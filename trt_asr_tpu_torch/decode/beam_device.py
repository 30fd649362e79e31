"""Device-resident TDT beam search, as the JAX package's
``decode/beam_device.py``: the beam frontier advanced over a chunk's
encoder rows on the card, with no host round trip inside the search.

The host beam (``decode/beam.py``) is the semantics oracle. Here a
static-width hypothesis set (scores, token buffers, cursors, y_id,
predictor h/c/g stacked on a beam axis K) advances frame by frame, with
candidate expansion, path recombination (log-add merging) and label-diverse
pruning as masked tensor ops. One core carries a stream axis S:
``tdt_beam_chunk_device`` is its S = 1 case and
``tdt_beam_chunk_device_batch`` serves the engine's slots. A stream whose
frame has nothing to expand (or lies past its valid rows) keeps its state
by a per-stream select, where JAX skips it with ``lax.cond`` under
``vmap``; nothing in a chunk's search reads a value back to the host.

Algorithm, per frame t (the host's ``beam_advance``):
1. actives with cursor != t wait (pool slots, untouched);
2. actives at t expand through ``max_symbols`` rounds of dur-0 chaining:
   per hypothesis the candidates are [blank @ argmax-duration] ++
   [top-k non-blank x every duration bin], leading-punct tokens masked on
   a true first emission; advancing candidates go to the pool in the
   host's order (hyp-major, candidate-minor, round-major), dur-0
   candidates form the next frontier, pruned to the beam width in stable
   score order; the last round forces an advance >= 1;
3. pool entries with identical (token history, cursor) merge by log-add,
   the first occurrence represents the class, the dominant alignment's
   stamps win;
4. label-diverse pruning: the best entry per distinct label first (stable
   score order, up to the beam), the remaining slots by raw score.

Top k and every ordering come from stable sorts, so that ties keep the
lower index first, as ``lax.top_k`` and ``argsort(stable=True)`` do.

The merge needs full token-history equality over the pool (K + ms*K*C
rows, 676 at full width). Histories are compared exactly by two f32 Gram
products: tokens + 1 split into 7-bit halves (hi = v >> 7 <= 64, lo =
v & 127), ||a - b||^2 == 0 per half (the largest sum of squares, 512 *
127^2 = 8.3e6 < 2^24, keeps the arithmetic integer-exact; the halves are
exact in TF32 too).

Shallow fusion runs on the card too: an ``NGramLM`` or ``BiasingLM``
compiles into tables (``decode/lm_device.py``) scored inside the
expansion with the host's semantics (top-k chosen on the acoustic score,
``lm_weight * lm_fn(prefix, v)`` added to every non-blank candidate).

token_cap: a non-blank emission into a full buffer keeps the first
``token_cap`` tokens, drops the new one and latches the hypothesis's
``sat`` flag (inherited by descendants, OR-merged through recombination);
scores and predictor state still advance. ``BeamStreamingSession`` and the
engine report a live saturated hypothesis once per utterance as an ERROR
event.

The joint runs with K rows per stream and the predictor with K * k rows
(k = expansion_k), the row counts the host beam pads to
(``beam.make_host_fns``), so that on the card both searches' products take
the same cuBLAS kernels.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet.joint import _proj, joint_from_projected
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step

NEG = float("-inf")


class BeamDeviceState(NamedTuple):
    """The carried search state. All leading axes are the beam width K (a
    stream axis S before it in the batched form); ``tokens``/``frames``/
    ``durs``/``logps`` are [K, L] utterance buffers (-1 / 0 padded).
    ``cursor`` is relative to the next chunk's first frame. ``frame_base`` is
    the global index of that frame (for stamps); ``emitted_base`` mirrors
    ``BeamSearchState.emitted_base``. Integer buffers are int32."""

    score: torch.Tensor       # [K] f32, -inf = dead slot
    tokens: torch.Tensor      # [K, L] int32, -1 padded
    n_tok: torch.Tensor       # [K] int32
    cursor: torch.Tensor      # [K] int32
    y_id: torch.Tensor        # [K] int32
    g: torch.Tensor           # [K, P]
    h: torch.Tensor           # [R, K, P]
    c: torch.Tensor           # [R, K, P]
    frames: torch.Tensor      # [K, L] int32 emission frame per token
    durs: torch.Tensor        # [K, L] int32 predicted duration per token
    logps: torch.Tensor       # [K, L] f32 token log-softmax per token
    frame_base: torch.Tensor  # scalar int32
    emitted_base: torch.Tensor  # scalar int32
    sat: torch.Tensor         # [K] bool: token_cap overflow (truncated tail)


def init_beam_device_state_batch(cfg: ModelConfig, dec_state, *, beam: int,
                                 token_cap: int = 512) -> BeamDeviceState:
    """[S, K, ...] search state: each stream row primed from its
    DecodeState row (prompt-primed g/h/c/y_id), slot 0 live at score 0."""
    K, L = beam, token_cap
    P, R = cfg.pred_hidden, cfg.pred_rnn_layers
    S = dec_state.g.shape[0]
    dev = dec_state.g.device
    i32 = dict(dtype=torch.int32, device=dev)
    score = torch.full((S, K), NEG, dtype=torch.float32, device=dev)
    score[:, 0] = 0.0
    return BeamDeviceState(
        score=score,
        tokens=torch.full((S, K, L), -1, **i32),
        n_tok=torch.zeros((S, K), **i32),
        cursor=torch.zeros((S, K), **i32),
        y_id=dec_state.y_id[:, None].expand(S, K).to(torch.int32).contiguous(),
        g=dec_state.g[:, None, :].expand(S, K, P).float().contiguous(),
        h=dec_state.h.permute(1, 0, 2)[:, :, None, :].expand(S, R, K, P).float().contiguous(),
        c=dec_state.c.permute(1, 0, 2)[:, :, None, :].expand(S, R, K, P).float().contiguous(),
        frames=torch.full((S, K, L), -1, **i32),
        durs=torch.full((S, K, L), -1, **i32),
        logps=torch.zeros((S, K, L), dtype=torch.float32, device=dev),
        frame_base=torch.zeros((S,), **i32),
        emitted_base=torch.zeros((S,), **i32),
        sat=torch.zeros((S, K), dtype=torch.bool, device=dev),
    )


def init_beam_device_state(cfg: ModelConfig, dec_state, *, beam: int, token_cap: int = 512,
                           emitted_so_far: int = 0) -> BeamDeviceState:
    """A fresh search from a prompt-primed DecodeState (B = 1): slot 0 live
    at score 0, the rest dead (the device analog of ``beam_start``)."""
    st = _unbatch(init_beam_device_state_batch(cfg, dec_state, beam=beam, token_cap=token_cap))
    return st._replace(emitted_base=torch.full_like(st.emitted_base, emitted_so_far))


def _batch(st: BeamDeviceState) -> BeamDeviceState:
    return BeamDeviceState(*(x[None] for x in st))


def _unbatch(st: BeamDeviceState) -> BeamDeviceState:
    return BeamDeviceState(*(x[0] for x in st))


def _history_eq(tokens_a, n_a, tokens_b, n_b):
    """[..., Pa, L] x [..., Pb, L] -> [..., Pa, Pb] exact full-history
    equality by the split-precision Gram products (module docstring). Pads
    are -1 on both sides, so equal lengths and zero squared distance mean
    equal buffers. f32 throughout, outside any autocast."""
    with torch.autocast(tokens_a.device.type, enabled=False):
        va = (tokens_a + 1).float()               # 0 .. 8194
        vb = (tokens_b + 1).float()
        eq = n_a[..., :, None] == n_b[..., None, :]
        hi_a, lo_a = torch.floor_divide(va, 128.0), torch.remainder(va, 128.0)
        hi_b, lo_b = torch.floor_divide(vb, 128.0), torch.remainder(vb, 128.0)
        for a, b in ((hi_a, hi_b), (lo_a, lo_b)):
            sa = (a * a).sum(-1)
            sb = (b * b).sum(-1)
            gram = torch.matmul(a, b.transpose(-1, -2))
            d2 = sa[..., :, None] + sb[..., None, :] - 2.0 * gram
            eq = eq & (d2 == 0.0)
    return eq


def _stable_desc(score: torch.Tensor) -> torch.Tensor:
    """Stable descending argsort on the last axis (ties keep index order)."""
    return torch.sort(-score, dim=-1, stable=True)[1]


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x gathered along ``dim`` at idx [S, N] (the leading axis S batched;
    for ``dim`` > 1 the axes between are kept)."""
    shape = list(x.shape)
    shape[dim] = idx.shape[1]
    view = [idx.shape[0]] + [1] * (x.dim() - 1)
    view[dim] = idx.shape[1]
    return torch.gather(x, dim, idx.long().reshape(view).expand(shape))


def _consts(cfg: ModelConfig, k: int, beam: int, device):
    """Index constants of a call: the duration values and, per candidate
    slot, its top-k index and duration bin (slot 0 = blank at the best
    duration, slot 1 + m*nd + di = token m, bin di)."""
    nd = cfg.num_duration_bins
    dur = torch.tensor(cfg.duration_values, dtype=torch.int32, device=device)
    if beam == 1:
        return dur, None, None
    mm = torch.tensor([m for m in range(k) for _ in range(nd)], dtype=torch.long, device=device)
    dd = torch.tensor([di for _ in range(k) for di in range(nd)], dtype=torch.long, device=device)
    return dur, mm, dd


def _beam_chunk_core(params: Dict[str, Any], cfg: ModelConfig, enc: torch.Tensor,
                     t_enc: torch.Tensor, st: BeamDeviceState, *, beam: int,
                     expansion_k: int = 4, max_symbols: Optional[int] = None,
                     blank_penalty: float = 0.0, punct_mask: Optional[torch.Tensor] = None,
                     use_punct_mask: bool = False, lm_spec=None, lm_tables=None,
                     lm_weight: float = 0.0) -> BeamDeviceState:
    """Advance S device beams over one chunk: enc [S, T, D], t_enc [S] valid
    rows, st the [S, K, ...] state. Returns the state with cursors rebased
    past the consumed frames (the host's ``beam_advance``). Python loops run
    over the static ranges only: the chunk's T rows and ``max_symbols``
    rounds."""
    S, T, D = enc.shape
    K = beam
    k = expansion_k if beam > 1 else 1
    ms = max_symbols or cfg.max_symbols_per_timestep
    nd = cfg.num_duration_bins
    C = 1 + k * nd if beam > 1 else 1            # candidates per hyp per round
    L = st.tokens.shape[2]
    P, R = cfg.pred_hidden, cfg.pred_rnn_layers
    blank, ths = cfg.blank_id, cfg.token_head_size
    dev = enc.device
    dur_values, mm, dd = _consts(cfg, k, beam, dev)
    jp, pp = params["joint"], params["predictor"]
    t_enc = torch.as_tensor(t_enc).to(device=dev, dtype=torch.int32).reshape(S)
    use_lm = beam > 1 and lm_spec is not None and bool(lm_weight)
    pmask = punct_mask.to(dev) if (use_punct_mask and punct_mask is not None) else None
    Pn = K + ms * K * C
    idx_pool = torch.arange(Pn, device=dev)
    blank_idx = torch.tensor([blank], device=dev)
    blank_col = torch.full((S, K, 1), blank, dtype=torch.long, device=dev)
    arange_l = torch.arange(L, device=dev)
    if use_lm:
        from trt_asr_tpu_torch.decode.lm_device import lm_scores

    def expand_round(fr, r, t, e_proj, frame_t):
        """One dur-0 chain round over every stream's frontier: returns
        (next frontier, pool block of K*C rows a stream)."""
        (f_score, f_tok, f_n, f_y, f_g, f_h, f_c, f_frames, f_durs, f_logps, f_alive,
         f_sat) = fr
        logits = joint_from_projected(jp, e_proj, f_g.reshape(S * K, P)).reshape(S, K, -1)
        tok_logits = logits[..., :ths]
        if blank_penalty:
            tok_logits = tok_logits.clone()
            tok_logits[..., blank] -= blank_penalty
        ls_tok = torch.log_softmax(tok_logits, dim=-1)
        ls_dur = torch.log_softmax(logits[..., ths:ths + nd], dim=-1)
        first = (st.emitted_base[:, None] == 0) & (f_n == 0)           # [S, K]
        best_dur_bin = torch.argmax(ls_dur, dim=-1)                     # [S, K]
        if beam == 1:
            v = torch.argmax(ls_tok, dim=-1)
            if pmask is not None:
                v = v.masked_fill(first & (v != blank) & pmask[v], blank)
            cand_tok = v[..., None]                                     # [S, K, 1]
            cand_di = best_dur_bin[..., None]
            step_tokens = v.reshape(S, K)
        else:
            masked = ls_tok.index_fill(-1, blank_idx, NEG)
            if pmask is not None:
                masked = masked.masked_fill(first[..., None] & pmask[None, None, :ths], NEG)
            top_idx = torch.sort(masked, dim=-1, descending=True, stable=True)[1][..., :k]
            cand_tok = torch.cat([blank_col, top_idx[..., mm]], dim=-1)    # [S, K, C]
            cand_di = torch.cat([best_dur_bin[..., None], dd.expand(S, K, C - 1)], dim=-1)
            step_tokens = top_idx.reshape(S, K * k)
        cand_dur = dur_values[cand_di]                                  # [S, K, C] int32
        is_blank = cand_tok == blank
        if r == ms - 1:                                                 # forced advance
            adv = cand_dur.clamp_min(1)
        else:
            adv = torch.where(is_blank, cand_dur.clamp_min(1), cand_dur)
        ls_tok_c = torch.gather(ls_tok, -1, cand_tok)
        ls_dur_c = torch.gather(ls_dur, -1, cand_di)
        c_score = (f_score[..., None] + ls_tok_c + ls_dur_c).masked_fill(~f_alive[..., None], NEG)
        if use_lm:
            # the host's fusion: candidates chosen on the acoustic score,
            # the LM term added to every non-blank candidate's path score
            lmv = lm_weight * lm_scores(lm_spec, lm_tables, f_tok.reshape(S * K, L),
                                        f_n.reshape(S * K), top_idx.reshape(S * K, k))
            lmv = lmv.reshape(S, K, k)
            c_score = c_score + torch.cat([torch.zeros_like(lmv[..., :1]), lmv[..., mm]], dim=-1)
        # one predictor step per (hyp, token), K * k rows a stream
        h_in = f_h[:, :, :, None].expand(R, S, K, k, P).reshape(R, S * K * k, P)
        c_in = f_c[:, :, :, None].expand(R, S, K, k, P).reshape(R, S * K * k, P)
        g2, h2, c2 = predictor_step(pp, step_tokens.reshape(-1), h_in, c_in)
        g2 = g2.reshape(S, K, k, P)
        h2 = h2.reshape(R, S, K, k, P)
        c2 = c2.reshape(R, S, K, k, P)
        if beam == 1:
            g_sel, h_sel, c_sel = g2, h2, c2
        else:
            g_sel = torch.cat([g2[:, :, :1], g2[:, :, mm]], dim=2)      # [S, K, C, P]
            h_sel = torch.cat([h2[:, :, :, :1], h2[:, :, :, mm]], dim=3)
            c_sel = torch.cat([c2[:, :, :, :1], c2[:, :, :, mm]], dim=3)
        emit = ~is_blank
        can_write = emit & (f_n[..., None] < L)
        # head-preserving truncation: an emission into a full buffer drops
        # the token and latches the descendant's saturation flag
        c_sat = f_sat[..., None] | (emit & (f_n[..., None] >= L))
        wr = can_write[..., None] & (arange_l == f_n[:, :, None, None])   # [S, K, C, L]
        cand32 = cand_tok.to(torch.int32)
        c_tokens = torch.where(wr, cand32[..., None], f_tok[:, :, None, :])
        c_frames = torch.where(wr, frame_t, f_frames[:, :, None, :])
        c_durs = torch.where(wr, cand_dur[..., None], f_durs[:, :, None, :])
        c_logps = torch.where(wr, ls_tok_c[..., None], f_logps[:, :, None, :])
        c_n = f_n[..., None] + can_write.to(torch.int32)
        c_y = torch.where(is_blank, f_y[..., None], cand32)
        c_g = torch.where(is_blank[..., None], f_g[:, :, None, :], g_sel)
        c_h = torch.where(is_blank[None, ..., None], f_h[:, :, :, None, :], h_sel)
        c_c = torch.where(is_blank[None, ..., None], f_c[:, :, :, None, :], c_sel)
        c_cursor = (t + adv).to(torch.int32)
        pool_valid = f_alive[..., None] & (adv > 0)
        front_valid = f_alive[..., None] & (adv == 0) & ~is_blank

        flat = lambda x: x.reshape((S, K * C) + x.shape[3:])           # noqa: E731
        block = dict(score=flat(c_score.masked_fill(~pool_valid, NEG)), tokens=flat(c_tokens),
                     n_tok=flat(c_n), cursor=flat(c_cursor), y_id=flat(c_y), g=flat(c_g),
                     h=c_h.reshape(R, S, K * C, P), c=c_c.reshape(R, S, K * C, P),
                     frames=flat(c_frames), durs=flat(c_durs), logps=flat(c_logps),
                     sat=flat(c_sat))
        # next frontier: dur-0 candidates, stable score order, top K
        f_flat = flat(c_score.masked_fill(~front_valid, NEG))
        order = _stable_desc(f_flat)[:, :K]
        sel = lambda x: _take(x, order, 1)                              # noqa: E731
        nf_score = sel(f_flat)
        nf = (nf_score, sel(block["tokens"]), sel(block["n_tok"]), sel(block["y_id"]),
              sel(block["g"]), _take_rows(block["h"], order), _take_rows(block["c"], order),
              sel(block["frames"]), sel(block["durs"]), sel(block["logps"]),
              nf_score > NEG, sel(block["sat"]))
        return nf, block

    for t in range(T):
        alive = st.score > NEG
        here = alive & (st.cursor == t)
        do = (t < t_enc) & here.any(dim=1)                              # [S]
        e_row = enc[:, t].float()                                       # [S, D]
        e_proj = _proj(jp["enc"], e_row[:, None, :].expand(S, K, D).reshape(S * K, D))
        frame_t = (st.frame_base + t)[:, None, None, None]             # global frame index
        waiting = alive & (st.cursor != t)
        fr = (st.score.masked_fill(~here, NEG), st.tokens, st.n_tok,
              st.y_id, st.g, st.h.permute(1, 0, 2, 3), st.c.permute(1, 0, 2, 3), st.frames,
              st.durs, st.logps, here, st.sat)
        blocks = []
        for r in range(ms):
            fr, block = expand_round(fr, r, t, e_proj, frame_t)
            blocks.append(block)
        # pool = waiting actives ++ the round blocks (the host's order)
        cat = lambda name, w: torch.cat([w] + [b[name] for b in blocks], dim=1)  # noqa: E731
        p_score = cat("score", st.score.masked_fill(~waiting, NEG))
        p_tokens, p_n, p_cursor = cat("tokens", st.tokens), cat("n_tok", st.n_tok), \
            cat("cursor", st.cursor)
        p_y, p_g = cat("y_id", st.y_id), cat("g", st.g)
        p_h = torch.cat([st.h.permute(1, 0, 2, 3)] + [b["h"] for b in blocks], dim=2)
        p_c = torch.cat([st.c.permute(1, 0, 2, 3)] + [b["c"] for b in blocks], dim=2)
        p_frames, p_durs = cat("frames", st.frames), cat("durs", st.durs)
        p_logps, p_sat = cat("logps", st.logps), cat("sat", st.sat)

        valid = p_score > NEG
        hist_eq = _history_eq(p_tokens, p_n, p_tokens, p_n)             # [S, Pn, Pn]
        eq = (hist_eq & (p_cursor[:, :, None] == p_cursor[:, None, :])
              & valid[:, :, None] & valid[:, None, :])
        rep = torch.where(eq, idx_pool, Pn).amin(dim=2)
        is_rep = (rep == idx_pool) & valid
        # log-add merge: a logsumexp over each class row, -inf rows kept -inf
        masked = p_score[:, None, :].masked_fill(~eq, NEG)
        mrow = masked.amax(dim=2)
        safe = torch.where(torch.isfinite(mrow), mrow, torch.zeros_like(mrow))
        merged = safe + torch.log(torch.exp(masked - safe[..., None]).sum(dim=2))
        m_score = merged.masked_fill(~is_rep, NEG)
        # the dominant alignment's stamps
        dom = torch.argmax(masked, dim=2)
        m_frames, m_durs, m_logps = (_take(x, dom, 1) for x in (p_frames, p_durs, p_logps))
        # saturation is sticky through recombination
        m_sat = (eq & p_sat[:, None, :]).any(dim=2)

        # label-diverse pruning in stable merged-score order
        order = _stable_desc(m_score)
        s_score = torch.gather(m_score, 1, order)
        s_valid = s_score > NEG
        eqL = _take(_take(hist_eq, order, 1), order, 2) & s_valid[:, :, None] & s_valid[:, None, :]
        dup = (eqL & (idx_pool[None, :] < idx_pool[:, None])).any(dim=2)
        is_first = s_valid & ~dup
        n_first_cum = torch.cumsum(is_first.to(torch.int32), dim=1)
        pick_first = is_first & (n_first_cum <= K)
        n_first = n_first_cum[:, -1:].clamp(max=K)
        rest = s_valid & ~pick_first
        rest_cum = torch.cumsum(rest.to(torch.int32), dim=1)
        pick_rest = rest & (rest_cum <= K - n_first)
        slot = torch.where(pick_first, n_first_cum - 1,
                           torch.where(pick_rest, n_first + rest_cum - 1,
                                       torch.full_like(rest_cum, K)))
        # survivor slot -> sorted position -> pool index (slot K is dropped)
        pos_of_slot = torch.full((S, K + 1), Pn, dtype=torch.long, device=dev)
        pos_of_slot.scatter_(1, slot.long(), idx_pool.expand(S, Pn))
        pos_of_slot = pos_of_slot[:, :K]
        live = pos_of_slot < Pn
        pool_of_slot = torch.where(live, torch.gather(order, 1, pos_of_slot.clamp(max=Pn - 1)),
                                   torch.zeros_like(pos_of_slot))
        gk = lambda x: _take(x, pool_of_slot, 1)                        # noqa: E731
        new = BeamDeviceState(
            score=gk(m_score).masked_fill(~live, NEG),
            tokens=gk(p_tokens), n_tok=gk(p_n), cursor=gk(p_cursor), y_id=gk(p_y), g=gk(p_g),
            h=_take_rows(p_h, pool_of_slot).permute(1, 0, 2, 3),
            c=_take_rows(p_c, pool_of_slot).permute(1, 0, 2, 3),
            frames=gk(m_frames), durs=gk(m_durs), logps=gk(m_logps),
            frame_base=st.frame_base, emitted_base=st.emitted_base,
            sat=live & gk(m_sat))
        st = BeamDeviceState(*(
            torch.where(do.reshape((S,) + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(new, st)))
    return st._replace(cursor=st.cursor - t_enc[:, None], frame_base=st.frame_base + t_enc)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [R, S, N, P] gathered on N at idx [S, M] -> [R, S, M, P]."""
    R, S, _, P = x.shape
    i = idx.long()[None, :, :, None].expand(R, S, idx.shape[1], P)
    return torch.gather(x, 2, i)


def tdt_beam_chunk_device_batch(params: Dict[str, Any], cfg: ModelConfig, enc: torch.Tensor,
                                t_enc, state: BeamDeviceState, **kw) -> BeamDeviceState:
    """S independent device beams advanced in lockstep (the engine serves
    beam and LM fusion per slot in one step): enc [S, T, D], t_enc [S]
    valid rows, state [S, K, ...]. A slot with t_enc == 0 keeps its rows
    (every frame fails ``t < t_enc``), the engine's mask-and-skip."""
    return _beam_chunk_core(params, cfg, enc, t_enc, state, **kw)


def tdt_beam_chunk_device(params: Dict[str, Any], cfg: ModelConfig, enc: torch.Tensor,
                          t_enc, state: BeamDeviceState, **kw) -> BeamDeviceState:
    """Advance one stream's device beam over a chunk's encoder rows enc
    [T, D] (``t_enc`` valid): the S = 1 case of the batched core."""
    return _unbatch(_beam_chunk_core(params, cfg, enc[None], torch.as_tensor(t_enc).reshape(1),
                                     _batch(state), **kw))


def reset_beam_device_state_rows(state: BeamDeviceState, mask, cfg: ModelConfig, dec_state, *,
                                 beam: int, token_cap: int) -> BeamDeviceState:
    """Re-init the masked stream rows from (already reset and primed)
    DecodeState rows, leaving the other rows untouched: the beam's
    ``reset_decode_state_rows``."""
    fresh = init_beam_device_state_batch(cfg, dec_state, beam=beam, token_cap=token_cap)
    m = torch.as_tensor(mask, device=state.score.device).reshape(-1)
    return BeamDeviceState(*(torch.where(m.reshape((-1,) + (1,) * (f.dim() - 1)), f, o)
                             for f, o in zip(fresh, state)))


def beam_device_row_to_hypotheses(state: BeamDeviceState, row: int):
    """One stream row of a batched [S, K, ...] state as host Hypothesis
    objects."""
    return beam_device_to_hypotheses(BeamDeviceState(*(x[row] for x in state)))


def beam_device_to_hypotheses(state: BeamDeviceState):
    """Fetch the device pool into host Hypothesis objects, so that
    ``beam_finish``, n-best and the stable prefix reuse the host code."""
    from trt_asr_tpu_torch.decode.beam import Hypothesis

    a = {k: v.cpu().numpy() for k, v in state._asdict().items()}
    base = int(a["frame_base"])
    hyps = []
    for i in range(a["score"].shape[0]):
        if not np.isfinite(a["score"][i]):
            continue
        n = int(a["n_tok"][i])
        hyps.append(Hypothesis(
            score=float(a["score"][i]), tokens=[int(t) for t in a["tokens"][i, :n]],
            cursor=base + int(a["cursor"][i]), y_id=int(a["y_id"][i]),
            stamps=[(int(a["frames"][i, j]), int(a["durs"][i, j]), float(a["logps"][i, j]))
                    for j in range(n)]))
    return hyps
