"""TDT beam-search decoding (n-best) on the host, as the JAX package's
``decode/beam.py``: the semantics oracle of the device beam
(``decode/beam_device.py``), over the joint and predictor callables of
``make_host_fns``. It is incremental: the search state advances one frame
window at a time, which is what the streaming beam session
(``streaming/beam_session.py``) feeds with each chunk's encoder frames.

Search shape: frame-synchronous beam adapted to TDT's duration head. At
each encoder frame t, every hypothesis whose time cursor sits at t expands:

- non-blank token v with duration d:
    score += logsoftmax_tok(v) + logsoftmax_dur(d); cursor += d
    (d = 0 keeps the cursor at t, bounded by ``max_symbols`` a frame, after
    which the advance is forced to 1, the greedy clamp)
- blank with duration d:
    score += logsoftmax_tok(blank) + logsoftmax_dur(d); cursor += max(d, 1)

After all frame-t expansions the pool is pruned to ``beam`` survivors;
hypotheses with identical (token prefix, cursor) are merged by log-add. A
hypothesis whose cursor sits beyond the frames seen so far waits (the
beam's analog of the greedy decoder's cross-chunk ``time_carry``); at
``beam_finish`` alignments of one label sequence are recombined and ranked.

``beam=1`` takes each hypothesis's single greedy successor (argmax token
and argmax duration, with the blank and symbol-cap clamps), which
reproduces the greedy decoder token for token. Optional shallow fusion:
``lm_fn(prefix, token)`` adds ``lm_weight`` times an external LM
log-probability to every non-blank emission (blank is acoustic-only).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Hypothesis:
    """One beam entry. ``score`` is the total log-probability (token and
    duration heads) of the alignment(s) merged into this hypothesis."""

    score: float
    tokens: List[int] = field(default_factory=list)
    cursor: int = 0          # next encoder frame to consume (global index)
    u: int = 0               # symbols emitted at the current frame
    y_id: int = 0
    g: Optional[np.ndarray] = None
    state: object = None
    stamps: List[Tuple[int, int, float]] = field(default_factory=list)
                             # per emitted token: (global emission frame,
                             # predicted TDT duration, token log-softmax) —
                             # the greedy decoder's stamps, so beam
                             # transcripts get the same frame-anchored
                             # timestamps (decode/timestamps.py)

    def key(self) -> Tuple[Tuple[int, ...], int]:
        return (tuple(self.tokens), self.cursor)


@dataclass
class BeamSearchState:
    """Carried search state for incremental (chunk-by-chunk) decoding:
    the surviving hypotheses and the global index of the next encoder
    frame ``beam_advance`` will consume. ``emitted_base`` is the
    utterance-level emission count at search start (leading-punct
    suppression applies only to a truly first emission)."""

    active: List[Hypothesis] = field(default_factory=list)
    offset: int = 0
    emitted_base: int = 0


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = float(np.max(x))
    e = np.exp(x - m)
    return (x - m) - math.log(float(np.sum(e)))


def make_host_fns(params, device, *, joint_rows: int = 1, pred_rows: int = 1):
    """The host-callable triplet every beam search needs: single-step joint
    (j_fn), predictor step (p_fn) and the frontier-batched joint (j_batch,
    equal to j_fn row for row). Each runs the torch joint or predictor on
    ``device`` and returns numpy; a hypothesis's predictor state stays
    there. Shared by ``ParakeetTDT.transcribe_offline_beam`` and the
    streaming beam session.

    ``joint_rows`` and ``pred_rows`` fix the row count of every joint and
    predictor product (the rows past the real ones are padding): the device
    beam (``decode/beam_device.py``) takes its joint with K rows and its
    predictor with K * expansion_k rows, and with the same row counts the
    card's cuBLAS picks the same kernel, and so the same summation order,
    for both searches."""
    import torch

    from trt_asr_tpu_torch.models.parakeet.joint import joint_single_step
    from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step

    jp, pp = params["joint"], params["predictor"]

    def enc_rows(enc_t, rows):
        e = torch.as_tensor(np.asarray(enc_t, np.float32), device=device)
        return e[None].expand(rows, e.shape[0]).contiguous()

    def j_batch(enc_t, G):
        G = np.asarray(G, np.float32)
        k = G.shape[0]
        rows = max(joint_rows, k)
        g = torch.zeros((rows, G.shape[1]), dtype=torch.float32, device=device)
        g[:k] = torch.as_tensor(G, device=device)
        return joint_single_step(jp, enc_rows(enc_t, rows), g)[:k].cpu().numpy()

    def j_fn(enc_t, g):
        return j_batch(enc_t, np.asarray(g)[None])[0]

    def p_fn(tok, st):
        h, c = st
        r, _, p = h.shape
        y = torch.full((pred_rows,), int(tok), dtype=torch.int32, device=device)
        g, h2, c2 = predictor_step(pp, y, h.expand(r, pred_rows, p).contiguous(),
                                   c.expand(r, pred_rows, p).contiguous())
        return g[0].cpu().numpy(), (h2[:, :1].contiguous(), c2[:, :1].contiguous())

    return j_fn, p_fn, j_batch


def beam_start(g: np.ndarray, y_id: int, state,
               *, emitted_so_far: int = 0) -> BeamSearchState:
    """Fresh search from a primed predictor state (analogous to the greedy
    decoder's prompt-primed DecodeState)."""
    init = Hypothesis(score=0.0, y_id=y_id, g=np.asarray(g), state=state)
    return BeamSearchState(active=[init], emitted_base=emitted_so_far)


def beam_advance(
    bs: BeamSearchState,
    enc_frames: np.ndarray,            # [n, D] fresh valid encoder frames
    joint_fn: Callable,                # (enc_t [D], g [P]) -> logits [V_joint]
    predictor_fn: Callable,            # (token_id, state) -> (g [P], state)
    *,
    blank_id: int,
    token_head_size: int,
    duration_values: Sequence[int],
    beam: int = 4,
    expansion_k: int = 4,              # non-blank tokens considered per step
    max_symbols: int = 8,
    blank_penalty: float = 0.0,        # subtracted from the blank logit
                                       # pre-softmax (the greedy decoder's)
    punct_token_ids: Optional[set] = None,
                                       # leading-punct suppression: these
                                       # tokens cannot be an utterance's
                                       # first emission (as in greedy)
    lm_fn: Optional[Callable[[List[int], int], float]] = None,
    lm_weight: float = 0.0,
    joint_batch_fn: Optional[Callable] = None,
                                       # (enc_t [D], G [k, P]) -> [k, V]:
                                       # evaluate the joint for a whole
                                       # frontier in ONE device call, which
                                       # cuts the per-frame calls about
                                       # beam-fold; results must match
                                       # joint_fn row for row
) -> BeamSearchState:
    """Consume ``enc_frames`` (global frames [offset, offset+n)); returns
    the state with ``offset`` advanced. Hypotheses whose cursor lies beyond
    the window survive untouched — they resume when their frame arrives."""
    n = int(enc_frames.shape[0])
    ndur = len(duration_values)
    active = bs.active
    for t_local in range(n):
        if not active:
            break
        t = bs.offset + t_local
        # Hyps not at this frame pass through untouched; they still occupy
        # beam slots (they already paid their scores up to a later frame).
        here = [h for h in active if h.cursor == t]
        waiting = [h for h in active if h.cursor != t]
        if not here:
            continue
        pool: List[Hypothesis] = list(waiting)
        # expand frame-t hypotheses, chasing dur=0 chains within the frame
        frontier = here
        for _u in range(max_symbols):
            if not frontier:
                break
            next_frontier: List[Hypothesis] = []
            batched_logits = None
            if joint_batch_fn is not None and len(frontier) > 1:
                batched_logits = np.asarray(
                    joint_batch_fn(enc_frames[t_local],
                                   np.stack([h.g for h in frontier])),
                    dtype=np.float32)
            for h_i, h in enumerate(frontier):
                logits = (batched_logits[h_i] if batched_logits is not None
                          else np.asarray(joint_fn(enc_frames[t_local], h.g),
                                          dtype=np.float32))
                tok_logits = logits[:token_head_size]
                if blank_penalty:
                    tok_logits = tok_logits.copy()
                    tok_logits[blank_id] -= blank_penalty
                ls_tok = _log_softmax(tok_logits)
                ls_dur = _log_softmax(
                    logits[token_head_size : token_head_size + ndur])
                first = (punct_token_ids and bs.emitted_base == 0
                         and not h.tokens)
                forced = _u == max_symbols - 1   # greedy's symbol-cap clamp
                if beam == 1:
                    # exact greedy successor: argmax over each head, with
                    # the greedy leading-punct substitution to blank
                    v = int(np.argmax(ls_tok))
                    if first and v != blank_id and v in punct_token_ids:
                        v = blank_id
                    cands = [(v, int(np.argmax(ls_dur)))]
                else:
                    # blank (best duration) + top-k non-blank x every duration
                    cands = [(blank_id, int(np.argmax(ls_dur)))]
                    emitted = 0
                    for v in np.argsort(ls_tok)[::-1]:
                        v = int(v)
                        if v == blank_id or (first and v in punct_token_ids):
                            continue
                        if emitted >= expansion_k:
                            break
                        emitted += 1
                        cands.extend((v, di) for di in range(ndur))
                g_cache = {}   # one predictor step per distinct token
                lm_cache = {}  # one LM query per distinct token
                for v, di in cands:
                    d = int(duration_values[di])
                    sc = h.score + float(ls_tok[v]) + float(ls_dur[di])
                    if (lm_fn is not None and lm_weight and beam > 1
                            and v != blank_id):
                        if v not in lm_cache:
                            lm_cache[v] = lm_weight * float(lm_fn(h.tokens, v))
                        sc += lm_cache[v]
                    if v == blank_id:
                        # blank: no emission, predictor untouched, >=1 frame
                        pool.append(Hypothesis(
                            score=sc, tokens=h.tokens, cursor=t + max(d, 1),
                            y_id=h.y_id, g=h.g, state=h.state,
                            stamps=h.stamps))
                        continue
                    if v not in g_cache:
                        g_cache[v] = predictor_fn(v, h.state)
                    g2, st2 = g_cache[v]
                    adv = max(d, 1) if forced else d
                    h2 = Hypothesis(
                        score=sc, tokens=h.tokens + [v], cursor=t + adv,
                        y_id=v, g=np.asarray(g2), state=st2,
                        stamps=h.stamps + [(t, d, float(ls_tok[v]))])
                    if adv == 0:
                        h2.u = _u + 1
                        next_frontier.append(h2)
                    else:
                        pool.append(h2)
            # dur-0 chains compete with the pool next round via pruning of
            # the frontier itself (bound work per frame)
            next_frontier.sort(key=lambda h: h.score, reverse=True)
            frontier = next_frontier[:beam]
        # any frontier leftovers at the symbol cap were already forced to
        # advance (forced=True on the last _u), so nothing is dropped here
        # merge identical (tokens, cursor) alignments: log-add scores
        merged = {}
        best_ind = {}   # per-key max INDIVIDUAL alignment score: the
                        # dominant-alignment test must not compare against
                        # the log-added accumulator (>= every individual)
        for h in pool:
            k = h.key()
            if k in merged:
                if h.score > best_ind[k]:
                    best_ind[k] = h.score
                    # keep the dominant alignment's emission stamps (same
                    # tokens => same predictor state/g/y_id; only the
                    # emission frames differ between alignments)
                    merged[k].stamps = h.stamps
                merged[k].score = float(np.logaddexp(merged[k].score, h.score))
            else:
                merged[k] = h
                best_ind[k] = h.score
        pool = sorted(merged.values(), key=lambda h: h.score, reverse=True)
        # label-diverse pruning: a single token expanded with 5 duration
        # bins yields 5 pool entries with identical labels at different
        # cursors, which can flood a small beam and evict the blank
        # continuation (and with it every alternative label). Keep the
        # best entry per distinct label sequence first, then fill the
        # remaining slots by raw score — beam=1 reduces to plain top-1,
        # preserving exact greedy parity.
        survivors: List[Hypothesis] = []
        rest: List[Hypothesis] = []
        seen_labels = set()
        for h in pool:
            lk = tuple(h.tokens)
            if lk not in seen_labels and len(survivors) < beam:
                seen_labels.add(lk)
                survivors.append(h)
            else:
                rest.append(h)
        if len(survivors) < beam:
            survivors.extend(rest[: beam - len(survivors)])
        active = survivors
    bs.active = active
    bs.offset += n
    return bs


def beam_finish(bs: BeamSearchState, *, beam: int = 4,
                length_norm: float = 0.0) -> List[Hypothesis]:
    """End of utterance: recombine alignments of the same label sequence
    that stopped at different frames (log-add — completing the per-frame
    merging in ``beam_advance``), rank, and return up to ``beam``.

    Non-mutating: the streaming session calls this mid-stream for interim
    n-best, so the live pool's hypotheses must not be touched."""
    import dataclasses

    def rank(h: Hypothesis) -> float:
        if length_norm and h.tokens:
            return h.score / (len(h.tokens) ** length_norm)
        return h.score
    merged_fin: dict = {}   # tokens -> (log-added score, dominant hyp)
    for h in bs.active:
        k = tuple(h.tokens)
        cur = merged_fin.get(k)
        if cur is None:
            merged_fin[k] = (h.score, h)
        else:
            s, kept = cur
            if h.score > kept.score:
                kept = h
            merged_fin[k] = (float(np.logaddexp(s, h.score)), kept)
    out = [dataclasses.replace(h, score=s) for s, h in merged_fin.values()]
    out.sort(key=rank, reverse=True)
    return out[:beam]


def beam_best(bs: BeamSearchState) -> Optional[Hypothesis]:
    """Current best active hypothesis (for streaming partials)."""
    return max(bs.active, key=lambda h: h.score) if bs.active else None


def beam_stable_prefix(bs: BeamSearchState) -> List[int]:
    """Longest common token prefix of all active hypotheses. This prefix
    is COMMITTED: every future hypothesis descends from an active one (a
    hypothesis only ever extends its token list), so no re-ranking can
    rewrite these tokens. The serving signal a beam partial needs that a
    greedy partial gets for free (greedy never rewrites)."""
    if not bs.active:
        return []
    toks = [h.tokens for h in bs.active]
    ref = min(toks, key=len)
    n = 0
    for i, t in enumerate(ref):
        if all(x[i] == t for x in toks):
            n = i + 1
        else:
            break
    return list(ref[:n])


def tdt_beam_decode_host(
    enc: np.ndarray,                   # [T_enc, D] valid encoder steps
    joint_fn: Callable,
    predictor_fn: Callable,
    state,                             # initial predictor state
    g: np.ndarray,                     # primed predictor output [P]
    y_id: int,
    *,
    blank_id: int,
    token_head_size: int,
    duration_values: Sequence[int],
    beam: int = 4,
    expansion_k: int = 4,
    max_symbols: int = 8,
    length_norm: float = 0.0,
    blank_penalty: float = 0.0,
    punct_token_ids: Optional[set] = None,
    emitted_so_far: int = 0,
    lm_fn: Optional[Callable[[List[int], int], float]] = None,
    lm_weight: float = 0.0,
    joint_batch_fn: Optional[Callable] = None,
) -> List[Hypothesis]:
    """Decode one whole utterance; returns up to ``beam`` finished
    hypotheses, best first. ``tokens`` of the top hypothesis is the 1-best
    transcript. (Composition of beam_start/beam_advance/beam_finish — the
    streaming session drives the same three calls chunk-by-chunk.)"""
    bs = beam_start(g, y_id, state, emitted_so_far=emitted_so_far)
    bs = beam_advance(
        bs, np.asarray(enc), joint_fn, predictor_fn,
        blank_id=blank_id, token_head_size=token_head_size,
        duration_values=duration_values, beam=beam,
        expansion_k=expansion_k, max_symbols=max_symbols,
        blank_penalty=blank_penalty, punct_token_ids=punct_token_ids,
        lm_fn=lm_fn, lm_weight=lm_weight, joint_batch_fn=joint_batch_fn)
    return beam_finish(bs, beam=beam, length_norm=length_norm)
