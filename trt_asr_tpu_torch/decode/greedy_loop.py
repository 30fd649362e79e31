"""The host loop of the TDT greedy decoders: ``tdt_greedy_decode_batch``
(``decode/batched.py``, all streams of a chunk in lockstep) and the
single-stream ``tdt_greedy_decode_chunk`` (``decode/tdt_greedy.py``).

Same decisions as the JAX package's ``decode/batched.py``
``tdt_greedy_decode_batch``; its ``lax.while_loop`` becomes a Python loop
whose control state (time index, per-step symbol count, emitted count)
lives on the host, while the predictor state and the joint run on the
device. Two regimes (the batched decoder switches on the shape as the JAX
version does; the chunk decoder always walks blank runs):

- blank-run (B*T <= 256, the streaming case): the token/duration argmax of
  EVERY (row, step) is computed in one joint call under the current
  predictor output g and copied to the host; the loop then walks blank
  runs on the host and recomputes only after an emission changed g.
  Host syncs per chunk = 1 (the chunk's valid length and carried time
  offset) + the number of recomputes (1 + the iterations that emitted).
- per-row (B*T > 256): one [B, V] joint per iteration at each row's
  current step, one host sync per iteration.

``use_kernel`` routes the blank-run joint through the fused CUDA
joint-step kernel (``ops/kernels/joint_step.py``).

``trace`` (one stream; ``trace=True`` of either decoder) records every
iteration's (time_idx, u, y_id, best_tok, duration, advance, is_blank),
``advance`` before the forced advance, as the JAX decoder's trace buffer:
the loop's control state is on the host already, so a record is a host
row, and the predictor's last token joins the one host sync a call has
anyway. With ``trace`` off nothing of it runs.
``greedy_decode_loop.iterations`` counts loop iterations over all calls of
both decoders (a plain int, as the kernels' launch counters).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet.joint import _proj, joint_project_enc
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step
from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step

if TYPE_CHECKING:
    from trt_asr_tpu_torch.decode.tdt_greedy import DecodeState


def greedy_decode_loop(params, cfg: ModelConfig, enc, t_enc, state: DecodeState, *,
                       max_tokens: int, max_symbols: Optional[int], blank_penalty: float,
                       emitted_so_far, punct_mask, use_punct_mask: bool,
                       with_timestamps: bool, blank_run: bool, use_kernel: bool,
                       joint_packed=None, trace: bool = False):
    """Decode enc [B, T, D] from ``state`` in the regime the caller chose:
    ``blank_run`` (else per-row), with the joint-step kernel in the
    blank-run recomputes when ``use_kernel`` (on ``joint_packed``, the int8
    or f32 weights packed once, where given). Arguments and results as
    :func:`~trt_asr_tpu_torch.decode.batched.tdt_greedy_decode_batch`;
    with ``trace`` (B = 1 only) the results end with ``(records [T *
    max_symbols, 7] int32 (-1 padded), n_steps)``."""
    b, tq = enc.shape[0], enc.shape[1]
    if trace and b != 1:
        raise ValueError(f"the decode trace records one stream, got B = {b}")
    dev = enc.device
    max_symbols = max_symbols or cfg.max_symbols_per_timestep
    blank = cfg.blank_id
    ths = cfg.token_head_size
    nd = cfg.num_duration_bins
    jp = params["joint"]
    dur_values = torch.as_tensor(cfg.duration_values, dtype=torch.long, device=dev)
    emitted = (np.zeros(b, np.int64) if emitted_so_far is None
               else np.asarray(torch.as_tensor(emitted_so_far).cpu(), np.int64).reshape(b))
    pmask = (torch.as_tensor(punct_mask, device=dev)
             if use_punct_mask and punct_mask is not None else None)

    enc_proj = joint_project_enc(jp, enc)                          # [B, T, J]
    # one host sync: valid steps and the carried time offset of every row
    # (and, for the trace, the predictor's last token)
    cols = [torch.as_tensor(t_enc, device=dev).reshape(b).long(), state.time_carry.long()]
    host = torch.stack(cols + ([state.y_id.long()] if trace else [])).cpu().numpy()
    t_enc_h, time_idx = host[0], host[1].copy()
    records = [] if trace else None
    y_host = host[2].copy() if trace else None

    def finish(toks, dur_sel, tok_logits, n):
        """Punct suppression, confidences and duration values; one host copy."""
        if pmask is not None:
            first = torch.as_tensor((emitted + n) == 0, device=dev)
            first = first.view((b,) + (1,) * (toks.dim() - 1))
            toks = torch.where(first & pmask[toks], torch.full_like(toks, blank), toks)
        if with_timestamps:
            conf = (torch.gather(tok_logits, -1, toks[..., None])[..., 0]
                    - torch.logsumexp(tok_logits, dim=-1))
        else:
            conf = torch.zeros(toks.shape, dtype=torch.float32, device=dev)
        out = torch.stack([toks.double(), dur_values[dur_sel].double(), conf.double()]).cpu()
        return out[0].long().numpy(), out[1].long().numpy(), out[2].float().numpy()

    def penalized(tok_logits):
        if blank_penalty:
            tok_logits = tok_logits.clone()
            tok_logits[..., blank] -= blank_penalty
        return tok_logits

    def compute_vecs(g, n):
        """Token/duration argmax of every (row, step) under each row's g."""
        if use_kernel:
            toks, dur_sel, logits = joint_step(
                enc_proj.reshape(b * tq, -1), g.repeat_interleave(tq, dim=0),
                jp["pred"]["w"], jp["pred"]["b"], jp["out"]["w"], jp["out"]["b"],
                ths=ths, ndur=nd, blank_id=blank, blank_penalty=blank_penalty,
                packed=joint_packed)
            toks = toks.view(b, tq).long()
            dur_sel = dur_sel.view(b, tq).long()
            tok_logits = penalized(logits[:, :ths].reshape(b, tq, ths))
        else:
            h = torch.relu(enc_proj + _proj(jp["pred"], g)[:, None, :])
            logits = _proj(jp["out"], h)                           # [B, T, V]
            tok_logits = penalized(logits[..., :ths])
            toks = torch.argmax(tok_logits, dim=-1)
            dur_sel = torch.argmax(logits[..., ths:ths + nd], dim=-1)
        return finish(toks, dur_sel, tok_logits, n)

    def step_vals(g, n, t_c):
        """One joint per row at its CURRENT step only: [B, V]."""
        e_t = enc_proj[torch.arange(b, device=dev), torch.as_tensor(t_c, device=dev)]
        h = torch.relu(e_t + _proj(jp["pred"], g))
        logits = _proj(jp["out"], h)
        tok_logits = penalized(logits[:, :ths])
        toks = torch.argmax(tok_logits, dim=-1)
        dur_sel = torch.argmax(logits[:, ths:ths + nd], dim=-1)
        return finish(toks, dur_sel, tok_logits, n)

    g, h, c, y_id = state.g, state.h, state.c, state.y_id
    bi = np.arange(b)
    u_count = np.zeros(b, np.int64)
    n = np.zeros(b, np.int64)
    tokens = np.full((b, max_tokens), -1, np.int64)
    frames_buf = np.full((b, max_tokens), -1, np.int64)
    durs_buf = np.full((b, max_tokens), -1, np.int64)
    logps_buf = np.zeros((b, max_tokens), np.float32)
    any_stale = True
    tok_vec = dur_vec = conf_vec = None
    while np.any(time_idx < t_enc_h):
        greedy_decode_loop.iterations += 1
        t_c = np.clip(time_idx, 0, tq - 1)
        if blank_run:
            if any_stale:
                tok_vec, dur_vec, conf_vec = compute_vecs(g, n)
            best, duration, conf = tok_vec[bi, t_c], dur_vec[bi, t_c], conf_vec[bi, t_c]
        else:
            best, duration, conf = step_vals(g, n, t_c)
        active = time_idx < t_enc_h
        is_blank = best == blank
        advance = np.where(is_blank & (duration == 0), 1, duration)
        if records is not None:
            records.append((time_idx[0], u_count[0], y_host[0], best[0], duration[0],
                            advance[0], is_blank[0]))
        hit_cap = u_count >= (max_symbols - 1)
        advance = np.where((advance == 0) & hit_cap, 1, advance)
        emit = active & ~is_blank & (n < max_tokens)
        if emit.any():
            emit_t = torch.as_tensor(emit, device=dev)
            best_t = torch.as_tensor(best, device=dev)
            g2, h2, c2 = predictor_step(params["predictor"],
                                        torch.where(emit_t, best_t, y_id.long()), h, c)
            g = torch.where(emit_t[:, None], g2, g)
            h = torch.where(emit_t[None, :, None], h2, h)
            c = torch.where(emit_t[None, :, None], c2, c)
            y_id = torch.where(emit_t, best_t.to(y_id.dtype), y_id)
            rows = bi[emit]
            tokens[rows, n[rows]] = best[rows]
            frames_buf[rows, n[rows]] = t_c[rows]
            durs_buf[rows, n[rows]] = duration[rows]
            logps_buf[rows, n[rows]] = conf[rows]
            if y_host is not None:
                y_host[rows] = best[rows]
        n = n + emit
        u_count = np.where(advance > 0, 0, u_count + 1)
        time_idx = time_idx + np.where(active, advance, 0)
        any_stale = bool(emit.any())
    carry = np.maximum(time_idx - t_enc_h, 0)
    new_state = state._replace(g=g, h=h, c=c, y_id=y_id, time_carry=torch.as_tensor(
        carry, dtype=torch.int32, device=dev))
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    out = (i32(tokens), i32(n), new_state)
    if with_timestamps:
        out = out + ((i32(frames_buf), i32(durs_buf), torch.from_numpy(logps_buf)),)
    if records is not None:
        out = out + (trace_buffer(records, tq * max_symbols),)
    return out


def trace_buffer(records, rows: int):
    """The trace rows as the JAX decoder's buffer: [rows, 7] int32, -1
    padded, a step past the last row overwriting it; and the step count
    (0-d int32)."""
    buf = np.full((rows, 7), -1, np.int32)
    n = len(records)
    if n:
        buf[:min(n, rows)] = np.asarray(records[:rows], np.int64)
        buf[min(n, rows) - 1] = records[-1]
    return torch.from_numpy(buf), torch.tensor(n, dtype=torch.int32)


greedy_decode_loop.iterations = 0     # loop iterations, all calls
