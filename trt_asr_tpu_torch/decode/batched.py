"""Batched TDT greedy decode of one chunk (all streams in lockstep).

Same decisions as the JAX package's ``decode/batched.py``
``tdt_greedy_decode_batch``; its ``lax.while_loop`` becomes a Python loop
whose control state (time index, per-step symbol count, emitted count)
lives on the host, while the predictor state and the joint run on the
device. Two regimes, switched on the shape as in the JAX version:

- blank-run (B*T <= 256, the streaming case): the token/duration argmax of
  EVERY (row, step) is computed in one joint call under the current
  predictor output g and copied to the host; the loop then walks blank
  runs on the host and recomputes only after an emission changed g.
  Host syncs per chunk = 1 (the chunk's valid length and carried time
  offset) + the number of recomputes (1 + the iterations that emitted).
- per-row (B*T > 256): one [B, V] joint per iteration at each row's
  current step, one host sync per iteration.

``use_pallas_joint`` routes the blank-run joint through the fused CUDA
joint-step kernel (``ops/kernels/joint_step.py``) when B*T <= 128.
``tdt_greedy_decode_batch.iterations`` counts loop iterations over all
calls (a plain int, as the kernels' launch counters).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.decode.tdt_greedy import DecodeState
from trt_asr_tpu_torch.models.parakeet.joint import _proj, joint_project_enc
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step
from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step


def tdt_greedy_decode_batch(
    params: Dict[str, Any],
    cfg: ModelConfig,
    enc: torch.Tensor,              # [B, T, D]
    t_enc,                          # [B] valid steps (tensor or array)
    state: DecodeState,             # batch B
    *,
    max_tokens: int,
    max_symbols: Optional[int] = None,
    blank_penalty: float = 0.0,
    emitted_so_far=None,            # [B] tokens emitted before this chunk
    punct_mask=None,                # [ths] bool: suppressed as the first token
    use_punct_mask: bool = False,
    use_pallas_joint: bool = False,
    with_timestamps: bool = False,
):
    """Returns (tokens [B, max_tokens] (-1 padded), n [B], new_state) and,
    with ``with_timestamps``, ``(frames, durs, logps)`` [B, max_tokens]
    (-1/-1/0 padded): each token's within-chunk frame, predicted duration
    and decode-time log-softmax confidence. Tokens, counts and stamps are
    host (CPU) tensors; the new state stays on the device."""
    b, tq = enc.shape[0], enc.shape[1]
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
    host = torch.stack([torch.as_tensor(t_enc, device=dev).reshape(b).long(),
                        state.time_carry.long()]).cpu().numpy()
    t_enc_h, time_idx = host[0], host[1].copy()
    blank_run = b * tq <= 256
    use_kernel = use_pallas_joint and b * tq <= 128

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
                ths=ths, ndur=nd, blank_id=blank, blank_penalty=blank_penalty)
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
        tdt_greedy_decode_batch.iterations += 1
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
        n = n + emit
        u_count = np.where(advance > 0, 0, u_count + 1)
        time_idx = time_idx + np.where(active, advance, 0)
        any_stale = bool(emit.any())
    carry = np.maximum(time_idx - t_enc_h, 0)
    new_state = DecodeState(g=g, h=h, c=c, y_id=y_id,
                            time_carry=torch.as_tensor(carry, dtype=torch.int32, device=dev))
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    out = (i32(tokens), i32(n), new_state)
    if with_timestamps:
        out = out + ((i32(frames_buf), i32(durs_buf), torch.from_numpy(logps_buf)),)
    return out


tdt_greedy_decode_batch.iterations = 0     # loop iterations, all calls
