"""Batched TDT greedy decode of one chunk (all streams in lockstep).

Same decisions as the JAX package's ``decode/batched.py``
``tdt_greedy_decode_batch``: blank-run batching when B*T <= 256 (the
streaming case), one joint per row and iteration above that, and the fused
joint-step kernel for the blank-run joint when ``use_pallas_joint`` and
B*T <= 128. The loop itself is ``decode/greedy_loop.py``'s. Also the
engine's per-row decode-state reset, ``reset_decode_state_rows``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.decode.greedy_loop import greedy_decode_loop
from trt_asr_tpu_torch.decode.tdt_greedy import (DecodeState, init_decode_state,
                                                 prime_decode_state)


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
    joint_packed=None,              # the int8 or f32 joint weights packed once (pack_joint_step)
    trace: bool = False,
):
    """Returns (tokens [B, max_tokens] (-1 padded), n [B], new_state) and,
    with ``with_timestamps``, ``(frames, durs, logps)`` [B, max_tokens]
    (-1/-1/0 padded): each token's within-chunk frame, predicted duration
    and decode-time log-softmax confidence. Tokens, counts and stamps are
    host (CPU) tensors; the new state stays on the device. ``joint_packed``
    goes to the joint-step kernel (int8 or f32 weights), which packs anew at
    every call without it. ``trace`` (B = 1) appends the decode trace's
    ``(records, n_steps)`` (``greedy_decode_loop``)."""
    b, tq = enc.shape[0], enc.shape[1]
    return greedy_decode_loop(
        params, cfg, enc, t_enc, state, max_tokens=max_tokens, max_symbols=max_symbols,
        blank_penalty=blank_penalty, emitted_so_far=emitted_so_far, punct_mask=punct_mask,
        use_punct_mask=use_punct_mask, with_timestamps=with_timestamps,
        blank_run=b * tq <= 256, use_kernel=use_pallas_joint and b * tq <= 128,
        joint_packed=joint_packed, trace=trace)


def reset_decode_state_rows(params, cfg: ModelConfig, state: DecodeState, row_mask,
                            prompt_ids) -> DecodeState:
    """Re-initialize (and re-prime with ``prompt_ids``) the decode state of
    the streams where ``row_mask`` [B] is True: a slot attaching or
    detaching in the lockstep engine. Returns a new state."""
    b, dev = state.g.shape[0], state.g.device
    fresh = prime_decode_state(params, cfg, init_decode_state(cfg, b, device=dev), prompt_ids)
    m = torch.as_tensor(row_mask, device=dev).reshape(b)
    return DecodeState(g=torch.where(m[:, None], fresh.g, state.g),
                       h=torch.where(m[None, :, None], fresh.h, state.h),
                       c=torch.where(m[None, :, None], fresh.c, state.c),
                       y_id=torch.where(m, fresh.y_id, state.y_id),
                       time_carry=torch.where(m, torch.zeros_like(state.time_carry),
                                              state.time_carry))
