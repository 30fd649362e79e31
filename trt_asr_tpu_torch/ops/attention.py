"""Relative-position multi-head attention (Transformer-XL style).

Two branches, as in the JAX package's ``ops/attention.py``:

- streaming: the caller gives ``rel_idx``, the positional-table index of
  every (query, kv slot) pair, so a ring-ordered kv cache can be consumed in
  ring order;
- offline (``rel_idx=None``, no cache): the static shift
  ``bd[t, s] = pd[t, Tq - 1 - t + s]``, by the fused rel-shift kernel
  (``use_shift_kernel``; auto on CUDA bf16 at Tq >= 128) or by pad, reshape
  and slice; ``use_flash`` runs the blocked flash kernel over it when its
  static gate holds, and warns when it does not.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from trt_asr_tpu_torch.ops.common import einsum, matmul
from trt_asr_tpu_torch.ops.kernels.flash_att import flash_bias_attention
from trt_asr_tpu_torch.ops.kernels.rel_shift import (rel_pos_bias_shifted,
                                                     rel_pos_bias_shifted_plain)

# Calls that asked for the flash kernel, and calls that took it: its gate is
# static (shapes, rel_idx), so a run labelled "flash" may not have used it.
flash_trace_counts = {"requested": 0, "taken": 0}


def sinusoidal_pos_table(tq: int, tkv: int, d_model: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Sinusoidal embeddings for relative distances, descending from
    (tkv-1) to -(tq-1). Shape [tq + tkv - 1, d_model]; sin on even
    indices, cos on odd (NeMo RelPositionalEncoding layout)."""
    positions = np.arange(tkv - 1, -tq, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * -(math.log(10000.0) / d_model))
    pe = np.zeros((positions.shape[0], d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(positions * div)
    pe[:, 1::2] = np.cos(positions * div)
    return torch.as_tensor(pe.astype(np.float32), device=device).to(dtype)


def rel_pos_attention_kv(
    q: torch.Tensor,              # [B, Tq, H, dh] (projected)
    k: torch.Tensor,              # [B, Tkv, H, dh] (projected, cache ++ new)
    v: torch.Tensor,              # [B, Tkv, H, dh]
    pos_proj: torch.Tensor,       # [Tq+Tkv-1, H, dh] (pos_table @ W_pos)
    pos_bias_u: torch.Tensor,     # [H, dh]
    pos_bias_v: torch.Tensor,     # [H, dh]
    wo,                           # [D, D] or QuantTensor
    kv_mask: Optional[torch.Tensor] = None,  # [B, Tkv] bool, True = attend
    rel_idx: Optional[torch.Tensor] = None,  # [B, Tq, Tkv] pos-table indices
    use_flash: bool = False,                 # offline: blocked flash kernel
    use_shift_kernel: Optional[bool] = None,  # offline: fused rel-shift kernel
                                              # (None = auto)
) -> torch.Tensor:
    """Attention core on pre-projected q/k/v. Returns [B, Tq, D]."""
    b, tq, h, dh = q.shape
    tkv = k.shape[1]
    q_u = q + pos_bias_u.to(q.dtype)[None, None]
    q_v = q + pos_bias_v.to(q.dtype)[None, None]
    if rel_idx is None:
        if use_shift_kernel is None:
            # the JAX package takes its kernel on the TPU at these shapes in
            # bf16; CUDA plays the TPU's part
            use_shift_kernel = (tq >= 128 and dh <= 128 and q.dtype == torch.bfloat16
                                and q.is_cuda)
        shift = rel_pos_bias_shifted if use_shift_kernel else rel_pos_bias_shifted_plain
        bd = shift(q_v, pos_proj, tkv=tkv)                          # [B,H,Tq,Tkv]
    else:
        pd = einsum("bthd,rhd->bhtr", q_v, pos_proj.to(q.dtype))    # [B,H,Tq,R]
        idx = rel_idx.long()[:, None].expand(b, h, tq, tkv)
        bd = torch.gather(pd, -1, idx)

    if use_flash:
        flash_trace_counts["requested"] += 1
        if rel_idx is None and tq == tkv and dh <= 128:
            flash_trace_counts["taken"] += 1
            mask = kv_mask if kv_mask is not None else torch.ones(
                (b, tkv), dtype=torch.bool, device=q.device)
            out = flash_bias_attention(q_u, k, v, bd, mask)
            return matmul(out.to(q.dtype), wo)
        reason = ("cached/ring kv (rel_idx given)" if rel_idx is not None
                  else f"tq={tq} != tkv={tkv}" if tq != tkv
                  else f"head_dim={dh} > 128")
        warnings.warn(f"use_flash requested but unavailable ({reason}); "
                      "falling back to the plain attention path - do not "
                      "label this run 'flash'", stacklevel=2)

    ac = einsum("bthd,bshd->bhts", q_u, k)                          # [B,H,Tq,Tkv]
    scores = (ac + bd).float() / math.sqrt(dh)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :], scores,
                             torch.full((), -1e30, dtype=torch.float32,
                                        device=scores.device))
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    out = einsum("bhts,bshd->bthd", att, v).reshape(b, tq, h * dh)
    return matmul(out, wo)
