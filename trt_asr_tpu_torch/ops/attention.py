"""Relative-position multi-head attention (Transformer-XL style) over a
ring-ordered streaming kv cache.

Only the streaming branch is ported: the caller gives ``rel_idx``, the
positional-table index of every (query, kv slot) pair, so the cache can be
consumed in ring order. The offline relative shift waits for the offline
encoder.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from trt_asr_tpu_torch.ops.common import einsum, matmul


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
) -> torch.Tensor:
    """Attention core on pre-projected q/k/v. Returns [B, Tq, D]."""
    if rel_idx is None:
        raise NotImplementedError(
            "offline (static relative shift) attention is not ported yet; "
            "pass rel_idx")
    b, tq, h, dh = q.shape
    tkv = k.shape[1]
    q_u = q + pos_bias_u.to(q.dtype)[None, None]
    q_v = q + pos_bias_v.to(q.dtype)[None, None]
    pd = einsum("bthd,rhd->bhtr", q_v, pos_proj.to(q.dtype))        # [B,H,Tq,R]
    idx = rel_idx.long()[:, None].expand(b, h, tq, tkv)
    bd = torch.gather(pd, -1, idx)
    ac = einsum("bthd,bshd->bhts", q_u, k)                          # [B,H,Tq,Tkv]
    scores = (ac + bd).float() / math.sqrt(dh)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, :], scores,
                             torch.full((), -1e30, dtype=torch.float32,
                                        device=scores.device))
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    out = einsum("bhts,bshd->bthd", att, v).reshape(b, tq, h * dh)
    return matmul(out, wo)
