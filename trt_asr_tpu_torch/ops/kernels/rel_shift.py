"""Relative-position bias with the Transformer-XL shift: the CUDA kernel
``csrc/rel_shift.cu`` and its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/rel_shift_kernel.py:rel_pos_bias_shifted``:
``bd[b, h, t, s] = q_v[b, t, h] . pos_proj[Tq - 1 - t + s, h]``, already
shifted, summed in f32 and rounded once to ``q_v``'s type. The plain version
is the offline attention's einsum followed by the static shift (pad,
reshape, slice), as the JAX package's XLA path computes it. The kernel reads
only the band of positions each tile of rows needs (see the source's note);
in bf16 it sums on the tensor cores, in f32 on the CUDA cores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from trt_asr_tpu_torch.ops.common import einsum
from trt_asr_tpu_torch.ops.kernels import build as kb

MAX_HEAD_DIM = 128       # RS_DMAX of csrc/rel_shift.cu


def rel_shift(pd: torch.Tensor, tkv: int) -> torch.Tensor:
    """The static Transformer-XL shift of pd [B, H, Tq, R]:
    ``bd[..., t, s] = pd[..., t, Tq - 1 - t + s]`` for s < tkv (a view)."""
    b, h, tq, r = pd.shape
    padded = F.pad(pd, (1, 0))
    return padded.reshape(b, h, tq * (r + 1))[..., tq:].reshape(b, h, tq, r)[..., :tkv]


def rel_pos_bias_shifted_plain(q_v: torch.Tensor, pos_proj: torch.Tensor, *,
                               tkv: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch. q_v [B, Tq, H, dh], pos_proj
    [R, H, dh] with R >= Tq + tkv - 1 (cast to q_v's type first). Returns
    bd [B, H, Tq, tkv] in q_v's type."""
    pd = einsum("bthd,rhd->bhtr", q_v, pos_proj.to(q_v.dtype))
    return rel_shift(pd, tkv)


def rel_pos_bias_shifted(q_v: torch.Tensor, pos_proj: torch.Tensor, *,
                         tkv: int) -> torch.Tensor:
    """Shifted rel-pos bias; same arguments and result as
    :func:`rel_pos_bias_shifted_plain` (the result is contiguous). CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if q_v.device.type == "cpu":
        return rel_pos_bias_shifted_plain(q_v, pos_proj, tkv=tkv)
    b, tq, h, dh = q_v.shape
    if q_v.dtype not in kb.DTYPE_CODES:
        raise TypeError(f"rel_pos_bias_shifted: q_v must be f32 or bf16, got {q_v.dtype}")
    pos = pos_proj.to(q_v.dtype)
    if pos.dim() != 3 or pos.shape[1:] != (h, dh) or pos.shape[0] < tq + tkv - 1:
        raise ValueError(f"rel_pos_bias_shifted: pos_proj {tuple(pos.shape)} does not fit "
                         f"q_v {tuple(q_v.shape)} and tkv={tkv}")
    if dh > MAX_HEAD_DIM or dh % 4:
        raise ValueError(f"rel_pos_bias_shifted: head dim {dh} is not a multiple of 4 "
                         f"up to {MAX_HEAD_DIM}")
    kb.require_cuda("rel_pos_bias_shifted", q_v, pos)
    kb.require_aligned("rel_pos_bias_shifted", 4, q_v, pos)
    out = torch.empty((b, h, tq, tkv), dtype=q_v.dtype, device=q_v.device)
    if out.numel() == 0:
        return out
    lib = kb.load("rel_shift")
    rc = lib.rel_shift_launch(q_v.data_ptr(), pos.data_ptr(), b, tq, h, dh, pos.shape[0],
                              tkv, kb.DTYPE_CODES[q_v.dtype], out.data_ptr(),
                              kb.stream_ptr(q_v.device))
    kb.check(lib, rc, "rel_pos_bias_shifted")
    rel_pos_bias_shifted.launches += 1
    return out


rel_pos_bias_shifted.launches = 0
