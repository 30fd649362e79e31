"""Offline attention with a relative-position bias and an online softmax:
the CUDA kernel ``csrc/flash_att.cu`` and its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/flash_att_kernel.py:flash_bias_attention``
and keeps its numbers, which differ from the plain attention path's: ``bd``
is cast to the operand type, masked kv columns take -1e9 (in that type) in
place of ``bd``, ``s = (q_u . k in f32 + bd) / sqrt(dh)``, the softmax runs
online over key blocks of 128 (the TPU kernel's block: its running max,
from -1e30, moves at the same keys), ``p`` is rounded to ``v``'s type before
``p . v``, sums are f32, and the result is divided by ``max(l, 1e-30)``.
The TPU wrapper folds the mask into a padded bias tensor (its block rule);
reading ``kv_mask`` directly gives the same result for every row with a
valid key. The result is the context before the output projection,
``[B, T, H * dh]`` f32.
"""

from __future__ import annotations

import math

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb

MASKED_BIAS = -1e9
KEY_BLOCK = 128
MAX_HEAD_DIM = 128       # FA_DMAX of csrc/flash_att.cu
MAX_COPY_BYTES = 16      # the widest asynchronous copy (cp.async)


def flash_bias_attention_plain(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bd: torch.Tensor, kv_mask: torch.Tensor,
                               qk: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch. q_u, k, v [B, T, H, dh] of one
    type, bd [B, H, T, T] (unscaled), kv_mask [B, T] bool (True = attend).
    Returns [B, T, H * dh] f32. q_u . k is an f32 einsum, unless a check
    passes its own sums as ``qk`` [B, H, T, T] f32."""
    b, t, h, dh = q_u.shape
    if t == 0:
        return torch.zeros((b, 0, h * dh), dtype=torch.float32, device=q_u.device)
    dtype = q_u.dtype
    neg = torch.full((), MASKED_BIAS, dtype=dtype, device=q_u.device)
    bdm = torch.where(kv_mask[:, None, None, :], bd.to(dtype), neg)
    if qk is None:
        qk = torch.einsum("bthd,bshd->bhts", q_u.float(), k.float())
    s = (qk + bdm.float()) * (1.0 / math.sqrt(dh))
    vf = v.float()
    m = torch.full((b, h, t, 1), -1e30, device=q_u.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, t, dh), device=q_u.device)
    for j0 in range(0, t, KEY_BLOCK):
        sj = s[..., j0:j0 + KEY_BLOCK]
        m_new = torch.maximum(m, sj.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sj - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhts,bshd->bhtd", p.to(v.dtype).float(),
                                         vf[:, j0:j0 + KEY_BLOCK])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).reshape(b, t, h * dh)


def copy_bytes(addr: int, strides_bytes) -> int:
    """The widest copy, a power of two up to ``MAX_COPY_BYTES``, that divides
    a view's first address and each of its strides in bytes: every copy of
    that width taken at those steps starts on a multiple of it."""
    width = MAX_COPY_BYTES
    for x in (addr, *strides_bytes):
        while x % width:
            width //= 2
    return width


def copy_widths(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bd: torch.Tensor) -> tuple:
    """The bf16 kernel's copy widths in bytes (its template parameters):
    for the rows of q_u, k and v [B, T, H, dh] (contiguous, so a head's row
    starts every dh elements: 16 or 8) and for bd's rows [B, H, T, T] (its
    row stride, and its plane stride where there is more than one plane: 16,
    8, 4 or 2; the plain shift's view, with an odd row stride, takes 2)."""
    b, _, h, dh = q_u.shape
    es = q_u.element_size()
    qkv = min(copy_bytes(x.data_ptr(), (dh * es,)) for x in (q_u, k, v))
    strides = (bd.stride(2), bd.stride(1 if h > 1 else 0)) if b * h > 1 else (bd.stride(2),)
    return qkv, copy_bytes(bd.data_ptr(), tuple(s * bd.element_size() for s in strides))


def flash_bias_attention(q_u: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bd: torch.Tensor, kv_mask: torch.Tensor) -> torch.Tensor:
    """Blocked attention with bias; same arguments and result as
    :func:`flash_bias_attention_plain`. ``bd`` may be a strided view (unit
    column stride, evenly strided rows and (b, h) planes), as the plain
    shift returns it. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    if q_u.device.type == "cpu":
        return flash_bias_attention_plain(q_u, k, v, bd, kv_mask)
    b, t, h, dh = q_u.shape
    dtype = q_u.dtype
    if dtype not in kb.DTYPE_CODES or k.dtype != dtype or v.dtype != dtype:
        raise TypeError("flash_bias_attention: q_u, k and v must share one type, f32 or bf16")
    if k.shape != q_u.shape or v.shape != q_u.shape or bd.shape != (b, h, t, t) \
            or kv_mask.shape != (b, t):
        raise ValueError("flash_bias_attention: shape mismatch")
    if kv_mask.dtype != torch.bool:
        raise TypeError("flash_bias_attention: kv_mask must be bool")
    if dh > MAX_HEAD_DIM or dh % 4:
        raise ValueError(f"flash_bias_attention: head dim {dh} is not a multiple of 4 "
                         f"up to {MAX_HEAD_DIM}")
    kb.require_cuda("flash_bias_attention", q_u, k, v, kv_mask)
    kb.require_aligned("flash_bias_attention", 4, q_u, k, v)
    bd = bd.to(dtype)
    plane, ld = bd.stride(1 if h > 1 else 0), bd.stride(2)
    if bd.device != q_u.device or bd.stride(3) != 1 or ld < t or plane < t * ld \
            or (b > 1 and bd.stride(0) != h * plane):
        raise ValueError("flash_bias_attention: bd must lie on q_u's device with unit "
                         "column stride and evenly strided rows and planes")
    out = torch.empty((b, t, h * dh), dtype=torch.float32, device=q_u.device)
    if out.numel() == 0:
        return out
    neg = float(torch.tensor(MASKED_BIAS, dtype=dtype))
    qkv_bytes, bd_bytes = copy_widths(q_u, k, v, bd) if dtype == torch.bfloat16 else (0, 0)
    lib = kb.load("flash_att")
    rc = lib.flash_att_launch(q_u.data_ptr(), k.data_ptr(), v.data_ptr(), bd.data_ptr(), plane,
                              ld, kv_mask.data_ptr(), b, t, h, dh, kb.DTYPE_CODES[dtype],
                              qkv_bytes, bd_bytes, 1.0 / math.sqrt(dh), neg, out.data_ptr(),
                              kb.stream_ptr(q_u.device))
    kb.check(lib, rc, "flash_bias_attention")
    flash_bias_attention.launches += 1
    return out


flash_bias_attention.launches = 0
