"""Int8 weight-only quantization primitives.

Weights live as int8 with a per-output-channel f32 scale. Exactness
structure (as in the JAX package): int8 -> bf16/f32 conversion is exact,
and a per-OUTPUT-channel scale commutes with the contraction, so
``x @ (q * s) == (x @ q) * s`` and dequantization is one multiply on the
f32 accumulator.

Activation policy for f32 callers (``TRT_ASR_Q8_ACT``, read once):
"bf16" (default) rounds activations to bf16 before the product; "split"
splits ``a = hi + lo`` into two exact bf16 operands and sums both products.

On the card the product runs as the JAX package computes it: q widened to
bf16 (exact, |q| <= 127) times the bf16 activation on the tensor cores, with
f32 sums (cuBLAS's bf16 product with an f32 output), the scale on the f32
sums. The model keeps each weight's bf16 copy beside q, made once
(:func:`keep_bf16_copy`); a weight on the card without one is widened at the
call and counted in ``q8_matmul.widened``. On the CPU the product is the f32
product of the rounded activation and the widened q.

The kernels read small parameters (biases, conv taps) in f32: a bf16 one
keeps an f32 copy beside it, made once (:func:`keep_f32_copy`,
:func:`as_f32`).
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import torch

_Q8_ACT = os.environ.get("TRT_ASR_Q8_ACT", "bf16").lower()
if _Q8_ACT not in ("bf16", "split"):
    warnings.warn(f"TRT_ASR_Q8_ACT={_Q8_ACT!r} unknown; using 'bf16'")
    _Q8_ACT = "bf16"


class QuantTensor(NamedTuple):
    """int8 weight + per-output-channel scale."""

    q: torch.Tensor   # int8 [..., in, out]
    s: torch.Tensor   # f32  [..., 1, out]


def quantize_tensor(w: torch.Tensor) -> QuantTensor:
    """Symmetric per-output-channel (last axis) int8 quantization.
    w [..., in, out]; scale = amax over the contraction (in) axis / 127."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return QuantTensor(q, s)


def dequantize(t: QuantTensor, dtype=torch.float32) -> torch.Tensor:
    return (t.q.float() * t.s).to(dtype)


def round_bf16(a: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 precision, keeping the f32 dtype."""
    return a.to(torch.bfloat16).float()


# the attribute of a QuantTensor's q that holds its bf16 copy on the card
_BF16_COPY = "q8_bf16"


def keep_bf16_copy(q: torch.Tensor, copy: torch.Tensor | None = None) -> None:
    """Keeps a bf16 copy of the int8 tensor ``q`` beside it (an attribute of
    ``q``), for :func:`q8_matmul` on the card: ``copy`` (a view of a larger
    tensor's copy, e.g. one layer of a stacked weight) or ``q`` widened now.
    Made once, where the weights are made: a copy that no longer matches q
    gives wrong results. 2 bytes a weight."""
    if copy is None:
        copy = q.to(torch.bfloat16)
    if copy.shape != q.shape or copy.dtype != torch.bfloat16 or copy.device != q.device:
        raise ValueError(f"bf16 copy {copy.dtype} {tuple(copy.shape)} on {copy.device} does "
                         f"not fit q {tuple(q.shape)} on {q.device}")
    setattr(q, _BF16_COPY, copy)


def bf16_copy(q: torch.Tensor) -> torch.Tensor | None:
    """The bf16 copy kept beside ``q`` by :func:`keep_bf16_copy`, if any."""
    return getattr(q, _BF16_COPY, None)


# the attribute of a small bf16 tensor (a bias, conv taps) that holds its f32 copy
_F32_COPY = "f32_copy"


def keep_f32_copy(t: torch.Tensor) -> None:
    """Keeps an f32 copy of the small non-f32 tensor ``t`` beside it (an
    attribute of ``t``), for the kernels that read it in f32 (:func:`as_f32`).
    Made once, where the weights are made: a copy that no longer matches t
    gives wrong results. An f32 tensor needs none."""
    if t.dtype != torch.float32:
        setattr(t, _F32_COPY, t.float())


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32 for a kernel: itself, the copy kept beside it
    (:func:`keep_f32_copy`), or a copy made now, whose call
    ``as_f32.widened`` counts and whose bytes (read and written)
    ``as_f32.widened_bytes`` adds up."""
    if t.dtype == torch.float32:
        return t
    copy = getattr(t, _F32_COPY, None)
    if copy is not None:
        return copy
    as_f32.widened += 1
    as_f32.widened_bytes += t.numel() * (t.element_size() + 4)
    return t.float()


as_f32.widened = 0          # copies made at a call
as_f32.widened_bytes = 0    # their bytes, read and written


def q8_matmul(a: torch.Tensor, t: QuantTensor) -> torch.Tensor:
    """a @ dequantize(t), computed as (a @ q) * s with f32 accumulation.
    Output dtype follows the activation dtype (matches ops.common.matmul).
    CUDA tensors take the tensor cores (:func:`_q8_matmul_cuda`), CPU
    tensors the f32 product (:func:`_q8_matmul_f32`)."""
    return (_q8_matmul_cuda if a.is_cuda else _q8_matmul_f32)(a, t)


def _q8_matmul_f32(a: torch.Tensor, t: QuantTensor) -> torch.Tensor:
    """:func:`q8_matmul` as the f32 product of the rounded activation and q
    widened to f32 (exact integers) at the call."""
    w = t.q.float()                                   # exact integers
    if a.dtype == torch.float32 and _Q8_ACT == "split":
        hi = round_bf16(a)
        lo = round_bf16(a - hi)
        out = torch.matmul(hi, w) + torch.matmul(lo, w)
    else:
        out = torch.matmul(round_bf16(a.float()), w)
    out = out * t.s
    return out.to(a.dtype) if a.dtype == torch.bfloat16 else out


q8_matmul.widened = 0     # calls on the card that widened q for want of its copy


def _q8_matmul_cuda(a: torch.Tensor, t: QuantTensor) -> torch.Tensor:
    """:func:`q8_matmul` on the card: bf16 operands, f32 sums
    (``torch.mm(..., out_dtype=torch.float32)``, CUDA only), activations of
    any rank taken as 2-D rows."""
    if t.q.dim() != 2:
        raise ValueError(f"q8_matmul: the card takes a 2-D weight, got {tuple(t.q.shape)}")
    w = bf16_copy(t.q)
    if w is None:
        q8_matmul.widened += 1
        w = t.q.to(torch.bfloat16)                    # exact
    a2 = a.reshape(-1, a.shape[-1])
    if a.dtype == torch.float32 and _Q8_ACT == "split":
        hi = a2.to(torch.bfloat16)
        lo = (a2 - hi.float()).to(torch.bfloat16)
        out = (torch.mm(hi, w, out_dtype=torch.float32)
               + torch.mm(lo, w, out_dtype=torch.float32))
    else:
        out = torch.mm(a2.to(torch.bfloat16), w, out_dtype=torch.float32)
    out = (out * t.s).reshape(*a.shape[:-1], w.shape[1])
    return out.to(a.dtype) if a.dtype == torch.bfloat16 else out


def is_low_precision(w) -> bool:
    """A weight whose products take bf16 operands: int8 or bf16 storage."""
    return isinstance(w, QuantTensor) or w.dtype == torch.bfloat16


def scaled_matmul(a: torch.Tensor, w) -> torch.Tensor:
    """a @ w in f32 for a float weight or a QuantTensor (the int8 product
    times the per-channel scale), with ``a`` taken as given: the kernels'
    plain versions round their operands themselves."""
    if isinstance(w, QuantTensor):
        return torch.matmul(a, w.q.float()) * w.s.reshape(-1)
    return torch.matmul(a, w.float())
