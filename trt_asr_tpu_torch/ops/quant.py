"""Int8 weight-only quantization primitives.

Weights live as int8 with a per-output-channel f32 scale. Exactness
structure (as in the JAX package): int8 -> bf16/f32 conversion is exact,
and a per-OUTPUT-channel scale commutes with the contraction, so
``x @ (q * s) == (x @ q) * s`` and dequantization is one multiply on the
f32 accumulator.

Activation policy for f32 callers (``TRT_ASR_Q8_ACT``, read once):
"bf16" (default) rounds activations to bf16 before the product; "split"
splits ``a = hi + lo`` into two exact bf16 operands and sums both products.
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


def q8_matmul(a: torch.Tensor, t: QuantTensor) -> torch.Tensor:
    """a @ dequantize(t), computed as (a @ q) * s with f32 accumulation.
    Output dtype follows the activation dtype (matches ops.common.matmul)."""
    w = t.q.float()                                   # exact integers
    if a.dtype == torch.float32 and _Q8_ACT == "split":
        hi = round_bf16(a)
        lo = round_bf16(a - hi)
        out = torch.matmul(hi, w) + torch.matmul(lo, w)
    else:
        out = torch.matmul(round_bf16(a.float()), w)
    out = out * t.s
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
