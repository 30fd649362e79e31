"""Shared numeric primitives.

Float32 products run in full f32 (the precision policy in ``device.py``
turns TF32 off). bf16 inputs are multiplied with f32 accumulation and the
result is cast back to bf16, as the JAX package's ``preferred_element_type``
does. ``matmul`` dispatches on :class:`QuantTensor` weights.
"""

from __future__ import annotations

import torch

from trt_asr_tpu_torch.ops.quant import QuantTensor, q8_matmul


def matmul(a: torch.Tensor, b) -> torch.Tensor:
    """a @ b with f32 accumulation; ``b`` may be a QuantTensor."""
    if isinstance(b, QuantTensor):
        return q8_matmul(a, b)
    out = torch.matmul(a.float(), b.float())
    return out.to(a.dtype) if a.dtype == torch.bfloat16 else out


def einsum(spec: str, *args: torch.Tensor) -> torch.Tensor:
    out = torch.einsum(spec, *[x.float() for x in args])
    return out.to(args[0].dtype) if args[0].dtype == torch.bfloat16 else out


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, stats in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def batch_norm_inference(x: torch.Tensor, gamma, beta, mean, var,
                         eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm over the channel (last) axis."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    bias = beta.float() - mean.float() * scale
    return (x.float() * scale + bias).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)
