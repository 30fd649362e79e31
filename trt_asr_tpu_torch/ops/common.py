"""Shared numeric primitives.

Float32 products run in full f32 (the precision policy in ``device.py``
turns TF32 off). bf16 inputs are multiplied with f32 accumulation and the
result is cast back to bf16, as the JAX package's ``preferred_element_type``
does: a bf16 activation times an f32 weight is an f32 product (JAX promotes
the pair to f32); a bf16 activation times a bf16 weight (the weights of
``cast_params_for_compute``) goes, on the card, to cuBLAS's bf16 tensor-core
product, whose sums are f32 (split-K reductions too: ``device.py``) and are
rounded once to bf16. On the CPU that pair takes the f32 product of the
widened operands, the same products summed in another order.
``matmul`` dispatches on :class:`QuantTensor` weights. An f32 activation
times a bf16 weight widens the weight to f32 at the call (JAX's promotion),
counted in ``matmul.widened``.
"""

from __future__ import annotations

import torch

from trt_asr_tpu_torch.ops.quant import QuantTensor, q8_matmul


def matmul(a: torch.Tensor, b) -> torch.Tensor:
    """a @ b with f32 accumulation; ``b`` may be a QuantTensor."""
    if isinstance(b, QuantTensor):
        return q8_matmul(a, b)
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.matmul(a, b)
    if b.dtype == torch.bfloat16 and a.dtype == torch.float32:
        matmul.widened += 1
    out = torch.matmul(a.float(), b.float())
    return out.to(a.dtype) if a.dtype == torch.bfloat16 else out


matmul.widened = 0     # calls that widened a bf16 weight for an f32 activation


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


# a 0-d CPU tensor: a binary op on a card tensor takes it as a scalar, so
# it costs no allocation and no fill launch there
_ZERO = torch.zeros(())


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0), the values of ``torch.relu`` in x's dtype; its gradient at
    x == 0 is half the incoming one, as JAX's ``jnp.maximum(x, 0)``
    differentiates (a zero-padded window with zero biases sits exactly at
    0)."""
    return torch.maximum(x, _ZERO)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)
