"""Fused conformer feed-forward module: the CUDA kernel ``csrc/ffn.cu`` and
its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/ffn_kernel.py:fused_ffn_pallas``:
``x + scale * silu(LN(x) @ W1) @ W2``. The bound on the H100 is memory: one
read of W1 and W2 (33.6 MB f32, 8.4 MB int8 at full size) per call, for all
rows; the kernel reads each weight byte once (see the source's note).
"""

from __future__ import annotations

import torch

from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.quant import is_low_precision, round_bf16, scaled_matmul


def layer_norm_plain(x, g, b):
    """LayerNorm over the last axis (eps 1e-5) as the kernels compute it."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * (1.0 / torch.sqrt(var + 1e-5)) * g + b


def fused_ffn_plain(x, ln_g, ln_b, w1, w2, scale: float = 0.5):
    """The kernel's function in plain PyTorch, with its rounding points:
    with bf16 or int8 weights the LN output and silu(h) are rounded to
    bf16. x [..., T, D] f32; w1 [D, E], w2 [E, D] float or QuantTensor.
    Returns x + scale * silu(LN(x) @ w1) @ w2, f32 of x's shape."""
    rnd = round_bf16 if is_low_precision(w1) else (lambda t: t)
    u = rnd(layer_norm_plain(x, ln_g, ln_b))
    h = rnd(silu(scaled_matmul(u, w1)))
    return x + scale * scaled_matmul(h, w2)


def fused_ffn(x, ln_g, ln_b, w1, w2, scale: float = 0.5):
    """Fused FFN; same arguments and result as :func:`fused_ffn_plain`. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise). As the TPU kernel, it rounds f32 activations to bf16 before an
    int8 product whatever ``TRT_ASR_Q8_ACT`` says (no "split" mode)."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, ln_g, ln_b, w1, w2, scale)
    d = x.shape[-1]
    w1_t, s1, wtype = kb.weight_parts(w1)
    w2_t, s2, wtype2 = kb.weight_parts(w2)
    if wtype != wtype2:
        raise ValueError("fused_ffn: W1 and W2 must share one storage type")
    e = w1_t.shape[1]
    if w1_t.shape != (d, e) or w2_t.shape != (e, d):
        raise ValueError(f"fused_ffn: weights {tuple(w1_t.shape)}, {tuple(w2_t.shape)} "
                         f"do not fit D={d}")
    if any(t.dtype != torch.float32 for t in (x, ln_g, ln_b)):
        raise TypeError("fused_ffn: activations and norms must be f32")
    kb.require_cuda("fused_ffn", x, ln_g, ln_b, w1_t, w2_t,
                    *[s for s in (s1, s2) if s is not None])
    lib = kb.load("ffn")
    x2 = x.view(-1, d)
    m = x2.shape[0]
    dev = x.device
    y = torch.empty_like(x)
    u = torch.empty((m, d), dtype=torch.float32, device=dev)
    h = torch.empty((m, e), dtype=torch.float32, device=dev)
    ks1, ks2 = kb.gemm_splits(d), kb.gemm_splits(e)
    part = torch.empty((max(ks1 * e, ks2 * d) * m,), dtype=torch.float32, device=dev)
    rc = lib.ffn_launch(x2.data_ptr(), m, d, e, ln_g.data_ptr(), ln_b.data_ptr(),
                        w1_t.data_ptr(), kb.ptr(s1), w2_t.data_ptr(), kb.ptr(s2), wtype,
                        float(scale), ks1, ks2, y.data_ptr(), u.data_ptr(), h.data_ptr(),
                        part.data_ptr(), kb.stream_ptr(dev))
    kb.check(lib, rc, "fused_ffn")
    fused_ffn.launches += 1
    return y


fused_ffn.launches = 0
