"""Fused conformer convolution module (B=1 streaming chunks), alone and with
the second FFN and the output LayerNorm: the CUDA kernels of
``csrc/conv_block.cu`` and their plain PyTorch versions.

Replaces ``trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_block_pallas``
and ``:conv_ffn_ln_pallas``. The bound on the H100 is memory: pw1 and pw2
(12.6 MB f32, 3.1 MB int8 per layer at full size), plus FFN2's W1 and W2 in
the fused tail (11.5 MB int8 in all); the kernels read each weight byte
once for all rows (see the source's note).

Both functions return ``(y, c)``, each [Tq, D] f32: ``c`` holds the masked
post-GLU rows whose first ``cache_keep`` rows feed the time cache.
"""

from __future__ import annotations

import torch

from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.ffn import fused_ffn_plain, layer_norm_plain
from trt_asr_tpu_torch.ops.quant import QuantTensor, is_low_precision, round_bf16, scaled_matmul


def conv_block_plain(x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2,
                     time_cache, mask):
    """The kernel's function in plain PyTorch, with its rounding points:
    with bf16 or int8 weights the LN output and silu(BN(conv)) are rounded
    to bf16. x [Tq, D] f32; pw1 [D, 2D], pw2 [D, D] float or QuantTensor;
    dw [K, D] (K odd); time_cache [(K-1)/2, D]; mask [Tq, 1] f32 (1 = valid
    step). Returns (y = x + conv_module(x), c), both [Tq, D] f32."""
    rnd = round_bf16 if is_low_precision(pw1) else (lambda t: t)
    tq, d = x.shape
    kk = dw.shape[0]
    hw = scaled_matmul(rnd(layer_norm_plain(x, ln_g, ln_b)), pw1)
    c = hw[:, :d] * torch.sigmoid(hw[:, d:]) * mask
    ext = torch.cat([time_cache, c, c.new_zeros(((kk - 1) // 2, d))])
    cv = ext[0:tq] * dw[0]
    for j in range(1, kk):
        cv = cv + ext[j:j + tq] * dw[j]
    cv = (cv - bn_m) * (bn_g * torch.rsqrt(bn_v + 1e-5)) + bn_b
    return x + scaled_matmul(rnd(silu(cv)), pw2), c


def conv_ffn_ln_plain(x, conv_ln_g, conv_ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2,
                      time_cache, mask, ff_ln_g, ff_ln_b, ff_w1, ff_w2, out_ln_g, out_ln_b):
    """The conv module, then FFN2 (0.5 residual) and the output LayerNorm,
    in plain PyTorch; int8 weights only (TypeError otherwise). Returns
    (y = LN_out(x1 + 0.5 * FFN2(x1)) with x1 = x + conv_module(x), c)."""
    _require_int8(pw1, pw2, ff_w1, ff_w2)
    x1, c = conv_block_plain(x, conv_ln_g, conv_ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v,
                             pw2, time_cache, mask)
    x2 = fused_ffn_plain(x1, ff_ln_g, ff_ln_b, ff_w1, ff_w2, 0.5)
    return layer_norm_plain(x2, out_ln_g, out_ln_b), c


def _require_int8(*ws) -> None:
    if not all(isinstance(w, QuantTensor) for w in ws):
        raise TypeError("conv_ffn_ln takes int8 QuantTensor weights only")


def _conv_args(what, x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask):
    """Checks the conv module's inputs for the kernel; returns (pw1 parts,
    pw2 parts, wtype, kk)."""
    tq, d = x.shape
    kk = dw.shape[0]
    pw1_t, s1, wtype = kb.weight_parts(pw1)
    pw2_t, s2, wtype2 = kb.weight_parts(pw2)
    if wtype != wtype2:
        raise ValueError(f"{what}: pw1 and pw2 must share one storage type")
    if pw1_t.shape != (d, 2 * d) or pw2_t.shape != (d, d) or dw.shape != (kk, d):
        raise ValueError(f"{what}: weight shapes do not fit D={d}")
    if kk % 2 == 0 or time_cache.shape != ((kk - 1) // 2, d) or mask.shape != (tq, 1):
        raise ValueError(f"{what}: needs an odd kernel size, time_cache [(K-1)/2, D] "
                         f"and mask [Tq, 1]")
    # the depthwise taps run over [time cache ++ Tq rows ++ zeros] in 48 KB
    # of shared memory, 32 columns a block
    if (tq + kk - 1) * 32 * 4 > 48 * 1024:
        raise ValueError(f"{what}: Tq={tq} with a {kk}-tap conv exceeds the kernel's "
                         f"shared memory")
    floats = [x, ln_g, ln_b, dw, bn_g, bn_b, bn_m, bn_v, time_cache, mask]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{what}: activations, norms, conv weights, cache and mask must be f32")
    kb.require_cuda(what, *floats, pw1_t, pw2_t, *[s for s in (s1, s2) if s is not None])
    return (pw1_t, s1), (pw2_t, s2), wtype, kk


def conv_block(x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask):
    """Fused conv module; same arguments and results as
    :func:`conv_block_plain`. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    args = (x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask)
    if x.device.type == "cpu":
        return conv_block_plain(*args)
    (pw1_t, s1), (pw2_t, s2), wtype, kk = _conv_args("conv_block", *args)
    lib = kb.load("conv_block")
    tq, d = x.shape
    y, c, u, a = (torch.empty_like(x) for _ in range(4))
    ksplit = kb.gemm_splits(d)
    part = torch.empty((ksplit * tq * 2 * d,), dtype=torch.float32, device=x.device)
    rc = lib.conv_block_launch(
        x.data_ptr(), tq, d, ln_g.data_ptr(), ln_b.data_ptr(), pw1_t.data_ptr(), kb.ptr(s1),
        dw.data_ptr(), kk, bn_g.data_ptr(), bn_b.data_ptr(), bn_m.data_ptr(), bn_v.data_ptr(),
        pw2_t.data_ptr(), kb.ptr(s2), wtype, time_cache.data_ptr(), mask.data_ptr(), ksplit,
        y.data_ptr(), c.data_ptr(), u.data_ptr(), a.data_ptr(), part.data_ptr(),
        kb.stream_ptr(x.device))
    kb.check(lib, rc, "conv_block")
    conv_block.launches += 1
    return y, c


conv_block.launches = 0


def conv_ffn_ln(x, conv_ln_g, conv_ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache,
                mask, ff_ln_g, ff_ln_b, ff_w1, ff_w2, out_ln_g, out_ln_b):
    """Fused conv module + FFN2 + output LayerNorm (int8 weights only); same
    arguments and results as :func:`conv_ffn_ln_plain`. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise). As the
    TPU kernel, it ignores ``TRT_ASR_Q8_ACT=split``."""
    conv = (x, conv_ln_g, conv_ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask)
    tail = (ff_ln_g, ff_ln_b, ff_w1, ff_w2, out_ln_g, out_ln_b)
    if x.device.type == "cpu":
        return conv_ffn_ln_plain(*conv, *tail)
    _require_int8(pw1, pw2, ff_w1, ff_w2)
    (pw1_t, s1), (pw2_t, s2), _, kk = _conv_args("conv_ffn_ln", *conv)
    tq, d = x.shape
    e = ff_w1.q.shape[1]
    if ff_w1.q.shape != (d, e) or ff_w2.q.shape != (e, d):
        raise ValueError(f"conv_ffn_ln: FFN weights do not fit D={d}")
    fs1, fs2 = ff_w1.s.reshape(-1), ff_w2.s.reshape(-1)
    norms = (ff_ln_g, ff_ln_b, out_ln_g, out_ln_b)
    if any(t.dtype != torch.float32 for t in norms):
        raise TypeError("conv_ffn_ln: norms must be f32")
    kb.require_cuda("conv_ffn_ln", x, *norms, ff_w1.q, ff_w2.q, fs1, fs2)
    lib = kb.load("conv_block")
    y, c, u, a, y1, y2 = (torch.empty_like(x) for _ in range(6))
    h = torch.empty((tq, e), dtype=torch.float32, device=x.device)
    ksplit, ks_e = kb.gemm_splits(d), kb.gemm_splits(e)
    part = torch.empty((max(ksplit * 2 * d, ksplit * e, ks_e * d) * tq,),
                       dtype=torch.float32, device=x.device)
    rc = lib.conv_ffn_ln_launch(
        x.data_ptr(), tq, d, conv_ln_g.data_ptr(), conv_ln_b.data_ptr(), pw1_t.data_ptr(),
        s1.data_ptr(), dw.data_ptr(), kk, bn_g.data_ptr(), bn_b.data_ptr(), bn_m.data_ptr(),
        bn_v.data_ptr(), pw2_t.data_ptr(), s2.data_ptr(), time_cache.data_ptr(),
        mask.data_ptr(), ff_ln_g.data_ptr(), ff_ln_b.data_ptr(), ff_w1.q.data_ptr(),
        fs1.data_ptr(), ff_w2.q.data_ptr(), fs2.data_ptr(), e, out_ln_g.data_ptr(),
        out_ln_b.data_ptr(), ksplit, ks_e, y.data_ptr(), c.data_ptr(), u.data_ptr(),
        a.data_ptr(), y1.data_ptr(), y2.data_ptr(), h.data_ptr(), part.data_ptr(),
        kb.stream_ptr(x.device))
    kb.check(lib, rc, "conv_ffn_ln")
    conv_ffn_ln.launches += 1
    return y, c


conv_ffn_ln.launches = 0
