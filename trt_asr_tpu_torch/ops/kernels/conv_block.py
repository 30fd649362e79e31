"""Fused conformer convolution module (B=1 streaming chunks), alone and with
the second FFN and the output LayerNorm: the CUDA kernels of
``csrc/conv_block.cu`` and ``csrc/conv_ffn_ln.cu`` and their plain PyTorch
versions.

Replaces ``trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_block_pallas``
and ``:conv_ffn_ln_pallas``. The bound on the H100 is memory: pw1 and pw2
(12.6 MB f32, 3.1 MB int8 per layer at full size), plus FFN2's W1 and W2 in
the fused tail (11.5 MB int8 in all); the kernels read each weight byte
once for all rows (see the sources' notes). The fused tail is one
persistent cooperative launch, laid out by :func:`conv_ffn_ln_plan`.

Both functions return ``(y, c)``, each [Tq, D] f32: ``c`` holds the masked
post-GLU rows whose first ``cache_keep`` rows feed the time cache.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.ffn import fused_ffn_plain, layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import (SMEM_PER_BLOCK, TAIL_GROUP, TAIL_KSTEP,
                                                      TAIL_ROWS, TAIL_WARPS, align16,
                                                      column_slices, pack_columns, pad_k,
                                                      pack_tail_weight, sm_count)
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
    tq, d = x.shape
    # the depthwise taps run over [time cache ++ Tq rows ++ zeros] in 48 KB
    # of shared memory, 32 columns a block
    if (tq + kk - 1) * 32 * 4 > 48 * 1024:
        raise ValueError(f"conv_block: Tq={tq} with a {kk}-tap conv exceeds the kernel's "
                         f"shared memory")
    lib = kb.load("conv_block")
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


class TailPlan(NamedTuple):
    """Launch plan of the fused tail (``csrc/conv_ffn_ln.cu``)."""
    blocks: int          # one a column slice, all co-resident
    cols_d: int          # columns of pw1 (GLU pairs), pw2 and W2 a block
    cols_e: int          # columns of W1 a block
    smem: int            # dynamic shared bytes a block
    scratch: int         # bytes of device scratch: a, y1, h, y2


def _tail_weight_bytes(d: int, e: int, cd: int, ce: int) -> int:
    """A block's int8 slices of pw1, pw2, W1, W2 (K padded to 16)."""
    return pad_k(d) * (3 * cd + ce) + pad_k(e) * cd


def _tail_columns(kk: int, cd: int, ce: int) -> int:
    """A block's f32 columns: the four scales (pw1's twice), taps, BN."""
    return (8 + kk) * cd + ce


def conv_ffn_ln_plan(tq: int, d: int, e: int, kk: int, sms: int,
                     smem_limit: int = SMEM_PER_BLOCK) -> TailPlan:
    """The grid and shared memory of the fused tail for Tq rows, width D,
    FFN expansion E, a kk-tap conv and ``sms`` SMs (one block an SM at
    most): each block owns cD columns of pw1 (with their GLU gates), pw2
    and W2 and cE of W1, as few as cover D and E with at most ``sms``
    blocks. Mirrors ``tail_smem`` in the source, which checks it at launch.
    Raises ValueError for shapes the kernel does not take (D or E not a
    multiple of 8) or whose weight slices and staging do not fit."""
    if tq < 1 or d < TAIL_GROUP or e < TAIL_GROUP or d % TAIL_GROUP or e % TAIL_GROUP:
        raise ValueError(f"conv_ffn_ln: needs Tq >= 1 and D, E multiples of {TAIL_GROUP} "
                         f"(Tq={tq}, D={d}, E={e})")
    g = TAIL_GROUP
    cd, blocks = column_slices(d, sms)
    ce = g * -(-e // (g * blocks))
    dp, ep = pad_k(d), pad_k(e)
    act_d, act_e = (TAIL_ROWS * (k + TAIL_KSTEP) * 2 for k in (dp, ep))   # operand rows, bf16
    smem = (_tail_weight_bytes(d, e, cd, ce)                    # weight slices, int8
            + max(act_d + TAIL_ROWS * d * 4, act_e)             # and f32 rows to normalize
            + 6 * d * 4 + _tail_columns(kk, cd, ce) * 4         # norms; scales, taps, BN
            + align16(tq * 4) + align16((tq + kk - 1) * cd * 4)   # mask, conv rows
            + align16(tq * cd * 4)                             # the block's columns of y1
            + TAIL_WARPS * max(2 * cd, ce) * TAIL_ROWS * 4      # per-warp sums
            + 11 * 8)                                           # mbarriers
    if smem > smem_limit:
        raise ValueError(f"conv_ffn_ln: {smem} B of shared memory a block at Tq={tq}, D={d}, "
                         f"E={e} exceeds {smem_limit} B")
    return TailPlan(blocks, cd, ce, smem, tq * (10 * d + 2 * e))


def pack_tail(pw1, pw2, w1, w2, s1, s2, fs1, fs2, dw, bn, plan: TailPlan) -> torch.Tensor:
    """The layer's constants as the fused tail's blocks read them, a block's
    slice contiguous: [blocks, bytes] uint8, block b holding its int8
    slices of pw1 (the GLU pairs), pw2, W1 and W2 (:func:`pack_tail_weight`),
    then its f32 columns of pw1's scales (n, then n + D), pw2's, W1's and
    W2's, the conv taps [kk, cD] and BN g, b, m, v (``tail_blob`` in the
    source). pw1 .. w2 are int8 [K, N]; s1 .. fs2 the scales; dw [kk, D];
    bn (g, b, m, v)."""
    cd, ce, nb = plan.cols_d, plan.cols_e, plan.blocks
    d = pw2.shape[0]
    s1, s2, fs1, fs2 = (v.reshape(-1) for v in (s1, s2, fs1, fs2))
    weights = (pack_tail_weight(pw1, cd, nb, glu=True), pack_tail_weight(pw2, cd, nb),
               pack_tail_weight(w1, ce, nb), pack_tail_weight(w2, cd, nb))
    cols = torch.cat([pack_columns(s1[:d], cd, nb), pack_columns(s1[d:], cd, nb),
                      pack_columns(s2, cd, nb), pack_columns(fs1, ce, nb),
                      pack_columns(fs2, cd, nb), pack_columns(dw, cd, nb),
                      *[pack_columns(v, cd, nb) for v in bn]], dim=1)
    return torch.cat([w.reshape(nb, -1).view(torch.uint8) for w in weights]
                     + [cols.contiguous().view(torch.uint8)], dim=1).contiguous()


def pack_conv_ffn_ln(pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, ff_w1, ff_w2,
                     sms: int | None = None) -> torch.Tensor:
    """A layer's constants for :func:`conv_ffn_ln`'s ``packed`` (int8
    QuantTensor weights, as the wrapper takes them): :func:`pack_tail` for
    the column slices of a card with ``sms`` SMs (by default that of the
    weights' device). Made once, where the layer's int8 weights are made
    (``models/parakeet/encoder.py:layer_params``): the weights are fixed
    from then on, and a packed copy that no longer matches them gives wrong
    results. 11.5 MB a layer at full width, beside the [K, N] matrices that
    the plain path and the other kernels read."""
    _require_int8(pw1, pw2, ff_w1, ff_w2)
    if sms is None:
        sms = sm_count(pw1.q.device.index or 0)
    plan = conv_ffn_ln_plan(1, pw2.q.shape[0], ff_w1.q.shape[1], dw.shape[0], sms)
    return pack_tail(pw1.q, pw2.q, ff_w1.q, ff_w2.q, pw1.s, pw2.s, ff_w1.s, ff_w2.s, dw,
                     (bn_g, bn_b, bn_m, bn_v), plan)


def check_packed(packed: torch.Tensor, plan: TailPlan, d: int, e: int, kk: int) -> None:
    """Raises ValueError unless ``packed`` has the layout of ``plan``'s
    column slices: [blocks, bytes of a block's slice] uint8."""
    want = (plan.blocks, _tail_weight_bytes(d, e, plan.cols_d, plan.cols_e)
            + _tail_columns(kk, plan.cols_d, plan.cols_e) * 4)
    if packed.dtype != torch.uint8 or tuple(packed.shape) != want:
        raise ValueError(f"conv_ffn_ln: packed constants {packed.dtype} {tuple(packed.shape)} "
                         f"do not fit the launch plan {want} (see pack_conv_ffn_ln)")


def conv_ffn_ln(x, conv_ln_g, conv_ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache,
                mask, ff_ln_g, ff_ln_b, ff_w1, ff_w2, out_ln_g, out_ln_b, packed=None):
    """Fused conv module + FFN2 + output LayerNorm (int8 weights only); same
    arguments and results as :func:`conv_ffn_ln_plain`. CPU tensors take
    the plain version; CUDA tensors launch the kernel, one cooperative
    launch (or raise: also when its blocks cannot all be resident).
    ``packed``: the layer's weights, scales, taps and BN as
    :func:`pack_conv_ffn_ln` lays them out for the kernel, made once with
    the weights; without it they are packed anew at every call. As the TPU
    kernel, it ignores ``TRT_ASR_Q8_ACT=split``."""
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
    plan = conv_ffn_ln_plan(tq, d, e, kk, sm_count(x.device.index or 0))
    # bulk copies (16-byte aligned) of x's rows and the norms
    kb.require_aligned("conv_ffn_ln", 4, x, conv_ln_g, conv_ln_b, *norms)
    if packed is None:
        packed = pack_tail(pw1.q, pw2.q, ff_w1.q, ff_w2.q, pw1.s, pw2.s, ff_w1.s, ff_w2.s, dw,
                           (bn_g, bn_b, bn_m, bn_v), plan)
    check_packed(packed, plan, d, e, kk)
    kb.require_cuda("conv_ffn_ln", x, packed)
    kb.require_aligned("conv_ffn_ln", 16, packed)
    lib = kb.load("conv_ffn_ln")
    y, c = torch.empty_like(x), torch.empty_like(x)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=x.device)
    rc = lib.conv_ffn_ln_launch(
        x.data_ptr(), tq, d, e, kk, conv_ln_g.data_ptr(), conv_ln_b.data_ptr(),
        time_cache.data_ptr(), mask.data_ptr(), ff_ln_g.data_ptr(), ff_ln_b.data_ptr(),
        out_ln_g.data_ptr(), out_ln_b.data_ptr(), packed.data_ptr(), plan.blocks, plan.cols_d,
        plan.cols_e, plan.smem, y.data_ptr(), c.data_ptr(), scratch.data_ptr(),
        kb.stream_ptr(x.device))
    kb.check(lib, rc, "conv_ffn_ln")
    conv_ffn_ln.launches += 1
    return y, c


conv_ffn_ln.launches = 0
