"""Fused conformer convolution module (B=1 streaming chunks), alone and with
the second FFN and the output LayerNorm: the CUDA kernels of
``csrc/conv_block_q8.cu`` (int8 weights), ``csrc/conv_block_bf16.cu`` (bf16
weights), ``csrc/conv_block_f32.cu`` (f32 weights) and
``csrc/conv_ffn_ln.cu`` (the int8 tail), and their plain PyTorch versions;
the five launches of ``csrc/conv_block.cu`` (:func:`conv_block_chain`), on
no path, stay for ``chip_smoke.py`` to time beside the kernels.

Replaces ``trt_asr_tpu/ops/pallas/conv_block_kernel.py:conv_block_pallas``
and ``:conv_ffn_ln_pallas``. The bound on the H100 is memory: pw1 and pw2
(12.6 MB f32, 6.3 MB bf16, 3.1 MB int8 per layer at full size), plus
FFN2's W1 and W2 in the fused tail (11.5 MB int8 in all); the kernels read
each weight byte once for all rows (see the sources' notes). The int8,
bf16 and f32 conv modules and the fused tail are each one persistent
cooperative launch, laid out by :func:`conv_block_q8_plan`,
:func:`conv_block_bf16_plan`, :func:`conv_block_f32_plan` and
:func:`conv_ffn_ln_plan` on constants packed once (:func:`pack_conv_block`,
:func:`pack_conv_ffn_ln`): block b owns ``cols_d`` columns of pw1 (with
their GLU gates) and of pw2 over the whole K, runs the depthwise taps on
its columns, and after one grid barrier multiplies all of a by its columns
of pw2.

Every function returns ``(y, c)``, each [Tq, D] f32: ``c`` holds the masked
post-GLU rows whose first ``cache_keep`` rows feed the time cache.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.ffn import fused_ffn_plain, layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import (SMEM_PER_BLOCK, TAIL_GROUP, TAIL_KSTEP,
                                                      TAIL_ROWS, TAIL_WARPS, align16,
                                                      column_slices, pack_columns, pad_k,
                                                      pack_tail_weight, sm_count, weight_kind)
from trt_asr_tpu_torch.ops.quant import (QuantTensor, as_f32, is_low_precision, round_bf16,
                                         scaled_matmul)


def conv_block_plain(x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2,
                     time_cache, mask):
    """The kernel's function in plain PyTorch, with its rounding points:
    with bf16 or int8 weights the LN output and silu(BN(conv)) are rounded
    to bf16. x [Tq, D] f32; pw1 [D, 2D], pw2 [D, D] float or QuantTensor;
    dw [K, D] (K odd) and time_cache [(K-1)/2, D], each f32 or bf16 (widened
    where read); mask [Tq, 1] f32 (1 = valid step). Returns (y = x +
    conv_module(x), c), both [Tq, D] f32."""
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
    pw2 parts, wtype, kk, dw in f32). bf16 taps are read as the f32 copy
    kept beside them (:func:`as_f32`); the time cache may be f32 or bf16."""
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
    dw = as_f32(dw)
    floats = [x, ln_g, ln_b, dw, bn_g, bn_b, bn_m, bn_v, mask]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"{what}: activations, norms, BN and mask must be f32, the taps f32 "
                        f"or bf16")
    if time_cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: the time cache must be f32 or bf16")
    kb.require_cuda(what, *floats, time_cache, pw1_t, pw2_t,
                    *[s for s in (s1, s2) if s is not None])
    return (pw1_t, s1), (pw2_t, s2), wtype, kk, dw


def conv_block(x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask,
               packed=None):
    """Fused conv module; same arguments and results as
    :func:`conv_block_plain`. CPU tensors take the plain version; CUDA
    tensors launch the persistent kernel of the weights' type (int8, bf16
    or f32), one cooperative launch, or raise (also when its blocks cannot
    all be resident). ``packed``: the layer's weights, taps and BN as
    :func:`pack_conv_block` lays them out, made once with the weights;
    without it they are packed anew at every call. The bf16 kernel reads a
    bf16 time cache as stored; the int8 and f32 kernels read an f32 copy of
    it, made at the call (:func:`as_f32` counts its bytes)."""
    args = (x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask)
    if x.device.type == "cpu":
        return conv_block_plain(*args)
    kind = weight_kind("conv_block: pw1 and pw2", pw1, pw2)
    dw = _conv_args("conv_block", *args)[4]
    if kind != "bf16":
        time_cache = as_f32(time_cache)
    tq, d = x.shape
    kk = dw.shape[0]
    plan = CONV_PLANS[kind](tq, d, kk, sm_count(x.device.index or 0))
    # bulk copies (16-byte aligned) of x's rows and the norms
    kb.require_aligned("conv_block", 4, x, ln_g, ln_b)
    if packed is None:
        packed = _pack(pw1, dw, (bn_g, bn_b, bn_m, bn_v), pw2, plan, kind)
    check_packed_conv(packed, plan, d, kk, kind)
    kb.require_cuda("conv_block", x, packed)
    kb.require_aligned("conv_block", 16 // packed.element_size(), packed)
    name = CONV_LIBS[kind]
    lib = kb.load(name)
    y, c = torch.empty_like(x), torch.empty_like(x)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=x.device)
    cache = ((time_cache.data_ptr(), int(time_cache.dtype == torch.bfloat16)) if kind == "bf16"
             else (time_cache.data_ptr(),))
    rc = getattr(lib, f"{name}_launch")(
        x.data_ptr(), tq, d, kk, ln_g.data_ptr(), ln_b.data_ptr(), *cache,
        mask.data_ptr(), packed.data_ptr(), plan.blocks, plan.cols_d, plan.smem, y.data_ptr(),
        c.data_ptr(), scratch.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "conv_block")
    conv_block.launches += 1
    return y, c


def conv_block_chain(x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask):
    """The chain of ``csrc/conv_block.cu`` on CUDA tensors (LayerNorm, a
    split-K pw1 product, the GLU and conv kernel, a split-K pw2 product with
    the residual: five launches) with f32, bf16 or int8 weights: the
    predecessor of the persistent kernels, on no path, kept so that
    ``chip_smoke.py`` times them side by side in one run. An f32 or bf16
    time cache is read as stored."""
    args = (x, ln_g, ln_b, pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, time_cache, mask)
    (pw1_t, s1), (pw2_t, s2), wtype, kk, dw = _conv_args("conv_block", *args)
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
        pw2_t.data_ptr(), kb.ptr(s2), wtype, time_cache.data_ptr(),
        int(time_cache.dtype == torch.bfloat16), mask.data_ptr(), ksplit,
        y.data_ptr(), c.data_ptr(), u.data_ptr(), a.data_ptr(), part.data_ptr(),
        kb.stream_ptr(x.device))
    kb.check(lib, rc, "conv_block")
    conv_block.launches += 1
    return y, c


conv_block.launches = 0


class TailPlan(NamedTuple):
    """Launch plan of a persistent conv-module kernel: the fused tail
    (``csrc/conv_ffn_ln.cu``), the int8, bf16 or f32 conv module
    (``csrc/conv_block_q8.cu``, ``csrc/conv_block_bf16.cu``,
    ``csrc/conv_block_f32.cu``: ``cols_e`` 0)."""
    blocks: int          # one a column slice, all co-resident
    cols_d: int          # columns of pw1 (GLU pairs), pw2 and W2 a block
    cols_e: int          # columns of W1 a block
    smem: int            # dynamic shared bytes a block
    scratch: int         # bytes of device scratch: a (the tail: a, y1, h, y2)


CONV_RUN = 64            # K rows of an f32 weight piece (csrc/conv_block_f32.cu CF_RUN)


def _tail_weight_bytes(d: int, e: int, cd: int, ce: int, wb: int = 1) -> int:
    """A block's slices of pw1, pw2, W1, W2, ``wb`` bytes a weight (1 int8,
    2 bf16; K padded to 16; E = cE = 0: the conv module alone, pw1 and
    pw2)."""
    return (pad_k(d) * (3 * cd + ce) + pad_k(e) * cd) * wb


def _tail_columns(kk: int, cd: int, ce: int, scaled: bool = True) -> int:
    """A block's f32 columns: with int8 weights (``scaled``) the scales
    (pw1's twice; W1's and W2's with the FFN, ce > 0); the taps, BN."""
    return (4 + kk) * cd + ((3 * cd + (cd + ce if ce else 0)) if scaled else 0)


def _tail_smem(tq: int, d: int, e: int, kk: int, cd: int, ce: int, wb: int = 1,
               scaled: bool = True) -> int:
    """Dynamic shared bytes of the body of ``csrc/conv_tail.cuh``
    (``tail_smem``): int8 weights, or bf16 (``wb`` 2, no scales); e = ce =
    0: the conv module alone."""
    act_d, act_e = (TAIL_ROWS * (pad_k(k) + TAIL_KSTEP) * 2 for k in (d, e))   # operand rows
    return (_tail_weight_bytes(d, e, cd, ce, wb)                # weight slices
            + max(act_d + TAIL_ROWS * d * 4, act_e)             # and f32 rows to normalize
            + (6 if e else 2) * d * 4 + _tail_columns(kk, cd, ce, scaled) * 4   # norms; columns
            + align16(tq * 4) + align16((tq + kk - 1) * cd * 4)   # mask, conv rows
            + (align16(tq * cd * 4) if e else 0)               # the block's columns of y1
            + TAIL_WARPS * max(2 * cd, ce) * TAIL_ROWS * 4      # per-warp sums
            + 11 * 8)                                           # mbarriers


def _check_smem(what: str, smem: int, smem_limit: int, shape: str) -> None:
    if smem > smem_limit:
        raise ValueError(f"{what}: {smem} B of shared memory a block at {shape} exceeds "
                         f"{smem_limit} B")


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
    smem = _tail_smem(tq, d, e, kk, cd, ce)
    _check_smem("conv_ffn_ln", smem, smem_limit, f"Tq={tq}, D={d}, E={e}")
    return TailPlan(blocks, cd, ce, smem, tq * (10 * d + 2 * e))


def _conv_grid(what: str, tq: int, d: int, sms: int) -> tuple[int, int]:
    """(cols_d, blocks) of a persistent conv module: the fewest 8-column
    groups a block that cover D with at most ``sms`` blocks."""
    if tq < 1 or d < TAIL_GROUP or d % TAIL_GROUP:
        raise ValueError(f"{what}: needs Tq >= 1 and D a multiple of {TAIL_GROUP} "
                         f"(Tq={tq}, D={d})")
    return column_slices(d, sms)


@functools.lru_cache(maxsize=None)
def conv_block_q8_plan(tq: int, d: int, kk: int, sms: int,
                       smem_limit: int = SMEM_PER_BLOCK) -> TailPlan:
    """The grid and shared memory of the int8 conv module (the fused tail's
    phases (a)-(c), ``csrc/conv_tail.cuh`` without the FFN): a block's int8
    slices of pw1 (its GLU pairs) and pw2 with their scales, the taps and
    BN stay whole in shared memory. Mirrors ``tail_smem`` in the source,
    which checks it at launch. Raises ValueError for shapes the kernel does
    not take (D not a multiple of 8) or whose staging does not fit."""
    what = "conv_block[int8]"
    cd, blocks = _conv_grid(what, tq, d, sms)
    smem = _tail_smem(tq, d, 0, kk, cd, 0)
    _check_smem(what, smem, smem_limit, f"Tq={tq}, D={d}")
    return TailPlan(blocks, cd, 0, smem, tq * d * 2)        # a, bf16


@functools.lru_cache(maxsize=None)
def conv_block_bf16_plan(tq: int, d: int, kk: int, sms: int,
                         smem_limit: int = SMEM_PER_BLOCK) -> TailPlan:
    """The grid and shared memory of the bf16 conv module
    (``csrc/conv_block_bf16.cu``: the int8 module's plan,
    ``csrc/conv_tail.cuh`` without the FFN, on bf16 slices without scales):
    a block's bf16 slices of pw1 (its GLU pairs) and pw2, the taps and BN
    stay whole in shared memory. Mirrors ``tail_smem`` in the source, which
    checks it at launch. Raises ValueError for shapes the kernel does not
    take (D not a multiple of 8) or whose staging does not fit."""
    what = "conv_block[bf16]"
    cd, blocks = _conv_grid(what, tq, d, sms)
    smem = _tail_smem(tq, d, 0, kk, cd, 0, wb=2, scaled=False)
    _check_smem(what, smem, smem_limit, f"Tq={tq}, D={d}")
    return TailPlan(blocks, cd, 0, smem, tq * d * 2)        # a, bf16


def _conv_f32_runs(d: int) -> int:
    return -(-d // CONV_RUN)


def _conv_f32_floats(d: int, kk: int, cd: int) -> int:
    """A block's f32 slice: the pw1 pieces (GLU pairs), the pw2 pieces, the
    taps and BN (``cf_blob`` in the source)."""
    return _conv_f32_runs(d) * CONV_RUN * 3 * cd + (kk + 4) * cd


@functools.lru_cache(maxsize=None)
def conv_block_f32_plan(tq: int, d: int, kk: int, sms: int,
                        smem_limit: int = SMEM_PER_BLOCK) -> TailPlan:
    """The grid and shared memory of the f32 conv module
    (``csrc/conv_block_f32.cu``): a block's f32 slices of pw1 (its GLU
    pairs) and pw2 in pieces of CONV_RUN rows of K, its taps and BN stay
    whole in shared memory beside x's rows and a's, K padded to the pieces.
    Mirrors ``cf_smem`` in the source, which checks it at launch. Raises
    ValueError for shapes the kernel does not take (D not a multiple of 8)
    or whose slices and staging do not fit."""
    what = "conv_block[f32]"
    cd, blocks = _conv_grid(what, tq, d, sms)
    runs = _conv_f32_runs(d)
    smem = (_conv_f32_floats(d, kk, cd) * 4                    # the block's slice
            + 2 * TAIL_ROWS * runs * CONV_RUN * 4               # x's rows (then u's), a's rows
            + 2 * d * 4                                         # LN's g, b
            + runs * TAIL_ROWS * 2 * cd * 4                     # the pieces' sums
            + align16(tq * cd * 4) + align16(tq * 4)            # x on the block's columns, mask
            + align16((tq + kk - 1) * cd * 4)                   # conv rows
            + (3 * runs + 1) * 8)                               # mbarriers
    _check_smem(what, smem, smem_limit, f"Tq={tq}, D={d}")
    # a, f32, laid out [pass][run][8 rows][CONV_RUN] (``cf_a_at`` in the source)
    return TailPlan(blocks, cd, 0, smem, -(-tq // TAIL_ROWS) * TAIL_ROWS * runs * CONV_RUN * 4)


def pack_tail(pw1, pw2, w1, w2, s1, s2, fs1, fs2, dw, bn, plan: TailPlan) -> torch.Tensor:
    """The layer's constants as the kernels of ``csrc/conv_tail.cuh`` read
    them, a block's slice contiguous: [blocks, bytes] uint8, block b holding
    its int8 or bf16 slices of pw1 (the GLU pairs), pw2, W1 and W2
    (:func:`pack_tail_weight`), then its f32 columns of pw1's scales (n,
    then n + D), pw2's, W1's and W2's (int8 only), the conv taps [kk, cD]
    and BN g, b, m, v (``tail_blob`` in the source). pw1 .. w2 are int8 or
    bf16 [K, N]; s1 .. fs2 the int8 scales (None with bf16 weights); dw [kk,
    D]; bn (g, b, m, v). For the conv module alone (the int8 and bf16 conv
    modules' plans) w1, w2, fs1 and fs2 are None."""
    cd, ce, nb = plan.cols_d, plan.cols_e, plan.blocks
    d = pw2.shape[0]
    weights = [pack_tail_weight(pw1, cd, nb, glu=True), pack_tail_weight(pw2, cd, nb)]
    cols = []
    if s1 is not None:
        s1, s2 = s1.reshape(-1), s2.reshape(-1)
        cols = [pack_columns(s1[:d], cd, nb), pack_columns(s1[d:], cd, nb),
                pack_columns(s2, cd, nb)]
    if w1 is not None:
        weights += [pack_tail_weight(w1, ce, nb), pack_tail_weight(w2, cd, nb)]
        cols += [pack_columns(fs1.reshape(-1), ce, nb), pack_columns(fs2.reshape(-1), cd, nb)]
    cols = torch.cat(cols + [pack_columns(dw, cd, nb), *[pack_columns(v, cd, nb) for v in bn]],
                     dim=1)
    return torch.cat([w.reshape(nb, -1).view(torch.uint8) for w in weights]
                     + [cols.contiguous().view(torch.uint8)], dim=1).contiguous()


def pack_conv_f32(pw1, pw2, dw, bn, plan: TailPlan) -> torch.Tensor:
    """The f32 conv module's constants as its blocks read them, a block's
    slice contiguous: [blocks, floats] f32, block b holding for its columns
    b * cols_d .. the pieces of CONV_RUN rows of K of pw1, each
    [CONV_RUN / 4][2 cols_d][4] (a column's four consecutive K values
    together; the columns n, then their gates n + D), then those of pw2,
    each [CONV_RUN / 4][cols_d][4], then the taps [kk, cols_d] and BN g, b,
    m, v; zero past D and K (``cf_blob`` in the source). pw1 [D, 2D], pw2
    [D, D], dw [kk, D] f32; bn (g, b, m, v)."""
    d = pw2.shape[0]
    nb, cd, runs = plan.blocks, plan.cols_d, _conv_f32_runs(d)
    kp = runs * CONV_RUN

    def pieces(ws):
        p = pw2.new_zeros((kp, nb, len(ws), cd))
        for i, w in enumerate(ws):
            full = w.new_zeros((kp, nb * cd))
            full[:d, :w.shape[1]] = w
            p[:, :, i] = full.view(kp, nb, cd)
        return (p.view(runs, CONV_RUN // 4, 4, nb, len(ws) * cd).permute(3, 0, 1, 4, 2)
                .reshape(nb, -1))

    cols = [pack_columns(dw, cd, nb), *[pack_columns(v, cd, nb) for v in bn]]
    return torch.cat([pieces([pw1[:, :d], pw1[:, d:]]), pieces([pw2]), *cols],
                     dim=1).float().contiguous()


# weight type -> the plan and the library of its persistent conv module
CONV_PLANS = {"int8": conv_block_q8_plan, "bf16": conv_block_bf16_plan,
              "f32": conv_block_f32_plan}
CONV_LIBS = {"int8": "conv_block_q8", "bf16": "conv_block_bf16", "f32": "conv_block_f32"}


def _pack(pw1, dw, bn, pw2, plan: TailPlan, kind: str) -> torch.Tensor:
    if kind == "int8":
        return pack_tail(pw1.q, pw2.q, None, None, pw1.s, pw2.s, None, None, dw, bn, plan)
    if kind == "bf16":
        return pack_tail(pw1, pw2, None, None, None, None, None, None, dw, bn, plan)
    return pack_conv_f32(pw1, pw2, dw, bn, plan)


def pack_conv_block(pw1, dw, bn_g, bn_b, bn_m, bn_v, pw2, sms: int | None = None) -> torch.Tensor:
    """A layer's conv constants for :func:`conv_block`'s ``packed``, for the
    column slices of a card with ``sms`` SMs (by default that of the
    weights' device): int8 QuantTensors by :func:`pack_tail` without the FFN
    (3.2 MB a layer at full width), bf16 weights likewise without scales
    (6.3 MB), f32 weights by :func:`pack_conv_f32` (12.6 MB), each held
    beside the [K, N] matrices that the plain path reads. Made once, where
    the layer's weights are made (``models/parakeet/encoder.py:layer_params``):
    a packed copy that no longer matches the weights gives wrong results.
    Raises ValueError for weights of two storage types."""
    kind = weight_kind("conv_block: pw1 and pw2", pw1, pw2)
    t = pw2.q if kind == "int8" else pw2
    sms = sm_count(t.device.index or 0) if sms is None else sms
    d, kk = t.shape[0], dw.shape[0]
    plan = CONV_PLANS[kind](1, d, kk, sms)
    return _pack(pw1, dw, (bn_g, bn_b, bn_m, bn_v), pw2, plan, kind)


def check_packed_conv(packed: torch.Tensor, plan: TailPlan, d: int, kk: int, kind: str) -> None:
    """Raises ValueError unless ``packed`` has the layout of ``plan``'s
    column slices for weights of type ``kind``: int8 and bf16 [blocks, bytes
    of a block's slice] uint8 (bf16's slices twice int8's bytes, without
    scales), f32 [blocks, floats of a block's slice] f32."""
    if kind == "f32":
        want = (torch.float32, (plan.blocks, _conv_f32_floats(d, kk, plan.cols_d)))
    else:
        bf = kind == "bf16"
        want = (torch.uint8, (plan.blocks, _tail_weight_bytes(d, 0, plan.cols_d, 0, 2 if bf else 1)
                              + _tail_columns(kk, plan.cols_d, 0, not bf) * 4))
    if (packed.dtype, tuple(packed.shape)) != want:
        raise ValueError(f"conv_block[{kind}]: packed constants {packed.dtype} "
                         f"{tuple(packed.shape)} do not fit the launch plan {want[0]} {want[1]} "
                         f"(see pack_conv_block)")


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
    (pw1_t, s1), (pw2_t, s2), _, kk, dw = _conv_args("conv_ffn_ln", *conv)
    time_cache = as_f32(time_cache)
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
