"""Fused conformer feed-forward module: the CUDA kernels ``csrc/ffn_f32.cu``
(f32 weights), ``csrc/ffn_q8.cu`` (int8 weights) and ``csrc/ffn_bf16.cu``
(bf16 weights), each one persistent cooperative launch a call laid out by
:func:`ffn_f32_plan`, :func:`ffn_q8_plan` or :func:`ffn_bf16_plan` on
weights packed once (:func:`pack_ffn`), the chain of ``csrc/ffn.cu`` that
they replaced (:func:`fused_ffn_chain`), and their plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/ffn_kernel.py:fused_ffn_pallas``:
``x + scale * silu(LN(x) @ W1) @ W2``. The bound on the H100 is memory: one
read of W1 and W2 (33.6 MB f32, 16.8 MB bf16, 8.4 MB int8 at full size) per
call, for all rows; the kernels read each weight byte once a pass of 8 rows
(see the sources' notes). Block b of a persistent kernel owns ``cols_e`` columns of
the expansion, its columns of h = silu(LN(x) @ W1[:, slice]), and adds up
``cols_d`` columns of y after one grid barrier: the f32 kernel computes
h_b @ W2[slice, :], a partial of every column of y, and adds every block's
partial of its columns in a fixed order (runs of FFN_SUM_RUN blocks, each
in block order, then the runs' sums in order); the int8 and bf16 kernels
write their columns of h and multiply all of h by their columns of W2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.persistent import (SMEM_PER_BLOCK, TAIL_GROUP, TAIL_KSTEP,
                                                      TAIL_ROWS, TAIL_WARPS, pack_columns,
                                                      pack_tail_weight, pad_k, sm_count,
                                                      weight_kind)
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


class FfnPlan(NamedTuple):
    """Launch plan of a persistent FFN (``csrc/ffn_f32.cu``,
    ``csrc/ffn_q8.cu``, ``csrc/ffn_bf16.cu``)."""
    blocks: int          # one an expansion slice, all co-resident
    cols_e: int          # expansion columns a block (W1's columns, W2's rows)
    cols_d: int          # columns of y a block adds up after the barrier
    smem: int            # dynamic shared bytes a block
    scratch: int         # bytes of scratch, two buffers: the blocks' partials (f32), h (int8, bf16)
    stages: int = 0      # f32 weights: slots of the weights' ring (0: int8, bf16)
    kind: str = "int8"   # the weights' type: int8, bf16 or f32


FFN_SLICE = 32           # expansion columns a block takes in multiples of (csrc FF_SLICE)
FFN_RUN = 64             # K rows of an f32 W1 piece, D columns of a W2 piece (csrc FF_RUN)
FFN_SUM_RUN = 16         # blocks' partials a thread adds up after the barrier (csrc FF_SUM_RUN)


def _ffn_grid(what: str, d: int, e: int, sms: int, group: int):
    """(cols_e, blocks, cols_d) of a persistent FFN: the fewest multiples of
    FFN_SLICE expansion columns a block that cover E with at most ``sms``
    blocks, and the fewest multiples of ``group`` columns of y a block that
    cover D with those blocks. Raises ValueError for shapes the kernels do
    not take (D not a multiple of 8)."""
    if d < TAIL_GROUP or d % TAIL_GROUP or e < 1:
        raise ValueError(f"{what}: needs D a multiple of {TAIL_GROUP} and E >= 1 "
                         f"(D={d}, E={e})")
    slices = -(-e // FFN_SLICE)
    ce = FFN_SLICE * -(-slices // sms)
    blocks = -(-e // ce)
    return ce, blocks, group * -(-d // (group * blocks))


def _f32_runs(d: int) -> int:
    return -(-d // FFN_RUN)


def ffn_f32_plan(d: int, e: int, sms: int, smem_limit: int = SMEM_PER_BLOCK,
                 stages: int | None = None) -> FfnPlan:
    """The grid and shared memory of the f32 FFN for width D, expansion E
    and ``sms`` SMs (one block an SM at most; :func:`_ffn_grid`): a block's
    W1 and W2 pieces (FFN_RUN rows of K of its W1 columns, FFN_RUN columns
    of its W2 rows) stream through a ring of ``stages`` slots, by default as
    many as there are pieces, or as fit. The ring also stages the blocks'
    partials of the block's columns of y. Mirrors ``ff_smem`` in the source,
    which checks it at launch. Raises ValueError for shapes the kernel does
    not take or whose staging does not fit with at least one slot."""
    what = "fused_ffn[f32]"
    ce, blocks, cd = _ffn_grid(what, d, e, sms, 4)
    runs = _f32_runs(d)
    slot = FFN_RUN * ce * 4
    fixed = (TAIL_ROWS * runs * FFN_RUN * 4                     # x's rows, then u's
             + TAIL_ROWS * ce * 4                               # h's rows
             + TAIL_ROWS * cd * 4                               # x on the block's columns
             + max(runs * TAIL_ROWS * ce, 2 * d) * 4            # W1's sums; LN's g, b
             + (2 * runs + 1) * 8)                              # mbarriers: the pieces, x
    if stages is None:
        stages = max(1, min(2 * runs, (smem_limit - fixed) // slot))
    if not 1 <= stages <= 2 * runs:
        raise ValueError(f"{what}: {stages} ring slots for {2 * runs} pieces")
    smem = fixed + max(stages * slot, blocks * TAIL_ROWS * cd * 4)
    if smem > smem_limit:
        raise ValueError(f"{what}: {smem} B of shared memory a block at D={d}, E={e} "
                         f"exceeds {smem_limit} B")
    # two buffers of the blocks' [8, D] partials
    return FfnPlan(blocks, ce, cd, smem, 2 * blocks * TAIL_ROWS * d * 4, stages, "f32")


def _q8_blob_bytes(d: int, e: int, ce: int, cd: int) -> int:
    """A block's int8 slices of W1 ([ce / 8][Dp / 16][8][16]) and W2 ([cd /
    8][Ep / 16][8][16]) and its f32 columns of s1 and s2 (``fq_blob`` in the
    source)."""
    return pad_k(d) * ce + 4 * (ce + cd) + pad_k(e) * cd


def ffn_q8_plan(d: int, e: int, sms: int, smem_limit: int = SMEM_PER_BLOCK) -> FfnPlan:
    """The grid and shared memory of the int8 FFN (:func:`_ffn_grid`): a
    block's int8 slices of W1 (its expansion columns) and W2 (its columns of
    y over the whole expansion) and their scales stay whole in shared
    memory. Mirrors ``fq_smem`` in the source, which checks it at launch.
    Raises ValueError for shapes the kernel does not take (E not a multiple
    of 8 among them) or whose staging does not fit."""
    what = "fused_ffn[int8]"
    ce, blocks, cd = _ffn_grid(what, d, e, sms, TAIL_GROUP)
    if e % TAIL_GROUP:
        raise ValueError(f"{what}: needs E a multiple of {TAIL_GROUP} (E={e})")
    smem = (_q8_blob_bytes(d, e, ce, cd)                        # weight slices, scales
            + TAIL_ROWS * (max(pad_k(d), pad_k(e)) + TAIL_KSTEP) * 2   # u's rows, then h's
            + TAIL_ROWS * d * 4                                 # x's rows
            + 2 * d * 4                                         # LN's g, b
            + TAIL_WARPS * max(ce, cd) * TAIL_ROWS * 4          # per-warp sums
            + 7 * 8)                                            # mbarriers: x, W1, W2, h's chunks
    if smem > smem_limit:
        raise ValueError(f"{what}: {smem} B of shared memory a block at D={d}, E={e} "
                         f"exceeds {smem_limit} B")
    return FfnPlan(blocks, ce, cd, smem, 2 * TAIL_ROWS * e * 2)


def _bf16_blob_elems(d: int, e: int, ce: int, cd: int) -> int:
    """A block's bf16 slices of W1 ([ce / 8][Dp / 16][8][16]) and W2 ([cd /
    8][Ep / 16][8][16]), in elements (``fb_blob`` in the source)."""
    return pad_k(d) * ce + pad_k(e) * cd


def ffn_bf16_plan(d: int, e: int, sms: int, smem_limit: int = SMEM_PER_BLOCK) -> FfnPlan:
    """The grid and shared memory of the bf16 FFN: the int8 kernel's split
    (:func:`ffn_q8_plan`) with bf16 slices, whole in shared memory (64 KB
    each at full width), and x's rows in the operand buffer of h's rows,
    past u's (h's overwrite them after the grid barrier; the residual is
    read from device memory). Mirrors ``fb_smem`` in the source, which
    checks it at launch. Raises ValueError for shapes the kernel does not
    take (E not a multiple of 8 among them) or whose staging does not fit."""
    what = "fused_ffn[bf16]"
    ce, blocks, cd = _ffn_grid(what, d, e, sms, TAIL_GROUP)
    if e % TAIL_GROUP:
        raise ValueError(f"{what}: needs E a multiple of {TAIL_GROUP} (E={e})")
    u_rows = TAIL_ROWS * (pad_k(d) + TAIL_KSTEP) * 2
    smem = (_bf16_blob_elems(d, e, ce, cd) * 2                  # weight slices
            + max(u_rows + TAIL_ROWS * d * 4,                   # u's rows, x's rows,
                  TAIL_ROWS * (pad_k(e) + TAIL_KSTEP) * 2)      # then h's over them
            + 2 * d * 4                                         # LN's g, b
            + TAIL_WARPS * max(ce, cd) * TAIL_ROWS * 4          # per-warp sums
            + 7 * 8)                                            # mbarriers: x, W1, W2, h's chunks
    if smem > smem_limit:
        raise ValueError(f"{what}: {smem} B of shared memory a block at D={d}, E={e} "
                         f"exceeds {smem_limit} B")
    return FfnPlan(blocks, ce, cd, smem, 2 * TAIL_ROWS * e * 2, kind="bf16")


def pack_ffn_f32(w1, w2, plan: FfnPlan) -> torch.Tensor:
    """The f32 weights as the f32 FFN's ring takes them, a block's slice
    contiguous: [blocks, 2 runs * FFN_RUN * cols_e] f32, block b holding for
    its expansion columns b * cols_e .. the runs of FFN_RUN rows of K of W1,
    each [FFN_RUN / 4][cols_e][4] (a column's four consecutive K values
    together), then the runs of FFN_RUN columns of its rows of W2, each
    [cols_e / 4][FFN_RUN][4]; zero past D and E (``ff_issue`` in the
    source). w1 [D, E], w2 [E, D] f32."""
    d, e = w1.shape
    runs, blocks, ce = _f32_runs(d), plan.blocks, plan.cols_e
    a = w1.new_zeros((runs * FFN_RUN, blocks * ce))
    a[:d, :e] = w1
    a = a.view(runs, FFN_RUN // 4, 4, blocks, ce).permute(3, 0, 1, 4, 2)
    b = w2.new_zeros((blocks * ce, runs * FFN_RUN))
    b[:e, :d] = w2
    b = b.view(blocks, ce // 4, 4, runs, FFN_RUN).permute(0, 3, 1, 4, 2)
    return torch.cat([a.reshape(blocks, -1), b.reshape(blocks, -1)], dim=1).float().contiguous()


def pack_ffn_bf16(w1, w2, plan: FfnPlan) -> torch.Tensor:
    """The bf16 weights as the bf16 FFN's blocks read them, a block's slice
    contiguous: [blocks, elements] bf16, block b holding W1's columns b *
    cols_e .. and then W2's columns b * cols_d .. over the whole expansion,
    each as :func:`~trt_asr_tpu_torch.ops.kernels.persistent.
    pack_tail_weight` lays out an int8 matrix; zero past D and E
    (``fb_blob`` in the source). w1 [D, E], w2 [E, D] bf16."""
    blocks = plan.blocks
    return torch.cat([pack_tail_weight(w1, plan.cols_e, blocks).reshape(blocks, -1),
                      pack_tail_weight(w2, plan.cols_d, blocks).reshape(blocks, -1)],
                     dim=1).contiguous()


def pack_ffn_q8(w1, w2, plan: FfnPlan) -> torch.Tensor:
    """The int8 weights and their scales as the int8 FFN's blocks read them,
    a block's slice contiguous: [blocks, bytes] uint8, block b holding W1's
    columns b * cols_e .. and W2's columns b * cols_d .. over the whole
    expansion (each by :func:`~trt_asr_tpu_torch.ops.kernels.persistent.
    pack_tail_weight`), between them the scales of both; zero past D and E
    (``fq_blob`` in the source). w1, w2: int8 QuantTensors [D, E], [E, D]."""
    blocks, ce, cd = plan.blocks, plan.cols_e, plan.cols_d
    a = pack_tail_weight(w1.q, ce, blocks).reshape(blocks, -1)
    cols = torch.cat([pack_columns(w1.s.reshape(-1), ce, blocks),
                      pack_columns(w2.s.reshape(-1), cd, blocks)], dim=1)
    b = pack_tail_weight(w2.q, cd, blocks).reshape(blocks, -1)
    return torch.cat([a.view(torch.uint8), cols.contiguous().view(torch.uint8),
                      b.view(torch.uint8)], dim=1).contiguous()


def pack_ffn(w1, w2, sms: int | None = None) -> torch.Tensor:
    """An FFN's weights for :func:`fused_ffn`'s ``packed``, for the plan of
    a card with ``sms`` SMs (by default that of the weights' device): int8
    QuantTensors by :func:`pack_ffn_q8` (8.4 MB at full width), bf16
    weights by :func:`pack_ffn_bf16` (16.8 MB), f32 weights by
    :func:`pack_ffn_f32` (33.6 MB), each held beside the [D, E] and [E, D]
    matrices that the plain path reads. Made once, where the layer's weights
    are made (``models/parakeet/encoder.py:layer_params``): a packed copy
    that no longer matches the weights gives wrong results. Raises
    ValueError for weights of mixed or other types."""
    kind = weight_kind("fused_ffn: W1 and W2", w1, w2)
    t = w1.q if kind == "int8" else w1
    sms = sm_count(t.device.index or 0) if sms is None else sms
    d, e = t.shape
    plan, pack = _plan_and_packer(kind)
    return pack(w1, w2, plan(d, e, sms))


def check_packed_ffn(packed: torch.Tensor, plan: FfnPlan, d: int, e: int) -> None:
    """Raises ValueError unless ``packed`` has the layout of ``plan``'s
    slices: with an f32 plan [blocks, floats of a block's slice] f32, with a
    bf16 plan [blocks, elements of a block's slice] bf16, with an int8 plan
    [blocks, bytes of a block's slice] uint8."""
    ce, cd = plan.cols_e, plan.cols_d
    dtype, elems = {"f32": (torch.float32, 2 * _f32_runs(d) * FFN_RUN * ce),
                    "bf16": (torch.bfloat16, _bf16_blob_elems(d, e, ce, cd)),
                    "int8": (torch.uint8, _q8_blob_bytes(d, e, ce, cd))}[plan.kind]
    what, want = plan.kind, (dtype, (plan.blocks, elems))
    if (packed.dtype, tuple(packed.shape)) != want:
        raise ValueError(f"fused_ffn[{what}]: packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} do not fit the launch plan {want[0]} "
                         f"{want[1]} (see pack_ffn)")


def _check_args(x, ln_g, ln_b, w1_t, w2_t):
    d = x.shape[-1]
    e = w1_t.shape[1]
    if w1_t.shape != (d, e) or w2_t.shape != (e, d):
        raise ValueError(f"fused_ffn: weights {tuple(w1_t.shape)}, {tuple(w2_t.shape)} "
                         f"do not fit D={d}")
    if any(t.dtype != torch.float32 for t in (x, ln_g, ln_b)):
        raise TypeError("fused_ffn: activations and norms must be f32")
    return d, e


def fused_ffn(x, ln_g, ln_b, w1, w2, scale: float = 0.5, packed=None):
    """Fused FFN; same arguments and result as :func:`fused_ffn_plain`. CPU
    tensors take the plain version; CUDA tensors launch the persistent
    kernel of the weights' type (int8, bf16 or f32), one cooperative
    launch, or raise (also when its blocks cannot all be resident).
    ``packed``: the weights as :func:`pack_ffn` lays them out, made once
    with the weights; without it they are packed anew at every call. As
    the TPU kernel, it rounds f32 activations to bf16 before an int8 product
    whatever ``TRT_ASR_Q8_ACT`` says (no "split" mode)."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, ln_g, ln_b, w1, w2, scale)
    kind = weight_kind("fused_ffn: W1 and W2", w1, w2)
    int8 = kind == "int8"
    d, e = _check_args(x, ln_g, ln_b, w1.q if int8 else w1, w2.q if int8 else w2)
    kb.require_cuda("fused_ffn", x, ln_g, ln_b)
    make_plan, pack = _plan_and_packer(kind)
    plan = make_plan(d, e, sm_count(x.device.index or 0))
    if packed is None:
        packed = pack(w1, w2, plan)
    check_packed_ffn(packed, plan, d, e)
    kb.require_cuda("fused_ffn", x, packed)
    # bulk copies (16-byte aligned) of x's rows, the norms and the weights
    kb.require_aligned("fused_ffn", 4, x, ln_g, ln_b)
    kb.require_aligned("fused_ffn", 16 // packed.element_size(), packed)
    name = {"int8": "ffn_q8", "bf16": "ffn_bf16", "f32": "ffn_f32"}[kind]
    lib = kb.load(name)
    x2 = x.view(-1, d)
    y = torch.empty_like(x)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=x.device)
    stages = (plan.stages,) if kind == "f32" else ()
    rc = getattr(lib, f"{name}_launch")(
        x2.data_ptr(), x2.shape[0], d, e, ln_g.data_ptr(), ln_b.data_ptr(), packed.data_ptr(),
        plan.blocks, plan.cols_e, plan.cols_d, *stages, plan.smem, float(scale), y.data_ptr(),
        scratch.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "fused_ffn")
    fused_ffn.launches += 1
    return y


def fused_ffn_chain(x, ln_g, ln_b, w1, w2, scale: float = 0.5):
    """The chain of ``csrc/ffn.cu`` on CUDA tensors (LayerNorm, a split-K W1
    product with its SiLU epilogue, a split-K W2 product with the scaled
    residual: five launches) with f32, bf16 or int8 weights: the
    predecessor of the persistent kernels, on no path now, kept so that
    ``chip_smoke.py`` times it beside them in one run."""
    w1_t, s1, wtype = kb.weight_parts(w1)
    w2_t, s2, wtype2 = kb.weight_parts(w2)
    if wtype != wtype2:
        raise ValueError("fused_ffn: W1 and W2 must share one storage type")
    d, e = _check_args(x, ln_g, ln_b, w1_t, w2_t)
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


def _plan_and_packer(kind: str):
    """The launch plan and the packer of the weights' type ``kind``."""
    return {"int8": (ffn_q8_plan, pack_ffn_q8), "bf16": (ffn_bf16_plan, pack_ffn_bf16),
            "f32": (ffn_f32_plan, pack_ffn_f32)}[kind]
