"""Fused TDT joint decode step: the CUDA kernels ``csrc/joint_step_q8.cu``
(int8 weights), ``csrc/joint_step_bf16.cu`` (bf16 weights; the two share
the body of ``csrc/joint_core.cuh``, laid out by :func:`joint_step_q8_plan`
and :func:`joint_step_bf16_plan`) and ``csrc/joint_step_f32.cu`` (f32
weights, laid out by :func:`joint_step_f32_plan`), each one persistent
cooperative launch, and their plain PyTorch version; the three launches of
``csrc/joint_step.cu`` (:func:`joint_step_chain`), on no path, stay for
``chip_smoke.py`` to time beside the kernels.

Replaces ``trt_asr_tpu/ops/pallas/joint_step_kernel.py:
joint_step_pallas_prepadded`` (the TPU's lane padding is not needed: only
the real V columns are computed). The bound on the H100 is memory: one read
of W_out [640, 8198] (21 MB f32, 10.5 MB bf16, 5.2 MB int8) per call, for
all rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.persistent import (SMEM_PER_BLOCK, TAIL_GROUP, TAIL_KSTEP,
                                                      TAIL_ROWS, TAIL_WARPS, align16,
                                                      pack_columns, pack_tail_weight, pad_k,
                                                      sm_count, weight_kind)
from trt_asr_tpu_torch.ops.quant import (QuantTensor, as_f32, is_low_precision, round_bf16,
                                         scaled_matmul)


def joint_step_plain(e, g, wp, bp, wo, bo, *, ths: int, ndur: int,
                     blank_id: int, blank_penalty: float = 0.0):
    """The kernel's function in plain PyTorch, with its rounding points.
    e [rows, J] f32 (encoder projection incl. bias), g [rows, P] f32;
    wp [P, J], wo [J, V] float or QuantTensor; bp [J], bo [V] f32 or bf16.
    Returns (tok [rows] int32, dur_idx [rows] int32 relative to ths,
    logits [rows, V] f32 before the blank penalty)."""
    rnd = round_bf16 if is_low_precision(wo) else (lambda t: t)
    h = e + scaled_matmul(rnd(g), wp) + bp
    h = rnd(torch.relu(h))
    logits = scaled_matmul(h, wo) + bo
    tok_logits = logits[:, :ths]
    if blank_penalty:
        tok_logits = tok_logits.clone()
        tok_logits[:, blank_id] -= blank_penalty
    tok = torch.argmax(tok_logits, dim=1).to(torch.int32)
    dur = torch.argmax(logits[:, ths:ths + ndur], dim=1).to(torch.int32)
    return tok, dur, logits


class JointPlan(NamedTuple):
    """Launch plan of the persistent joint step (``csrc/joint_step_q8.cu``,
    ``csrc/joint_step_bf16.cu``, ``csrc/joint_step_f32.cu``)."""
    blocks: int          # one a run of W_out's column groups, all co-resident
    groups: int          # 8-column groups of W_out a block
    hcols: int           # columns of W_pred (of h) a block
    smem: int            # dynamic shared bytes a block
    scratch: int         # bytes of device scratch: the ticket, h, the blocks' argmax pairs


JOINT_RUN = 64           # rows of K a run of the hidden product's sums (csrc JS_RUN, JF_RUN)
JOINT_BARS = 3           # mbarriers: W_pred's slice, g's rows, W_out's slice (f32: its first half,
                         # and one more a late warp's range of it)
JOINT_F32_GROUPS = 8     # W_out groups an f32 block takes at most, two a lane (csrc JF_GROUPS)


def _joint_blob_bytes(p: int, j: int, hcols: int, groups: int, bf16: bool = False) -> int:
    """A block's slice: W_pred's ``hcols`` columns [hcols][Pp] int8 (bf16),
    their f32 scales (int8 only) and biases (16-byte aligned), W_out's groups
    [groups][Jp / 16][8][16] int8 (bf16), their f32 scales (int8 only) and
    biases (``joint_blob`` in ``csrc/joint_core.cuh``)."""
    wb, per_col = (2, 1) if bf16 else (1, 2)      # bytes a weight; f32 values a column
    return ((hcols * pad_k(p) + groups * TAIL_GROUP * pad_k(j)) * wb
            + align16(4 * per_col * hcols) + per_col * groups * TAIL_GROUP * 4)


def _plan_grid(rows: int, p: int, j: int, v: int, sms: int, what: str):
    """(blocks, groups, hcols) of a persistent joint step: each block owns
    the fewest 8-column groups of W_out that cover V with at most ``sms``
    blocks, and ``hcols`` = ceil(J / blocks) columns of W_pred. Raises
    ValueError for shapes the kernels do not take."""
    if rows < 1 or p < 4 or j < TAIL_GROUP or v < 1 or p % 4 or j % TAIL_GROUP:
        raise ValueError(f"joint_step[{what}]: needs rows >= 1, P a multiple of 4 and J one of "
                         f"{TAIL_GROUP} (rows={rows}, P={p}, J={j}, V={v})")
    n_groups = -(-v // TAIL_GROUP)
    groups = -(-n_groups // sms)
    blocks = -(-n_groups // groups)
    return blocks, groups, -(-j // blocks)


def _joint_core_plan(rows, p, j, v, sms, smem_limit, bf16: bool) -> JointPlan:
    """The plan of ``csrc/joint_core.cuh``'s body, int8 or bf16 weights."""
    what = "bf16" if bf16 else "int8"
    blocks, groups, hcols = _plan_grid(rows, p, j, v, sms, what)
    runs = -(-p // JOINT_RUN)
    cols = groups * TAIL_GROUP
    smem = (_joint_blob_bytes(p, j, hcols, groups, bf16)
            + TAIL_ROWS * (p + 4) * 4                                  # g's rows
            + TAIL_ROWS * (pad_k(j) + TAIL_KSTEP) * 2                  # h's rows, bf16
            + TAIL_ROWS * cols * 4                                     # a pass's logits
            + align16(max(TAIL_WARPS * groups * 64, TAIL_ROWS * hcols * runs) * 4)   # sums
            + JOINT_BARS * 8)
    if smem > smem_limit:
        raise ValueError(f"joint_step[{what}]: {smem} B of shared memory a block at P={p}, "
                         f"J={j}, V={v} exceeds {smem_limit} B")
    return JointPlan(blocks, groups, hcols, smem, 16 + align16(rows * j * 2) + rows * blocks * 16)


def joint_step_q8_plan(rows: int, p: int, j: int, v: int, sms: int,
                       smem_limit: int = SMEM_PER_BLOCK) -> JointPlan:
    """The grid and shared memory of the int8 joint step for ``rows``
    encoder positions, P predictor and J joint columns, V logits and
    ``sms`` SMs (one block an SM at most): each block owns the fewest
    8-column groups of W_out that cover V with at most ``sms`` blocks, and
    ``hcols`` = ceil(J / blocks) columns of W_pred. Mirrors ``joint_smem``
    in the source, which checks it at launch. Raises ValueError for shapes
    the kernel does not take (P not a multiple of 4, J not one of 8) or
    whose staging does not fit."""
    return _joint_core_plan(rows, p, j, v, sms, smem_limit, bf16=False)


def joint_step_bf16_plan(rows: int, p: int, j: int, v: int, sms: int,
                         smem_limit: int = SMEM_PER_BLOCK) -> JointPlan:
    """The grid and shared memory of the bf16 joint step
    (``csrc/joint_step_bf16.cu``): the int8 step's grid and staging
    (:func:`joint_step_q8_plan`) with bf16 slices, twice int8's bytes, and
    no scales (154,552 B a block at full width: one block an SM). Raises
    ValueError as the int8 plan does."""
    return _joint_core_plan(rows, p, j, v, sms, smem_limit, bf16=True)


def _joint_f32_blob_floats(p: int, j: int, hcols: int, groups: int) -> int:
    """A block's f32 slice in floats: W_pred's ``hcols`` columns [hcols][P],
    b_pred's values (zero to a multiple of 4), b_out's, W_out's groups
    [J / 4][8 groups][4] (``jf_blob`` in the source)."""
    cols = groups * TAIL_GROUP
    return hcols * p + -(-hcols // 4) * 4 + cols + j * cols


def joint_step_f32_plan(rows: int, p: int, j: int, v: int, sms: int,
                        smem_limit: int = SMEM_PER_BLOCK) -> JointPlan:
    """The grid and shared memory of the f32 joint step
    (``csrc/joint_step_f32.cu``), as :func:`joint_step_q8_plan` lays out
    the int8 one: the block's whole f32 slice stays in shared memory, g's
    rows and h's rows share one buffer, and each of the 16 warps sums a
    sixteenth of K for all the block's columns. Mirrors ``jf_smem`` in the
    source, which checks it at launch. Raises ValueError for shapes the
    kernel does not take (more than 8 column groups a block among them) or
    whose staging does not fit."""
    blocks, groups, hcols = _plan_grid(rows, p, j, v, sms, "f32")
    if groups > JOINT_F32_GROUPS:
        raise ValueError(f"joint_step[f32]: {groups} column groups a block at V={v} on {sms} "
                         f"SMs; the kernel takes at most {JOINT_F32_GROUPS}")
    runs = -(-p // JOINT_RUN)
    cols = groups * TAIL_GROUP
    smem = (4 * _joint_f32_blob_floats(p, j, hcols, groups)
            + TAIL_ROWS * max(p + 4, j + 4) * 4                           # g's rows, then h's
            + align16(max(TAIL_ROWS * hcols * runs, TAIL_WARPS * TAIL_ROWS * cols) * 4)  # sums
            + (JOINT_BARS + TAIL_WARPS) * 8)                              # mbarriers
    if smem > smem_limit:
        raise ValueError(f"joint_step[f32]: {smem} B of shared memory a block at P={p}, "
                         f"J={j}, V={v} exceeds {smem_limit} B")
    return JointPlan(blocks, groups, hcols, smem, 16 + align16(rows * j * 4) + rows * blocks * 16)


def pack_joint_f32(wp, bp, wo, bo, plan: JointPlan) -> torch.Tensor:
    """The joint's f32 weights as the f32 joint step's blocks read them, a
    block's slice contiguous: [blocks, floats] f32, block b holding W_pred's
    columns b * hcols .. as [hcols][P] (a column's K contiguous, zero past
    J), their biases (zero to a multiple of 4), the biases of W_out's
    ``groups`` 8-column groups from b * groups, then those groups as
    [J / 4][cols][4] (a column's four consecutive K values in one float4,
    the columns side by side; zero past V). wp [P, J], wo [J, V], bp [J],
    bo [V] f32."""
    p, j = wp.shape
    blocks, hc, cols = plan.blocks, plan.hcols, plan.groups * TAIL_GROUP
    wpp = wp.new_zeros((p, blocks * hc))
    wpp[:, :j] = wp
    wpp = wpp.view(p, blocks, hc).permute(1, 2, 0).reshape(blocks, -1)
    bpp = pack_columns(bp, hc, blocks)
    bpp = torch.cat([bpp, bpp.new_zeros((blocks, -(-hc // 4) * 4 - hc))], dim=1)
    wop = wo.new_zeros((j, blocks * cols))
    wop[:, :wo.shape[1]] = wo
    wop = wop.view(j // 4, 4, blocks, cols).permute(2, 0, 3, 1).reshape(blocks, -1)
    return torch.cat([wpp, bpp, pack_columns(bo, cols, blocks), wop], dim=1).float().contiguous()


def pack_joint(wp, sp, bp, wo, so, bo, plan: JointPlan) -> torch.Tensor:
    """The joint's int8 or bf16 weights as the joint step's blocks read them
    (``csrc/joint_core.cuh``), a block's slice contiguous: [blocks, bytes]
    uint8, block b holding W_pred's columns b * hcols .. as [hcols][Pp] (a
    column's K contiguous, zero past P and J), their scales (int8 only) and
    biases, then W_out's ``groups`` 8-column groups from b * groups
    (:func:`~trt_asr_tpu_torch.ops.kernels.persistent.pack_tail_weight`),
    their scales (int8 only) and biases (zero past V). wp [P, J] and wo [J,
    V] are int8 or bf16; sp [J] and so [V] the int8 scales (None with bf16
    weights); bp [J] and bo [V] f32."""
    p, j = wp.shape
    blocks, hc, cols = plan.blocks, plan.hcols, plan.groups * TAIL_GROUP
    wpp = wp.new_zeros((pad_k(p), blocks * hc))
    wpp[:p, :j] = wp
    wpp = wpp.view(pad_k(p), blocks, hc).permute(1, 2, 0).reshape(blocks, -1)
    pred = [x for x in (sp, bp) if x is not None]
    pred_cols = torch.cat([pack_columns(x.reshape(-1), hc, blocks) for x in pred], dim=1)
    n = len(pred) * hc
    pred_cols = torch.cat([pred_cols, pred_cols.new_zeros((blocks, (align16(4 * n) - 4 * n) // 4))],
                          dim=1)
    out_w = pack_tail_weight(wo, cols, blocks).reshape(blocks, -1)
    out_cols = torch.cat([pack_columns(x.reshape(-1), cols, blocks) for x in (so, bo)
                          if x is not None], dim=1)
    return torch.cat([x.contiguous().view(torch.uint8) for x in (wpp, pred_cols, out_w, out_cols)],
                     dim=1).contiguous()


def pack_joint_step(wp, bp, wo, bo, sms: int | None = None) -> torch.Tensor:
    """The joint's weights for :func:`joint_step`'s ``packed``, for the
    launch plan of a card with ``sms`` SMs (by default that of the weights'
    device): int8 QuantTensors by :func:`pack_joint`, 5.6 MB at full width;
    bf16 weights likewise without scales, 11.3 MB (the biases in f32); f32
    weights by :func:`pack_joint_f32`, 22.6 MB. Each is held beside the [P,
    J] and [J, V] matrices that the plain path reads. Made once, where the
    model is made: a packed copy that no longer matches the weights or
    biases gives wrong results. Raises ValueError for weights of two storage
    types."""
    kind = weight_kind("pack_joint_step: pred and out weights", wp, wo)
    w0 = wp.q if kind == "int8" else wp
    sms = sm_count(w0.device.index or 0) if sms is None else sms
    p, j = w0.shape
    v = (wo.q if kind == "int8" else wo).shape[1]
    plan = JOINT_PLANS[kind](1, p, j, v, sms)
    if kind == "int8":
        return pack_joint(wp.q, wp.s, bp, wo.q, wo.s, bo, plan)
    if kind == "bf16":
        return pack_joint(wp, None, bp, wo, None, bo, plan)
    return pack_joint_f32(wp, bp, wo, bo, plan)


def check_packed_joint(packed: torch.Tensor, plan: JointPlan, p: int, j: int,
                       kind: str = "int8") -> None:
    """Raises ValueError unless ``packed`` has the layout of ``plan``'s
    slices for weights of type ``kind``: [blocks, bytes of a block's slice]
    uint8 for int8 and bf16 weights (bf16's twice int8's bytes, without
    scales), [blocks, floats of a block's slice] f32 for f32 weights."""
    if kind == "f32":
        want = (torch.float32, (plan.blocks, _joint_f32_blob_floats(p, j, plan.hcols, plan.groups)))
    else:
        want = (torch.uint8, (plan.blocks, _joint_blob_bytes(p, j, plan.hcols, plan.groups,
                                                             kind == "bf16")))
    if (packed.dtype, tuple(packed.shape)) != want:
        raise ValueError(f"joint_step[{kind}]: packed weights "
                         f"{packed.dtype} {tuple(packed.shape)} do not fit the launch plan "
                         f"{want[0]} {want[1]} (see pack_joint_step)")


def joint_step(e, g, wp, bp, wo, bo, *, ths: int, ndur: int, blank_id: int,
               blank_penalty: float = 0.0, packed=None):
    """Fused joint step; same arguments and results as
    :func:`joint_step_plain`. CPU tensors take the plain version; CUDA
    tensors launch the persistent kernel of the weights' type (int8, bf16
    or f32), one cooperative launch, or raise (also when its blocks cannot
    all be resident). ``packed``: the weights as :func:`pack_joint_step`
    lays them out, made once with the model; without it they are packed
    anew at that call."""
    if e.device.type == "cpu":
        return joint_step_plain(e, g, wp, bp, wo, bo, ths=ths, ndur=ndur,
                                blank_id=blank_id, blank_penalty=blank_penalty)
    if isinstance(wp, QuantTensor) or isinstance(wo, QuantTensor):
        return _joint_step_q8(e, g, wp, bp, wo, bo, ths, ndur, blank_id, blank_penalty, packed)
    if wp.dtype == torch.float32 and wo.dtype == torch.float32:
        return _joint_step_f32(e, g, wp, bp, wo, bo, ths, ndur, blank_id, blank_penalty, packed)
    return _joint_step_bf16(e, g, wp, bp, wo, bo, ths, ndur, blank_id, blank_penalty, packed)


def _check_args(e, g, wp_t, wo_t, bp, bo, ths, ndur):
    """The checks every route needs; returns (rows, P, J, V, bp, bo), the
    biases in f32 (bf16 biases as the f32 copies kept beside them,
    :func:`as_f32`)."""
    rows, j = e.shape
    p, v = g.shape[1], wo_t.shape[1]
    if wp_t.shape != (p, j) or wo_t.shape[0] != j or g.shape[0] != rows:
        raise ValueError("joint_step: shape mismatch")
    if ths + ndur > v:
        raise ValueError(f"joint_step: ths + ndur = {ths + ndur} exceeds V = {v}")
    bp, bo = as_f32(bp), as_f32(bo)
    if any(t.dtype != torch.float32 for t in (e, g, bp, bo)):
        raise TypeError("joint_step: e and g must be f32, the biases f32 or bf16")
    return rows, p, j, v, bp, bo


def _joint_step_q8(e, g, wp, bp, wo, bo, ths, ndur, blank_id, blank_penalty, packed):
    """The persistent kernel of ``csrc/joint_step_q8.cu`` on CUDA tensors."""
    if not (isinstance(wp, QuantTensor) and isinstance(wo, QuantTensor)):
        raise ValueError("joint_step: pred and out weights must share one storage type")
    rows, p, j, v, bp, bo = _check_args(e, g, wp.q, wo.q, bp, bo, ths, ndur)
    plan = joint_step_q8_plan(rows, p, j, v, sm_count(e.device.index or 0))
    if packed is None:
        packed = pack_joint(wp.q, wp.s, bp, wo.q, wo.s, bo, plan)
    check_packed_joint(packed, plan, p, j)
    return _launch_persistent("joint_step_q8", e, g, rows, p, j, v, packed, plan, ths, ndur,
                              blank_id, blank_penalty)


def _joint_step_bf16(e, g, wp, bp, wo, bo, ths, ndur, blank_id, blank_penalty, packed):
    """The persistent kernel of ``csrc/joint_step_bf16.cu`` on CUDA tensors."""
    weight_kind("joint_step: pred and out weights", wp, wo)
    rows, p, j, v, bp, bo = _check_args(e, g, wp, wo, bp, bo, ths, ndur)
    plan = joint_step_bf16_plan(rows, p, j, v, sm_count(e.device.index or 0))
    if packed is None:
        packed = pack_joint(wp, None, bp, wo, None, bo, plan)
    check_packed_joint(packed, plan, p, j, "bf16")
    return _launch_persistent("joint_step_bf16", e, g, rows, p, j, v, packed, plan, ths, ndur,
                              blank_id, blank_penalty)


def _joint_step_f32(e, g, wp, bp, wo, bo, ths, ndur, blank_id, blank_penalty, packed):
    """The persistent kernel of ``csrc/joint_step_f32.cu`` on CUDA tensors."""
    rows, p, j, v, bp, bo = _check_args(e, g, wp, wo, bp, bo, ths, ndur)
    plan = joint_step_f32_plan(rows, p, j, v, sm_count(e.device.index or 0))
    if packed is None:
        packed = pack_joint_f32(wp, bp, wo, bo, plan)
    check_packed_joint(packed, plan, p, j, "f32")
    return _launch_persistent("joint_step_f32", e, g, rows, p, j, v, packed, plan, ths, ndur,
                              blank_id, blank_penalty)


def _launch_persistent(name, e, g, rows, p, j, v, packed, plan: JointPlan, ths, ndur, blank_id,
                       blank_penalty):
    """One cooperative launch of ``csrc/<name>.cu`` on its packed weights."""
    kb.require_cuda("joint_step", e, g, packed)
    kb.require_aligned("joint_step", 4, g)        # g's rows are read 16 bytes at a time
    kb.require_aligned("joint_step", 16 // packed.element_size(), packed)   # bulk copies
    lib = kb.load(name)
    logits = torch.empty((rows, v), dtype=torch.float32, device=e.device)
    idx = torch.empty((2, rows), dtype=torch.int32, device=e.device)
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=e.device)
    rc = getattr(lib, f"{name}_launch")(
        e.data_ptr(), g.data_ptr(), rows, p, j, v, packed.data_ptr(), plan.blocks,
        plan.groups, plan.hcols, plan.smem, ths, ndur, blank_id, float(blank_penalty),
        logits.data_ptr(), idx[0].data_ptr(), idx[1].data_ptr(), scratch.data_ptr(),
        kb.stream_ptr(e.device))
    kb.check(lib, rc, "joint_step")
    joint_step.launches += 1
    return idx[0], idx[1], logits


def joint_step_chain(e, g, wp, bp, wo, bo, *, ths: int, ndur: int, blank_id: int,
                     blank_penalty: float = 0.0):
    """The three launches of ``csrc/joint_step.cu`` on CUDA tensors (split-K
    hidden product, split-K output product with 32-column argmax tiles, a
    per-row reduction) with f32, bf16 or int8 weights: the predecessor of
    the persistent kernels, on no path, kept so that ``chip_smoke.py`` times
    them side by side in one run."""
    wp_t, sp, wtype = kb.weight_parts(wp)
    wo_t, so, wtype_o = kb.weight_parts(wo)
    if wtype != wtype_o:
        raise ValueError("joint_step: pred and out weights must share one storage type")
    rows, p, j, v, bp, bo = _check_args(e, g, wp_t, wo_t, bp, bo, ths, ndur)
    kb.require_cuda("joint_step", e, g, bp, bo, wp_t, wo_t,
                    *[s for s in (sp, so) if s is not None])
    lib = kb.load("joint_step")
    dev = e.device
    ntiles = (v + 31) // 32
    h = torch.empty((rows, j), dtype=torch.float32, device=dev)
    logits = torch.empty((rows, v), dtype=torch.float32, device=dev)
    tv = torch.empty((rows, ntiles), dtype=torch.float32, device=dev)
    dv = torch.empty_like(tv)
    ti = torch.empty((rows, ntiles), dtype=torch.int32, device=dev)
    di = torch.empty_like(ti)
    ks_pred, ks_out = kb.gemm_splits(p), kb.gemm_splits(j)
    part = torch.empty((max(ks_pred * j, ks_out * v) * rows,), dtype=torch.float32, device=dev)
    tok = torch.empty((rows,), dtype=torch.int32, device=dev)
    dur = torch.empty_like(tok)
    rc = lib.joint_step_launch(
        e.data_ptr(), g.data_ptr(), rows, p, j, v, wp_t.data_ptr(), kb.ptr(sp),
        bp.data_ptr(), wo_t.data_ptr(), kb.ptr(so), bo.data_ptr(), wtype,
        ths, ndur, blank_id, float(blank_penalty), ks_pred, ks_out, h.data_ptr(),
        logits.data_ptr(), part.data_ptr(), tv.data_ptr(), ti.data_ptr(), dv.data_ptr(),
        di.data_ptr(), tok.data_ptr(), dur.data_ptr(), kb.stream_ptr(dev))
    kb.check(lib, rc, "joint_step")
    joint_step.launches += 1
    return tok, dur, logits


joint_step.launches = 0

# weight type -> the plan of its persistent joint step
JOINT_PLANS = {"int8": joint_step_q8_plan, "bf16": joint_step_bf16_plan,
               "f32": joint_step_f32_plan}
