"""Fused conformer attention block (B=1 streaming chunks): the CUDA kernels
``csrc/att_block_q8.cu`` (int8 weights), ``csrc/att_block_bf16.cu`` (bf16
weights; an f32 or bf16 kv cache read as stored) and ``csrc/att_block_f32.cu``
(f32 weights, streamed through shared memory in runs of K), each one
persistent cooperative launch laid out by :func:`att_block_q8_plan`,
:func:`att_block_bf16_plan` or :func:`att_block_f32_plan`, the chain of
launches of ``csrc/att_block.cu`` that the bf16 and f32 kernels replaced
(:func:`att_block_chain`), and their plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas``
(with ``build_rel_selection``). The bound on the H100 is memory: the four
projection matrices, the kv cache and the positional table (~20 MB f32,
~7.4 MB with int8 weights, ~11.6 MB with bf16 per layer at full size);
the kernels read each weight byte once for all rows (see the sources'
notes).

Instead of the TPU kernel's {0,1} selection tensor, both versions index the
positional table directly: ``r = r0[s] - t`` with ``r0`` derived from
``meta = (cursor, cache_len, valid_tq)``, an int32 device tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import (SMEM_PER_BLOCK, TAIL_GROUP, TAIL_KSTEP,
                                                      TAIL_ROWS, TAIL_WARPS, align16,
                                                      column_slices, pack_columns, pad_k,
                                                      pack_tail_weight, sm_count, weight_kind)
from trt_asr_tpu_torch.ops.quant import (QuantTensor, as_f32, is_low_precision, round_bf16,
                                         scaled_matmul)


def rel_offsets(meta: torch.Tensor, c_size: int, tq: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per kv slot (ring cache [0, C) ++ current rows [C, C+Tq)): the
    positional-table row ``r0[s]`` of query row 0 and the attend mask."""
    dev = meta.device
    cursor, cache_len, valid_tq = meta.long().unbind()
    base = c_size + tq - 1
    age = torch.remainder(cursor - 1 - torch.arange(c_size, device=dev), max(c_size, 1)) + 1
    cur = torch.arange(tq, device=dev)
    r0 = torch.cat([base - age, base + cur])
    mask = torch.cat([age <= cache_len, cur < valid_tq])
    return r0, mask


def att_block_plain(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj,
                    kv_cache, meta, *, n_heads: int):
    """The kernel's function in plain PyTorch, with the kernel's rounding
    points. x [Tq, D] f32; weights [D, D] float or QuantTensor; bias_u/v
    [H, dh] f32 or bf16; pos_proj [2*Tq + C - 1, D]; kv_cache [C, 2D]
    ring-ordered k ++ v, f32 or bf16 (widened where read); meta int32 [3] =
    (cursor, cache_len, valid_tq).
    Returns (y = x + attention, u = LN(x), k_new, v_new), all [Tq, D] f32."""
    tq, d = x.shape
    h = n_heads
    dh = d // h
    c = kv_cache.shape[0]
    rnd = round_bf16 if is_low_precision(wq) else (lambda t: t)
    u = layer_norm_plain(x, ln_g, ln_b)
    uc = rnd(u)
    q, k_new, v_new = (scaled_matmul(uc, w) for w in (wq, wk, wv))

    r0, mask = rel_offsets(meta, c, tq)
    s = c + tq
    k_all = rnd(torch.cat([kv_cache[:, :d], k_new])).view(s, h, dh)
    v_all = rnd(torch.cat([kv_cache[:, d:], v_new])).view(s, h, dh)
    qh = q.view(tq, h, dh)
    qu, qv = rnd(qh + bias_u), rnd(qh + bias_v)
    ac = torch.einsum("thd,shd->hts", qu, k_all)
    m = torch.einsum("thd,rhd->htr", qv, pos_proj.view(-1, h, dh))
    ridx = (r0[None, :] - torch.arange(tq, device=x.device)[:, None]).clamp(0, m.shape[-1] - 1)
    bd = rnd(torch.gather(m, 2, ridx[None].expand(h, tq, s)))
    # a fill, not a host copy: the plain version never waits on the device
    scale = torch.full((), 1.0 / math.sqrt(dh), dtype=torch.float32, device=x.device)
    scores = (ac + bd) * scale
    scores = torch.where(mask[None, None, :], scores,
                         torch.full((), -1e30, dtype=torch.float32, device=x.device))
    p = rnd(torch.softmax(scores, dim=-1))
    ctx = torch.einsum("hts,shd->thd", p, v_all).reshape(tq, d)
    y = x + scaled_matmul(rnd(ctx), wo)
    return y, u, k_new, v_new


class AttPlan(NamedTuple):
    """Launch plan of a persistent attention block (``csrc/att_block_q8.cu``,
    ``csrc/att_block_bf16.cu``, ``csrc/att_block_f32.cu``)."""
    blocks: int          # one a column slice, all co-resident
    cols: int            # columns of Wq, Wk, Wv and Wo a block
    ranges: int          # scores items a head, one a block
    slots: int           # kv positions a scores item
    smem: int            # dynamic shared bytes a block
    scratch: int         # bytes of device scratch: q, the scores, ctx
    stages: int = 0      # f32 weights: slots of the weights' ring (0: int8, bf16)
    kind: str = "int8"   # the weights' type: int8, bf16 or f32


# rows of K a run of the products' sums (csrc/att_block_q8.cu AB_RUN), and of
# the f32 weights' runs through the ring (csrc/att_block_f32.cu AF_RUN)
ATT_RUN = 64
ATT_F32_BARS = 3 + TAIL_WARPS    # csrc/att_block_f32.cu AF_PIECE: mbarriers besides the pieces'


def _att_blob_bytes(d: int, cols: int) -> int:
    """A block's int8 slices of Wq, Wk, Wv, Wo (K padded to 16) and its f32
    scale columns of the four."""
    return 4 * pad_k(d) * cols + 4 * cols * 4


def _att_items(what: str, tq: int, d: int, h: int, c: int, sms: int):
    """(cols, blocks, ranges, slots, s4, core bytes) of a persistent attention
    block: each block owns ``cols`` columns of Wq, Wk, Wv and Wo
    (:func:`~trt_asr_tpu_torch.ops.kernels.conv_block.column_slices`, as the
    fused tail), and block b < H * ranges the scores of head b // ranges over
    kv positions [(b % ranges) * slots, + slots) of the C + Tq; ``s4`` is a
    row of a head's scores in floats, rounded up to 16 bytes, and the core
    bytes are the shared memory of the attention core (csrc/att_core.cuh) and
    of v_new's columns. Raises ValueError for shapes the kernels do not take
    (D not a multiple of 8, the head dim not one of 16, fewer blocks than
    heads)."""
    dh = d // max(h, 1)
    if tq < 1 or c < 1 or h < 1 or d % h or d % TAIL_GROUP or dh % 16:
        raise ValueError(f"{what}: needs Tq, C, H >= 1, D a multiple of "
                         f"{TAIL_GROUP} and the head dim of 16 (Tq={tq}, D={d}, H={h}, C={c})")
    cols, blocks = column_slices(d, sms)
    if blocks < h:
        raise ValueError(f"{what}: {blocks} blocks for {h} heads at D={d} on "
                         f"{sms} SMs; the scores need a block a head")
    s = c + tq
    s4 = -(-s // 4) * 4
    slots = -(-s // max(1, blocks // h))
    ranges = -(-s // slots)
    core = ((2 * tq + 2 * slots + tq - 1) * (dh + 4) * 4       # q + biases, keys, band
            + align16(2 * tq * slots * 4)                        # the item's dots
            + c * cols * 4 + align16(tq * cols * 4)              # the block's columns of v
            + tq * s4 * 4                                        # a head's scores, then p
            + 2 * tq * TAIL_GROUP * 4)                           # the context's halves
    return cols, blocks, ranges, slots, s4, core


def _check_fits(what: str, smem: int, smem_limit: int, tq: int, d: int, h: int, c: int):
    if smem > smem_limit:
        raise ValueError(f"{what}: {smem} B of shared memory a block at Tq={tq}, "
                         f"D={d}, H={h}, C={c} exceeds {smem_limit} B")


def att_block_q8_plan(tq: int, d: int, h: int, c: int, sms: int,
                      smem_limit: int = SMEM_PER_BLOCK) -> AttPlan:
    """The grid and shared memory of the int8 attention block for Tq rows,
    width D, H heads, a ring cache of C slots and ``sms`` SMs (one block an
    SM at most; the layout of :func:`_att_items`). Mirrors ``att_smem`` in
    the source, which checks it at launch. Raises ValueError for shapes the
    kernel does not take or whose staging does not fit."""
    what = "att_block[int8]"
    cols, blocks, ranges, slots, s4, core = _att_items(what, tq, d, h, c, sms)
    smem = (_att_blob_bytes(d, cols)                             # weight slices, scales
            + TAIL_ROWS * (pad_k(d) + TAIL_KSTEP) * 2            # operand rows, bf16
            + TAIL_ROWS * d * 4 + 2 * d * 4                      # x's rows; LN's g, b
            + core
            + max(TAIL_WARPS, -(-d // ATT_RUN)) * 3 * cols * TAIL_ROWS * 4   # products' sums
            + 10 * 8)                                            # mbarriers
    _check_fits(what, smem, smem_limit, tq, d, h, c)
    return AttPlan(blocks, cols, ranges, slots, smem,
                   align16(tq * d * 4 + h * tq * s4 * 4) + tq * d * 2)


def _att_bf16_elems(d: int, cols: int) -> int:
    """A block's bf16 slices of Wq, Wk, Wv, Wo (K padded to 16), in elements."""
    return 4 * pad_k(d) * cols


def att_block_bf16_plan(tq: int, d: int, h: int, c: int, sms: int,
                        smem_limit: int = SMEM_PER_BLOCK) -> AttPlan:
    """The grid and shared memory of the bf16 attention block: the int8
    kernel's layout (:func:`att_block_q8_plan`) with bf16 weight slices and
    no scales (64 KB a block at full width), a bf16 cache's key rows staged
    as stored, and the products' sums by warp (the tensor cores). One
    layout takes an f32 or a bf16 kv cache. Mirrors ``atb_smem`` in the
    source, which checks it at launch. Raises ValueError for shapes the
    kernel does not take or whose staging does not fit."""
    what = "att_block[bf16]"
    cols, blocks, ranges, slots, s4, core = _att_items(what, tq, d, h, c, sms)
    smem = (_att_bf16_elems(d, cols) * 2                         # weight slices
            + TAIL_ROWS * (pad_k(d) + TAIL_KSTEP) * 2            # operand rows, bf16
            + TAIL_ROWS * d * 4 + 2 * d * 4                      # x's rows; LN's g, b
            + core + slots * (d // h) * 2                        # a bf16 cache's key rows
            + TAIL_WARPS * 3 * cols * TAIL_ROWS * 4              # products' sums
            + 10 * 8)                                            # mbarriers
    _check_fits(what, smem, smem_limit, tq, d, h, c)
    return AttPlan(blocks, cols, ranges, slots, smem,
                   align16(tq * d * 4 + h * tq * s4 * 4) + tq * d * 2, kind="bf16")


def _f32_runs(d: int) -> int:
    return -(-d // ATT_RUN)


def att_block_f32_plan(tq: int, d: int, h: int, c: int, sms: int,
                       smem_limit: int = SMEM_PER_BLOCK, stages: int | None = None) -> AttPlan:
    """The grid and shared memory of the f32 attention block (the layout of
    :func:`_att_items`), whose weights stream through a ring of ``stages``
    slots of shared memory, one run of ATT_RUN rows of K of the block's
    Q/K/V columns a slot: by default as many as there are runs, or as fit.
    Mirrors ``af_smem`` in the source, which checks it at launch. Raises
    ValueError for shapes the kernel does not take or whose staging does
    not fit with at least one slot."""
    what = "att_block[f32]"
    cols, blocks, ranges, slots, s4, core = _att_items(what, tq, d, h, c, sms)
    runs = _f32_runs(d)
    slot = ATT_RUN * 3 * cols * 4                                # a Q/K/V run of the columns
    fixed = (tq * runs * ATT_RUN * 4                             # x's rows, u's, ctx's
             + core
             + max(runs * tq * 3 * cols, 2 * d) * 4              # products' sums; LN's g, b
             + (ATT_F32_BARS + 2 * runs) * 8)                    # mbarriers: one a piece
    if stages is None:
        stages = max(1, min(runs, (smem_limit - fixed) // slot))
    if not 1 <= stages <= 2 * runs:
        raise ValueError(f"{what}: {stages} ring slots for {runs} runs of K")
    smem = fixed + stages * slot
    _check_fits(what, smem, smem_limit, tq, d, h, c)
    return AttPlan(blocks, cols, ranges, slots, smem,
                   align16(tq * d * 4 + h * tq * s4 * 4) + tq * d * 4, stages, "f32")


def pack_att(wq, wk, wv, wo, sq, sk, sv, so, cols: int, blocks: int) -> torch.Tensor:
    """The layer's int8 weights as the attention block's blocks read them, a
    block's slice contiguous: [blocks, bytes] uint8, block b holding its
    ``cols`` columns b * cols .. of Wq, Wk, Wv and Wo
    (:func:`~trt_asr_tpu_torch.ops.kernels.conv_block.pack_tail_weight`),
    then its f32 columns of their scales (``att_blob`` in the source). wq ..
    wo are int8 [D, D]; sq .. so the scales."""
    weights = [pack_tail_weight(w, cols, blocks).reshape(blocks, -1).view(torch.uint8)
               for w in (wq, wk, wv, wo)]
    scales = torch.cat([pack_columns(v.reshape(-1), cols, blocks) for v in (sq, sk, sv, so)],
                       dim=1)
    return torch.cat(weights + [scales.contiguous().view(torch.uint8)], dim=1).contiguous()


def pack_att_bf16(wq, wk, wv, wo, cols: int, blocks: int) -> torch.Tensor:
    """The layer's bf16 weights as the bf16 attention block's blocks read
    them, a block's slice contiguous: [blocks, 4 * Kp * cols] bf16, block b
    holding its ``cols`` columns b * cols .. of Wq, Wk, Wv and Wo, each as
    :func:`~trt_asr_tpu_torch.ops.kernels.persistent.pack_tail_weight`
    lays out an int8 matrix (``atb_slice`` in the source). wq .. wo are
    bf16 [D, D]."""
    return torch.cat([pack_tail_weight(w, cols, blocks).reshape(blocks, -1)
                      for w in (wq, wk, wv, wo)], dim=1).contiguous()


def pack_att_f32(wq, wk, wv, wo, cols: int, blocks: int) -> torch.Tensor:
    """The layer's f32 weights as the f32 attention block's ring takes them,
    a block's slice contiguous: [blocks, runs * ATT_RUN * 4 * cols] f32,
    block b holding for its ``cols`` columns b * cols .. the runs of
    ATT_RUN rows of K of Wq, Wk and Wv, each [3][ATT_RUN / 4][cols][4] (a
    column's four consecutive K values together), then those of Wo, each
    [ATT_RUN / 4][cols][4]; zero past K and D (``af_issue`` in the
    source). wq .. wo are f32 [D, D]."""
    d = wq.shape[0]
    runs = _f32_runs(d)

    def cut(w):
        full = w.new_zeros((runs * ATT_RUN, blocks * cols))
        full[:d, :d] = w
        return full.view(runs, ATT_RUN // 4, 4, blocks, cols).permute(3, 0, 1, 4, 2)

    qkv = torch.stack([cut(w) for w in (wq, wk, wv)], dim=2)     # [b, run, 3, K/4, col, 4]
    return torch.cat([qkv.reshape(blocks, -1), cut(wo).reshape(blocks, -1)], dim=1).contiguous()


def pack_att_block(wq, wk, wv, wo, sms: int | None = None) -> torch.Tensor:
    """A layer's weights for :func:`att_block`'s ``packed``, for the column
    slices of a card with ``sms`` SMs (by default that of the weights'
    device): int8 QuantTensors by :func:`pack_att`, 4.2 MB a layer at full
    width; bf16 weights by :func:`pack_att_bf16`, 8.4 MB a layer; f32
    weights by :func:`pack_att_f32`, 16.8 MB a layer (403 MB for 24
    layers). Each is held beside the [D, D] matrices that the plain path
    reads. Made once, where the layer's weights are made
    (``models/parakeet/encoder.py:layer_params``): a packed copy that no
    longer matches the weights gives wrong results. Raises TypeError for
    weights of mixed or other types."""
    ws = (wq, wk, wv, wo)
    if all(isinstance(w, QuantTensor) for w in ws):
        sms = sm_count(wq.q.device.index or 0) if sms is None else sms
        return pack_att(wq.q, wk.q, wv.q, wo.q, wq.s, wk.s, wv.s, wo.s,
                        *column_slices(wq.q.shape[0], sms))
    for dtype, pack in ((torch.float32, pack_att_f32), (torch.bfloat16, pack_att_bf16)):
        if all(isinstance(w, torch.Tensor) and w.dtype == dtype for w in ws):
            sms = sm_count(wq.device.index or 0) if sms is None else sms
            return pack(wq, wk, wv, wo, *column_slices(wq.shape[0], sms))
    raise TypeError("pack_att_block takes int8 QuantTensor, bf16 or f32 weights")


def check_packed_att(packed: torch.Tensor, plan: AttPlan, d: int) -> None:
    """Raises ValueError unless ``packed`` has the layout of ``plan``'s
    column slices: with an int8 plan [blocks, bytes of a block's slice]
    uint8, with a bf16 plan [blocks, elements of a block's slice] bf16,
    with an f32 plan [blocks, floats of a block's slice] f32."""
    dtype, elems = {"int8": (torch.uint8, _att_blob_bytes(d, plan.cols)),
                    "bf16": (torch.bfloat16, _att_bf16_elems(d, plan.cols)),
                    "f32": (torch.float32, _f32_runs(d) * ATT_RUN * 4 * plan.cols)}[plan.kind]
    what, want = f"att_block[{plan.kind}]", (plan.blocks, elems)
    if packed.dtype != dtype or tuple(packed.shape) != want:
        raise ValueError(f"{what}: packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} do not fit the launch plan {dtype} {want} "
                         f"(see pack_att_block)")


def _check_inputs(x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache, meta):
    """The checks both kernels need; returns x, the norms, the biases (f32:
    bf16 biases as the f32 copies kept beside them, :func:`as_f32`), the
    positional table and the kv cache (f32 or bf16)."""
    tq, d = x.shape
    c = kv_cache.shape[0]
    if pos_proj.shape != (2 * tq + c - 1, d):
        raise ValueError(f"att_block: pos_proj {tuple(pos_proj.shape)} does not fit "
                         f"Tq={tq}, C={c}")
    if meta.dtype != torch.int32 or meta.numel() != 3:
        raise ValueError("att_block: meta must be int32 (cursor, cache_len, valid_tq)")
    floats = [x, ln_g, ln_b, as_f32(bias_u), as_f32(bias_v), pos_proj]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("att_block: activations, norms and the positional table must be f32")
    if kv_cache.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("att_block: the kv cache must be f32 or bf16")
    return floats + [kv_cache]


def att_block(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj,
              kv_cache, meta, *, n_heads: int, packed=None):
    """Fused attention block; same arguments and results as
    :func:`att_block_plain`. CPU tensors take the plain version; CUDA
    tensors launch the persistent kernel of the weights' type (int8, bf16
    or f32), one cooperative launch, or raise (also when its blocks cannot
    all be resident). ``packed``: the weights as :func:`pack_att_block`
    lays them out, made once with the weights; without it they are packed
    anew at every call. A bf16 kv cache is read as stored by the bf16
    kernel; the int8 and f32 kernels read an f32 copy of it, made at the
    call (:func:`as_f32` counts its bytes)."""
    if x.device.type == "cpu":
        return att_block_plain(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v,
                               pos_proj, kv_cache, meta, n_heads=n_heads)
    ws = (wq, wk, wv, wo)
    return _att_block_persistent(x, ln_g, ln_b, ws, bias_u, bias_v, pos_proj, kv_cache,
                                 meta, n_heads, packed,
                                 weight_kind("att_block: q/k/v/o weights", *ws))


def att_block_chain(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj,
                    kv_cache, meta, *, n_heads: int):
    """The chain of ``csrc/att_block.cu`` on CUDA tensors (LayerNorm, split-K
    Q/K/V, the attention core, split-K Wo: six launches) with f32 or bf16
    weights and an f32 or bf16 kv cache (read as stored): the predecessor
    of the f32 and bf16 persistent kernels, on no path now, kept so that
    ``chip_smoke.py`` times it beside them in one run."""
    tq, d = x.shape
    c = kv_cache.shape[0]
    parts = [kb.weight_parts(w) for w in (wq, wk, wv, wo)]
    wtype = parts[0][2]
    if any(p[2] != wtype for p in parts) or wtype == 2:
        raise ValueError("att_block: q/k/v/o weights must share one float storage type")
    floats = _check_inputs(x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache, meta)
    bias_u, bias_v = floats[3], floats[4]
    # the kernel reads key, value and positional rows with 16-byte loads
    # (8-byte from a bf16 cache), four lanes a row
    if (d // n_heads) % 16 or pos_proj.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("att_block: needs a head dim divisible by 16 and 16-byte "
                         "aligned pos_proj and kv_cache")
    kb.require_cuda("att_block", *floats, meta, *[p[0] for p in parts])
    lib = kb.load("att_block")
    y, u, q, k_new, v_new, ctx = (torch.empty_like(x) for _ in range(6))
    ksplit = kb.gemm_splits(d)
    part = torch.empty((3, ksplit, tq, d), dtype=torch.float32, device=x.device)
    rc = lib.att_block_launch(
        x.data_ptr(), tq, d, n_heads, ln_g.data_ptr(), ln_b.data_ptr(),
        *[p[0].data_ptr() for p in parts], *[kb.ptr(p[1]) for p in parts], wtype,
        bias_u.data_ptr(), bias_v.data_ptr(), pos_proj.data_ptr(),
        kv_cache.data_ptr(), int(kv_cache.dtype == torch.bfloat16), c, meta.data_ptr(),
        1.0 / math.sqrt(d // n_heads), ksplit,
        y.data_ptr(), u.data_ptr(), q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ctx.data_ptr(), part.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "att_block")
    att_block.launches += 1
    return y, u, k_new, v_new


def _att_block_persistent(x, ln_g, ln_b, ws, bias_u, bias_v, pos_proj, kv_cache, meta,
                          n_heads, packed, kind):
    """The persistent kernel of ``kind`` (``csrc/att_block_q8.cu`` for int8
    QuantTensor weights, ``csrc/att_block_bf16.cu`` for bf16,
    ``csrc/att_block_f32.cu`` for f32) on CUDA tensors."""
    int8 = kind == "int8"
    tq, d = x.shape
    c = kv_cache.shape[0]
    mats = [w.q if int8 else w for w in ws]
    if any(m.shape != (d, d) for m in mats):
        raise ValueError(f"att_block: weights must be [D, D] (D={d})")
    floats = _check_inputs(x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache, meta)
    if kind != "bf16":
        floats[-1] = kv_cache = as_f32(kv_cache)
    bias_u, bias_v = floats[3], floats[4]
    plan = {"int8": att_block_q8_plan, "bf16": att_block_bf16_plan,
            "f32": att_block_f32_plan}[kind](tq, d, n_heads, c, sm_count(x.device.index or 0))
    if packed is None:
        packed = (pack_att(*mats, *[w.s for w in ws], plan.cols, plan.blocks) if int8 else
                  {"bf16": pack_att_bf16, "f32": pack_att_f32}[kind](*mats, plan.cols,
                                                                     plan.blocks))
    check_packed_att(packed, plan, d)
    kb.require_cuda("att_block", *floats, meta, packed)
    # bulk copies of x's rows, the norms and the key and positional rows;
    # 16-byte reads of the biases
    kb.require_aligned("att_block", 4, *floats[:-1])
    kb.require_aligned("att_block", 16 // kv_cache.element_size(), kv_cache)
    kb.require_aligned("att_block", 16 // packed.element_size(), packed)
    name = {"int8": "att_block_q8", "bf16": "att_block_bf16", "f32": "att_block_f32"}[kind]
    lib = kb.load(name)
    y, u, k_new, v_new = (torch.empty_like(x) for _ in range(4))
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=x.device)
    stages = (plan.stages,) if kind == "f32" else ()
    kv_type = (int(kv_cache.dtype == torch.bfloat16),) if kind == "bf16" else ()
    rc = getattr(lib, f"{name}_launch")(
        x.data_ptr(), tq, d, n_heads, c, ln_g.data_ptr(), ln_b.data_ptr(), bias_u.data_ptr(),
        bias_v.data_ptr(), pos_proj.data_ptr(), kv_cache.data_ptr(), *kv_type, meta.data_ptr(),
        1.0 / math.sqrt(d // n_heads), packed.data_ptr(), plan.blocks, plan.cols, plan.ranges,
        plan.slots, *stages, plan.smem, y.data_ptr(), u.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), scratch.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "att_block")
    att_block.launches += 1
    return y, u, k_new, v_new


att_block.launches = 0
