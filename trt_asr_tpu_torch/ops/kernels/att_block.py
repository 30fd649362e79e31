"""Fused conformer attention block (B=1 streaming chunks): the CUDA kernels
``csrc/att_block.cu`` (f32 and bf16 weights, a chain of launches) and
``csrc/att_block_q8.cu`` (int8 weights, one persistent cooperative launch
laid out by :func:`att_block_q8_plan`), and their plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas``
(with ``build_rel_selection``). The bound on the H100 is memory: the four
projection matrices, the kv cache and the positional table (~20 MB f32,
~7.4 MB with int8 weights per layer at full size); the kernels read each
weight byte once for all rows (see the sources' notes).

Instead of the TPU kernel's {0,1} selection tensor, both versions index the
positional table directly: ``r = r0[s] - t`` with ``r0`` derived from
``meta = (cursor, cache_len, valid_tq)``, an int32 device tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.conv_block import (SMEM_PER_BLOCK, TAIL_GROUP, TAIL_KSTEP,
                                                      TAIL_ROWS, TAIL_WARPS, align16,
                                                      column_slices, pack_columns, pad_k,
                                                      pack_tail_weight, sm_count)
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.quant import (QuantTensor, is_low_precision, round_bf16,
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
    [H, dh]; pos_proj [2*Tq + C - 1, D]; kv_cache [C, 2D] ring-ordered
    k ++ v; meta int32 [3] = (cursor, cache_len, valid_tq).
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
    """Launch plan of the int8 attention block (``csrc/att_block_q8.cu``)."""
    blocks: int          # one a column slice, all co-resident
    cols: int            # columns of Wq, Wk, Wv and Wo a block
    ranges: int          # scores items a head, one a block
    slots: int           # kv positions a scores item
    smem: int            # dynamic shared bytes a block
    scratch: int         # bytes of device scratch: q, the scores, ctx


ATT_RUN = 64                 # rows of K a run of the Q/K/V sums (csrc/att_block_q8.cu AB_RUN)


def _att_blob_bytes(d: int, cols: int) -> int:
    """A block's int8 slices of Wq, Wk, Wv, Wo (K padded to 16) and its f32
    scale columns of the four."""
    return 4 * pad_k(d) * cols + 4 * cols * 4


def att_block_q8_plan(tq: int, d: int, h: int, c: int, sms: int,
                      smem_limit: int = SMEM_PER_BLOCK) -> AttPlan:
    """The grid and shared memory of the int8 attention block for Tq rows,
    width D, H heads, a ring cache of C slots and ``sms`` SMs (one block an
    SM at most): each block owns ``cols`` columns of Wq, Wk, Wv and Wo
    (:func:`~trt_asr_tpu_torch.ops.kernels.conv_block.column_slices`, as
    the fused tail), and block b < H * ranges the scores of head b // ranges
    over kv positions [(b % ranges) * slots, + slots) of the C + Tq. Mirrors
    ``att_smem`` in the source, which checks it at launch. Raises
    ValueError for shapes the kernel does not take (D not a multiple of 8,
    the head dim not one of 16, fewer blocks than heads) or whose staging
    does not fit."""
    dh = d // max(h, 1)
    if tq < 1 or c < 1 or h < 1 or d % h or d % TAIL_GROUP or dh % 16:
        raise ValueError(f"att_block[int8]: needs Tq, C, H >= 1, D a multiple of "
                         f"{TAIL_GROUP} and the head dim of 16 (Tq={tq}, D={d}, H={h}, C={c})")
    cols, blocks = column_slices(d, sms)
    if blocks < h:
        raise ValueError(f"att_block[int8]: {blocks} blocks for {h} heads at D={d} on "
                         f"{sms} SMs; the scores need a block a head")
    s = c + tq
    s4 = -(-s // 4) * 4                 # a row of a head's scores, in 16-byte pieces
    slots = -(-s // max(1, blocks // h))
    ranges = -(-s // slots)
    smem = (_att_blob_bytes(d, cols)                             # weight slices, scales
            + TAIL_ROWS * (pad_k(d) + TAIL_KSTEP) * 2            # operand rows, bf16
            + TAIL_ROWS * d * 4 + 2 * d * 4                      # x's rows; LN's g, b
            + (2 * tq + 2 * slots + tq - 1) * (dh + 4) * 4       # q + biases, keys, band
            + align16(2 * tq * slots * 4)                        # the item's dots
            + c * cols * 4 + align16(tq * cols * 4)              # the block's columns of v
            + tq * s4 * 4                                        # a head's scores, then p
            + 2 * tq * TAIL_GROUP * 4                            # the context's halves
            + max(TAIL_WARPS, -(-d // ATT_RUN)) * 3 * cols * TAIL_ROWS * 4   # products' sums
            + 10 * 8)                                            # mbarriers
    if smem > smem_limit:
        raise ValueError(f"att_block[int8]: {smem} B of shared memory a block at Tq={tq}, "
                         f"D={d}, H={h}, C={c} exceeds {smem_limit} B")
    return AttPlan(blocks, cols, ranges, slots, smem,
                   align16(tq * d * 4 + h * tq * s4 * 4) + tq * d * 2)


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


def _require_int8(*ws) -> None:
    if not all(isinstance(w, QuantTensor) for w in ws):
        raise TypeError("att_block[int8] takes int8 QuantTensor weights only")


def pack_att_block(wq, wk, wv, wo, sms: int | None = None) -> torch.Tensor:
    """A layer's weights for :func:`att_block`'s ``packed`` (int8
    QuantTensors): :func:`pack_att` for the column slices of a card with
    ``sms`` SMs (by default that of the weights' device). Made once, where
    the layer's int8 weights are made (``models/parakeet/encoder.py:
    layer_params``): a packed copy that no longer matches the weights gives
    wrong results. 4.2 MB a layer at full width, beside the [D, D] matrices
    that the plain path reads."""
    _require_int8(wq, wk, wv, wo)
    if sms is None:
        sms = sm_count(wq.q.device.index or 0)
    return pack_att(wq.q, wk.q, wv.q, wo.q, wq.s, wk.s, wv.s, wo.s,
                    *column_slices(wq.q.shape[0], sms))


def check_packed_att(packed: torch.Tensor, plan: AttPlan, d: int) -> None:
    """Raises ValueError unless ``packed`` has the layout of ``plan``'s
    column slices: [blocks, bytes of a block's slice] uint8."""
    want = (plan.blocks, _att_blob_bytes(d, plan.cols))
    if packed.dtype != torch.uint8 or tuple(packed.shape) != want:
        raise ValueError(f"att_block[int8]: packed weights {packed.dtype} "
                         f"{tuple(packed.shape)} do not fit the launch plan {want} "
                         f"(see pack_att_block)")


def _check_inputs(x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache, meta):
    """The checks both kernels need; returns the f32 inputs."""
    tq, d = x.shape
    c = kv_cache.shape[0]
    if pos_proj.shape != (2 * tq + c - 1, d):
        raise ValueError(f"att_block: pos_proj {tuple(pos_proj.shape)} does not fit "
                         f"Tq={tq}, C={c}")
    if meta.dtype != torch.int32 or meta.numel() != 3:
        raise ValueError("att_block: meta must be int32 (cursor, cache_len, valid_tq)")
    floats = [x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("att_block: activations, norms, biases and caches must be f32")
    return floats


def att_block(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj,
              kv_cache, meta, *, n_heads: int, packed=None):
    """Fused attention block; same arguments and results as
    :func:`att_block_plain`. CPU tensors take the plain version; CUDA
    tensors launch a kernel (or raise): with int8 weights the persistent
    kernel, one cooperative launch (raising also when its blocks cannot all
    be resident), else the chain. ``packed``: the int8 weights as
    :func:`pack_att_block` lays them out, made once with the weights;
    without it they are packed anew at every call."""
    if x.device.type == "cpu":
        return att_block_plain(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v,
                               pos_proj, kv_cache, meta, n_heads=n_heads)
    if any(isinstance(w, QuantTensor) for w in (wq, wk, wv, wo)):
        return _att_block_q8(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj,
                             kv_cache, meta, n_heads, packed)
    tq, d = x.shape
    c = kv_cache.shape[0]
    parts = [kb.weight_parts(w) for w in (wq, wk, wv, wo)]
    wtype = parts[0][2]
    if any(p[2] != wtype for p in parts):
        raise ValueError("att_block: q/k/v/o weights must share one storage type")
    floats = _check_inputs(x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache, meta)
    # the kernel reads key, value and positional rows with 16-byte loads,
    # four lanes a row
    if (d // n_heads) % 16 or pos_proj.data_ptr() % 16 or kv_cache.data_ptr() % 16:
        raise ValueError("att_block: needs a head dim divisible by 16 and 16-byte "
                         "aligned pos_proj and kv_cache")
    kb.require_cuda("att_block", *floats, meta, *[p[0] for p in parts],
                    *[p[1] for p in parts if p[1] is not None])
    lib = kb.load("att_block")
    y, u, q, k_new, v_new, ctx = (torch.empty_like(x) for _ in range(6))
    ksplit = kb.gemm_splits(d)
    part = torch.empty((3, ksplit, tq, d), dtype=torch.float32, device=x.device)
    rc = lib.att_block_launch(
        x.data_ptr(), tq, d, n_heads, ln_g.data_ptr(), ln_b.data_ptr(),
        *[p[0].data_ptr() for p in parts], *[kb.ptr(p[1]) for p in parts], wtype,
        bias_u.data_ptr(), bias_v.data_ptr(), pos_proj.data_ptr(),
        kv_cache.data_ptr(), c, meta.data_ptr(), 1.0 / math.sqrt(d // n_heads), ksplit,
        y.data_ptr(), u.data_ptr(), q.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), ctx.data_ptr(), part.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "att_block")
    att_block.launches += 1
    return y, u, k_new, v_new


def _att_block_q8(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj, kv_cache, meta,
                  n_heads, packed):
    """The int8 kernel (``csrc/att_block_q8.cu``) on CUDA tensors."""
    _require_int8(wq, wk, wv, wo)
    tq, d = x.shape
    c = kv_cache.shape[0]
    if any(w.q.shape != (d, d) for w in (wq, wk, wv, wo)):
        raise ValueError(f"att_block: weights must be [D, D] (D={d})")
    floats = _check_inputs(x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache, meta)
    plan = att_block_q8_plan(tq, d, n_heads, c, sm_count(x.device.index or 0))
    if packed is None:
        packed = pack_att(wq.q, wk.q, wv.q, wo.q, wq.s, wk.s, wv.s, wo.s, plan.cols,
                          plan.blocks)
    check_packed_att(packed, plan, d)
    kb.require_cuda("att_block", *floats, meta, packed)
    # bulk copies of x's rows, the norms and the key and positional rows;
    # 16-byte reads of the biases
    kb.require_aligned("att_block", 4, *floats)
    kb.require_aligned("att_block", 16, packed)
    lib = kb.load("att_block_q8")
    y, u, k_new, v_new = (torch.empty_like(x) for _ in range(4))
    scratch = torch.empty((plan.scratch,), dtype=torch.uint8, device=x.device)
    rc = lib.att_block_q8_launch(
        x.data_ptr(), tq, d, n_heads, c, ln_g.data_ptr(), ln_b.data_ptr(), bias_u.data_ptr(),
        bias_v.data_ptr(), pos_proj.data_ptr(), kv_cache.data_ptr(), meta.data_ptr(),
        1.0 / math.sqrt(d // n_heads), packed.data_ptr(), plan.blocks, plan.cols, plan.ranges,
        plan.slots, plan.smem, y.data_ptr(), u.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        scratch.data_ptr(), kb.stream_ptr(x.device))
    kb.check(lib, rc, "att_block")
    att_block.launches += 1
    return y, u, k_new, v_new


att_block.launches = 0
