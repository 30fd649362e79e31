"""Fused conformer attention block (B=1 streaming chunks): the CUDA kernel
``csrc/att_block.cu`` and its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/att_block_kernel.py:att_block_pallas``
(with ``build_rel_selection``). The bound on the H100 is memory: the four
projection matrices, the kv cache and the positional table (~20 MB f32,
~7.5 MB with int8 weights per layer at full size); the kernel reads each
weight byte once for all rows (see the source's note).

Instead of the TPU kernel's {0,1} selection tensor, both versions index the
positional table directly: ``r = r0[s] - t`` with ``r0`` derived from
``meta = (cursor, cache_len, valid_tq)``, an int32 device tensor.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.quant import is_low_precision, round_bf16, scaled_matmul


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
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    u = (x - mu) * (1.0 / torch.sqrt(var + 1e-5)) * ln_g + ln_b
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


def att_block(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v, pos_proj,
              kv_cache, meta, *, n_heads: int):
    """Fused attention block; same arguments and results as
    :func:`att_block_plain`. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return att_block_plain(x, ln_g, ln_b, wq, wk, wv, wo, bias_u, bias_v,
                               pos_proj, kv_cache, meta, n_heads=n_heads)
    tq, d = x.shape
    c = kv_cache.shape[0]
    parts = [kb.weight_parts(w) for w in (wq, wk, wv, wo)]
    wtype = parts[0][2]
    if any(p[2] != wtype for p in parts):
        raise ValueError("att_block: q/k/v/o weights must share one storage type")
    if pos_proj.shape != (2 * tq + c - 1, d):
        raise ValueError(f"att_block: pos_proj {tuple(pos_proj.shape)} does not fit "
                         f"Tq={tq}, C={c}")
    if meta.dtype != torch.int32 or meta.numel() != 3:
        raise ValueError("att_block: meta must be int32 (cursor, cache_len, valid_tq)")
    floats = [x, ln_g, ln_b, bias_u, bias_v, pos_proj, kv_cache]
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("att_block: activations, norms, biases and caches must be f32")
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


att_block.launches = 0
