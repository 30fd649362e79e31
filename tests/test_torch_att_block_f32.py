"""Launch plan, weight packing and work split of the f32 attention-block
kernel of the PyTorch port (``ops/kernels/att_block.py``;
``csrc/att_block_f32.cu`` checks the same shared-memory layout at launch):
one cooperative launch whose blocks must all be resident, at most one an
SM, each owning a column slice of Wq, Wk, Wv and Wo whose f32 weights
stream through a ring of slots of shared memory in runs of 64 rows of K,
from a packed copy in which the slice is contiguous in the ring's order,
and one scores item (a head and a run of kv positions). A plain-torch
replay of the kernel's split (the runs of K summed one by one and added in
order, scores by item over the positional band, softmax and context by
column group in two halves of the slots) is held to ``att_block_plain`` at
1e-5: with f32 weights nothing is rounded, so only the summation order
differs. The kernel itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``)."""

import math

import numpy as np
import pytest
import torch

from trt_asr_tpu_torch.ops.kernels import att_block as ab
from trt_asr_tpu_torch.ops.kernels.att_block import (ATT_RUN, att_block, att_block_f32_plan,
                                                     att_block_plain, pack_att_block)
from trt_asr_tpu_torch.ops.kernels.conv_block import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.quant import quantize_tensor

H100_SMS = 132
# (Tq, D, H, C): tiny (ModelConfig.tiny), gate_r3, full width (ModelConfig()),
# Tq 13, one row, six heads of 16 (D 96: a run of 32 rows past K's last 64)
SHAPES = [(8, 64, 4, 32), (8, 64, 4, 64), (8, 1024, 8, 256), (13, 64, 4, 32),
          (13, 1024, 8, 256), (1, 64, 4, 32), (8, 96, 6, 40)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 8 columns on the H100's 132 SMs; the Q/K/V weights'
    16 runs each fit a slot of the ring (6 KB: 64 rows x 3 x 8 columns)
    beside the staging, so all of them are in flight at entry."""
    plan = att_block_f32_plan(8, 1024, 8, 256, H100_SMS)
    assert (plan.blocks, plan.cols, plan.ranges, plan.slots, plan.stages) == (128, 8, 16, 17, 16)
    ring = 16 * 64 * 3 * 8 * 4                          # the weights' slots
    rows = 8 * 1024 * 4                                 # x's rows, u's, ctx's
    item = (2 * 8 + 2 * 17 + 7) * 132 * 4 + 2 * 8 * 17 * 4   # q + biases, keys, band; dots
    values = 256 * 8 * 4 + 8 * 8 * 4                   # the block's columns of v
    softmax = 8 * 264 * 4 + 2 * 8 * 8 * 4              # a head's p; the context's halves
    sums = 16 * 8 * 24 * 4                              # the runs' sums (LN's norms before)
    bars = (3 + 16 + 2 * 16) * 8                        # mbarriers: one a piece of the stream
    assert plan.smem == ring + rows + item + values + softmax + sums + bars == 192_360
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 8 * 1024 * 4 + 8 * 8 * 264 * 4 + 8 * 1024 * 4
    # Tq 13: a ring of 15 slots, so one run waits for a slot to be freed
    assert att_block_f32_plan(13, 1024, 8, 256, H100_SMS).stages == 15


def items(plan, h, s):
    """(head, first position, end) of each block's scores item."""
    out = []
    for b in range(plan.blocks):
        hh, i0 = b // plan.ranges, (b % plan.ranges) * plan.slots
        if hh < h and i0 < s:
            out.append((hh, i0, min(s, i0 + plan.slots)))
    return out


@pytest.mark.parametrize("tq,d,h,c,sms", [(*shape, H100_SMS) for shape in SHAPES] + [
    (8, 64, 4, 32, 4), (13, 64, 4, 32, 4),             # 4 blocks of 16 columns, a head each
    (8, 1024, 8, 256, 66),                              # 64 blocks of 16 columns
])
def test_plan_covers_every_column_and_head_slot_once(tq, d, h, c, sms):
    plan = att_block_f32_plan(tq, d, h, c, sms)
    assert plan.cols % 8 == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols < d <= plan.blocks * plan.cols
    s = c + tq
    seen = np.zeros((h, s), dtype=int)
    for hh, i0, i1 in items(plan, h, s):
        seen[hh, i0:i1] += 1
    assert (seen == 1).all()
    assert h * plan.ranges <= plan.blocks
    assert 1 <= plan.stages <= -(-d // ATT_RUN)
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tq,d,h,c,sms,stages,match", [
    (8, 1016, 4, 256, H100_SMS, None, "a multiple of 8"),     # D
    (8, 96, 8, 256, H100_SMS, None, "head dim of 16"),        # head dim 12
    (0, 64, 4, 32, H100_SMS, None, "a multiple of 8"),        # no rows
    (8, 128, 8, 32, 4, None, "a block a head"),               # 4 blocks of 32 columns, 8 heads
    (8, 1024, 8, 6000, H100_SMS, None, "exceeds"),            # the scores of 6008 slots
    (8, 1024, 8, 256, H100_SMS, 0, "ring slots"),             # no slot
    (8, 64, 4, 32, H100_SMS, 3, "ring slots"),                # more slots than pieces
    (8, 1024, 8, 256, H100_SMS, 30, "exceeds"),               # 30 slots of 6 KB
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, h, c, sms, stages, match):
    with pytest.raises(ValueError, match=match):
        att_block_f32_plan(tq, d, h, c, sms, stages=stages)


def weights(seed, d):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32))
            for _ in range(4)]


def unpack(packed, d, cols, blocks):
    """The four [D, D] matrices back from the packed layout (block b: the
    Q/K/V runs [3][16][cols][4], then the Wo runs [16][cols][4])."""
    runs = -(-d // ATT_RUN)
    k4 = ATT_RUN // 4
    qkv_len = runs * 3 * k4 * cols * 4
    qkv = packed[:, :qkv_len].view(blocks, runs, 3, k4, cols, 4)
    wo = packed[:, qkv_len:].view(blocks, runs, k4, cols, 4)
    full = lambda t: t.permute(1, 2, 4, 0, 3).reshape(runs * ATT_RUN, blocks * cols)  # noqa: E731
    mats = [full(qkv[:, :, q]) for q in range(3)] + [full(wo)]
    for m in mats:                                      # zero past K and D
        assert not m[d:].any() and not m[:, d:].any()
    return [m[:d, :d] for m in mats]


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, 6), (1024, H100_SMS)])
def test_packed_layout_unpacks_to_the_four_matrices(d, sms):
    ws = weights(d, d)
    packed = pack_att_block(*ws, sms=sms)
    plan = att_block_f32_plan(8, d, d // 16, 32, sms)
    runs = -(-d // ATT_RUN)
    assert packed.dtype == torch.float32
    assert packed.shape == (plan.blocks, runs * ATT_RUN * 4 * plan.cols)
    for got, want in zip(unpack(packed, d, plan.cols, plan.blocks), ws):
        assert torch.equal(got, want)
    ab.check_packed_att(packed, plan, d)


@pytest.mark.parametrize("change", ["other_card", "int8_layout", "dropped_block", "other_width"])
def test_check_packed_att_refuses_another_layout(change):
    d = 96
    ws = weights(7, d)
    packed = pack_att_block(*ws, sms=H100_SMS)
    plan = att_block_f32_plan(8, d, d // 16, 32, H100_SMS)
    if change == "other_card":
        packed = pack_att_block(*ws, sms=4)
    elif change == "int8_layout":
        packed = pack_att_block(*[quantize_tensor(w) for w in ws], sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        ab.check_packed_att(packed, plan, d)


def test_layer_params_pack_f32_attention_on_the_card_only():
    """On CPU tensors the wrapper runs its plain version, so nothing is
    packed, whatever the weights' type; the card tests hold the packed copy
    of a model's layers."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
    from trt_asr_tpu_torch.models.parakeet.params import init_params

    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0)
    plain = layer_params(params, cfg.num_layers)
    packed = layer_params(params, cfg.num_layers, pack_att=True)
    assert [sorted(lp) for lp in packed] == [sorted(lp) for lp in plain]
    assert all(lp["att_wq"].dtype == torch.float32 for lp in packed)


def replay(x, ln_g, ln_b, ws, bu, bv, pos, kv, meta, h, plan):
    """The f32 kernel's work split in plain torch: (b) q, k_new, v_new as the
    runs of ATT_RUN rows of K summed one by one, added in order; (c) each
    block's scores item over its kv positions i (ring slot (cursor + i) mod
    C for i < C, current row i - C after), reading positional rows from the
    item's band [i0, i1 + Tq - 1), written in ring-slot order; (d) per
    column group of 8, the head's softmax and the context summed in two
    halves of the slots, then added; (e) the out-projection by runs of K
    again."""
    tq, d = x.shape
    c, dh, s = kv.shape[0], d // h, kv.shape[0] + tq

    def by_runs(a, w):
        out = torch.zeros(a.shape[0], w.shape[1])
        for k0 in range(0, d, ATT_RUN):
            out = out + a[:, k0:k0 + ATT_RUN] @ w[k0:k0 + ATT_RUN]
        return out

    u = layer_norm_plain(x, ln_g, ln_b)
    q, k_new, v_new = (by_runs(u, w) for w in ws[:3])
    cursor, cache_len, valid_tq = (int(v) for v in meta)
    k_all, v_all = torch.cat([kv[:, :d], k_new]), torch.cat([kv[:, d:], v_new])
    scores = torch.full((h, tq, s), float("nan"))
    t = torch.arange(tq)[:, None]
    for hh, i0, i1 in items(plan, h, s):
        cols = slice(hh * dh, (hh + 1) * dh)
        band = pos[i0:i1 + tq - 1, cols]
        i = torch.arange(i0, i1)
        slot = torch.where(i < c, (cursor + i) % c, i)
        qu, qv = q[:, cols] + bu[hh], q[:, cols] + bv[hh]
        a = qu @ k_all[slot, cols].T
        m = (qv[:, None, :] * band[i[None, :] - t + tq - 1 - i0]).sum(-1)
        ok = torch.where(i < c, i >= c - cache_len, i - c < valid_tq)
        sc = (a + m) * (1.0 / math.sqrt(dh))
        scores[hh][:, slot] = torch.where(ok[None, :], sc, torch.full((), -1e30))
    assert not scores.isnan().any()                    # every (head, slot) written
    ctx = torch.zeros(tq, d)
    for col0 in range(0, d, 8):
        p = torch.softmax(scores[col0 // dh], dim=-1)
        for half in (slice(0, s // 2), slice(s // 2, s)):
            ctx[:, col0:col0 + 8] += p[:, half] @ v_all[half, col0:col0 + 8]
    return x + by_runs(ctx, ws[3]), u, k_new, v_new


@pytest.mark.parametrize("tq,d,h,c,cursor,cache_len,valid_tq", [
    (8, 64, 4, 32, 7, 19, 6),          # tiny: partly filled ring
    (8, 64, 4, 32, 0, 32, 6),          # the cursor at the wrap, full ring
    (8, 64, 4, 64, 37, 64, 6),         # gate_r3, steady chunk
    (13, 64, 4, 32, 31, 5, 11),        # Tq 13
    (1, 64, 4, 32, 3, 0, 1),           # one row, empty ring
    (8, 96, 6, 40, 11, 40, 6),         # six heads, a last run of 32 rows of K
    (8, 1024, 8, 256, 100, 256, 6),    # full width, steady chunk
])
def test_replay_of_the_kernels_split_matches_plain(tq, d, h, c, cursor, cache_len, valid_tq):
    rng = np.random.default_rng(tq + d + cursor)
    r = lambda *sh, sc=0.3: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(sh) * sc).astype(np.float32))
    ws = [r(d, d, sc=d ** -0.5) for _ in range(4)]
    args = (r(tq, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1), *ws, r(h, d // h),
            r(h, d // h), r(2 * tq + c - 1, d), r(c, 2 * d))
    meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32)
    plan = att_block_f32_plan(tq, d, h, c, H100_SMS)
    got = replay(*args[:3], ws, *args[7:], meta, h, plan)
    want = att_block_plain(*args, meta, n_heads=h)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4)


def test_wrapper_ignores_packed_weights_on_cpu():
    d, h, c, tq = 64, 4, 32, 8
    rng = np.random.default_rng(5)
    r = lambda *sh: torch.as_tensor(rng.standard_normal(sh).astype(np.float32) * 0.3)  # noqa: E731
    ws = [r(d, d) for _ in range(4)]
    args = (r(tq, d), 1.0 + r(d), r(d), *ws, r(h, d // h), r(h, d // h), r(2 * tq + c - 1, d),
            r(c, 2 * d), torch.tensor([3, 10, 6], dtype=torch.int32))
    before = att_block.launches
    got = att_block(*args, n_heads=h, packed=pack_att_block(*ws, sms=H100_SMS))
    for g, w in zip(got, att_block_plain(*args, n_heads=h)):
        assert torch.equal(g, w)
    assert att_block.launches == before            # no kernel launch on the CPU
