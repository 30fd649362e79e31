"""Launch plan, weight packing and work split of the int8 attention-block
kernel of the PyTorch port (``ops/kernels/att_block.py``;
``csrc/att_block_q8.cu`` checks the same shared-memory layout at launch):
one cooperative launch whose blocks must all be resident, at most one an
SM, each owning a column slice of Wq, Wk, Wv and Wo with its weights in
shared memory, copied from a packed copy in which the slice is contiguous,
and one scores item (a head and a run of kv positions). A plain-torch
replay of the kernel's split (scores by item over the positional band,
softmax and context by column group in two halves of the slots) is held to
``att_block_plain``: 1e-5 with f32 weights (only the summation order
differs), 2e-3 with int8 weights (as ``test_torch_att_block.py``: an f32
value that differs in its last bit can round to a neighbouring bf16 value).
The kernel itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``)."""

import math

import numpy as np
import pytest
import torch

from trt_asr_tpu_torch.ops.kernels import att_block as ab
from trt_asr_tpu_torch.ops.kernels.att_block import (att_block, att_block_plain,
                                                     att_block_q8_plan, pack_att_block)
from trt_asr_tpu_torch.ops.kernels.conv_block import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.quant import (QuantTensor, is_low_precision, quantize_tensor,
                                         round_bf16, scaled_matmul)

H100_SMS = 132
# (Tq, D, H, C): tiny (ModelConfig.tiny), gate_r3, full width (ModelConfig()),
# Tq 13, and six heads of 16
SHAPES = [(8, 64, 4, 32), (8, 64, 4, 64), (8, 1024, 8, 256), (13, 64, 4, 32),
          (13, 1024, 8, 256), (1, 64, 4, 32), (8, 96, 6, 40)]


def test_plan_at_full_width_is_one_resident_wave():
    plan = att_block_q8_plan(8, 1024, 8, 256, H100_SMS)
    assert (plan.blocks, plan.cols, plan.ranges, plan.slots) == (128, 8, 16, 17)
    weights = 4 * 1024 * 8 + 4 * 8 * 4                 # Wq, Wk, Wv, Wo slices; scales
    rows = 8 * (1024 + 16) * 2 + 8 * 1024 * 4 + 2 * 1024 * 4   # operand rows, x, norms
    item = (2 * 8 + 2 * 17 + 7) * 132 * 4 + 2 * 8 * 17 * 4   # q + biases, keys, band; dots
    values = 256 * 8 * 4 + 8 * 8 * 4                   # the block's columns of v
    softmax = 8 * 264 * 4 + 2 * 8 * 8 * 4              # a head's p; the context's halves
    sums = 16 * 24 * 8 * 4                             # per-warp sums
    assert plan.smem == weights + rows + item + values + softmax + sums + 10 * 8 == 151_456
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 8 * 1024 * 4 + 8 * 8 * 264 * 4 + 8 * 1024 * 2


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
    plan = att_block_q8_plan(tq, d, h, c, sms)
    assert plan.cols % 8 == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols < d <= plan.blocks * plan.cols
    s = c + tq
    seen = np.zeros((h, s), dtype=int)
    for hh, i0, i1 in items(plan, h, s):
        seen[hh, i0:i1] += 1
    assert (seen == 1).all()
    assert h * plan.ranges <= plan.blocks
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tq,d,h,c,sms,match", [
    (8, 1016, 4, 256, H100_SMS, "a multiple of 8"),     # D
    (8, 96, 8, 256, H100_SMS, "head dim of 16"),        # head dim 12
    (8, 64, 8, 32, H100_SMS, "head dim of 16"),         # head dim 8
    (0, 64, 4, 32, H100_SMS, "a multiple of 8"),        # no rows
    (8, 64, 4, 0, H100_SMS, "a multiple of 8"),         # no cache
    (8, 128, 8, 32, 4, "a block a head"),               # 4 blocks of 32 columns, 8 heads
    (8, 1024, 8, 6000, H100_SMS, "exceeds"),            # the scores of 6008 slots
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, h, c, sms, match):
    with pytest.raises(ValueError, match=match):
        att_block_q8_plan(tq, d, h, c, sms)


def quant(seed, d):
    rng = np.random.default_rng(seed)
    return QuantTensor(torch.as_tensor(rng.integers(-127, 128, size=(d, d), dtype=np.int8)),
                       torch.as_tensor(rng.uniform(1e-3, 2e-2, size=(1, d)).astype(np.float32)))


def unpack_group(p):
    """[Kp / 16, 8, 16] (a group as the kernel reads it) -> [Kp, 8]."""
    return p.permute(0, 2, 1).reshape(-1, 8)


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, 6), (1024, H100_SMS)])
def test_packed_blob_holds_each_blocks_slices_and_scales(d, sms):
    ws = [quant(i, d) for i in range(4)]
    blob = pack_att_block(*ws, sms=sms)
    plan = att_block_q8_plan(8, d, d // 16, 32, sms)
    cols, nb = plan.cols, plan.blocks
    kp = -(-d // 16) * 16
    assert blob.shape == (nb, 4 * kp * cols + 4 * cols * 4) and blob.dtype == torch.uint8
    for b in (0, 1, nb - 1):
        w = blob[b, :4 * kp * cols].view(torch.int8).view(4, cols // 8, kp // 16, 8, 16)
        scales = blob[b, 4 * kp * cols:].view(torch.float32).view(4, cols)
        for which, qt in enumerate(ws):
            full = torch.zeros((kp, nb * cols), dtype=torch.int8)      # zero past K and D
            full[:d, :d] = qt.q
            s = torch.zeros(nb * cols)
            s[:d] = qt.s.reshape(-1)
            for g in range(cols // 8):
                c0 = b * cols + 8 * g
                assert torch.equal(unpack_group(w[which, g]), full[:, c0:c0 + 8])
            assert torch.equal(scales[which], s[b * cols:(b + 1) * cols])


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (1024, H100_SMS), (96, 6)])
def test_packed_weights_fit_every_tq_and_cache_of_the_card(d, sms):
    """The packed weights depend on the card's column slices, not on Tq or
    C: one copy made with the weights serves every chunk."""
    ws = [quant(10 + i, d) for i in range(4)]
    packed = pack_att_block(*ws, sms=sms)
    for tq, c in ((1, 32), (8, 64), (13, 256)):
        plan = att_block_q8_plan(tq, d, d // 16, c, sms)
        ab.check_packed_att(packed, plan, d)
        assert torch.equal(packed, ab.pack_att(*[w.q for w in ws], *[w.s for w in ws],
                                               plan.cols, plan.blocks))


@pytest.mark.parametrize("change", ["other_card", "int8_view", "dropped_block", "other_width"])
def test_check_packed_att_refuses_another_layout(change):
    d = 96
    ws = [quant(20 + i, d) for i in range(4)]
    packed = pack_att_block(*ws, sms=H100_SMS)
    plan = att_block_q8_plan(8, d, d // 16, 32, H100_SMS)
    if change == "other_card":
        packed = pack_att_block(*ws, sms=4)
    elif change == "int8_view":
        packed = packed.view(torch.int8)
    elif change == "dropped_block":
        packed = packed[1:]
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        ab.check_packed_att(packed, plan, d)


def test_pack_att_block_takes_int8_weights_only():
    """Of the quantized weights, int8 ones, all four: int8 beside f32, or
    bf16 beside f32, raises. bf16 weights alone, which took the chain and
    were packed for nothing, now take their own persistent kernel and are
    packed in its layout (test_torch_att_block_bf16.py); f32 weights take
    theirs (test_torch_att_block_f32.py)."""
    bf = [torch.zeros(64, 64, dtype=torch.bfloat16)] * 4
    packed = pack_att_block(*bf, sms=H100_SMS)
    assert packed.dtype == torch.bfloat16 and packed.shape == (8, 4 * 64 * 8)
    with pytest.raises(TypeError, match="int8"):
        pack_att_block(quant(0, 64), *[torch.zeros(64, 64)] * 3, sms=H100_SMS)
    with pytest.raises(TypeError, match="int8"):
        pack_att_block(*bf[:3], torch.zeros(64, 64), sms=H100_SMS)


def test_layer_params_pack_attention_on_the_card_only():
    """On CPU tensors the wrapper runs its plain version, so nothing is
    packed; the card tests hold the packed copy of a model's layers."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
    from trt_asr_tpu_torch.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    cfg = ModelConfig.tiny()
    params = quantize_params(init_params(cfg, seed=0), "all")
    plain = layer_params(params, cfg.num_layers)
    packed = layer_params(params, cfg.num_layers, pack_att=True)
    assert [sorted(lp) for lp in packed] == [sorted(lp) for lp in plain]
    assert all(isinstance(lp["att_wq"], QuantTensor) for lp in packed)


def replay(x, ln_g, ln_b, ws, bu, bv, pos, kv, meta, h, plan):
    """The int8 kernel's work split in plain torch: (b) q, k_new, v_new;
    (c) each block's scores item over its kv positions i (ring slot (cursor
    + i) mod C for i < C, current row i - C after), reading positional rows
    from the item's band [i0, i1 + Tq - 1), written in ring-slot order;
    (d) per column group of 8, the head's softmax and the context summed in
    two halves of the slots, then added; (e) the out-projection."""
    tq, d = x.shape
    c, dh, s = kv.shape[0], d // h, kv.shape[0] + tq
    rnd = round_bf16 if is_low_precision(ws[0]) else (lambda t: t)
    u = layer_norm_plain(x, ln_g, ln_b)
    q, k_new, v_new = (scaled_matmul(rnd(u), w) for w in ws[:3])
    cursor, cache_len, valid_tq = (int(v) for v in meta)
    k_all, v_all = torch.cat([kv[:, :d], k_new]), torch.cat([kv[:, d:], v_new])
    scores = torch.full((h, tq, s), float("nan"))
    t = torch.arange(tq)[:, None]
    for hh, i0, i1 in items(plan, h, s):
        cols = slice(hh * dh, (hh + 1) * dh)
        band = pos[i0:i1 + tq - 1, cols]
        i = torch.arange(i0, i1)
        slot = torch.where(i < c, (cursor + i) % c, i)
        qu, qv = rnd(q[:, cols] + bu[hh]), rnd(q[:, cols] + bv[hh])
        a = qu @ rnd(k_all[slot, cols]).T
        m = (qv[:, None, :] * band[i[None, :] - t + tq - 1 - i0]).sum(-1)
        ok = torch.where(i < c, i >= c - cache_len, i - c < valid_tq)
        sc = (a + rnd(m)) * (1.0 / math.sqrt(dh))
        scores[hh][:, slot] = torch.where(ok[None, :], sc, torch.full((), -1e30))
    assert not scores.isnan().any()                    # every (head, slot) written
    ctx = torch.zeros(tq, d)
    for col0 in range(0, d, 8):
        p = rnd(torch.softmax(scores[col0 // dh], dim=-1))
        for half in (slice(0, s // 2), slice(s // 2, s)):
            ctx[:, col0:col0 + 8] += p[:, half] @ rnd(v_all[half, col0:col0 + 8])
    return x + scaled_matmul(rnd(ctx), ws[3]), u, k_new, v_new


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("tq,d,h,c,cursor,cache_len,valid_tq", [
    (8, 64, 4, 32, 7, 19, 6),          # tiny: partly filled ring
    (8, 64, 4, 32, 0, 32, 6),          # the cursor at the wrap, full ring
    (8, 64, 4, 64, 37, 64, 6),         # gate_r3, steady chunk
    (13, 64, 4, 32, 31, 5, 11),        # Tq 13
    (1, 64, 4, 32, 3, 0, 1),           # one row, empty ring
    (8, 1024, 8, 256, 100, 256, 6),    # full width, steady chunk
])
def test_replay_of_the_kernels_split_matches_plain(tq, d, h, c, cursor, cache_len, valid_tq,
                                                   weights):
    rng = np.random.default_rng(tq + d + cursor)
    r = lambda *sh, sc=0.3: torch.as_tensor(  # noqa: E731
        (rng.standard_normal(sh) * sc).astype(np.float32))
    ws = [r(d, d, sc=d ** -0.5) for _ in range(4)]
    if weights == "int8":
        ws = [quantize_tensor(w) for w in ws]
    args = (r(tq, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1), *ws, r(h, d // h),
            r(h, d // h), r(2 * tq + c - 1, d), r(c, 2 * d))
    meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32)
    plan = att_block_q8_plan(tq, d, h, c, H100_SMS)
    got = replay(*args[:3], list(args[3:7]), *args[7:], meta, h, plan)
    want = att_block_plain(*args, meta, n_heads=h)
    atol = 1e-5 if weights == "f32" else 2e-3
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=atol, rtol=1e-4)


def test_wrapper_ignores_packed_weights_on_cpu():
    d, h, c, tq = 64, 4, 32, 8
    rng = np.random.default_rng(4)
    r = lambda *sh: torch.as_tensor(rng.standard_normal(sh).astype(np.float32) * 0.3)  # noqa: E731
    ws = [quantize_tensor(r(d, d)) for _ in range(4)]
    args = (r(tq, d), 1.0 + r(d), r(d), *ws, r(h, d // h), r(h, d // h), r(2 * tq + c - 1, d),
            r(c, 2 * d), torch.tensor([3, 10, 6], dtype=torch.int32))
    before = att_block.launches
    got = att_block(*args, n_heads=h, packed=pack_att_block(*ws, sms=H100_SMS))
    for g, w in zip(got, att_block_plain(*args, n_heads=h)):
        assert torch.equal(g, w)
    assert att_block.launches == before            # no kernel launch on the CPU
