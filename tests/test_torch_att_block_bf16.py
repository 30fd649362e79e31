"""Launch plan, weight packing and work split of the bf16 attention-block
kernel of the PyTorch port (``ops/kernels/att_block.py``;
``csrc/att_block_bf16.cu`` checks the same shared-memory layout at launch):
one cooperative launch whose blocks must all be resident, at most one an
SM, each owning a column slice of Wq, Wk, Wv and Wo (bf16, 64 KB a block
at full width) in shared memory, copied from a packed copy in which the
slice is contiguous, and one scores item (a head and a run of kv
positions); the kv cache is read as stored, f32 or bf16. A plain-torch
replay of the kernel's split (the products' K in runs of whole mma steps,
one run a warp, the runs added in warp order; scores by item over the
positional band; softmax and context by column group in two halves of the
slots) is held to ``att_block_plain`` and to the JAX package's
``att_block_pallas`` in interpret mode with bf16 weights at 2e-3: both sides
round the same operands to bf16, but the sums run in another order, and an
f32 value that differs in its last bit can round to a neighbouring bf16
value (as ``test_torch_att_block_q8.py`` states for int8). The kernel
itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 2)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trt_asr_tpu.ops.pallas.att_block_kernel import att_block_pallas, build_rel_selection
from trt_asr_tpu_torch.ops.kernels import att_block as ab
from trt_asr_tpu_torch.ops.kernels.att_block import (att_block, att_block_bf16_plan,
                                                     att_block_plain, pack_att_block)
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK, pad_k
from trt_asr_tpu_torch.ops.quant import quantize_tensor, round_bf16

H100_SMS = 132
TOL = 2e-3
bf16 = torch.bfloat16
# (Tq, D, H, C): tiny (ModelConfig.tiny), gate_r3, full width (ModelConfig()),
# Tq 13 at both widths, one row, and six heads of 16
SHAPES = [(8, 64, 4, 32), (8, 64, 4, 64), (8, 1024, 8, 256), (13, 64, 4, 32),
          (13, 1024, 8, 256), (1, 64, 4, 32), (8, 96, 6, 40)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 8 columns on the H100's 132 SMs, each with its bf16
    slices of the four weights (64 KB) whole in shared memory: the int8
    kernel's 151,456 B with twice the weights, no scales, a bf16 cache's
    key rows and the tensor-core products' sums by warp."""
    plan = att_block_bf16_plan(8, 1024, 8, 256, H100_SMS)
    assert (plan.blocks, plan.cols, plan.ranges, plan.slots, plan.kind) == (128, 8, 16, 17,
                                                                            "bf16")
    weights = 4 * 1024 * 8 * 2                         # Wq, Wk, Wv, Wo slices, bf16
    rows = 8 * (1024 + 16) * 2 + 8 * 1024 * 4 + 2 * 1024 * 4   # operand rows, x, norms
    item = (2 * 8 + 2 * 17 + 7) * 132 * 4 + 2 * 8 * 17 * 4   # q + biases, keys, band; dots
    kst = 17 * 128 * 2                                 # the item's key rows as stored, bf16
    values = 256 * 8 * 4 + 8 * 8 * 4                   # the block's columns of v
    softmax = 8 * 264 * 4 + 2 * 8 * 8 * 4              # a head's p; the context's halves
    sums = 16 * 24 * 8 * 4                             # per-warp sums
    total = weights + rows + item + kst + values + softmax + sums + 10 * 8
    assert plan.smem == total == 188_448
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
])
def test_plan_covers_every_column_and_head_slot_once(tq, d, h, c, sms):
    plan = att_block_bf16_plan(tq, d, h, c, sms)
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
    (8, 128, 8, 32, 4, "a block a head"),               # 4 blocks of 32 columns, 8 heads
    (8, 1024, 8, 3000, H100_SMS, "exceeds"),            # the scores of 3008 slots
    (8, 1024, 8, 256, 66, "exceeds"),                   # 16 columns a block: 128 KB of weights
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, h, c, sms, match):
    with pytest.raises(ValueError, match=match):
        att_block_bf16_plan(tq, d, h, c, sms)


def bf16_weights(seed, d, n=4):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor((rng.standard_normal((d, d)) * d ** -0.5).astype(np.float32))
            .to(bf16) for _ in range(n)]


def unpack_group(p):
    """[Kp / 16, 8, 16] (a group as the kernel reads it) -> [Kp, 8]."""
    return p.permute(0, 2, 1).reshape(-1, 8)


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, 6), (1024, H100_SMS)])
def test_packed_blob_holds_each_blocks_slices(d, sms):
    ws = bf16_weights(d, d)
    blob = pack_att_block(*ws, sms=sms)
    plan = att_block_bf16_plan(8, d, d // 16, 32, sms)
    cols, nb, kp = plan.cols, plan.blocks, pad_k(d)
    assert blob.shape == (nb, 4 * kp * cols) and blob.dtype == bf16
    for b in (0, 1, nb - 1):
        w = blob[b].view(4, cols // 8, kp // 16, 8, 16)
        for which, wt in enumerate(ws):
            full = torch.zeros((kp, nb * cols), dtype=bf16)           # zero past K and D
            full[:d, :d] = wt
            for g in range(cols // 8):
                c0 = b * cols + 8 * g
                assert torch.equal(unpack_group(w[which, g]), full[:, c0:c0 + 8])


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, 6)])
def test_packed_weights_fit_every_tq_and_cache_of_the_card(d, sms):
    """The packed weights depend on the card's column slices, not on Tq or
    C: one copy made with the weights serves every chunk."""
    ws = bf16_weights(10 + d, d)
    packed = pack_att_block(*ws, sms=sms)
    for tq, c in ((1, 32), (8, 64), (13, 256)):
        plan = att_block_bf16_plan(tq, d, d // 16, c, sms)
        ab.check_packed_att(packed, plan, d)
        assert torch.equal(packed, ab.pack_att_bf16(*ws, plan.cols, plan.blocks))


@pytest.mark.parametrize("change", ["other_card", "int8_layout", "f32_layout", "dropped_block",
                                    "other_width"])
def test_check_packed_att_refuses_another_layout(change):
    d = 96
    ws = bf16_weights(20, d)
    packed = pack_att_block(*ws, sms=H100_SMS)
    plan = att_block_bf16_plan(8, d, d // 16, 32, H100_SMS)
    if change == "other_card":
        packed = pack_att_block(*ws, sms=4)
    elif change == "int8_layout":
        packed = pack_att_block(*[quantize_tensor(w.float()) for w in ws], sms=H100_SMS)
    elif change == "f32_layout":
        packed = pack_att_block(*[w.float() for w in ws], sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        ab.check_packed_att(packed, plan, d)


def test_layer_params_pack_bf16_attention_on_the_card_only(monkeypatch):
    """The weights of ``cast_params_for_compute`` (bf16): on CPU tensors the
    wrapper runs its plain version, so nothing is packed; on the card
    (stood in for here: the weights count as on the card and the plan
    takes the H100's SMs) each layer holds the copy ``pack_att_block``
    makes, and only with ``pack_att``."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.models.parakeet.params import cast_params_for_compute, init_params

    cfg = ModelConfig.tiny()
    params = cast_params_for_compute(init_params(cfg, seed=0), bf16)
    plain = encoder.layer_params(params, cfg.num_layers)
    on_cpu = encoder.layer_params(params, cfg.num_layers, pack_att=True)
    assert [sorted(lp) for lp in on_cpu] == [sorted(lp) for lp in plain]
    assert all(lp["att_wq"].dtype == bf16 for lp in on_cpu)
    monkeypatch.setattr(encoder, "_bf16_weights", lambda ws: True)
    monkeypatch.setattr(ab, "sm_count", lambda index: H100_SMS)
    for lp in encoder.layer_params(params, cfg.num_layers, pack_att=True):
        att = [lp[k] for k in ("att_wq", "att_wk", "att_wv", "att_wo")]
        assert torch.equal(lp["att_block_packed"], pack_att_block(*att, sms=H100_SMS))
        assert "conv_block_packed" not in lp           # the conv module keeps its chain
    assert not any("att_block_packed" in lp
                   for lp in encoder.layer_params(params, cfg.num_layers))


def warp_runs(a, w):
    """a @ w as block_product sums it: K in runs of whole mma steps (16 rows
    of K), one run a warp of 16, each run's sum added in warp order (inside
    a run the tensor cores sum in their own order)."""
    k = a.shape[-1]
    steps = -(-k // 16)
    per = -(-steps // 16)
    out = torch.zeros(a.shape[0], w.shape[1])
    for s0 in range(0, steps, per):
        ks = slice(16 * s0, min(k, 16 * (s0 + per)))
        out = out + a[:, ks] @ w[ks].float()
    return out


def replay(x, ln_g, ln_b, ws, bu, bv, pos, kv, meta, h, plan):
    """The bf16 kernel's work split in plain torch: (b) q, k_new, v_new of
    bf16(LN(x)) by warp runs; (c) each block's scores item over its kv
    positions i (ring slot (cursor + i) mod C for i < C, current row i - C
    after), reading positional rows from the item's band [i0, i1 + Tq - 1)
    and the cache's keys as stored, written in ring-slot order; (d) per
    column group of 8, the head's softmax and the context summed in two
    halves of the slots, then added; (e) the out-projection by warp runs."""
    tq, d = x.shape
    c, dh, s = kv.shape[0], d // h, kv.shape[0] + tq
    u = layer_norm_plain(x, ln_g, ln_b)
    q, k_new, v_new = (warp_runs(round_bf16(u), w) for w in ws[:3])
    cursor, cache_len, valid_tq = (int(v) for v in meta)
    kv = kv.float()
    k_all, v_all = torch.cat([kv[:, :d], k_new]), torch.cat([kv[:, d:], v_new])
    scores = torch.full((h, tq, s), float("nan"))
    t = torch.arange(tq)[:, None]
    for hh, i0, i1 in items(plan, h, s):
        cols = slice(hh * dh, (hh + 1) * dh)
        band = pos[i0:i1 + tq - 1, cols]
        i = torch.arange(i0, i1)
        slot = torch.where(i < c, (cursor + i) % c, i)
        qu, qv = round_bf16(q[:, cols] + bu[hh].float()), round_bf16(q[:, cols] + bv[hh].float())
        a = qu @ round_bf16(k_all[slot, cols]).T
        m = (qv[:, None, :] * band[i[None, :] - t + tq - 1 - i0]).sum(-1)
        ok = torch.where(i < c, i >= c - cache_len, i - c < valid_tq)
        sc = (a + round_bf16(m)) * (1.0 / math.sqrt(dh))
        scores[hh][:, slot] = torch.where(ok[None, :], sc, torch.full((), -1e30))
    assert not scores.isnan().any()                    # every (head, slot) written
    ctx = torch.zeros(tq, d)
    for col0 in range(0, d, 8):
        p = round_bf16(torch.softmax(scores[col0 // dh], dim=-1))
        for half in (slice(0, s // 2), slice(s // 2, s)):
            ctx[:, col0:col0 + 8] += p[:, half] @ round_bf16(v_all[half, col0:col0 + 8])
    return x + warp_runs(round_bf16(ctx), ws[3]), u, k_new, v_new


def inputs(seed, tq, d, h, c, kv):
    rng = np.random.default_rng(seed)
    r = lambda *sh, sc=0.3: (rng.standard_normal(sh) * sc).astype(np.float32)  # noqa: E731
    return dict(x=r(tq, d, sc=1.0), ln_g=1.0 + r(d, sc=0.2), ln_b=r(d, sc=0.1),
                ws=[r(d, d, sc=d ** -0.5) for _ in range(4)], bu=r(h, d // h), bv=r(h, d // h),
                pos=r(2 * tq + c - 1, d), kv=r(c, 2 * d), kv_dtype=kv)


def port_args(inp):
    """The kernel's arguments: bf16 weights and biases (their f32 copies are
    what the kernel reads), the kv cache in its stored type."""
    kv = torch.as_tensor(inp["kv"])
    return (torch.as_tensor(inp["x"]), torch.as_tensor(inp["ln_g"]), torch.as_tensor(inp["ln_b"]),
            *[torch.as_tensor(w).to(bf16) for w in inp["ws"]],
            torch.as_tensor(inp["bu"]).to(bf16), torch.as_tensor(inp["bv"]).to(bf16),
            torch.as_tensor(inp["pos"]), kv.to(bf16) if inp["kv_dtype"] == "bf16" else kv)


def compare(got, want, valid_tq, atol=TOL):
    for name, g, w in zip(("y", "u", "k_new", "v_new"), got, want):
        g, w = np.asarray(g, dtype=np.float32), np.asarray(w, dtype=np.float32)
        if name == "y":                         # padded query rows are don't-care
            g, w = g[:valid_tq], w[:valid_tq]
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("tq,d,h,c,cursor,cache_len,valid_tq", [
    (8, 64, 4, 32, 7, 19, 6),          # tiny: partly filled ring
    (8, 64, 4, 32, 0, 32, 6),          # the cursor at the wrap, full ring
    (8, 64, 4, 64, 37, 64, 6),         # gate_r3, steady chunk
    (13, 64, 4, 32, 31, 5, 11),        # Tq 13
    (1, 64, 4, 32, 3, 0, 1),           # one row, empty ring
    (8, 1024, 8, 256, 100, 256, 6),    # full width, steady chunk
])
def test_replay_of_the_kernels_split_matches_plain(tq, d, h, c, cursor, cache_len, valid_tq,
                                                   kv):
    args = port_args(inputs(tq + d + cursor, tq, d, h, c, kv))
    meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32)
    got = replay(*args[:3], list(args[3:7]), *args[7:], meta, h,
                 att_block_bf16_plan(tq, d, h, c, H100_SMS))
    compare(got, att_block_plain(*args, meta, n_heads=h), valid_tq)


def test_replay_sees_the_rounding_points():
    """The tolerance tells the replay from the plain version without the
    bf16 rounding points (on the bf16 weights widened to f32)."""
    args = port_args(inputs(3, 8, 64, 4, 32, "f32"))
    meta = torch.tensor([7, 19, 6], dtype=torch.int32)
    got = replay(*args[:3], list(args[3:7]), *args[7:], meta, 4,
                 att_block_bf16_plan(8, 64, 4, 32, H100_SMS))
    unrounded = att_block_plain(*args[:3], *[w.float() for w in args[3:7]], *args[7:], meta,
                                n_heads=4)
    assert float((got[0] - unrounded[0])[:6].abs().max()) > TOL


@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("cursor,cache_len,valid_tq", [(7, 19, 6), (31, 32, 1)])
def test_replay_matches_pallas_interpret(cursor, cache_len, valid_tq, kv):
    """ModelConfig.tiny()'s widths (D 64, H 4, C 32, Tq 8) with bf16 weights
    and biases over an f32 or a bf16 kv cache, as the JAX encoder runs the
    TPU kernel for the weights of ``cast_params_for_compute`` (``g_sel`` in
    bf16)."""
    tq, d, h, c = 8, 64, 4, 32
    inp = inputs(5 + cursor, tq, d, h, c, kv)
    kv_j = jnp.bfloat16 if kv == "bf16" else jnp.float32
    posT = jnp.zeros((d, 128)).at[:, :inp["pos"].shape[0]].set(inp["pos"].T)
    g_sel, mask = build_rel_selection(jnp.int32(cursor), jnp.int32(cache_len), c, tq,
                                      jnp.int32(valid_tq), 128, 128, dtype=jnp.bfloat16)
    want = att_block_pallas(jnp.asarray(inp["x"]), inp["ln_g"], inp["ln_b"],
                            *[jnp.asarray(w).astype(jnp.bfloat16) for w in inp["ws"]],
                            jnp.asarray(inp["bu"]).astype(jnp.bfloat16),
                            jnp.asarray(inp["bv"]).astype(jnp.bfloat16), posT,
                            jnp.asarray(inp["kv"]).astype(kv_j), g_sel, mask, n_heads=h,
                            interpret=True)
    args = port_args(inp)
    meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32)
    got = replay(*args[:3], list(args[3:7]), *args[7:], meta, h,
                 att_block_bf16_plan(tq, d, h, c, H100_SMS))
    compare(got, want, valid_tq)


def test_wrapper_ignores_packed_weights_on_cpu():
    args = port_args(inputs(4, 8, 64, 4, 32, "bf16"))
    meta = torch.tensor([3, 10, 6], dtype=torch.int32)
    before = att_block.launches
    got = att_block(*args, meta, n_heads=4, packed=pack_att_block(*args[3:7], sms=H100_SMS))
    for g, w in zip(got, att_block_plain(*args, meta, n_heads=4)):
        assert torch.equal(g, w)
    assert att_block.launches == before            # no kernel launch on the CPU
