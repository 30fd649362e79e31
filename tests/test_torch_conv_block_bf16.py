"""Launch plan, weight packing and work split of the bf16 conv-module kernel
of the PyTorch port (``ops/kernels/conv_block.py``;
``csrc/conv_block_bf16.cu`` runs the fused tail's phases (a)-(c) of
``csrc/conv_tail.cuh`` on bf16 slices and checks the same shared-memory
layout at launch): one cooperative launch whose blocks must all be
resident, at most one an SM, block b owning a slice of 8 (a multiple of 8)
columns of pw1 (with their GLU gates) and of pw2 over the whole K, both
bf16 slices in the int8 kernel's [K/16][8][16] groups (no scales), the taps
and BN contiguous in a packed copy and whole in shared memory. A
plain-torch replay of the kernel's split, reading each block's constants
out of the packed copy as the kernel does (per pass of 8 rows: u =
bf16(LN(x)); per block, its GLU pairs of u @ pw1, GLU, mask, c; per block,
the taps over [time cache ++ c ++ 0] (f32 or bf16, widened exactly), BN and
SiLU on its columns, a rounded to bf16; after the barrier, per block, its
columns of y = x + a @ pw2; each product's K in runs of whole mma steps,
one run a warp, the runs added in warp order), is held to
``conv_block_plain`` and to the JAX package's ``conv_block_pallas`` in
interpret mode with bf16 weights at 1e-4: both sides round the same
operands to bf16 and sum exact bf16 products in f32, in other orders, so
they differ only where an f32 value one bit apart rounds a to a
neighbouring bf16 value. The kernel itself is held against its plain
version on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``
phase 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import conv_module_inputs as inputs
from torch_port_helpers import padded

from trt_asr_tpu.ops.pallas.conv_block_kernel import conv_block_pallas
from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import conv_block as cb
from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_block_bf16_plan,
                                                      conv_block_plain, conv_block_q8_plan,
                                                      pack_conv_block)
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK, pad_k
from trt_asr_tpu_torch.ops.quant import quantize_tensor, round_bf16

H100_SMS = 132
KK = 9
TOL = 1e-4
bf16 = torch.bfloat16
# (Tq, valid steps, D): rows 1, 8 (a steady chunk, 6 valid) and 13 (two
# passes of 8 rows); D 64 (ModelConfig.tiny(), gate_r3) and 96
SHAPES = [(tq, valid, d) for tq, valid in ((1, 1), (8, 6), (13, 11)) for d in (64, 96)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 8 columns on the H100's 132 SMs, each with its whole
    bf16 slices (32 KB of pw1's GLU pairs, 16 KB of pw2) in shared memory:
    the int8 plan's 91,512 B with twice the weight bytes and no scales,
    so one block an SM."""
    plan = conv_block_bf16_plan(8, 1024, KK, H100_SMS)
    assert (plan.blocks, plan.cols_d, plan.cols_e) == (128, 8, 0)
    weights = (1024 * 2 * 8 + 1024 * 8) * 2         # pw1 (GLU pairs), pw2: bf16
    rows = 8 * (1024 + 16) * 2 + 8 * 1024 * 4       # operand rows (bf16), x's rows (f32)
    norms = 2 * 1024 * 4
    columns = (KK + 4) * 8 * 4 + 8 * 4              # taps, BN; mask
    conv = (8 + KK - 1) * 8 * 4                     # conv rows
    sums = 16 * 16 * 8 * 4                          # per-warp sums
    bars = 11 * 8                                   # mbarriers
    assert plan.smem == weights + rows + norms + columns + conv + sums + bars == 115_992
    q8 = conv_block_q8_plan(8, 1024, KK, H100_SMS)
    assert plan.smem == q8.smem + (weights // 2) - 3 * 8 * 4 == 115_992
    # an SM's 228 KB hold one such block (1 KB more reserved a block), not two
    assert plan.smem <= SMEM_PER_BLOCK and 2 * (plan.smem + 1024) > 228 * 1024
    assert plan.scratch == q8.scratch == 8 * 1024 * 2           # a, bf16


@pytest.mark.parametrize("tq,d,sms", [(8, 1024, H100_SMS), (8, 64, H100_SMS), (13, 96, H100_SMS),
                                      (1, 64, 3), (8, 1000, H100_SMS), (300, 1024, H100_SMS),
                                      (8, 512, 64)])
def test_plan_covers_every_column_once(tq, d, sms):
    plan = conv_block_bf16_plan(tq, d, KK, sms)
    assert plan.cols_d % 8 == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_d < d <= plan.blocks * plan.cols_d
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tq,d,sms,match", [
    (8, 60, H100_SMS, "a multiple of 8"),          # D
    (0, 64, H100_SMS, "Tq >= 1"),
    (8, 2048, H100_SMS, "exceeds"),                 # 16 columns a block: 96 KB of bf16 slices
    (6000, 1024, H100_SMS, "exceeds"),              # the conv's rows
    (8, 1024, 32, "exceeds"),                       # a card of 32 SMs: 32 columns a block
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, sms, match):
    with pytest.raises(ValueError, match=match):
        conv_block_bf16_plan(tq, d, KK, sms)


def bf16_weights(inp):
    return tuple(torch.as_tensor(inp[k]).to(bf16) for k in ("pw1", "pw2"))


def port_args(inp, pw1, pw2, tc_dtype=torch.float32):
    """``conv_block``'s arguments: bf16 weights and taps (as
    ``cast_params_for_compute`` leaves them), the time cache f32 or bf16."""
    c = torch.as_tensor
    return (c(inp["x"]), c(inp["g"]), c(inp["b"]), pw1, c(inp["dw"]).to(bf16),
            *[c(v) for v in inp["bn"]], pw2, c(inp["tc"]).to(tc_dtype), c(inp["mask"]))


def packed_for(inp, sms=H100_SMS):
    pw1, pw2 = bf16_weights(inp)
    return pack_conv_block(pw1, torch.as_tensor(inp["dw"]).to(bf16),
                           *[torch.as_tensor(v) for v in inp["bn"]], pw2, sms=sms)


def unpack_block(blob, d, kk, cd):
    """Block b's constants back from its packed slice (``tail_blob`` with E
    = 0 and bf16 weights): pw1's GLU pairs [Dp, 2 cD] (the columns n, then
    their gates n + D), pw2 [Dp, cD] (bf16, each group [Dp / 16][8][16]),
    then f32 taps [kk, cD] and BN [4, cD]."""
    dp = pad_k(d)

    def groups(raw, cols):
        q = raw.contiguous().view(bf16).reshape(cols // 8, dp // 16, 8, 16)
        return q.permute(1, 3, 0, 2).reshape(dp, cols)

    w1 = groups(blob[:dp * 2 * cd * 2], 2 * cd)
    w2 = groups(blob[dp * 2 * cd * 2:dp * 3 * cd * 2], cd)
    f = blob[dp * 3 * cd * 2:].contiguous().view(torch.float32)
    assert f.numel() == (4 + kk) * cd
    return w1, w2, f[:kk * cd].reshape(kk, cd), f[kk * cd:].reshape(4, cd)


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, H100_SMS), (64, 3), (1024, H100_SMS)])
def test_packed_layout_unpacks_slice_for_slice(d, sms):
    inp = inputs(d + sms, 8, 6, d)
    pw1, pw2 = bf16_weights(inp)
    dw, bn = torch.as_tensor(inp["dw"]).to(bf16), [torch.as_tensor(v) for v in inp["bn"]]
    packed = pack_conv_block(pw1, dw, *bn, pw2, sms=sms)
    plan = conv_block_bf16_plan(1, d, KK, sms)
    cd, nb = plan.cols_d, plan.blocks
    assert packed.dtype == torch.uint8
    assert packed.shape == (nb, pad_k(d) * 3 * cd * 2 + (4 + KK) * cd * 4)
    w = nb * cd
    for b in range(nb):
        cols = slice(b * cd, (b + 1) * cd)
        w1, w2, taps, bnb = unpack_block(packed[b], d, KK, cd)
        assert not w1[d:].any() and not w2[d:].any()                # zero past K
        assert torch.equal(w1[:d, :cd], padded(pw1[:, :d], w)[:, cols])
        assert torch.equal(w1[:d, cd:], padded(pw1[:, d:], w)[:, cols])
        assert torch.equal(w2[:d], padded(pw2, w)[:, cols])
        assert torch.equal(taps, padded(dw.float(), w)[:, cols])
        assert torch.equal(bnb, padded(torch.stack(bn), w)[:, cols])
    for tq in (1, 8, 13):                       # one copy serves every Tq
        cb.check_packed_conv(packed, conv_block_bf16_plan(tq, d, KK, sms), d, KK, "bf16")


@pytest.mark.parametrize("change", ["other_card", "int8_layout", "f32_layout", "dropped_block",
                                    "other_taps", "int8_plan"])
def test_check_packed_conv_refuses_another_layout(change):
    d = 96
    inp = inputs(7, 8, 6, d)
    pw1, pw2 = bf16_weights(inp)
    dw, bn = torch.as_tensor(inp["dw"]), [torch.as_tensor(v) for v in inp["bn"]]
    packed = pack_conv_block(pw1, dw, *bn, pw2, sms=H100_SMS)
    plan, kk, kind = conv_block_bf16_plan(8, d, KK, H100_SMS), KK, "bf16"
    if change == "other_card":
        packed = pack_conv_block(pw1, dw, *bn, pw2, sms=4)
    elif change == "int8_layout":
        packed = pack_conv_block(quantize_tensor(pw1.float()), dw, *bn,
                                 quantize_tensor(pw2.float()), sms=H100_SMS)
    elif change == "f32_layout":
        packed = pack_conv_block(pw1.float(), dw, *bn, pw2.float(), sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    elif change == "other_taps":
        kk = KK - 2
    else:                                       # the bf16 copy read with the int8 layout
        plan, kind = conv_block_q8_plan(8, d, KK, H100_SMS), "int8"
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        cb.check_packed_conv(packed, plan, d, kk, kind)


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


def replay(x, g, b, tc, mask, packed, plan, kk=KK, rounded=True):
    """The bf16 kernel's work split in plain torch, reading each block's
    constants out of its packed slice: per pass of 8 rows, (a) u =
    bf16(LN(x)); (b) per block, its GLU pairs of u @ pw1, GLU, mask: its
    columns of c; per block, the taps over [time cache ++ c ++ 0] (the
    cache widened exactly), BN, SiLU, rounded to bf16: its columns of a;
    (c) after the barrier, per block, its columns of y = x + a @ pw2; the
    products by warp runs. ``rounded=False`` skips the two bf16 rounding
    points."""
    rnd = round_bf16 if rounded else (lambda t: t)
    tq, d = x.shape
    cd, nb, half = plan.cols_d, plan.blocks, (kk - 1) // 2
    consts = [unpack_block(packed[i], d, kk, cd) for i in range(nb)]
    w = nb * cd
    xw, tcw = padded(x, w), padded(tc.float(), w)
    c, a, y = (x.new_zeros((tq, w)) for _ in range(3))
    for m0 in range(0, tq, 8):
        u = rnd(layer_norm_plain(x[m0:m0 + 8], g, b))
        for blk, (w1, _, _, _) in enumerate(consts):
            hw = warp_runs(u, w1[:d])
            c[m0:m0 + 8, blk * cd:(blk + 1) * cd] = (
                hw[:, :cd] * torch.sigmoid(hw[:, cd:]) * mask[m0:m0 + 8])
    for blk, (_, _, taps, bnb) in enumerate(consts):
        cols = slice(blk * cd, (blk + 1) * cd)
        ext = torch.cat([tcw[:, cols], c[:, cols], x.new_zeros((half, cd))])
        cv = ext[0:tq] * taps[0]
        for j in range(1, kk):
            cv = cv + ext[j:j + tq] * taps[j]
        cv = (cv - bnb[2]) * (bnb[0] * torch.rsqrt(bnb[3] + 1e-5)) + bnb[1]
        a[:, cols] = rnd(silu(cv))
    for m0 in range(0, tq, 8):
        for blk, (_, w2, _, _) in enumerate(consts):
            cols = slice(blk * cd, (blk + 1) * cd)
            y[m0:m0 + 8, cols] = xw[m0:m0 + 8, cols] + warp_runs(a[m0:m0 + 8, :d], w2[:d])
    return y[:, :d], c[:, :d]


def replay_of(args, packed, plan, rounded=True):
    return replay(args[0], args[1], args[2], args[10], args[11], packed, plan, rounded=rounded)


@pytest.mark.parametrize("tc_dtype", [torch.float32, bf16], ids=["f32_cache", "bf16_cache"])
@pytest.mark.parametrize("tq,valid,d", SHAPES + [(13, 11, 1024)])
def test_replay_of_the_kernels_split_matches_plain(tq, valid, d, tc_dtype):
    inp = inputs(tq * 100 + d, tq, valid, d)
    args = port_args(inp, *bf16_weights(inp), tc_dtype)
    got = replay_of(args, packed_for(inp), conv_block_bf16_plan(tq, d, KK, H100_SMS))
    for g, w in zip(got, conv_block_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert float(got[1][valid:].abs().sum()) == 0.0             # padded steps: c = 0


def test_replay_with_ragged_slices_matches_plain():
    """D 64 on 3 SMs: 3 blocks of 24 columns, the last one 8 past D."""
    inp = inputs(11, 8, 6, 64)
    args = port_args(inp, *bf16_weights(inp))
    got = replay_of(args, packed_for(inp, sms=3), conv_block_bf16_plan(8, 64, KK, 3))
    for g, w in zip(got, conv_block_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_replay_sees_the_rounding_points():
    """The tolerance tells the replay from one without the bf16 rounding
    points."""
    inp = inputs(5, 8, 6, 64)
    args = port_args(inp, *bf16_weights(inp))
    plan, packed = conv_block_bf16_plan(8, 64, KK, H100_SMS), packed_for(inp)
    got = replay_of(args, packed, plan)
    unrounded = replay_of(args, packed, plan, rounded=False)
    assert max(float((g - u).abs().max()) for g, u in zip(got, unrounded)) > 10 * TOL


@pytest.mark.parametrize("tc_dtype", [torch.float32, bf16], ids=["f32_cache", "bf16_cache"])
@pytest.mark.parametrize("tq,valid", [(1, 1), (8, 6), (13, 11)])
def test_replay_matches_pallas_interpret(tq, valid, tc_dtype):
    """ModelConfig.tiny()'s width (D 64) with the bf16 weights and taps of
    ``cast_params_for_compute``, over an f32 and a bf16 time cache."""
    inp = inputs(tq, tq, valid, 64)
    jt = jnp.bfloat16 if tc_dtype == bf16 else jnp.float32
    want = conv_block_pallas(jnp.asarray(inp["x"]), inp["g"], inp["b"],
                             jnp.asarray(inp["pw1"]).astype(jnp.bfloat16),
                             jnp.asarray(inp["dw"]).astype(jnp.bfloat16), *inp["bn"],
                             jnp.asarray(inp["pw2"]).astype(jnp.bfloat16),
                             jnp.asarray(inp["tc"]).astype(jt), jnp.asarray(inp["mask"]),
                             interpret=True)
    args = port_args(inp, *bf16_weights(inp), tc_dtype)
    got = replay_of(args, packed_for(inp), conv_block_bf16_plan(tq, 64, KK, H100_SMS))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_wrapper_ignores_packed_weights_on_cpu():
    inp = inputs(6, 8, 6, 64)
    args = port_args(inp, *bf16_weights(inp), bf16)
    before = conv_block.launches
    got = conv_block(*args, packed=packed_for(inp))
    for g, w in zip(got, conv_block_plain(*args)):
        assert torch.equal(g, w)
    assert conv_block.launches == before            # no kernel launch on the CPU


def test_layer_params_pack_bf16_convs_on_the_card_only(monkeypatch):
    """The weights of ``cast_params_for_compute`` (bf16): on CPU tensors
    nothing is packed; on the card (stood in for here: the weights count as
    on the card and the plan takes the H100's SMs) each layer's conv module
    holds the copy ``pack_conv_block`` makes, with the FFN flag too (the
    fused tail is int8 only), and only with ``pack_conv``."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.models.parakeet.params import cast_params_for_compute, init_params

    cfg = ModelConfig.tiny()
    params = cast_params_for_compute(init_params(cfg, seed=0), bf16)
    on_cpu = encoder.layer_params(params, cfg.num_layers, pack_tail=True, pack_conv=True)
    assert not any(k.endswith("_packed") for lp in on_cpu for k in lp)
    monkeypatch.setattr(encoder, "_bf16_weights", lambda ws: True)
    monkeypatch.setattr(cb, "sm_count", lambda index: H100_SMS)
    names = ("conv_pw1", "conv_dw", "conv_bn_g", "conv_bn_b", "conv_bn_m", "conv_bn_v",
             "conv_pw2")
    for lp in encoder.layer_params(params, cfg.num_layers, pack_tail=True, pack_conv=True):
        assert lp["conv_pw1"].dtype == bf16
        assert torch.equal(lp["conv_block_packed"],
                           pack_conv_block(*[lp[k] for k in names], sms=H100_SMS))
    assert not any("conv_block_packed" in lp
                   for lp in encoder.layer_params(params, cfg.num_layers, pack_tail=True))
