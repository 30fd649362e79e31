"""Launch plan, weight packing and work split of the int8 conv-module kernel
of the PyTorch port (``ops/kernels/conv_block.py``; ``csrc/conv_block_q8.cu``
runs the fused tail's phases (a)-(c) of ``csrc/conv_tail.cuh`` and checks
the same shared-memory layout at launch): one cooperative launch whose
blocks must all be resident, at most one an SM, block b owning a slice of
8 (a multiple of 8) columns of pw1 (with their GLU gates) and of pw2 over
the whole K, both int8 slices with their scales, the taps and BN
contiguous in a packed copy and whole in shared memory. A plain-torch
replay of the kernel's split, reading each block's constants out of the
packed copy as the kernel does (per pass of 8 rows: u = bf16(LN(x)); per
block, its GLU pairs of u @ pw1 times s1, GLU, mask, c; per block, the
taps, BN and SiLU on its columns, a rounded to bf16; after the barrier,
per block, its columns of y = x + (a @ pw2) * s2), is held to
``conv_block_plain`` at 1e-5, the exactness ``tests/test_torch_conv_block.py``
states (both round the same operands to bf16 and multiply exact
integers), and to the JAX package's ``conv_block_pallas`` in interpret mode
at ``ModelConfig.tiny()``'s width. The kernel itself is held against its
plain version on the card (``test_torch_kernels_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import conv_module_args as torch_args
from torch_port_helpers import conv_module_inputs as inputs
from torch_port_helpers import padded

from trt_asr_tpu.ops.pallas.conv_block_kernel import conv_block_pallas
from trt_asr_tpu.ops.quant import quantize_tensor as j_quantize
from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import conv_block as cb
from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_block_plain,
                                                      conv_block_q8_plan, pack_conv_block)
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK, pad_k
from trt_asr_tpu_torch.ops.quant import QuantTensor, quantize_tensor, round_bf16

H100_SMS = 132
KK = 9
TOL = 1e-5
# (Tq, valid steps, D): rows 1, 6, 8 (a steady chunk, 6 valid) and 13 (two
# passes of 8 rows); D 64 (ModelConfig.tiny(), gate_r3) and 96
SHAPES = [(tq, valid, d) for tq, valid in ((1, 1), (6, 6), (8, 6), (13, 11)) for d in (64, 96)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 8 columns on the H100's 132 SMs, each with its whole
    int8 slices (16 KB of pw1's GLU pairs, 8 KB of pw2) in shared memory."""
    plan = conv_block_q8_plan(8, 1024, KK, H100_SMS)
    assert (plan.blocks, plan.cols_d, plan.cols_e) == (128, 8, 0)
    weights = 1024 * 2 * 8 + 1024 * 8               # pw1 (GLU pairs), pw2: int8
    rows = 8 * (1024 + 16) * 2 + 8 * 1024 * 4       # operand rows (bf16), x's rows (f32)
    norms = 2 * 1024 * 4
    columns = (3 * 8 + (KK + 4) * 8) * 4 + 8 * 4    # scales, taps, BN; mask
    conv = (8 + KK - 1) * 8 * 4                     # conv rows
    sums = 16 * 16 * 8 * 4                          # per-warp sums
    bars = 11 * 8                                   # mbarriers
    assert plan.smem == weights + rows + norms + columns + conv + sums + bars == 91_512
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 8 * 1024 * 2             # a, bf16


@pytest.mark.parametrize("tq,d,sms", [(8, 1024, H100_SMS), (8, 64, H100_SMS), (13, 96, H100_SMS),
                                      (1, 64, 3), (8, 1000, H100_SMS), (300, 1024, H100_SMS),
                                      (8, 512, 32)])
def test_plan_covers_every_column_once(tq, d, sms):
    plan = conv_block_q8_plan(tq, d, KK, sms)
    assert plan.cols_d % 8 == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_d < d <= plan.blocks * plan.cols_d
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tq,d,sms,match", [
    (8, 60, H100_SMS, "a multiple of 8"),          # D
    (8, 1020, H100_SMS, "a multiple of 8"),
    (0, 64, H100_SMS, "Tq >= 1"),
    (8, 8192, H100_SMS, "exceeds"),                 # x's rows alone are 256 KB
    (6000, 1024, H100_SMS, "exceeds"),              # the conv's rows
    (8, 1024, 8, "exceeds"),                        # a card of 8 SMs: 128 columns a block
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, sms, match):
    with pytest.raises(ValueError, match=match):
        conv_block_q8_plan(tq, d, KK, sms)


def quantized(inp):
    return tuple(quantize_tensor(torch.as_tensor(inp[k])) for k in ("pw1", "pw2"))


def unpack_block(blob, d, kk, cd):
    """Block b's constants back from its packed slice (``tail_blob`` with E
    = 0): pw1's GLU pairs [Dp, 2 cD] (the columns n, then their gates n +
    D), pw2 [Dp, cD] (int8, each group [Dp / 16][8][16]), then f32 s1 [2
    cD], s2 [cD], the taps [kk, cD] and BN [4, cD]."""
    dp = pad_k(d)

    def groups(raw, cols):
        q = raw.contiguous().view(torch.int8).reshape(cols // 8, dp // 16, 8, 16)
        return q.permute(1, 3, 0, 2).reshape(dp, cols)

    w1 = groups(blob[:dp * 2 * cd], 2 * cd)
    w2 = groups(blob[dp * 2 * cd:dp * 3 * cd], cd)
    f = blob[dp * 3 * cd:].contiguous().view(torch.float32)
    assert f.numel() == (7 + kk) * cd
    return (w1, w2, f[:2 * cd], f[2 * cd:3 * cd], f[3 * cd:3 * cd + kk * cd].reshape(kk, cd),
            f[3 * cd + kk * cd:].reshape(4, cd))


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, H100_SMS), (64, 3), (1024, H100_SMS)])
def test_packed_layout_unpacks_slice_for_slice(d, sms):
    inp = inputs(d + sms, 8, 6, d)
    q1, q2 = quantized(inp)
    dw, bn = torch.as_tensor(inp["dw"]), [torch.as_tensor(v) for v in inp["bn"]]
    packed = pack_conv_block(q1, dw, *bn, q2, sms=sms)
    plan = conv_block_q8_plan(1, d, KK, sms)
    cd, nb = plan.cols_d, plan.blocks
    assert packed.dtype == torch.uint8
    assert packed.shape == (nb, pad_k(d) * 3 * cd + (7 + KK) * cd * 4)
    w = nb * cd
    want_q1 = padded(q1.q[:, :d], w), padded(q1.q[:, d:], w)
    want_s1 = padded(q1.s.reshape(1, -1)[:, :d], w), padded(q1.s.reshape(1, -1)[:, d:], w)
    for b in range(nb):
        cols = slice(b * cd, (b + 1) * cd)
        w1, w2, s1, s2, taps, bnb = unpack_block(packed[b], d, KK, cd)
        assert not w1[d:].any() and not w2[d:].any()                # zero past K
        assert torch.equal(w1[:d, :cd], want_q1[0][:, cols])
        assert torch.equal(w1[:d, cd:], want_q1[1][:, cols])
        assert torch.equal(w2[:d], padded(q2.q, w)[:, cols])
        assert torch.equal(s1, torch.cat([want_s1[0][0, cols], want_s1[1][0, cols]]))
        assert torch.equal(s2, padded(q2.s.reshape(1, -1), w)[0, cols])
        assert torch.equal(taps, padded(dw, w)[:, cols])
        assert torch.equal(bnb, padded(torch.stack(bn), w)[:, cols])
    for tq in (1, 8, 13):                       # one copy serves every Tq
        cb.check_packed_conv(packed, conv_block_q8_plan(tq, d, KK, sms), d, KK, "int8")


@pytest.mark.parametrize("change", ["other_card", "f32_layout", "tail_layout", "dropped_block",
                                    "other_taps", "int8_view"])
def test_check_packed_conv_refuses_another_layout(change):
    d = 96
    inp = inputs(7, 8, 6, d)
    q1, q2 = quantized(inp)
    dw, bn = torch.as_tensor(inp["dw"]), [torch.as_tensor(v) for v in inp["bn"]]
    packed = pack_conv_block(q1, dw, *bn, q2, sms=H100_SMS)
    plan, kk = conv_block_q8_plan(8, d, KK, H100_SMS), KK
    if change == "other_card":
        packed = pack_conv_block(q1, dw, *bn, q2, sms=4)
    elif change == "f32_layout":
        packed = pack_conv_block(q1.q.float() * q1.s, dw, *bn, q2.q.float() * q2.s, sms=H100_SMS)
    elif change == "tail_layout":
        rng = np.random.default_rng(8)
        w1, w2 = (quantize_tensor(torch.as_tensor(rng.standard_normal(s).astype(np.float32)))
                  for s in ((d, 2 * d), (2 * d, d)))
        packed = cb.pack_conv_ffn_ln(q1, dw, *bn, q2, w1, w2, sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    elif change == "other_taps":
        kk = KK - 2
    else:
        packed = packed.view(torch.int8)
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        cb.check_packed_conv(packed, plan, d, kk, "int8")


def test_pack_conv_block_takes_int8_or_f32_weights_only():
    """Each storage type packs into its own layout (int8 and bf16 uint8 of
    their own widths, f32 f32); weights of two storage types raise."""
    inp = inputs(3, 8, 6, 64)
    pw1, pw2 = torch.as_tensor(inp["pw1"]), torch.as_tensor(inp["pw2"])
    consts = (torch.as_tensor(inp["dw"]), *[torch.as_tensor(v) for v in inp["bn"]])
    q8 = pack_conv_block(quantize_tensor(pw1), *consts, quantize_tensor(pw2), sms=H100_SMS)
    b16 = pack_conv_block(pw1.bfloat16(), *consts, pw2.bfloat16(), sms=H100_SMS)
    assert q8.dtype == b16.dtype == torch.uint8 and q8.shape != b16.shape
    cb.check_packed_conv(b16, cb.conv_block_bf16_plan(8, 64, KK, H100_SMS), 64, KK, "bf16")
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        cb.check_packed_conv(b16, conv_block_q8_plan(8, 64, KK, H100_SMS), 64, KK, "int8")
    assert pack_conv_block(pw1, *consts, pw2, sms=H100_SMS).dtype == torch.float32
    with pytest.raises(ValueError, match="one storage type"):
        pack_conv_block(pw1, *consts, quantize_tensor(pw2), sms=H100_SMS)
    with pytest.raises(ValueError, match="one storage type"):
        pack_conv_block(pw1.bfloat16(), *consts, pw2, sms=H100_SMS)


def replay(x, g, b, tc, mask, packed, plan, kk=KK, rounded=True):
    """The int8 kernel's work split in plain torch, reading each block's
    constants out of its packed slice: per pass of 8 rows, (a) u =
    bf16(LN(x)); (b) per block, its GLU pairs of u @ pw1 times s1, GLU,
    mask: its columns of c; per block, the taps over [time cache ++ c ++
    0], BN, SiLU, rounded to bf16: its columns of a; (c) after the barrier,
    per block, its columns of y = x + (a @ pw2) * s2. ``rounded=False``
    skips the two bf16 rounding points."""
    rnd = round_bf16 if rounded else (lambda t: t)
    tq, d = x.shape
    cd, nb, half = plan.cols_d, plan.blocks, (kk - 1) // 2
    consts = [unpack_block(packed[i], d, kk, cd) for i in range(nb)]
    w = nb * cd
    xw, tcw = padded(x, w), padded(tc, w)
    c, a, y = (x.new_zeros((tq, w)) for _ in range(3))
    for m0 in range(0, tq, 8):
        u = rnd(layer_norm_plain(x[m0:m0 + 8], g, b))
        for blk, (w1, _, s1, _, _, _) in enumerate(consts):
            hw = (u @ w1[:d].float()) * s1
            c[m0:m0 + 8, blk * cd:(blk + 1) * cd] = (
                hw[:, :cd] * torch.sigmoid(hw[:, cd:]) * mask[m0:m0 + 8])
    for blk, (_, _, _, _, taps, bnb) in enumerate(consts):
        cols = slice(blk * cd, (blk + 1) * cd)
        ext = torch.cat([tcw[:, cols], c[:, cols], x.new_zeros((half, cd))])
        cv = ext[0:tq] * taps[0]
        for j in range(1, kk):
            cv = cv + ext[j:j + tq] * taps[j]
        cv = (cv - bnb[2]) * (bnb[0] * torch.rsqrt(bnb[3] + 1e-5)) + bnb[1]
        a[:, cols] = rnd(silu(cv))
    for m0 in range(0, tq, 8):
        for blk, (_, w2, _, s2, _, _) in enumerate(consts):
            cols = slice(blk * cd, (blk + 1) * cd)
            y[m0:m0 + 8, cols] = xw[m0:m0 + 8, cols] + (a[m0:m0 + 8, :d] @ w2[:d].float()) * s2
    return y[:, :d], c[:, :d]


def packed_for(inp, q1, q2, sms=H100_SMS):
    return pack_conv_block(q1, torch.as_tensor(inp["dw"]),
                           *[torch.as_tensor(v) for v in inp["bn"]], q2, sms=sms)


@pytest.mark.parametrize("tq,valid,d", SHAPES + [(13, 11, 1024)])
def test_replay_of_the_kernels_split_matches_plain(tq, valid, d):
    inp = inputs(tq * 100 + d, tq, valid, d)
    q1, q2 = quantized(inp)
    args = torch_args(inp, q1, q2)
    got = replay(args[0], args[1], args[2], args[10], args[11], packed_for(inp, q1, q2),
                 conv_block_q8_plan(tq, d, KK, H100_SMS))
    for g, w in zip(got, conv_block_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert float(got[1][valid:].abs().sum()) == 0.0             # padded steps: c = 0


def test_replay_with_ragged_slices_matches_plain():
    """D 64 on 3 SMs: 3 blocks of 24 columns, the last one 8 past D."""
    inp = inputs(11, 8, 6, 64)
    q1, q2 = quantized(inp)
    args = torch_args(inp, q1, q2)
    got = replay(args[0], args[1], args[2], args[10], args[11], packed_for(inp, q1, q2, sms=3),
                 conv_block_q8_plan(8, 64, KK, 3))
    for g, w in zip(got, conv_block_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def test_replay_sees_the_rounding_points():
    """The tolerance tells the replay from one without the bf16 rounding
    points."""
    inp = inputs(5, 8, 6, 64)
    q1, q2 = quantized(inp)
    args = torch_args(inp, q1, q2)
    plan, packed = conv_block_q8_plan(8, 64, KK, H100_SMS), packed_for(inp, q1, q2)
    got = replay(args[0], args[1], args[2], args[10], args[11], packed, plan)
    unrounded = replay(args[0], args[1], args[2], args[10], args[11], packed, plan,
                       rounded=False)
    assert max(float((g - u).abs().max()) for g, u in zip(got, unrounded)) > 10 * TOL


@pytest.mark.parametrize("tq,valid", [(1, 1), (6, 6), (8, 6), (13, 11)])
def test_replay_matches_pallas_interpret(tq, valid):
    """ModelConfig.tiny()'s width (D 64), one quantization shared by both
    sides."""
    inp = inputs(tq, tq, valid, 64)
    jw = [j_quantize(jnp.asarray(inp[k])) for k in ("pw1", "pw2")]
    want = conv_block_pallas(jnp.asarray(inp["x"]), inp["g"], inp["b"], jw[0], inp["dw"],
                             *inp["bn"], jw[1], jnp.asarray(inp["tc"]), jnp.asarray(inp["mask"]),
                             interpret=True)
    q1, q2 = (QuantTensor(torch.as_tensor(np.array(q.q)), torch.as_tensor(np.array(q.s)))
              for q in jw)
    args = torch_args(inp, q1, q2)
    got = replay(args[0], args[1], args[2], args[10], args[11], packed_for(inp, q1, q2),
                 conv_block_q8_plan(tq, 64, KK, H100_SMS))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_wrapper_ignores_packed_weights_on_cpu():
    inp = inputs(6, 8, 6, 64)
    q1, q2 = quantized(inp)
    args = torch_args(inp, q1, q2)
    before = conv_block.launches
    got = conv_block(*args, packed=packed_for(inp, q1, q2))
    for g, w in zip(got, conv_block_plain(*args)):
        assert torch.equal(g, w)
    assert conv_block.launches == before            # no kernel launch on the CPU


@pytest.mark.parametrize("quant", ["none", "all"])
def test_layer_params_pack_each_conv_the_kernel_runs(monkeypatch, quant):
    """With the conv flag a model packs the conv module of a layer whose
    conv weights are on the card (int8 or f32), except where the fused
    int8 tail takes it (with the FFN flag too); each copy is the one
    ``pack_conv_block`` makes. The card stands in for the CPU here: the
    weights count as on the card and the plan takes the H100's SMs."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    monkeypatch.setattr(encoder, "_persistent_weights", lambda ws: True)
    monkeypatch.setattr(cb, "sm_count", lambda index: H100_SMS)
    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0)
    if quant != "none":
        params = quantize_params(params, quant)
    names = ("conv_pw1", "conv_dw", "conv_bn_g", "conv_bn_b", "conv_bn_m", "conv_bn_v",
             "conv_pw2")
    for tail in (False, True):
        layers = encoder.layer_params(params, cfg.num_layers, pack_tail=tail, pack_conv=True)
        takes_conv = tail and quant != "none"          # the fused int8 tail runs the conv
        for lp in layers:
            assert ("conv_block_packed" in lp) == (not takes_conv)
            if not takes_conv:
                want = pack_conv_block(*[lp[k] for k in names], sms=H100_SMS)
                assert lp["conv_block_packed"].dtype == (torch.uint8 if quant == "all"
                                                         else torch.float32)
                assert torch.equal(lp["conv_block_packed"], want)
        assert not any("conv_block_packed" in lp
                       for lp in encoder.layer_params(params, cfg.num_layers, pack_tail=tail))


def test_layer_params_pack_the_conv_on_the_card_only():
    """On CPU tensors the wrapper runs its plain version, so nothing is
    packed, whatever the weights' type; the card tests hold the packed
    copies of a model's layers."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
    from trt_asr_tpu_torch.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    cfg = ModelConfig.tiny()
    for params in (init_params(cfg, seed=0), quantize_params(init_params(cfg, seed=0), "all")):
        plain = layer_params(params, cfg.num_layers)
        packed = layer_params(params, cfg.num_layers, pack_conv=True, pack_ffn=True)
        assert [sorted(lp) for lp in packed] == [sorted(lp) for lp in plain]
