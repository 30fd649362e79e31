"""Launch plan, weight packing and work split of the f32 conv-module kernel
of the PyTorch port (``ops/kernels/conv_block.py``; ``csrc/conv_block_f32.cu``
checks the same shared-memory layout at launch): one cooperative launch
whose blocks must all be resident, at most one an SM, block b owning a
slice of 8 (a multiple of 8) columns of pw1 (with their GLU gates) and of
pw2 over the whole K, its f32 slices whole in shared memory in pieces of
64 rows of K, copied from a packed copy in which the slice, its taps and
BN are contiguous. A plain-torch replay of the kernel's split, reading each
block's constants out of the packed copy as the kernel does (per pass of 8
rows: u = LN(x); per block, its GLU pairs of u @ pw1 summed a piece at a
time and added in order, GLU, mask, c; per block, the taps, BN and SiLU on
its columns; after the barrier, per block, its columns of a @ pw2, a piece
at a time, plus x), is held to ``conv_block_plain`` at 1e-5 (with f32
weights nothing is rounded, so only the summation order differs) and to the
JAX package's ``conv_block_pallas`` in interpret mode at
``ModelConfig.tiny()``'s width. The kernel itself is held against its plain
version on the card (``test_torch_kernels_cuda.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import conv_module_args as torch_args
from torch_port_helpers import conv_module_inputs as inputs
from torch_port_helpers import padded

from trt_asr_tpu.ops.pallas.conv_block_kernel import conv_block_pallas
from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import conv_block as cb
from trt_asr_tpu_torch.ops.kernels.conv_block import (CONV_RUN, conv_block, conv_block_f32_plan,
                                                      conv_block_plain, pack_conv_block)
from trt_asr_tpu_torch.ops.kernels.ffn import layer_norm_plain
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.quant import quantize_tensor

H100_SMS = 132
KK = 9
TOL = 1e-5
# (Tq, valid steps, D): rows 1, 6, 8 (a steady chunk, 6 valid) and 13 (two
# passes of 8 rows); D 64 (ModelConfig.tiny(), gate_r3; one piece of K) and
# 96 (a last piece of 32 rows, K padded to 128)
SHAPES = [(tq, valid, d) for tq, valid in ((1, 1), (6, 6), (8, 6), (13, 11)) for d in (64, 96)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 8 columns on the H100's 132 SMs, each with its whole f32
    slices (64 KB of pw1's GLU pairs, 32 KB of pw2, in 16 pieces each) in
    shared memory beside x's rows and a's."""
    plan = conv_block_f32_plan(8, 1024, KK, H100_SMS)
    assert (plan.blocks, plan.cols_d, plan.cols_e) == (128, 8, 0)
    weights = 1024 * 3 * 8 * 4 + (KK + 4) * 8 * 4   # pw1 (GLU pairs), pw2; taps, BN
    rows = 2 * 8 * 1024 * 4                         # x's rows (then u's), a's rows
    norms = 2 * 1024 * 4
    sums = 16 * 8 * 16 * 4                          # the pieces' sums
    cols = 8 * 8 * 4 + 8 * 4 + (8 + KK - 1) * 8 * 4   # x's columns, mask, conv rows
    bars = (3 * 16 + 1) * 8                         # mbarriers: pieces of pw1, pw2, a; x
    assert plan.smem == weights + rows + norms + sums + cols + bars == 181_832
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 8 * 1024 * 4             # a, f32


@pytest.mark.parametrize("tq,d,sms", [(8, 1024, H100_SMS), (8, 64, H100_SMS), (13, 96, H100_SMS),
                                      (1, 64, 3), (8, 1000, H100_SMS), (300, 1024, H100_SMS)])
def test_plan_covers_every_column_once(tq, d, sms):
    plan = conv_block_f32_plan(tq, d, KK, sms)
    assert plan.cols_d % 8 == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_d < d <= plan.blocks * plan.cols_d
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tq,d,sms,match", [
    (8, 60, H100_SMS, "a multiple of 8"),          # D
    (0, 64, H100_SMS, "Tq >= 1"),
    (8, 2048, H100_SMS, "exceeds"),                 # 16 columns a block: 192 KB of weights
    (2000, 1024, H100_SMS, "exceeds"),              # the conv's rows and x's columns
    (8, 1024, 66, "exceeds"),                       # a card of 66 SMs
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, sms, match):
    with pytest.raises(ValueError, match=match):
        conv_block_f32_plan(tq, d, KK, sms)


def unpack_block(blob, d, kk, cd):
    """Block b's constants back from its packed slice (``cf_blob``): the
    pw1 pieces [runs][16][2 cD][4] -> [Kp, 2 cD] (the columns n, then their
    gates n + D), the pw2 pieces [runs][16][cD][4] -> [Kp, cD], the taps
    [kk, cD] and BN [4, cD]."""
    runs = -(-d // CONV_RUN)
    n1, n2 = runs * CONV_RUN * 2 * cd, runs * CONV_RUN * cd

    def pieces(v, cols):
        return v.view(runs, CONV_RUN // 4, cols, 4).permute(0, 1, 3, 2).reshape(-1, cols)

    assert blob.numel() == n1 + n2 + (kk + 4) * cd
    rest = blob[n1 + n2:]
    return (pieces(blob[:n1], 2 * cd), pieces(blob[n1:n1 + n2], cd),
            rest[:kk * cd].view(kk, cd), rest[kk * cd:].view(4, cd))


def f32_inputs(seed, tq, valid, d):
    inp = inputs(seed, tq, valid, d)
    return inp, torch_args(inp, torch.as_tensor(inp["pw1"]), torch.as_tensor(inp["pw2"]))


@pytest.mark.parametrize("d,sms", [(64, H100_SMS), (96, H100_SMS), (64, 3), (1024, H100_SMS)])
def test_packed_layout_unpacks_slice_for_slice(d, sms):
    _, args = f32_inputs(d + sms, 8, 6, d)
    pw1, dw, bn, pw2 = args[3], args[4], args[5:9], args[9]
    packed = pack_conv_block(pw1, dw, *bn, pw2, sms=sms)
    plan = conv_block_f32_plan(1, d, KK, sms)
    cd, nb, kp = plan.cols_d, plan.blocks, -(-d // CONV_RUN) * CONV_RUN
    assert packed.dtype == torch.float32
    assert packed.shape == (nb, kp * 3 * cd + (KK + 4) * cd)
    w = nb * cd
    for b in range(nb):
        cols = slice(b * cd, (b + 1) * cd)
        w1, w2, taps, bnb = unpack_block(packed[b], d, KK, cd)
        assert not w1[d:].any() and not w2[d:].any()                # zero past K
        assert torch.equal(w1[:d, :cd], padded(pw1[:, :d], w)[:, cols])
        assert torch.equal(w1[:d, cd:], padded(pw1[:, d:], w)[:, cols])
        assert torch.equal(w2[:d], padded(pw2, w)[:, cols])
        assert torch.equal(taps, padded(dw, w)[:, cols])
        assert torch.equal(bnb, padded(torch.stack(bn), w)[:, cols])
    for tq in (1, 8, 13):                       # one copy serves every Tq
        cb.check_packed_conv(packed, conv_block_f32_plan(tq, d, KK, sms), d, KK, "f32")


@pytest.mark.parametrize("change", ["other_card", "int8_layout", "dropped_block", "other_taps",
                                    "other_width"])
def test_check_packed_conv_refuses_another_layout(change):
    d = 96
    _, args = f32_inputs(7, 8, 6, d)
    consts = args[3:10]
    packed = pack_conv_block(*consts, sms=H100_SMS)
    plan, kk = conv_block_f32_plan(8, d, KK, H100_SMS), KK
    if change == "other_card":
        packed = pack_conv_block(*consts, sms=4)
    elif change == "int8_layout":
        packed = pack_conv_block(quantize_tensor(consts[0]), *consts[1:6],
                                 quantize_tensor(consts[6]), sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    elif change == "other_taps":
        kk = KK - 2
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        cb.check_packed_conv(packed, plan, d, kk, "f32")


def in_order(parts):
    return functools.reduce(torch.add, parts)


def replay(x, g, b, tc, mask, packed, plan, kk=KK):
    """The f32 kernel's work split in plain torch, reading each block's
    constants out of its packed slice: per pass of 8 rows, (a) u = LN(x);
    (b) per block, its GLU pairs of u @ pw1, a piece of CONV_RUN rows of K
    at a time, the pieces' sums added in order, GLU, mask: its columns of c;
    per block, the taps over [time cache ++ c ++ 0], BN, SiLU: its columns
    of a; (c) after the barrier, per block, its columns of a @ pw2, a piece
    at a time, added in order, plus x."""
    tq, d = x.shape
    cd, nb, half = plan.cols_d, plan.blocks, (kk - 1) // 2
    consts = [unpack_block(packed[i], d, kk, cd) for i in range(nb)]
    runs = -(-d // CONV_RUN)
    w = nb * cd
    xw, tcw = padded(x, w), padded(tc, w)
    c, a, y = (x.new_zeros((tq, w)) for _ in range(3))

    def product(rows, wk):
        rows = padded(rows, runs * CONV_RUN)
        return in_order([rows[:, k0:k0 + CONV_RUN] @ wk[k0:k0 + CONV_RUN]
                         for k0 in range(0, runs * CONV_RUN, CONV_RUN)])

    for m0 in range(0, tq, 8):
        u = layer_norm_plain(x[m0:m0 + 8], g, b)
        for blk, (w1, _, _, _) in enumerate(consts):
            hw = product(u, w1)
            c[m0:m0 + 8, blk * cd:(blk + 1) * cd] = (
                hw[:, :cd] * torch.sigmoid(hw[:, cd:]) * mask[m0:m0 + 8])
    for blk, (_, _, taps, bnb) in enumerate(consts):
        cols = slice(blk * cd, (blk + 1) * cd)
        ext = torch.cat([tcw[:, cols], c[:, cols], x.new_zeros((half, cd))])
        cv = ext[0:tq] * taps[0]
        for j in range(1, kk):
            cv = cv + ext[j:j + tq] * taps[j]
        cv = (cv - bnb[2]) * (bnb[0] * torch.rsqrt(bnb[3] + 1e-5)) + bnb[1]
        a[:, cols] = silu(cv)
    for m0 in range(0, tq, 8):
        for blk, (_, w2, _, _) in enumerate(consts):
            cols = slice(blk * cd, (blk + 1) * cd)
            y[m0:m0 + 8, cols] = xw[m0:m0 + 8, cols] + product(a[m0:m0 + 8, :d], w2)
    return y[:, :d], c[:, :d]


@pytest.mark.parametrize("tq,valid,d", SHAPES + [(13, 11, 1024)])
def test_replay_of_the_kernels_split_matches_plain(tq, valid, d):
    _, args = f32_inputs(tq * 100 + d, tq, valid, d)
    got = replay(args[0], args[1], args[2], args[10], args[11],
                 pack_conv_block(*args[3:10], sms=H100_SMS),
                 conv_block_f32_plan(tq, d, KK, H100_SMS))
    for g, w in zip(got, conv_block_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    assert float(got[1][valid:].abs().sum()) == 0.0             # padded steps: c = 0


def test_replay_with_ragged_slices_matches_plain():
    """D 96 on 5 SMs: 4 blocks of 24 columns; K padded from 96 to 128."""
    _, args = f32_inputs(11, 8, 6, 96)
    got = replay(args[0], args[1], args[2], args[10], args[11],
                 pack_conv_block(*args[3:10], sms=5), conv_block_f32_plan(8, 96, KK, 5))
    for g, w in zip(got, conv_block_plain(*args)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("tq,valid", [(1, 1), (6, 6), (8, 6), (13, 11)])
def test_replay_matches_pallas_interpret(tq, valid):
    """ModelConfig.tiny()'s width (D 64)."""
    inp, args = f32_inputs(tq, tq, valid, 64)
    want = conv_block_pallas(jnp.asarray(inp["x"]), inp["g"], inp["b"], jnp.asarray(inp["pw1"]),
                             inp["dw"], *inp["bn"], jnp.asarray(inp["pw2"]),
                             jnp.asarray(inp["tc"]), jnp.asarray(inp["mask"]), interpret=True)
    got = replay(args[0], args[1], args[2], args[10], args[11],
                 pack_conv_block(*args[3:10], sms=H100_SMS),
                 conv_block_f32_plan(tq, 64, KK, H100_SMS))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)


def test_wrapper_ignores_packed_weights_on_cpu():
    _, args = f32_inputs(6, 8, 6, 64)
    before = conv_block.launches
    got = conv_block(*args, packed=pack_conv_block(*args[3:10], sms=H100_SMS))
    for g, w in zip(got, conv_block_plain(*args)):
        assert torch.equal(g, w)
    assert conv_block.launches == before            # no kernel launch on the CPU
