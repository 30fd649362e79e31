"""Launch plan, weight packing and work split of the f32 FFN kernel of the
PyTorch port (``ops/kernels/ffn.py``; ``csrc/ffn_f32.cu`` checks the same
shared-memory layout at launch): one cooperative launch whose blocks must
all be resident, at most one an SM, block b owning a slice of 32 (a
multiple of 32) expansion columns, whose f32 W1 columns and W2 rows stream
through a ring of slots of shared memory in pieces of 64 rows of K (W1) or
64 columns of D (W2), from a packed copy in which the slice is contiguous
in the ring's order. A plain-torch replay of the kernel's split (per pass
of 8 rows: the W1 pieces summed one by one and added in order, SiLU, each
block's partial h_b @ W2[slice, :], the partials added in a fixed order) is
held to ``fused_ffn_plain`` at 1e-5 (with f32 weights nothing is rounded,
so only the summation order differs) and to the JAX package's
``fused_ffn_pallas`` in interpret mode at ``ModelConfig.tiny()``'s widths.
The kernel itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trt_asr_tpu.ops.pallas.ffn_kernel import fused_ffn_pallas
from trt_asr_tpu_torch.ops.kernels import ffn as kf
from trt_asr_tpu_torch.ops.kernels.ffn import (FFN_RUN, FFN_SLICE, FFN_SUM_RUN, ffn_f32_plan,
                                               fused_ffn, fused_ffn_plain, layer_norm_plain,
                                               pack_ffn)
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.quant import quantize_tensor

H100_SMS = 132
TOL = 1e-5
# (M, D, E): rows 1, 6, 8 (a steady chunk) and 13 (two passes of 8 rows);
# D 64 (ModelConfig.tiny(), gate_r3) and 96 (a last piece of 32); E 128 and
# 200 (a ragged last slice)
SHAPES = [(m, d, e) for m in (1, 6, 8, 13) for d in (64, 96) for e in (128, 200)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 32 expansion columns on the H100's 132 SMs; of the 32
    pieces of 8 KB (16 of W1, 16 of W2) 22 fit the ring beside the staging,
    so the first 22 are in flight at entry and the rest follow as the W1
    pieces are summed."""
    plan = ffn_f32_plan(1024, 4096, H100_SMS)
    assert (plan.blocks, plan.cols_e, plan.cols_d, plan.stages) == (128, 32, 8, 22)
    ring = 22 * 64 * 32 * 4                         # the weights' slots (8 KB a piece)
    rows = 8 * 1024 * 4                             # x's rows, then u's
    h = 8 * 32 * 4                                  # h's rows
    xc = 8 * 8 * 4                                  # x on the block's 8 columns of y
    sums = 16 * 8 * 32 * 4                          # the W1 pieces' sums (LN's norms before)
    bars = (32 + 1) * 8                             # mbarriers: a piece each, x
    assert plan.smem == ring + rows + h + xc + sums + bars == 230_920
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 2 * 128 * 8 * 1024 * 4   # two buffers of the blocks' [8, D] partials
    assert 128 * 8 * 8 * 4 <= ring                  # the ring stages a block's 128 partials


@pytest.mark.parametrize("d,e,sms", [(1024, 4096, H100_SMS), (64, 128, H100_SMS),
                                     (96, 200, H100_SMS), (64, 200, 3), (1024, 4096, 66),
                                     (96, 8, H100_SMS)])
def test_plan_covers_every_column_once(d, e, sms):
    plan = ffn_f32_plan(d, e, sms)
    assert plan.cols_e % FFN_SLICE == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_e < e <= plan.blocks * plan.cols_e
    assert plan.cols_d % 4 == 0 and plan.blocks * plan.cols_d >= d
    assert 1 <= plan.stages <= 2 * -(-d // FFN_RUN)
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("d,e,sms,stages,match", [
    (1020, 4096, H100_SMS, None, "a multiple of 8"),    # D
    (64, 0, H100_SMS, None, "E >= 1"),
    (1024, 4096, H100_SMS, 0, "ring slots"),            # no slot
    (64, 128, H100_SMS, 3, "ring slots"),               # more slots than pieces
    (1024, 4096, H100_SMS, 28, "exceeds"),              # 28 slots of 8 KB
    (4096, 4096, H100_SMS, None, "exceeds"),            # D 4096: x's rows alone are 128 KB
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(d, e, sms, stages, match):
    with pytest.raises(ValueError, match=match):
        ffn_f32_plan(d, e, sms, stages=stages)


def weights(seed, d, e):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor((rng.standard_normal((d, e)) * d ** -0.5).astype(np.float32)),
            torch.as_tensor((rng.standard_normal((e, d)) * e ** -0.5).astype(np.float32)))


def unpack(packed, d, e, plan):
    """W1 and W2 back from the packed layout (block b: the W1 pieces [runs]
    [16][cE][4], then the W2 pieces [runs][cE / 4][64][4])."""
    runs, ce, blocks = -(-d // FFN_RUN), plan.cols_e, plan.blocks
    n1 = runs * FFN_RUN * ce
    a = packed[:, :n1].view(blocks, runs, FFN_RUN // 4, ce, 4)
    a = a.permute(1, 2, 4, 0, 3).reshape(runs * FFN_RUN, blocks * ce)
    b = packed[:, n1:].view(blocks, runs, ce // 4, FFN_RUN, 4)
    b = b.permute(0, 2, 4, 1, 3).reshape(blocks * ce, runs * FFN_RUN)
    assert not a[d:].any() and not a[:, e:].any()      # zero past D and E
    assert not b[e:].any() and not b[:, d:].any()
    return a[:d, :e], b[:e, :d]


@pytest.mark.parametrize("d,e,sms", [(64, 128, H100_SMS), (96, 200, H100_SMS), (96, 200, 3),
                                     (1024, 4096, H100_SMS)])
def test_packed_layout_unpacks_to_the_two_matrices(d, e, sms):
    w1, w2 = weights(d + e, d, e)
    packed = pack_ffn(w1, w2, sms=sms)
    plan = ffn_f32_plan(d, e, sms)
    assert packed.dtype == torch.float32
    assert packed.shape == (plan.blocks, 2 * -(-d // FFN_RUN) * FFN_RUN * plan.cols_e)
    got1, got2 = unpack(packed, d, e, plan)
    assert torch.equal(got1, w1) and torch.equal(got2, w2)
    kf.check_packed_ffn(packed, plan, d, e)


@pytest.mark.parametrize("change", ["other_card", "int8_layout", "dropped_block", "other_width"])
def test_check_packed_ffn_refuses_another_layout(change):
    d, e = 96, 200
    w1, w2 = weights(7, d, e)
    packed = pack_ffn(w1, w2, sms=H100_SMS)
    plan = ffn_f32_plan(d, e, H100_SMS)
    if change == "other_card":
        packed = pack_ffn(w1, w2, sms=3)
    elif change == "int8_layout":
        packed = pack_ffn(quantize_tensor(w1), quantize_tensor(w2), sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        kf.check_packed_ffn(packed, plan, d, e)


def test_pack_ffn_takes_int8_or_f32_weights_only():
    """W1 and W2 of one type: int8 beside f32 raises. bf16 weights, which
    took the chain and were packed for nothing, now take their own
    persistent kernel and are packed in its layout
    (test_torch_ffn_bf16.py)."""
    w1, w2 = weights(3, 64, 128)
    packed = pack_ffn(w1.bfloat16(), w2.bfloat16(), sms=H100_SMS)
    assert packed.dtype == torch.bfloat16 and packed.shape == (4, 64 * 32 + 128 * 16)
    with pytest.raises(ValueError, match="one storage type"):
        pack_ffn(w1, quantize_tensor(w2), sms=H100_SMS)
    with pytest.raises(ValueError, match="one storage type"):
        pack_ffn(w1.bfloat16(), w2, sms=H100_SMS)


def add_in_runs(parts):
    """The blocks' partials added as the kernel adds them (``ff_reduce`` in
    ``csrc/ffn_f32.cu``): runs of FFN_SUM_RUN blocks, each in block order,
    then the runs' sums in order."""
    runs = [functools.reduce(torch.add, parts[q:q + FFN_SUM_RUN])
            for q in range(0, len(parts), FFN_SUM_RUN)]
    return functools.reduce(torch.add, runs)


def replay(x, g, b, w1, w2, plan, scale=0.5):
    """The f32 kernel's work split in plain torch, 8 rows a pass: (a) u =
    LN(x); (b) per block, h_b = silu of u times its W1 columns, the pieces
    of FFN_RUN rows of K summed one by one and added in order; (c) its
    partial h_b @ W2[slice, :]; (d) the partials added in runs of
    FFN_SUM_RUN blocks, each in block order, then the runs' sums in order:
    y = x + scale * sum."""
    m, d = x.shape
    e = w1.shape[1]
    ce = plan.cols_e
    y = torch.empty_like(x)
    for m0 in range(0, m, 8):
        rows = x[m0:m0 + 8]
        u = layer_norm_plain(rows, g, b)
        parts = []
        for blk in range(plan.blocks):
            cols = slice(blk * ce, min(e, (blk + 1) * ce))
            s = torch.zeros(rows.shape[0], cols.stop - cols.start)
            for k0 in range(0, d, FFN_RUN):
                s = s + u[:, k0:k0 + FFN_RUN] @ w1[k0:k0 + FFN_RUN, cols]
            parts.append(torch.nn.functional.silu(s) @ w2[cols])
        y[m0:m0 + 8] = rows + scale * add_in_runs(parts)
    return y


def inputs(seed, m, d, e):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return (r(m, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1), r(d, e, sc=d ** -0.5),
            r(e, d, sc=e ** -0.5))


@pytest.mark.parametrize("m,d,e", SHAPES)
def test_replay_of_the_kernels_split_matches_plain(m, d, e):
    args = [torch.as_tensor(a) for a in inputs(m * 1000 + d + e, m, d, e)]
    got = replay(*args, ffn_f32_plan(d, e, H100_SMS))
    torch.testing.assert_close(got, fused_ffn_plain(*args, 0.5), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("m", [1, 6, 8, 13])
def test_replay_matches_pallas_interpret(m):
    """ModelConfig.tiny()'s widths (D 64, E 128)."""
    x, g, b, w1, w2 = inputs(m, m, 64, 128)
    want = fused_ffn_pallas(jnp.asarray(x), g, b, jnp.asarray(w1), jnp.asarray(w2), scale=0.5,
                            interpret=True)
    got = replay(*[torch.as_tensor(a) for a in (x, g, b, w1, w2)], ffn_f32_plan(64, 128, 132))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_wrapper_ignores_packed_weights_on_cpu():
    args = [torch.as_tensor(a) for a in inputs(5, 8, 64, 128)]
    before = fused_ffn.launches
    got = fused_ffn(*args, 0.5, packed=pack_ffn(args[3], args[4], sms=H100_SMS))
    assert torch.equal(got, fused_ffn_plain(*args, 0.5))
    assert fused_ffn.launches == before            # no kernel launch on the CPU


def test_layer_params_pack_ffn_on_the_card_only():
    """On CPU tensors the wrapper runs its plain version, so nothing is
    packed, whatever the weights' type; the card tests hold the packed
    copies of a model's layers."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
    from trt_asr_tpu_torch.models.parakeet.params import init_params

    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0)
    plain = layer_params(params, cfg.num_layers)
    packed = layer_params(params, cfg.num_layers, pack_tail=True, pack_ffn=True)
    assert [sorted(lp) for lp in packed] == [sorted(lp) for lp in plain]
