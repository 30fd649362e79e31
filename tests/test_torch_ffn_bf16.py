"""Launch plan, weight packing and work split of the bf16 FFN kernel of the
PyTorch port (``ops/kernels/ffn.py``; ``csrc/ffn_bf16.cu`` checks the same
shared-memory layout at launch): one cooperative launch whose blocks must
all be resident, at most one an SM, block b owning a slice of 32 (a
multiple of 32) expansion columns of W1 and a slice of 8 (a multiple of 8)
columns of W2 over the whole expansion, both bf16 slices contiguous in a
packed copy and whole in shared memory (64 KB each at full width), x's
rows in the operand buffer of h's rows, past u's. A plain-torch replay of
the kernel's split (per pass of 8 rows: u = bf16(LN(x)); per block, its
columns of h = bf16(silu(u @ W1[:, slice])); after the barrier, per block,
its columns of y = x + scale * (h @ W2[:, slice]); each product's K in runs
of whole mma steps, one run a warp, the runs added in warp order) is held
to ``fused_ffn_plain`` and to the JAX package's ``fused_ffn_pallas`` in
interpret mode with bf16 weights at 1e-4: both sides round the same
operands to bf16 and sum exact bf16 products in f32, in other orders, so
they differ only where an f32 value one bit apart rounds h to a
neighbouring bf16 value, which moves y by a few 1e-5 at these widths. The
kernel itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trt_asr_tpu.ops.pallas.ffn_kernel import fused_ffn_pallas
from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import ffn as kf
from trt_asr_tpu_torch.ops.kernels.ffn import (FFN_SLICE, ffn_bf16_plan, fused_ffn,
                                               fused_ffn_plain, layer_norm_plain, pack_ffn)
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK, pad_k
from trt_asr_tpu_torch.ops.quant import quantize_tensor, round_bf16

H100_SMS = 132
TOL = 1e-4
bf16 = torch.bfloat16
# (M, D, E): rows 1, 8 (a steady chunk) and 13 (two passes of 8 rows); D 64
# (ModelConfig.tiny(), gate_r3) and 96; E 128 and 200 (a ragged last slice)
SHAPES = [(m, d, e) for m in (1, 8, 13) for d in (64, 96) for e in (128, 200)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 32 expansion columns and 8 columns of y on the H100's
    132 SMs, each with its whole bf16 slices (64 KB of W1, 64 KB of W2) in
    shared memory: x's rows lie in h's operand buffer past u's, so the
    block takes 221,496 B where a bf16 copy of the int8 kernel's layout
    would take 254,264 B."""
    plan = ffn_bf16_plan(1024, 4096, H100_SMS)
    assert (plan.blocks, plan.cols_e, plan.cols_d, plan.stages, plan.kind) == (128, 32, 8, 0,
                                                                               "bf16")
    blob = (1024 * 32 + 4096 * 8) * 2               # W1 and W2 slices, bf16
    rows = 8 * (4096 + 16) * 2                      # h's rows, bf16 (u's and x's before them)
    assert 8 * (1024 + 16) * 2 + 8 * 1024 * 4 <= rows
    norms = 2 * 1024 * 4
    sums = 16 * 32 * 8 * 4                          # W1's per-warp sums (W2's after them)
    bars = 7 * 8                                    # mbarriers: x, W1, W2, h's four chunks
    assert plan.smem == blob + rows + norms + sums + bars == 221_496
    assert plan.smem <= SMEM_PER_BLOCK < plan.smem + 8 * 1024 * 4
    assert plan.scratch == 2 * 8 * 4096 * 2         # two buffers of h, bf16


@pytest.mark.parametrize("d,e,sms", [(1024, 4096, H100_SMS), (64, 128, H100_SMS),
                                     (64, 256, H100_SMS), (96, 200, H100_SMS), (64, 200, 3)])
def test_plan_covers_every_column_once(d, e, sms):
    plan = ffn_bf16_plan(d, e, sms)
    assert plan.cols_e % FFN_SLICE == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_e < e <= plan.blocks * plan.cols_e
    assert plan.cols_d % 8 == 0 and plan.blocks * plan.cols_d >= d
    assert plan.smem <= SMEM_PER_BLOCK


def test_plan_keeps_x_past_u_in_hs_buffer():
    """Where h's rows are narrower than u's and x's together (E < 3 D), the
    operand buffer takes the larger."""
    d, e = 96, 128
    plan = ffn_bf16_plan(d, e, H100_SMS)
    u_and_x = 8 * (pad_k(d) + 16) * 2 + 8 * d * 4
    assert u_and_x > 8 * (pad_k(e) + 16) * 2
    blob = (pad_k(d) * plan.cols_e + pad_k(e) * plan.cols_d) * 2
    assert plan.smem == blob + u_and_x + 2 * d * 4 + 16 * max(plan.cols_e, plan.cols_d) * 8 * 4 + 56


@pytest.mark.parametrize("d,e,sms,match", [
    (100, 128, H100_SMS, "a multiple of 8"),            # D
    (64, 0, H100_SMS, "E >= 1"),
    (64, 100, H100_SMS, "E a multiple of 8"),           # h's rows are copied 16 bytes at a time
    (1024, 4096, 66, "exceeds"),                        # 64 expansion columns, 16 of y
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(d, e, sms, match):
    with pytest.raises(ValueError, match=match):
        ffn_bf16_plan(d, e, sms)


def inputs(seed, m, d, e):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return (r(m, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1), r(d, e, sc=d ** -0.5),
            r(e, d, sc=e ** -0.5))


def port_args(arrays):
    x, g, b, w1, w2 = (torch.as_tensor(a) for a in arrays)
    return x, g, b, w1.to(bf16), w2.to(bf16)


def unpack(packed, d, e, plan):
    """(W1, W2) back from the packed layout: block b's W1 columns [cE / 8][Dp
    / 16][8][16], then its W2 columns [cD / 8][Ep / 16][8][16]."""
    blocks, ce, cd, dp, ep = plan.blocks, plan.cols_e, plan.cols_d, pad_k(d), pad_k(e)

    def columns(q, k, cols):
        q = q.contiguous().reshape(blocks, cols // 8, k // 16, 8, 16)
        return q.permute(2, 4, 0, 1, 3).reshape(k, blocks * cols)

    a = columns(packed[:, :dp * ce], dp, ce)
    b = columns(packed[:, dp * ce:], ep, cd)
    assert not a[d:].any() and not a[:, e:].any()                   # zero past D and E
    assert not b[e:].any() and not b[:, d:].any()
    return a[:d, :e], b[:e, :d]


@pytest.mark.parametrize("d,e,sms", [(64, 128, H100_SMS), (96, 200, H100_SMS), (96, 200, 3),
                                     (1024, 4096, H100_SMS)])
def test_packed_layout_unpacks_slice_for_slice(d, e, sms):
    _, _, _, w1, w2 = port_args(inputs(d + e, 1, d, e))
    packed = pack_ffn(w1, w2, sms=sms)
    plan = ffn_bf16_plan(d, e, sms)
    assert packed.dtype == bf16
    assert packed.shape == (plan.blocks, pad_k(d) * plan.cols_e + pad_k(e) * plan.cols_d)
    a, b = unpack(packed, d, e, plan)
    assert torch.equal(a, w1) and torch.equal(b, w2)
    kf.check_packed_ffn(packed, plan, d, e)


@pytest.mark.parametrize("change", ["other_card", "int8_layout", "f32_layout", "dropped_block",
                                    "other_width"])
def test_check_packed_ffn_refuses_another_layout(change):
    d, e = 96, 200
    _, _, _, w1, w2 = port_args(inputs(7, 1, d, e))
    packed = pack_ffn(w1, w2, sms=H100_SMS)
    plan = ffn_bf16_plan(d, e, H100_SMS)
    if change == "other_card":
        packed = pack_ffn(w1, w2, sms=3)
    elif change == "int8_layout":
        packed = pack_ffn(quantize_tensor(w1.float()), quantize_tensor(w2.float()), sms=H100_SMS)
    elif change == "f32_layout":
        packed = pack_ffn(w1.float(), w2.float(), sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        kf.check_packed_ffn(packed, plan, d, e)


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


def replay(x, g, b, w1, w2, plan, scale=0.5):
    """The bf16 kernel's work split in plain torch, 8 rows a pass: (a) u =
    bf16(LN(x)); (b) per block, its columns of h = bf16(silu(u @ W1[:,
    slice])); (c) after the barrier, per block, its columns of y = x +
    scale * (h @ W2[:, slice]); the products by warp runs."""
    m, d = x.shape
    e = w1.shape[1]
    ce, cd = plan.cols_e, plan.cols_d
    y = torch.empty_like(x)
    for m0 in range(0, m, 8):
        rows = x[m0:m0 + 8]
        u = round_bf16(layer_norm_plain(rows, g, b))
        h = torch.cat([round_bf16(silu(warp_runs(u, w1[:, c0:c0 + ce])))
                       for c0 in range(0, e, ce)], dim=1)
        for n0 in range(0, d, cd):
            cols = slice(n0, n0 + cd)
            y[m0:m0 + 8, cols] = rows[:, cols] + scale * warp_runs(h, w2[:, cols])
    return y


@pytest.mark.parametrize("m,d,e", SHAPES + [(8, 1024, 4096)])
def test_replay_of_the_kernels_split_matches_plain(m, d, e):
    x, g, b, w1, w2 = port_args(inputs(m * 1000 + d + e, m, d, e))
    got = replay(x, g, b, w1, w2, ffn_bf16_plan(d, e, H100_SMS))
    torch.testing.assert_close(got, fused_ffn_plain(x, g, b, w1, w2, 0.5), atol=TOL, rtol=TOL)


def test_replay_sees_the_rounding_points():
    """The tolerance tells the replay from one without the bf16 rounding
    points (the plain version on the bf16 weights widened to f32)."""
    x, g, b, w1, w2 = port_args(inputs(5, 8, 64, 128))
    got = replay(x, g, b, w1, w2, ffn_bf16_plan(64, 128, H100_SMS))
    unrounded = fused_ffn_plain(x, g, b, w1.float(), w2.float(), 0.5)
    assert float((got - unrounded).abs().max()) > 10 * TOL


@pytest.mark.parametrize("m", [1, 8, 13])
def test_replay_matches_pallas_interpret(m):
    """ModelConfig.tiny()'s widths (D 64, E 128) with the bf16 weights of
    ``cast_params_for_compute`` (the LayerNorm's parameters f32)."""
    x, g, b, w1, w2 = inputs(m, m, 64, 128)
    want = fused_ffn_pallas(jnp.asarray(x), g, b, jnp.asarray(w1).astype(jnp.bfloat16),
                            jnp.asarray(w2).astype(jnp.bfloat16), scale=0.5, interpret=True)
    got = replay(*port_args((x, g, b, w1, w2)), ffn_bf16_plan(64, 128, H100_SMS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_wrapper_ignores_packed_weights_on_cpu():
    x, g, b, w1, w2 = port_args(inputs(6, 8, 64, 128))
    before = fused_ffn.launches
    got = fused_ffn(x, g, b, w1, w2, 0.5, packed=pack_ffn(w1, w2, sms=H100_SMS))
    assert torch.equal(got, fused_ffn_plain(x, g, b, w1, w2, 0.5))
    assert fused_ffn.launches == before            # no kernel launch on the CPU


def test_layer_params_pack_bf16_ffns_on_the_card_only(monkeypatch):
    """The weights of ``cast_params_for_compute`` (bf16): on CPU tensors
    nothing is packed; on the card (stood in for here: the weights count as
    on the card and the plan takes the H100's SMs) both FFNs of each layer
    hold the copy ``pack_ffn`` makes, with the conv flag too (the fused
    tail is int8 only), and only with ``pack_ffn``."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.models.parakeet.params import cast_params_for_compute, init_params

    cfg = ModelConfig.tiny()
    params = cast_params_for_compute(init_params(cfg, seed=0), bf16)
    on_cpu = encoder.layer_params(params, cfg.num_layers, pack_tail=True, pack_ffn=True)
    assert not any(k.endswith("_packed") for lp in on_cpu for k in lp)
    monkeypatch.setattr(encoder, "_bf16_weights", lambda ws: True)
    monkeypatch.setattr(kf, "sm_count", lambda index: H100_SMS)
    for lp in encoder.layer_params(params, cfg.num_layers, pack_tail=True, pack_ffn=True):
        for f in ("ff1", "ff2"):
            assert lp[f"{f}_w1"].dtype == bf16
            assert torch.equal(lp[f"{f}_packed"],
                               pack_ffn(lp[f"{f}_w1"], lp[f"{f}_w2"], sms=H100_SMS))
    assert not any("ff1_packed" in lp
                   for lp in encoder.layer_params(params, cfg.num_layers, pack_tail=True))
