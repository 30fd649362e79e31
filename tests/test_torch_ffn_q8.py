"""Launch plan, weight packing and work split of the int8 FFN kernel of the
PyTorch port (``ops/kernels/ffn.py``; ``csrc/ffn_q8.cu`` checks the same
shared-memory layout at launch): one cooperative launch whose blocks must
all be resident, at most one an SM, block b owning a slice of 32 (a
multiple of 32) expansion columns of W1 and a slice of 8 (a multiple of 8)
columns of W2 over the whole expansion, both int8 slices with the scales
of their columns contiguous in a packed copy and whole in shared memory. A
plain-torch replay of the kernel's split (per pass of 8 rows: u =
bf16(LN(x)); per block, its columns of h = bf16(silu(s1 * u @ W1[:,
slice])); after the barrier, per block, its columns of y = x + scale * s2 *
(h @ W2[:, slice]), s2 applied after the whole sum as ``fused_ffn_plain``
applies it) is held to ``fused_ffn_plain`` at 1e-5, the exactness
``tests/test_torch_ffn.py`` states (both round the same operands to bf16
and multiply exact integers), and to the JAX package's ``fused_ffn_pallas``
in interpret mode at ``ModelConfig.tiny()``'s widths. The kernel itself is
held against its plain version on the card (``test_torch_kernels_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trt_asr_tpu.ops.pallas.ffn_kernel import fused_ffn_pallas
from trt_asr_tpu.ops.quant import quantize_tensor as j_quantize
from trt_asr_tpu_torch.ops.common import silu
from trt_asr_tpu_torch.ops.kernels import ffn as kf
from trt_asr_tpu_torch.ops.kernels.ffn import (FFN_SLICE, ffn_q8_plan, fused_ffn, fused_ffn_plain,
                                               layer_norm_plain, pack_ffn)
from trt_asr_tpu_torch.ops.kernels.persistent import SMEM_PER_BLOCK, pad_k
from trt_asr_tpu_torch.ops.quant import QuantTensor, quantize_tensor, round_bf16

H100_SMS = 132
TOL = 1e-5
# (M, D, E): rows 1, 6, 8 (a steady chunk) and 13 (two passes of 8 rows);
# D 64 (ModelConfig.tiny(), gate_r3) and 96; E 128 and 200 (a ragged last
# slice)
SHAPES = [(m, d, e) for m in (1, 6, 8, 13) for d in (64, 96) for e in (128, 200)]


def test_plan_at_full_width_is_one_resident_wave():
    """128 blocks of 32 expansion columns and 8 columns of y on the H100's
    132 SMs, each with its whole int8 slices (32 KB of W1, 32 KB of W2) in
    shared memory."""
    plan = ffn_q8_plan(1024, 4096, H100_SMS)
    assert (plan.blocks, plan.cols_e, plan.cols_d, plan.stages) == (128, 32, 8, 0)
    blob = 1024 * 32 + (32 + 8) * 4 + 4096 * 8      # W1 (int8), s1 and s2 columns, W2 (int8)
    rows = 8 * (4096 + 16) * 2                      # h's rows, bf16 (u's before them)
    x = 8 * 1024 * 4                                # x's rows
    norms = 2 * 1024 * 4
    sums = 16 * 32 * 8 * 4                          # W1's per-warp sums (W2's after them)
    bars = 7 * 8                                    # mbarriers: x, W1, W2, h's four chunks
    assert plan.smem == blob + rows + x + norms + sums + bars == 188_888
    assert plan.smem <= SMEM_PER_BLOCK
    assert plan.scratch == 2 * 8 * 4096 * 2         # two buffers of h, bf16


@pytest.mark.parametrize("d,e,sms", [(1024, 4096, H100_SMS), (64, 128, H100_SMS),
                                     (96, 200, H100_SMS), (64, 200, 3), (1024, 2048, 66)])
def test_plan_covers_every_column_once(d, e, sms):
    plan = ffn_q8_plan(d, e, sms)
    assert plan.cols_e % FFN_SLICE == 0 and plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_e < e <= plan.blocks * plan.cols_e
    assert plan.cols_d % 8 == 0 and plan.blocks * plan.cols_d >= d
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("d,e,sms,match", [
    (100, 128, H100_SMS, "a multiple of 8"),            # D
    (64, 0, H100_SMS, "E >= 1"),
    (64, 100, H100_SMS, "E a multiple of 8"),           # h's rows are copied 16 bytes at a time
    (1024, 4096, 4, "exceeds"),                         # 1024 expansion columns a block
    (1024, 4096, 66, "exceeds"),                        # 64 expansion columns, 16 of y
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(d, e, sms, match):
    with pytest.raises(ValueError, match=match):
        ffn_q8_plan(d, e, sms)


def weights(seed, d, e):
    rng = np.random.default_rng(seed)
    return (quantize_tensor(torch.as_tensor((rng.standard_normal((d, e)) * d ** -0.5)
                                            .astype(np.float32))),
            quantize_tensor(torch.as_tensor((rng.standard_normal((e, d)) * e ** -0.5)
                                            .astype(np.float32))))


def unpack(packed, d, e, plan):
    """(W1, s1, s2, W2) back from the packed layout: block b's W1 columns
    [cE / 8][Dp / 16][8][16], its s1 [cE] and s2 [cD] columns, its W2
    columns [cD / 8][Ep / 16][8][16]."""
    blocks, ce, cd, dp, ep = plan.blocks, plan.cols_e, plan.cols_d, pad_k(d), pad_k(e)

    def columns(q, k, cols):
        q = q.contiguous().view(torch.int8).reshape(blocks, cols // 8, k // 16, 8, 16)
        return q.permute(2, 4, 0, 1, 3).reshape(k, blocks * cols)

    n1, nc = dp * ce, 4 * (ce + cd)
    a = columns(packed[:, :n1], dp, ce)
    fc = packed[:, n1:n1 + nc].contiguous().view(torch.float32)
    s1, s2 = fc[:, :ce].reshape(-1), fc[:, ce:].reshape(-1)
    b = columns(packed[:, n1 + nc:], ep, cd)
    assert not a[d:].any() and not a[:, e:].any()                   # zero past D and E
    assert not b[e:].any() and not b[:, d:].any()
    assert not s1[e:].any() and not s2[d:].any()
    return a[:d, :e], s1[:e], s2[:d], b[:e, :d]


@pytest.mark.parametrize("d,e,sms", [(64, 128, H100_SMS), (96, 200, H100_SMS), (96, 200, 3),
                                     (1024, 4096, H100_SMS)])
def test_packed_layout_unpacks_slice_for_slice(d, e, sms):
    w1, w2 = weights(d + e, d, e)
    packed = pack_ffn(w1, w2, sms=sms)
    plan = ffn_q8_plan(d, e, sms)
    assert packed.dtype == torch.uint8
    assert packed.shape == (plan.blocks, pad_k(d) * plan.cols_e + pad_k(e) * plan.cols_d
                            + 4 * (plan.cols_e + plan.cols_d))
    a, s1, s2, b = unpack(packed, d, e, plan)
    assert torch.equal(a, w1.q) and torch.equal(b, w2.q)
    assert torch.equal(s1, w1.s.reshape(-1)) and torch.equal(s2, w2.s.reshape(-1))
    kf.check_packed_ffn(packed, plan, d, e)


@pytest.mark.parametrize("change", ["other_card", "f32_layout", "dropped_block", "other_width"])
def test_check_packed_ffn_refuses_another_layout(change):
    d, e = 96, 200
    w1, w2 = weights(7, d, e)
    packed = pack_ffn(w1, w2, sms=H100_SMS)
    plan = ffn_q8_plan(d, e, H100_SMS)
    if change == "other_card":
        packed = pack_ffn(w1, w2, sms=3)
    elif change == "f32_layout":
        packed = pack_ffn(w1.q.float() * w1.s, w2.q.float() * w2.s, sms=H100_SMS)
    elif change == "dropped_block":
        packed = packed[1:]
    else:
        d = 64
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        kf.check_packed_ffn(packed, plan, d, e)


def replay(x, g, b, w1, w2, plan, scale=0.5):
    """The int8 kernel's work split in plain torch, 8 rows a pass: (a) u =
    bf16(LN(x)); (b) per block, its columns of h = bf16(silu(s1 * u @ W1[:,
    slice])); (c) after the barrier, per block, its columns of y = x +
    scale * ((h @ W2[:, slice]) * s2), s2 after the whole sum over E."""
    m, d = x.shape
    e = w1.q.shape[1]
    ce, cd = plan.cols_e, plan.cols_d
    q1, s1, q2, s2 = w1.q.float(), w1.s.reshape(-1), w2.q.float(), w2.s.reshape(-1)
    y = torch.empty_like(x)
    for m0 in range(0, m, 8):
        rows = x[m0:m0 + 8]
        u = round_bf16(layer_norm_plain(rows, g, b))
        h = torch.cat([round_bf16(silu((u @ q1[:, c0:c0 + ce]) * s1[c0:c0 + ce]))
                       for c0 in range(0, e, ce)], dim=1)
        for n0 in range(0, d, cd):
            cols = slice(n0, n0 + cd)
            y[m0:m0 + 8, cols] = rows[:, cols] + scale * ((h @ q2[:, cols]) * s2[cols])
    return y


def inputs(seed, m, d, e):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return (r(m, d, sc=1.0), 1.0 + r(d, sc=0.2), r(d, sc=0.1), r(d, e, sc=d ** -0.5),
            r(e, d, sc=e ** -0.5))


@pytest.mark.parametrize("m,d,e", SHAPES)
def test_replay_of_the_kernels_split_matches_plain(m, d, e):
    x, g, b, w1, w2 = (torch.as_tensor(a) for a in inputs(m * 1000 + d + e, m, d, e))
    q1, q2 = quantize_tensor(w1), quantize_tensor(w2)
    got = replay(x, g, b, q1, q2, ffn_q8_plan(d, e, H100_SMS))
    torch.testing.assert_close(got, fused_ffn_plain(x, g, b, q1, q2, 0.5), atol=TOL, rtol=TOL)


def test_replay_sees_the_rounding_points():
    """The tolerance tells the replay from one without the bf16 rounding
    points (the plain version on the dequantized f32 weights)."""
    x, g, b, w1, w2 = (torch.as_tensor(a) for a in inputs(5, 8, 64, 128))
    q1, q2 = quantize_tensor(w1), quantize_tensor(w2)
    got = replay(x, g, b, q1, q2, ffn_q8_plan(64, 128, H100_SMS))
    deq = fused_ffn_plain(x, g, b, q1.q.float() * q1.s, q2.q.float() * q2.s, 0.5)
    assert float((got - deq).abs().max()) > 10 * TOL


@pytest.mark.parametrize("m", [1, 6, 8, 13])
def test_replay_matches_pallas_interpret(m):
    """ModelConfig.tiny()'s widths (D 64, E 128), one quantization shared by
    both sides."""
    x, g, b, w1, w2 = inputs(m, m, 64, 128)
    jw = [j_quantize(jnp.asarray(w)) for w in (w1, w2)]
    want = fused_ffn_pallas(jnp.asarray(x), g, b, *jw, scale=0.5, interpret=True)
    pw = [QuantTensor(torch.as_tensor(np.array(q.q)), torch.as_tensor(np.array(q.s)))
          for q in jw]
    got = replay(*[torch.as_tensor(a) for a in (x, g, b)], *pw, ffn_q8_plan(64, 128, H100_SMS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_wrapper_ignores_packed_weights_on_cpu():
    x, g, b, w1, w2 = (torch.as_tensor(a) for a in inputs(6, 8, 64, 128))
    q1, q2 = quantize_tensor(w1), quantize_tensor(w2)
    before = fused_ffn.launches
    got = fused_ffn(x, g, b, q1, q2, 0.5, packed=pack_ffn(q1, q2, sms=H100_SMS))
    assert torch.equal(got, fused_ffn_plain(x, g, b, q1, q2, 0.5))
    assert fused_ffn.launches == before            # no kernel launch on the CPU


@pytest.mark.parametrize("quant", ["none", "all"])
def test_layer_params_pack_each_ffn_the_kernel_runs(monkeypatch, quant):
    """With the FFN flag a model packs both FFNs of a layer whose weights are
    on the card (int8 or f32), FFN2 only where the fused int8 tail does not
    take it (with the conv flag too); each copy is the one ``pack_ffn``
    makes. The card stands in for the CPU here: the weights count as on the
    card and the plan takes the H100's SMs."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet import encoder
    from trt_asr_tpu_torch.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    monkeypatch.setattr(encoder, "_persistent_weights", lambda ws: True)
    monkeypatch.setattr(kf, "sm_count", lambda index: H100_SMS)
    cfg = ModelConfig.tiny()
    params = init_params(cfg, seed=0)
    if quant != "none":
        params = quantize_params(params, quant)
    for tail in (False, True):
        layers = encoder.layer_params(params, cfg.num_layers, pack_tail=tail, pack_ffn=True)
        takes_ff2 = tail and quant != "none"         # the fused int8 tail runs FFN2
        for lp in layers:
            assert torch.equal(lp["ff1_packed"], pack_ffn(lp["ff1_w1"], lp["ff1_w2"], sms=H100_SMS))
            assert ("ff2_packed" in lp) == (not takes_ff2)
            if not takes_ff2:
                assert torch.equal(lp["ff2_packed"],
                                   pack_ffn(lp["ff2_w1"], lp["ff2_w2"], sms=H100_SMS))
        assert not any("ff1_packed" in lp
                       for lp in encoder.layer_params(params, cfg.num_layers, pack_tail=tail))
