"""Launch plan and weight packing of the fused conv + FFN2 + out-LN kernel
of the PyTorch port (``ops/kernels/conv_block.py``; ``csrc/conv_ffn_ln.cu``
checks the same shared-memory layout at launch): one cooperative launch
whose blocks must all be resident, at most one an SM, each owning a column
slice of every product with its weights in shared memory, copied from a
packed copy of each weight in which the slice is contiguous. The kernel
itself is held against its plain version on the card
(``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from trt_asr_tpu_torch.ops.kernels import conv_block as cb
from trt_asr_tpu_torch.ops.kernels.conv_block import (SMEM_PER_BLOCK, TAIL_GROUP,
                                                      conv_ffn_ln_plan, pack_tail_weight)
from trt_asr_tpu_torch.ops.quant import QuantTensor

H100_SMS = 132
KK = 9


def test_plan_at_full_width_is_one_resident_wave():
    plan = conv_ffn_ln_plan(8, 1024, 4096, KK, H100_SMS)
    assert (plan.blocks, plan.cols_d, plan.cols_e) == (128, 8, 32)
    assert plan.blocks <= H100_SMS
    weights = 1024 * 2 * 8 + 1024 * 8 + 1024 * 32 + 4096 * 8     # pw1, pw2, W1, W2 slices
    assert weights == 88 * 1024
    staged = 8 * (4096 + 16) * 2       # 8 rows of h, bf16, padded; 8 f32 rows of y1 alias them
    norms = 6 * 1024 * 4
    columns = (4 * 8 + 32 + (KK + 4) * 8) * 4 + 8 * 4            # scales, taps, BN, mask
    rows = (8 + KK - 1) * 8 * 4 + 8 * 8 * 4                      # conv rows; y1's columns
    sums = 16 * 32 * 8 * 4                                       # per-warp sums
    bars = 11 * 8                                                # mbarriers
    assert plan.smem == weights + staged + norms + columns + rows + sums + bars == 198_424
    assert plan.smem <= SMEM_PER_BLOCK == 232_448
    assert plan.scratch == 8 * (10 * 1024 + 2 * 4096)


@pytest.mark.parametrize("tq,d,e,sms", [
    (8, 64, 128, H100_SMS), (5, 96, 200, H100_SMS), (1, 64, 128, H100_SMS),
    (8, 1024, 4096, H100_SMS), (13, 1000, 4096, H100_SMS), (8, 512, 2048, 32),
    (74, 1024, 4096, H100_SMS),
])
def test_plan_covers_every_column(tq, d, e, sms):
    plan = conv_ffn_ln_plan(tq, d, e, KK, sms)
    assert plan.cols_d % TAIL_GROUP == 0 and plan.cols_e % TAIL_GROUP == 0
    assert plan.blocks <= sms
    assert (plan.blocks - 1) * plan.cols_d < d <= plan.blocks * plan.cols_d
    assert e <= plan.blocks * plan.cols_e
    assert plan.smem <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tq,d,e,sms", [
    (8, 1024, 16384, H100_SMS),       # W1's and W2's slices alone are 256 KB
    (8, 2048, 8192, H100_SMS),        # 16 columns a block
    (6000, 1024, 4096, H100_SMS),     # the conv's rows
    (8, 1024, 4096, 16),              # a card of 16 SMs: 64 columns a block
])
def test_plan_raises_when_it_cannot_fit(tq, d, e, sms):
    with pytest.raises(ValueError, match="exceeds"):
        conv_ffn_ln_plan(tq, d, e, KK, sms)


@pytest.mark.parametrize("tq,d,e", [(8, 1020, 4096), (8, 1024, 4100), (0, 64, 128)])
def test_plan_raises_on_shapes_the_kernel_does_not_take(tq, d, e):
    with pytest.raises(ValueError, match="multiples of 8"):
        conv_ffn_ln_plan(tq, d, e, KK, H100_SMS)


def int8_matrix(seed, k, n):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(-127, 128, size=(k, n), dtype=np.int8))


def unpack_group(p):
    """[Kp / 16, 8, 16] (a group as the kernel reads it) -> [Kp, 8]."""
    return p.permute(0, 2, 1).reshape(-1, 8)


@pytest.mark.parametrize("k,n,cols,blocks", [(64, 128, 16, 8), (96, 200, 24, 12),
                                             (200, 96, 8, 12)])
def test_packed_slice_holds_the_blocks_columns(k, n, cols, blocks):
    q = int8_matrix(k + n, k, n)
    p = pack_tail_weight(q, cols, blocks)
    kp = -(-k // 16) * 16
    assert p.shape == (blocks, cols // 8, kp // 16, 8, 16) and p.is_contiguous()
    full = torch.zeros((kp, blocks * cols), dtype=torch.int8)
    full[:k, :n] = q                                  # zero past K and past N
    for b in range(blocks):
        for g in range(cols // 8):
            c0 = b * cols + 8 * g
            assert torch.equal(unpack_group(p[b, g]), full[:, c0:c0 + 8])


def test_packed_glu_slice_pairs_each_column_with_its_gate():
    d, cols, blocks = 96, 8, 12
    q = int8_matrix(5, d, 2 * d)
    p = pack_tail_weight(q, cols, blocks, glu=True)
    assert p.shape == (blocks, 2, d // 16, 8, 16)
    for b in range(blocks):
        assert torch.equal(unpack_group(p[b, 0]), q[:, b * 8:b * 8 + 8])
        assert torch.equal(unpack_group(p[b, 1]), q[:, d + b * 8:d + b * 8 + 8])


def layer_constants(seed, d, e, kk=KK):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return (int8_matrix(seed, d, 2 * d), int8_matrix(seed + 1, d, d),
            int8_matrix(seed + 2, d, e), int8_matrix(seed + 3, e, d),
            f(2 * d), f(d), f(e), f(d), f(kk, d), f(d), f(d), f(d), f(d))


def test_packed_blob_holds_each_blocks_slices_and_columns():
    d, e = 96, 200
    plan = conv_ffn_ln_plan(5, d, e, KK, H100_SMS)
    cd, ce, nb = plan.cols_d, plan.cols_e, plan.blocks
    consts = layer_constants(7, d, e)
    blob = cb.pack_tail(*consts[:9], consts[9:], plan)
    weights = 96 * (3 * cd + ce) + 208 * cd                       # K padded to 16
    assert blob.shape == (nb, weights + ((8 + KK) * cd + ce) * 4) and blob.dtype == torch.uint8
    pw1, pw2, w1, w2, s1, s2, fs1, fs2, dw, *bn = consts
    for b in (0, 7, nb - 1):
        w = blob[b, :weights]
        assert torch.equal(w[:96 * 2 * cd].view(torch.int8),
                           pack_tail_weight(pw1, cd, nb, glu=True)[b].reshape(-1))
        o = 96 * 3 * cd + 96 * ce
        assert torch.equal(w[o:].view(torch.int8), pack_tail_weight(w2, cd, nb)[b].reshape(-1))
        cols = blob[b, weights:].view(torch.float32)

        def col(v, c0, width, limit):
            out = torch.zeros(width)
            n = max(0, min(width, limit - c0))
            out[:n] = v[c0:c0 + n]
            return out
        want = torch.cat([col(s1[:d], b * cd, cd, d), col(s1[d:], b * cd, cd, d),
                          col(s2, b * cd, cd, d), col(fs1, b * ce, ce, e), col(fs2, b * cd, cd, d),
                          *[col(row, b * cd, cd, d) for row in dw],
                          *[col(v, b * cd, cd, d) for v in bn]])
        assert torch.equal(cols, want)


def quant_layer(seed, d, e, kk=KK):
    """A layer's tail constants as the wrapper takes them: (pw1, dw, BN g,
    b, m, v, pw2, W1, W2), the weights int8 QuantTensors."""
    pw1, pw2, w1, w2, s1, s2, fs1, fs2, dw, *bn = layer_constants(seed, d, e, kk)
    qt = lambda q, s: QuantTensor(q, s.reshape(1, -1))  # noqa: E731
    return (qt(pw1, s1), dw, *bn, qt(pw2, s2), qt(w1, fs1), qt(w2, fs2))


@pytest.mark.parametrize("d,e,sms", [(96, 200, H100_SMS), (1024, 4096, H100_SMS),
                                     (512, 2048, 32)])
def test_pack_conv_ffn_ln_fits_every_tq_of_the_card(d, e, sms):
    """The packed constants depend on the card's column slices, not on Tq:
    one copy made with the weights serves every chunk."""
    layer = quant_layer(3, d, e)
    packed = cb.pack_conv_ffn_ln(*layer, sms=sms)
    pw1, dw, *bn, pw2, w1, w2 = layer
    for tq in (1, 8, 13):
        plan = conv_ffn_ln_plan(tq, d, e, KK, sms)
        cb.check_packed(packed, plan, d, e, KK)
        assert torch.equal(packed, cb.pack_tail(pw1.q, pw2.q, w1.q, w2.q, pw1.s, pw2.s, w1.s,
                                                w2.s, dw, tuple(bn), plan))


@pytest.mark.parametrize("change", ["other_card", "int8_view", "other_taps", "dropped_block"])
def test_check_packed_refuses_another_layout(change):
    d, e = 96, 200
    layer = quant_layer(4, d, e)
    packed = cb.pack_conv_ffn_ln(*layer, sms=H100_SMS)
    plan, kk = conv_ffn_ln_plan(8, d, e, KK, H100_SMS), KK
    if change == "other_card":
        packed = cb.pack_conv_ffn_ln(*layer, sms=4)
    elif change == "int8_view":
        packed = packed.view(torch.int8)
    elif change == "other_taps":
        kk = KK - 2
    else:
        packed = packed[1:]
    with pytest.raises(ValueError, match="do not fit the launch plan"):
        cb.check_packed(packed, plan, d, e, kk)


def test_layer_params_pack_the_tail_on_the_card_only():
    """On CPU tensors the wrapper runs its plain version, so nothing is
    packed; the card tests hold the packed copy of a model's layers."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
    from trt_asr_tpu_torch.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    cfg = ModelConfig.tiny()
    params = quantize_params(init_params(cfg, seed=0), "all")
    plain = layer_params(params, cfg.num_layers)
    packed = layer_params(params, cfg.num_layers, pack_tail=True)
    assert [sorted(lp) for lp in packed] == [sorted(lp) for lp in plain]
    assert all(isinstance(lp["conv_pw1"], QuantTensor) for lp in packed)
