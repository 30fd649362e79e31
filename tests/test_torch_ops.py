"""PyTorch port ``ops/`` against the JAX package on the CPU (f32): common,
quant, conv, lstm and the streaming branch of the rel-pos attention.

Tolerance: 1e-5 absolute for f32 results (the two frameworks sum in
different orders); one bf16 ulp for a bf16 x bf16 product (the same f32
sums in another order, rounded once); integer and quantization results
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_within_bf16_ulp, t

from trt_asr_tpu.ops import attention as j_att
from trt_asr_tpu.ops import common as j_common
from trt_asr_tpu.ops import conv as j_conv
from trt_asr_tpu.ops import lstm as j_lstm
from trt_asr_tpu.ops import quant as j_quant
from trt_asr_tpu_torch.ops import attention as p_att
from trt_asr_tpu_torch.ops import common as p_common
from trt_asr_tpu_torch.ops import conv as p_conv
from trt_asr_tpu_torch.ops import lstm as p_lstm
from trt_asr_tpu_torch.ops import quant as p_quant

ATOL = 1e-5


def rnd(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=1e-5)


@pytest.mark.parametrize("op", ["layer_norm", "batch_norm", "silu", "glu"])
def test_common_elementwise(op):
    rng = np.random.default_rng(1)
    x = rnd(rng, 3, 5, 16)
    g, b = 1 + rnd(rng, 16, scale=0.1), rnd(rng, 16, scale=0.1)
    if op == "layer_norm":
        close(p_common.layer_norm(t(x), t(g), t(b)), j_common.layer_norm(x, g, b))
    elif op == "batch_norm":
        m, v = rnd(rng, 16), np.abs(rnd(rng, 16)) + 0.5
        close(p_common.batch_norm_inference(t(x), t(g), t(b), t(m), t(v)),
              j_common.batch_norm_inference(x, g, b, m, v))
    elif op == "silu":
        close(p_common.silu(t(x)), j_common.silu(jnp.asarray(x)))
    else:
        close(p_common.glu(t(x)), j_common.glu(jnp.asarray(x)))


def test_matmul_and_einsum_f32():
    rng = np.random.default_rng(2)
    a, w = rnd(rng, 4, 7, 32), rnd(rng, 32, 24, scale=0.2)
    close(p_common.matmul(t(a), t(w)), j_common.matmul(jnp.asarray(a), jnp.asarray(w)))
    b = rnd(rng, 4, 9, 32)
    close(p_common.einsum("btd,bsd->bts", t(a), t(b)),
          j_common.einsum("btd,bsd->bts", jnp.asarray(a), jnp.asarray(b)), atol=3e-5)


@pytest.mark.parametrize("weight", ["bf16", "f32"])
def test_matmul_bf16_activations(weight):
    """bf16 activations times bf16 weights (cast_params_for_compute) and
    times f32 weights: a bf16 result within one bf16 ulp of JAX's."""
    rng = np.random.default_rng(3)
    a = rnd(rng, 3, 11, 96)
    w = rnd(rng, 96, 40, scale=0.1)
    ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w)
    pa, pw = t(a).to(torch.bfloat16), t(w)
    if weight == "bf16":
        jw, pw = jw.astype(jnp.bfloat16), pw.to(torch.bfloat16)
    got = p_common.matmul(pa, pw)
    want = j_common.matmul(ja, jw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert_within_bf16_ulp(got, np.array(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape", [(16, 24), (3, 64, 40)])
def test_quantize_tensor_exact(shape):
    rng = np.random.default_rng(3)
    w = rnd(rng, *shape)
    w[..., 0] = 0.0                     # an all-zero output channel -> scale 1
    jq = j_quant.quantize_tensor(jnp.asarray(w))
    pq = p_quant.quantize_tensor(t(w))
    np.testing.assert_array_equal(pq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(pq.s.numpy(), np.asarray(jq.s))
    np.testing.assert_array_equal(p_quant.dequantize(pq).numpy(),
                                  np.asarray(j_quant.dequantize(jq)))


def test_q8_matmul_and_dispatch():
    rng = np.random.default_rng(4)
    a, w = rnd(rng, 5, 48), rnd(rng, 48, 20, scale=0.2)
    jq, pq = j_quant.quantize_tensor(jnp.asarray(w)), p_quant.quantize_tensor(t(w))
    want = j_quant.q8_matmul(jnp.asarray(a), jq)
    close(p_quant.q8_matmul(t(a), pq), want)
    close(p_common.matmul(t(a), pq), j_common.matmul(jnp.asarray(a), jq))


def test_bf16_copies_of_int8_weights_are_exact_and_made_once():
    """The bf16 copy of each int8 weight that ``q8_matmul`` reads on the
    card (kept beside q once, where the model is made) holds q exactly
    (|q| <= 127 is exact in bf16); each layer's view of a stacked weight
    carries its layer of the one copy, the same tensor on two calls of
    ``layer_params``. On the CPU the model keeps none, so the copies are
    made here by hand."""
    from trt_asr_tpu_torch.config import ModelConfig
    from trt_asr_tpu_torch.models.parakeet.encoder import layer_params
    from trt_asr_tpu_torch.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    cfg = ModelConfig.tiny()
    params = quantize_params(init_params(cfg, seed=3), "all")
    stacked = params["encoder"]["layers"]
    quants = [w for w in stacked.values() if isinstance(w, p_quant.QuantTensor)]
    quants += [params["joint"][k]["w"] for k in ("enc", "pred", "out")]
    assert len(quants) == 13
    for w in quants:
        assert p_quant.bf16_copy(w.q) is None
        p_quant.keep_bf16_copy(w.q)
        copy = p_quant.bf16_copy(w.q)
        assert copy.dtype == torch.bfloat16 and p_quant.bf16_copy(w.q) is copy
        assert torch.equal(copy.float(), w.q.float())
    first, again = (layer_params(params, cfg.num_layers) for _ in range(2))
    for li, (a, b) in enumerate(zip(first, again)):
        for k, w in stacked.items():
            if isinstance(w, p_quant.QuantTensor):
                ca, cb = p_quant.bf16_copy(a[k].q), p_quant.bf16_copy(b[k].q)
                assert torch.equal(ca.float(), a[k].q.float())
                assert ca.data_ptr() == cb.data_ptr() == p_quant.bf16_copy(w.q)[li].data_ptr()
    with pytest.raises(ValueError, match="does not fit"):
        p_quant.keep_bf16_copy(quants[0].q, quants[1].q.to(torch.bfloat16)[:1])


@pytest.mark.parametrize("act", [torch.float32, torch.bfloat16])
def test_matmul_counts_widened_bf16_weights(act):
    """An f32 activation times a bf16 weight (the weights of
    ``cast_params_for_compute``) widens the weight at the call, as JAX
    promotes the pair, and counts one widening; a bf16 x bf16 product
    counts none. The product equals the f32 product of the widened pair."""
    rng = np.random.default_rng(8)
    a = t(rnd(rng, 4, 16)).to(act)
    w = t(rnd(rng, 16, 8)).to(torch.bfloat16)
    before = p_common.matmul.widened
    got = p_common.matmul(a, w)
    assert p_common.matmul.widened - before == (1 if act == torch.float32 else 0)
    want = torch.matmul(a.float(), w.float())
    assert torch.equal(got, want if act == torch.float32 else want.to(torch.bfloat16))
    p_common.matmul(a.float(), w.float())          # f32 x f32: none
    assert p_common.matmul.widened - before == (1 if act == torch.float32 else 0)


def test_f32_copies_of_small_bf16_tensors():
    """``keep_f32_copy`` keeps an exact f32 copy beside a bf16 tensor, which
    ``as_f32`` returns without a new copy; without one ``as_f32`` widens at
    the call and counts it and its bytes; f32 tensors pass as they are."""
    b = t(rnd(np.random.default_rng(9), 24)).to(torch.bfloat16)
    n0, bytes0 = p_quant.as_f32.widened, p_quant.as_f32.widened_bytes
    fresh = p_quant.as_f32(b)
    assert torch.equal(fresh, b.float()) and fresh.dtype == torch.float32
    assert (p_quant.as_f32.widened - n0, p_quant.as_f32.widened_bytes - bytes0) == (1, 24 * 6)
    p_quant.keep_f32_copy(b)
    assert p_quant.as_f32(b) is p_quant.as_f32(b) and torch.equal(p_quant.as_f32(b), fresh)
    f = b.float()
    p_quant.keep_f32_copy(f)
    assert p_quant.as_f32(f) is f
    assert p_quant.as_f32.widened - n0 == 1


def test_depthwise_conv1d():
    rng = np.random.default_rng(5)
    x, w, b = rnd(rng, 2, 17, 12), rnd(rng, 9, 12), rnd(rng, 12)
    close(p_conv.depthwise_conv1d(t(x), t(w), t(b)),
          j_conv.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("case", ["same_s1", "explicit_s2", "depthwise_s2", "valid_1x1"])
def test_conv2d(case):
    rng = np.random.default_rng(6)
    x = rnd(rng, 2, 11, 9, 4)
    if case == "same_s1":
        w, kw = rnd(rng, 3, 3, 4, 6), dict(stride=(1, 1), padding="SAME")
    elif case == "explicit_s2":
        w, kw = rnd(rng, 3, 3, 4, 6), dict(stride=(2, 2), padding=[(1, 1), (1, 1)])
    elif case == "depthwise_s2":
        w, kw = rnd(rng, 3, 3, 1, 4), dict(stride=(2, 2), padding=[(1, 1), (1, 1)], groups=4)
    else:
        w, kw = rnd(rng, 1, 1, 4, 5), dict(stride=(1, 1), padding="VALID")
    b = rnd(rng, w.shape[-1])
    close(p_conv.conv2d(t(x), t(w), t(b), **kw),
          j_conv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw), atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_dw_striding_subsample(masked):
    from trt_asr_tpu.config import ModelConfig
    from trt_asr_tpu.models.parakeet.params import init_params
    from trt_asr_tpu_torch.models.parakeet.params import params_from_numpy

    from torch_port_helpers import np_tree

    cfg = ModelConfig.tiny()
    pre = np_tree(init_params(cfg, seed=1)["encoder"]["pre_encode"])
    rng = np.random.default_rng(7)
    x = rnd(rng, 2, 57, cfg.feat_in)
    lens = np.array([57, 40], np.int32) if masked else None
    want = j_conv.dw_striding_subsample(pre, jnp.asarray(x),
                                        None if lens is None else jnp.asarray(lens))
    got = p_conv.dw_striding_subsample(params_from_numpy(pre), t(x),
                                       None if lens is None else t(lens))
    close(got, want, atol=2e-5)


def test_subsampled_length():
    n = np.arange(0, 200, dtype=np.int32)
    np.testing.assert_array_equal(p_conv.subsampled_length(t(n), 3).numpy(),
                                  np.asarray(j_conv.subsampled_length(jnp.asarray(n), 3)))
    assert p_conv.subsampled_length(57, 3) == 8


def test_lstm_step():
    rng = np.random.default_rng(8)
    p_in, hid, b = 12, 16, 3
    layers = [{"wi": rnd(rng, p_in if i == 0 else hid, 4 * hid, scale=0.3),
               "wh": rnd(rng, hid, 4 * hid, scale=0.3),
               "bi": rnd(rng, 4 * hid, scale=0.1), "bh": rnd(rng, 4 * hid, scale=0.1)}
              for i in range(2)]
    x, h, c = rnd(rng, b, p_in), rnd(rng, 2, b, hid), rnd(rng, 2, b, hid)
    want = j_lstm.lstm_step([{k: jnp.asarray(v) for k, v in l.items()} for l in layers],
                            jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    got = p_lstm.lstm_step([{k: t(v) for k, v in l.items()} for l in layers], t(x), t(h), t(c))
    for g, w in zip(got, want):
        close(g, w)


def test_sinusoidal_pos_table_exact():
    np.testing.assert_array_equal(p_att.sinusoidal_pos_table(6, 38, 64).numpy(),
                                  np.asarray(j_att.sinusoidal_pos_table(6, 38, 64)))


@pytest.mark.parametrize("cursor,cache_len", [(0, 0), (7, 19), (5, 32)])
def test_rel_pos_attention_streaming_branch(cursor, cache_len):
    """Ring-ordered cache with per-slot relative indices and a kv mask, as
    the streaming encoder builds them."""
    rng = np.random.default_rng(9)
    b, tq, h, dh, c = 1, 6, 4, 16, 32
    q = rnd(rng, b, tq, h, dh)
    k, v = rnd(rng, b, c + tq, h, dh), rnd(rng, b, c + tq, h, dh)
    pos = rnd(rng, 2 * tq + c - 1, h, dh)
    bu, bv = rnd(rng, h, dh), rnd(rng, h, dh)
    wo = rnd(rng, h * dh, h * dh, scale=0.1)
    age = ((cursor - 1 - np.arange(c)) % c) + 1
    idx_cache = (c + tq - 1) - (age[None, :] + np.arange(tq)[:, None])
    ii, jj = np.arange(tq)[:, None], np.arange(tq)[None, :]
    rel_idx = np.concatenate([idx_cache, (c + tq - 1) - (ii - jj)], 1)[None].astype(np.int32)
    mask = np.concatenate([age <= cache_len, np.arange(tq) < 5])[None]
    want = j_att.rel_pos_attention_kv(*map(jnp.asarray, (q, k, v, pos, bu, bv, wo)),
                                      kv_mask=jnp.asarray(mask), rel_idx=jnp.asarray(rel_idx))
    got = p_att.rel_pos_attention_kv(*map(t, (q, k, v, pos, bu, bv, wo)),
                                     kv_mask=t(mask), rel_idx=t(rel_idx))
    close(got, want, atol=2e-5)
