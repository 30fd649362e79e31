"""PyTorch port ``ops/`` against the JAX package on the CPU (f32): common,
quant, conv, lstm and the streaming branch of the rel-pos attention.

Tolerance: 1e-5 absolute for f32 results (the two frameworks sum in
different orders); integer and quantization results exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

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
