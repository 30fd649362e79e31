"""Streaming encoder of the PyTorch port against the JAX package: ``encode``
closed-loop over the chunk schedule (more than 20 chunks, the ring cache
saturating on the way), with the fused attention block off and on (the CPU
tensors take its plain version); the ring writes, the per-row reset and the
contract-layout state conversion.

Tolerance: 1e-4 absolute and relative on encoder outputs and caches
(float32, summation order compounding over the closed loop)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, t

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.models.parakeet import encoder as jenc
from trt_asr_tpu.models.parakeet.params import init_params as j_init
from trt_asr_tpu.models.parakeet.quant import quantize_params as j_quantize
from trt_asr_tpu.streaming.schedule import build_schedule as j_build_schedule
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet import encoder as penc
from trt_asr_tpu_torch.models.parakeet.params import params_from_numpy
from trt_asr_tpu_torch.streaming.schedule import build_schedule, extract_chunk

ATOL = RTOL = 1e-4
TOTAL_FRAMES = 520          # 21 chunks of the tiny schedule


@pytest.fixture(scope="module")
def models():
    cfg_j = JConfig.tiny()
    params_j = j_init(cfg_j, seed=4)
    return cfg_j, params_j, ModelConfig.tiny(), params_from_numpy(np_tree(params_j))


def steady_tq(cfg):
    frames = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
    return penc.subsampled_length(frames, cfg.stride_stages) - cfg.drop_extra_pre_encoded


def test_schedule_matches_jax():
    cfg = ModelConfig.tiny()
    ours, ref = build_schedule(TOTAL_FRAMES, cfg), j_build_schedule(TOTAL_FRAMES, JConfig.tiny())
    assert [tuple(vars(s).values()) for s in ours] == [tuple(vars(s).values()) for s in ref]


@pytest.mark.parametrize("fused_att", [False, True])
def test_closed_loop_encode_matches_jax(models, fused_att):
    cfg_j, params_j, cfg, params = models
    feats = (0.5 * np.random.default_rng(0).standard_normal((TOTAL_FRAMES, cfg.feat_in))
             ).astype(np.float32)
    sched = build_schedule(TOTAL_FRAMES, cfg)
    assert len(sched) >= 20
    st_j = jenc.init_encoder_state(cfg_j, 1)
    st_p = penc.init_encoder_state(cfg, 1)
    tq_steady = steady_tq(cfg)
    pad = (-tq_steady) % 8 if fused_att else 0
    layers = penc.layer_params(params, cfg.num_layers)
    saturated = fused_chunks = 0
    for spec in sched:
        x = extract_chunk(feats, spec)
        valid = max(min(spec.slice_end, TOTAL_FRAMES) - max(spec.slice_start, 0), 0)
        kw = dict(drop_extra=spec.drop_extra, cache_drop=0 if spec.is_last else cfg.cache_drop_size,
                  valid_cap=None if spec.is_last else cfg.valid_out_len)
        enc_j, len_j, st_j = jenc.encode(params_j, cfg_j, x[None], np.array([valid], np.int32),
                                         st_j, **kw)
        tq = penc.subsampled_length(spec.frames, cfg.stride_stages) - spec.drop_extra
        use = fused_att and tq == tq_steady
        fused_chunks += use
        enc_p, len_p, st_p = penc.encode(params, cfg, t(x[None]), torch.tensor([valid]), st_p,
                                         pad_steps=pad if use else 0, use_pallas_att=use,
                                         layers=layers, **kw)
        n = int(np.asarray(len_j)[0])
        assert int(len_p[0]) == n, f"chunk {spec.idx}"
        np.testing.assert_allclose(enc_p[0, :n].numpy(), np.asarray(enc_j)[0, :n],
                                   atol=ATOL, rtol=RTOL, err_msg=f"chunk {spec.idx}")
        for name in ("att_cache", "time_cache", "kv_cache"):
            np.testing.assert_allclose(getattr(st_p, name).numpy(),
                                       np.asarray(getattr(st_j, name)), atol=ATOL, rtol=RTOL,
                                       err_msg=f"chunk {spec.idx} {name}")
        for name in ("cache_len", "cursor"):
            np.testing.assert_array_equal(getattr(st_p, name).numpy(),
                                          np.asarray(getattr(st_j, name)))
        saturated |= int(st_p.cache_len[0]) == cfg.att_cache_size
    assert saturated
    assert fused_chunks >= 18 if fused_att else fused_chunks == 0


def test_int8_encode_matches_jax(models):
    """quant='all' weights on both sides (the fast arm's encoder), one chunk
    of each kind through the fused attention block."""
    cfg_j, params_j, cfg, _ = models
    qj = j_quantize(params_j, "all")
    qp = params_from_numpy(np_tree(qj))
    feats = (0.5 * np.random.default_rng(1).standard_normal((160, cfg.feat_in))).astype(np.float32)
    st_j, st_p = jenc.init_encoder_state(cfg_j, 1), penc.init_encoder_state(cfg, 1)
    tq_steady = steady_tq(cfg)
    for spec in build_schedule(160, cfg):
        x = extract_chunk(feats, spec)
        valid = max(min(spec.slice_end, 160) - max(spec.slice_start, 0), 0)
        kw = dict(drop_extra=spec.drop_extra, cache_drop=0 if spec.is_last else cfg.cache_drop_size)
        enc_j, len_j, st_j = jenc.encode(qj, cfg_j, x[None], np.array([valid], np.int32), st_j, **kw)
        tq = penc.subsampled_length(spec.frames, cfg.stride_stages) - spec.drop_extra
        use = tq == tq_steady
        enc_p, _, st_p = penc.encode(qp, cfg, t(x[None]), torch.tensor([valid]), st_p,
                                     use_pallas_att=use, pad_steps=(-tq) % 8 if use else 0, **kw)
        n = int(np.asarray(len_j)[0])
        # bf16 operand rounding inside the fused block vs the XLA int8 path
        np.testing.assert_allclose(enc_p[0, :n].numpy(), np.asarray(enc_j)[0, :n],
                                   atol=3e-2, rtol=3e-2, err_msg=f"chunk {spec.idx}")


@pytest.mark.parametrize("appended", [[3, 0], [5, 2]])
def test_ring_write_drops_rows_past_appended(appended):
    """JAX scatters the rows past ``appended`` to slot C with mode='drop';
    the port masks them instead. Writes wrap around the ring."""
    rng = np.random.default_rng(5)
    cache = rng.standard_normal((2, 8, 4)).astype(np.float32)
    block = rng.standard_normal((2, 5, 4)).astype(np.float32)
    cursor = np.array([6, 1], np.int32)
    app = np.array(appended, np.int32)
    want = np.asarray(jenc._ring_write(jnp.asarray(cache), jnp.asarray(block),
                                       jnp.asarray(cursor), jnp.asarray(app)))
    got = penc._ring_write(t(cache), t(block), t(cursor), t(app)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jenc._append_cache(jnp.asarray(cache), jnp.asarray(block), jnp.asarray(app)))
    np.testing.assert_array_equal(penc._append_cache(t(cache), t(block), t(app)).numpy(), want)


def warm_states(models, chunks=9):
    cfg_j, params_j, cfg, params = models
    feats = (0.5 * np.random.default_rng(6).standard_normal((400, cfg.feat_in))).astype(np.float32)
    st_j, st_p = jenc.init_encoder_state(cfg_j, 2), penc.init_encoder_state(cfg, 2)
    for spec in build_schedule(400, cfg)[:chunks]:
        x = np.stack([extract_chunk(feats, spec)] * 2)
        valid = np.array([spec.frames, spec.frames - 5], np.int32)
        kw = dict(drop_extra=spec.drop_extra, cache_drop=cfg.cache_drop_size)
        _, _, st_j = jenc.encode(params_j, cfg_j, x, valid, st_j, **kw)
        _, _, st_p = penc.encode(params, cfg, t(x), t(valid), st_p, **kw)
    return st_j, st_p


def test_state_contract_round_trip_matches_jax(models):
    cfg_j, params_j, cfg, params = models
    st_j, st_p = warm_states(models)
    cj, cp = jenc.state_to_contract(st_j), penc.state_to_contract(st_p)
    for k in cj:
        np.testing.assert_allclose(cp[k].numpy(), np.asarray(cj[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    back_j = jenc.state_from_contract(cj, params_j)
    back_p = penc.state_from_contract(cp, params)
    for name in back_j._fields:
        np.testing.assert_allclose(getattr(back_p, name).numpy(), np.asarray(getattr(back_j, name)),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    # the copy is independent of the live (in-place updated) caches
    st_p.att_cache.add_(1.0)
    np.testing.assert_allclose(cp["cache_last_channel"].numpy(),
                               np.asarray(cj["cache_last_channel"]), atol=ATOL, rtol=RTOL)


def test_reset_rows_matches_jax(models):
    st_j, st_p = warm_states(models, chunks=4)
    mask = np.array([False, True])
    rj = jenc.reset_encoder_state_rows(st_j, jnp.asarray(mask))
    rp = penc.reset_encoder_state_rows(st_p, torch.as_tensor(mask))
    for name in rj._fields:
        np.testing.assert_allclose(getattr(rp, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    assert int(rp.cache_len[1]) == 0 and float(rp.att_cache[:, 1].abs().max()) == 0.0
