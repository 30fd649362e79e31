"""Streaming encoder of the PyTorch port against the JAX package: ``encode``
closed-loop over the chunk schedule (more than 20 chunks, the ring cache
saturating on the way), with the fused attention block off and on (the CPU
tensors take its plain version); closed-loop over a short utterance's whole
schedule with the fused FFN and conv kernels on both sides (JAX's in
interpret mode), in f32 and with int8 encoder weights (the fused conv +
FFN2 + out-LN tail, and the conv module alone); closed-loop with the bf16
weights of ``cast_params_for_compute``, an f32 or bf16 state, the attention
kernel off and on (its own tolerance, below); the per-row cache_drop and
emission-cap vectors of the lockstep batch step; the ring writes, the
per-row reset and the contract-layout state conversion.

Tolerance: 1e-4 absolute and relative on encoder outputs and caches
(float32, summation order compounding over the closed loop). With the
kernels on, int8 too is held to 1e-4: both sides round the same operands to
bf16 (observed gap 4.8e-7, f32 2.0e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, spy_calls, t

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.models.parakeet import encoder as jenc
from trt_asr_tpu.models.parakeet.params import cast_params_for_compute as j_cast
from trt_asr_tpu.models.parakeet.params import init_params as j_init
from trt_asr_tpu.models.parakeet.quant import quantize_params as j_quantize
from trt_asr_tpu.streaming.schedule import build_schedule as j_build_schedule
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet import encoder as penc
from trt_asr_tpu_torch.models.parakeet.params import cast_params_for_compute as penc_cast
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


BF16_FLIP_ATOL = 1e-2      # a chunk after a bf16 rounding flip in a kernel's plain version
BF16_FLIP_CHUNKS = 4       # chunks of 10 past 1e-4 that flips may touch


@pytest.mark.parametrize("fused_att", [False, True, "all"])
@pytest.mark.parametrize("state", ["f32", "bf16"])
def test_closed_loop_bf16_encode_matches_jax(models, state, fused_att):
    """The bf16 weights of ``cast_params_for_compute`` on both sides, an f32
    or a bf16 encoder state (its caches stored in bf16, as the graft entry
    keeps them), the attention block's kernel off or on (its plain version:
    u, q + biases, k, v, the positional term, p and the context rounded to
    bf16, as the TPU kernel rounds them), or every kernel flag on ("all":
    the FFN and conv module too, JAX's in interpret mode, the conv over a
    bf16 time cache with a bf16 state), closed loop over 10 chunks.

    Tolerance: with the kernels off every chunk's encoder output and
    caches within 1e-4 (readings 1.8e-6, 3.1e-5 with a bf16 state). With
    kernels on, their plain versions round operands to bf16 as the TPU
    kernels do, and an f32 value one ulp apart on the two sides (inputs
    1e-6 apart) can round to the neighbouring bf16 value: at most 4 of the
    10 chunks may lie past 1e-4, each within 1e-2. Readings: one flip of u
    at layer 1 of the last chunk, 2.8e-3 (the attention kernel, f32
    state; the JAX side's u lies on a bf16 rounding midpoint); with every
    kernel one flip in chunk 0's last layer, 5.3e-3 (f32 state) and one
    bf16 ulp of a cache value, 7.8e-3 (bf16 state), carried into the two
    chunks its time-cache rows feed, and a second of 1.9e-4 at chunk 6.
    The same loop with the port's kernels off, the version without the
    rounding points, lies 1.1e-2 to 1.6e-2 from JAX's at every chunk, so
    the tolerance sees the rounding points."""
    cfg_j, params_j, cfg, params = models
    params_j = j_cast(params_j, jnp.bfloat16)
    params = penc_cast(params, torch.bfloat16)
    total = 240                                   # the last chunk: 40 valid frames
    feats = (0.5 * np.random.default_rng(2).standard_normal((total, cfg.feat_in))
             ).astype(np.float32)
    jd, pd = (jnp.float32, torch.float32) if state == "f32" else (jnp.bfloat16, torch.bfloat16)
    st_j = jenc.init_encoder_state(cfg_j, 1, dtype=jd)
    st_p, st_u = penc.init_encoder_state(cfg, 1, dtype=pd), penc.init_encoder_state(cfg, 1, dtype=pd)
    tq_steady = steady_tq(cfg)
    layers = penc.layer_params(params, cfg.num_layers)
    errs, errs_unrounded = [], []
    for spec in build_schedule(total, cfg):
        x = extract_chunk(feats, spec)
        valid = max(min(spec.slice_end, total) - max(spec.slice_start, 0), 0)
        tq = penc.subsampled_length(spec.frames, cfg.stride_stages) - spec.drop_extra
        att = bool(fused_att) and tq == tq_steady
        kw = dict(drop_extra=spec.drop_extra, cache_drop=0 if spec.is_last else cfg.cache_drop_size,
                  valid_cap=None if spec.is_last else cfg.valid_out_len)
        fk = dict(use_pallas_att=att, pad_steps=(-tq) % 8 if att else 0,
                  use_pallas_ffn=fused_att == "all", use_pallas_conv=fused_att == "all")
        enc_j, len_j, st_j = jenc.encode(params_j, cfg_j, x[None], np.array([valid], np.int32),
                                         st_j, **kw, **fk)
        enc_p, len_p, st_p = penc.encode(params, cfg, t(x[None]), torch.tensor([valid]), st_p,
                                         layers=layers, **kw, **fk)
        n = int(np.asarray(len_j)[0])
        assert int(len_p[0]) == n, f"chunk {spec.idx}"

        def gap(enc, st):
            e = np.abs(enc[0, :n].float().numpy() - np.asarray(enc_j, np.float32)[0, :n]).max()
            return max([float(e)] + [
                float(np.abs(getattr(st, k).float().numpy()
                             - np.asarray(getattr(st_j, k), np.float32)).max())
                for k in ("att_cache", "time_cache", "kv_cache")])

        errs.append(gap(enc_p, st_p))
        assert st_p.att_cache.dtype == pd
        if fused_att:
            enc_u, _, st_u = penc.encode(params, cfg, t(x[None]), torch.tensor([valid]), st_u,
                                         layers=layers, **kw)
            errs_unrounded.append(gap(enc_u, st_u))
    past = sum(e > ATOL for e in errs)
    assert past <= (BF16_FLIP_CHUNKS if fused_att else 0) and max(errs) <= BF16_FLIP_ATOL, errs
    if fused_att:
        assert sum(e > ATOL for e in errs_unrounded) > BF16_FLIP_CHUNKS, errs_unrounded


KERNELS = dict(use_pallas_att=True, use_pallas_ffn=True, use_pallas_conv=True)


@pytest.mark.parametrize("quant,flags", [
    ("none", KERNELS),                              # FFN kernel, conv_block[f32]
    ("encoder", KERNELS),                           # FFN1 kernel, fused conv+FFN2+LN tail
    ("encoder", dict(use_pallas_conv=True)),        # conv_block[int8]
])
def test_closed_loop_encode_with_ffn_conv_kernels_matches_jax(models, quant, flags,
                                                            monkeypatch):
    """Chunk 0, steady chunks (with the attention kernel: padded to 8 steps)
    and the flush chunk, every one through the FFN/conv kernels on both
    sides."""
    calls = spy_calls(monkeypatch, penc, ("fused_ffn", "conv_block", "conv_ffn_ln"))
    cfg_j, params_j, cfg, _ = models
    if quant != "none":
        params_j = j_quantize(params_j, quant)
    params = params_from_numpy(np_tree(params_j))
    total = 160
    feats = (0.5 * np.random.default_rng(2).standard_normal((total, cfg.feat_in))
             ).astype(np.float32)
    st_j, st_p = jenc.init_encoder_state(cfg_j, 1), penc.init_encoder_state(cfg, 1)
    tq_steady = steady_tq(cfg)
    sched = build_schedule(total, cfg)
    assert sched[-1].is_last and len({s.frames for s in sched}) > 1
    for spec in sched:
        x = extract_chunk(feats, spec)
        valid = max(min(spec.slice_end, total) - max(spec.slice_start, 0), 0)
        tq = penc.subsampled_length(spec.frames, cfg.stride_stages) - spec.drop_extra
        att = flags.get("use_pallas_att", False) and tq == tq_steady
        kw = dict(drop_extra=spec.drop_extra, cache_drop=0 if spec.is_last else cfg.cache_drop_size,
                  valid_cap=None if spec.is_last else cfg.valid_out_len,
                  use_pallas_ffn=flags.get("use_pallas_ffn", False),
                  use_pallas_conv=flags["use_pallas_conv"], use_pallas_att=att,
                  pad_steps=(-tq) % 8 if att else 0)
        enc_j, len_j, st_j = jenc.encode(params_j, cfg_j, x[None], np.array([valid], np.int32),
                                         st_j, **kw)
        enc_p, len_p, st_p = penc.encode(params, cfg, t(x[None]), torch.tensor([valid]), st_p,
                                         **kw)
        n = int(np.asarray(len_j)[0])
        assert int(len_p[0]) == n, f"chunk {spec.idx}"
        np.testing.assert_allclose(enc_p[0, :n].numpy(), np.asarray(enc_j)[0, :n],
                                   atol=ATOL, rtol=RTOL, err_msg=f"chunk {spec.idx}")
        for name in ("att_cache", "time_cache", "kv_cache"):
            np.testing.assert_allclose(getattr(st_p, name).numpy(),
                                       np.asarray(getattr(st_j, name)), atol=ATOL, rtol=RTOL,
                                       err_msg=f"chunk {spec.idx} {name}")
    per_chunk = len(sched) * cfg.num_layers
    tail = quant != "none" and "use_pallas_ffn" in flags
    assert calls == {"fused_ffn": (1 if tail else 2) * per_chunk if "use_pallas_ffn" in flags else 0,
                     "conv_block": 0 if tail else per_chunk,
                     "conv_ffn_ln": per_chunk if tail else 0}


def test_conv_kernel_needs_batch_one(models):
    _, _, cfg, params = models
    st = penc.init_encoder_state(cfg, 2)
    feats = torch.zeros((2, 57, cfg.feat_in))
    with pytest.raises(ValueError, match="B=1"):
        penc.encode(params, cfg, feats, torch.tensor([57, 57]), st, use_pallas_conv=True)


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
