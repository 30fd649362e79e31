"""Greedy TDT decode of the PyTorch port against the JAX package: decode
state priming, the predictor and joint, and ``tdt_greedy_decode_batch`` in
both regimes (blank-run, B*T <= 256, and per-row, B*T > 256), chained over
two chunks through ``time_carry``, with the blank penalty, the leading-punct
mask, the ``max_symbols`` cap and timestamps; the blank-run regime also with
the fused joint step (its plain version on CPU tensors).

Tolerance: tokens, counts, frames, durations and time_carry exact; decode
log-probs 1e-4 and predictor state 1e-5 absolute."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, t

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.decode import batched as jbat
from trt_asr_tpu.decode import tdt_greedy as jtdt
from trt_asr_tpu.models.parakeet import joint as jjoint
from trt_asr_tpu.models.parakeet.params import init_params as j_init
from trt_asr_tpu.models.parakeet.predictor import predictor_step as j_pred
from trt_asr_tpu.models.parakeet.quant import quantize_params as j_quantize
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.decode import tdt_greedy as ptdt
from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch
from trt_asr_tpu_torch.models.parakeet import joint as pjoint
from trt_asr_tpu_torch.models.parakeet.params import params_from_numpy
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step

ATOL = 1e-5
PROMPT = [5, 17]


@pytest.fixture(scope="module")
def models():
    cfg_j = JConfig.tiny()
    params_j = j_init(cfg_j, seed=8)
    return cfg_j, params_j, ModelConfig.tiny(), params_from_numpy(np_tree(params_j))


def close_state(sp, sj):
    for name in sj._fields:
        np.testing.assert_allclose(getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                                   atol=ATOL, err_msg=name)


def test_predictor_joint_and_priming_match_jax(models):
    cfg_j, params_j, cfg, params = models
    rng = np.random.default_rng(0)
    y = np.array([0, 3, cfg.blank_id], np.int32)
    h = rng.standard_normal((cfg.pred_rnn_layers, 3, cfg.pred_hidden)).astype(np.float32)
    c = rng.standard_normal(h.shape).astype(np.float32)
    for got, want in zip(predictor_step(params["predictor"], t(y), t(h), t(c)),
                         j_pred(params_j["predictor"], jnp.asarray(y), h, c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    enc = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 5, cfg.pred_hidden)).astype(np.float32)
    ep = pjoint.joint_project_enc(params["joint"], t(enc))
    np.testing.assert_allclose(ep.numpy(), np.asarray(jjoint.joint_project_enc(params_j["joint"], enc)),
                               atol=ATOL)
    np.testing.assert_allclose(
        pjoint.joint_from_projected(params["joint"], ep, t(g)).numpy(),
        np.asarray(jjoint.joint_from_projected(params_j["joint"], jnp.asarray(ep.numpy()), g)),
        atol=ATOL)
    for prompt in ([], PROMPT):
        sp = ptdt.prime_decode_state(params, cfg, ptdt.init_decode_state(cfg, 2), prompt)
        sj = jtdt.prime_decode_state(params_j, cfg_j, jtdt.init_decode_state(cfg_j, 2), prompt)
        close_state(sp, sj)


def run_both(models, b, tq, *, penalty, punct, quant=False, kernel=False, chunks=2,
             max_symbols=None, seed=0):
    cfg_j, params_j, cfg, params = models
    if quant:
        params_j = j_quantize(params_j, "all")
        params = params_from_numpy(np_tree(params_j))
    rng = np.random.default_rng(seed)
    pmask = np.zeros(cfg.token_head_size, bool)
    pmask[rng.integers(0, cfg.vocab_size, size=cfg.vocab_size // 3)] = True
    sj = jtdt.prime_decode_state(params_j, cfg_j, jtdt.init_decode_state(cfg_j, b), PROMPT)
    sp = ptdt.prime_decode_state(params, cfg, ptdt.init_decode_state(cfg, b), PROMPT)
    emitted = np.zeros(b, np.int32)
    n_total = max_carry = 0
    for _ in range(chunks):
        enc = (rng.standard_normal((b, tq, cfg.d_model)) * 1.5).astype(np.float32)
        t_enc = rng.integers(tq // 2, tq + 1, size=b).astype(np.int32)
        kw = dict(max_tokens=cfg.max_symbols_per_timestep * tq, max_symbols=max_symbols,
                  blank_penalty=penalty, use_punct_mask=punct, with_timestamps=True)
        tj, nj, sj, (fj, dj, lj) = jbat.tdt_greedy_decode_batch(
            params_j, cfg_j, jnp.asarray(enc), jnp.asarray(t_enc), sj,
            emitted_so_far=jnp.asarray(emitted), punct_mask=jnp.asarray(pmask), **kw)
        tp, np_, sp, (fp, dp, lp) = tdt_greedy_decode_batch(
            params, cfg, t(enc), t(t_enc), sp, emitted_so_far=emitted,
            punct_mask=torch.as_tensor(pmask), use_pallas_joint=kernel, **kw)
        np.testing.assert_array_equal(np_.numpy(), np.asarray(nj))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
        np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=1e-4)
        np.testing.assert_array_equal(sp.time_carry.numpy(), np.asarray(sj.time_carry))
        np.testing.assert_array_equal(sp.y_id.numpy(), np.asarray(sj.y_id))
        close_state(sp, sj)
        emitted = emitted + np.asarray(nj)
        n_total += int(np.asarray(nj).sum())
        max_carry = max(max_carry, int(sp.time_carry.max()))
    return n_total, max_carry


@pytest.mark.parametrize("penalty,punct,kernel", [(0.0, False, False), (0.0, False, True),
                                                  (1.5, True, False), (1.5, True, True)])
def test_blank_run_regime_matches_jax(models, penalty, punct, kernel):
    n, _ = run_both(models, b=2, tq=8, penalty=penalty, punct=punct, kernel=kernel)
    assert n > 0


def test_blank_run_regime_int8_with_kernel(models):
    n, _ = run_both(models, b=1, tq=8, penalty=0.5, punct=True, quant=True, kernel=True, seed=3)
    assert n > 0


@pytest.mark.parametrize("penalty,punct", [(0.0, False), (1.5, True)])
def test_per_row_regime_matches_jax(models, penalty, punct):
    n, _ = run_both(models, b=4, tq=70, penalty=penalty, punct=punct, seed=1)
    assert n > 0


def test_max_symbols_cap_and_time_carry(models):
    """max_symbols=1 forces an advance on every emission; a duration jump
    past the chunk end carries into the next chunk."""
    n, max_carry = run_both(models, b=2, tq=6, penalty=-2.0, punct=False, max_symbols=1,
                            chunks=3, seed=2)
    assert n > 0 and max_carry > 0
