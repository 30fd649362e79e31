"""The PyTorch port's device beam (``decode/beam_device.py``) against the
JAX package's ``tdt_beam_chunk_device`` and against the port's own host
beam, on ``ModelConfig.tiny()`` with seeded weights and encoder rows:
several chunks in a row with padded rows past the valid count (so that
hypotheses wait across chunk boundaries), beam 4 and beam 1, leading-punct
masking with a blank penalty, n-gram and biasing fusion, token-buffer
saturation, the batched core with an idle slot, slot resets, and
``_history_eq`` at the top of the full-width token range.

Tolerance: the state's int fields (tokens, counts, cursors, y_id, stamps'
frames and durations, saturation) exact; its f32 fields (scores, g, h, c,
stamp log-probs) 1e-5 plus 1e-6 relative (a score sums dozens of f32
terms: one f32 ulp at 62 is 3.8e-6); the n-best against the host beam: tokens, ranking
and stamps exact, scores 1e-4 (the host adds in f64)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.decode import init_decode_state as j_init_decode
from trt_asr_tpu.decode import prime_decode_state as j_prime_decode
from trt_asr_tpu.decode import beam_device as jbd
from trt_asr_tpu.decode.lm_device import to_device as j_to_device
from trt_asr_tpu.decode.ngram_lm import NGramLM as JNGram
from trt_asr_tpu.decode.biasing import BiasingLM as JBiasing
from trt_asr_tpu.models.parakeet import init_params
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.decode import beam_device as bd
from trt_asr_tpu_torch.decode.beam import (BeamSearchState, beam_advance, beam_finish,
                                           beam_start, make_host_fns)
from trt_asr_tpu_torch.decode.biasing import BiasingLM
from trt_asr_tpu_torch.decode.lm_device import to_device
from trt_asr_tpu_torch.decode.ngram_lm import NGramLM
from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state, prime_decode_state
from trt_asr_tpu_torch.models.parakeet.params import params_from_numpy

CHUNKS = (5, 3, 8, 1, 6)          # valid rows a chunk, each padded to T = 8
T_PAD = 8
INT_FIELDS = ("tokens", "n_tok", "cursor", "y_id", "frames", "durs", "frame_base",
              "emitted_base", "sat")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def tiny():
    cfg, jcfg = ModelConfig.tiny(), JConfig.tiny()
    jp = init_params(jcfg, seed=1)
    pp = params_from_numpy(np_tree(jp), "cpu")
    ds = prime_decode_state(pp, cfg, init_decode_state(cfg, 1), [])
    jds = j_prime_decode(jp, jcfg, j_init_decode(jcfg, 1), [])
    return cfg, jcfg, pp, jp, ds, jds


def assert_state_equal(got, want, where=""):
    for name in bd.BeamDeviceState._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.shape == b.shape, (where, name)
        if name in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {name}")
        else:
            assert (np.isfinite(a) == np.isfinite(b)).all(), (where, name)
            np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-6,
                                       atol=1e-5, err_msg=f"{where} {name}")


def _chunks(cfg, seed, scale=0.6):
    r = np.random.default_rng(seed)
    out = []
    for n in CHUNKS:
        enc = np.zeros((T_PAD, cfg.d_model), np.float32)
        enc[:n] = scale * r.standard_normal((n, cfg.d_model))
        enc[n:] = 9.0          # padded rows past the valid count must not be read
        out.append((enc, n))
    return out


def run_both(tiny, seed, beam, token_cap=64, lm=None, **kw):
    """Both device beams over the seeded chunks, state held equal after
    every chunk; returns the port's final state."""
    cfg, jcfg, pp, jp, ds, jds = tiny
    st = bd.init_beam_device_state(cfg, ds, beam=beam, token_cap=token_cap)
    jst = jbd.init_beam_device_state(jcfg, jds, beam=beam, token_cap=token_cap)
    assert_state_equal(st, jst, "init")
    pkw, jkw = dict(kw), dict(kw)
    if "punct_mask" in kw:
        pkw["punct_mask"] = torch.as_tensor(kw["punct_mask"])
    if lm is not None:
        pkw.update(zip(("lm_spec", "lm_tables"), to_device(lm[0])), lm_weight=lm[2])
        jkw.update(zip(("lm_spec", "lm_tables"), j_to_device(lm[1])), lm_weight=lm[2])
    for i, (enc, n) in enumerate(_chunks(cfg, seed)):
        st = bd.tdt_beam_chunk_device(pp, cfg, torch.as_tensor(enc), n, st, beam=beam,
                                      max_symbols=cfg.max_symbols_per_timestep, **pkw)
        jst = jbd.tdt_beam_chunk_device(jp, jcfg, enc, np.int32(n), jst, beam=beam,
                                        max_symbols=jcfg.max_symbols_per_timestep, **jkw)
        assert_state_equal(st, jst, f"chunk {i}")
    return st


def host_over_chunks(tiny, seed, beam, lm_fn=None, lm_weight=0.0, **kw):
    cfg, _, pp, _, ds, _ = tiny
    j_fn, p_fn, j_batch = make_host_fns(pp, "cpu", joint_rows=beam,
                                        pred_rows=beam * (4 if beam > 1 else 1))
    bs = beam_start(ds.g[0].numpy(), int(ds.y_id[0]), (ds.h, ds.c))
    for enc, n in _chunks(cfg, seed):
        bs = beam_advance(bs, enc[:n], j_fn, p_fn, blank_id=cfg.blank_id,
                          token_head_size=cfg.token_head_size,
                          duration_values=cfg.duration_values, beam=beam,
                          max_symbols=cfg.max_symbols_per_timestep, lm_fn=lm_fn,
                          lm_weight=lm_weight, joint_batch_fn=j_batch, **kw)
    return beam_finish(bs, beam=beam)


def assert_nbest_equal(got, want, atol=1e-4):
    assert [h.tokens for h in got] == [h.tokens for h in want]
    for a, b in zip(got, want):
        assert a.score == pytest.approx(b.score, abs=atol), a.tokens
        assert [s[:2] for s in a.stamps] == [s[:2] for s in b.stamps]


def device_nbest(st, beam):
    return beam_finish(BeamSearchState(active=bd.beam_device_to_hypotheses(st)), beam=beam)


@pytest.mark.parametrize("seed,beam", [(0, 4), (1, 4), (2, 1)])
def test_chunks_match_jax_and_host_beam(tiny, seed, beam):
    st = run_both(tiny, seed, beam)
    dev = device_nbest(st, beam)
    assert_nbest_equal(dev, host_over_chunks(tiny, seed, beam))
    assert dev[0].tokens and int(st.frame_base) == sum(CHUNKS)


def test_punct_mask_and_blank_penalty_match_jax(tiny):
    cfg = tiny[0]
    mask = np.zeros(cfg.token_head_size, bool)
    mask[::3] = True
    mask[cfg.blank_id] = False
    st = run_both(tiny, 3, 4, punct_mask=mask, use_punct_mask=True, blank_penalty=0.8)
    host = host_over_chunks(tiny, 3, 4, punct_token_ids=set(np.flatnonzero(mask).tolist()),
                            blank_penalty=0.8)
    dev = device_nbest(st, 4)
    assert_nbest_equal(dev, host)
    assert all(not mask[h.tokens[0]] for h in dev if h.tokens)


@pytest.mark.parametrize("kind", ["ngram", "bias"])
def test_fusion_matches_jax_and_host(tiny, kind):
    cfg = tiny[0]
    if kind == "ngram":
        r = np.random.default_rng(4)
        seqs = [r.integers(0, cfg.vocab_size, size=8).tolist() for _ in range(40)]
        lm = (NGramLM.fit(seqs, vocab_size=cfg.vocab_size),
              JNGram.fit(seqs, vocab_size=cfg.vocab_size), 0.6)
    else:
        cont = {(): {3, 7}, (3,): {11}, (3, 11): {20}}
        lm = (BiasingLM(cont, 2, 2.0, cfg.vocab_size), JBiasing(cont, 2, 2.0, cfg.vocab_size),
              1.0)
    st = run_both(tiny, 5, 4, lm=lm)
    assert_nbest_equal(device_nbest(st, 4),
                       host_over_chunks(tiny, 5, 4, lm_fn=lm[0], lm_weight=lm[2]))


@pytest.mark.parametrize("beam", [1, 4])
def test_saturation_matches_jax(tiny, beam):
    """A token buffer of 2: the head is kept, the flag latches, the search
    goes on (scores and predictor state advance as JAX's)."""
    st = run_both(tiny, 1, beam, token_cap=2)
    live = torch.isfinite(st.score)
    assert bool((st.sat & live).any()) and int(st.n_tok.max()) == 2
    full = host_over_chunks(tiny, 1, beam)[0].tokens
    best = int(torch.argmax(st.score))
    if beam == 1:
        assert st.tokens[best].tolist() == full[:2]


def test_batched_core_idle_slot_and_reset_match_jax(tiny):
    """Three streams in one call, the middle one idle (t_enc 0: its rows
    untouched), against JAX's vmapped core; then a row reset."""
    cfg, jcfg, pp, jp, _, _ = tiny
    S, K = 3, 4
    ds = prime_decode_state(pp, cfg, init_decode_state(cfg, S), [])
    jds = j_prime_decode(jp, jcfg, j_init_decode(jcfg, S), [])
    st = bd.init_beam_device_state_batch(cfg, ds, beam=K, token_cap=32)
    jst = jbd.init_beam_device_state_batch(jcfg, jds, beam=K, token_cap=32)
    r = np.random.default_rng(8)
    for step in range(3):
        enc = (0.6 * r.standard_normal((S, T_PAD, cfg.d_model))).astype(np.float32)
        t_enc = np.array([T_PAD, 0, 5 - step], np.int32)
        before = st
        st = bd.tdt_beam_chunk_device_batch(pp, cfg, torch.as_tensor(enc),
                                            torch.as_tensor(t_enc), st, beam=K,
                                            max_symbols=cfg.max_symbols_per_timestep)
        jst = jbd.tdt_beam_chunk_device_batch(jp, jcfg, enc, t_enc, jst, beam=K,
                                              max_symbols=jcfg.max_symbols_per_timestep)
        assert_state_equal(st, jst, f"step {step}")
        for a, b in zip(st, before):
            assert torch.equal(a[1], b[1])                  # the idle slot
    mask = np.array([True, False, False])
    st = bd.reset_beam_device_state_rows(st, torch.as_tensor(mask), cfg, ds, beam=K,
                                         token_cap=32)
    jst = jbd.reset_beam_device_state_rows(jst, mask, jcfg, jds, beam=K, token_cap=32)
    assert_state_equal(st, jst, "reset")
    for row in range(S):
        got = bd.beam_device_row_to_hypotheses(st, row)
        want = jbd.beam_device_row_to_hypotheses(jst, row)
        assert [(h.tokens, h.cursor, [x[:2] for x in h.stamps]) for h in got] == \
               [(h.tokens, h.cursor, [x[:2] for x in h.stamps]) for h in want]


def test_history_eq_exact_at_the_top_of_the_token_range():
    """Full-width ids (id + 1 up to 8194) over L = 512: the split Gram
    products give exact equality, as elementwise comparison does."""
    r = np.random.default_rng(0)
    L, Pn = 512, 24
    toks = np.full((Pn, L), -1, np.int32)
    n = r.integers(L - 8, L + 1, size=Pn).astype(np.int32)
    base = r.integers(8100, 8194, size=L).astype(np.int32)
    for i in range(Pn):
        toks[i, :n[i]] = base[:n[i]]
    toks[3, 100] = 8193
    toks[5, n[5] - 1] = 8192 - (toks[5, n[5] - 1] == 8192)     # one last token off
    toks[7] = toks[8]
    n[7] = n[8]
    toks[9, 0] = 0                                             # 0 .. 8193 both ends
    got = bd._history_eq(torch.as_tensor(toks), torch.as_tensor(n), torch.as_tensor(toks),
                         torch.as_tensor(n)).numpy()
    want = (n[:, None] == n[None, :]) & (toks[:, None, :] == toks[None, :, :]).all(-1)
    np.testing.assert_array_equal(got, want)
    assert got[7, 8] and not got[3].sum() > 1
    got_b = bd._history_eq(torch.as_tensor(toks)[None], torch.as_tensor(n)[None],
                           torch.as_tensor(toks)[None], torch.as_tensor(n)[None])[0].numpy()
    np.testing.assert_array_equal(got_b, want)
