"""The PyTorch port's host beam and its LMs against the JAX package's:
``decode/ngram_lm.py`` (fit, score, sentence_logp, and one v1 JSON file
read by both), ``decode/biasing.py`` on gate_r3's tokenizer,
``decode/beam.py`` (``tdt_beam_decode_host`` over the same seeded weights
and encoder rows, with and without fusion) and
``ParakeetTDT.transcribe_offline_beam`` on ``ModelConfig.tiny()`` and on
the trained gate_r3. Also beam = 1 against the port's greedy decoder and
``make_host_fns``'s batched joint against its single-row joint.

Tolerance: tokens, ranking and emission frames and durations exact;
scores 1e-5 (f32 joints summed in another order; the search adds them in
f64); LM scores exact (the same f64 Python on both sides)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, np_tree, synth_audio, one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.decode import init_decode_state as j_init_decode
from trt_asr_tpu.decode import prime_decode_state as j_prime_decode
from trt_asr_tpu.decode.beam import make_host_fns as j_make_host_fns
from trt_asr_tpu.decode.beam import tdt_beam_decode_host as j_beam_host
from trt_asr_tpu.decode.biasing import make_biasing_lm as j_make_biasing
from trt_asr_tpu.decode.ngram_lm import NGramLM as JNGram
from trt_asr_tpu.decode.ngram_lm import fit_from_text as j_fit_from_text
from trt_asr_tpu.models.parakeet import init_params
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.tokenizer import Tokenizer as JTokenizer
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.decode.beam import make_host_fns, tdt_beam_decode_host
from trt_asr_tpu_torch.decode.biasing import make_biasing_lm
from trt_asr_tpu_torch.decode.ngram_lm import NGramLM, fit_from_text
from trt_asr_tpu_torch.decode.tdt_greedy import (init_decode_state, prime_decode_state,
                                                 tdt_greedy_decode_chunk)
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import params_from_numpy
from trt_asr_tpu_torch.tokenizer import Tokenizer

GATE_WORDS = ["baba daba faba", "gaba haba", "faba baba gaba haba", "jaba kaba laba"]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _seqs(seed, vocab=64, n=40):
    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=r.integers(2, 14)).tolist() for _ in range(n)]


def assert_nbest_equal(got, want, atol=1e-5):
    """Hypothesis lists: tokens and ranking exact, stamps' frames and
    durations exact, scores and stamp log-probs within ``atol``."""
    assert [h.tokens for h in got] == [h.tokens for h in want]
    for a, b in zip(got, want):
        assert a.score == pytest.approx(b.score, abs=atol), a.tokens
        assert [s[:2] for s in a.stamps] == [s[:2] for s in b.stamps]
        np.testing.assert_allclose([s[2] for s in a.stamps], [s[2] for s in b.stamps],
                                   atol=atol)


@pytest.mark.parametrize("order", [2, 3])
def test_ngram_fit_score_and_one_file_match_jax(order, tmp_path):
    seqs = _seqs(order)
    lm, jl = NGramLM.fit(seqs, order=order), JNGram.fit(seqs, order=order)
    assert (lm.vocab_size, lm.counts, lm.totals) == (jl.vocab_size, jl.counts, jl.totals)
    r = np.random.default_rng(9)
    for _ in range(60):
        prefix = r.integers(0, 70, size=r.integers(0, 6)).tolist()
        t = int(r.integers(0, 70))
        assert lm.score(prefix, t) == jl.score(prefix, t) == lm(prefix, t)
    assert lm.sentence_logp(seqs[0]) == jl.sentence_logp(seqs[0])
    # one file serves both packages, either way round
    lm.save(tmp_path / "port.json")
    jl.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back, jback = NGramLM.load(tmp_path / "jax.json"), JNGram.load(tmp_path / "port.json")
    assert back.counts == jback.counts == lm.counts
    assert back.score([1, 2], 3) == jback.score([1, 2], 3)
    (tmp_path / "bad.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="not an ngram-lm/v1 file"):
        NGramLM.load(tmp_path / "bad.json")


def test_fit_from_text_and_biasing_match_jax_on_gate_r3():
    """gate_r3's tokenizer: the LM fitted from text and the biasing trie
    (a phrase the vocab cannot encode is dropped) equal JAX's."""
    vocab = f"{GATE_R3}/vocab.txt"
    tok, jtok = Tokenizer.from_file(vocab, blank_id=1120), JTokenizer.from_file(vocab,
                                                                               blank_id=1120)
    lm, jl = fit_from_text(GATE_WORDS, tok), j_fit_from_text(GATE_WORDS, jtok)
    assert (lm.counts, lm.vocab_size) == (jl.counts, jl.vocab_size) and lm.vocab_size == 1120
    phrases = GATE_WORDS[:2] + ["qqq"]
    bias, jbias = make_biasing_lm(phrases, tok, bonus=2.5), j_make_biasing(phrases, jtok,
                                                                          bonus=2.5)
    assert (bias.cont, bias.max_pfx, bias.bonus, bias.vocab_size) == (
        jbias.cont, jbias.max_pfx, jbias.bonus, jbias.vocab_size)
    ids = tok.encode(GATE_WORDS[0])
    assert bias([], ids[0]) == bias(ids[:1], ids[1]) == 2.5 and bias([5], 9) == 0.0
    r = np.random.default_rng(3)
    for _ in range(100):
        prefix = r.integers(0, 8, size=r.integers(0, 4)).tolist()
        t = int(r.integers(0, 8))
        assert bias(prefix, t) == jbias(prefix, t)


@pytest.fixture(scope="module")
def tiny():
    """Seeded tiny weights in both packages, their primed decode states and
    host callables (the port's padded to the device beam's row counts)."""
    cfg, jcfg = ModelConfig.tiny(), JConfig.tiny()
    jp = init_params(jcfg, seed=3)
    pp = params_from_numpy(np_tree(jp), "cpu")
    ds = prime_decode_state(pp, cfg, init_decode_state(cfg, 1), [])
    jds = j_prime_decode(jp, jcfg, j_init_decode(jcfg, 1), [])
    return cfg, pp, ds, jp, jds


def _host(cfg, pp, ds, enc, beam, **kw):
    j_fn, p_fn, j_batch = make_host_fns(pp, "cpu", joint_rows=beam,
                                        pred_rows=beam * (4 if beam > 1 else 1))
    return tdt_beam_decode_host(
        enc, j_fn, p_fn, (ds.h, ds.c), ds.g[0].numpy(), int(ds.y_id[0]),
        blank_id=cfg.blank_id, token_head_size=cfg.token_head_size,
        duration_values=cfg.duration_values, beam=beam,
        max_symbols=cfg.max_symbols_per_timestep, joint_batch_fn=j_batch, **kw)


def _jax_host(cfg, jp, jds, enc, beam, **kw):
    j_fn, p_fn, j_batch = j_make_host_fns(jp)
    return j_beam_host(
        enc, j_fn, p_fn, (jds.h, jds.c), np.asarray(jds.g)[0], int(np.asarray(jds.y_id)[0]),
        blank_id=cfg.blank_id, token_head_size=cfg.token_head_size,
        duration_values=cfg.duration_values, beam=beam,
        max_symbols=cfg.max_symbols_per_timestep, joint_batch_fn=j_batch, **kw)


@pytest.mark.parametrize("seed,beam,fusion", [(0, 4, None), (1, 4, None), (2, 1, None),
                                              (3, 4, "ngram"), (4, 2, "penalty")])
def test_host_beam_matches_jax(tiny, seed, beam, fusion):
    cfg, pp, ds, jp, jds = tiny
    enc = (0.6 * np.random.default_rng(seed).standard_normal((12, cfg.d_model))).astype(
        np.float32)
    kw, jkw = {}, {}
    if fusion == "ngram":
        kw = dict(lm_fn=NGramLM.fit(_seqs(seed)), lm_weight=0.6)
        jkw = dict(lm_fn=JNGram.fit(_seqs(seed)), lm_weight=0.6)
    elif fusion == "penalty":
        kw = jkw = dict(blank_penalty=0.7, punct_token_ids={5, 9, 17}, length_norm=0.5)
    got = _host(cfg, pp, ds, enc, beam, **kw)
    want = _jax_host(cfg, jp, jds, enc, beam, **jkw)
    assert_nbest_equal(got, want)
    assert got[0].tokens and len(got) == (1 if beam == 1 else beam)


def test_beam1_equals_greedy_and_batched_joint_rows(tiny):
    """beam = 1 is the greedy decoder token for token; ``j_batch`` equals
    ``j_fn`` row for row, bit for bit."""
    cfg, pp, ds, _, _ = tiny
    for seed in (5, 6, 7):
        enc = (0.6 * np.random.default_rng(seed).standard_normal((14, cfg.d_model))).astype(
            np.float32)
        toks, n, _ = tdt_greedy_decode_chunk(pp, cfg, torch.as_tensor(enc), 14, ds,
                                             max_tokens=cfg.max_symbols_per_timestep * 14)
        hyp = _host(cfg, pp, ds, enc, 1)
        assert hyp[0].tokens == toks[:int(n)].tolist() and hyp[0].tokens
    j_fn, _, j_batch = make_host_fns(pp, "cpu", joint_rows=4)
    r = np.random.default_rng(0)
    enc_t = r.standard_normal(cfg.d_model).astype(np.float32)
    G = r.standard_normal((3, cfg.pred_hidden)).astype(np.float32)
    rows = j_batch(enc_t, G)
    for i in range(3):
        np.testing.assert_array_equal(rows[i], j_fn(enc_t, G[i]))


@pytest.mark.parametrize("where", ["tiny", "gate_r3"])
def test_offline_beam_matches_jax(where):
    """``transcribe_offline_beam`` (the n-best and its scores) on the same
    audio: random tiny weights with leading-punct suppression on, and the
    trained gate_r3 with an LM fitted from its words and with biasing."""
    rt = dict(suppress_leading_punct=True)
    if where == "tiny":
        jm = JModel.random(JConfig.tiny(), seed=4)
        jm.runtime = JRuntime(**rt)
        pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                         Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                         runtime=RuntimeConfig(**rt), device="cpu")
        rng = np.random.default_rng(2)
        audio = (0.4 * np.sin(2 * np.pi * 300 * np.arange(24000) / 16000)
                 + 0.1 * rng.standard_normal(24000)).astype(np.float32)
        cases = [({}, {})]
    else:
        jm = JModel.from_model_dir(GATE_R3, runtime=JRuntime(**rt))
        pm = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(**rt), device="cpu")
        audio = synth_audio(seed=31, words=5)
        cases = [({}, {}),
                 (dict(lm_fn=fit_from_text(GATE_WORDS, pm.tokenizer), lm_weight=0.6),
                  dict(lm_fn=j_fit_from_text(GATE_WORDS, jm.tokenizer), lm_weight=0.6)),
                 (dict(lm_fn=make_biasing_lm(GATE_WORDS[:2], pm.tokenizer), lm_weight=1.0),
                  dict(lm_fn=j_make_biasing(GATE_WORDS[:2], jm.tokenizer), lm_weight=1.0))]
    for kw, jkw in cases:
        got = pm.transcribe_offline_beam(audio, beam=4, norm="none", **kw)
        want = jm.transcribe_offline_beam(audio, beam=4, norm="none", **jkw)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], atol=1e-4)
        assert got[0][1]
    # beam 1 is the greedy offline decode
    assert pm.transcribe_offline_beam(audio, beam=1, norm="none")[0][1] == \
        pm.transcribe_offline(audio, norm="none")[1]
