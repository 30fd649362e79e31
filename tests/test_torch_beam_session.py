"""The PyTorch port's ``BeamStreamingSession`` against the JAX package's,
host and device search, on ``ModelConfig.tiny()`` (the same seeded weights
on both sides) and on the trained gate_r3: the events (partials paced at
0 ms on both sides, so that the wall clock does not decide which are
sent), ``stable_text`` mid-stream, the n-best after finalize and the word
timestamps; beam = 1 against the greedy session; the device search with an
n-gram LM and with biasing against JAX's and against the port's host
search; the token-cap ERROR event, sent once; and the refusals.

Tolerance: tokens, events, ranking and timestamps exact; scores 1e-4."""

import numpy as np
import pytest

from torch_port_helpers import GATE_R3, np_tree, synth_audio, one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.decode.biasing import make_biasing_lm as j_make_biasing
from trt_asr_tpu.decode.ngram_lm import NGramLM as JNGram
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.beam_session import BeamStreamingSession as JBeamSession
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.decode.biasing import make_biasing_lm
from trt_asr_tpu_torch.decode.ngram_lm import NGramLM
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession
from trt_asr_tpu_torch.streaming.session import StreamingSession
from trt_asr_tpu_torch.tokenizer import Tokenizer

RT = dict(suppress_leading_punct=True, partial_min_interval_ms=0)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    jm = JModel.random(JConfig.tiny(), seed=6)
    jm.runtime = JRuntime(**RT)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                     Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                     runtime=RuntimeConfig(**RT), device="cpu")
    return jm, pm


def _audio(n=36000, seed=0):
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * 320 * np.arange(n) / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def drive(sess, audio, piece=8000):
    """Push ``audio`` in pieces, read ``stable_text`` midway, finalize;
    returns (events, stable text midway, n-best, word timestamps)."""
    events, stable = [], None
    for i in range(0, len(audio), piece):
        sess.push_audio(audio[i:i + piece])
        if i >= len(audio) // 2 and stable is None:
            stable = sess.stable_text
    sess.finalize()
    while (ev := sess.poll_event()) is not None:
        events.append((int(ev.type), ev.segment_id, ev.text, list(ev.tokens), ev.error_message))
    return events, stable, sess.nbest(), sess.word_timestamps()


def assert_same(got, want):
    (ev, stable, nbest, words), (jev, jstable, jnbest, jwords) = got, want
    assert ev == jev and stable == jstable and words == jwords
    assert [n[:2] for n in nbest] == [n[:2] for n in jnbest]
    np.testing.assert_allclose([n[2] for n in nbest], [n[2] for n in jnbest], atol=1e-4)


@pytest.mark.parametrize("device", [False, True])
def test_session_matches_jax(models, device):
    jm, pm = models
    audio = _audio()
    got = drive(BeamStreamingSession(pm, beam=4, device=device), audio)
    want = drive(JBeamSession(jm, beam=4, device=device, runtime=JRuntime(**RT)), audio)
    assert_same(got, want)
    assert got[2][0][1] and len(got[2]) == 4 and got[0][-1][0] == 1


@pytest.mark.parametrize("device", [False, True])
def test_beam1_equals_greedy_session(models, device):
    pm = models[1]
    audio = _audio(seed=3)
    greedy = StreamingSession(pm)
    for i in range(0, len(audio), 8000):
        greedy.push_audio(audio[i:i + 8000])
    greedy.finalize()
    _, _, nbest, _ = drive(BeamStreamingSession(pm, beam=1, device=device), audio)
    assert nbest[0][1] == greedy.tokens and greedy.tokens


@pytest.mark.parametrize("kind", ["ngram", "bias"])
def test_device_fusion_matches_jax_and_host(models, kind):
    jm, pm = models
    if kind == "ngram":
        r = np.random.default_rng(2)
        seqs = [r.integers(0, 64, size=10).tolist() for _ in range(40)]
        lm, jlm, w = NGramLM.fit(seqs, vocab_size=65), JNGram.fit(seqs, vocab_size=65), 0.6
    else:
        phrases = [pm.tokenizer.decode([7, 12]), pm.tokenizer.decode([30])]
        lm, jlm, w = (make_biasing_lm(phrases, pm.tokenizer),
                      j_make_biasing(phrases, jm.tokenizer), 1.0)
    audio = _audio(seed=4)
    got = drive(BeamStreamingSession(pm, beam=4, device=True, lm_fn=lm, lm_weight=w), audio)
    want = drive(JBeamSession(jm, beam=4, device=True, lm_fn=jlm, lm_weight=w,
                              runtime=JRuntime(**RT)), audio)
    assert_same(got, want)
    host = drive(BeamStreamingSession(pm, beam=4, lm_fn=lm, lm_weight=w), audio)
    assert [n[1] for n in host[2]] == [n[1] for n in got[2]]


def test_token_cap_error_once_and_refusals(models):
    jm, pm = models
    audio = _audio(seed=1)
    got = drive(BeamStreamingSession(pm, beam=4, device=True, token_cap=2), audio)
    want = drive(JBeamSession(jm, beam=4, device=True, token_cap=2, runtime=JRuntime(**RT)),
                 audio)
    assert_same(got, want)
    errors = [e for e in got[0] if e[0] == 2]
    assert len(errors) == 1 and "token_cap=2 saturated" in errors[0][4]
    with pytest.raises(ValueError, match="NGramLM / BiasingLM"):
        BeamStreamingSession(pm, beam=4, device=True, lm_fn=lambda p, t: 0.0)
    with pytest.raises(NotImplementedError):
        BeamStreamingSession(pm, beam=2).snapshot()


@pytest.mark.parametrize("device", [False, True])
def test_gate_r3_session_matches_jax(device):
    """The trained gate_r3 with an LM fitted from its words: the n-best,
    events and timestamps of both packages."""
    rt = dict(partial_min_interval_ms=0)
    jm = JModel.from_model_dir(GATE_R3, runtime=JRuntime(**rt))
    pm = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(**rt), device="cpu")
    words = ["baba daba faba", "gaba haba faba baba"]
    lm = NGramLM.fit([pm.tokenizer.encode(w) for w in words], vocab_size=1120)
    jlm = JNGram.fit([jm.tokenizer.encode(w) for w in words], vocab_size=1120)
    audio = synth_audio(seed=33, words=5)
    got = drive(BeamStreamingSession(pm, beam=4, device=device, lm_fn=lm, lm_weight=0.6),
                audio)
    want = drive(JBeamSession(jm, beam=4, device=device, lm_fn=jlm, lm_weight=0.6,
                              runtime=JRuntime(**rt)), audio)
    assert_same(got, want)
    assert len(got[2][0][1]) == 5
