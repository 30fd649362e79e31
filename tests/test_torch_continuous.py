"""Continuous transcription of the PyTorch port (``streaming/continuous.py``)
against the JAX package's on ``ModelConfig.tiny()``, the same weights on
both sides: the endpoint detector's events equal JAX's for any push size,
and the transcriber's segments (text, tokens, times, words) equal JAX's
over the JAX session and a dedicated port session fed each segment's
samples. The greedy cases of ``tests/test_continuous.py``: push sizes,
a flush mid-speech, the per_feature refusal, the pre-roll, and a flushed
segment's end matching the samples fed. Also the session's
``stable_text`` and ``set_debug_context``.

Tolerance: none. Events, samples, tokens, texts and times are exact."""

import numpy as np
import pytest

from torch_port_helpers import np_tree

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.continuous import ContinuousTranscriber as JTranscriber
from trt_asr_tpu.streaming.continuous import EndpointDetector as JDetector
from trt_asr_tpu.streaming.session import StreamingSession as JSession
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.continuous import HOP, ContinuousTranscriber, EndpointDetector
from trt_asr_tpu_torch.streaming.session import StreamingSession
from trt_asr_tpu_torch.tokenizer import Tokenizer


@pytest.fixture(scope="module")
def models():
    jm = JModel.random(JConfig.tiny(), seed=5)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                     Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                     runtime=RuntimeConfig(), device="cpu")
    return jm, pm


def _speech(n, f, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * f * t / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _stream():
    """1 s silence | 0.8 s speech | 1 s silence | 0.8 s speech | 1 s silence."""
    z = np.zeros(16000, np.float32)
    return np.concatenate([z, _speech(12800, 300, 0), z, _speech(12800, 440, 1), z])


def _run(session, audio, chunk, cls=ContinuousTranscriber):
    ct = cls(session)
    for s in range(0, len(audio), chunk):
        ct.push_audio(audio[s:s + chunk])
    ct.flush()
    return ct.segments


def _events(det, audio, chunk):
    out = []
    for s in range(0, len(audio), chunk):
        for kind, payload in det.feed(audio[s:s + chunk]):
            if kind == "onset":
                out.append((kind, payload[0].tolist(), payload[1]))
            elif kind == "speech":
                out.append((kind, payload.tolist()))
            else:
                out.append((kind, payload))
    return out, det.pending_end, det.flush()


@pytest.mark.parametrize("chunk", [1000, 7900, None])
def test_endpoint_detector_events_match_jax(chunk):
    audio = np.concatenate([_stream(), _speech(5000, 350, 2)])    # ends mid-speech
    chunk = chunk or len(audio)
    kw = dict(silence_s=0.5, min_speech_s=0.15, preroll_s=0.1)
    got = _events(EndpointDetector(**kw), audio, chunk)
    want = _events(JDetector(**kw), audio, chunk)
    assert got == want
    kinds = [e[0] for e in got[0]]
    assert kinds.count("onset") == 3 and kinds.count("endpoint") == 2
    assert got[1] == got[2] is not None


def _key(segs):
    return [(s["text"], list(s["tokens"]), s["start_s"], s["end_s"], s["words"]) for s in segs]


def test_segments_match_jax_and_dedicated_sessions(models):
    jm, pm = models
    audio = _stream()
    got = _run(StreamingSession(pm, RuntimeConfig()), audio, 4000)
    want = _run(JSession(jm, JRuntime()), audio, 4000, cls=JTranscriber)
    assert _key(got) == _key(want)
    assert len(got) == 2 and any(s["tokens"] for s in got), "degenerate: no tokens"
    assert 0.7 <= got[0]["start_s"] <= 1.02 and got[0]["end_s"] >= 1.8
    assert 2.5 <= got[1]["start_s"] <= 2.82 and got[1]["end_s"] >= 3.6
    for seg in got:
        a, b = int(round(seg["start_s"] * 16000)), int(round(seg["end_s"] * 16000))
        ref = StreamingSession(pm, RuntimeConfig())
        ref.push_audio(audio[a:b])
        ref.finalize()
        assert seg["tokens"] == ref.tokens and seg["text"] == ref.text


def test_push_granularity_invariance(models):
    audio = _stream()
    runs = [_run(StreamingSession(models[1], RuntimeConfig()), audio, c)
            for c in (1000, 7900, len(audio))]        # 7900: not a multiple of a hop
    assert _key(runs[0]) == _key(runs[1]) == _key(runs[2])
    assert len(runs[0]) == 2


def test_flush_midspeech_and_norm_rejection(models):
    pm = models[1]
    audio = np.concatenate([np.zeros(16000, np.float32), _speech(12800, 300, 0)])
    ct = ContinuousTranscriber(StreamingSession(pm, RuntimeConfig()))
    ct.push_audio(audio)
    assert ct.segments == []          # no endpoint without trailing silence
    assert ct.flush() == 1 and ct.flush() == 0
    assert len(ct.segments) == 1 and ct.segments[0]["end_s"] > 1.0
    stats = (np.zeros(pm.cfg.feat_in, np.float32), np.ones(pm.cfg.feat_in, np.float32))
    with pytest.raises(ValueError, match="per_feature"):
        ContinuousTranscriber(StreamingSession(pm, RuntimeConfig(), feature_norm="per_feature",
                                               norm_stats=stats))


def test_preroll_holds_full_onset_debounce():
    """min_speech_s > preroll_s keeps every onset hop: the ring holds the
    onset run and the pre-roll."""
    audio = np.concatenate([np.zeros(16000, np.float32), _speech(16000, 300, 0)])
    onsets = [p for k, p in EndpointDetector(min_speech_s=0.5, preroll_s=0.1).feed(audio)
              if k == "onset"]
    want = [p for k, p in JDetector(min_speech_s=0.5, preroll_s=0.1).feed(audio)
            if k == "onset"]
    assert len(onsets) == 1
    onset_audio, start = onsets[0]
    np.testing.assert_array_equal(onset_audio, want[0][0])
    assert start == want[0][1]
    assert len(onset_audio) >= int(0.5 * 16000 / HOP) * HOP
    assert start <= 16000 - int(0.1 * 16000) + HOP


def test_flush_end_matches_samples_fed(models):
    """A flushed segment ends where the samples the session saw end: a
    dedicated decode of [start_s, end_s) is token-exact."""
    pm = models[1]
    audio = np.concatenate([np.zeros(16000, np.float32), _speech(12800, 300, 0)])
    ct = ContinuousTranscriber(StreamingSession(pm, RuntimeConfig()))
    ct.push_audio(audio)
    assert ct.flush() == 1
    seg = ct.segments[0]
    assert seg["end_s"] <= len(audio) / 16000 + 1e-9
    a, b = int(round(seg["start_s"] * 16000)), int(round(seg["end_s"] * 16000))
    ref = StreamingSession(pm, RuntimeConfig())
    ref.push_audio(audio[a:b])
    ref.finalize()
    assert seg["tokens"] == ref.tokens


def test_stable_text_and_debug_context_match_jax(models):
    jm, pm = models
    audio = _speech(24000, 300, 4)
    sessions = (StreamingSession(pm, RuntimeConfig()), JSession(jm, JRuntime()))
    for s in sessions:
        s.set_debug_context("client-7")
        assert s._debug_ctx == "client-7"
        s.push_audio(audio[:16000])
        assert s.stable_text == s.text
    assert sessions[0].stable_text == sessions[1].stable_text
    for s in sessions:
        s.push_audio(audio[16000:])
        s.finalize()
    assert sessions[0].stable_text == sessions[1].stable_text == sessions[0].text
