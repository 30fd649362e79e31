"""The batched device beam of the PyTorch port's ``BatchStreamingEngine``
(``beam > 1``) against the JAX package's engine and against the port's own
device beam sessions, on ``ModelConfig.tiny()`` (the same seeded weights)
and on gate_r3: three streams of different lengths (one attached after the
first step) without fusion, with an n-gram LM and with biasing; each
slot's n-best equals JAX's slot and a standalone session's. Also slot
reuse, the token-cap ERROR event, ``warmup`` beside a live stream, and the
refusals (``lm_fn`` without a beam or not compilable, ``nbest`` on a greedy
engine; ``mesh=`` and ``engines=`` on a beam engine, with JAX's text).

Tolerance: tokens, ranking and events exact; scores 1e-4."""

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, np_tree, synth_audio, one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.decode.biasing import make_biasing_lm as j_make_biasing
from trt_asr_tpu.decode.ngram_lm import NGramLM as JNGram
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine as JEngine
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.decode.biasing import make_biasing_lm
from trt_asr_tpu_torch.decode.ngram_lm import NGramLM
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession
from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler
from trt_asr_tpu_torch.tokenizer import Tokenizer

RT = dict(suppress_leading_punct=False, partial_min_interval_ms=0)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    jm = JModel.random(JConfig.tiny(), seed=5)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                     Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                     runtime=RuntimeConfig(**RT), device="cpu")
    return jm, pm


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    return (0.4 * np.sin(2 * np.pi * (250 + 30 * seed) * np.arange(n) / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _events(eng, sid):
    out = []
    while (ev := eng.poll_event(sid)) is not None:
        out.append((int(ev.type), ev.segment_id, list(ev.tokens), ev.error_message))
    return out


def serve_streams(eng, audios, piece=8000):
    """Streams interleaved, the last attached after the first step; returns
    per stream (n-best, events)."""
    sids = [eng.open_stream() for _ in audios[:-1]]
    offs = [0] * len(audios)
    step = 0
    while any(o < len(a) for o, a in zip(offs, audios)) or len(sids) < len(audios):
        if step == 1:
            sids.append(eng.open_stream())
        for k, sid in enumerate(sids):
            if offs[k] < len(audios[k]):
                eng.push_audio(sid, audios[k][offs[k]:offs[k] + piece])
                offs[k] += piece
        eng.step()
        step += 1
    for sid in sids:
        eng.finalize_stream(sid)
    eng.run_until_drained()
    return [(eng.nbest(sid), _events(eng, sid)) for sid in sids]


def session_nbest(model, audio, **kw):
    sess = BeamStreamingSession(model, beam=4, device=True, **kw)
    sess._sched = ChunkScheduler(model.cfg, unified=True)   # the engine's chunk profile
    for i in range(0, len(audio), 8000):
        sess.push_audio(audio[i:i + 8000])
    sess.finalize()
    return sess.nbest()


def assert_nbest_equal(got, want):
    assert [n[:2] for n in got] == [n[:2] for n in want]
    np.testing.assert_allclose([n[2] for n in got], [n[2] for n in want], atol=1e-4)


@pytest.mark.parametrize("fusion", [None, "ngram", "bias"])
def test_engine_matches_jax_engine_and_sessions(models, fusion):
    jm, pm = models
    audios = [_audio(40000, 1), _audio(24000, 2), _audio(32000, 3)]
    kw, jkw = {}, {}
    if fusion == "ngram":
        r = np.random.default_rng(7)
        seqs = [r.integers(0, 64, size=9).tolist() for _ in range(40)]
        kw = dict(lm_fn=NGramLM.fit(seqs, vocab_size=65), lm_weight=0.6)
        jkw = dict(lm_fn=JNGram.fit(seqs, vocab_size=65), lm_weight=0.6)
    elif fusion == "bias":
        phrases = [pm.tokenizer.decode([38, 60]), pm.tokenizer.decode([12])]
        kw = dict(lm_fn=make_biasing_lm(phrases, pm.tokenizer), lm_weight=1.0)
        jkw = dict(lm_fn=j_make_biasing(phrases, jm.tokenizer), lm_weight=1.0)
    got = serve_streams(BatchStreamingEngine(pm, batch_size=4, runtime=RuntimeConfig(**RT),
                                             beam=4, token_cap=64, **kw), audios)
    want = serve_streams(JEngine(jm, batch_size=4, runtime=JRuntime(**RT), beam=4,
                                 token_cap=64, **jkw), audios)
    for k, a in enumerate(audios):
        assert_nbest_equal(got[k][0], want[k][0])
        assert got[k][1] == want[k][1]
        assert [n[1] for n in got[k][0]] == [n[1] for n in session_nbest(pm, a, **kw)]
        assert got[k][0][0][1]


def test_slot_reuse_token_cap_and_warmup(models):
    """A reused slot decodes as a fresh one; a 2-token buffer reports one
    ERROR event a slot; a warm-up beside a live stream leaves it as it
    was."""
    pm = models[1]
    a = _audio(32000, 4)
    eng = BatchStreamingEngine(pm, batch_size=2, runtime=RuntimeConfig(**RT), beam=4,
                               token_cap=64)
    first = serve_streams(eng, [a])[0][0]
    eng.close_stream(0)
    sid = eng.open_stream()
    eng.push_audio(sid, a[:16000])
    eng.step()
    assert eng.warmup() > 0
    eng.push_audio(sid, a[16000:])
    eng.finalize_stream(sid)
    eng.run_until_drained()
    assert eng.nbest(sid) == first
    capped = BatchStreamingEngine(pm, batch_size=2, runtime=RuntimeConfig(**RT), beam=4,
                                  token_cap=2)
    events = serve_streams(capped, [a, _audio(24000, 5)])
    for nbest, evs in events:
        errors = [e for e in evs if e[0] == 2]
        assert len(errors) == 1 and "token_cap=2 saturated" in errors[0][3]
        assert max(len(n[1]) for n in nbest) == 2


def test_refusals(models):
    pm = models[1]
    with pytest.raises(ValueError, match="lm_fn requires beam > 1"):
        BatchStreamingEngine(pm, batch_size=2, lm_fn=NGramLM.fit([[1, 2]], vocab_size=65))
    with pytest.raises(ValueError, match="NGramLM / BiasingLM"):
        BatchStreamingEngine(pm, batch_size=2, beam=4, lm_fn=lambda p, t: 0.0)
    with pytest.raises(ValueError, match="nbest requires a beam>1 engine"):
        BatchStreamingEngine(pm, batch_size=2).nbest(0)
    # a beam engine takes neither a mesh nor an engine set: JAX's refusals
    from trt_asr_tpu_torch.parallel.mesh import make_mesh
    from trt_asr_tpu_torch.runtime.engine import EngineSet

    for kw, match in ((dict(mesh=make_mesh(devices=[torch.device("cpu")])),
                       "beam serving is single-device"),
                      (dict(engines=EngineSet({}, {})), "beam serving runs live-jit")):
        with pytest.raises(ValueError, match=match):
            BatchStreamingEngine(pm, batch_size=2, beam=4, **kw)


def test_gate_r3_engine_matches_jax_engine():
    """gate_r3, an LM fitted from its words, three streams: both engines'
    n-best and events."""
    jm = JModel.from_model_dir(GATE_R3, runtime=JRuntime(**RT))
    pm = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(**RT), device="cpu")
    words = ["baba daba faba", "gaba haba faba baba", "jaba kaba"]
    lm = NGramLM.fit([pm.tokenizer.encode(w) for w in words], vocab_size=1120)
    jlm = JNGram.fit([jm.tokenizer.encode(w) for w in words], vocab_size=1120)
    audios = [synth_audio(seed=50 + k, words=3 + k) for k in range(3)]
    got = serve_streams(BatchStreamingEngine(pm, batch_size=4, runtime=RuntimeConfig(**RT),
                                             beam=4, lm_fn=lm, lm_weight=0.6), audios)
    want = serve_streams(JEngine(jm, batch_size=4, runtime=JRuntime(**RT), beam=4, lm_fn=jlm,
                                 lm_weight=0.6), audios)
    for k in range(3):
        assert_nbest_equal(got[k][0], want[k][0])
        assert got[k][1] == want[k][1]
        assert len(got[k][0][0][1]) == 3 + k
