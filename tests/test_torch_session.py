"""Streaming session of the PyTorch port against the JAX package on the
trained ``gate_r3`` model: synthesized utterances pushed at 0.3/0.5/1.0 s
give the same transcript, tokens and token/word stamps as the JAX
``StreamingSession``, with the fused attention block and joint step off and
on (their plain versions on CPU tensors); the event protocol, reset/reuse,
push-after-finalize and snapshot/restore; the package imports nothing of
JAX; without a CUDA device the entry points raise unless asked for the CPU.

Tolerance: transcripts, tokens, frames and durations exact; per-token
log-probs 1e-4 absolute."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, synth_audio

from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.session import StreamingSession as JSession
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.session import EventType, StreamingSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    return JModel.from_model_dir(GATE_R3, runtime=JRuntime())


@pytest.fixture(scope="module")
def port_model():
    return ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")


def run(session, audio, piece):
    for i in range(0, len(audio), piece):
        session.push_audio(audio[i:i + piece])
    session.finalize()
    return session


def stamps(sess):
    return ([{k: v for k, v in d.items() if k != "logp"} for d in sess.token_timestamps()],
            [d["logp"] for d in sess.token_timestamps()], sess.word_timestamps())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("seconds", [0.3, 0.5, 1.0])
def test_session_matches_jax_on_gate_r3(jax_model, port_model, seconds, fused):
    audio = synth_audio(seed=int(seconds * 10) + 100 * fused, words=6)
    piece = int(seconds * 16000)
    kw = dict(use_pallas_att=fused, use_pallas_joint=fused)
    ref = run(JSession(jax_model, JRuntime(**kw)), audio, piece)
    got = run(StreamingSession(port_model, RuntimeConfig(**kw)), audio, piece)
    assert len(ref._tokens) > 0
    assert got.tokens == ref._tokens
    assert got.text == ref.text
    (tok_g, lp_g, words_g), (tok_r, lp_r, words_r) = stamps(got), stamps(ref)
    assert tok_g == tok_r
    np.testing.assert_allclose(lp_g, lp_r, atol=1e-4)
    assert [{k: v for k, v in w.items() if k != "logp"} for w in words_g] == \
        [{k: v for k, v in w.items() if k != "logp"} for w in words_r]


def events_of(sess):
    out = []
    while (ev := sess.poll_event()) is not None:
        out.append(ev)
    return out


def test_event_protocol_reset_and_push_after_finalize(port_model):
    audio = synth_audio(seed=11, words=5)
    sess = run(StreamingSession(port_model, RuntimeConfig()), audio, 8000)
    events = events_of(sess)
    assert events[-1].type == EventType.FINAL_TEXT
    assert events[-1].text == sess.text and events[-1].tokens == sess.tokens
    assert any(e.type == EventType.PARTIAL_TEXT for e in events)
    first = sess.tokens

    sess.push_audio(audio[:8000])                   # after finalize: an ERROR event
    err = events_of(sess)
    assert [e.type for e in err] == [EventType.ERROR]
    assert "finalize" in err[0].error_message
    sess.finalize()                                 # idempotent
    assert events_of(sess) == []

    sess.reset_utterance()                          # reuse gives the same transcript
    run(sess, audio, 4800)
    assert sess.tokens == first
    assert events_of(sess)[-1].segment_id == events[-1].segment_id + 1


def test_snapshot_restore_continues_identically(port_model):
    audio = synth_audio(seed=12, words=6)
    rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True)
    whole = run(StreamingSession(port_model, rt), audio, 8000)
    a = StreamingSession(port_model, rt)
    a.push_audio(audio[:24000])
    snap = a.snapshot()
    a.push_audio(audio[24000:32000])                # the snapshot is a copy, not a view
    b = StreamingSession(port_model, rt)
    b.restore(snap)
    for i in range(24000, len(audio), 8000):
        b.push_audio(audio[i:i + 8000])
    b.finalize()
    assert b.tokens == whole.tokens
    assert b.token_timestamps() == whole.token_timestamps()


def test_cache_fault_paths_match_jax(jax_model, port_model):
    audio = synth_audio(seed=13, words=4)
    for kw in (dict(disable_cache=True), dict(cache_len_override=5)):
        ref = run(JSession(jax_model, JRuntime(**kw)), audio, 8000)
        got = run(StreamingSession(port_model, RuntimeConfig(**kw)), audio, 8000)
        assert got.tokens == ref._tokens, kw


def test_port_imports_nothing_of_jax():
    code = (
        "import sys, numpy as np\n"
        "from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig\n"
        "from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT\n"
        "from trt_asr_tpu_torch.streaming.session import StreamingSession\n"
        "import trt_asr_tpu_torch.ops.kernels.build\n"
        "m = ParakeetTDT.random(ModelConfig.tiny(), seed=1, runtime=RuntimeConfig(), device='cpu')\n"
        "s = StreamingSession(m)\n"
        "s.push_audio(np.sin(np.arange(16000) * 0.05).astype(np.float32)); s.finalize()\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "       or k == 'trt_asr_tpu' or k.startswith('trt_asr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(s.chunk_latencies_ms))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend

    if torch.cuda.is_available():
        assert ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        LogMelFrontend()
    m = ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig(), device="cpu")
    assert StreamingSession(m).device.type == "cpu"
