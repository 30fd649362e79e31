"""The Python side of the C-ABI bridge of the PyTorch port
(``runtime/capi_bridge.py``) against the JAX package's
``runtime/capi_bridge.py`` on the trained ``gate_r3``, driven as the C++
runtime drives it: create, push log-mel features from a float32 buffer in
pieces, finalize, poll until empty. The events, ``stable_text``, the word
TSV's words and times are equal, its log-probs within 1e-3; after
``reset_session`` the next utterance's events are equal too; ``TRT_ASR_BEAM`` selects the beam session in
both, with equal finals; the device rule of ``runtime/platform.py``: the
CPU when ``JAX_PLATFORMS=cpu`` asks for it, the card otherwise, and without
a card and without that request creating a session raises (JAX's bridge
falls back to the CPU there).

Tolerance: events, text and word times exact; word log-probs 1e-3."""

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, synth_audio

from trt_asr_tpu.runtime import capi_bridge as jbridge
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.runtime import capi_bridge as pbridge
from trt_asr_tpu_torch.runtime.platform import requested_device
from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession
from trt_asr_tpu_torch.streaming.session import StreamingSession


@pytest.fixture(scope="module")
def feats():
    audio = np.concatenate([synth_audio(seed=31, words=6), np.zeros(4000, np.float32)])
    model = ParakeetTDT.from_model_dir(GATE_R3, device="cpu")
    return model.frontend(audio).numpy().astype(np.float32)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
    monkeypatch.delenv("TRT_ASR_BEAM", raising=False)


def drive(bridge, s, feats, piece=37):
    """Push ``feats`` as the native runtime does (float32 bytes and a frame
    count), finalize, poll until empty."""
    assert bridge.n_mels(s) == feats.shape[1]
    pushed = 0
    for i in range(0, len(feats), piece):
        block = np.ascontiguousarray(feats[i:i + piece])
        pushed += bridge.push_features(s, block.tobytes(), block.shape[0])
    bridge.finalize(s)
    events = []
    while (ev := bridge.poll_event(s)) is not None:
        events.append(ev)
    return pushed, events, bridge.stable_text(s), bridge.word_timestamps_tsv(s)


def _tsv(text):
    rows = [ln.split("\t") for ln in text.splitlines()]
    return [(a, b, w) for a, b, _, w in rows], np.array([float(r[2]) for r in rows])


def test_bridge_matches_jax(feats):
    s, js = pbridge.create_session(GATE_R3), jbridge.create_session(GATE_R3)
    assert type(s.session) is StreamingSession and s.model.device == torch.device("cpu")
    got, want = drive(pbridge, s, feats), drive(jbridge, js, feats)
    assert got[:3] == want[:3]
    pushed, events, stable, tsv = got
    assert pushed > 3 and events[-1][0] == 1 and events[-1][2] == stable and stable
    assert [e[0] for e in events[:-1]] == [0] * (len(events) - 1)
    words, logp = _tsv(tsv)
    jwords, jlogp = _tsv(want[3])
    assert words == jwords and len(words) == len(stable.split())
    np.testing.assert_allclose(logp, jlogp, atol=1e-3)
    # the next utterance on a reset session: the next segment id, as JAX's
    pbridge.reset_session(s)
    jbridge.reset_session(js)
    again = drive(pbridge, s, feats)
    assert again[:3] == drive(jbridge, js, feats)[:3]
    assert [e[1] for e in again[1]] == [e[1] + 1 for e in events]
    # a second session shares the model of its directory
    assert pbridge.create_session(GATE_R3).model is s.model
    pbridge.destroy_session(s)
    assert s.session is None


def test_beam_env_selects_the_beam_session(feats, monkeypatch):
    monkeypatch.setenv("TRT_ASR_BEAM", "2")
    s, js = pbridge.create_session(GATE_R3), jbridge.create_session(GATE_R3)
    assert isinstance(s.session, BeamStreamingSession)
    got, want = drive(pbridge, s, feats[:150]), drive(jbridge, js, feats[:150])
    assert got[1][-1] == want[1][-1] and got[1][-1][0] == 1 and got[2] == want[2]


@pytest.mark.parametrize("env", [None, "tpu", "cuda"])
def test_no_card_and_no_cpu_request_raises(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_PLATFORMS")
    else:
        monkeypatch.setenv("JAX_PLATFORMS", env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        requested_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbridge.create_session(GATE_R3)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu,tpu")
    assert requested_device() == torch.device("cpu")
