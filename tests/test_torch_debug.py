"""The debug surface of the PyTorch port against the JAX package (one case
per case of ``tests/test_debug_subsystems.py`` that it covers): tap stats,
sidecar and gap filling; the session's audio tap byte-equal to JAX's and
read by ``tools/analyze_tap.py``, its feature tap within 1e-4 of JAX's
(the two log-mel frontends' f32 noise); per-chunk snapshots of one gate_r3
utterance through ``tools/parity/compare_snapshots.py`` at its default
1e-4 and the port's own comparison; the NaN guard's cadence and halt; the
stage marker's format and the session's marker, emitted-token lines
equal to JAX's; the per-step route's tokens, stamps and trace on gate_r3
equal to JAX's; one bounded profiler trace; the ``drop_time_carry``
sabotage giving JAX's sabotaged tokens in the session and the engine;
``RuntimeConfig.from_env`` equal to JAX's for every debug field and
alias; ``save_model_dir`` read by JAX's ``from_model_dir`` with equal
params and tokens, and back."""

import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, assert_tree_equal, np_tree, one_torch_thread, synth_audio  # noqa: F401

from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.debug import nan_guard as j_nan_guard
from trt_asr_tpu.debug.stage_markers import stage_marker as j_stage_marker
from trt_asr_tpu.debug.taps import TapRun as JTapRun
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine as JEngine
from trt_asr_tpu.streaming.session import StreamingSession as JSession
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.debug import nan_guard
from trt_asr_tpu_torch.debug.snapshot import compare_snapshot_dirs
from trt_asr_tpu_torch.debug.stage_markers import stage_marker
from trt_asr_tpu_torch.debug.taps import TapRun
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import params_to_numpy
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
from trt_asr_tpu_torch.streaming.session import StreamingSession

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARKER = re.compile(r"^\[stage \+ *\d+\.\d{3}s\] (.*)$")


def run(sess, audio, piece=8000):
    for i in range(0, len(audio), piece):
        sess.push_audio(audio[i:i + piece])
    sess.finalize()
    return sess


def sidecar(run_dir, name):
    with open(os.path.join(run_dir, name + ".f32.json")) as f:
        return json.load(f)


def chunk_records(path):
    """The per-chunk NDJSON records without their wall-clock ``t``."""
    return [{k: v for k, v in json.loads(ln).items() if k != "t"} for ln in open(path)]


def test_tap_writer_stats_sidecar_and_gaps(tmp_path):
    """Stats, sidecar and gap filling equal JAX's writer's on the same writes."""
    bad = np.ones((5, 4), np.float32)
    bad[0, 0] = np.nan
    out = {}
    for name, cls in (("port", TapRun), ("jax", JTapRun)):
        run_ = cls(str(tmp_path / name))
        w = run_.features(n_mels=4)
        w.write(np.ones((10, 4), np.float32), stream_pos=0)
        w.write(bad, {"ctx": "chunk1"}, stream_pos=12)         # 2 lost frames
        a = run_.audio()
        a.write(np.ones(1000, np.float32), stream_pos=0)
        a.write(np.ones(1000, np.float32), stream_pos=1500)   # 500 lost samples
        run_.close()
        out[name] = run_.run_dir
    d = out["port"]
    assert sorted(os.listdir(d)) == sorted(os.listdir(out["jax"])) == [
        "audio.chunks.ndjson", "audio.f32", "audio.f32.json", "features.chunks.ndjson",
        "features.f32", "features.f32.json"]
    for name in ("audio", "features"):
        assert sidecar(d, name) == sidecar(out["jax"], name)
        assert open(os.path.join(d, name + ".f32"), "rb").read() == open(
            os.path.join(out["jax"], name + ".f32"), "rb").read()
        assert chunk_records(os.path.join(d, name + ".chunks.ndjson")) == chunk_records(
            os.path.join(out["jax"], name + ".chunks.ndjson"))
    sc = sidecar(d, "features")
    assert sc["frames"] == 17 and sc["nan_inf_count"] == 1 and sc["gap_values_filled"] == 8
    raw = np.fromfile(os.path.join(d, "audio.f32"), np.float32)
    assert raw.size == 2500 and np.all(raw[1000:1500] == 0.0)
    assert sidecar(d, "audio")["gaps_filled"] is True


# JAX's per-step route with its trace: the one session route of this
# module, so that its JAX sessions share one set of compiles
J_ROUTE = dict(batched_decode=False, debug_tdt_steps=True)


@pytest.fixture(scope="module")
def gate_r3_debug_runs(tmp_path_factory):
    """One gate_r3 utterance through the port's and JAX's sessions with
    taps, snapshots, the NaN guard (halting), stage markers, the
    emitted-token lines, the per-step route with its trace (NDJSON) and the
    blank-scan line on, an 8,000-sample hole left in the pushes (the audio
    tap fills it from ``stream_pos``); the port's also with the joint and
    attention kernels' plain versions; and the port's session with every
    toggle off on the same audio. Returns the two sessions, their dirs,
    stderr lines, the plain session, the two models and the utterance."""
    audio = synth_audio(11)
    base = tmp_path_factory.mktemp("gate_r3_debug")
    model = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")
    jmodel = JModel.from_model_dir(GATE_R3, runtime=JRuntime())
    out = {}
    for name in ("port", "jax"):
        kw = dict(tap_enabled=True, tap_dir=str(base / name / "taps"),
                  snapshot_dir=str(base / name / "snaps"), nan_guard=True, nan_guard_halt=True,
                  stage_markers=True, debug_emit_tokens=True, **J_ROUTE,
                  tdt_trace_path=str(base / name / "trace.jsonl"), debug_blank_scan=True)
        if name == "port":
            sess = StreamingSession(model, RuntimeConfig(
                **kw, use_pallas_joint=True, use_pallas_att=True))
        else:
            sess = JSession(jmodel, JRuntime(**kw))
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            for i, start in enumerate(range(0, len(audio), 8000)):
                if i == 2:
                    continue                                  # the capture lost this piece
                sess.push_audio(audio[start:start + 8000], stream_pos=start)
            sess.finalize()
        err = buf.getvalue()
        out[name] = (sess, base / name, [MARKER.match(ln).group(1) for ln in err.splitlines()
                                          if MARKER.match(ln)])
    plain = run(StreamingSession(model, RuntimeConfig()),
                np.concatenate([audio[:16000], audio[24000:]]))
    return out, plain, (model, jmodel), audio


def test_session_taps_equal_jax_and_analyze_tap_reads_them(gate_r3_debug_runs):
    out = gate_r3_debug_runs[0]
    dirs = {}
    for name in ("port", "jax"):
        (run_dir,) = os.listdir(out[name][1] / "taps")
        dirs[name] = str(out[name][1] / "taps" / run_dir)
    port, jax_ = dirs["port"], dirs["jax"]
    assert open(os.path.join(port, "audio.f32"), "rb").read() == open(
        os.path.join(jax_, "audio.f32"), "rb").read()
    assert sidecar(port, "audio") == sidecar(jax_, "audio")
    assert sidecar(port, "audio")["gap_values_filled"] == 8000
    feats = {k: np.fromfile(os.path.join(d, "features.f32"), np.float32) for k, d in dirs.items()}
    assert feats["port"].shape == feats["jax"].shape
    np.testing.assert_allclose(feats["port"], feats["jax"], atol=1e-4)
    tool = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "analyze_tap.py"),
                           os.path.join(port, "audio.f32")], capture_output=True, text=True,
                          timeout=120)
    assert tool.returncode == 0, tool.stderr
    assert f"samples={sidecar(port, 'audio')['num_values']}" in tool.stdout
    assert "writer gaps: 1" in tool.stdout


def test_session_snapshots_equal_jax(gate_r3_debug_runs):
    out, plain = gate_r3_debug_runs[:2]
    port, jax_ = (str(out[k][1] / "snaps") for k in ("port", "jax"))
    assert out["port"][0].tokens == out["jax"][0]._tokens == plain.tokens
    assert len(plain.tokens) > 3
    tool = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "parity",
                                                        "compare_snapshots.py"), port, jax_],
                          capture_output=True, text=True, timeout=120)
    assert tool.returncode == 0 and "PASS" in tool.stdout, tool.stdout
    report = compare_snapshot_dirs(port, jax_)
    assert report["pass"] and report["chunks"] >= 5, report
    assert max(report["max_abs"].values()) < 1e-4
    # a perturbed tensor fails the port's comparison at its chunk
    bad = out["jax"][1] / "snaps_bad"
    shutil.copytree(jax_, bad)
    g_path = bad / "chunk_00001" / "pred_g.f32"
    (np.fromfile(g_path, np.float32) + 1e-3).tofile(g_path)
    report = compare_snapshot_dirs(port, str(bad))
    assert not report["pass"] and report["first_bad"] == {"pred_g": "chunk_00001"}


def test_per_step_session_equals_jax_on_gate_r3(gate_r3_debug_runs):
    """gate_r3 with ``batched_decode=False`` and the trace (the debug runs):
    tokens, stamps, trace records and NDJSON lines equal JAX's per-step
    session's (log-probs within 1e-4, as in ``test_torch_session.py``),
    as many non-blank records as tokens, and tokens and stamps equal the
    port's default session's."""
    out, plain = gate_r3_debug_runs[:2]
    port, jsess = out["port"][0], out["jax"][0]
    stamps = lambda s: [{k: v for k, v in d.items() if k != "logp"}  # noqa: E731
                        for d in s.token_timestamps()]
    assert port.tokens == jsess._tokens == plain.tokens
    assert stamps(port) == stamps(jsess) == stamps(plain)
    np.testing.assert_allclose([d["logp"] for d in port.token_timestamps()],
                               [d["logp"] for d in jsess.token_timestamps()], atol=1e-4)
    assert port.token_timestamps() == plain.token_timestamps()
    assert port.tdt_steps == jsess.tdt_steps and plain.tdt_steps == []
    assert sum(not r["is_blank"] for r in port.tdt_steps) == len(port.tokens)
    lines = [open(out[k][1] / "trace.jsonl").read().splitlines() for k in ("port", "jax")]
    assert lines[0] == lines[1] and len(lines[0]) == len(port.tdt_steps) + 1


def test_session_markers_equal_jax(gate_r3_debug_runs):
    """Stage and emitted-token markers: the same lines as JAX's but for the
    milliseconds; the halting NaN guard found nothing."""
    out = gate_r3_debug_runs[0]
    strip = lambda lines: [re.sub(r"\d+\.\d ms", "ms", ln) for ln in lines  # noqa: E731
                           if not ln.startswith("SLOW chunk")]
    port, jax_ = strip(out["port"][2]), strip(out["jax"][2])
    assert port == jax_
    assert port[0] == "chunk 0 enter []" and any(" emitted [" in ln for ln in port)
    assert sum(ln.startswith("chunk ") and " enter " in ln for ln in port) >= 5


def test_stage_marker_format(capfd):
    stage_marker(RuntimeConfig(stage_markers=True), "hello")
    stage_marker(RuntimeConfig(), "hidden")
    stage_marker(None, "forced", force=True)
    j_stage_marker(JRuntime(stage_markers=True), "hello")
    lines = capfd.readouterr().err.splitlines()
    assert [MARKER.match(ln).group(1) for ln in lines] == ["hello", "forced", "hello"]


def test_nan_guard_cadence_and_halt(capfd):
    for guard in (nan_guard, j_nan_guard):
        assert guard.check_finite(np.ones(10), "x")
        assert not guard.check_finite(np.array([1.0, np.nan]), "x")
        with pytest.raises(guard.NanGuardError):
            guard.check_finite(np.array([np.inf]), "x", halt=True)
        np.testing.assert_array_equal(guard.scrub_logits(np.array([1.0, np.nan, -np.inf])),
                                      [1.0, -100.0, -100.0])
        for _ in range(205):
            guard.check_finite(np.array([np.nan]), "torch_port_cadence", sample=True,
                               first_n=3, every=100)
    err = capfd.readouterr().err.splitlines()
    # per package: 2 unsampled reports, then calls 0-2, 100 and 200 of the site
    assert len(err) == 2 * (2 + 5) and err[:7] == err[7:]
    t = torch.tensor([[1.0, float("nan")], [float("inf"), 2.0]])
    assert not nan_guard.check_finite(t, "tensor")
    assert "tensor has 2 non-finite values (shape (2, 2))" in capfd.readouterr().err
    with pytest.raises(nan_guard.NanGuardError):
        nan_guard.check_finite(t, "tensor", halt=True)
    assert nan_guard.check_finite(torch.ones(3), "ok")
    assert torch.equal(nan_guard.scrub_logits(t), torch.tensor([[1.0, -100.0], [-100.0, 2.0]]))


def test_profiler_writes_one_bounded_trace(tmp_path):
    model = ParakeetTDT.random(ModelConfig.tiny(), seed=3, runtime=RuntimeConfig(), device="cpu")
    sess = run(StreamingSession(model, RuntimeConfig(
        profile_dir=str(tmp_path / "prof"), profile_chunks=2)),
        (0.1 * np.random.default_rng(3).standard_normal(32000)).astype(np.float32))
    assert len(sess.chunk_latencies_ms) > 2
    (run_dir,) = os.listdir(tmp_path / "prof")
    assert run_dir.startswith("run_") and os.listdir(tmp_path / "prof" / run_dir) == ["trace.json"]
    with open(tmp_path / "prof" / run_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    prof = sess._profiler
    assert prof._done and prof._count == 2


def test_drop_time_carry_equals_jax_in_session_and_engine(gate_r3_debug_runs):
    """On the gate_r3 utterance (JAX's session compiled by the debug runs)."""
    _, _, (model, jmodel), audio = gate_r3_debug_runs
    rt = dict(sabotage="drop_time_carry")
    got = run(StreamingSession(model, RuntimeConfig(**rt)), audio).tokens
    want = run(JSession(jmodel, JRuntime(**rt, **J_ROUTE)), audio)._tokens
    clean = run(StreamingSession(model, RuntimeConfig()), audio).tokens
    assert got == want and got != clean          # the fault is live on this utterance
    engines = []
    for eng_cls, rt_cls, m in ((BatchStreamingEngine, RuntimeConfig, model),
                               (JEngine, JRuntime, jmodel)):
        eng = eng_cls(m, batch_size=2, runtime=rt_cls(**rt))
        sid = eng.open_stream()
        for i in range(0, len(audio), 8000):
            eng.push_audio(sid, audio[i:i + 8000])
            eng.step()
        eng.finalize_stream(sid)
        eng.run_until_drained()
        engines.append(list(eng._tokens[sid]))
    assert engines[0] == engines[1] != clean


# every debug field's env names (primary and PARAKEET_/AUDIO_ aliases) with a value
ENV = [("TRT_ASR_NAN_GUARD", "1"), ("PARAKEET_NAN_GUARD_ALWAYS", "1"),
       ("TRT_ASR_NAN_GUARD_HALT", "yes"), ("PARAKEET_NAN_GUARD_HALT", "on"),
       ("TRT_ASR_STAGE_MARKERS", "1"), ("PARAKEET_DEBUG_STAGE_MARKERS", "true"),
       ("TRT_ASR_DEBUG_EMIT_TOKENS", "1"), ("PARAKEET_DEBUG_EMIT_TOKENS", "1"),
       ("TRT_ASR_DEBUG_TDT_STEPS", "1"), ("PARAKEET_DEBUG_TDT_STEPS", "1"),
       ("TRT_ASR_TDT_TRACE_PATH", "/t.jsonl"), ("TRT_ASR_SNAPSHOT_DIR", "/s"),
       ("PARAKEET_TDT_SNAPSHOT_DIR", "/s2"), ("TRT_ASR_TAP_DIR", "/taps"),
       ("AUDIO_TAP_DIR", "/taps2"), ("TRT_ASR_TAP_ENABLE", "1"), ("AUDIO_TAP_ENABLE", "1"),
       ("TRT_ASR_SLOW_STEP_MS", "12.5"), ("PARAKEET_SLOW_ENQUEUE_MS", "7"),
       ("PARAKEET_SLOW_CHUNK_MS", "9"), ("TRT_ASR_PROFILE_DIR", "/prof"),
       ("TRT_ASR_PROFILE_CHUNKS", "3"), ("TRT_ASR_DEBUG_BLANK_SCAN", "1"),
       ("PARAKEET_DEBUG_BLANK_SCAN", "1"), ("TRT_ASR_SABOTAGE", "drop_time_carry")]
NEW_FIELDS = ("nan_guard", "nan_guard_halt", "stage_markers", "debug_emit_tokens",
              "debug_tdt_steps", "tdt_trace_path", "snapshot_dir", "tap_dir", "tap_enabled",
              "slow_step_ms", "profile_dir", "profile_chunks", "debug_blank_scan", "sabotage")


@pytest.mark.parametrize("name,value", ENV, ids=[n for n, _ in ENV])
def test_from_env_equals_jax(name, value, monkeypatch):
    for n, _ in ENV:
        monkeypatch.delenv(n, raising=False)
    monkeypatch.setenv(name, value)
    got, want = RuntimeConfig.from_env(), JRuntime.from_env()
    assert {f: getattr(got, f) for f in NEW_FIELDS} == {f: getattr(want, f) for f in NEW_FIELDS}
    assert got != RuntimeConfig()
    defaults = {f.name: f.default for f in dataclasses.fields(RuntimeConfig)}
    assert {f: defaults[f] for f in NEW_FIELDS} == {f: getattr(JRuntime(), f) for f in NEW_FIELDS}


def test_save_model_dir_round_trips_with_jax(gate_r3_debug_runs, tmp_path):
    _, _, (model, jmodel), audio = gate_r3_debug_runs
    port_dir, jax_dir = str(tmp_path / "from_port"), str(tmp_path / "from_jax")
    model.save_model_dir(port_dir)
    assert sorted(os.listdir(port_dir)) == ["config.json", "manifest.json", "params.npz",
                                            "vocab.txt"]
    loaded = JModel.from_model_dir(port_dir, runtime=JRuntime())
    assert loaded.cfg == jmodel.cfg and loaded.tokenizer.vocab == model.tokenizer.vocab
    assert_tree_equal(np_tree(loaded.params), params_to_numpy(model.params))
    jmodel.save_model_dir(jax_dir)
    back = ParakeetTDT.from_model_dir(jax_dir, runtime=RuntimeConfig(), device="cpu")
    assert back.cfg == model.cfg
    assert_tree_equal(params_to_numpy(back.params), np_tree(jmodel.params))
    assert (run(StreamingSession(back, RuntimeConfig()), audio).tokens
            == run(JSession(loaded, JRuntime(**J_ROUTE)), audio)._tokens
            == run(StreamingSession(model, RuntimeConfig()), audio).tokens)
