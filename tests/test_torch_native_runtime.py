"""The port's native C-ABI runtime (``trt_asr_tpu_torch/native/``): built by
``native/build.py`` without cmake, then driven as the JAX package's
``tests/test_native_runtime.py`` drives ``cpp/``, each of its tests with a
counterpart here: the mock backend's CLI, the log-mel tool against the
port's frontend and JAX's ``LogMelFrontend``, the embedded backend's CLI
(``trt_asr_tpu_torch`` on the CPU, ``JAX_PLATFORMS=cpu``), the f16 push, the
``n_mels`` and ``stable_text`` getters, a bad model dir, feature dump and
replay, the fast and beam envs, and the thread smoke. Beside them: the
port's CLI prints the JAX native CLI's ``Final``/``Transcript``/``Word``
lines on one tiny model and wav (JAX's built by cmake into a temporary
directory, skipped without cmake or ninja); without a card and without
``JAX_PLATFORMS=cpu`` the CLI exits non-zero (no CPU fallback); a client
built against the reference header links against the port's library
unchanged; a compile error raises with the compiler's log; no native source
names the JAX package.

Tolerance: log-mel 2e-4 against JAX's frontend (the JAX test's); against
the port's frontend that plus the port's own tolerance against JAX's
(2e-5 absolute + 5e-5 relative, ``test_torch_frontend.py``; on the CPU each
of its values lies within 2e-5 of float64 sums, ``ops/kernels/mel.py``, and
the native FFT is in double precision); CLI lines exact."""

import ctypes
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from trt_asr_tpu_torch.native import build as native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(REPO, "trt_asr_tpu_torch", "native")
LINES = ("Final:", "Transcript:", "Word:")


class Config(ctypes.Structure):
    _fields_ = [("model_dir", ctypes.c_char_p), ("device_id", ctypes.c_int32),
                ("use_fp16", ctypes.c_bool), ("use_mock", ctypes.c_bool)]


class Event(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int), ("segment_id", ctypes.c_int32),
                ("text", ctypes.c_char_p), ("error_message", ctypes.c_char_p)]


@pytest.fixture(scope="module")
def native():
    return native_build.build()


@pytest.fixture(scope="module")
def lib(native):
    lib = ctypes.CDLL(str(native.lib))
    lib.parakeet_create_session.restype = ctypes.c_void_p
    lib.parakeet_create_session.argtypes = [ctypes.POINTER(Config)]
    lib.parakeet_destroy_session.argtypes = [ctypes.c_void_p]
    lib.parakeet_reset_utterance.argtypes = [ctypes.c_void_p]
    lib.parakeet_poll_event.restype = ctypes.c_bool
    lib.parakeet_poll_event.argtypes = [ctypes.c_void_p, ctypes.POINTER(Event)]
    lib.parakeet_push_features.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.c_size_t]
    lib.trt_asr_push_features_tc.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                             ctypes.c_size_t]
    lib.trt_asr_push_features_tc_f16.argtypes = [ctypes.c_void_p,
                                                 ctypes.POINTER(ctypes.c_uint16),
                                                 ctypes.c_size_t]
    lib.trt_asr_finalize.argtypes = [ctypes.c_void_p]
    lib.trt_asr_n_mels.argtypes = [ctypes.c_void_p]
    lib.trt_asr_stable_text.restype = ctypes.c_char_p
    lib.trt_asr_stable_text.argtypes = [ctypes.c_void_p]
    return lib


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """One tiny model dir (JAX's ``ParakeetTDT.random(tiny, seed=5)``, which
    both packages read) and one wav (a 300 Hz tone, 1.5 s)."""
    from trt_asr_tpu.config import ModelConfig
    from trt_asr_tpu.io.wav import save_wav
    from trt_asr_tpu.models.parakeet.model import ParakeetTDT

    root = tmp_path_factory.mktemp("native")
    ParakeetTDT.random(ModelConfig.tiny(), seed=5).save_model_dir(str(root / "model"))
    t = np.arange(24000)
    save_wav(str(root / "t.wav"), (0.4 * np.sin(2 * np.pi * 300 * t / 16000)).astype(np.float32))
    return root


def cpu_env(**extra):
    """The embedded interpreter's env (repository root and this
    interpreter's packages on PYTHONPATH), on the CPU."""
    env = native_build.embed_env()
    env["JAX_PLATFORMS"] = "cpu"
    for k in ("TRT_ASR_QUANT", "TRT_ASR_PALLAS_ATT", "TRT_ASR_BEAM"):
        env.pop(k, None)
    env.update(extra)
    return env


def run_cli(native, tiny, *flags, env=None):
    out = subprocess.run([str(native.cli), str(tiny / "t.wav"), "--model-dir",
                          str(tiny / "model"), *flags], capture_output=True, text=True,
                         env=env or cpu_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out


def lines(stdout):
    return [ln for ln in stdout.splitlines() if ln.startswith(LINES)]


@pytest.fixture(scope="module")
def base_run(native, tiny):
    """The port's CLI on the tiny model and wav with ``--timestamps``."""
    return run_cli(native, tiny, "--timestamps")


def test_native_logmel_parity(native, tmp_path, rng):
    """logmel_tool against the port's frontend and JAX's LogMelFrontend."""
    from trt_asr_tpu.frontend import LogMelFrontend
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend as PortLogMel

    audio = (0.3 * np.sin(np.arange(20000) * 0.13)
             + 0.05 * rng.standard_normal(20000)).astype(np.float32)
    p = tmp_path / "a.f32"
    audio.tofile(p)
    out = subprocess.run([str(native.logmel_tool), str(p)], capture_output=True, check=True)
    got = np.frombuffer(out.stdout, dtype=np.float32).reshape(-1, 128)
    port = PortLogMel(device="cpu")(audio).numpy()
    jax_ref = np.asarray(LogMelFrontend()(audio))
    assert got.shape == port.shape == jax_ref.shape
    np.testing.assert_allclose(got, jax_ref, atol=2e-4)
    np.testing.assert_allclose(got, port, atol=2e-4 + 2e-5, rtol=5e-5)


def test_mock_backend_cli(native, tmp_path):
    from trt_asr_tpu_torch.io.wav import save_wav

    wav = tmp_path / "t.wav"
    save_wav(str(wav), np.zeros(32000, np.float32))
    out = subprocess.run([str(native.cli), str(wav), "--mock", "--timestamps"],
                         capture_output=True, text=True, check=True)
    assert "Final: Mock transcription for" in out.stdout
    assert "Transcript: Mock transcription for" in out.stdout
    assert "backend=mock" in out.stderr
    # mock word timestamps: one word per 100 frames (198 pushed -> 1 word)
    assert "Word: [0.000000 1.000000] mock0" in out.stdout


def test_torch_backend_cli(native, tiny, base_run):
    """The native -> embedded trt_asr_tpu_torch path on the tiny model."""
    out = base_run
    assert "backend=torch(embedded)" in out.stderr
    transcript = [ln for ln in out.stdout.splitlines()
                  if ln.startswith("Transcript:")][-1][len("Transcript:"):].strip()
    words = [ln for ln in out.stdout.splitlines() if ln.startswith("Word: [")]
    assert transcript and words, out.stdout[-2000:]
    starts = [float(ln.split("[")[1].split()[0]) for ln in words]
    assert starts == sorted(starts)
    # determinism through the whole native stack
    again = run_cli(native, tiny)
    assert f"Transcript: {transcript}" in again.stdout


def test_cli_matches_jax_native_cli(native, tiny, base_run, tmp_path_factory):
    """The port's CLI and the JAX package's (``cpp/``, built by cmake into a
    temporary directory) print the same Final, Transcript and Word lines on
    one model dir and wav."""
    if shutil.which("cmake") is None or shutil.which("ninja") is None:
        pytest.skip("cmake/ninja unavailable")
    bdir = tmp_path_factory.mktemp("jax_cpp_build")
    subprocess.run(["cmake", "-S", os.path.join(REPO, "cpp"), "-B", str(bdir), "-G", "Ninja"],
                   check=True, capture_output=True)
    subprocess.run(["ninja", "-C", str(bdir), "trt_asr_cli"], check=True, capture_output=True)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    jax_out = subprocess.run([str(bdir / "trt_asr_cli"), str(tiny / "t.wav"), "--model-dir",
                              str(tiny / "model"), "--timestamps"], capture_output=True,
                             text=True, env=env, timeout=420)
    assert jax_out.returncode == 0, jax_out.stderr[-2000:]
    got, want = lines(base_run.stdout), lines(jax_out.stdout)
    assert got == want and any(ln.startswith("Word:") for ln in got), (got, want)


def test_f16_push_matches_f32(lib, tiny, monkeypatch):
    """The f16 feature push == the f32 push of the same (f16-rounded)
    values, through the embedded backend (in this process's interpreter)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    cfg = Config(str(tiny / "model").encode(), 0, True, False)
    s = lib.parakeet_create_session(ctypes.byref(cfg))
    assert s, "session create failed (embedded backend)"
    f16 = np.random.default_rng(3).standard_normal((90, 32)).astype(np.float16)
    f32 = f16.astype(np.float32)  # exactly the f16-representable values

    def run(push):
        lib.parakeet_reset_utterance(s)
        assert push() == 0
        assert lib.trt_asr_finalize(s) == 0
        ev, final = Event(), ""
        while lib.parakeet_poll_event(s, ctypes.byref(ev)):
            if ev.type == 1:
                final = ev.text.decode()
        return final

    t32 = run(lambda: lib.trt_asr_push_features_tc(
        s, f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 90))
    t16 = run(lambda: lib.trt_asr_push_features_tc_f16(
        s, f16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 90))
    lib.parakeet_destroy_session(s)
    assert t16 == t32 and t32 != ""


def test_n_mels_abi_getter(lib):
    """trt_asr_n_mels reports the backend's mel count (mock: 128)."""
    s = lib.parakeet_create_session(ctypes.byref(Config(b"", 0, True, True)))
    assert s
    assert lib.trt_asr_n_mels(s) == 128
    lib.parakeet_destroy_session(s)
    assert lib.trt_asr_n_mels(None) == 0


def test_stable_text_abi_getter(lib):
    """trt_asr_stable_text over the mock backend: the mock transcript form
    after frames are pushed."""
    s = lib.parakeet_create_session(ctypes.byref(Config(b"", 0, True, True)))
    assert s
    feats = np.zeros((50, 128), np.float32).ravel()
    buf = feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    assert lib.parakeet_push_features(s, buf, 50) == 0
    txt = lib.trt_asr_stable_text(s).decode()
    assert txt.startswith("Mock transcription for"), txt
    lib.parakeet_destroy_session(s)


def test_bad_model_dir_fails_cleanly(native, tmp_path):
    from trt_asr_tpu_torch.io.wav import save_wav

    wav = tmp_path / "t.wav"
    save_wav(str(wav), np.zeros(16000, np.float32))
    out = subprocess.run([str(native.cli), str(wav), "--model-dir", "/nonexistent"],
                         capture_output=True, text=True, env=cpu_env(), timeout=120)
    assert out.returncode != 0
    assert "failed" in out.stderr.lower()


def test_no_cpu_fallback_without_card(native, tiny):
    """Without a card and without JAX_PLATFORMS=cpu, session creation fails
    and the CLI exits non-zero: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the session would run on it")
    env = cpu_env()
    del env["JAX_PLATFORMS"]
    out = subprocess.run([str(native.cli), str(tiny / "t.wav"), "--model-dir",
                          str(tiny / "model")], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0 and "failed" in out.stderr, out.stderr[-2000:]
    assert "no CUDA device" in out.stderr and "Transcript:" not in out.stdout


def test_cli_dump_and_replay_roundtrip(native, tmp_path):
    """--dump-features writes raw f32 + the sidecar; --features-input
    replays it (both layouts), honoring the sidecar's bins."""
    from trt_asr_tpu_torch.io.wav import save_wav

    cli = str(native.cli)
    wav = tmp_path / "t.wav"
    save_wav(str(wav), (0.2 * np.sin(np.arange(24000) * 0.07)).astype(np.float32))
    dump = tmp_path / "feats.f32"
    subprocess.run([cli, str(wav), "--mock", "--dump-features", str(dump)],
                   capture_output=True, text=True, check=True)
    sc = json.loads((tmp_path / "feats.f32.json").read_text())
    assert sc["layout"] == "frames_major" and sc["bins"] == 128
    feats = np.fromfile(dump, np.float32).reshape(sc["frames"], sc["bins"])

    out = subprocess.run([cli, str(dump), "--mock", "--features-input"],
                         capture_output=True, text=True, check=True)
    assert f"Mock transcription for {sc['frames']} frames" in out.stdout

    # bins_major replay with a non-128 bin count via the sidecar
    bm = tmp_path / "feats32.f32"
    np.ascontiguousarray(feats[:, :32].T).tofile(bm)
    (tmp_path / "feats32.f32.json").write_text(json.dumps(
        {"layout": "bins_major", "bins": 32, "frames": int(sc["frames"])}))
    out = subprocess.run([cli, str(bm), "--mock", "--features-input"],
                         capture_output=True, text=True, check=True)
    assert f"Mock transcription for {sc['frames']} frames" in out.stdout


def test_torch_backend_fast_mode_env(native, tiny, base_run):
    """TRT_ASR_* env toggles reach the embedded interpreter: the CLI in fast
    mode (int8 weights, attention kernel flag) gives the default transcript
    on this tone model."""
    fast = run_cli(native, tiny, env=cpu_env(TRT_ASR_QUANT="all", TRT_ASR_PALLAS_ATT="1"))
    transcript = [ln for ln in base_run.stdout.splitlines() if ln.startswith("Transcript:")]
    assert fast.stdout.splitlines()[-1].startswith("Transcript:")
    assert [fast.stdout.splitlines()[-1]] == transcript


def test_torch_backend_beam_env(native, tiny, base_run):
    """TRT_ASR_BEAM reaches the embedded interpreter: beam 1 gives the
    greedy transcript through the C ABI."""
    beamed = run_cli(native, tiny, env=cpu_env(TRT_ASR_BEAM="1"))
    transcript = [ln for ln in base_run.stdout.splitlines() if ln.startswith("Transcript:")]
    assert beamed.stdout.splitlines()[-1].startswith("Transcript:")
    assert [beamed.stdout.splitlines()[-1]] == transcript


def test_abi_thread_smoke(native):
    """abi_thread_smoke: a pusher thread and a poller thread over the C ABI
    (mock backend, mutex-guarded event queue)."""
    out = subprocess.run([str(native.abi_thread_smoke)], capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr
    assert "abi_thread_smoke ok" in out.stdout


def declarations(path):
    text = open(path).read()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


def test_reference_header_client_links_unchanged(native, tmp_path):
    """The port's header declares what ``cpp/include/trt_asr_tpu.h`` does,
    and a client built against that header (the reference's thread smoke)
    links against the port's library and runs."""
    port_h = os.path.join(NATIVE_SRC, "include", "trt_asr_tpu.h")
    assert declarations(port_h) == declarations(os.path.join(REPO, "cpp", "include",
                                                             "trt_asr_tpu.h"))
    exe = tmp_path / "client"
    subprocess.run([native_build.compiler(), "-std=c++17", "-I", os.path.join(REPO, "cpp",
                                                                             "include"),
                    os.path.join(REPO, "cpp", "tools", "abi_thread_smoke.cpp"), "-o", str(exe),
                    str(native.lib), f"-Wl,-rpath,{native.dir}", "-pthread"],
                   check=True, capture_output=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and "abi_thread_smoke ok" in out.stdout, out.stderr


def test_compile_error_raises_with_log(tmp_path, monkeypatch):
    """A source that does not compile: build() raises with the compiler's
    log and leaves no build behind."""
    src = tmp_path / "native"
    shutil.copytree(NATIVE_SRC, src, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    with open(src / "src" / "logmel.cpp", "a") as f:
        f.write("\nint broken_on_purpose( {\n")
    monkeypatch.setattr(native_build, "NATIVE_DIR", src)
    monkeypatch.setattr(native_build, "BUILD_ROOT", tmp_path / "out")
    with pytest.raises(RuntimeError, match=r"native build failed:(.|\n)*logmel\.cpp"):
        native_build.build()
    assert not any((tmp_path / "out").iterdir())


def test_native_sources_name_no_jax_module():
    """Nothing under native/ names a module of the JAX package (the header's
    file name, ``trt_asr_tpu.h``, is the ABI's) or imports JAX."""
    bad = []
    for dirpath, _, files in os.walk(NATIVE_SRC):
        for name in files:
            if not name.endswith((".py", ".h", ".cpp")):
                continue
            path = os.path.join(dirpath, name)
            for k, ln in enumerate(open(path), 1):
                if (re.search(r"\btrt_asr_tpu[./](?!h\b)", ln)
                        or re.search(r"^\s*(import|from)\s+jax\b", ln)):
                    bad.append(f"{path}:{k}: {ln.strip()}")
    assert not bad, bad
