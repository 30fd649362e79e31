"""The PyTorch port's replay CLI (``cli.py``) against the JAX package's
``main`` on the trained ``gate_r3``, the same wav on both sides: the
``Partial:`` (with ``TRT_ASR_PARTIAL_MIN_INTERVAL_MS=0`` on both sides:
partials are paced by the wall clock otherwise), ``Final:``,
``Transcript:``, ``Word:`` and ``Segment:`` lines are equal, and so are the
SRT and VTT files, byte for byte; in stream-sim, one-shot, continuous,
``--raw-pcm``, a resampled 44.1 kHz wav and ``--features-input`` replay.
``--dump-features`` writes the same sidecar, byte for byte, and features
within the frontend's tolerance (2e-5 absolute plus 5e-5 relative without
normalization, 2e-5 absolute after per_feature normalization: 6.4e-6
read). The beam flags (``--beam``, ``--beam-device``, ``--bias``, ``--lm``,
``--lm-weight``, ``TRT_ASR_BEAM``, also under ``--continuous``) print the
JAX CLI's lines and NBest lines, and their rules exit as JAX's;
``--compile-cache`` (over ``TRT_ASR_COMPILE_CACHE``) sets the kernel
libraries' directory; without a card the CLI raises
unless ``--device cpu`` is given; as a subprocess it imports nothing of
JAX."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, synth_audio, one_torch_thread  # noqa: F401

from trt_asr_tpu.cli import main as jax_main
from trt_asr_tpu_torch.cli import main as port_main
from trt_asr_tpu_torch.io.wav import save_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIXES = ("Partial: ", "Final: ", "Transcript: ", "Word: ", "Segment: ")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    speech = synth_audio(seed=21, words=7)
    z = np.zeros(16000, np.float32)
    gapped = np.concatenate([z[:6000], synth_audio(seed=22, words=4), z,
                             synth_audio(seed=23, words=3), z[:4000]])
    paths = {"speech": str(d / "speech.wav"), "gapped": str(d / "gapped.wav"),
             "raw": str(d / "speech.f32"), "wav44": str(d / "speech44.wav")}
    save_wav(paths["speech"], speech)
    save_wav(paths["gapped"], gapped)
    speech.astype("<f4").tofile(paths["raw"])
    # 44.1 kHz by linear interpolation: any signal at another rate will do
    t = np.arange(int(len(speech) * 44100 / 16000)) * (16000 / 44100)
    save_wav(paths["wav44"], np.interp(t, np.arange(len(speech)), speech), rate=44100)
    paths["dir"] = str(d)
    return paths


def run(main, argv, monkeypatch):
    monkeypatch.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    assert rc == 0
    return ([ln for ln in out.getvalue().splitlines() if ln.startswith(PREFIXES)],
            err.getvalue())


def both(argv, monkeypatch, tmp_path, subs=True):
    """Run the port's CLI (``--device cpu``) and the JAX CLI on ``argv``;
    returns (port lines, JAX lines, port stderr, JAX stderr) after checking
    the subtitle files are byte-equal."""
    outs = []
    for name, main, extra in (("port", port_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        sub = (["--srt", str(tmp_path / f"{name}.srt"), "--vtt", str(tmp_path / f"{name}.vtt")]
               if subs else [])
        outs.append(run(main, argv + sub + extra, monkeypatch))
    if subs:
        for ext in ("srt", "vtt"):
            got = (tmp_path / f"port.{ext}").read_bytes()
            assert got == (tmp_path / f"jax.{ext}").read_bytes(), ext
            assert got.count(b"-->") >= 1
    (p_lines, p_err), (j_lines, j_err) = outs
    return p_lines, j_lines, p_err, j_err


def transcript(lines):
    return [ln for ln in lines if ln.startswith("Transcript: ")][-1][len("Transcript: "):]


@pytest.mark.parametrize("norm", ["none", "per_feature"])
def test_stream_sim_matches_jax(inputs, monkeypatch, tmp_path, norm):
    argv = [inputs["speech"], "--model-dir", GATE_R3, "--stream-sim", "0.5", "--no-sleep",
            "--timestamps", "--feature-norm", norm]
    got, want, err, _ = both(argv, monkeypatch, tmp_path)
    assert got == want
    kinds = {ln.split(":")[0] for ln in got}
    assert kinds == {"Partial", "Final", "Transcript", "Word"}
    if norm == "none":
        assert len(transcript(got).split()) == 7
    assert "ChunkLatencyMs: p50=" in err


def test_one_shot_matches_jax(inputs, monkeypatch, tmp_path):
    argv = [inputs["speech"], "--model-dir", GATE_R3, "--feature-norm", "none", "--timestamps"]
    got, want, _, _ = both(argv, monkeypatch, tmp_path)
    assert got == want and len(transcript(got).split()) == 7


def test_continuous_matches_jax(inputs, monkeypatch, tmp_path):
    argv = [inputs["gapped"], "--model-dir", GATE_R3, "--stream-sim", "0.5", "--no-sleep",
            "--continuous"]
    got, want, _, _ = both(argv, monkeypatch, tmp_path)
    assert got == want
    segs = [ln for ln in got if ln.startswith("Segment: ")]
    assert len(segs) == 2 and len(transcript(got).split()) >= 7


def test_raw_pcm_matches_jax(inputs, monkeypatch, tmp_path):
    argv = [inputs["raw"], "--raw-pcm", "--model-dir", GATE_R3, "--stream-sim", "0.3",
            "--no-sleep", "--feature-norm", "none", "--timestamps"]
    got, want, _, _ = both(argv, monkeypatch, tmp_path)
    assert got == want and len(transcript(got).split()) == 7


def test_resampled_wav_matches_jax(inputs, monkeypatch, tmp_path):
    argv = [inputs["wav44"], "--model-dir", GATE_R3, "--stream-sim", "0.5", "--no-sleep",
            "--feature-norm", "none"]
    got, want, err, j_err = both(argv, monkeypatch, tmp_path, subs=False)
    assert got == want
    assert "note: resampling 44100 Hz -> 16000 Hz" in err and "note: resampling" in j_err


@pytest.mark.parametrize("norm,atol,rtol", [("none", 2e-5, 5e-5), ("per_feature", 2e-5, 0.0)])
def test_dump_features_and_replay_match_jax(inputs, monkeypatch, tmp_path, norm, atol, rtol):
    dumps = {}
    for name, main, extra in (("port", port_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        path = str(tmp_path / f"{name}.f32")
        run(main, [inputs["speech"], "--model-dir", GATE_R3, "--feature-norm", norm,
                   "--dump-features", path] + extra, monkeypatch)
        with open(path + ".json", "rb") as f:
            dumps[name] = (np.fromfile(path, "<f4"), f.read(), path)
    assert dumps["port"][1] == dumps["jax"][1]
    meta = json.loads(dumps["port"][1])
    assert meta["layout"] == "frames_major" and meta["bins"] == 32
    np.testing.assert_allclose(dumps["port"][0], dumps["jax"][0], atol=atol, rtol=rtol)
    # replay the JAX package's dump through both CLIs: the same features in
    got, want, _, _ = both([dumps["jax"][2], "--features-input", "--model-dir", GATE_R3,
                            "--timestamps"], monkeypatch, tmp_path)
    assert got == want and transcript(got)


def test_synthetic_model_continuous_and_subhop_stream_sim(tmp_path, monkeypatch):
    """--synthetic-model tiny takes the port's random weights; the
    endpointer cuts one segment a speech span, also with a stream-sim hop
    shorter than one 10 ms hop (which must not become 0)."""
    rng = np.random.default_rng(0)
    z = np.zeros(16000, np.float32)
    speech = [(0.4 * np.sin(2 * np.pi * f * np.arange(12800) / 16000)
               + 0.1 * rng.standard_normal(12800)).astype(np.float32) for f in (300, 440)]
    pcm = tmp_path / "s.f32"
    np.concatenate([z, speech[0], z, speech[1], z]).astype("<f4").tofile(pcm)
    for sim, want in (("0", 2), ("0.00005", 2)):
        lines, _ = run(port_main, [str(pcm), "--raw-pcm", "--synthetic-model", "tiny",
                                   "--continuous", "--stream-sim", sim, "--no-sleep",
                                   "--device", "cpu"], monkeypatch)
        assert len([ln for ln in lines if ln.startswith("Segment: ")]) == want, lines
        assert any(ln.startswith("Transcript: ") for ln in lines)


def test_compile_cache_flag_sets_the_library_dir(inputs, monkeypatch, tmp_path):
    """``--compile-cache DIR`` points the kernel libraries' directory at DIR,
    over ``TRT_ASR_COMPILE_CACHE``, and transcribes as without it."""
    from trt_asr_tpu_torch.ops.kernels import build

    # the one-way compile cache, restored after the test
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_cache_dir", None)
    monkeypatch.setenv("TRT_ASR_COMPILE_CACHE", str(tmp_path / "from_env"))
    got, _ = run(port_main, [inputs["speech"], "--model-dir", GATE_R3, "--feature-norm", "none",
                             "--device", "cpu", "--compile-cache", str(tmp_path / "cc")],
                 monkeypatch)
    assert build.BUILD_DIR == tmp_path / "cc" and (tmp_path / "cc").is_dir()
    assert not (tmp_path / "from_env").exists()
    assert len(transcript(got).split()) == 7       # as test_one_shot_matches_jax


@pytest.fixture(scope="module")
def lm_file(inputs):
    """An n-gram LM fitted from gate_r3's words by the port, saved as the v1
    JSON both CLIs read."""
    from trt_asr_tpu_torch.decode.ngram_lm import fit_from_text
    from trt_asr_tpu_torch.tokenizer import Tokenizer

    tok = Tokenizer.from_file(os.path.join(GATE_R3, "vocab.txt"), blank_id=1120)
    path = os.path.join(inputs["dir"], "lm.json")
    fit_from_text(["baba daba faba", "gaba haba faba baba", "jaba kaba laba"], tok).save(path)
    return path


def nbest_lines(err_out_lines):
    return [ln for ln in err_out_lines if ln.startswith("NBest: ")]


def run_nbest(main, argv, monkeypatch):
    """run() with the NBest lines kept: (other lines, [(score, text)])."""
    monkeypatch.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
    out = io.StringIO()
    with redirect_stdout(out), redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    lines = out.getvalue().splitlines()
    nb = [(float(ln.split()[1]), ln.split(" ", 2)[2] if ln.count(" ") > 1 else "")
          for ln in nbest_lines(lines)]
    return [ln for ln in lines if ln.startswith(PREFIXES)], nb


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("extra", [
    ["--beam", "4"], ["--beam", "4", "--beam-device"], ["--beam", "4", "--bias", "gaba haba"],
    ["--beam", "4", "--beam-device", "--lm", "LM"],
    ["--beam", "2", "--lm", "LM", "--lm-weight", "0.3"], ["--beam", "1"], ["TRT_ASR_BEAM=3"]])
def test_beam_flags_match_jax(inputs, lm_file, monkeypatch, extra):
    """The beam session behind the CLI: its Partial, Final, Transcript and
    Word lines equal the JAX CLI's, and so do its NBest lines (texts and
    ranking exact, the printed scores within 2e-4: f32 sums in another
    order, printed to 4 decimals)."""
    if extra == ["TRT_ASR_BEAM=3"]:
        monkeypatch.setenv("TRT_ASR_BEAM", "3")
        extra = []
    extra = [lm_file if a == "LM" else a for a in extra]
    argv = [inputs["speech"], "--model-dir", GATE_R3, "--stream-sim", "0.5", "--no-sleep",
            "--timestamps", "--feature-norm", "none"] + extra
    got, got_nb = run_nbest(port_main, argv + ["--device", "cpu"], monkeypatch)
    want, want_nb = run_nbest(jax_main, argv, monkeypatch)
    assert got == want and transcript(got)
    assert [t for _, t in got_nb] == [t for _, t in want_nb] and got_nb
    np.testing.assert_allclose([s for s, _ in got_nb], [s for s, _ in want_nb], atol=2e-4)


@pytest.mark.usefixtures("one_torch_thread")
def test_beam_continuous_matches_jax(inputs, monkeypatch, tmp_path):
    """``--continuous`` over a beam session (each segment the 1-best)."""
    argv = [inputs["gapped"], "--model-dir", GATE_R3, "--stream-sim", "0.5", "--no-sleep",
            "--continuous", "--beam", "4"]
    got, want, _, _ = both(argv, monkeypatch, tmp_path)
    assert got == want and len([ln for ln in got if ln.startswith("Segment: ")]) == 2


@pytest.mark.parametrize("argv", [["--bias", "gaba"], ["--lm", "x.json"],
                                  ["--beam", "2", "--lm", "x.json", "--bias", "gaba"],
                                  ["--beam-device"]])
def test_beam_flag_rules_match_jax(monkeypatch, capsys, argv):
    """Fusion needs a beam of 2 or more, one lm_fn at a time, and
    ``--beam-device`` a beam: both CLIs exit 2 with the same message."""
    msgs = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(SystemExit) as e:
            main(["x.wav", "--model-dir", GATE_R3] + argv + extra)
        assert e.value.code == 2
        msgs.append(capsys.readouterr().err.strip().splitlines()[-1].split(": error: ")[1])
    assert msgs[0] == msgs[1]


def test_needs_a_card_unless_cpu_is_asked(inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main([inputs["speech"], "--model-dir", GATE_R3])


def test_cli_subprocess_imports_no_jax(inputs, tmp_path):
    """``python -m trt_asr_tpu_torch.cli`` as a user runs it: the transcript
    of the in-process run, and no module of JAX or the JAX package
    (``-X importtime`` lists every import)."""
    err = tmp_path / "stderr.txt"
    with open(err, "w") as ferr:
        res = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "trt_asr_tpu_torch.cli",
             inputs["speech"], "--model-dir", GATE_R3, "--feature-norm", "none",
             "--stream-sim", "0.5", "--no-sleep", "--device", "cpu"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
            stderr=ferr, text=True, timeout=120)
    assert res.returncode == 0
    mods = {ln.rsplit("|", 1)[1].strip() for ln in err.read_text().splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2}
    assert "trt_asr_tpu_torch.streaming.session" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "trt_asr_tpu")]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("Transcript: ")]
    assert len(lines) == 1 and len(lines[0].split()) == 1 + 7
