"""The port's gate tools (``trt_asr_tpu_torch/tools/``) against the repo's
JAX tools (``tools/``), each run in this process on the same small
arguments: the JAX tool with ``--platform cpu``, the port's with
``--device cpu``, on the committed trained model ``gate_r3``.

- ``ngram_lm_fit``: the LM JSON byte for byte;
- ``gate_beam_eval`` (2 utterances, beam 1; beam 2 is held to JAX by the
  LM gate's unfused row): rows, verdict, transcripts and exit code equal;
- ``gate_lm_eval`` (2 noisy utterances, 200 LM sentences, beam 2, weights
  0 and 0.2): the LM JSON byte for byte, rows, verdict and exit code;
- ``gate_continuous_eval`` (3 utterances): segments (text, tokens, times,
  words), boundaries, WER row and exit code;
- every port tool raises without a card unless the CPU is asked for.

Tolerance: none; every compared value is exact but the wall seconds.
"""

import json
import os
import sys

import pytest
import torch

from torch_port_helpers import GATE_R3, one_torch_thread  # noqa: F401

from trt_asr_tpu_torch.eval.synthetic import make_set, make_words
from trt_asr_tpu_torch.tools import (fuzz_session, gate_beam_eval, gate_continuous_eval,
                                     gate_lm_eval, ngram_lm_fit, soak_daemon)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def run_jax_tool(mp, name: str, argv):
    """``tools/<name>.py``'s ``main`` with ``argv`` on the command line, on
    the CPU; -> its exit code."""
    import importlib

    mp.setenv("JAX_PLATFORMS", "cpu")
    mp.syspath_prepend(ROOT)
    mod = importlib.import_module(f"tools.{name}")
    mp.setattr(sys, "argv", [f"tools/{name}.py", *argv])
    return mod.main()


def rows_without_wall(art):
    return {k: {f: v for f, v in r.items() if f != "wall_sec"} for k, r in art["rows"].items()}


# ---- ngram_lm_fit --------------------------------------------------------------

@pytest.mark.parametrize("order,alpha", [(3, 0.4), (2, 0.7)])
def test_ngram_lm_fit_matches_jax_bytes(tmp_path, order, alpha):
    words = make_words(1120)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("".join(" ".join(words[k] for k in ids) + "\n"
                              for ids, _ in make_set(6, 2, words, 8, 13)) + "\n")
    flags = ["--model-dir", GATE_R3, "--order", str(order), "--alpha", str(alpha)]
    with pytest.MonkeyPatch.context() as mp:
        assert run_jax_tool(mp, "ngram_lm_fit",
                            [str(corpus), "--out", str(tmp_path / "jax.json"), *flags]) == 0
    assert ngram_lm_fit.main([str(corpus), "--out", str(tmp_path / "port.json"), *flags,
                              "--device", "cpu"]) == 0
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert json.loads(got)["order"] == order


# ---- gate_beam_eval ------------------------------------------------------------

@pytest.fixture(scope="module")
def beam_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate_beam")
    flags = ["--model-dir", GATE_R3, "--eval-utts", "2", "--beams", "1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
        rc_port = gate_beam_eval.main([*flags, "--out-dir", str(root / "port"), "--artifact",
                                       str(root / "port.json"), "--device", "cpu"])
        rc_jax = run_jax_tool(mp, "gate_beam_eval", [
            *flags, "--out-dir", str(root / "jax"), "--artifact", str(root / "jax.json"),
            "--platform", "cpu"])
    return root, rc_jax, rc_port


def test_gate_beam_eval_matches_jax(beam_runs):
    root, rc_jax, rc_port = beam_runs
    got = json.loads((root / "port.json").read_text())
    want = json.loads((root / "jax.json").read_text())
    assert set(got) == set(want) == {"config", "rows", "verdict"}
    assert list(got["rows"]) == ["greedy", "beam1"]
    assert rows_without_wall(got) == rows_without_wall(want)
    assert got["verdict"] == want["verdict"]
    assert got["verdict"]["beam1_matches_greedy_transcripts"] is True
    assert rc_port == rc_jax == 0
    assert got["rows"]["greedy"]["ref_words"] == 22 and got["rows"]["greedy"]["wer"] == 0.0


@pytest.mark.parametrize("label", ["greedy", "beam1"])
def test_gate_beam_eval_transcripts_match_jax(beam_runs, label):
    root = beam_runs[0]
    name = f"suite_{label}/suite_results.json"
    got, want = (json.loads((root / side / name).read_text())["variants"]["base"][0]
                 for side in ("port", "jax"))
    assert [u["transcript"] for u in got["utterances"]] == [
        u["transcript"] for u in want["utterances"]]
    assert (root / "port" / "eval.tsv").read_text().replace(str(root / "port"), "") == (
        root / "jax" / "eval.tsv").read_text().replace(str(root / "jax"), "")


# ---- gate_lm_eval --------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gate_lm")
    flags = ["--model-dir", GATE_R3, "--eval-utts", "2", "--lm-train-utts", "200",
             "--beam", "2", "--lm-weights", "0,0.2"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
        rc_port = gate_lm_eval.main([*flags, "--out-dir", str(root / "port"), "--artifact",
                                     str(root / "port.json"), "--device", "cpu"])
        rc_jax = run_jax_tool(mp, "gate_lm_eval", [
            *flags, "--out-dir", str(root / "jax"), "--artifact", str(root / "jax.json"),
            "--platform", "cpu"])
    return root, rc_jax, rc_port


def test_gate_lm_eval_matches_jax(lm_runs):
    root, rc_jax, rc_port = lm_runs
    got = json.loads((root / "port.json").read_text())
    want = json.loads((root / "jax.json").read_text())
    assert set(got) == set(want) == {"config", "snr_db", "rows", "verdict"}
    assert list(got["rows"]) == ["beam2_lm0", "beam2_lm0.2"]
    assert rows_without_wall(got) == rows_without_wall(want)
    assert got["verdict"] == want["verdict"] and got["snr_db"] == want["snr_db"] == 15.0
    assert rc_port == rc_jax
    assert got["rows"]["beam2_lm0"]["wer"] > 0.05       # the noisy set is hard


def test_gate_lm_eval_lm_json_and_transcripts_match_jax(lm_runs):
    root = lm_runs[0]
    assert (root / "port" / "lm.json").read_bytes() == (root / "jax" / "lm.json").read_bytes()
    for label in ("beam2_lm0", "beam2_lm0.2"):
        name = f"suite_{label}/suite_results.json"
        got, want = (json.loads((root / side / name).read_text())["variants"]["base"][0]
                     for side in ("port", "jax"))
        assert [u["transcript"] for u in got["utterances"]] == [
            u["transcript"] for u in want["utterances"]], label
    for i in range(2):      # the noisy wavs, bit for bit
        wav = f"wavs/utt{i}.wav"
        assert (root / "port" / wav).read_bytes() == (root / "jax" / wav).read_bytes()


def test_gate_lm_eval_needs_a_fused_row(tmp_path, capsys):
    rc = gate_lm_eval.main(["--model-dir", GATE_R3, "--eval-utts", "1", "--lm-train-utts",
                            "20", "--beam", "1", "--lm-weights", "0", "--out-dir",
                            str(tmp_path), "--device", "cpu"])
    assert rc == 2 and "no fused (w>0) rows" in capsys.readouterr().err


# ---- gate_continuous_eval ------------------------------------------------------

@pytest.fixture(scope="module")
def continuous_runs(tmp_path_factory):
    import trt_asr_tpu.streaming.continuous as jax_continuous

    root = tmp_path_factory.mktemp("gate_continuous")
    jax_segments = []
    with pytest.MonkeyPatch.context() as mp:
        real_flush = jax_continuous.ContinuousTranscriber.flush

        def flush(self):
            n = real_flush(self)
            jax_segments.extend(self.segments)
            return n

        mp.setattr(jax_continuous.ContinuousTranscriber, "flush", flush)
        rc_jax = run_jax_tool(mp, "gate_continuous_eval", [
            "--model-dir", GATE_R3, "--eval-utts", "3", "--artifact", str(root / "jax.json"),
            "--platform", "cpu"])
        port_runs = []          # main's evaluate: (payload, segments)
        real_evaluate = gate_continuous_eval.evaluate
        mp.setattr(gate_continuous_eval, "evaluate",
                   lambda args: port_runs.append(real_evaluate(args)) or port_runs[-1])
        rc_port = gate_continuous_eval.main(["--model-dir", GATE_R3, "--eval-utts", "3",
                                             "--artifact", str(root / "port.json"),
                                             "--device", "cpu"])
    (payload, port_segments), = port_runs
    return root, rc_jax, rc_port, payload, port_segments, jax_segments


def test_gate_continuous_eval_matches_jax(continuous_runs):
    root, rc_jax, rc_port, payload, _, _ = continuous_runs
    got = json.loads((root / "port.json").read_text())
    want = json.loads((root / "jax.json").read_text())
    assert set(got) == set(want)
    for key in ("n_utterances", "n_segments", "segments_match_utterances", "wer",
                "boundaries", "pass"):
        assert got[key] == want[key] == payload[key], key
    assert got["n_segments"] == 3 and got["pass"] and rc_port == rc_jax == 0


def test_gate_continuous_segments_match_jax(continuous_runs):
    port_segments, jax_segments = continuous_runs[4:]
    assert len(port_segments) == len(jax_segments) == 3
    for got, want in zip(port_segments, jax_segments):
        assert set(got) == set(want)
        assert got == want


# ---- no card, no CPU request: every tool raises ---------------------------------

NO_DEVICE_ARGV = {
    ngram_lm_fit: ["corpus.txt", "--model-dir", GATE_R3, "--out", "lm.json"],
    gate_beam_eval: ["--eval-utts", "1"],
    gate_lm_eval: ["--eval-utts", "1"],
    gate_continuous_eval: ["--eval-utts", "1"],
    fuzz_session: ["--seeds", "1"],
    soak_daemon: ["--minutes", "0.01"],
}


@pytest.mark.parametrize("tool", list(NO_DEVICE_ARGV), ids=lambda m: m.__name__.split(".")[-1])
@pytest.mark.parametrize("platform", [[], ["--platform", "tpu"]], ids=["default", "tpu"])
def test_tool_raises_without_card(tool, platform, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(NO_DEVICE_ARGV[tool] + platform)
    assert not any(tmp_path.iterdir())          # raised before writing anything


def test_platform_flag_selects_the_device(monkeypatch):
    import argparse

    from trt_asr_tpu_torch.tools import add_device_args, tool_device

    ap = argparse.ArgumentParser()
    add_device_args(ap)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool_device(ap.parse_args(["--platform", "cpu"])) == torch.device("cpu")
    assert tool_device(ap.parse_args(["--device", "cpu"])) == torch.device("cpu")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert tool_device(ap.parse_args(["--platform", "env"])) == torch.device("cpu")
    monkeypatch.setenv("JAX_PLATFORMS", "tpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool_device(ap.parse_args(["--platform", "env"]))
