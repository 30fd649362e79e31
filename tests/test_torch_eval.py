"""The port's evaluation surface against the JAX package: the WER functions
(``eval/wer.py``) on fixed cases and on drawn strings; the synthetic
spoken-words task (``eval/synthetic.py``) bit for bit against
``tools/train_synthetic_e2e.py``; the WER gate (``eval/gate.py``) against
the tool's ``_evaluate`` (``--skip-train``) on gate_r3's first 3 held-out
utterances, python and batch surfaces, ``base`` and ``nocache``: the same
artifact keys, matrix, gate rows and exit code, and the same suite results
(``run_suite``: transcripts, partial counts and every WER field; timings
excluded); the beam suite against JAX's, with and without an n-gram LM
fused (``lm_path``); the port alone under ``drop_time_carry`` (the gate
fails), its cli engine against its python engine (greedy, and beam 2 with
the LM), its native engine (the port's C++ CLI) against its cli engine, the
gate's native surface beside its cli surface, the validation errors and
the ``python -m trt_asr_tpu_torch.eval.suite`` exit rule. Partials are
unpaced (``TRT_ASR_PARTIAL_MIN_INTERVAL_MS=0``) on both sides, so their
counts do not depend on the wall clock."""

import argparse
import importlib.util
import json
import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_port_helpers import GATE_R3

from trt_asr_tpu.eval import suite as jax_suite
from trt_asr_tpu.eval import wer as jax_wer
from trt_asr_tpu_torch.eval import gate, synthetic
from trt_asr_tpu_torch.eval import suite as port_suite
from trt_asr_tpu_torch.eval import wer as port_wer
from trt_asr_tpu_torch.eval.manifest import read_manifest, write_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_UTTS = 3
WER_KEYS = ("wer", "substitutions", "insertions", "deletions", "ref_words",
            "num_utterances", "empty_hypotheses")


def load_tool():
    spec = importlib.util.spec_from_file_location(
        "train_synthetic_e2e", os.path.join(ROOT, "tools", "train_synthetic_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TOOL = load_tool()


# ---- WER ---------------------------------------------------------------------

CASES = [("the cat sat on the mat", "the cat sat on the mat"), ("the cat sat", "the bat sat"),
         ("the cat sat", "the cat"), ("the cat", "the big cat"), ("a b c", ""), ("", "x y"),
         ("", ""), ("Hello, world!", "hello world"), ("don't stop", "DON'T stop"),
         ("'quoted' text", "quoted, text!"), ("rock 'n' roll", "rock n roll"),
         ("a b c d e f", "f e d c b a")]


def counts(c):
    return (c.substitutions, c.insertions, c.deletions, c.ref_words, c.errors, c.wer)


@pytest.mark.parametrize("ref,hyp", CASES)
def test_wer_fixed_cases_match_jax(ref, hyp):
    for text in (ref, hyp):
        assert port_wer.normalize_text(text) == jax_wer.normalize_text(text)
    assert counts(port_wer.score_pair(ref, hyp)) == counts(jax_wer.score_pair(ref, hyp))


def test_normalize_keeps_inner_apostrophes():
    assert port_wer.normalize_text("Hello, world!") == ["HELLO", "WORLD"]
    assert port_wer.normalize_text("don't stop") == ["DON'T", "STOP"]
    assert port_wer.normalize_text("'quoted'") == ["QUOTED"]


def test_score_corpus_matches_jax():
    got = port_wer.score_corpus(CASES)
    assert got == jax_wer.score_corpus(CASES)
    assert got["empty_hypotheses"] == 2


_WORDS = st.lists(st.sampled_from(["a", "b", "ab", "don't", "'x'", "B,", "c!", "é", "--", "1"]),
                  max_size=8).map(" ".join)


@settings(max_examples=60, deadline=None, database=None)
@given(pairs=st.lists(st.tuples(_WORDS | st.text(max_size=20), _WORDS), max_size=4))
def test_wer_drawn_strings_match_jax(pairs):
    for ref, hyp in pairs:
        assert port_wer.normalize_text(ref) == jax_wer.normalize_text(ref)
        assert counts(port_wer.score_pair(ref, hyp)) == counts(jax_wer.score_pair(ref, hyp))
    assert port_wer.score_corpus(pairs) == jax_wer.score_corpus(pairs)


def test_eval_package_reexports():
    import trt_asr_tpu_torch.eval as ev

    assert (ev.normalize_text, ev.score_pair, ev.score_corpus) == (
        port_wer.normalize_text, port_wer.score_pair, port_wer.score_corpus)


# ---- the synthetic task --------------------------------------------------------

def test_make_words_matches_tool():
    assert synthetic.make_words(1120) == TOOL.make_words(1120)
    assert synthetic.make_words(7) == TOOL.make_words(7)


def test_held_out_set_bitwise():
    words = synthetic.make_words(1120)
    got = synthetic.make_set(50, 2, words, 8, 13)[:4]
    want = TOOL.make_set(50, 2, words, 8, 13)[:4]
    for (ids_g, a_g), (ids_w, a_w) in zip(got, want):
        assert [int(i) for i in ids_g] == [int(i) for i in ids_w]
        assert a_g.dtype == a_w.dtype == np.float32
        assert a_g.tobytes() == a_w.tobytes()
    # the first utterances do not depend on the set's size
    assert synthetic.make_set(2, 2, words, 8, 13)[1][1].tobytes() == got[1][1].tobytes()


def test_add_noise_bitwise():
    audio = synthetic.make_set(1, 2, synthetic.make_words(1120), 8, 13)[0][1]
    for snr in (15.0, 0.0, -3.0):
        got = synthetic.add_noise(audio, snr, np.random.default_rng(99))
        want = TOOL.add_noise(audio, snr, np.random.default_rng(99))
        assert got.tobytes() == want.tobytes()


# ---- the gate and the suite on gate_r3 ------------------------------------------

@pytest.fixture(scope="module")
def gate_runs(tmp_path_factory):
    """The port's gate (on the CPU) and the JAX tool's ``_evaluate`` on the
    first 3 held-out utterances: python and batch surfaces (B = 2), base and
    nocache, sim 0.5, no noisy copy."""
    root = tmp_path_factory.mktemp("gate")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
        words = TOOL.make_words(1120)
        jdir = root / "jax"
        jdir.mkdir()
        ns = argparse.Namespace(
            out_dir=str(jdir), noise_snr_db=0.0, sabotage="", variants="base,nocache",
            stream_sims="0.5", surfaces="python,batch", native_variants="base",
            native_eval_utts=12, native_cli="", batch_size=2,
            artifact=str(root / "jax.json"), gate_wer=0.05)
        rc_jax = TOOL._evaluate(ns, words, TOOL.make_set(N_UTTS, 2, words, 8, 13),
                                os.path.join(ROOT, GATE_R3))
        rc_port = gate.main(["--model-dir", GATE_R3, "--out-dir", str(root / "port"),
                             "--eval-utts", str(N_UTTS), "--noise-snr-db", "0",
                             "--variants", "base,nocache", "--stream-sims", "0.5",
                             "--surfaces", "python,batch", "--batch-size", "2",
                             "--artifact", str(root / "port.json"), "--device", "cpu"])
    return root, rc_jax, rc_port


def test_gate_artifact_matches_jax_tool(gate_runs):
    root, rc_jax, rc_port = gate_runs
    got = json.loads((root / "port.json").read_text())
    want = json.loads((root / "jax.json").read_text())
    assert set(got) == set(want) == {"config", "vocab_size", "matrix", "gate_per_surface"}
    assert got["vocab_size"] == want["vocab_size"] == 1120
    assert got["matrix"] == want["matrix"]
    assert sorted(got["matrix"]) == ["batch/clean/base/sim0.5", "batch/clean/nocache/sim0.5",
                                     "python/clean/base/sim0.5", "python/clean/nocache/sim0.5"]
    assert got["gate_per_surface"] == want["gate_per_surface"]
    assert rc_port == rc_jax == 0
    assert got["matrix"]["python/clean/nocache/sim0.5"]["wer"] > 0.05   # nocache hurts


@pytest.mark.parametrize("surface,variant", [("python", "base"), ("python", "nocache"),
                                             ("batch", "base"), ("batch", "nocache")])
def test_run_suite_matches_jax(gate_runs, surface, variant):
    root = gate_runs[0]
    name = f"suite_{surface}_clean_s0.5/suite_results.json"
    got = json.loads((root / "port" / name).read_text())
    want = json.loads((root / "jax" / name).read_text())
    for key in ("engine", "variants", "rounds", "stream_sim", "feature_norm", "beam",
                "num_utterances"):
        assert got["config"][key] == want["config"][key], key
    g, w = got["variants"][variant][0], want["variants"][variant][0]
    assert g["wer"] == w["wer"] and set(g["wer"]) == set(WER_KEYS)
    assert [(u["transcript"], u["num_partials"], u["reference"]) for u in g["utterances"]] == [
        (u["transcript"], u["num_partials"], u["reference"]) for u in w["utterances"]]
    assert g["latency_ms"]["p95"] >= g["latency_ms"]["p50"] > 0 and g["rtfx"] > 0


@pytest.fixture(scope="module")
def one_utt(gate_runs, tmp_path_factory):
    """A manifest of the first held-out utterance."""
    path = str(tmp_path_factory.mktemp("one") / "one.tsv")
    write_manifest(path, read_manifest(str(gate_runs[0] / "port" / "eval_clean.tsv"))[:1])
    return path


@pytest.fixture(scope="module")
def lm_file(gate_runs):
    """An n-gram LM (ngram-lm/v1) fitted from the 3 held-out references
    through gate_r3's tokenizer."""
    from trt_asr_tpu_torch.decode.ngram_lm import fit_from_text
    from trt_asr_tpu_torch.tokenizer import Tokenizer

    root = gate_runs[0]
    refs = [e.transcript for e in read_manifest(str(root / "port" / "eval_clean.tsv"))]
    path = str(root / "lm.json")
    fit_from_text(refs, Tokenizer.from_file(os.path.join(GATE_R3, "vocab.txt"),
                                            blank_id=1120)).save(path)
    return path


@pytest.fixture(scope="module")
def beam_runs(one_utt, lm_file, tmp_path_factory):
    """The python engine's beam suite (beam 2) on the first utterance, in
    each package, without and with the LM fused (``lm_path``): {(lm,
    package): round}. The port reads the LM once, through its memo."""
    root = tmp_path_factory.mktemp("beam")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
        for lm in (False, True):
            common = dict(manifest_path=one_utt, model_dir=GATE_R3, engine="python", beam=2,
                          stream_sim=0.5, feature_norm="none", lm_path=lm_file if lm else "")
            loads = port_suite._load_lm_mtime.cache_info().misses
            got = port_suite.run_suite(port_suite.SuiteConfig(
                out_dir=str(root / f"port_{lm}"), device="cpu", **common))
            assert port_suite._load_lm_mtime.cache_info().misses == loads + lm
            want = jax_suite.run_suite(jax_suite.SuiteConfig(
                out_dir=str(root / f"jax_{lm}"), **common))
            assert got["config"]["beam"] == want["config"]["beam"] == 2
            out[lm, "port"], out[lm, "jax"] = (r["variants"]["base"][0] for r in (got, want))
    return out


@pytest.mark.parametrize("lm", [False, True], ids=["beam2", "beam2_lm"])
def test_beam_suite_matches_jax(beam_runs, lm):
    g, w = beam_runs[lm, "port"], beam_runs[lm, "jax"]
    assert g["wer"] == w["wer"]
    assert [(u["transcript"], u["num_partials"]) for u in g["utterances"]] == [
        (u["transcript"], u["num_partials"]) for u in w["utterances"]]
    assert g["wer"]["wer"] == 0.0


def test_sabotage_fails_the_gate(tmp_path, capsys):
    rc = gate.main(["--model-dir", GATE_R3, "--out-dir", str(tmp_path), "--eval-utts",
                    str(N_UTTS), "--noise-snr-db", "0", "--variants", "base", "--stream-sims",
                    "0.5", "--sabotage", "drop_time_carry", "--artifact",
                    str(tmp_path / "a.json"), "--device", "cpu"])
    art = json.loads((tmp_path / "a.json").read_text())
    row = art["matrix"]["python/clean/base/sim0.5"]
    assert rc == 1 and "WER GATE FAIL" in capsys.readouterr().out
    assert row["wer"] > 0.05 and row["insertions"] > 0 and not art["gate_per_surface"][
        "python"]["pass"]
    assert "TRT_ASR_SABOTAGE" not in os.environ        # held for the run only


@pytest.mark.parametrize("beam_lm", [False, True], ids=["greedy", "beam2_lm"])
def test_cli_engine_matches_python_engine(gate_runs, one_utt, tmp_path, monkeypatch, request,
                                          beam_lm):
    monkeypatch.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
    kw = {}
    if beam_lm:     # the cli engine's --beam, --lm and --lm-weight arguments
        kw = dict(beam=2, lm_path=request.getfixturevalue("lm_file"))
        py = request.getfixturevalue("beam_runs")[True, "port"]["utterances"][0]
    else:
        py = json.loads((gate_runs[0] / "port" / "suite_python_clean_s0.5" /
                         "suite_results.json").read_text())["variants"]["base"][0][
                             "utterances"][0]
    res = port_suite.run_suite(port_suite.SuiteConfig(
        manifest_path=one_utt, out_dir=str(tmp_path), model_dir=GATE_R3, engine="cli",
        stream_sim=0.5, feature_norm="none", device="cpu", **kw))
    (u,) = res["variants"]["base"][0]["utterances"]
    assert u["returncode"] == 0, u.get("stderr_tail")
    assert (u["transcript"], u["num_partials"]) == (py["transcript"], py["num_partials"])
    assert u["num_finals"] >= 1 and u["transcript"]


def test_native_engine_matches_cli_engine(one_utt, tmp_path, monkeypatch):
    """``engine="native"``: the port's C++ CLI (built at first use), its
    embedded interpreter on the CPU (``device="cpu"``), gives the cli
    engine's row."""
    monkeypatch.setenv("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "0")
    rows = {}
    for engine in ("cli", "native"):
        res = port_suite.run_suite(port_suite.SuiteConfig(
            manifest_path=one_utt, out_dir=str(tmp_path / engine), model_dir=GATE_R3,
            engine=engine, stream_sim=0.5, feature_norm="none", device="cpu"))
        rows[engine] = r = res["variants"]["base"][0]
        assert res["config"]["engine"] == engine
        (u,) = r["utterances"]
        assert u["returncode"] == 0, u.get("stderr_tail")
    (n,), (c,) = rows["native"]["utterances"], rows["cli"]["utterances"]
    assert (n["transcript"], n["num_partials"], n["num_finals"]) == (
        c["transcript"], c["num_partials"], c["num_finals"])
    assert rows["native"]["wer"] == rows["cli"]["wer"] and n["transcript"]


def test_gate_native_surface(tmp_path):
    """``--surfaces native`` (``--native-eval-utts``, ``--native-variants``):
    the native rows in the matrix and the gate rows, equal to the cli
    surface's on the same utterance, both in the fast env."""
    rc = gate.main(["--model-dir", GATE_R3, "--out-dir", str(tmp_path), "--eval-utts",
                    str(N_UTTS), "--noise-snr-db", "0", "--variants", "base", "--stream-sims",
                    "0.5", "--surfaces", "cli,native", "--cli-eval-utts", "1",
                    "--native-eval-utts", "1", "--native-variants", "base", "--artifact",
                    str(tmp_path / "a.json"), "--device", "cpu"])
    art = json.loads((tmp_path / "a.json").read_text())
    assert rc == 0 and sorted(art["matrix"]) == ["cli/clean/base/sim0.5",
                                                 "native/clean/base/sim0.5"]
    assert art["matrix"]["native/clean/base/sim0.5"] == art["matrix"]["cli/clean/base/sim0.5"]
    assert art["matrix"]["native/clean/base/sim0.5"]["num_utterances"] == 1
    assert art["gate_per_surface"]["native"] == art["gate_per_surface"]["cli"]
    assert art["gate_per_surface"]["native"]["pass"]
    assert read_manifest(str(tmp_path / "eval_clean_native.tsv")) == read_manifest(
        str(tmp_path / "eval_clean.tsv"))[:1]


@pytest.mark.parametrize("kw,match", [
    (dict(engine="batch", feature_norm="per_feature"), "feature_norm"),
    (dict(engine="batch", feature_norm="none", beam=2), "beam decoding"),
    (dict(engine="native", beam=2), "beam decoding")])
def test_validation_errors_match_jax(one_utt, tmp_path, kw, match):
    errs = []
    for mod in (port_suite, jax_suite):
        with pytest.raises(ValueError, match=match) as e:
            mod.run_suite(mod.SuiteConfig(manifest_path=one_utt, out_dir=str(tmp_path),
                                          model_dir=GATE_R3, **kw))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("model,gate_wer,rc", [(["--model-dir", GATE_R3], "0.05", 0),
                                               (["--synthetic-model", "tiny"], "0.05", 1),
                                               (["--synthetic-model", "tiny"], None, 0)])
def test_suite_cli_gate_exit(one_utt, tmp_path, capsys, model, gate_wer, rc):
    argv = ["--manifest", one_utt, "--out-dir", str(tmp_path), "--feature-norm", "none",
            "--device", "cpu"] + model + (["--gate-wer", gate_wer] if gate_wer else [])
    assert port_suite.main(argv) == rc
    out = capsys.readouterr()
    assert "base round 0: WER=" in out.out
    assert ("WER GATE FAIL" in out.err) == (rc == 1)
    assert os.path.exists(tmp_path / "suite_results.json")
