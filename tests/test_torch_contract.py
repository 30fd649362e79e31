"""The contract, the fixtures codec and the golden checks of the PyTorch
port against the JAX package: ``load_contract`` spec for spec,
``validate`` on the shipped contract and on one mutated contract per rule,
the tolerance ladder (``rung_verdicts``), ``ModelConfig.from_contract``,
the base64 JSONL codec (round trip, byte-equal files, the committed
golden decoded to equal arrays), and the port's golden runner
(``python -m trt_asr_tpu_torch.parity``) on the committed goldens:
the streaming encoder at tiny seed 1 clears the contract's strictest rung
(``ort_f32``: max abs <= 1e-4 on every chunk, closed loop and functional,
kernels' plain versions too; the JAX tool reads 1.3e-6), a wrong seed
fails with exit 1, and the decode trace is IDENTICAL to
``artifacts/goldens/tdt_trace.jsonl`` by the port's comparator and by
``tools/parity/compare_tdt_trace.py``."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_port_helpers import one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JModelConfig
from trt_asr_tpu.contract import load_contract as j_load_contract
from trt_asr_tpu.io import fixtures as jfix
from trt_asr_tpu_torch import parity
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.contract import DEFAULT_CONTRACT_PATH, load_contract
from trt_asr_tpu_torch.debug.tdt_trace import compare_traces, load_trace
from trt_asr_tpu_torch.io import fixtures

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "artifacts", "goldens")
ENC_GOLDEN = os.path.join(GOLDENS, "streaming_encoder_reference.jsonl")
TRACE_GOLDEN = os.path.join(GOLDENS, "tdt_trace.jsonl")


def test_load_contract_equals_jax():
    c, jc = load_contract(), j_load_contract()
    assert DEFAULT_CONTRACT_PATH == os.path.join(ROOT, "contracts", "parakeet-tdt-0.6b-v3.json")
    assert [f.name for f in dataclasses.fields(c)] == [f.name for f in dataclasses.fields(jc)]
    for f in dataclasses.fields(c):
        got, want = getattr(c, f.name), getattr(jc, f.name)
        assert (dataclasses.asdict(got) if dataclasses.is_dataclass(got) else got) == (
            dataclasses.asdict(want) if dataclasses.is_dataclass(want) else want), f.name
    assert c.validate() == jc.validate() == []


def _set(path, value):
    def mutate(raw):
        node = raw
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return mutate


# one mutation a rule of Contract.validate, in its order
MUTATIONS = {
    "hop_length": _set(("frontend", "hop_length"), 161),
    "encoder_frame_shift": _set(("timebase", "encoder_frame_shift_ms"), 81),
    "subsampling_factor": _set(("encoder", "subsampling", "factor"), 4),
    "feat_in": _set(("encoder", "feat_in"), 80),
    "token_head_size": _set(("joint", "token_head", "size"), 8194),
    "joint_vocab_size": _set(("joint", "joint_vocab_size"), 8199),
    "blank_id": _set(("joint", "blank_id"), 8191),
    "duration_head_offset": _set(("joint", "duration_head", "offset"), 8194),
    "shift_size": _set(("streaming", "shift_size_frames"), [17, 25]),
    "chunk_size": _set(("streaming", "chunk_size_frames"), [41, 49]),
    "time_context": _set(("streaming", "cache_time_context_size"), 5),
}


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_validate_equals_jax_on_a_broken_contract(rule, tmp_path):
    with open(DEFAULT_CONTRACT_PATH) as f:
        raw = json.load(f)
    MUTATIONS[rule](raw)
    path = str(tmp_path / "broken.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    with pytest.raises(ValueError) as got:
        load_contract(path)
    with pytest.raises(ValueError) as want:
        j_load_contract(path)
    assert str(got.value) == str(want.value)
    assert "failed validation" in str(got.value)


SERIES = {"all_clean": [1e-6] * 50, "f32_floor": [2.9e-4] * 30, "bf16_class": [1.2e-3] * 30,
          "one_outlier": [1e-5] * 99 + [2e-3], "fails_all": [5e-2] * 10}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_rung_verdicts_equal_jax(name):
    got = load_contract().tolerances.rung_verdicts(SERIES[name])
    want = j_load_contract().tolerances.rung_verdicts(SERIES[name])
    assert got == want


def test_rung_verdicts_refuse_an_empty_series():
    with pytest.raises(ValueError, match="empty error series"):
        load_contract().tolerances.rung_verdicts([])
    with pytest.raises(ValueError, match="empty error series"):
        j_load_contract().tolerances.rung_verdicts([])


def test_model_config_from_contract_equals_jax():
    got = ModelConfig.from_contract(load_contract())
    want = JModelConfig.from_contract(j_load_contract())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == ModelConfig()


def test_fixtures_roundtrip_and_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    recs = [{"type": "meta", "n": np.int64(3), "x": np.float32(0.5)},
            {"a": rng.standard_normal((2, 3)).astype(np.float32),
             "nested": {"i": np.arange(4, dtype=np.int64), "l": [np.ones(2, np.float16), 7]}}]
    p, jp = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert fixtures.write_jsonl(p, recs) == jfix.write_jsonl(jp, recs) == 2
    assert open(p, "rb").read() == open(jp, "rb").read()
    back = list(fixtures.read_jsonl(p))
    np.testing.assert_array_equal(back[1]["a"], recs[1]["a"])
    assert back[1]["nested"]["l"][0].dtype == np.float16 and back[1]["nested"]["l"][1] == 7
    assert back[0] == {"type": "meta", "n": 3, "x": 0.5}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_fixtures_decode_the_committed_golden_as_jax():
    got, want = fixtures.read_jsonl(ENC_GOLDEN), jfix.read_jsonl(ENC_GOLDEN)
    for _ in range(3):
        _assert_same(next(got), next(want))


@pytest.mark.parametrize("mode,kernels", [("closedloop", False), ("functional", False),
                                          ("closedloop", True)])
def test_runner_clears_ort_f32_on_the_encoder_golden(mode, kernels, tmp_path):
    summary = str(tmp_path / "s.json")
    argv = ["--goldens", ENC_GOLDEN, "--mode", mode, "--config", "tiny", "--seed", "1",
            "--device", "cpu", "--summary", summary] + (["--kernels"] if kernels else [])
    assert parity.main(argv) == 0
    with open(summary) as f:
        s = json.load(f)
    assert s["num_chunks"] == 50 and s["pass_rate"] == 1.0
    assert s["best_rung"] == "ort_f32"
    assert s["encoder_output_error_distribution"]["max"] < 1e-4
    assert set(s) >= {"rung_verdicts", "encoder_output_error_distribution", "pass_rate",
                      "best_rung", "timing_ms", "per_chunk"}


def test_runner_fails_on_wrong_weights(capsys):
    assert parity.main(["--goldens", ENC_GOLDEN, "--mode", "functional", "--config", "tiny",
                        "--seed", "99", "--device", "cpu", "--max-chunks", "5"]) == 1
    assert "0/5 PASS" in capsys.readouterr().out


def test_trace_identical_to_the_golden(tmp_path, capsys):
    out = str(tmp_path / "port_trace.jsonl")
    assert parity.main(["--mode", "trace", "--goldens", TRACE_GOLDEN, "--config", "tiny",
                        "--seed", "1", "--frames", "300", "--feats-seed", "0",
                        "--device", "cpu", "--out", out]) == 0
    assert "IDENTICAL" in capsys.readouterr().out
    ok, verdict = compare_traces(TRACE_GOLDEN, out)
    assert ok and verdict.startswith("traces IDENTICAL: 38 steps"), verdict
    tool = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "parity",
                                                        "compare_tdt_trace.py"),
                           TRACE_GOLDEN, out], capture_output=True, text=True, timeout=60)
    assert tool.returncode == 0 and "IDENTICAL" in tool.stdout, tool.stdout
    # the comparator finds a divergence where the tool does
    meta, steps = load_trace(out)
    steps[5] = dict(steps[5], best_tok=steps[5]["best_tok"] + 1)
    ok, verdict = compare_traces(TRACE_GOLDEN, (meta, steps))
    assert not ok and verdict.startswith("FIRST DIVERGENCE at step 5: fields ['best_tok']")
    ok, verdict = compare_traces(TRACE_GOLDEN, (meta, load_trace(out)[1][:-1]))
    assert not ok and verdict.startswith("LENGTH MISMATCH")


def test_new_modules_and_the_runner_import_nothing_of_jax():
    code = (
        "import sys\n"
        "import trt_asr_tpu_torch.contract, trt_asr_tpu_torch.io.fixtures\n"
        "import trt_asr_tpu_torch.decode.host_decode, trt_asr_tpu_torch.debug.tdt_trace\n"
        "import trt_asr_tpu_torch.debug.taps, trt_asr_tpu_torch.debug.snapshot\n"
        "import trt_asr_tpu_torch.debug.nan_guard, trt_asr_tpu_torch.debug.profiler\n"
        "import trt_asr_tpu_torch.debug.stage_markers\n"
        "from trt_asr_tpu_torch import parity\n"
        f"rc = parity.main(['--mode', 'trace', '--goldens', {TRACE_GOLDEN!r}, '--device', 'cpu'])\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'trt_asr_tpu')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
    assert "IDENTICAL" in out.stdout


def test_runner_needs_cuda_unless_asked_for_cpu():
    import torch

    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        parity.main(["--mode", "trace"])
