"""The port's randomized session fuzz (``trt_asr_tpu_torch/tools/fuzz_session.py``)
against the repo's JAX tool (``tools/fuzz_session.py``), both in this
process on ``ModelConfig.tiny()`` at seed 7:

- the tiny model's leaves equal JAX's ``init_params`` at seed 7, so both
  tools decode with the same weights;
- the random draws (audio, push plans, and so each seed's ``samples``)
  equal the JAX tool's, and the committed artifact's for its first seeds;
- ``run_seed`` at seeds 11 and 12 over all six surfaces: the same record
  (samples, tokens, surfaces, no failure), and each surface's token list
  equal to the JAX surface's;
- the harness fails when a surface diverges (the sabotaged time carry on
  ``shreds``, mirroring ``tests/test_fuzz_session.py``);
- the JAX-only ``onnx`` surface raises, naming what it waits for.

Tolerance: none; tokens and draws are exact.
"""

import json
import os

import numpy as np
import pytest

from torch_port_helpers import assert_tree_equal, np_tree, one_torch_thread  # noqa: F401

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import init_params_numpy, params_to_numpy
from trt_asr_tpu_torch.tools import fuzz_session as fz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = ["shreds", "snapshot", "engine", "beam1", "batchbeam"]
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_tool():
    import importlib
    import sys

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return importlib.import_module("tools.fuzz_session")


@pytest.fixture(scope="module")
def jax_model():
    from trt_asr_tpu.config import ModelConfig as JConfig
    from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel

    return JModel.random(JConfig.tiny(), seed=7)


@pytest.fixture(scope="module")
def model():
    return ParakeetTDT.random(ModelConfig.tiny(), seed=7, device="cpu")


def test_tiny_leaves_match_jax_init_params(jax_model, model):
    from trt_asr_tpu.config import ModelConfig as JConfig
    from trt_asr_tpu.models.parakeet.params import init_params as jax_init_params

    want = np_tree(jax_init_params(JConfig.tiny(), seed=7))
    assert_tree_equal(init_params_numpy(ModelConfig.tiny(), seed=7), want)
    assert_tree_equal(params_to_numpy(model.params), want)
    assert_tree_equal(np_tree(jax_model.params), want)
    assert model.tokenizer.vocab == list(jax_model.tokenizer.vocab)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_draws_match_jax(seed):
    jt = jax_tool()
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    n = int(a.integers(4800, 128000))
    assert n == int(b.integers(4800, 128000))
    assert fz.random_audio(a, n).tobytes() == jt.random_audio(b, n).tobytes()
    assert fz.random_pushes(a, n) == jt.random_pushes(b, n)
    assert a.integers(0, 1 << 30) == b.integers(0, 1 << 30)   # streams still in step


def test_samples_match_committed_artifact():
    """A seed's length is its first draw, made before any model runs."""
    with open(os.path.join(ROOT, "artifacts", "fuzz_session.json")) as f:
        results = json.load(f)["results"]
    for r in results[:50]:
        rng = np.random.default_rng(r["seed"])
        assert int(rng.integers(int(0.3 * 16000), 8 * 16000)) == r["samples"], r["seed"]


def record_jax_tokens(mp, log: list) -> None:
    """Append each JAX session's tokens at its (outermost) finalize, and an
    engine's first finalized stream's once drained, in call order."""
    from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine
    from trt_asr_tpu.streaming.beam_session import BeamStreamingSession
    from trt_asr_tpu.streaming.session import StreamingSession

    depth = [0]
    for cls in (StreamingSession, BeamStreamingSession):
        def finalize(self, *a, _orig=cls.__dict__["finalize"], **kw):
            depth[0] += 1
            try:
                return _orig(self, *a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    log.append(list(self._tokens))
        mp.setattr(cls, "finalize", finalize)
    real_fin, real_drain = BatchStreamingEngine.finalize_stream, BatchStreamingEngine.run_until_drained

    def finalize_stream(self, sid):
        self.__dict__.setdefault("_fuzz_sid", sid)
        return real_fin(self, sid)

    def run_until_drained(self, *a, **kw):
        out = real_drain(self, *a, **kw)
        log.append(list(self._tokens[self._fuzz_sid]))
        return out

    mp.setattr(BatchStreamingEngine, "finalize_stream", finalize_stream)
    mp.setattr(BatchStreamingEngine, "run_until_drained", run_until_drained)


@pytest.fixture(scope="module")
def fuzz_runs(jax_model, model):
    """{seed: (port record, port tokens, JAX record, JAX tokens)} over all
    surfaces; JAX's tokens in its call order: single, shreds, snapshot,
    engine, beam1, the device-beam reference, batchbeam."""
    jt = jax_tool()
    out = {}
    for seed in (11, 12):
        log: list = []
        with pytest.MonkeyPatch.context() as mp:
            record_jax_tokens(mp, log)
            want = jt.run_seed(jax_model, seed, ALL)
        names = ["single", "shreds", "snapshot", "engine", "beam1", "batchbeam_ref", "batchbeam"]
        assert len(log) == len(names)
        toks: dict = {}
        got = fz.run_seed(model, seed, ALL, tokens_out=toks)
        out[seed] = (got, toks, want, dict(zip(names, log)))
    return out


@pytest.mark.parametrize("seed", [11, 12])
def test_run_seed_matches_jax(fuzz_runs, seed):
    got, _, want, _ = fuzz_runs[seed]
    assert got == want
    assert got["fails"] == {} and got["tokens"] > 0
    assert got["surfaces"] == sorted(["single"] + ALL)


@pytest.mark.parametrize("seed", [11, 12])
def test_surface_tokens_match_jax(fuzz_runs, seed):
    _, toks, _, jax_toks = fuzz_runs[seed]
    assert set(toks) == set(jax_toks)
    for name in jax_toks:
        assert toks[name] == jax_toks[name], name
    assert toks["single"] and toks["batchbeam_ref"]


def test_fuzz_detects_divergence(model, monkeypatch):
    """The harness must fail when a surface diverges: the time-carry
    sabotage on every session but the canonical one, on ``shreds``."""
    from trt_asr_tpu_torch.streaming.session import StreamingSession

    real_init = StreamingSession.__init__
    calls = {"n": 0}

    def patched(self, *a, **kw):
        real_init(self, *a, **kw)
        calls["n"] += 1
        if calls["n"] > 1:      # leave the canonical session clean
            self.rt = type(self.rt)(**{**self.rt.__dict__, "sabotage": "drop_time_carry"})

    monkeypatch.setattr(StreamingSession, "__init__", patched)
    # scan seeds until one carries a duration overshoot across a chunk
    # boundary (not every random utterance does)
    for seed in range(20, 40):
        r = fz.run_seed(model, seed, ["shreds"])
        if r["fails"]:
            assert set(r["fails"]) == {"shreds"}
            return
    pytest.fail("sabotaged surface never diverged over 20 seeds")


def test_onnx_surface_raises(model, capsys):
    with pytest.raises(NotImplementedError, match="tools/onnx_pipeline.py"):
        fz.run_seed(model, 0, ["onnx"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 15"):
        fz.main(["--seeds", "1", "--surfaces", "shreds,onnx", "--device", "cpu"])


def test_main_writes_the_jax_tools_summary(tmp_path, capsys):
    out = tmp_path / "fuzz.json"
    assert fz.main(["--seeds", "2", "--seed-base", "11", "--surfaces", "shreds,snapshot",
                    "--out", str(out), "--device", "cpu"]) == 0
    summary = json.loads(out.read_text())
    assert set(summary) == {"seeds", "failures", "surfaces", "wall_s", "results"}
    assert summary["failures"] == 0 and summary["surfaces"] == ["shreds", "snapshot"]
    assert [r["seed"] for r in summary["results"]] == [11, 12]
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("2/2 seeds token-exact across 3 surfaces")
