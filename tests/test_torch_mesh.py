"""The device mesh of the PyTorch port (``parallel/mesh.py``) against the
JAX package's ``parallel/mesh.py``: the spec table equals JAX's for every
leaf path and rank of the tiny and the full-width trees (the full-width one
from ``empty_params_numpy``: nothing drawn), and so do the shardings with
the drop of axes that do not divide (dp 1, tp 2: JAX on two of the test
harness's virtual CPU devices), the state and batch shardings too;
``make_mesh``'s assertion; on a one-device mesh ``transcribe_batch(mesh=)``
and the engine's ``mesh=`` equal their
``mesh=None`` runs and JAX's on a one-device mesh; the beam and engine
refusals with JAX's text; a mesh of two devices raises; ``python -m
trt_asr_tpu_torch.train.toy --mesh`` trains as without it.

Tolerance: specs, tokens and printed losses exact."""

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.parallel import mesh as jmesh
from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine as JEngine
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import empty_params_numpy
from trt_asr_tpu_torch.parallel import mesh as pmesh
from trt_asr_tpu_torch.runtime.engine import EngineSet
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
from trt_asr_tpu_torch.tokenizer import Tokenizer
from trt_asr_tpu_torch.train import toy

RT = dict(suppress_leading_punct=False)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    jm = JModel.random(JConfig.tiny(), seed=5)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                     Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                     runtime=RuntimeConfig(), device="cpu")
    return jm, pm


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _specs(shardings):
    return {p: tuple(s.spec) for p, s in _leaves(shardings)}


@pytest.mark.parametrize("cfg", [ModelConfig.tiny(), ModelConfig()], ids=["tiny", "full"])
def test_spec_table_and_shardings_match_jax(cfg):
    params = empty_params_numpy(cfg)
    leaves = list(_leaves(params))
    assert len(leaves) > 40
    for path, leaf in leaves:
        for ndim in {leaf.ndim, 1, 2, 3}:
            assert tuple(pmesh._tp_spec_for(path, ndim)) == tuple(jmesh._tp_spec_for(path, ndim)), \
                (path, ndim)
    # the drop of axes that do not divide, on a dp 1 x tp 2 mesh
    got = _specs(pmesh.param_shardings(params, pmesh.make_mesh(dp=1, tp=2, devices=[CPU, CPU])))
    want = _specs(jmesh.param_shardings(params, jmesh.make_mesh(dp=1, tp=2,
                                                                devices=jax.devices()[:2])))
    assert got == want
    assert any("tp" in s for s in got.values())


def test_state_and_batch_shardings_match_jax():
    m, jm = pmesh.make_mesh(devices=[CPU]), jmesh.make_mesh(devices=jax.devices()[:1])
    for got, want in ((pmesh.encoder_state_shardings(m), jmesh.encoder_state_shardings(jm)),
                      (pmesh.decode_state_shardings(m), jmesh.decode_state_shardings(jm))):
        assert got._fields == want._fields
        assert [tuple(s.spec) for s in got] == [tuple(s.spec) for s in want]
    for ndim in (1, 3):
        assert (tuple(pmesh.batch_sharding(m, ndim).spec)
                == tuple(jmesh.batch_sharding(jm, ndim).spec))


def test_make_mesh():
    m = pmesh.make_mesh(devices=[CPU])
    assert m.shape == {"dp": 1, "tp": 1} and m.size == 1 and m.device() == CPU
    with pytest.raises(AssertionError, match=r"dp\(2\) \* tp\(1\) != devices\(1\)"):
        pmesh.make_mesh(dp=2, devices=[CPU])
    with pytest.raises(AssertionError, match=r"dp\(2\) \* tp\(1\) != devices\(1\)"):
        jmesh.make_mesh(dp=2, devices=jax.devices()[:1])
    assert pmesh.make_mesh(tp=2, devices=[CPU, CPU]).shape == {"dp": 1, "tp": 2}


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * (250 + 30 * seed) * t / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _engine_tokens(eng, audios):
    sids = [eng.open_stream() for _ in audios]
    for sid, a in zip(sids, audios):
        eng.push_audio(sid, a)
        eng.finalize_stream(sid)
    eng.run_until_drained()
    return [list(eng._tokens[sid]) for sid in sids]


def test_one_device_mesh_equals_no_mesh_and_jax(models):
    jm, pm = models
    audios = [_audio(30000, 1), _audio(20000, 2)]
    mesh = pmesh.make_mesh(devices=[CPU])
    jax_mesh = jmesh.make_mesh(devices=jax.devices()[:1])
    got = pm.transcribe_batch(audios, mesh=mesh)
    assert got == pm.transcribe_batch(audios) == jm.transcribe_batch(audios, mesh=jax_mesh)
    assert any(ids for _, ids in got)
    eng = BatchStreamingEngine(pm, batch_size=2, runtime=RuntimeConfig(**RT), mesh=mesh)
    toks = _engine_tokens(eng, audios)
    assert toks == _engine_tokens(BatchStreamingEngine(pm, batch_size=2,
                                                       runtime=RuntimeConfig(**RT)), audios)
    assert toks == _engine_tokens(JEngine(jm, batch_size=2, runtime=JRuntime(**RT),
                                          mesh=jax_mesh), audios)
    assert any(toks)


def test_refusals_match_jax(models):
    jm, pm = models
    one, jone = pmesh.make_mesh(devices=[CPU]), jmesh.make_mesh(devices=jax.devices()[:1])
    es = EngineSet({}, {})
    for kw, jkw, match in (
            (dict(beam=4, mesh=one), dict(beam=4, mesh=jone), "beam serving is single-device"),
            (dict(beam=4, engines=es), dict(beam=4, engines=es), "beam serving runs live-jit"),
            (dict(engines=es, mesh=one), dict(engines=es, mesh=jone),
             "AOT engines are single-device artifacts")):
        with pytest.raises(ValueError, match=match):
            BatchStreamingEngine(pm, batch_size=2, **kw)
        with pytest.raises(ValueError, match=match):
            JEngine(jm, batch_size=2, **jkw)
    two = pmesh.make_mesh(dp=2, devices=[CPU, CPU])
    with pytest.raises(ValueError, match="batch_size 3 must divide over dp=2 slots"):
        BatchStreamingEngine(pm, batch_size=3, mesh=two)
    with pytest.raises(ValueError, match="batch_size 3 must divide over dp=2 slots"):
        JEngine(jm, batch_size=3, mesh=jmesh.make_mesh(dp=2, devices=jax.devices()[:2]))


def test_multi_device_mesh_raises(models):
    _, pm = models
    two = pmesh.make_mesh(dp=2, devices=[CPU, CPU])
    for call in (lambda: BatchStreamingEngine(pm, batch_size=2, mesh=two),
                 lambda: pm.transcribe_batch([_audio(8000, 1)], mesh=two),
                 lambda: pmesh.shard_params(pm.params, two),
                 lambda: pmesh.shard_batch(np.zeros(2), two)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 10"):
            call()
    # a one-device mesh on another device than the model's is refused
    other = pmesh.make_mesh(devices=[torch.device("meta")])
    for call in (lambda: BatchStreamingEngine(pm, batch_size=2, mesh=other),
                 lambda: pm.transcribe_batch([_audio(8000, 1)], mesh=other)):
        with pytest.raises(ValueError, match="is not the model's"):
            call()


def _toy(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        assert toy.main(argv) == 0
    return [ln for ln in out.getvalue().splitlines()
            if ln.startswith(("step", "recovered", "mesh"))]


def test_toy_mesh_trains_as_without():
    with_mesh = _toy(["--steps", "4", "--device", "cpu", "--mesh"])
    assert with_mesh[0] == "mesh: dp=1 tp=1"
    assert with_mesh[1:] == _toy(["--steps", "4", "--device", "cpu"])
