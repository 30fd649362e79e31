"""Engine sets and the compile cache of the PyTorch port
(``runtime/engine.py``, ``ops/kernels/build.py``'s library directory)
against the JAX package's ``runtime/engine.py`` on ``ModelConfig.tiny()``
(the same weights on both sides): the program sets' names, feature shapes
and static values equal JAX's; keys are distinct, read no values, and move
with a static, the weights' dtype and the quant scope; the manifest records
every file's bytes and sha256 and every program's statics; a corrupt record
raises "sha256 mismatch", a library of other sources raises, build-time
numerics other than the server's warn and miss (counted); a session served
from a set equals the live port and the JAX session token for token, and
the lockstep engine (B = 2) the live port's, with zero misses; the compile
cache in a
subprocess; the library directory refuses a second build of a loaded
library; ``python -m trt_asr_tpu_torch.engine_build`` builds and inspects.

Tolerance: tokens exact."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.runtime import engine as jengine
from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine as JEngine
from trt_asr_tpu.streaming.session import StreamingSession as JSession
from trt_asr_tpu_torch import engine_build
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.kernels import build
from trt_asr_tpu_torch.runtime.engine import (EngineSet, batch_program_specs, build_engines,
                                              program_key, session_program_specs)
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
from trt_asr_tpu_torch.streaming.session import StreamingSession
from trt_asr_tpu_torch.tokenizer import Tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RT = dict(suppress_leading_punct=False)
KERNELS = dict(use_pallas_att=True, use_pallas_joint=True, use_pallas_ffn=True,
               use_pallas_conv=True)
# JAX statics with no port counterpart: the port's step decides these itself
# (a punct mask given or not, one decode loop for both routes, stamps always)
JAX_ONLY = {"use_punct_mask", "use_batched_decode", "with_timestamps"}
# tables, None where absent: data, not statics (JAX's attention kernel reads
# a transposed copy, pos_projT, the port's the padded table as pos_proj)
TABLES = {"pos_proj", "pos_projT", "punct_mask"}


@pytest.fixture(scope="module")
def models():
    jm = JModel.random(JConfig.tiny(), seed=5)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                     Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                     runtime=RuntimeConfig(), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def engine_dir(models, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("engines"))
    build_engines(models[1], d, runtime=RuntimeConfig(**RT), batch_sizes=(2,))
    return d


def _audio(n=40000, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * 280 * t / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _statics(kwargs):
    return {k: v for k, v in kwargs.items()
            if k not in TABLES and (v is None or isinstance(v, (bool, int, float, str)))}


@pytest.mark.parametrize("flags", [{}, KERNELS], ids=["plain", "kernels"])
def test_program_sets_match_jax(models, flags):
    jm, pm = models
    got = session_program_specs(pm, RuntimeConfig(**RT, **flags))
    want = jengine.session_program_specs(jm, JRuntime(**RT, **flags))
    got += batch_program_specs(pm, 2, RuntimeConfig(**RT, **flags))
    want += jengine.batch_program_specs(jm, 2, JRuntime(**RT, **flags))
    assert [s.name for s in got] == [s.name for s in want] == [
        "chunk0", "steady", "flush0", "flush", "batch2"]
    for g, w in zip(got, want):
        assert tuple(g.args[1].shape) == tuple(np.shape(w.args[2])), g.name
        gs, ws = _statics(g.kwargs), _statics(w.kwargs)
        assert set(ws) - set(gs) <= JAX_ONLY and set(gs) <= set(ws), g.name
        assert {k: gs[k] for k in gs} == {k: ws[k] for k in gs}, g.name
    assert got[1].kwargs["use_pallas_att"] is bool(flags)      # the steady chunk's kernel


def test_keys(models):
    jm, pm = models
    specs = session_program_specs(pm, RuntimeConfig(**RT)) + batch_program_specs(pm, 2)
    keys = [s.key for s in specs]
    assert len(set(keys)) == len(keys)
    steady = specs[1]
    # values do not enter: other features, tokens and states, the same key
    x = torch.randn_like(steady.args[1])
    enc = steady.args[3]._replace(att_cache=torch.randn_like(steady.args[3].att_cache))
    args = (steady.args[0], x, np.int32(3), enc, steady.args[4])
    assert program_key(args, {**steady.kwargs, "emitted_so_far": np.int32(9)}) == steady.key
    # a static's value, the weights' dtype and the quant scope do
    assert program_key(steady.args, {**steady.kwargs, "blank_penalty": 1.5}) != steady.key
    for kw in (dict(weights_dtype=torch.bfloat16),
               dict(runtime=RuntimeConfig(quant="joint"))):
        other = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params), pm.tokenizer,
                            **{"runtime": RuntimeConfig(), **kw}, device="cpu")
        [o] = [s for s in session_program_specs(other, RuntimeConfig(**RT)) if s.name == "steady"]
        assert o.key != steady.key, kw


def test_manifest(engine_dir):
    with open(os.path.join(engine_dir, "manifest.json")) as f:
        manifest = json.load(f)
    eng = manifest["engines"]
    assert set(eng) == {"chunk0", "steady", "flush0", "flush", "batch2"}
    for name, e in eng.items():
        data = open(os.path.join(engine_dir, e["file"]), "rb").read()
        assert len(data) == e["bytes"] and hashlib.sha256(data).hexdigest() == e["sha256"]
        rec = json.loads(data)
        assert rec["key"] == e["key"] and rec["statics"] == e["statics"]
        assert rec["inputs"] and rec["outputs"] and e["smoke"]["ok"] is True
    assert eng["flush"]["statics"]["cache_drop"] == 0 and eng["flush"]["statics"]["valid_cap"] is None
    assert eng["steady"]["statics"]["cache_drop"] == ModelConfig.tiny().cache_drop_size
    assert eng["chunk0"]["feats_shape"] == [1, 41, 32] and eng["batch2"]["feats_shape"] == [2, 57, 32]
    b = manifest["build"]
    assert b["quant"] == "none" and b["weights_dtype"] == ["float32"] and b["platform"] == "cpu"
    assert (b["compute_dtype"], b["decode_dtype"]) == ("bfloat16", "float32")
    assert b["f32_policy"] == {"matmul_tf32": False, "cudnn_tf32": False,
                               "bf16_reduced_reduction": False}
    # built without a card: no library, and the manifest says so
    assert manifest["libraries"] == {} and "without a card" in b["libraries_note"]


def test_corrupt_record_and_foreign_library_raise(engine_dir, tmp_path):
    import shutil

    bad = tmp_path / "corrupt"
    shutil.copytree(engine_dir, bad)
    p = bad / "steady.json"
    data = bytearray(p.read_bytes())
    data[10] ^= 1
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="sha256 mismatch"):
        EngineSet.load(str(bad), runtime=RuntimeConfig(**RT))
    foreign = tmp_path / "foreign"
    shutil.copytree(engine_dir, foreign)
    (foreign / "libs").mkdir()
    lib = foreign / "libs" / "mel-000000000000.so"
    lib.write_bytes(b"not this tree's build")
    manifest = json.loads((foreign / "manifest.json").read_text())
    manifest["libraries"] = {"mel": {"file": "libs/" + lib.name, "bytes": lib.stat().st_size,
                                     "sha256": hashlib.sha256(lib.read_bytes()).hexdigest(),
                                     "source_hash": "000000000000"}}
    (foreign / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="C interface may differ"):
        EngineSet.load(str(foreign), runtime=RuntimeConfig(**RT))
    assert "mel" not in build._bound


def _run(sess, audio, piece=8000):
    for s in range(0, len(audio), piece):
        sess.push_audio(audio[s:s + piece])
    sess.finalize()
    return sess


def _engine_tokens(eng, audios):
    """Each stream's FINAL tokens (the JAX and the port's engines alike)."""
    sids = [eng.open_stream() for _ in audios]
    for sid, a in zip(sids, audios):
        eng.push_audio(sid, a)
        eng.finalize_stream(sid)
    eng.run_until_drained()
    finals = []
    for sid in sids:
        evs = []
        while (e := eng.poll_event(sid)) is not None:
            evs.append(e)
        finals.append([list(e.tokens) for e in evs if e.type == 1])
    return finals


def test_served_equals_live_and_jax(models, engine_dir):
    jm, pm = models
    es = EngineSet.load(engine_dir, runtime=RuntimeConfig(**RT))
    assert len(es) == 5
    audio = _audio()
    served = _run(StreamingSession(pm, RuntimeConfig(**RT), engines=es), audio)
    live = _run(StreamingSession(pm, RuntimeConfig(**RT)), audio)
    jax = _run(JSession(jm, JRuntime(**RT)), audio)
    assert served.tokens == live.tokens == list(jax._tokens) and served.tokens
    assert served.engine_misses == 0 and served.engine_hits == len(live.chunk_latencies_ms)
    audios = [audio, _audio(24000, 7)]
    eng = BatchStreamingEngine(pm, batch_size=2, runtime=RuntimeConfig(**RT), engines=es)
    assert eng.warmup() > 0
    got = _engine_tokens(eng, audios)
    live = _engine_tokens(BatchStreamingEngine(pm, batch_size=2, runtime=RuntimeConfig(**RT)),
                          audios)
    jax = _engine_tokens(JEngine(jm, batch_size=2, runtime=JRuntime(**RT)), audios)
    assert got == live == jax and all(f and f[0] for f in got)
    assert eng.engine_misses == 0 and eng.engine_hits == len(eng.step_latencies_ms) > 0


def test_build_numerics_mismatch_warns_and_misses(models, engine_dir):
    jm, pm = models
    rt = RuntimeConfig(quant="joint", **RT)
    with pytest.warns(UserWarning, match="quant=none"):
        es = EngineSet.load(engine_dir, runtime=rt)
    q8 = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params), pm.tokenizer, runtime=rt,
                     device="cpu")
    audio = _audio(24000)
    served = _run(StreamingSession(q8, rt, engines=es), audio)
    assert served.engine_hits == 0 and served.engine_misses == len(served.chunk_latencies_ms)
    assert served.tokens == _run(StreamingSession(q8, rt), audio).tokens


def test_compile_cache_in_a_subprocess(tmp_path):
    """A fresh process with TRT_ASR_COMPILE_CACHE builds into and loads from
    the cache (``apply_compile_cache`` at model construction), and refuses
    another cache after it."""
    cache = tmp_path / "cache"
    code = ("from trt_asr_tpu_torch.config import ModelConfig\n"
            "from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT\n"
            "from trt_asr_tpu_torch.ops.kernels import build\n"
            "from trt_asr_tpu_torch.runtime.engine import apply_compile_cache\n"
            "before = build.BUILD_DIR\n"
            "ParakeetTDT.random(ModelConfig.tiny(), device='cpu')\n"
            "apply_compile_cache(build.BUILD_DIR)\n"
            "try:\n"
            "    apply_compile_cache(before)\n"
            "except RuntimeError as e:\n"
            "    refused = 'refused' in str(e)\n"
            "print(before, build.BUILD_DIR, build.lib_file('mel').parent, refused)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT, TRT_ASR_COMPILE_CACHE=str(cache)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    before, after, lib_parent, refused = out.stdout.split()
    assert before.endswith("_build") and after == lib_parent == str(cache) and cache.is_dir()
    assert refused == "True"


def _held(monkeypatch, tmp_path):
    """A library ``mel`` held from ``a/`` (bytes "build one"), and two
    directories with a copy of it: ``same`` (the same bytes) and ``other``."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.setattr(build, "_cache_dir", None)
    monkeypatch.setattr(build, "_bound", {})
    name = build.lib_file("mel", tmp_path).name
    dirs = {}
    for d, data in (("a", b"build one"), ("same", b"build one"), ("other", b"build two")):
        (tmp_path / d).mkdir()
        (tmp_path / d / name).write_bytes(data)
        dirs[d] = tmp_path / d
    monkeypatch.setattr(build, "_held_sha", {"mel": build.file_sha256(dirs["a"] / name)})
    return name, dirs


@pytest.mark.parametrize("how", ["compile_cache", "bind"])
def test_a_second_build_of_a_held_library_is_refused(monkeypatch, tmp_path, how):
    """Once a library is held, a compile cache or an engine set's copy with
    other bytes is refused; one with the same bytes (an engine set's pinned
    copy) is taken. The compile cache is one-way."""
    name, dirs = _held(monkeypatch, tmp_path)
    if how == "bind":
        build.bind("mel", dirs["same"] / name)
        assert build._bound["mel"] == dirs["same"] / name
        with pytest.raises(RuntimeError, match="another build of mel"):
            build.bind("mel", dirs["other"] / name)
        assert build._bound["mel"] == dirs["same"] / name
        return
    with pytest.raises(RuntimeError, match="another build of mel"):
        build.apply_compile_cache(dirs["other"])
    build.apply_compile_cache(dirs["same"])
    assert build.BUILD_DIR == dirs["same"]
    build.apply_compile_cache(dirs["same"])            # the same cache again: no-op
    with pytest.raises(RuntimeError, match="for this process's life"):
        build.apply_compile_cache(dirs["a"])
    assert build.BUILD_DIR == dirs["same"]


def test_engine_build_cli(tmp_path, capsys):
    out = str(tmp_path / "eng")
    assert engine_build.main(["--config", "tiny", "--outdir", out, "--batch", "2",
                              "--device", "cpu", "--no-smoke"]) == 0
    text = capsys.readouterr().out
    assert "built 5 programs and 0 kernel libraries" in text and "smoke=skipped" in text
    assert engine_build.main(["--inspect", out]) == 0
    text = capsys.readouterr().out
    assert "loaded + sha256-verified 5 programs, 0 kernel libraries" in text
    assert "[batch2]" in text and "feats [2, 57, 32]" in text
