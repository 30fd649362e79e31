"""Engine sets and the compile cache: the port's counterpart of the JAX
package's ``runtime/engine.py``.

JAX's engine takes the trace+compile step out of a serving process:
``jax.export`` artifacts plus XLA's persistent compile cache. In the port
the one compile step is ``nvcc``, which builds the kernel libraries of
``ops/kernels/build.py``. So the port's ahead-of-time artifacts are those
libraries, built once, sha256-pinned and bound from the engine directory.
A program is the eager chunk step itself, keyed by its signature: a
session or an engine serving from a set looks its key up a chunk and
counts the hit or the miss, and runs the same step either way. So the
port has no ``EngineSet.call``: there is no other executable to call.

- :func:`session_program_specs`: the greedy session's four programs
  (chunk0, steady, flush0, flush), from the session's own ``_step_kwargs``;
  :func:`batch_program_specs`: one lockstep program a batch size, from the
  engine's own ``_step_args`` and ``_step_kwargs``, so that an engine
  cannot drift from the serving call.
- :func:`build_engines` writes one record file a program (its key, its
  statics, its input and output shapes and dtypes), a copy of every kernel
  library of ``build.SOURCES`` (on a card; without one it writes none and
  the manifest says so), and ``manifest.json``: build facts, each file's
  bytes and sha256, each library's source hash, each program's smoke
  check (its run's outputs finite, its key found in the set read back).
- :meth:`EngineSet.load` verifies every sha256, refuses a library built
  from other sources than this tree's (its C interface may differ from
  ``build._SIGNATURES``), binds the libraries to their copies in the
  engine directory (``build.bind``), so that a serving process runs no
  ``nvcc``, and warns when the numerics it was built with differ from this
  process's.
- :func:`apply_compile_cache` (``build.apply_compile_cache``) points the
  library directory at a compile cache, once a process: a fresh process
  that finds the libraries there skips ``nvcc``.

The key covers the shapes and dtypes of the tensor arguments, the value of
every static, and what JAX bakes into an exported program: the model's
config, its weights' dtypes (int8 leaves: the quant scope) and the kernel
flags. A session running other numerics than the set's therefore misses,
counted in ``engine_misses``, where a JAX engine hit would run the
numerics it was built with; every step runs the process's own numerics.
The f32 policy is the process's too: :meth:`EngineSet.load` warns when it
differs from the one the set was built under.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.config import RuntimeConfig
from trt_asr_tpu_torch.device import f32_policy
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.kernels import build
from trt_asr_tpu_torch.ops.kernels.build import apply_compile_cache  # noqa: F401 (JAX's name)
from trt_asr_tpu_torch.ops.quant import QuantTensor

LIB_SUBDIR = "libs"
FORMAT = "trt_asr_tpu_torch engine set: program records + kernel libraries"
KERNEL_FLAGS = ("use_pallas_att", "use_pallas_joint", "use_pallas_ffn", "use_pallas_conv")


def _norm(v: Any) -> Any:
    """Canonical JSON-able form of one step argument: statics (Python
    scalars, configs) by value, tensors and arrays by shape and dtype, the
    model by its config, its weights' shapes and dtypes and its quant
    scope: the program's signature, not its data."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, torch.Tensor):
        return ["tensor", list(v.shape), str(v.dtype).replace("torch.", "")]
    if isinstance(v, (np.ndarray, np.generic)):
        return ["array", list(np.shape(v)), str(np.asarray(v).dtype)]
    if isinstance(v, QuantTensor):
        return {"int8": _norm(v.q), "scale": _norm(v.s)}
    if isinstance(v, ParakeetTDT):
        return {"cfg": _norm(v.cfg), "params": _norm(v.params), "quant": v.runtime.quant}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return json.loads(json.dumps(dataclasses.asdict(v), default=list))
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return {"type": type(v).__name__, **{f: _norm(getattr(v, f)) for f in v._fields}}
    if isinstance(v, dict):
        return {str(k): _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    raise TypeError(f"no program signature for a {type(v).__name__}")


def program_key(args: Tuple, kwargs: Dict[str, Any]) -> str:
    """Deterministic signature key of one (args, kwargs) invocation of a
    chunk program: shapes and dtypes of the tensors, values of the statics."""
    payload = json.dumps([[_norm(a) for a in args],
                          {k: _norm(v) for k, v in sorted(kwargs.items())}],
                         sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _is_static(v: Any) -> bool:
    return v is None or isinstance(v, (bool, int, float, str))


def _avals(v: Any, path: str) -> List[list]:
    """[path, shape, dtype] of every tensor or array in ``v`` (an int leaf:
    [path, "int"]); the model contributes its weights."""
    if isinstance(v, torch.Tensor):
        return [[path, list(v.shape), str(v.dtype).replace("torch.", "")]]
    if isinstance(v, (np.ndarray, np.generic)):
        return [[path, list(np.shape(v)), str(np.asarray(v).dtype)]]
    if isinstance(v, ParakeetTDT):
        return _avals(v.params, f"{path}.params")
    if isinstance(v, tuple) and hasattr(v, "_fields"):
        return [a for f in v._fields for a in _avals(getattr(v, f), f"{path}.{f}")]
    if isinstance(v, dict):
        return [a for k, x in v.items() for a in _avals(x, f"{path}/{k}")]
    if isinstance(v, (list, tuple)):
        return [a for i, x in enumerate(v) for a in _avals(x, f"{path}[{i}]")]
    if isinstance(v, int) and not isinstance(v, bool):
        return [[path, "int"]]
    return []


@dataclass
class ProgramSpec:
    """One buildable program: a name, its step function, the exact call."""

    name: str
    fn: Any
    args: Tuple
    kwargs: Dict[str, Any]

    @property
    def key(self) -> str:
        return program_key(self.args, self.kwargs)


def session_program_specs(model: ParakeetTDT, runtime: Optional[RuntimeConfig] = None
                          ) -> List[ProgramSpec]:
    """The greedy session's program set: chunk0 (41 frames at full width),
    the steady chunk (57), and the finalize flush at both geometries
    (cache_drop 0, uncapped valid length), each on fresh states."""
    from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler
    from trt_asr_tpu_torch.streaming.session import StreamingSession, _session_step

    sess = StreamingSession(model, runtime)
    cfg = model.cfg
    first_chunk = cfg.chunk_size_frames[0]
    sch = ChunkScheduler(cfg)
    chunk0 = sch.next_ready(first_chunk)
    steady = sch.peek(1 << 30)
    f0 = ChunkScheduler(cfg).flush(max(first_chunk - 1, 1))
    sch2 = ChunkScheduler(cfg)
    sch2.next_ready(first_chunk)
    flush = sch2.flush(first_chunk + 1)
    specs: List[ProgramSpec] = []
    for name, spec, is_last in (("chunk0", chunk0, False), ("steady", steady, False),
                                ("flush0", f0, True), ("flush", flush, True)):
        if spec is None:
            continue
        # fresh states a program: the step writes its caches in place
        sess.reset_utterance()
        sess._feat_buf = np.zeros((max(spec.slice_end, spec.frames), cfg.feat_in), np.float32)
        args, kwargs = sess._step_kwargs(spec, is_last)
        specs.append(ProgramSpec(name, _session_step, args, kwargs))
    return specs


def batch_program_specs(model: ParakeetTDT, batch_size: int,
                        runtime: Optional[RuntimeConfig] = None) -> List[ProgramSpec]:
    """The lockstep engine's program set: one program a batch size, steady
    and flush rows alike (per-row vectors). Every row holds a full chunk,
    so that a smoke run reaches the decode's joint; the key does not read
    values."""
    from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine, _batch_step

    eng = BatchStreamingEngine(model, batch_size=batch_size, runtime=runtime)
    cfg, b = model.cfg, eng.b
    args = eng._step_args(np.zeros((b, eng._frames, cfg.feat_in), np.float32),
                          np.full((b,), eng._frames, np.int32), np.zeros((b,), np.int32),
                          np.full((b,), cfg.cache_drop_size, np.int32),
                          np.full((b,), cfg.valid_out_len, np.int32))
    return [ProgramSpec(f"batch{b}", _batch_step, args, eng._step_kwargs())]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _numerics(rt: RuntimeConfig) -> Dict[str, Any]:
    """The numerics a manifest records and a load compares."""
    return {"f32_policy": f32_policy(), "compute_dtype": rt.compute_dtype,
            "decode_dtype": rt.decode_dtype, "quant": rt.quant}


def _finite(out) -> bool:
    return all(bool(torch.isfinite(v).all()) for v in _tensors(out) if v.is_floating_point())


def _tensors(v):
    if isinstance(v, torch.Tensor):
        yield v
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _tensors(x)


def build_engines(model: ParakeetTDT, outdir: str, runtime: Optional[RuntimeConfig] = None,
                  smoke: bool = True, batch_sizes: Tuple[int, ...] = ()) -> Dict:
    """Build the session's programs (and one lockstep program a requested
    batch size) into ``outdir``: a record each, the kernel libraries (on a
    card) and ``manifest.json``, which is returned. Each program runs once
    here, which gives its output shapes; ``smoke`` also checks that its
    outputs are finite and that the set, read back by
    :meth:`EngineSet.load`, serves its key."""
    out_dir = Path(outdir)
    out_dir.mkdir(parents=True, exist_ok=True)
    specs = session_program_specs(model, runtime)
    for b in batch_sizes:
        specs += batch_program_specs(model, b, runtime)
    rt = runtime if runtime is not None else model.runtime
    dev = model.device
    on_card = dev.type == "cuda"
    manifest: Dict[str, Any] = {
        "format": FORMAT,
        "build": {
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "platform": dev.type,
            "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "num_programs": len(specs),
            **_numerics(rt),
            "weights_dtype": sorted({a[2] for a in _avals(model.params, "") if len(a) == 3}),
            "kernel_flags": {f: getattr(rt, f) for f in KERNEL_FLAGS},
        },
        "libraries": {},
        "engines": {},
    }
    if on_card:
        t0 = time.perf_counter()
        build.build()
        (out_dir / LIB_SUBDIR).mkdir(exist_ok=True)
        for name in build.SOURCES:
            src = build.lib_file(name)
            dst = out_dir / LIB_SUBDIR / src.name
            shutil.copyfile(src, dst)
            data = dst.read_bytes()
            manifest["libraries"][name] = {
                "file": f"{LIB_SUBDIR}/{src.name}", "bytes": len(data),
                "sha256": hashlib.sha256(data).hexdigest(),
                "source_hash": build.source_hash(name)}
        manifest["build"]["libraries_s"] = round(time.perf_counter() - t0, 3)
    else:
        manifest["build"]["libraries_note"] = (
            "no kernel library: built without a card; a serving process builds its own")
    finite = {}
    for sp in specs:
        t0 = time.perf_counter()
        out = sp.fn(*sp.args, **sp.kwargs)
        _sync(dev)
        run_s = time.perf_counter() - t0
        finite[sp.name] = _finite(out)
        statics = {k: v for k, v in sp.kwargs.items() if _is_static(v)}
        record = {"name": sp.name, "key": sp.key, "cfg": _norm(model.cfg),
                  "quant": model.runtime.quant, "statics": statics,
                  "inputs": _avals(list(sp.args), "args") + _avals(sp.kwargs, "kwargs"),
                  "outputs": _avals(list(out), "out")}
        data = json.dumps(record, indent=1, sort_keys=True).encode()
        fname = f"{sp.name}.json"
        (out_dir / fname).write_bytes(data)
        manifest["engines"][sp.name] = {
            "file": fname, "key": sp.key, "bytes": len(data),
            "sha256": hashlib.sha256(data).hexdigest(), "run_s": round(run_s, 3),
            "statics": statics, "feats_shape": list(sp.args[1].shape)}
    _write_manifest(out_dir, manifest)
    if smoke:
        es = EngineSet.load(str(out_dir), runtime=rt)
        for sp in specs:
            ok = finite[sp.name] and es.get(sp.key) is not None
            manifest["engines"][sp.name]["smoke"] = {"ok": ok}
            if not ok:
                raise RuntimeError(f"engine {sp.name}: non-finite outputs or a key the set "
                                   "read back does not serve")
        _write_manifest(out_dir, manifest)
    return manifest


def _write_manifest(out_dir: Path, manifest: Dict) -> None:
    with open(out_dir / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)


def _verified(engine_dir: Path, what: str, entry: Dict) -> bytes:
    data = (engine_dir / entry["file"]).read_bytes()
    sha = hashlib.sha256(data).hexdigest()
    if sha != entry["sha256"]:
        raise ValueError(f"{what}: sha256 mismatch (manifest {entry['sha256'][:12]}.., "
                         f"file {sha[:12]}..): corrupt or tampered artifact")
    return data


class EngineSet:
    """The program records of an engine directory, keyed by signature, and
    its kernel libraries, bound. A session or an engine looks its key up a
    chunk and counts the hit or the miss."""

    def __init__(self, programs: Dict[str, Dict[str, Any]], manifest: Dict):
        self._programs = programs
        self.manifest = manifest

    @classmethod
    def load(cls, engine_dir: str, runtime: Optional[RuntimeConfig] = None) -> "EngineSet":
        """Read and verify ``engine_dir`` and bind its kernel libraries.
        ``runtime`` (default: ``RuntimeConfig.from_env()``) is the serving
        numerics the set's are compared with."""
        root = Path(engine_dir)
        with open(root / "manifest.json") as f:
            manifest = json.load(f)
        rt = runtime if runtime is not None else RuntimeConfig.from_env()
        built = manifest.get("build", {})
        for k, cur in _numerics(rt).items():
            if k in built and built[k] != cur:
                warnings.warn(
                    f"engine set was built with {k}={built[k]} but this process runs {cur}: "
                    f"a session whose weights or kernel flags differ from the set's "
                    f"misses (counted); every step runs this process's numerics",
                    stacklevel=2)
        libs = manifest.get("libraries", {})
        for name, entry in libs.items():
            if name not in build.SOURCES:
                raise ValueError(f"library {name}: not a kernel of this tree")
            _verified(root, f"library {name}", entry)
            here = build.source_hash(name)
            if entry["source_hash"] != here:
                raise ValueError(
                    f"library {name}: built from sources {entry['source_hash']}, this tree's "
                    f"are {here}; its C interface may differ from build._SIGNATURES: rebuild "
                    f"the engine set")
        programs = {}
        for name, entry in manifest["engines"].items():
            record = json.loads(_verified(root, f"engine {name}", entry))
            if record["key"] != entry["key"]:
                raise ValueError(f"engine {name}: record key {record['key']} != manifest's "
                                 f"{entry['key']}")
            programs[entry["key"]] = record
        # every launch loads its library from here: nvcc never runs for them
        for name, entry in libs.items():
            build.bind(name, root / entry["file"])
        if libs and torch.cuda.is_available():
            for name in libs:
                build.load(name)
        return cls(programs, manifest)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        """The record of the program of ``key``, or None."""
        return self._programs.get(key)

    def __len__(self) -> int:
        return len(self._programs)

