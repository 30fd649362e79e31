"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. Builds
happen at first use, from the repository's sources only, into
``trt_asr_tpu_torch/_build/`` (listed in ``.gitignore``), or into the
compile cache that :func:`apply_compile_cache` names; a library's file name
carries a hash of its sources (:func:`source_hash`), so an edited source is
rebuilt. ``build()`` starts one ``nvcc`` per missing library, all at once.
:func:`bind` loads a library from a given file instead (an engine set's
sha256-pinned copy, ``runtime/engine.py``).

A process never mixes two builds of one library: binding a copy with other
bytes than the loaded one, or pointing the compile cache at one, raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from trt_asr_tpu_torch.ops.quant import QuantTensor

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("att_block", "att_block_q8", "att_block_bf16", "att_block_f32", "joint_step",
           "joint_step_q8", "joint_step_f32", "mel", "ffn", "ffn_f32", "ffn_q8", "ffn_bf16",
           "conv_block", "conv_block_q8", "conv_block_f32", "conv_ffn_ln", "rel_shift",
           "flash_att", "conv_block_bf16", "joint_step_bf16")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_held_sha: Dict[str, str] = {}        # library -> sha256 of the file it is loaded or bound from
_bound: Dict[str, Path] = {}          # library -> the file bind() pinned it to
_cache_dir: Optional[Path] = None     # the compile cache, once set

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CONV = [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P]
# library -> {launch function: argtypes}
_SIGNATURES = {
    "att_block": {"att_block_launch":
                  [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                   _P, _P, _P, _P, _I, _I, _P, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P]},
    "att_block_q8": {"att_block_q8_launch":
                     [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I,
                      _P, _P, _P, _P, _P, _P],
                     "att_block_q8_occupancy": [_I, _P]},
    "att_block_bf16": {"att_block_bf16_launch":
                       [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _F, _P, _I, _I, _I,
                        _I, _I, _P, _P, _P, _P, _P, _P],
                       "att_block_bf16_occupancy": [_I, _P]},
    "att_block_f32": {"att_block_f32_launch":
                      [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I,
                       _I, _P, _P, _P, _P, _P, _P],
                      "att_block_f32_occupancy": [_I, _P]},
    "joint_step": {"joint_step_launch":
                   [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                    _I, _I, _I, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]},
    "joint_step_q8": {"joint_step_q8_launch":
                      [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P,
                       _P, _P],
                      "joint_step_q8_occupancy": [_I, _P]},
    "joint_step_bf16": {"joint_step_bf16_launch":
                        [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P,
                         _P, _P],
                        "joint_step_bf16_occupancy": [_I, _P]},
    "joint_step_f32": {"joint_step_f32_launch":
                       [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P,
                        _P, _P],
                       "joint_step_f32_occupancy": [_I, _P]},
    "mel": {"logmel_launch": [_P, _I, _I, _P, _I, _P, _I, _F, _I, _I, _P, _P]},
    "ffn": {"ffn_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F, _I, _I,
                           _P, _P, _P, _P, _P]},
    "ffn_f32": {"ffn_f32_launch": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P,
                                   _P],
                "ffn_f32_occupancy": [_I, _P]},
    "ffn_q8": {"ffn_q8_launch": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P],
               "ffn_q8_occupancy": [_I, _P]},
    "ffn_bf16": {"ffn_bf16_launch": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P,
                                     _P],
                 "ffn_bf16_occupancy": [_I, _P]},
    "conv_block": {"conv_block_launch": _CONV + [_I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P]},
    "conv_block_q8": {"conv_block_q8_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                               _P, _P, _P, _P],
                      "conv_block_q8_occupancy": [_I, _P]},
    "conv_block_bf16": {"conv_block_bf16_launch": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                                                   _I, _I, _P, _P, _P, _P],
                        "conv_block_bf16_occupancy": [_I, _P]},
    "conv_block_f32": {"conv_block_f32_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                                                 _P, _P, _P, _P],
                       "conv_block_f32_occupancy": [_I, _P]},
    "conv_ffn_ln": {"conv_ffn_ln_launch": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _I, _I, _I, _I, _P, _P, _P, _P],
                    "conv_ffn_ln_occupancy": [_I, _P]},
    "rel_shift": {"rel_shift_launch": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
                  "rel_shift_bf16_occupancy": [_I, _P]},
    "flash_att": {"flash_att_launch": [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I,
                                       _I, _F, _F, _P, _P],
                  "flash_att_bf16_occupancy": [_I, _P], "flash_att_f32_occupancy": [_P]},
}


# operand types of the offline kernels, as csrc/common.cuh's WType codes them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

GEMM_KSLICE = 64      # K rows per block of the split-K product (csrc/common.cuh)


def gemm_splits(k: int) -> int:
    """K slices of the split-K small-M product (csrc/common.cuh): the
    partial-sum buffer holds this many [M, N] slabs per product."""
    return -(-k // GEMM_KSLICE)


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for c in cands:
        p = Path(c) / "bin" / "nvcc"
        if c and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def source_hash(name: str) -> str:
    """Hash of the sources and flags ``csrc/<name>.cu`` is built from: the
    key of its library, whose C interface ``_SIGNATURES`` binds."""
    h = hashlib.sha256()
    for src in (*sorted(CSRC_DIR.glob("*.cuh")), CSRC_DIR / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def lib_file(name: str, directory: Optional[Path] = None) -> Path:
    """The library file of ``csrc/<name>.cu`` in ``directory`` (default:
    the current library directory)."""
    return Path(directory or BUILD_DIR) / f"{name}-{source_hash(name)}.so"


def file_sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _refuse_other_build(name: str, path: Path) -> None:
    """Raise if this process holds ``name`` from a file whose bytes differ
    from ``path``'s."""
    sha = _held_sha.get(name)
    if sha is not None and file_sha256(path) != sha:
        raise RuntimeError(
            f"{path}: another build of {name} is already loaded in this process "
            f"(sha256 {sha[:12]}.., this copy {file_sha256(path)[:12]}..)")


def apply_compile_cache(cache_dir) -> None:
    """Build every library into and load it from ``cache_dir`` from now on:
    a fresh process that finds them there runs no ``nvcc``. Wired to
    ``TRT_ASR_COMPILE_CACHE`` (``RuntimeConfig.compile_cache_dir``),
    applied at model construction, as in the JAX package.

    One-way per process: the same directory again is a no-op, another one
    raises, and so does a cache whose copy of a loaded library has other
    bytes."""
    global BUILD_DIR, _cache_dir
    path = Path(cache_dir)
    if _cache_dir is not None:
        if path.resolve() != _cache_dir.resolve():
            raise RuntimeError(f"the compile cache is {_cache_dir} for this process's life; "
                               f"{path} refused")
        return
    for name in _held_sha:
        if lib_file(name, path).exists():
            _refuse_other_build(name, lib_file(name, path))
    path.mkdir(parents=True, exist_ok=True)
    BUILD_DIR, _cache_dir = path, path


def bind(name: str, path) -> None:
    """Load ``csrc/<name>.cu``'s library from ``path`` (a copy the caller
    has verified) instead of building it: :func:`load` takes it from there.
    A library already held with the same bytes stays as it is; other bytes
    raise."""
    path = Path(path)
    _refuse_other_build(name, path)
    if name not in _libs:
        _bound[name] = path
        _held_sha[name] = file_sha256(path)


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes started together. Returns the wall seconds spent; raises
    with the compiler's output on failure. The -Xptxas -v report of each
    build is kept beside its library as ``<lib>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = lib_file(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        out.with_suffix(".log").write_text(log)
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)       # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    p = lib_file(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``: the file :func:`bind`
    pinned, else the library directory's, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _bound.get(name) or lib_file(name)
        if name not in _bound and not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _held_sha[name] = file_sha256(path)
        for fn_name, argtypes in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.port_error_string.argtypes = [ctypes.c_int]
        lib.port_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.port_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def weight_parts(w):
    """(stored tensor, scale row or None, wtype code) of a float weight or a
    QuantTensor; wtype 0 = f32, 1 = bf16, 2 = int8."""
    if isinstance(w, QuantTensor):
        return w.q, w.s.reshape(-1), 2
    if w.dtype == torch.float32:
        return w, None, 0
    if w.dtype == torch.bfloat16:
        return w, None, 1
    raise TypeError(f"unsupported weight dtype {w.dtype}")


def require_cuda(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {dev}")


def require_aligned(what: str, elems: int, *tensors: torch.Tensor) -> None:
    """The kernels load ``elems`` consecutive values at once: each tensor's
    data must start on such a boundary."""
    for t in tensors:
        if t.data_ptr() % (elems * t.element_size()):
            raise ValueError(f"{what}: tensor data must be aligned to {elems} elements")
