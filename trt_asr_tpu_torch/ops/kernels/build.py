"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. Builds
happen at first use, from the repository's sources only, into
``trt_asr_tpu_torch/_build/`` (listed in ``.gitignore``); a library's file
name carries a hash of its sources, so an edited source is rebuilt.
``build()`` starts one ``nvcc`` per missing library, all at once.
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
SOURCES = ("att_block", "joint_step", "mel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "att_block": ("att_block_launch",
                  [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                   _P, _P, _P, _P, _I, _P, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    "joint_step": ("joint_step_launch",
                   [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                    _I, _I, _I, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "mel": ("logmel_launch", [_P, _I, _I, _P, _P, _I, _P, _I, _F, _P, _P]),
}


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


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC_DIR / "common.cuh", CSRC_DIR / f"{name}.cu"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, all nvcc
    processes started together. Returns the wall seconds spent; raises
    with the compiler's output on failure. The -Xptxas -v report of each
    build is kept beside its library as ``<lib>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
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
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _SIGNATURES[name]
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
