"""The ctypes bindings of the PyTorch port's CUDA kernels
(``ops/kernels/build.py``) against the C interfaces in ``csrc/``: every
source is listed, every exported launch function is bound, and each bound
argument type matches the C parameter (a pointer passed as a C int would be
cut to 32 bits, an int passed as a pointer would be read as garbage). The
sources themselves compile only where nvcc is, on the card."""

import ctypes
import re

import pytest

from trt_asr_tpu_torch.ops.kernels import build

C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def c_signatures(name):
    """{function: [ctypes type]} of the extern "C" launch functions of
    csrc/<name>.cu."""
    src = (build.CSRC_DIR / f"{name}.cu").read_text()
    out = {}
    for fn, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        types = []
        for p in params.split(","):
            decl = p.strip().rsplit(" ", 1)[0]
            types.append(ctypes.c_void_p if "*" in p else C_TYPES[decl])
        out[fn] = types
    return out


def test_every_source_is_built():
    assert sorted(build.SOURCES) == sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))


@pytest.mark.parametrize("name", build.SOURCES)
def test_bindings_match_the_c_interface(name):
    assert c_signatures(name) == build._SIGNATURES[name]
