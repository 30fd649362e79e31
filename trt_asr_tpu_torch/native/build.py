"""Build the port's native C-ABI runtime from ``native/``'s sources, with the
host C++ compiler (``$CXX``, else ``g++``) and no build system:

    python -m trt_asr_tpu_torch.native.build

builds ``libtrt_asr_tpu_torch.so`` (the C ABI of ``include/trt_asr_tpu.h``,
its mock and embedded-Python backends), ``trt_asr_cli``, ``logmel_tool`` and
``abi_thread_smoke`` into ``trt_asr_tpu_torch/_build/native/<hash>/``
(listed in ``.gitignore``) and prints their paths. The hash covers the
sources, this recipe, the flags and the Python the library embeds, so an
edited source or another interpreter builds anew; :func:`build` builds at
first use and returns the existing build otherwise. Every source compiles
in its own process, all started together; a failed compile or link raises
with the compiler's log. Processes building one hash at once agree: each
builds in a directory of its own and renames it into place.

The library embeds the interpreter that runs the build: its headers, and
its ``libpython`` linked with an rpath (where that Python is built without
a shared ``libpython``, the static one is linked into the programs with
``--export-dynamic``, so that torch's extension modules resolve against
it). A process started on the library needs the repository root and that
interpreter's packages on its import path: :func:`embed_env`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

NATIVE_DIR = Path(__file__).resolve().parent
REPO_ROOT = NATIVE_DIR.parents[1]
BUILD_ROOT = NATIVE_DIR.parent / "_build" / "native"
LIB = "libtrt_asr_tpu_torch.so"
CXXFLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall")
LIB_SOURCES = ("src/session.cpp", "src/logmel.cpp", "src/backend_mock.cpp",
               "src/backend_python.cpp")
# program -> (its sources, whether it links the library)
PROGRAMS = {
    "trt_asr_cli": (("cli/main.cpp", "src/logmel.cpp"), True),
    "logmel_tool": (("tools/logmel_tool.cpp", "src/logmel.cpp"), False),
    "abi_thread_smoke": (("tools/abi_thread_smoke.cpp",), True),
}


class Native(NamedTuple):
    """One build's files, and the seconds it took (0 when it existed)."""
    dir: Path
    lib: Path
    cli: Path
    logmel_tool: Path
    abi_thread_smoke: Path
    seconds: float


def compiler() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if not found:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the native runtime needs one "
                           "(set CXX)")
    return found


def python_flags() -> Dict[str, List[str]]:
    """Compile and link flags of the running interpreter's embedding API:
    ``include``, ``lib`` (the library's link line) and ``program`` (added to
    each program that links the library)."""
    cv = sysconfig.get_config_var
    paths = sysconfig.get_paths()
    inc = [cv("INCLUDEPY"), paths.get("include"), paths.get("platinclude")]
    include = [f"-I{d}" for d in dict.fromkeys(i for i in inc if i)]
    extra = (cv("LIBS") or "").split() + (cv("SYSLIBS") or "").split()
    if cv("Py_ENABLE_SHARED"):
        libdir, ldlib = cv("LIBDIR"), cv("LDLIBRARY")       # libpython3.X.so
        name = ldlib[len("lib"):].split(".so")[0]
        return {"include": include,
                "lib": [f"-L{libdir}", f"-l{name}", f"-Wl,-rpath,{libdir}", *extra],
                "program": []}
    libpl, static = cv("LIBPL"), cv("LIBRARY")              # libpython3.X.a
    pic = Path(libpl) / static.replace(".a", "-pic.a")
    archive = pic if pic.exists() else Path(libpl) / static
    return {"include": include, "lib": [],
            "program": ["-Wl,--export-dynamic", "-Wl,--whole-archive", str(archive),
                        "-Wl,--no-whole-archive", *extra, "-lpthread", "-lutil"]}


def _sources() -> List[Path]:
    return sorted(p for d in ("include", "src", "cli", "tools")
                  for p in (NATIVE_DIR / d).iterdir() if p.suffix in (".h", ".cpp"))


def source_hash() -> str:
    """Hash of the sources, this recipe, the flags and the embedded
    Python's flags: the name of a build's directory."""
    h = hashlib.sha256(Path(__file__).read_bytes())
    for p in _sources():
        h.update(p.relative_to(NATIVE_DIR).as_posix().encode())
        h.update(p.read_bytes())
    flags = python_flags()
    h.update(" ".join((*CXXFLAGS, *flags["include"], *flags["lib"], *flags["program"],
                       sys.version)).encode())
    return h.hexdigest()[:12]


def _files(directory: Path, seconds: float = 0.0) -> Native:
    return Native(directory, directory / LIB, *(directory / p for p in PROGRAMS), seconds)


def _complete(directory: Path) -> bool:
    n = _files(directory)
    return all(f.exists() for f in (n.lib, n.cli, n.logmel_tool, n.abi_thread_smoke))


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands at once; raise with each failure's command and log."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    errors = []
    for cmd, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{' '.join(cmd)}\n{log}")
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))


def build() -> Native:
    """The native runtime's files, built first if this hash has no build."""
    out = BUILD_ROOT / source_hash()
    if _complete(out):
        return _files(out)
    t0 = time.perf_counter()
    cxx, flags = compiler(), python_flags()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".building-", dir=out.parent))
    try:
        inc = [f"-I{NATIVE_DIR / 'include'}", f"-I{NATIVE_DIR / 'src'}", *flags["include"]]
        srcs = dict.fromkeys([*LIB_SOURCES, *(s for srcs, _ in PROGRAMS.values() for s in srcs)])
        obj = {s: tmp / (s.replace("/", "_") + ".o") for s in srcs}
        _run_all([[cxx, *CXXFLAGS, *inc, "-c", str(NATIVE_DIR / s), "-o", str(obj[s])]
                  for s in srcs])
        _run_all([[cxx, "-shared", f"-Wl,-soname,{LIB}", "-o", str(tmp / LIB),
                   *(str(obj[s]) for s in LIB_SOURCES), *flags["lib"]]])
        links = []
        for prog, (srcs_p, uses_lib) in PROGRAMS.items():
            cmd = [cxx, "-o", str(tmp / prog), *(str(obj[s]) for s in srcs_p)]
            if uses_lib:
                cmd += [f"-L{tmp}", f"-l{LIB[len('lib'):-len('.so')]}", "-Wl,-rpath,$ORIGIN",
                        "-pthread", *flags["program"]]
            links.append(cmd)
        _run_all(links)
        for o in obj.values():
            o.unlink()
        try:
            os.rename(tmp, out)        # atomic: a concurrent process's equal build may win
        except OSError:
            if not _complete(out):
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _files(out, time.perf_counter() - t0)


def embed_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """A copy of ``env`` (default: this process's) for a process that runs
    the library's embedded interpreter: ``PYTHONPATH`` holds the repository
    root, then the running interpreter's import path (its site-packages
    among it, which an interpreter embedded in a program does not find by
    itself), then the entries ``env`` had."""
    env = dict(os.environ if env is None else env)
    old = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    here = [p for p in sys.path if p and os.path.isdir(p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys([str(REPO_ROOT), *here, *old]))
    return env


def main() -> int:
    n = build()
    print(f"native runtime in {n.dir}: "
          + (f"built in {n.seconds:.1f} s" if n.seconds else "already built"))
    for f in (n.lib, n.cli, n.logmel_tool, n.abi_thread_smoke):
        print(f"  {f} ({f.stat().st_size} B)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
