"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
inputs are made with numpy from a seed and handed to both packages."""

import numpy as np
import pytest
import torch

GATE_R3 = "artifacts/models/gate_r3"


def require_cuda() -> torch.device:
    """Skip the calling test unless a CUDA device is present (decided at run
    time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def spy_calls(monkeypatch, module, names):
    """Count the calls ``module`` makes to the functions it holds under
    ``names`` (the kernel wrappers it looks up at call time): on CPU tensors
    a wrapper runs its plain version, which agrees with the path without it,
    so only a count shows that a flag took the kernel branch."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def spy(*args, _name=name, _fn=getattr(module, name), **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, spy)
    return calls


def np_tree(tree):
    """JAX tree (incl. QuantTensor leaves) -> the same tree of numpy arrays."""
    import jax

    return jax.tree.map(np.asarray, tree)


def assert_tree_equal(a, b, path=""):
    """Exact equality of two trees of numpy arrays (QuantTensor leaves compared
    field by field)."""
    if hasattr(a, "q") and isinstance(a, tuple):
        assert_tree_equal(a.q, b.q, path + ".q")
        assert_tree_equal(a.s, b.s, path + ".s")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, order="C"))


def assert_within_bf16_ulp(got, want) -> None:
    """|got - want| <= one bf16 ulp of want (bf16 keeps 8 significant bits):
    the same f32 sum, taken in another order, rounded once."""
    g, w = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    bad = (g - w).abs() > ulp
    assert not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} values beyond one bf16 ulp"


def synth_audio(seed: int, words: int = 6) -> np.ndarray:
    """A spoken-words utterance in the synthetic task gate_r3 was trained on."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "train_synthetic_e2e", os.path.join(root, "tools", "train_synthetic_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(seed)
    return mod.synth_utterance(list(rng.integers(0, 1120, size=words)), rng)


def tensor_core_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q . k [B, H, T, T] for bf16 q, k [B, T, H, dh], summed by a bf16
    tensor-core product with f32 output (cuBLAS ``bmm``): the summation of
    the flash kernel's ``mma.sync``, whose f32 sums round otherwise than an
    f32 einsum's."""
    b, t_len, h, dh = q.shape
    qh = q.transpose(1, 2).reshape(b * h, t_len, dh)
    kh = k.permute(0, 2, 3, 1).reshape(b * h, dh, t_len)
    return torch.bmm(qh, kh, out_dtype=torch.float32).view(b, h, t_len, t_len)


def conv_module_inputs(seed: int, tq: int, valid: int, d: int, kk: int = 9) -> dict:
    """numpy inputs of one conv module call (B=1 chunk of Tq rows, ``valid``
    of them unpadded): x, the LN's g and b, pw1 [D, 2D], the taps [kk, D],
    BN g, b, m, v, pw2 [D, D], the time cache and the mask [Tq, 1]."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=r(tq, d, sc=1.0), g=1.0 + r(d, sc=0.2), b=r(d, sc=0.1),
                pw1=r(d, 2 * d, sc=d ** -0.5), dw=r(kk, d),
                bn=[1.0 + r(d, sc=0.1), r(d, sc=0.1), r(d, sc=0.1), np.abs(r(d)) * 0.5 + 0.8],
                pw2=r(d, d, sc=d ** -0.5), tc=r((kk - 1) // 2, d, sc=1.0),
                mask=(np.arange(tq) < valid).astype(np.float32)[:, None])


def conv_module_args(inp: dict, pw1, pw2) -> tuple:
    """The arguments of ``conv_block`` from :func:`conv_module_inputs`, with
    the weights given (float or int8)."""
    c = torch.as_tensor
    return (c(inp["x"]), c(inp["g"]), c(inp["b"]), pw1, c(inp["dw"]), *[c(v) for v in inp["bn"]],
            pw2, c(inp["tc"]), c(inp["mask"]))


def padded(v: torch.Tensor, width: int) -> torch.Tensor:
    """[rows, N] -> [rows, width], zero past N."""
    out = v.new_zeros((v.shape[0], width))
    out[:, :v.shape[1]] = v
    return out


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module of many small ops (the beam
    searches): under the suite's parallel workers a pool of threads per op
    costs far more than the op. A module takes it with
    ``pytestmark = pytest.mark.usefixtures("one_torch_thread")``; the count
    is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_jax_subprocess(code: str, out_path: str, timeout: int = 600):
    """Start ``code`` in a fresh Python process with JAX on the CPU and
    return a function that waits for it and returns the arrays it saved
    with ``np.savez(OUT, ...)`` (``OUT`` is bound to ``out_path``), and
    whose ``kill`` ends it. A module starts it in an autouse fixture, so
    that its other tests run meanwhile. JAX gradients of scans run there: XLA-CPU has crashed
    compiling them late in a long suite process (tests/test_tdt_loss.py,
    tests/test_training.py)."""
    import os
    import subprocess
    import sys
    import tempfile

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = ("import jax; jax.config.update('jax_platforms', 'cpu')\n"
            f"OUT = {out_path!r}\n" + code)
    logs = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", prog], stdout=logs[0], stderr=logs[1],
                            text=True, env={**os.environ, "JAX_PLATFORMS": "cpu",
                                            "PYTHONPATH": repo})

    def result() -> dict:
        try:
            rc = proc.wait(timeout=timeout)
        finally:
            proc.kill()
        for f in logs:
            f.seek(0)
        assert rc == 0, (logs[0].read()[-500:], logs[1].read()[-2000:])
        with np.load(out_path) as z:
            return {k: z[k] for k in z.files}
    result.kill = proc.kill
    return result


@pytest.fixture(autouse=False, scope="module")
def one_torch_thread():
    """torch's intra-op pool at one thread for a module (restored after):
    the tiny models' ops are too small to share out, and under the suite's
    parallel workers a pool of spinning threads a process slows every
    worker many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
