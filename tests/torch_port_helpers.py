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
