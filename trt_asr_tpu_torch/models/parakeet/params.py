"""Parameter tree: init, checkpoints (saving and loading) and the weight
bridge.

The tree has the JAX package's structure and layouts: linear weights
[in, out], conformer layers stacked [L, ...], conv weights HWIO, the
predictor embedding with a zero row at blank_id. Leaves are torch tensors;
int8-quantized leaves are :class:`QuantTensor` (int8 ``q`` + f32 ``s``).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from typing import Any, Dict

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.ops.quant import QuantTensor


def _normal(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    return (rng.standard_normal(shape) / math.sqrt(max(fan_in, 1))).astype(np.float32)


def init_params_numpy(cfg: ModelConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded random weights as numpy arrays. Draws the same
    ``default_rng(seed)`` sequence in the same order as the JAX package's
    ``init_params``, so both give the same weights."""
    rng = np.random.default_rng(seed)
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    ed = cfg.d_model * cfg.ff_expansion_factor
    c = cfg.subsampling_conv_channels
    k = cfg.conv_kernel_size
    ll = cfg.num_layers

    f_out = cfg.feat_in
    for _ in range(cfg.stride_stages):
        f_out = (f_out - 1) // 2 + 1

    pre_encode = {
        "conv_in": {"w": _normal(rng, (3, 3, 1, c), 9), "b": np.zeros(c, np.float32)},
        "stages": [
            {
                "dw_w": _normal(rng, (3, 3, 1, c), 9),
                "dw_b": np.zeros(c, np.float32),
                "pw_w": _normal(rng, (1, 1, c, c), c),
                "pw_b": np.zeros(c, np.float32),
            }
            for _ in range(cfg.stride_stages - 1)
        ],
        "out": {"w": _normal(rng, (c * f_out, d), c * f_out), "b": np.zeros(d, np.float32)},
    }

    def stack(fn):
        return np.stack([fn() for _ in range(ll)])

    layers = {
        "ff1_ln_g": np.ones((ll, d), np.float32), "ff1_ln_b": np.zeros((ll, d), np.float32),
        "ff1_w1": stack(lambda: _normal(rng, (d, ed), d)),
        "ff1_w2": stack(lambda: _normal(rng, (ed, d), ed)),
        "att_ln_g": np.ones((ll, d), np.float32), "att_ln_b": np.zeros((ll, d), np.float32),
        "att_wq": stack(lambda: _normal(rng, (d, d), d)),
        "att_wk": stack(lambda: _normal(rng, (d, d), d)),
        "att_wv": stack(lambda: _normal(rng, (d, d), d)),
        "att_wo": stack(lambda: _normal(rng, (d, d), d)),
        "att_wpos": stack(lambda: _normal(rng, (d, d), d)),
        "att_bias_u": stack(lambda: _normal(rng, (h, dh), dh)),
        "att_bias_v": stack(lambda: _normal(rng, (h, dh), dh)),
        "conv_ln_g": np.ones((ll, d), np.float32), "conv_ln_b": np.zeros((ll, d), np.float32),
        "conv_pw1": stack(lambda: _normal(rng, (d, 2 * d), d)),
        "conv_dw": stack(lambda: _normal(rng, (k, d), k)),
        "conv_bn_g": np.ones((ll, d), np.float32), "conv_bn_b": np.zeros((ll, d), np.float32),
        "conv_bn_m": np.zeros((ll, d), np.float32), "conv_bn_v": np.ones((ll, d), np.float32),
        "conv_pw2": stack(lambda: _normal(rng, (d, d), d)),
        "ff2_ln_g": np.ones((ll, d), np.float32), "ff2_ln_b": np.zeros((ll, d), np.float32),
        "ff2_w1": stack(lambda: _normal(rng, (d, ed), d)),
        "ff2_w2": stack(lambda: _normal(rng, (ed, d), ed)),
        "out_ln_g": np.ones((ll, d), np.float32), "out_ln_b": np.zeros((ll, d), np.float32),
    }

    p = cfg.pred_hidden
    embed = _normal(rng, (cfg.vocab_size + 1, p), p)
    embed[cfg.blank_id] = 0.0  # blank_as_pad: blank embeds to the zero vector
    predictor = {
        "embed": embed,
        "lstm": [
            {
                "wi": _normal(rng, (p, 4 * p), p),
                "wh": _normal(rng, (p, 4 * p), p),
                "bi": np.zeros(4 * p, np.float32),
                "bh": np.zeros(4 * p, np.float32),
            }
            for _ in range(cfg.pred_rnn_layers)
        ],
    }

    j = cfg.joint_hidden
    joint = {
        "enc": {"w": _normal(rng, (d, j), d), "b": np.zeros(j, np.float32)},
        "pred": {"w": _normal(rng, (p, j), p), "b": np.zeros(j, np.float32)},
        "out": {"w": _normal(rng, (j, cfg.joint_vocab_size), j),
                "b": np.zeros(cfg.joint_vocab_size, np.float32)},
    }
    return {"encoder": {"pre_encode": pre_encode, "layers": layers},
            "predictor": predictor, "joint": joint}


def init_params(cfg: ModelConfig, seed: int = 0, device="cpu") -> Dict[str, Any]:
    """Seeded random weights (same values as the JAX package's init_params)
    as a torch tree on ``device``."""
    return params_from_numpy(init_params_numpy(cfg, seed), device=device)


def _is_quant_leaf(node) -> bool:
    return (hasattr(node, "q") and hasattr(node, "s") and isinstance(node, tuple))


def params_from_numpy(tree, device="cpu"):
    """The weight bridge: a parameter tree of numpy arrays (e.g. the JAX
    package's tree after ``jax.tree.map(np.asarray, params)``) -> the port's
    tree of torch tensors on ``device``. Structure and layouts are kept;
    int8-quantized leaves (any named tuple with ``q`` and ``s``) become
    :class:`QuantTensor` with int8 ``q`` and f32 ``s``; bf16 arrays (JAX's
    ``ml_dtypes.bfloat16``) become bf16 tensors, bit for bit."""
    if _is_quant_leaf(tree):
        return QuantTensor(params_from_numpy(tree.q, device), params_from_numpy(tree.s, device))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    a = np.asarray(tree)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16, which torch cannot read
        return torch.as_tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.as_tensor(a, device=device)


def params_to_numpy(tree):
    """Inverse of :func:`params_from_numpy`: torch tree -> numpy arrays
    (QuantTensor leaves keep their int8 + scale form)."""
    if isinstance(tree, QuantTensor):
        return QuantTensor(params_to_numpy(tree.q), params_to_numpy(tree.s))
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def params_to(tree, device):
    """Move every leaf of a torch tree to ``device``."""
    if isinstance(tree, QuantTensor):
        return QuantTensor(tree.q.to(device), tree.s.to(device))
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to(v, device) for v in tree]
    return tree.to(device)


# leaves kept f32 by cast_params_for_compute: the norm parameters
_F32_KEEP = ("ln_g", "ln_b", "bn_g", "bn_b", "bn_m", "bn_v")


def cast_params_for_compute(params, dtype: torch.dtype):
    """Cast every leaf of a float tree to ``dtype`` (bf16: the weights the
    JAX package's bf16 configuration runs with) but those whose key path
    names a norm parameter (``_F32_KEEP``), which stay as they are. Cast
    before quantizing: a :class:`QuantTensor` leaf raises."""

    def cast(node, keep: bool):
        if isinstance(node, QuantTensor):
            raise TypeError("cast_params_for_compute: cast the float tree before quantizing")
        if isinstance(node, dict):
            return {k: cast(v, keep or any(t in k for t in _F32_KEEP)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [cast(v, keep) for v in node]
        return node if keep else node.to(dtype)

    return cast(params, False)


def num_params(params: Dict[str, Any]) -> int:
    """Number of values in a float tree (an int8 leaf counts its ``q`` and
    its scales)."""
    def count(node) -> int:
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(count(v) for v in node)
        return node.numel()
    return count(params)


def save_checkpoint(path: str, params: Dict[str, Any], meta: Dict[str, Any] | None = None) -> None:
    """Write a torch or numpy tree as the JAX package's ``save_checkpoint``
    does: flat-key ``params.npz`` (keys joined with "/", list items by
    index) and ``manifest.json`` with every tensor's shape, dtype and
    sha256, so that its ``load_checkpoint`` (and :func:`load_checkpoint`)
    read it."""
    os.makedirs(path, exist_ok=True)
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for kk, vv in node.items():
                walk(f"{prefix}/{kk}" if prefix else kk, vv)
        elif isinstance(node, (list, tuple)):
            for i, vv in enumerate(node):
                walk(f"{prefix}/{i}", vv)
        else:
            flat[prefix] = (node.detach().cpu().numpy() if isinstance(node, torch.Tensor)
                            else np.asarray(node))

    walk("", params)
    np.savez(os.path.join(path, "params.npz"), **flat)
    manifest = {
        "format": "trt-asr-tpu/npz/v1",
        "num_tensors": len(flat),
        "num_params": int(sum(int(np.prod(v.shape)) for v in flat.values())),
        "tensors": {kk: {"shape": list(v.shape), "dtype": str(v.dtype),
                         "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
                    for kk, v in flat.items()},
        "meta": meta or {},
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint_numpy(path: str, verify: bool = True) -> Dict[str, Any]:
    """Read a model dir's flat-key ``params.npz``, checking every tensor
    against the sha256 in ``manifest.json`` (the format the JAX package's
    ``save_checkpoint`` writes). Returns a numpy tree."""
    npz = np.load(os.path.join(path, "params.npz"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for key in npz.files:
        v = npz[key]
        if verify:
            want = manifest["tensors"][key]["sha256"]
            got = hashlib.sha256(v.tobytes()).hexdigest()
            if want != got:
                raise ValueError(f"checkpoint tensor {key} sha256 mismatch")
        parts = key.split("/")
        node = tree
        for pp in parts[:-1]:
            node = node.setdefault(pp, {})
        node[parts[-1]] = v

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(kk.isdigit() for kk in keys):
                return [listify(node[kk]) for kk in sorted(node, key=int)]
            return {kk: listify(vv) for kk, vv in node.items()}
        return node

    return listify(tree)


def load_checkpoint(path: str, verify: bool = True, device="cpu") -> Dict[str, Any]:
    return params_from_numpy(load_checkpoint_numpy(path, verify), device=device)
