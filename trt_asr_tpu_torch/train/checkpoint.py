"""Training-state checkpoint and resume, in the JAX package's format: the
weights as the npz + per-tensor sha256 manifest of ``params.save_checkpoint``
(under ``weights/``), the optimizer state as ordered flat leaves
(``opt_state.npz``, ``leaf_00000`` ...) with a ``trt-asr-tpu/train-state/v1``
manifest giving each leaf's shape, dtype and sha256 and the step count. The
leaves come in the port optimizer's order (``optim.tree_leaves``) and are
restored into a template built by the caller, ``init_opt(params)`` of the
same optimizer; nothing is pickled. Resume is exact: a restored state
continues as the uninterrupted run would.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.models.parakeet.params import load_checkpoint, save_checkpoint
from trt_asr_tpu_torch.train.optim import tree_leaves, tree_unflatten


def save_train_state(path: str, params: Dict[str, Any], opt_state: Any, step: int,
                     meta: Dict[str, Any] | None = None) -> None:
    """Write the weights, the optimizer's leaves and the step count."""
    os.makedirs(path, exist_ok=True)
    save_checkpoint(os.path.join(path, "weights"), params,
                    meta={"train_step": int(step), **(meta or {})})
    arrs = {f"leaf_{i:05d}": v.detach().cpu().numpy()
            for i, v in enumerate(tree_leaves(opt_state))}
    np.savez(os.path.join(path, "opt_state.npz"), **arrs)
    manifest = {
        "format": "trt-asr-tpu/train-state/v1",
        "step": int(step),
        "n_leaves": len(arrs),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                       "sha256": hashlib.sha256(v.tobytes()).hexdigest()}
                   for k, v in arrs.items()},
        "meta": meta or {},
    }
    with open(os.path.join(path, "train_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_train_state(path: str, opt_state_template: Any,
                     verify: bool = True) -> Tuple[Dict[str, Any], Any, int]:
    """Returns (params, opt_state, step), on the template's device.
    ``opt_state_template`` comes from the optimizer the state was saved
    under; each saved leaf is checked against its sha256 and the template
    leaf's shape and dtype."""
    t_leaves = tree_leaves(opt_state_template)
    device = t_leaves[0].device if t_leaves else "cpu"
    params = load_checkpoint(os.path.join(path, "weights"), verify=verify, device=device)
    with open(os.path.join(path, "train_manifest.json")) as f:
        manifest = json.load(f)
    npz = np.load(os.path.join(path, "opt_state.npz"))
    if len(t_leaves) != manifest["n_leaves"]:
        raise ValueError(
            f"optimizer-state template has {len(t_leaves)} leaves, "
            f"checkpoint has {manifest['n_leaves']}: a different optimizer?")
    new_leaves = []
    for i, tmpl in enumerate(t_leaves):
        key = f"leaf_{i:05d}"
        v = npz[key]
        if verify:
            want = manifest["leaves"][key]["sha256"]
            if hashlib.sha256(v.tobytes()).hexdigest() != want:
                raise ValueError(f"train-state leaf {key} sha256 mismatch")
        want_dtype = str(torch.empty(0, dtype=tmpl.dtype).numpy().dtype)
        if tuple(v.shape) != tuple(tmpl.shape) or str(v.dtype) != want_dtype:
            raise ValueError(
                f"train-state leaf {key}: saved {v.shape}/{v.dtype} vs "
                f"template {tuple(tmpl.shape)}/{tmpl.dtype}")
        new_leaves.append(torch.from_numpy(np.array(v, order="C")).to(device))
    return params, tree_unflatten(opt_state_template, new_leaves), int(manifest["step"])
