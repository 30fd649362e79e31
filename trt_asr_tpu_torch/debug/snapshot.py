"""Per-chunk state snapshots for cross-runtime comparison
(``RuntimeConfig.snapshot_dir``: TRT_ASR_SNAPSHOT_DIR /
PARAKEET_TDT_SNAPSHOT_DIR).

The JAX package's ``debug/snapshot.py`` layout: one ``chunk_<idx:05d>/``
directory a chunk holding the encoder caches (``att_cache.f32``,
``time_cache.f32``: the raw ring buffers, [L, B, C, D] and [L, B, K, D],
in the JAX package's ring layout), the predictor state (``pred_g.f32``,
``pred_h.f32``, ``pred_c.f32``) as raw f32, and ``meta.json`` (shapes,
``cache_len``, ``y_id``, ``time_carry`` and the chunk's new tokens). So
``tools/parity/compare_snapshots.py`` diffs a run of this package against
a run of the JAX package, and :func:`compare_snapshot_dirs` does the same
without the tool.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

SNAPSHOT_TENSORS = ("att_cache", "time_cache", "pred_g", "pred_h", "pred_c")


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _list(x) -> list:
    return x.detach().cpu().tolist() if isinstance(x, torch.Tensor) else np.asarray(x).tolist()


def maybe_snapshot_chunk(rt, chunk_idx: int, enc_state=None, dec_state=None,
                         tokens: Optional[List[int]] = None) -> Optional[str]:
    """Write chunk ``chunk_idx``'s snapshot when ``rt.snapshot_dir`` is set;
    returns its directory (None when off)."""
    if rt is None or not rt.snapshot_dir:
        return None
    d = os.path.join(rt.snapshot_dir, f"chunk_{chunk_idx:05d}")
    os.makedirs(d, exist_ok=True)
    meta = {"chunk_idx": chunk_idx, "tokens": list(tokens or [])}
    if enc_state is not None:
        att = _f32(enc_state.att_cache)
        tc = _f32(enc_state.time_cache)
        att.tofile(os.path.join(d, "att_cache.f32"))
        tc.tofile(os.path.join(d, "time_cache.f32"))
        meta["att_cache_shape"] = list(att.shape)
        meta["time_cache_shape"] = list(tc.shape)
        meta["cache_len"] = _list(enc_state.cache_len)
    if dec_state is not None:
        g, h, c = _f32(dec_state.g), _f32(dec_state.h), _f32(dec_state.c)
        g.tofile(os.path.join(d, "pred_g.f32"))
        h.tofile(os.path.join(d, "pred_h.f32"))
        c.tofile(os.path.join(d, "pred_c.f32"))
        meta["g_shape"] = list(g.shape)
        meta["h_shape"] = list(h.shape)
        meta["y_id"] = _list(dec_state.y_id)
        meta["time_carry"] = _list(dec_state.time_carry)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return d


def load_snapshot(d: str) -> Dict:
    """meta.json of one chunk directory, with each tensor file read back
    under its name (shaped by the meta's shapes)."""
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    shape_of = {"att_cache": "att_cache_shape", "time_cache": "time_cache_shape",
                "pred_g": "g_shape", "pred_h": "h_shape", "pred_c": "h_shape"}
    for name in SNAPSHOT_TENSORS:
        p = os.path.join(d, name + ".f32")
        if os.path.exists(p):
            meta[name] = np.fromfile(p, np.float32).reshape(meta[shape_of[name]])
    return meta


def compare_snapshot_dirs(dir_a: str, dir_b: str, atol: float = 1e-4) -> Dict:
    """Compare two runs' snapshot directories chunk by chunk: the same
    chunk directories, tokens equal in each, every tensor of equal shape
    and within ``atol``. Returns {"pass", "chunks", "max_abs" per tensor,
    "first_bad" per tensor, "token_divergence" (first chunk or None)}."""
    chunks_a = sorted(x for x in os.listdir(dir_a) if x.startswith("chunk_"))
    chunks_b = sorted(x for x in os.listdir(dir_b) if x.startswith("chunk_"))
    report = {"chunks": len(chunks_a), "max_abs": {}, "first_bad": {},
              "token_divergence": None, "pass": bool(chunks_a) and chunks_a == chunks_b}
    for c in chunks_a if report["pass"] else []:
        a, b = load_snapshot(os.path.join(dir_a, c)), load_snapshot(os.path.join(dir_b, c))
        if a["tokens"] != b["tokens"] and report["token_divergence"] is None:
            report["token_divergence"] = c
            report["pass"] = False
        for name in SNAPSHOT_TENSORS:
            if name not in a or name not in b:
                continue
            if a[name].shape != b[name].shape:
                e = float("inf")
            else:
                e = float(np.max(np.abs(a[name] - b[name]))) if a[name].size else 0.0
            report["max_abs"][name] = max(report["max_abs"].get(name, 0.0), e)
            if e > atol:
                report["first_bad"].setdefault(name, c)
                report["pass"] = False
    return report
