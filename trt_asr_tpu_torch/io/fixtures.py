"""Golden-fixture codec: numpy arrays as base64 in JSONL records.

Byte for byte the JAX package's ``io/fixtures.py`` format: an array is
``{"__ndarray__": <base64 of its C-order bytes>, "dtype": ..., "shape":
[...]}``, nested anywhere in a record. The committed goldens
(``artifacts/goldens/*.jsonl``) are read with :func:`read_jsonl`.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, Iterable, Iterator

import numpy as np


def encode_array(x: np.ndarray) -> Dict[str, Any]:
    x = np.ascontiguousarray(x)
    return {
        "__ndarray__": base64.b64encode(x.tobytes()).decode("ascii"),
        "dtype": str(x.dtype),
        "shape": list(x.shape),
    }


def decode_array(d: Dict[str, Any]) -> np.ndarray:
    raw = base64.b64decode(d["__ndarray__"])
    return np.frombuffer(raw, dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()


def _encode(obj):
    if isinstance(obj, np.ndarray):
        return encode_array(obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _decode(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return decode_array(obj)
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def write_jsonl(path: str, records: Iterable[Dict[str, Any]]) -> int:
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(_encode(rec)) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> Iterator[Dict[str, Any]]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield _decode(json.loads(line))
