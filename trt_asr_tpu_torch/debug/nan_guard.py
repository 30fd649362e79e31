"""NaN/Inf guard (``RuntimeConfig.nan_guard`` / ``nan_guard_halt``:
PARAKEET_NAN_GUARD_ALWAYS / _HALT), as the JAX package's
``debug/nan_guard.py``: a scan reports the count of non-finite values on
stderr and, with ``halt``, raises :class:`NanGuardError`; ``sample=True``
checks a site's first ``first_n`` calls, then one in ``every``.

On a device tensor the count is one reduction on the device and one
scalar read back: one sync, no copy of the tensor.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


class NanGuardError(RuntimeError):
    pass


# calls so far per site name (the sampling cadence), as the JAX package keeps
_counters: dict = {}


def check_finite(x, name: str, halt: bool = False, sample: bool = False,
                 first_n: int = 10, every: int = 100) -> bool:
    """True if ``x`` (a tensor or an array) was skipped by the cadence or
    is finite; False, after a line on stderr, if it holds NaN or Inf
    (raises NanGuardError with ``halt``)."""
    if sample:
        c = _counters.get(name, 0)
        _counters[name] = c + 1
        if c >= first_n and (c % every) != 0:
            return True
    if isinstance(x, torch.Tensor):
        bad = int((~torch.isfinite(x)).sum())
        shape = tuple(x.shape)
    else:
        arr = np.asarray(x)
        bad = int(np.size(arr) - np.isfinite(arr).sum())
        shape = arr.shape
    if bad:
        msg = f"nan_guard: {name} has {bad} non-finite values (shape {shape})"
        print(msg, file=sys.stderr, flush=True)
        if halt:
            raise NanGuardError(msg)
        return False
    return True


def scrub_logits(logits, fill: float = -100.0):
    """NaN/Inf -> ``fill`` (the joint-logits scrub); a tensor stays a tensor."""
    if isinstance(logits, torch.Tensor):
        return torch.where(torch.isfinite(logits), logits, torch.full_like(logits, fill))
    return np.where(np.isfinite(logits), logits, fill)
