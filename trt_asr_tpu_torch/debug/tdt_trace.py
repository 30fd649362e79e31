"""Decode step trace (``RuntimeConfig.debug_tdt_steps``,
PARAKEET_DEBUG_TDT_STEPS) and its first-divergence check.

With ``trace=True`` the chunk decoder (``decode/tdt_greedy.py``) returns a
bounded int32 record buffer, one row per loop iteration in ``COLUMNS``
order; :func:`records_from_buffer` turns it into step dicts in the schema
``decode/host_decode.py`` writes, :func:`write_ndjson` writes them after a
meta line (the session's is the JAX package's ``debug/tdt_trace.py``
meta, ``"source": "device_while_loop"``; the golden runner's the golden
trace's), and :func:`compare_traces` finds the first step
where two traces differ, with the rules and verdict words of
``tools/parity/compare_tdt_trace.py`` (``IDENTICAL``, ``FIRST
DIVERGENCE``, ``LENGTH MISMATCH``, ``EMITTED MISMATCH``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

# column order of the chunk decoder's trace buffer
COLUMNS = ("time_idx", "u", "y_id", "best_tok", "duration", "advance", "is_blank")
# the fields two traces must agree on, step for step
KEYS = ("time_idx", "u", "best_tok", "duration", "advance", "is_blank")


def records_from_buffer(buf, n_steps: int) -> List[Dict]:
    """The decoder's int32 record buffer [rows, 7] -> step dicts (host
    schema): ``duration`` is the duration head's value, ``advance`` the
    step after the blank + duration-0 clamp, which ``blank_dur0_clamped``
    flags."""
    buf = np.asarray(buf)
    out: List[Dict] = []
    for row in buf[: int(n_steps)]:
        rec = {"type": "step"}
        rec.update({k: int(v) for k, v in zip(COLUMNS, row)})
        rec["is_blank"] = bool(rec["is_blank"])
        rec["blank_dur0_clamped"] = bool(
            rec["is_blank"] and rec["duration"] == 0 and rec["advance"] == 1)
        out.append(rec)
    return out


def write_ndjson(path: str, steps: List[Dict], meta: Dict) -> None:
    """One NDJSON line for ``meta``, then one a step."""
    with open(path, "w") as f:
        f.write(json.dumps(meta) + "\n")
        for rec in steps:
            f.write(json.dumps(rec) + "\n")


def load_trace(path: str) -> Tuple[Dict, List[Dict]]:
    """(meta, steps) of an NDJSON trace file."""
    meta, steps = {}, []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("type") == "meta":
                meta = rec
            elif rec.get("type") == "step":
                steps.append(rec)
    return meta, steps


def compare_traces(golden, other, context: int = 2) -> Tuple[bool, str]:
    """First-divergence comparison of two traces, each a path or a (meta,
    steps) pair: step by step on ``KEYS``, then the step counts, then the
    meta lines' ``emitted`` where both have a token list. Returns (True,
    "traces IDENTICAL: ...") or (False, a report naming the first
    divergence with ``context`` steps around it)."""
    gm, gs = load_trace(golden) if isinstance(golden, str) else golden
    om, os_ = load_trace(other) if isinstance(other, str) else other
    n = min(len(gs), len(os_))
    for i in range(n):
        diffs = [k for k in KEYS if gs[i].get(k) != os_[i].get(k)]
        if diffs:
            lines = [f"FIRST DIVERGENCE at step {i}: fields {diffs}"]
            for j in range(max(0, i - context), min(n, i + context + 1)):
                mark = ">>" if j == i else "  "
                lines.append(f"{mark} step {j} golden: { {k: gs[j].get(k) for k in KEYS} }")
                lines.append(f"{mark} step {j} other : { {k: os_[j].get(k) for k in KEYS} }")
            return False, "\n".join(lines)
    if len(gs) != len(os_):
        return False, (f"LENGTH MISMATCH: golden {len(gs)} steps vs other {len(os_)} "
                       f"(first {n} identical)")
    g_em, o_em = gm.get("emitted"), om.get("emitted")
    if g_em is not None and o_em is not None and g_em != o_em:
        return False, f"EMITTED MISMATCH: {g_em} vs {o_em}"
    return True, f"traces IDENTICAL: {n} steps, emitted={g_em}"
