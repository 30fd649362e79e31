"""Unbuffered, timestamped stage markers on stderr for hang diagnosis
(``RuntimeConfig.stage_markers``: TRT_ASR_STAGE_MARKERS /
PARAKEET_DEBUG_STAGE_MARKERS). Same line format as the JAX package's:
``[stage +<seconds since import>s] <message>``."""

from __future__ import annotations

import sys
import time

_T0 = time.monotonic()


def stage_marker(rt, msg: str, force: bool = False) -> None:
    """Print ``msg`` when ``rt.stage_markers`` is on, or with ``force``."""
    if force or (rt is not None and rt.stage_markers):
        print(f"[stage +{time.monotonic() - _T0:10.3f}s] {msg}", file=sys.stderr, flush=True)
