"""Bounded profiler capture of the streaming chunk steps
(``RuntimeConfig.profile_dir`` / ``profile_chunks``: TRT_ASR_PROFILE_DIR,
TRT_ASR_PROFILE_CHUNKS, default 20).

The JAX package records an XPlane capture with ``jax.profiler``; this
package records what ``torch.profiler`` gives: the host's operators and,
on a CUDA device, the card's kernels, copies and fills (CUPTI). The
capture starts at the first chunk step and stops after ``profile_chunks``
steps or at ``finalize``, whichever comes first, and is written as one
Chrome trace, ``trace.json``, under a run-isolated ``run_<time>/``
directory of ``profile_dir`` (open it in Perfetto or chrome://tracing).

Usage:
    TRT_ASR_PROFILE_DIR=/tmp/prof python -m trt_asr_tpu_torch.cli demo.wav ...
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class ChunkProfiler:
    """Bounded profiler session: starts on the first chunk, stops after
    ``max_chunks``. ``device`` is the session's device: on a CUDA device
    the capture includes the card's activity."""

    def __init__(self, out_dir: str, max_chunks: int = 20, device=None):
        self.out_dir = os.path.join(out_dir, f"run_{int(time.time())}")
        self.trace_path = os.path.join(self.out_dir, "trace.json")
        self.max_chunks = max_chunks
        self._cuda = torch.device(device or "cpu").type == "cuda"
        self._prof = None
        self._count = 0
        self._done = False

    def chunk_start(self) -> None:
        if self._done or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.out_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=acts)
        self._prof.start()

    def chunk_end(self) -> None:
        if self._prof is None:
            return
        self._count += 1
        if self._count >= self.max_chunks:
            self.stop()

    def stop(self) -> None:
        """End the capture (if one runs) and write its trace."""
        if self._prof is None:
            return
        if self._cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self._done = True


def maybe_profiler(rt, device=None) -> Optional[ChunkProfiler]:
    """A ChunkProfiler when ``rt.profile_dir`` is set, else None."""
    if not getattr(rt, "profile_dir", ""):
        return None
    return ChunkProfiler(rt.profile_dir, rt.profile_chunks, device=device)
