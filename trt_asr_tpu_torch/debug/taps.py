"""Audio and feature taps: deterministic replay capture.

The JAX package's ``debug/taps.py``, file for file: a run-isolated
directory ``<tap_dir>/run_<ts>_<pid>/`` holding, per tap, the raw f32
stream (``audio.f32``, ``features.f32``), per-chunk NDJSON records with
each chunk's stats (peak, RMS, dBFS, NaN/Inf count) and a JSON sidecar of
the aggregate, written at close. A feature tap replays through the CLI's
``--features-input``; ``tools/analyze_tap.py`` reads either. Switched on by
``RuntimeConfig.tap_enabled`` / ``tap_dir`` (TRT_ASR_TAP_ENABLE /
AUDIO_TAP_ENABLE, TRT_ASR_TAP_DIR / AUDIO_TAP_DIR).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np


def _stats(x: np.ndarray) -> Dict[str, float]:
    finite = np.isfinite(x)
    n_bad = int(x.size - finite.sum())
    xa = np.abs(x[finite]) if n_bad else np.abs(x)
    peak = float(xa.max()) if xa.size else 0.0
    rms = float(np.sqrt(np.mean(np.square(xa)))) if xa.size else 0.0
    return {
        "num_values": int(x.size),
        "nan_inf_count": n_bad,
        "peak": peak,
        "rms": rms,
        "dbfs_peak": 20.0 * math.log10(peak) if peak > 0 else -200.0,
        "dbfs_rms": 20.0 * math.log10(rms) if rms > 0 else -200.0,
        "min": float(x[finite].min()) if xa.size else 0.0,
        "max": float(x[finite].max()) if xa.size else 0.0,
    }


class TapWriter:
    """One tap stream: appends raw f32 data + per-chunk NDJSON records,
    finalizes a JSON sidecar with aggregate stats."""

    def __init__(self, run_dir: str, name: str, kind: str, layout: str = "frames_major",
                 bins: int = 0):
        self.path = os.path.join(run_dir, f"{name}.f32")
        self.ndjson_path = os.path.join(run_dir, f"{name}.chunks.ndjson")
        self.sidecar_path = os.path.join(run_dir, f"{name}.f32.json")
        self.kind = kind
        self.layout = layout
        self.bins = bins
        self._count = 0
        self._chunks = 0
        self._nan = 0
        self._peak = 0.0
        self._sumsq = 0.0
        self._gap_count = 0
        self._gap_values = 0
        self._f = open(self.path, "wb")
        self._nd = open(self.ndjson_path, "w")

    def write(self, x: np.ndarray, meta: Optional[Dict] = None,
              stream_pos: Optional[int] = None) -> None:
        """Append one chunk. ``stream_pos`` (samples for audio taps, frames
        for feature taps) is this chunk's position in the source stream;
        when it lies beyond what has been written, the hole is zero-filled
        and counted, so the tap file stays time-aligned with the source."""
        x = np.asarray(x, np.float32)
        gap_filled = 0
        if stream_pos is not None:
            want = int(stream_pos) * (self.bins or 1)
            if want > self._count:
                gap_filled = want - self._count
                np.zeros(gap_filled, np.float32).tofile(self._f)
                self._count += gap_filled
                self._gap_count += 1
                self._gap_values += gap_filled
        x.tofile(self._f)
        st = _stats(x)
        self._count += x.size
        self._chunks += 1
        self._nan += st["nan_inf_count"]
        self._peak = max(self._peak, st["peak"])
        self._sumsq += float(np.square(x[np.isfinite(x)]).sum())
        rec = {"chunk": self._chunks - 1, "t": time.time(), **st}
        if gap_filled:
            rec["gap_values_filled"] = gap_filled
        if meta:
            rec.update(meta)
        self._nd.write(json.dumps(rec) + "\n")
        self._nd.flush()
        self._f.flush()

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.close()
        self._nd.close()
        rms = math.sqrt(self._sumsq / self._count) if self._count else 0.0
        sidecar = {
            "kind": self.kind,
            "layout": self.layout,
            "bins": self.bins,
            "frames": self._count // self.bins if self.bins else self._count,
            "chunks": self._chunks,
            "num_values": self._count,
            "nan_inf_count": self._nan,
            "peak": self._peak,
            "rms": rms,
            "dbfs_peak": 20.0 * math.log10(self._peak) if self._peak > 0 else -200.0,
            "gap_count": self._gap_count,
            "gap_values_filled": self._gap_values,
            "gaps_filled": self._gap_count > 0,
        }
        with open(self.sidecar_path, "w") as f:
            json.dump(sidecar, f, indent=1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TapRun:
    """Run-isolated tap directory: ``<tap_dir>/run_<ts>_<pid>/``."""

    def __init__(self, tap_dir: str):
        ts = time.strftime("%Y%m%d_%H%M%S")
        self.run_dir = os.path.join(tap_dir, f"run_{ts}_{os.getpid()}")
        os.makedirs(self.run_dir, exist_ok=True)
        self._writers: Dict[str, TapWriter] = {}

    def audio(self, name: str = "audio") -> TapWriter:
        return self._get(name, "audio_pcm_f32", layout="mono", bins=0)

    def features(self, name: str = "features", n_mels: int = 128) -> TapWriter:
        return self._get(name, "logmel_features", layout="frames_major", bins=n_mels)

    def _get(self, name: str, kind: str, layout: str, bins: int) -> TapWriter:
        if name not in self._writers:
            self._writers[name] = TapWriter(self.run_dir, name, kind, layout, bins)
        return self._writers[name]

    def close(self) -> None:
        for w in self._writers.values():
            w.close()


def maybe_tap_run(rt) -> Optional[TapRun]:
    """RuntimeConfig-gated constructor (None when taps disabled)."""
    if rt is not None and rt.tap_enabled:
        return TapRun(rt.tap_dir or "artifacts/taps")
    return None
