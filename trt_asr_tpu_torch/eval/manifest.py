"""Manifests: a TSV of (audio path, transcript, sha256, duration), one
utterance a line, the format of the JAX package's ``eval/manifest.py``
(the port keeps its own copy). WAV trees with sibling .txt transcripts and
LibriSpeech-style .trans.txt indexes are scanned natively; a sha256 in the
manifest can be checked on read.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class ManifestEntry:
    audio_path: str
    transcript: str
    sha256: str = ""
    duration_sec: float = 0.0


def _wav_duration(path: str) -> float:
    import wave

    try:
        with wave.open(path, "rb") as w:
            return w.getnframes() / float(w.getframerate())
    except Exception:
        return 0.0


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def scan_wav_tree(root: str) -> List[ManifestEntry]:
    """WAV files paired with transcripts from (a) sibling .txt files or
    (b) LibriSpeech-style *.trans.txt indexes (``<utt-id> <TRANSCRIPT>``)."""
    entries: List[ManifestEntry] = []
    trans: Dict[str, str] = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(".trans.txt"):
                with open(os.path.join(dirpath, fn), encoding="utf-8") as f:
                    for line in f:
                        parts = line.strip().split(" ", 1)
                        if len(parts) == 2:
                            trans[parts[0]] = parts[1]
    for dirpath, _dirs, files in os.walk(root):
        for fn in sorted(files):
            if not fn.endswith(".wav"):
                continue
            path = os.path.join(dirpath, fn)
            utt = os.path.splitext(fn)[0]
            text = trans.get(utt, "")
            if not text:
                txt = os.path.join(dirpath, utt + ".txt")
                if os.path.exists(txt):
                    with open(txt, encoding="utf-8") as f:
                        text = f.read().strip()
            entries.append(ManifestEntry(path, text))
    return entries


def write_manifest(path: str, entries: List[ManifestEntry], with_sha: bool = False,
                   with_duration: bool = True) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("audio_path\ttranscript\tsha256\tduration_sec\n")
        for e in entries:
            sha = _sha256(e.audio_path) if with_sha else e.sha256
            dur = _wav_duration(e.audio_path) if with_duration else e.duration_sec
            f.write(f"{e.audio_path}\t{e.transcript}\t{sha}\t{dur:.3f}\n")


def read_manifest(path: str, verify_sha: bool = False) -> List[ManifestEntry]:
    entries: List[ManifestEntry] = []
    with open(path, encoding="utf-8") as f:
        header = f.readline()
        assert header.startswith("audio_path"), f"bad manifest header: {header!r}"
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            e = ManifestEntry(parts[0], parts[1],
                              parts[2] if len(parts) > 2 else "",
                              float(parts[3]) if len(parts) > 3 and parts[3] else 0.0)
            if verify_sha and e.sha256:
                got = _sha256(e.audio_path)
                if got != e.sha256:
                    raise ValueError(f"manifest gate: sha mismatch for {e.audio_path}")
            entries.append(e)
    return entries

