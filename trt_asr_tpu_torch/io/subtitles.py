"""SRT and WebVTT subtitles from word timestamps, as the JAX package's
``io/subtitles.py``. Words are packed greedily into cues: a cue closes
when the next word would pass ``max_chars`` or ``max_dur_s``, or when a
silence of more than ``gap_s`` opens before it.

Inputs are the package's own records:
- words: [{word, start_s, end_s}, ...] (``StreamingSession.word_timestamps``);
- segments: [{text, words, start_s, ...}, ...] (``ContinuousTranscriber``
  and the daemon's segment events), whose words are relative to the
  segment: ``offset_s=segment["start_s"]`` puts them on the stream's clock.
"""

from __future__ import annotations

from typing import List, Optional


def _fmt_ts(t: float, sep: str) -> str:
    ms = int(round(t * 1000))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def pack_cues(words: List[dict], *, max_chars: int = 42,
              max_dur_s: float = 5.0, gap_s: float = 0.8,
              offset_s: float = 0.0) -> List[dict]:
    """Greedy word -> cue packing; returns [{start_s, end_s, text}]."""
    cues: List[dict] = []
    cur: Optional[dict] = None
    for w in words:
        ws, we = w["start_s"] + offset_s, w["end_s"] + offset_s
        if cur is not None:
            new_text = f"{cur['text']} {w['word']}"
            if (len(new_text) > max_chars
                    or we - cur["start_s"] > max_dur_s
                    or ws - cur["end_s"] > gap_s):
                cues.append(cur)
                cur = None
        if cur is None:
            cur = {"start_s": ws, "end_s": we, "text": w["word"]}
        else:
            cur["text"] = new_text
            cur["end_s"] = we
    if cur is not None:
        cues.append(cur)
    return cues


def cues_from_segments(segments: List[dict], **kw) -> List[dict]:
    """Continuous-mode segments -> cues, packed segment by segment, each
    segment's words moved to the stream's clock by its ``start_s``."""
    cues: List[dict] = []
    for seg in segments:
        cues.extend(pack_cues(seg.get("words", []), offset_s=seg["start_s"], **kw))
    return cues


def format_srt(cues: List[dict]) -> str:
    out = []
    for i, c in enumerate(cues, 1):
        out.append(f"{i}\n{_fmt_ts(c['start_s'], ',')} --> "
                   f"{_fmt_ts(c['end_s'], ',')}\n{c['text']}\n")
    return "\n".join(out)


def format_vtt(cues: List[dict]) -> str:
    out = ["WEBVTT\n"]
    for c in cues:
        out.append(f"{_fmt_ts(c['start_s'], '.')} --> "
                   f"{_fmt_ts(c['end_s'], '.')}\n{c['text']}\n")
    return "\n".join(out)
