"""Token- and word-level timestamp assembly.

TDT greedy decode is frame-anchored: every emitted token carries the
encoder frame index it was emitted at plus a predicted duration (the
decoders' ``with_timestamps`` output).  This module turns those integer
(frame, duration) pairs into second-denominated token intervals and groups
them into word intervals using the tokenizer's SentencePiece word-boundary
marker.

Capability beyond the reference: its event protocol carries text only
(cpp/src/parakeet_trt.cpp:680-690 builds events from the token string);
no timestamp surface exists anywhere in gracee3/trt-asr-engine.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from trt_asr_tpu_torch.tokenizer import WORD_BOUNDARY, Tokenizer


def token_intervals(frames: Sequence[int], durs: Sequence[int],
                    frame_s: float) -> List[Dict]:
    """[(frame, dur)] -> [{"start_s", "end_s"}].

    A token's extent is [frame, frame + max(dur, 1)) encoder frames: TDT
    can emit with predicted duration 0 (more symbols at the same frame);
    such tokens still occupy their anchor frame, so the extent is clamped
    to one frame minimum.
    """
    out = []
    for f, d in zip(frames, durs):
        start = float(f) * frame_s
        out.append({"start_s": round(start, 4),
                    "end_s": round(start + max(int(d), 1) * frame_s, 4)})
    return out


def word_intervals(token_ids: Sequence[int], frames: Sequence[int],
                   durs: Sequence[int], tokenizer: Tokenizer,
                   frame_s: float,
                   logps: Optional[Sequence[float]] = None) -> List[Dict]:
    """Group frame-anchored tokens into words with [start_s, end_s].

    Grouping mirrors ``Tokenizer.decode``: blank and control tokens are
    skipped; a piece beginning with the SentencePiece word-boundary marker
    starts a new word; any other piece (subword continuations AND bare
    punctuation) attaches to the current word.  A word's interval spans its
    first token's anchor frame through its last token's anchor + duration
    (minimum one frame, see token_intervals).

    When per-token decode confidences ``logps`` are given, each word also
    carries ``logp`` — the sum over its pieces (the log-probability of the
    word under the decode-time token distributions).
    """
    words: List[Dict] = []
    cur_text: List[str] = []
    cur_start = cur_end = cur_logp = 0.0
    lps = logps if logps is not None else [0.0] * len(token_ids)

    def flush():
        if cur_text:
            w = {"word": "".join(cur_text),
                 "start_s": round(cur_start, 4),
                 "end_s": round(cur_end, 4)}
            if logps is not None:
                w["logp"] = round(cur_logp, 4)
            words.append(w)

    for tid, f, d, lp in zip(token_ids, frames, durs, lps):
        tid = int(tid)
        if tid == tokenizer.blank_id:
            continue
        piece = tokenizer.token_at(tid)
        if not piece or Tokenizer.is_control(piece):
            continue
        start = float(f) * frame_s
        end = start + max(int(d), 1) * frame_s
        if piece.startswith(WORD_BOUNDARY) or not cur_text:
            flush()
            cur_text = [piece.replace(WORD_BOUNDARY, "")]
            cur_start, cur_end, cur_logp = start, end, float(lp)
        else:
            cur_text.append(piece)
            cur_end = max(cur_end, end)
            cur_logp += float(lp)
    flush()
    return [w for w in words if w["word"]]
