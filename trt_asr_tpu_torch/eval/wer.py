"""WER scoring: the port's copy of the JAX package's ``eval/wer.py`` (the
same normalization and the same S/I/D backtrace, so both score alike).

Matches the reference scorer's semantics (tools/stt_suite/score_wer.py:30-85):
normalization = uppercase + strip punctuation (keeping apostrophes inside
words as the reference does not — it strips ALL punct), then DP edit
distance with substitution/insertion/deletion counts.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

_PUNCT_RE = re.compile(r"[^\w\s']", flags=re.UNICODE)
_APOS_RE = re.compile(r"(?<!\w)'|'(?!\w)")


def normalize_text(text: str) -> List[str]:
    t = text.upper()
    t = _PUNCT_RE.sub(" ", t)
    t = _APOS_RE.sub(" ", t)       # keep intra-word apostrophes (DON'T)
    return t.split()


@dataclass
class WerCounts:
    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    ref_words: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def wer(self) -> float:
        if self.ref_words == 0:
            return 0.0 if self.errors == 0 else 1.0
        return self.errors / self.ref_words

    def add(self, other: "WerCounts") -> None:
        self.substitutions += other.substitutions
        self.insertions += other.insertions
        self.deletions += other.deletions
        self.ref_words += other.ref_words


def score_pair(reference: str, hypothesis: str) -> WerCounts:
    ref = normalize_text(reference)
    hyp = normalize_text(hypothesis)
    n, m = len(ref), len(hyp)
    # DP over (n+1) x (m+1); track op counts via backtrace
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(1, n + 1):
        dist[i][0] = i
    for j in range(1, m + 1):
        dist[0][j] = j
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1])
            dele = dist[i - 1][j] + 1
            ins = dist[i][j - 1] + 1
            dist[i][j] = min(sub, dele, ins)
    # backtrace
    c = WerCounts(ref_words=n)
    i, j = n, m
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i][j] == dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                c.substitutions += 1
            i, j = i - 1, j - 1
        elif i > 0 and dist[i][j] == dist[i - 1][j] + 1:
            c.deletions += 1
            i -= 1
        else:
            c.insertions += 1
            j -= 1
    return c


def score_corpus(pairs: Iterable[Tuple[str, str]]) -> Dict[str, object]:
    total = WerCounts()
    per_utt: List[Dict] = []
    empty = 0
    for ref, hyp in pairs:
        c = score_pair(ref, hyp)
        total.add(c)
        if not hyp.strip():
            empty += 1
        per_utt.append({"wer": c.wer, "S": c.substitutions, "I": c.insertions,
                        "D": c.deletions, "ref_words": c.ref_words})
    return {
        "wer": total.wer,
        "substitutions": total.substitutions,
        "insertions": total.insertions,
        "deletions": total.deletions,
        "ref_words": total.ref_words,
        "num_utterances": len(per_utt),
        "empty_hypotheses": empty,
        "per_utterance": per_utt,
    }
