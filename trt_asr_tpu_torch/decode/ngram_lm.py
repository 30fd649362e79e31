"""Token n-gram language model for shallow fusion, as the JAX package's
``decode/ngram_lm.py``: a count-based n-gram LM with stupid backoff
(Brants et al. 2007), whose ``score(prefix, token)`` is the beam's
``lm_fn`` (``decode/beam.py``).

    lm = NGramLM.fit(token_seqs, order=3)
    lm.save("lm.json")                     # the same v1 JSON as the JAX package's
    lm = NGramLM.load("lm.json")
    model.transcribe_offline_beam(audio, lm_fn=lm, lm_weight=0.6)
    # or: python -m trt_asr_tpu_torch.cli a.wav --beam 4 --lm lm.json --lm-weight 0.6

Scoring: score(prefix, t) = log P_sb(t | last order-1 tokens), where
P_sb(t|ctx) = count(ctx+t)/count(ctx) if seen, else alpha * P_sb(t|ctx[1:]),
grounded at the unigram level with add-1 smoothing over the vocab, so that
an unseen token gets a finite penalty and never vetoes the acoustic model.
Pure Python: it runs on the host for the host beam, and ``lm_device.py``
compiles it into tensor tables for the device beam.
"""

from __future__ import annotations

import json
import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, Sequence, Tuple

BOS = -1  # sentence-start context token (never a real vocab id)
FORMAT = "trt-asr-tpu/ngram-lm/v1"


class NGramLM:
    def __init__(self, order: int, counts: Dict[Tuple[int, ...], Counter],
                 vocab_size: int, alpha: float = 0.4):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        self.counts = counts                    # context tuple -> Counter(next)
        self.totals = {c: sum(v.values()) for c, v in counts.items()}
        self.vocab_size = vocab_size
        self.alpha = alpha

    @classmethod
    def fit(cls, sequences: Iterable[Sequence[int]], order: int = 3,
            vocab_size: int = 0, alpha: float = 0.4) -> "NGramLM":
        """Count n-grams of every length 1..order over token sequences, each
        BOS-padded so that sentence-initial contexts count."""
        counts: Dict[Tuple[int, ...], Counter] = defaultdict(Counter)
        vmax = 0
        for seq in sequences:
            toks = [int(t) for t in seq]
            if toks:
                vmax = max(vmax, max(toks) + 1)
            padded = [BOS] * (order - 1) + toks
            for i in range(order - 1, len(padded)):
                for n in range(1, order + 1):
                    if n - 1 > i:
                        break
                    ctx = tuple(padded[i - n + 1:i])
                    counts[ctx][padded[i]] += 1
        return cls(order, dict(counts), vocab_size or vmax, alpha)

    def prob(self, context: Sequence[int], token: int) -> float:
        """Stupid-backoff pseudo-probability P_sb(token | context)."""
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        scale = 1.0
        while True:
            c = self.counts.get(ctx)
            if c is not None and token in c:
                return scale * c[token] / self.totals[ctx]
            if not ctx:
                uni = self.counts.get((), Counter())
                total = self.totals.get((), 0)
                # add-1 grounded unigram: finite for unseen tokens
                return scale * (uni.get(token, 0) + 1) / (total + self.vocab_size + 1)
            ctx = ctx[1:]
            scale *= self.alpha

    def score(self, prefix: Sequence[int], token: int) -> float:
        """log P_sb: the beam's ``lm_fn(prefix, token)``."""
        padded = [BOS] * (self.order - 1) + [int(t) for t in prefix]
        return math.log(self.prob(padded, int(token)))

    __call__ = score   # an NGramLM is an lm_fn

    def sentence_logp(self, tokens: Sequence[int]) -> float:
        return sum(self.score(tokens[:i], t) for i, t in enumerate(tokens))

    def save(self, path: str) -> None:
        payload = {
            "format": FORMAT,
            "order": self.order,
            "vocab_size": self.vocab_size,
            "alpha": self.alpha,
            # contexts as space-joined strings (JSON keys must be strings)
            "counts": {" ".join(map(str, ctx)): dict(c) for ctx, c in self.counts.items()},
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    @classmethod
    def load(cls, path: str) -> "NGramLM":
        with open(path) as f:
            raw = json.load(f)
        if raw.get("format") != FORMAT:
            raise ValueError(f"{path}: not an ngram-lm/v1 file")
        counts = {tuple(int(x) for x in k.split() if x): Counter(
                      {int(t): n for t, n in v.items()})
                  for k, v in raw["counts"].items()}
        return cls(raw["order"], counts, raw["vocab_size"], raw["alpha"])


def fit_from_text(lines: Iterable[str], tokenizer, order: int = 3,
                  alpha: float = 0.4) -> NGramLM:
    """Fit from raw text through the model's tokenizer (its greedy
    longest-match encode)."""
    seqs = [tokenizer.encode(ln.strip()) for ln in lines if ln.strip()]
    return NGramLM.fit(seqs, order=order, vocab_size=len(tokenizer.vocab), alpha=alpha)
