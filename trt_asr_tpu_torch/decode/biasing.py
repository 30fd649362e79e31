"""Contextual biasing (hotwords) for the beam's LM-fusion hook, as the JAX
package's ``decode/biasing.py``.

``make_biasing_lm`` compiles a phrase list (text, through
``Tokenizer.encode``) into a token-prefix trie and returns an
``lm_fn(prefix_tokens, candidate)``: a candidate token earns ``bonus``
log-probability iff it starts a phrase or continues one that a suffix of
the decoded prefix has partly matched. The boost applies while inside a
phrase, so a multi-token phrase gains in proportion to its length, and a
hypothesis that leaves a phrase midway keeps only the tokens it matched.

Works wherever ``lm_fn``/``lm_weight`` are taken: the offline beam
(``ParakeetTDT.transcribe_offline_beam``), the streaming beam session, the
engine's batched beam and the CLI (``--bias``/``--bias-bonus``).
``lm_device.biasing_to_device`` compiles the same trie into tensor tables
for the device beam.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set, Tuple


class BiasingLM:
    """A compiled phrase-prefix trie, callable as the beam's lm_fn."""

    def __init__(self, cont: Dict[Tuple[int, ...], Set[int]],
                 max_pfx: int, bonus: float, vocab_size: int):
        self.cont = cont           # proper prefix -> continuation tokens
        self.max_pfx = max_pfx
        self.bonus = float(bonus)
        self.vocab_size = int(vocab_size)

    def __call__(self, prefix: List[int], tok: int) -> float:
        for k in range(0, min(self.max_pfx, len(prefix)) + 1):
            nexts = self.cont.get(tuple(prefix[len(prefix) - k:]))
            if nexts and tok in nexts:
                return self.bonus
        return 0.0


def make_biasing_lm(phrases: Iterable[str], tokenizer, *, bonus: float = 3.0) -> BiasingLM:
    """Compile phrase strings into a biasing lm_fn. ``bonus`` is the
    log-prob reward per matched token (before the lm_weight scaling)."""
    unk = tokenizer.token_id("<unk>") if hasattr(tokenizer, "token_id") else -1
    token_phrases: List[Sequence[int]] = []
    for p in phrases:
        ids = tuple(tokenizer.encode(p))
        # a phrase the vocab cannot represent encodes (partly) to <unk>;
        # biasing it would reward every <unk> emission, so it is dropped
        if ids and unk not in ids:
            token_phrases.append(ids)
    # proper prefix -> continuation tokens: a query is a few dict lookups
    cont: dict = {}
    for p in token_phrases:
        for k in range(len(p)):
            cont.setdefault(p[:k], set()).add(p[k])
    max_pfx = max((len(p) - 1 for p in token_phrases), default=0)
    # the vocab size only sizes the device tables; a tokenizer without
    # .vocab gives the largest phrase token
    vocab = getattr(tokenizer, "vocab", None)
    vocab_size = len(vocab) if vocab is not None else 1 + max(
        (t for p in token_phrases for t in p), default=0)
    return BiasingLM(cont, max_pfx, bonus, vocab_size)
