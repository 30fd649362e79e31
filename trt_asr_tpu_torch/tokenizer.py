"""Vocab-file tokenizer (decode side).

Behavioral parity with the reference's C++ tokenizer
(cpp/src/tokenizer.cpp:32-90 in gracee3/trt-asr-engine):

- newline-delimited vocab.txt, token id = line index
- SentencePiece word-boundary marker ``▁`` (U+2581) decodes to a space
- control tokens of the form ``<...>`` are skipped during decode
- ``is_punct_only`` classifies tokens used by leading-punctuation suppression
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional

WORD_BOUNDARY = "▁"  # ▁


class Tokenizer:
    def __init__(self, vocab: List[str], blank_id: Optional[int] = None):
        self.vocab = vocab
        self.blank_id = blank_id if blank_id is not None else len(vocab)
        self._tok_to_id = {}
        for i, t in enumerate(vocab):
            self._tok_to_id.setdefault(t, i)

    @classmethod
    def from_file(cls, path: str, blank_id: Optional[int] = None) -> "Tokenizer":
        with open(path, "r", encoding="utf-8") as f:
            vocab = [line.rstrip("\r\n") for line in f]
        # Trailing empty line is an artifact, not a token.
        while vocab and vocab[-1] == "":
            vocab.pop()
        return cls(vocab, blank_id=blank_id)

    def __len__(self) -> int:
        return len(self.vocab)

    def token_at(self, token_id: int) -> str:
        if 0 <= token_id < len(self.vocab):
            return self.vocab[token_id]
        return ""

    def token_id(self, token: str) -> int:
        return self._tok_to_id.get(token, -1)

    @staticmethod
    def is_control(token: str) -> bool:
        return len(token) >= 2 and token.startswith("<") and token.endswith(">")

    @staticmethod
    def is_punct_only(token: str) -> bool:
        """True if the token body (ignoring the ▁ marker) is non-empty and
        consists only of ASCII punctuation."""
        body = token.replace(WORD_BOUNDARY, "")
        if not body:
            return False
        return all(not ch.isalnum() and not ch.isspace() and ord(ch) < 0x2580 for ch in body)

    def encode(self, text: str) -> List[int]:
        """Greedy longest-match SentencePiece-style tokenization — the
        fine-tuning label path (the reference runtime only DEcodes;
        encoding lived inside NeMo, which this environment doesn't have).

        Normalization follows the SP convention: every word boundary
        becomes the ``▁`` marker, including a leading one. Pieces are
        matched longest-first against the non-control vocab; characters
        no piece covers fall back to ``<unk>`` when present, else are
        skipped. Deterministic, and ``decode(encode(t)) == t`` whenever
        t's characters are representable (tests). NOTE: greedy
        longest-match need not reproduce SentencePiece's unigram
        segmentation — token IDs can differ from NeMo's even when the
        decoded text matches; use for training labels, not for
        logit-level parity fixtures."""
        pieces = getattr(self, "_pieces", None)
        if pieces is None:
            # first occurrence wins, matching _tok_to_id's setdefault:
            # duplicated vocab lines must encode to the same canonical id
            # decode/token_id use
            pieces = {}
            for i, t in enumerate(self.vocab):
                if t and not self.is_control(t) and t not in pieces:
                    pieces[t] = i
            self._pieces = pieces
            self._max_piece = max(map(len, pieces), default=1)
        s = WORD_BOUNDARY + text.strip().replace(" ", WORD_BOUNDARY)
        unk = self.token_id("<unk>")
        ids: List[int] = []
        i = 0
        while i < len(s):
            for ln in range(min(self._max_piece, len(s) - i), 0, -1):
                pid = pieces.get(s[i : i + ln])
                if pid is not None:
                    ids.append(pid)
                    i += ln
                    break
            else:
                if unk >= 0:
                    ids.append(unk)
                i += 1
        # a bare ▁ segment (nothing matched after a space) contributes
        # nothing on decode; ids as-is round-trip through decode()
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        for tid in ids:
            if tid == self.blank_id:
                continue
            tok = self.token_at(int(tid))
            if not tok or self.is_control(tok):
                continue
            parts.append(tok.replace(WORD_BOUNDARY, " "))
        return "".join(parts).lstrip(" ")


def make_synthetic_vocab(size: int, prompt_tokens: Iterable[str] = ("<|startoftranscript|>", "<|en|>")) -> List[str]:
    """Deterministic synthetic vocab for tests/fixtures (no real assets here).

    Layout loosely mirrors the real asset: specials first, then ▁-prefixed
    word pieces and plain subword pieces.
    """
    specials = ["<unk>", "<|nospeech|>", "<pad>", "<|endoftext|>"] + list(prompt_tokens) + ["<|nopnc|>", "<|noitn|>"]
    vocab = list(specials[:size])
    punct = [".", ",", "?", "!", "'", "-"]
    vocab += [p for p in punct if len(vocab) < size]
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    i = 0
    while len(vocab) < size:
        a, b = divmod(i, len(alphabet))
        piece = alphabet[b] * (1 + a % 3)
        vocab.append((WORD_BOUNDARY + piece) if i % 2 == 0 else piece + str(a))
        i += 1
    return vocab[:size]


def write_vocab(path: str, vocab: List[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for t in vocab:
            f.write(t + "\n")
