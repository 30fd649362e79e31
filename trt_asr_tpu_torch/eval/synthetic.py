"""The synthetic spoken-words task the committed ``gate_r3`` model was
trained on: a vocabulary of pronounceable words, each an acoustic code of
three frequency bands (and a duration bit), and deterministic utterance
sets drawn from a seed. The port's own copy of the generators of
``tools/train_synthetic_e2e.py``; their output is equal bit for bit, so the
held-out set (seed 2) is the same utterances on both sides.
"""

from __future__ import annotations

from math import comb

import numpy as np

_CONS = ["b", "d", "f", "g", "h", "j", "k", "l", "m", "n",
         "p", "r", "s", "t", "v", "w", "z", "ch", "sh", "th"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "oo", "ei", "ou", "ia"]


def make_words(n: int):
    """n distinct pronounceable CVCV words (20x10 pairs -> up to 40000)."""
    words = []
    i = 0
    while len(words) < n:
        c1, v1 = _CONS[i % 20], _VOWELS[(i // 20) % 10]
        c2, v2 = _CONS[(i // 200) % 20], _VOWELS[(i // 4000) % 10]
        words.append(c1 + v1 + c2 + v2)
        i += 1
    return words


_N_BANDS = 16
_BANDS = [200.0 * (2 ** (i * 5.23 / _N_BANDS)) for i in range(_N_BANDS)]
# 200 Hz .. ~7.5 kHz, log-spaced: adjacent bands ~150 mel apart -> >=2 mel
# bins of separation at 32 bins, so every band is individually resolvable.
_N_COMBOS = 560                                   # C(16, 3)


def _combo_3_of_n(idx: int, n: int = _N_BANDS):
    """Unrank idx into the idx-th 3-element subset of range(n)."""
    out, prev = [], -1
    k = 3
    for _ in range(3):
        c = prev + 1
        while comb(n - 1 - c, k - 1) <= idx:
            idx -= comb(n - 1 - c, k - 1)
            c += 1
        out.append(c)
        prev = c
        k -= 1
    return out


def synth_word(word_idx: int, rng, sr=16000) -> np.ndarray:
    """Acoustic signature unique per word: a DTMF-style 3-of-16
    frequency-band code (560 combos), doubled by a duration bit (0.30 s vs
    0.42 s) for word_idx >= 560: 1120 cleanly separable classes at 32 mel
    bins."""
    dur = int((0.42 if word_idx >= _N_COMBOS else 0.30) * sr)
    t = np.arange(dur) / sr
    bands = _combo_3_of_n(word_idx % _N_COMBOS)
    x = 0.02 * rng.standard_normal(dur)
    for j, bi in enumerate(bands):
        x = x + (0.30 - 0.05 * j) * np.sin(2 * np.pi * _BANDS[bi] * t)
    env = np.minimum(np.arange(dur), dur - np.arange(dur)) / (0.02 * sr)
    return (x * np.clip(env, 0, 1)).astype(np.float32)


def synth_utterance(word_ids, rng, sr=16000, tail_s=0.6) -> np.ndarray:
    """Words 0.08 s apart, then ``tail_s`` of trailing silence (at least
    one steady chunk, 57 frames = 0.57 s): streaming-consistent training
    emulates only steady chunks, so the serving-side finalize flush must
    land entirely in silence."""
    gap = np.zeros(int(0.08 * sr), np.float32)
    parts = [gap.copy()]
    for w in word_ids:
        parts.append(synth_word(w, rng))
        parts.append(gap.copy())
    parts.append(np.zeros(int(tail_s * sr), np.float32))
    return np.concatenate(parts)


def make_set(n, seed, words, w_lo, w_hi):
    """Deterministic utterance set [(word ids, audio)]; seed=1 is the
    training set, seed=2 the held-out eval set. The first k utterances of
    a set do not depend on n."""
    r = np.random.default_rng(seed)
    utts = []
    for i in range(n):
        k = int(r.integers(w_lo, w_hi))
        # guarantee full vocabulary coverage across the training set
        forced = (i * 3) % len(words)
        ids = [forced] + list(r.integers(0, len(words), size=k - 1))
        utts.append((ids, synth_utterance(ids, r)))
    return utts


def add_noise(audio: np.ndarray, snr_db: float, rng) -> np.ndarray:
    """Additive white noise at the given SNR."""
    p_sig = float(np.mean(audio ** 2)) + 1e-12
    p_noise = p_sig / (10.0 ** (snr_db / 10.0))
    return (audio + rng.standard_normal(audio.shape).astype(np.float32)
            * np.sqrt(p_noise)).astype(np.float32)
