"""Shallow-fusion scorers of the device beam, as the JAX package's
``decode/lm_device.py``: the stupid-backoff n-gram LM (``ngram_lm.py``) and
the contextual-biasing trie (``biasing.py``) compiled into tensor tables on
the card and scored by tensor ops, with no host call inside the search.

An n-gram table is a sorted composite-key array searched by a vectorized
lexicographic binary search (``ceil(log2 N) + 1`` gather-and-compare
rounds, no data-dependent control flow). Context tokens are packed into two int32
Horner codes (base ``vocab + 2``, so that the BOS sentinel packs too); the
build checks (vocab + 2)^ceil(max_ctx / 2) against 2^31 for the context
length actually packed. Each backoff level (context length c = 1 ..
order - 1) is a table of its own; scoring walks the levels shortest first,
so that the deepest hit wins, as the host's backoff loop:

    score = alpha^(order-1) * P_add1(tok)                 # grounded unigram
    score = alpha^(order-1-c) * count(ctx+t)/count(ctx)   # deepest hit c

The biasing trie compiles the same way (level c holds the pairs of a
length-c proper prefix and its continuations), with "bonus iff any level
hits" in place of backoff. The tables equal the JAX package's element for
element, and the scores equal the host callables to f32 rounding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class LMSpec(NamedTuple):
    """The static half of a device LM."""

    mode: str                 # "backoff" (n-gram) | "bonus" (biasing trie)
    ctx_lens: Tuple[int, ...]  # context length per level, ascending
    order: int                # n-gram order (backoff); max_pfx + 1 for bonus
    log_alpha: float          # backoff penalty per skipped level
    bonus: float              # per-token reward (bonus mode)
    base: int                 # Horner packing base (vocab_size + 2)


class LMLevel(NamedTuple):
    """One context-length level: parallel arrays sorted by
    (ctx_hi, ctx_lo, tok) lexicographically."""

    ctx_hi: torch.Tensor      # [N] int32 Horner code of the older half
    ctx_lo: torch.Tensor      # [N] int32 Horner code of the recent half
    tok: torch.Tensor         # [N] int32 raw next-token id
    val: torch.Tensor         # [N] f32 level score (log count-ratio / bonus)


class LMTables(NamedTuple):
    """The tensor half of a device LM."""

    levels: Tuple[LMLevel, ...]
    uni: torch.Tensor         # [V] f32 grounded unigram logp (backoff);
                              # [1] zeros placeholder in bonus mode
    uni_floor: torch.Tensor   # [] f32 add-1 logp for tokens >= V


def _split(c: int) -> Tuple[int, int]:
    """Tokens per (hi, lo) Horner code for a context of length c."""
    n_hi = c // 2
    return n_hi, c - n_hi


def _encode_np(tokens, base: int) -> Tuple[int, int]:
    """The (hi, lo) codes of one context tuple (build time, on the host)."""
    n_hi, _ = _split(len(tokens))
    hi = lo = 0
    for t in tokens[:n_hi]:
        hi = hi * base + (int(t) + 1)       # BOS (-1) packs to 0
    for t in tokens[n_hi:]:
        lo = lo * base + (int(t) + 1)
    return hi, lo


def _build_level(entries, base: int, device) -> Optional[LMLevel]:
    """entries: [(ctx tuple, tok, val)] -> sorted LMLevel (None if empty)."""
    if not entries:
        return None
    rows = sorted((_encode_np(ctx, base) + (int(t), float(v))) for ctx, t, v in entries)
    hi, lo, tok, val = zip(*rows)
    i32 = lambda x: torch.tensor(np.asarray(x, np.int32), device=device)  # noqa: E731
    return LMLevel(i32(hi), i32(lo), i32(tok),
                   torch.tensor(np.asarray(val, np.float32), device=device))


def _check_base(vocab_size: int, max_ctx_len: int) -> int:
    """Packing base, checked against the widest half actually packed:
    ``_split`` puts ceil(c / 2) tokens in the lo code, so the bound is
    (vocab + 2)^ceil(max_ctx / 2) <= 2^31."""
    base = vocab_size + 2
    per_half = max(1, (max_ctx_len + 1) // 2)
    if base ** per_half > 2 ** 31:
        raise ValueError(
            f"context length {max_ctx_len} at vocab {vocab_size} overflows "
            f"the int32 Horner code: {per_half} tokens per half needs "
            f"(vocab + 2)^{per_half} <= 2^31. Reduce the n-gram order / "
            "biasing phrase length, or the vocabulary.")
    return base


def ngram_to_device(lm, device="cpu") -> Tuple[LMSpec, LMTables]:
    """Compile an ``ngram_lm.NGramLM`` into tables on ``device``."""
    base = _check_base(lm.vocab_size, lm.order - 1)
    # the dense unigram table and the Horner digits need every trained id
    # < vocab_size, or device and host scores would part
    tmax = max((t for ctx, counter in lm.counts.items() for t in (*ctx, *counter)), default=-1)
    if tmax >= lm.vocab_size:
        raise ValueError(
            f"trained token id {tmax} >= vocab_size {lm.vocab_size}: "
            "device and host scoring would diverge (dense unigram table / "
            "Horner digits cannot represent it). Refit or load the LM with "
            "vocab_size > the max token id.")
    levels, ctx_lens = [], []
    for c in range(1, lm.order):
        entries = []
        for ctx, counter in lm.counts.items():
            if len(ctx) != c:
                continue
            total = lm.totals[ctx]
            entries.extend((ctx, t, np.log(n / total)) for t, n in counter.items())
        lev = _build_level(entries, base, device)
        if lev is not None:
            levels.append(lev)
            ctx_lens.append(c)
    # grounded unigram: the count ratio when seen, the add-1 floor if not
    uni_counts = lm.counts.get((), {})
    total = lm.totals.get((), 0)
    uni = np.full(lm.vocab_size, 1.0 / (total + lm.vocab_size + 1))
    for t, n in uni_counts.items():
        if 0 <= t < lm.vocab_size:
            uni[t] = n / total
    spec = LMSpec(mode="backoff", ctx_lens=tuple(ctx_lens), order=lm.order,
                  log_alpha=float(np.log(lm.alpha)), bonus=0.0, base=base)
    floor = np.log(1.0 / (total + lm.vocab_size + 1))
    return spec, LMTables(
        levels=tuple(levels),
        uni=torch.tensor(np.log(uni).astype(np.float32), device=device),
        uni_floor=torch.tensor(np.float32(floor), device=device))


def biasing_to_device(bias, device="cpu") -> Tuple[LMSpec, LMTables]:
    """Compile a ``biasing.BiasingLM`` (phrase-prefix trie) into tables on
    ``device``: level c holds (length-c proper prefix -> continuation)."""
    base = _check_base(bias.vocab_size, max((len(p) for p in bias.cont), default=0))
    by_len: dict = {}
    for pfx, nexts in bias.cont.items():
        by_len.setdefault(len(pfx), []).extend((pfx, t, bias.bonus) for t in sorted(nexts))
    levels, ctx_lens = [], []
    for c in sorted(by_len):
        levels.append(_build_level(by_len[c], base, device))
        ctx_lens.append(c)
    spec = LMSpec(mode="bonus", ctx_lens=tuple(ctx_lens),
                  order=(max(ctx_lens) + 1 if ctx_lens else 1),
                  log_alpha=0.0, bonus=float(bias.bonus), base=base)
    return spec, LMTables(levels=tuple(levels),
                          uni=torch.zeros((1,), dtype=torch.float32, device=device),
                          uni_floor=torch.tensor(np.float32(0.0), device=device))


def to_device(lm_fn, device="cpu") -> Optional[Tuple[LMSpec, LMTables]]:
    """Compile a supported host lm_fn (NGramLM / BiasingLM) for the device
    beam; None for any other callable (the host beam is its surface)."""
    from trt_asr_tpu_torch.decode.biasing import BiasingLM
    from trt_asr_tpu_torch.decode.ngram_lm import NGramLM

    if isinstance(lm_fn, NGramLM):
        return ngram_to_device(lm_fn, device)
    if isinstance(lm_fn, BiasingLM):
        return biasing_to_device(lm_fn, device)
    return None


def _lookup(level: LMLevel, qh, ql, qt):
    """Vectorized lexicographic binary search: for each query lane the
    lower-bound position of (qh, ql, qt), then an exact-match check.
    Returns (found [Q] bool, val [Q] f32)."""
    n = level.tok.shape[0]
    steps = int(math.ceil(math.log2(max(n, 2)))) + 1
    lo = torch.zeros_like(qh, dtype=torch.long)
    hi = torch.full_like(qh, n, dtype=torch.long)
    for _ in range(steps):
        mid = (lo + hi) // 2
        m = mid.clamp(max=n - 1)       # lo == hi == n: the row is done, any index reads
        mh, ml, mt = level.ctx_hi[m], level.ctx_lo[m], level.tok[m]
        lt = (mh < qh) | ((mh == qh) & ((ml < ql) | ((ml == ql) & (mt < qt))))
        lo, hi = torch.where(lt, mid + 1, lo), torch.where(lt, hi, mid)
    pos = lo.clamp(max=n - 1)
    found = ((lo < n) & (level.ctx_hi[pos] == qh) & (level.ctx_lo[pos] == ql)
             & (level.tok[pos] == qt))
    return found, level.val[pos]


def lm_scores(spec: LMSpec, tables: LMTables, tok_buf: torch.Tensor,
              n_tok: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """Score candidate continuations for a hypothesis set.

    tok_buf [K, L] (-1 padded), n_tok [K], cands [K, k] raw token ids ->
    [K, k] f32, equal (f32) to the host ``lm_fn(prefix_tokens, cand)``. A
    short prefix pads its context with BOS as ``NGramLM.score`` does; for
    the biasing trie a BOS-padded context never equals a stored prefix of
    real tokens, which is the host's "suffix no longer than the prefix"."""
    K, L = tok_buf.shape
    k = cands.shape[1]
    cands = cands.to(torch.int32)
    qt = cands.reshape(-1)                                      # [K*k]
    if spec.mode == "backoff":
        v_lm = tables.uni.shape[0]
        out = torch.where(cands < v_lm, tables.uni[cands.long().clamp(0, v_lm - 1)],
                          tables.uni_floor) + spec.log_alpha * (spec.order - 1)
    else:
        out = torch.zeros((K, k), dtype=torch.float32, device=tok_buf.device)
    n_tok = n_tok.long()
    for level, c in zip(tables.levels, spec.ctx_lens):
        # the last c context values, BOS (-1) before the prefix start
        idx = n_tok[:, None] - c + torch.arange(c, device=tok_buf.device)[None, :]   # [K, c]
        vals = (torch.where(idx >= 0, torch.gather(tok_buf, 1, idx.clamp(0, L - 1)),
                            torch.full_like(tok_buf[:, :1], -1)) + 1).to(torch.int32)
        n_hi, _ = _split(c)
        hi = torch.zeros((K,), dtype=torch.int32, device=tok_buf.device)
        lo = torch.zeros((K,), dtype=torch.int32, device=tok_buf.device)
        for j in range(n_hi):
            hi = hi * spec.base + vals[:, j]
        for j in range(n_hi, c):
            lo = lo * spec.base + vals[:, j]
        found, v = _lookup(level, hi.repeat_interleave(k), lo.repeat_interleave(k), qt)
        found, v = found.reshape(K, k), v.reshape(K, k)
        if spec.mode == "backoff":
            # the deeper context wins (levels ascend, later writes overwrite)
            out = torch.where(found, v + spec.log_alpha * (spec.order - 1 - c), out)
        else:
            out = torch.where(found & (out == 0.0), v, out)
    return out
