"""Token-and-Duration Transducer (TDT) loss: the forward algorithm over the
duration lattice, in log space and f32, as the JAX package's
``train/tdt_loss.py`` computes it.

The joint factorizes into P_tok(v|t,u) and P_dur(d|t,u); from lattice node
(t, u), t < t_len:

- emit label y_{u+1} with duration d in D        -> (t+d, u+1)
- emit blank with duration d in D, d > 0         -> (t+d, u)

A path ends once it has emitted all U labels and its time index reaches
(t == t_len) or jumps past (t > t_len) the end. Nothing is emitted at
t == t_len.

Structure: a Python loop over t (JAX's ``lax.scan``) carrying a window of
the last max(D) alpha rows; within a row, the duration-0 label chain is a
loop over u. Impossible states hold the finite sentinel -1e30, never
-inf, so that ``logaddexp`` of two of them keeps a finite gradient.
Autograd differentiates the loops.
"""

from __future__ import annotations

from typing import Sequence

import torch

NEG = -1e30        # the sentinel of an impossible lattice state


def _d0_chain(row: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """row[u+1] <- logaddexp(row[u+1], row'[u] + trans[u]) in order of u, row'
    the updated row: the label emissions of duration 0 within one frame.
    row [B, U+1], trans [B, U]."""
    cols = [row[:, 0]]
    for u in range(trans.shape[1]):
        cols.append(torch.logaddexp(row[:, u + 1], cols[-1] + trans[:, u]))
    return torch.stack(cols, dim=1)


def tdt_loss(logits: torch.Tensor, labels: torch.Tensor, t_len: torch.Tensor,
             u_len: torch.Tensor, *, duration_values: Sequence[int],
             token_head_size: int, blank_id: int) -> torch.Tensor:
    """Per-example negative log-likelihood [B].

    logits [B, T, U+1, V_joint] raw joint logits (token head ++ duration
    head), labels [B, U] int, t_len [B] valid encoder steps, u_len [B]
    valid label counts."""
    b, t_max, u1, _ = logits.shape
    dev = logits.device
    durs = tuple(int(d) for d in duration_values)
    d_max = max(durs)
    labels = labels.to(device=dev, dtype=torch.long)
    t_len = t_len.to(device=dev, dtype=torch.long)
    u_len = u_len.to(device=dev, dtype=torch.long)

    lp_tok = torch.log_softmax(logits[..., :token_head_size].float(), dim=-1)
    lp_dur = torch.log_softmax(logits[..., token_head_size:].float(), dim=-1)
    lp_blank = lp_tok[..., blank_id]                                      # [B, T, U+1]
    lab = torch.cat([labels, labels.new_zeros((b, 1))], dim=1)            # pad at u=U
    lp_lab = torch.gather(lp_tok, 3, lab[:, None, :, None].expand(b, t_max, u1, 1))[..., 0]

    # label emission only for u < u_len; every emission only for t < t_len
    u_ok = torch.arange(u1, device=dev)[None, :] < u_len[:, None]         # [B, U+1]
    t_ok = torch.arange(t_max, device=dev)[None, :] < t_len[:, None]      # [B, T]
    neg = torch.full((), NEG, device=dev)
    lp_lab = torch.where(u_ok[:, None, :] & t_ok[:, :, None], lp_lab, neg)
    lp_blank = torch.where(t_ok[:, :, None], lp_blank, neg)

    d0 = 0 in durs
    d0_idx = durs.index(0) if d0 else -1

    def chain(row, t):
        if not d0 or t >= t_max:
            # past the last frame every emission is masked: the chain would
            # add only sentinel terms (JAX reads its -1e30 time padding)
            return row
        return _d0_chain(row, (lp_lab[:, t] + lp_dur[:, t, :, d0_idx])[:, :-1])

    alpha0_raw = torch.full((b, u1), NEG, device=dev)
    alpha0_raw[:, 0] = 0.0
    alpha0 = chain(alpha0_raw, 0)
    window = [torch.full((b, u1), NEG, device=dev)] * (d_max - 1) + [alpha0]
    rows, rows_raw = [alpha0], [alpha0_raw]
    pad_move = torch.full((b, 1), NEG, device=dev)
    for t in range(1, t_max + 1):
        acc = torch.full((b, u1), NEG, device=dev)
        for di, d in enumerate(durs):
            src = t - d
            if d == 0 or src < 0:
                continue
            row_src = window[d_max - d]                                  # alpha[t-d], chained
            lpd = lp_dur[:, src, :, di]
            stay = row_src + lp_blank[:, src] + lpd
            move = row_src + lp_lab[:, src] + lpd
            move = torch.cat([pad_move, move[:, :-1]], dim=1)
            acc = torch.logaddexp(acc, torch.logaddexp(stay, move))
        chained = chain(acc, t)
        window = window[1:] + [chained]
        # keep the raw (pre-chain) row too: the final row t == t_len must not
        # include within-row emissions
        rows.append(chained)
        rows_raw.append(acc)
    alpha = torch.stack(rows)                                             # [T+1, B, U+1]
    alpha_raw = torch.stack(rows_raw)

    bt = torch.arange(b, device=dev)
    final = alpha_raw[t_len, bt, u_len]                                   # exact arrival
    # overshooting terminations: from t0 = t_len - back with duration d > back
    um1 = torch.clamp_min(u_len - 1, 0)
    for di, d in enumerate(durs):
        for back in range(1, d):
            t0 = t_len - back
            t0c = torch.clamp(t0, 0, t_max - 1)
            a_blank = (alpha[t0c, bt, u_len] + lp_blank[bt, t0c, u_len]
                       + lp_dur[bt, t0c, u_len, di])
            a_lab = (alpha[t0c, bt, um1] + lp_lab[bt, t0c, um1] + lp_dur[bt, t0c, um1, di])
            a_lab = torch.where(u_len > 0, a_lab, neg)
            term = torch.logaddexp(a_blank, a_lab)
            final = torch.where(t0 >= 0, torch.logaddexp(final, term), final)
    return -final
