"""Host reference TDT greedy decode over joint and predictor callables.

The JAX package's ``decode/host_decode.py``, the same decisions step for
step:

- dual argmax over the token head [0, V+1) and the duration head's bins;
- advance = duration_values[argmax(dur)]; a blank with duration 0 advances
  1 (the contract's ``blank_duration_zero_policy``);
- a non-blank emits and steps the predictor (the predictor runs only on
  emission; its output g is reused across blank steps);
- at most ``max_symbols`` inner steps a frame, then a forced advance of 1;
- optional blank penalty and leading-punctuation suppression.

It drives any backend through ``joint_fn`` and ``predictor_fn`` (the port's
modules on either device, an oracle), and appends per-step records in the
golden trace's JSONL schema (``artifacts/goldens/tdt_trace.jsonl``) to
``trace`` when given: the first-divergence check of ``debug/tdt_trace.py``
compares two such traces.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def tdt_greedy_decode_host(
    enc: np.ndarray,                   # [T_enc, D] valid encoder steps
    joint_fn: Callable,                # (enc_t [D], g [P]) -> logits [V_joint]
    predictor_fn: Callable,            # (token_id, state) -> (g [P], state)
    state,                             # opaque predictor state
    g: np.ndarray,                     # current predictor output [P]
    y_id: int,
    *,
    blank_id: int,
    token_head_size: int,
    duration_values: Sequence[int],
    max_symbols: int = 8,
    blank_penalty: float = 0.0,
    punct_token_ids: Optional[set] = None,
    emitted_so_far: int = 0,
    trace: Optional[List[Dict]] = None,
    time_offset: int = 0,
    trace_topk: int = 0,        # per-step top-k token logits + logsumexp in
                                # the trace (PARAKEET_DEBUG_JOINT_TOPK)
    stamps_out: Optional[List[Tuple[int, int, float]]] = None,
                                # per emitted token, append (emission frame
                                # incl. time_offset, predicted TDT duration,
                                # log-softmax confidence of the token):
                                # the decoders' with_timestamps output
) -> Tuple[List[int], object, np.ndarray, int]:
    """Decode one chunk. Returns (emitted tokens, state, g, y_id)."""
    t_enc = enc.shape[0]
    emitted: List[int] = []
    time_idx = 0
    n_total = emitted_so_far
    while time_idx < t_enc:
        advanced = False
        for u in range(max_symbols):
            logits = np.asarray(joint_fn(enc[time_idx], g), dtype=np.float32)
            tok_logits = logits[:token_head_size].copy()
            dur_logits = logits[token_head_size : token_head_size + len(duration_values)]
            if blank_penalty:
                tok_logits[blank_id] -= blank_penalty
            best_tok = int(np.argmax(tok_logits))
            if (punct_token_ids and n_total == 0 and best_tok != blank_id
                    and best_tok in punct_token_ids):
                best_tok = blank_id  # leading-punctuation suppression
            best_dur_idx = int(np.argmax(dur_logits))
            duration = int(duration_values[best_dur_idx])
            advance = duration
            clamped = False
            if best_tok == blank_id and duration == 0:
                advance = 1
                clamped = True
            if trace is not None:
                rec = {
                    "type": "step", "time_idx": time_offset + time_idx, "u": u,
                    "y_id": int(y_id), "best_tok": best_tok,
                    "is_blank": bool(best_tok == blank_id),
                    "best_dur_idx": best_dur_idx, "duration": duration,
                    "advance": advance, "blank_dur0_clamped": clamped,
                }
                if trace_topk:
                    idx = np.argsort(tok_logits)[::-1][:trace_topk]
                    m = float(tok_logits.max())
                    rec["topk"] = [[int(i), float(tok_logits[i])] for i in idx]
                    rec["logsumexp"] = m + float(
                        np.log(np.sum(np.exp(tok_logits - m))))
                trace.append(rec)
            if best_tok != blank_id:
                emitted.append(best_tok)
                if stamps_out is not None:
                    m = float(tok_logits.max())
                    lse = m + float(np.log(np.sum(np.exp(tok_logits - m))))
                    stamps_out.append((time_offset + time_idx, duration,
                                       float(tok_logits[best_tok]) - lse))
                n_total += 1
                g, state = predictor_fn(best_tok, state)
                y_id = best_tok
            if advance == 0:
                continue
            time_idx += advance
            advanced = True
            break
        if not advanced:
            time_idx += 1
    return emitted, state, g, y_id
