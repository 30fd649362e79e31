"""TDT greedy decode: state, prompt priming, and the single-stream chunk
decode ``tdt_greedy_decode_chunk``."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.decode.greedy_loop import greedy_decode_loop
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step


class DecodeState(NamedTuple):
    """Per-stream decode carry (persists across chunks within an utterance):
    predictor output/state, last emitted token, and ``time_carry`` — a
    duration jump past the chunk end, carried into the next chunk so
    chunked decoding equals whole-utterance decoding."""

    g: torch.Tensor           # [B, P] cached predictor output
    h: torch.Tensor           # [R, B, P]
    c: torch.Tensor           # [R, B, P]
    y_id: torch.Tensor        # [B] int32
    time_carry: torch.Tensor  # [B] int32


def init_decode_state(cfg: ModelConfig, batch: int = 1, device="cpu",
                      dtype=torch.float32) -> DecodeState:
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
    return DecodeState(
        g=z(batch, cfg.pred_hidden),
        h=z(cfg.pred_rnn_layers, batch, cfg.pred_hidden),
        c=z(cfg.pred_rnn_layers, batch, cfg.pred_hidden),
        y_id=torch.full((batch,), cfg.blank_id, dtype=torch.int32, device=device),
        time_carry=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def prime_decode_state(params: Dict[str, Any], cfg: ModelConfig, state: DecodeState,
                       prompt_ids) -> DecodeState:
    """Seed the predictor with prompt tokens before any audio; without a
    prompt, prime with blank (zero embedding)."""
    g, h, c, y = state.g, state.h, state.c, state.y_id
    for tok in prompt_ids:
        y = torch.full_like(state.y_id, tok)
        g, h, c = predictor_step(params["predictor"], y, h, c)
    if not prompt_ids:
        g, h, c = predictor_step(params["predictor"], y, h, c)
    return DecodeState(g=g, h=h, c=c, y_id=y, time_carry=state.time_carry)


def tdt_greedy_decode_chunk(
    params: Dict[str, Any],
    cfg: ModelConfig,
    enc: torch.Tensor,              # [T, D] encoder output (single stream)
    t_enc,                          # valid steps (int or 0-d tensor)
    state: DecodeState,             # batch 1
    *,
    max_tokens: int,
    max_symbols: Optional[int] = None,
    blank_penalty: float = 0.0,
    emitted_so_far=0,               # tokens emitted before this chunk
    punct_mask=None,                # [ths] bool: suppressed as the first token
    use_punct_mask: bool = False,
    use_pallas_joint: bool = False,
    with_timestamps: bool = False,
    joint_packed=None,              # the int8 or f32 joint weights packed once (pack_joint_step)
    trace: bool = False,
):
    """Decode one chunk of one stream, as the JAX package's
    ``decode/tdt_greedy.py`` ``tdt_greedy_decode_chunk``: blank-run batching
    over every step of the chunk (the argmaxes of all steps under the
    current predictor output, recomputed after each emission), with the
    fused joint-step kernel for those recomputes when ``use_pallas_joint``,
    at any chunk length. Returns (tokens [max_tokens] (-1 padded), n (0-d),
    new_state) and, with ``with_timestamps``, ``(frames, durs, logps)``
    [max_tokens]; tokens, counts and stamps are host tensors.

    ``trace=True`` (``RuntimeConfig.debug_tdt_steps``) also returns the
    per-step record buffer ``(records [T*max_symbols, 7] int32, n_steps)``,
    columns (time_idx, u, y_id, best_tok, duration, advance, is_blank) as
    ``debug/tdt_trace.py`` reads them: host rows of the loop's own control
    state, no extra sync."""
    out = greedy_decode_loop(
        params, cfg, enc[None], torch.as_tensor(t_enc).reshape(1), state,
        max_tokens=max_tokens, max_symbols=max_symbols, blank_penalty=blank_penalty,
        emitted_so_far=[int(emitted_so_far)], punct_mask=punct_mask,
        use_punct_mask=use_punct_mask, with_timestamps=with_timestamps,
        blank_run=True, use_kernel=use_pallas_joint, joint_packed=joint_packed,
        trace=trace)
    ret = (out[0][0], out[1][0], out[2])
    if with_timestamps:
        ret = ret + (tuple(x[0] for x in out[3]),)
    if trace:
        ret = ret + (out[-1],)
    return ret
