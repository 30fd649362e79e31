"""TDT greedy decode state and prompt priming."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from trt_asr_tpu_torch.config import ModelConfig
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
