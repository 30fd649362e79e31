"""LSTM prediction network: one decode step (U=1). blank_as_pad: the blank
id embeds to the zero vector."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from trt_asr_tpu_torch.ops.lstm import lstm_step


def predictor_step(params: Dict[str, Any], y: torch.Tensor, h: torch.Tensor,
                   c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y [B] int -> (g [B, P], h', c') with h, c [layers, B, P]."""
    x = params["embed"][y.long()]
    return lstm_step(params["lstm"], x, h, c)
