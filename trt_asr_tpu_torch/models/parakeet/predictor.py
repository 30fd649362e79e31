"""LSTM prediction network: one decode step (U=1) and, for training, a
label sequence. blank_as_pad: the blank id embeds to the zero vector (a
zero row of the table, indexed like any other id)."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from trt_asr_tpu_torch.ops.lstm import lstm_sequence, lstm_step


def embed_tokens(params: Dict[str, Any], y: torch.Tensor) -> torch.Tensor:
    return params["embed"][y.long()]


def predictor_step(params: Dict[str, Any], y: torch.Tensor, h: torch.Tensor,
                   c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y [B] int -> (g [B, P], h', c') with h, c [layers, B, P]."""
    return lstm_step(params["lstm"], embed_tokens(params, y), h, c)


def predictor_sequence(params: Dict[str, Any], y: torch.Tensor, h: torch.Tensor,
                       c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """y [B, U] int -> (g [B, U, P], h', c')."""
    return lstm_sequence(params["lstm"], embed_tokens(params, y), h, c)


def init_predictor_state(cfg, batch: int, device="cpu", dtype=torch.float32):
    """Zero (h, c), each [layers, B, P]."""
    z = torch.zeros((cfg.pred_rnn_layers, batch, cfg.pred_hidden), dtype=dtype, device=device)
    return z, z.clone()
