"""RNNT-TDT joint network: raw logits [..., V] = token head (vocab + blank)
++ duration bins; the decode's single steps and training's full lattice."""

from __future__ import annotations

from typing import Any, Dict

import torch

from trt_asr_tpu_torch.ops.common import matmul, relu


def _proj(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    out = matmul(x, p["w"])
    if p.get("b") is not None:
        out = out + p["b"].to(out.dtype)
    return out


def joint_apply(params: Dict[str, Any], enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """enc [B, T, D], pred [B, U, P] -> logits [B, T, U, V]: every (t, u)
    pair of the training lattice."""
    e = _proj(params["enc"], enc)[:, :, None, :]      # [B, T, 1, J]
    g = _proj(params["pred"], pred)[:, None, :, :]    # [B, 1, U, J]
    return _proj(params["out"], relu(e + g))


def joint_single_step(params: Dict[str, Any], enc_t: torch.Tensor,
                      g_u: torch.Tensor) -> torch.Tensor:
    """enc_t [B, D], g_u [B, P] -> logits [B, V]: one joint step, the beam's."""
    h = torch.relu(_proj(params["enc"], enc_t) + _proj(params["pred"], g_u))
    return _proj(params["out"], h)


def joint_project_enc(params: Dict[str, Any], enc: torch.Tensor) -> torch.Tensor:
    """Encoder projection of a whole chunk [B, T, D] -> [B, T, J]."""
    return _proj(params["enc"], enc)


def joint_from_projected(params: Dict[str, Any], enc_proj_t: torch.Tensor,
                         g_u: torch.Tensor) -> torch.Tensor:
    h = torch.relu(enc_proj_t + _proj(params["pred"], g_u))
    return _proj(params["out"], h)
