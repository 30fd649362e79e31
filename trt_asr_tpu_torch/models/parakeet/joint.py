"""RNNT-TDT joint network: raw logits [..., V] = token head (vocab + blank)
++ duration bins."""

from __future__ import annotations

from typing import Any, Dict

import torch

from trt_asr_tpu_torch.ops.common import matmul


def _proj(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    out = matmul(x, p["w"])
    if p.get("b") is not None:
        out = out + p["b"].to(out.dtype)
    return out


def joint_project_enc(params: Dict[str, Any], enc: torch.Tensor) -> torch.Tensor:
    """Encoder projection of a whole chunk [B, T, D] -> [B, T, J]."""
    return _proj(params["enc"], enc)


def joint_from_projected(params: Dict[str, Any], enc_proj_t: torch.Tensor,
                         g_u: torch.Tensor) -> torch.Tensor:
    h = torch.relu(enc_proj_t + _proj(params["pred"], g_u))
    return _proj(params["out"], h)
