"""Per-feature (per-mel-bin) utterance normalization: mean over frames; std
with an N-1 denominator (N=1 -> 1) plus 1e-5 added to the std."""

from __future__ import annotations

from typing import Tuple

import torch


def compute_per_feature_stats(features_tc, eps: float = 1e-5
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """features [T, C] (or [B, T, C]) -> (mean [C], std [C]) over time."""
    x = torch.as_tensor(features_tc, dtype=torch.float32)
    frames = x.shape[-2]
    mean = x.mean(dim=-2)
    denom = float(frames - 1) if frames > 1 else 1.0
    var = ((x - mean[..., None, :]) ** 2).sum(dim=-2) / denom
    return mean, torch.sqrt(var) + eps


def apply_per_feature_norm(features_tc, mean, std) -> torch.Tensor:
    x = torch.as_tensor(features_tc, dtype=torch.float32)
    mean = torch.as_tensor(mean, device=x.device)
    std = torch.as_tensor(std, device=x.device)
    return (x - mean[..., None, :]) / std[..., None, :]
