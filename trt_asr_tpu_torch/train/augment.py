"""SpecAugment (Park et al., 2019) for log-mel training batches, as the JAX
package's ``train/augment.py`` masks them, split into a draw and an apply.

The draw (:func:`draw_masks`) takes a ``torch.Generator`` (JAX's
``jax.random`` bits cannot be reproduced in torch): per row and mask a
width ~ U{0..max_width} and a start ~ floor(U[0, 1) * max(valid - width,
1)). The apply (:func:`apply_masks`) is deterministic given the widths and
starts.

- ``freq_masks`` bands of width up to ``freq_width`` over the mel axis;
- ``time_masks`` bands over the time axis; ``time_width`` < 1 is the
  adaptive mode: the widest band is that fraction of each row's own
  valid length;
- the time masks never touch padding (frames at or past ``feat_len``); the
  masked value is ``mask_value`` (0.0, the mean of per-feature-normalized
  inputs).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpecAugmentMasks(NamedTuple):
    freq_w: torch.Tensor    # [B, freq_masks] int
    freq_s: torch.Tensor    # [B, freq_masks] int
    time_w: torch.Tensor    # [B, time_masks] int
    time_s: torch.Tensor    # [B, time_masks] int


def _draw_band(gen: torch.Generator, n_masks: int, max_width: torch.Tensor,
               valid_len: torch.Tensor):
    """(widths, starts) [B, n_masks]; max_width, valid_len [B] int."""
    b = valid_len.shape[0]
    hi = torch.clamp_min(max_width, 0).to(torch.int64)[:, None] + 1
    w = (torch.rand((b, n_masks), generator=gen, device=gen.device) * hi).floor().to(torch.int64)
    w = torch.minimum(w, hi - 1)
    span = torch.clamp_min(valid_len.to(torch.int64)[:, None] - w, 1)
    s = (torch.rand((b, n_masks), generator=gen, device=gen.device) * span).to(torch.int64)
    return w, s


def draw_masks(gen: torch.Generator, feat_len: torch.Tensor, n_freq: int, *,
               freq_masks: int = 2, freq_width: int = 27, time_masks: int = 10,
               time_width: float = 0.05) -> SpecAugmentMasks:
    """Draw every band's width and start with ``gen``, on its device."""
    feat_len = feat_len.to(device=gen.device, dtype=torch.int32)
    b = feat_len.shape[0]
    fw, fs = _draw_band(gen, freq_masks, torch.full((b,), freq_width, device=gen.device),
                        torch.full((b,), n_freq, device=gen.device))
    if time_width < 1.0:
        max_w = (feat_len.float() * time_width).to(torch.int32)
    else:
        max_w = torch.full((b,), int(time_width), dtype=torch.int32, device=gen.device)
    tw, ts = _draw_band(gen, time_masks, max_w, feat_len)
    return SpecAugmentMasks(fw, fs, tw, ts)


def _band(n: int, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[B, n] bool: True inside any of the bands [s, s + w)."""
    idx = torch.arange(n, device=w.device)[None, None, :]
    return ((idx >= s[:, :, None]) & (idx < (s + w)[:, :, None])).any(dim=1)


def apply_masks(feats: torch.Tensor, feat_len: torch.Tensor, masks: SpecAugmentMasks,
                mask_value: float = 0.0) -> torch.Tensor:
    """feats [B, T, F], feat_len [B] -> the masked copy."""
    b, t, f = feats.shape
    dev = feats.device
    m = SpecAugmentMasks(*(x.to(dev) for x in masks))
    fmask = _band(f, m.freq_w, m.freq_s)                                  # [B, F]
    tmask = _band(t, m.time_w, m.time_s)                                  # [B, T]
    tmask = tmask & (torch.arange(t, device=dev)[None, :] < feat_len.to(dev)[:, None])
    value = torch.full((), mask_value, dtype=feats.dtype, device=dev)
    masked = torch.where(tmask[:, :, None], value, feats)
    return torch.where(fmask[:, None, :], value, masked)


def spec_augment(gen: torch.Generator, feats: torch.Tensor, feat_len: torch.Tensor, *,
                 freq_masks: int = 2, freq_width: int = 27, time_masks: int = 10,
                 time_width: float = 0.05, mask_value: float = 0.0) -> torch.Tensor:
    """feats [B, T, F], feat_len [B] -> a masked copy (training only); the
    masks are drawn with ``gen`` (on its device) and applied on the
    features' device."""
    masks = draw_masks(gen, feat_len, feats.shape[2], freq_masks=freq_masks,
                       freq_width=freq_width, time_masks=time_masks, time_width=time_width)
    return apply_masks(feats, feat_len, masks, mask_value)
