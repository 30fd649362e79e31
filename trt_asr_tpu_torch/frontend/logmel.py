"""Log-mel feature frontend (same numerics as the JAX package's
``frontend/logmel.py``): 16 kHz, n_fft 512, win 400 (symmetric Hann), hop
160, no padding (``while pos + win <= len``), power spectrum over 257 bins,
HTK mel filterbank with the reference's edge conventions, log(mel + 1e-5).

The DFT is two real matmuls with the Hann window folded into the basis.
``use_kernel=True`` runs window+DFT+power+mel+log as one fused CUDA kernel
(``ops/kernels/mel.py``) on CUDA devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.device import resolve_device
from trt_asr_tpu_torch.ops.kernels.mel import logmel, logmel_plain


def hann_window(size: int) -> np.ndarray:
    """Symmetric Hann window: 0.5*(1 - cos(2*pi*i/(N-1)))."""
    i = np.arange(size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / (size - 1)))).astype(np.float32)


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: float, f_min: float = 0.0,
                   f_max: Optional[float] = None) -> np.ndarray:
    """Triangular HTK-mel filterbank, [n_mels, n_fft//2+1]: rising edge on
    (left, center) exclusive, falling edge on [center, right), bin frequency
    i * sr / n_fft, no area normalization."""
    if f_max is None:
        f_max = sample_rate / 2.0
    min_mel = _hz_to_mel(np.asarray(f_min, dtype=np.float64))
    max_mel = _hz_to_mel(np.asarray(f_max, dtype=np.float64))
    mel_points = _mel_to_hz(min_mel + (max_mel - min_mel) * np.arange(n_mels + 2) / (n_mels + 1))
    n_bins = n_fft // 2 + 1
    freqs = np.arange(n_bins, dtype=np.float64) * sample_rate / n_fft
    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = mel_points[m], mel_points[m + 1], mel_points[m + 2]
        rising = (freqs > left) & (freqs < center)
        falling = (freqs >= center) & (freqs < right)
        fb[m, rising] = (freqs[rising] - left) / (center - left)
        fb[m, falling] = (right - freqs[falling]) / (right - center)
    return fb.astype(np.float32)


def _dft_basis(win_length: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis restricted to the first win_length samples ([win, bins])."""
    n_bins = n_fft // 2 + 1
    n = np.arange(win_length, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


class LogMelFrontend:
    """Stateless log-mel extractor. Call with a 1-D or [B, S] audio array;
    returns a torch tensor on the frontend's device."""

    def __init__(self, spec: Optional[FrontendSpec] = None, use_kernel: bool = False,
                 device=None):
        self.spec = spec or FrontendSpec()
        self.device = resolve_device(device)
        s = self.spec
        window = hann_window(s.win_length)
        cos_b, sin_b = _dft_basis(s.win_length, s.n_fft)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)  # noqa: E731
        self._wcos = as_t(window[:, None] * cos_b)                    # [win, bins]
        self._wsin = as_t(window[:, None] * sin_b)
        self._mel = as_t(mel_filterbank(s.n_mels, s.n_fft, s.sample_rate_hz,
                                        s.mel_fmin_hz, s.mel_fmax_hz).T)  # [bins, mels]
        self.use_kernel = use_kernel

    def num_frames(self, num_samples: int) -> int:
        s = self.spec
        if num_samples < s.win_length:
            return 0
        return (num_samples - s.win_length) // s.hop_length + 1

    def __call__(self, audio) -> torch.Tensor:
        """audio [S] or [B, S] f32 -> log-mel [T, n_mels] or [B, T, n_mels]."""
        s = self.spec
        audio = torch.as_tensor(np.asarray(audio, np.float32), device=self.device)
        n_frames = self.num_frames(audio.shape[-1])
        if n_frames == 0:
            return torch.zeros(audio.shape[:-1] + (0, s.n_mels), device=self.device)
        frames = audio.unfold(-1, s.win_length, s.hop_length)[..., :n_frames, :]
        lead = frames.shape[:-2]
        flat = frames.reshape(-1, s.win_length).contiguous()
        fn = logmel if self.use_kernel else logmel_plain
        out = fn(flat, self._wcos, self._wsin, self._mel, s.log_floor)
        return out.reshape(*lead, n_frames, s.n_mels)


class StreamingLogMel:
    """Stateful frontend: carries the frame overlap across pushes, so the
    concatenated outputs of successive pushes equal one
    :class:`LogMelFrontend` call on the concatenated audio."""

    def __init__(self, frontend: Optional[LogMelFrontend] = None):
        self.frontend = frontend or LogMelFrontend()
        self._carry = np.zeros((0,), dtype=np.float32)

    def reset(self) -> None:
        self._carry = np.zeros((0,), dtype=np.float32)

    def push(self, audio: np.ndarray) -> np.ndarray:
        s = self.frontend.spec
        buf = np.concatenate([self._carry, np.asarray(audio, dtype=np.float32)])
        n_frames = self.frontend.num_frames(buf.shape[0])
        if n_frames == 0:
            self._carry = buf
            return np.zeros((0, s.n_mels), dtype=np.float32)
        consumed = n_frames * s.hop_length
        self._carry = buf[consumed:]
        feats = self.frontend(buf[: consumed + (s.win_length - s.hop_length)])
        return feats.cpu().numpy()
