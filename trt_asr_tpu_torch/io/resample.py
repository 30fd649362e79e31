"""Sample-rate conversion on the host (numpy), as the JAX package's
``io/resample.py``: a windowed-sinc interpolator (Hann window, 16 zero
crossings, cutoff at 95% of the narrower Nyquist, each output's weights
normalized for an exact DC gain) for any ratio; ``load_audio`` reads a WAV
at its own rate and converts it to the model's 16 kHz. Audio input is not
the hot path, so it stays off the device."""

from __future__ import annotations

import wave

import numpy as np

from trt_asr_tpu_torch.io.wav import load_wav

_ZEROS = 16          # sinc zero crossings kept per side
_BLOCK = 1 << 16     # output samples per vectorized block


def resample(x: np.ndarray, sr_in: int, sr_out: int = 16000) -> np.ndarray:
    """x [N] f32 at sr_in -> [round(N*sr_out/sr_in)] f32 at sr_out."""
    x = np.asarray(x, np.float32)
    if sr_in == sr_out or x.size == 0:
        return x
    ratio = sr_out / sr_in
    cutoff = min(1.0, ratio) * 0.95          # of the input Nyquist
    hw = int(np.ceil(_ZEROS / cutoff))       # kernel half-width, input samples
    n_out = int(round(x.size * ratio))
    xpad = np.pad(x, (hw, hw + 1))
    offs = np.arange(-hw + 1, hw + 1)        # [K] taps around floor(t)
    y = np.empty(n_out, np.float32)
    for b0 in range(0, n_out, _BLOCK):
        b1 = min(b0 + _BLOCK, n_out)
        t = np.arange(b0, b1) * (sr_in / sr_out)     # input time of each output
        base = np.floor(t).astype(np.int64)
        frac = t[:, None] - (base[:, None] + offs[None, :])   # [B, K]
        w = cutoff * np.sinc(cutoff * frac)
        w *= 0.5 * (1.0 + np.cos(np.pi * np.clip(frac / hw, -1.0, 1.0)))
        w /= np.sum(w, axis=1, keepdims=True)        # exact DC gain
        y[b0:b1] = np.sum(xpad[base[:, None] + offs[None, :] + hw] * w, axis=1)
    return y


def load_audio(path: str, target_rate: int = 16000) -> np.ndarray:
    """``load_wav`` at the file's own rate, resampled to ``target_rate``
    (the CLI's input; strict callers keep ``load_wav``, which rejects any
    rate but 16 kHz)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
    return resample(load_wav(path, expect_rate=rate), rate, target_rate)
