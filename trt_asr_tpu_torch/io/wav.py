"""WAV loading and saving (dependency-free), as the JAX package's
``io/wav.py``: 16 kHz mono; 8/16/24/32-bit PCM scaled to [-1, 1] f32,
channels averaged; raw f32le PCM passed through."""

from __future__ import annotations

import wave

import numpy as np


def load_wav(path: str, expect_rate: int = 16000) -> np.ndarray:
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if rate != expect_rate:
        raise ValueError(f"{path}: sample rate {rate} != {expect_rate}")
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x


def save_wav(path: str, audio: np.ndarray, rate: int = 16000) -> None:
    """16-bit mono PCM, clipped to [-1, 1]."""
    x = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def load_raw_pcm_f32(path: str) -> np.ndarray:
    """Headerless little-endian f32 samples (the CLI's ``--raw-pcm``)."""
    return np.fromfile(path, dtype="<f4")
