"""The parts of the deployment contract that the streaming path reads: the
frontend numerics (same fields and defaults as the JAX package's
``contract.FrontendSpec``)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class NormalizeSpec:
    mode: str = "per_feature"
    scope: str = "utterance_time"
    stats: str = "mean_std"
    std_denominator: str = "frames_minus_1"
    std_epsilon: float = 1e-5
    requires_full_utterance: bool = True
    streaming_safe: bool = False


@dataclass(frozen=True)
class FrontendSpec:
    sample_rate_hz: int = 16000
    n_fft: int = 512
    n_mels: int = 128
    hop_length: int = 160
    win_length: int = 400
    window: str = "hann_symmetric"
    preemphasis: float = 0.0
    mel_scale: str = "htk"
    mel_fmin_hz: float = 0.0
    mel_fmax_hz: float = 8000.0
    log_floor: float = 1e-5
    normalize: NormalizeSpec = field(default_factory=NormalizeSpec)
