"""Typed configuration: architecture (:class:`ModelConfig`) and the runtime
toggles the streaming greedy path reads (:class:`RuntimeConfig`).

Same field names, defaults and env-var names (``TRT_ASR_*``, with the
``PARAKEET_*`` aliases) as the JAX package's ``config.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for the Parakeet-TDT family."""

    # frontend / encoder input
    feat_in: int = 128
    # encoder
    num_layers: int = 24
    d_model: int = 1024
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 9
    subsampling_factor: int = 8
    subsampling_conv_channels: int = 256
    pos_emb_max_len: int = 5000
    use_bias: bool = False
    xscaling: bool = False
    # predictor
    pred_hidden: int = 640
    pred_rnn_layers: int = 2
    # vocab / joint
    vocab_size: int = 8192
    joint_hidden: int = 640
    duration_values: Tuple[int, ...] = (0, 1, 2, 3, 4)
    # streaming
    att_cache_size: int = 256
    cache_drop_size: int = 3
    valid_out_len: int = 3
    drop_extra_pre_encoded: int = 2
    chunk_size_frames: Tuple[int, int] = (41, 48)
    shift_size_frames: Tuple[int, int] = (17, 24)
    pre_encode_cache_size: Tuple[int, int] = (0, 9)
    # True: apply drop_extra_pre_encoded on chunk 0 too (the real export's
    # behavior); False: chunk 0 drops nothing and valid outputs tile the
    # stream. See streaming/schedule.py.
    nemo_compat_chunk0: bool = False
    # decode
    max_symbols_per_timestep: int = 8

    @property
    def blank_id(self) -> int:
        return self.vocab_size

    @property
    def token_head_size(self) -> int:
        return self.vocab_size + 1

    @property
    def num_duration_bins(self) -> int:
        return len(self.duration_values)

    @property
    def joint_vocab_size(self) -> int:
        return self.token_head_size + self.num_duration_bins

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def conv_context_size(self) -> int:
        return (self.conv_kernel_size - 1) // 2

    @property
    def stride_stages(self) -> int:
        f, n = self.subsampling_factor, 0
        while f > 1:
            assert f % 2 == 0, "subsampling factor must be a power of 2"
            f //= 2
            n += 1
        return n

    @classmethod
    def tiny(cls, **overrides) -> "ModelConfig":
        """A fast test-sized config preserving all structural invariants."""
        base = dict(
            feat_in=32, num_layers=2, d_model=64, n_heads=4,
            ff_expansion_factor=2, conv_kernel_size=9, subsampling_factor=8,
            subsampling_conv_channels=16, pos_emb_max_len=512,
            pred_hidden=32, pred_rnn_layers=2, vocab_size=64, joint_hidden=32,
            att_cache_size=32, max_symbols_per_timestep=4,
        )
        base.update(overrides)
        return cls(**base)


def _env(name: str, alias=None) -> Optional[str]:
    """alias may be a single PARAKEET_* name or a tuple of them."""
    v = os.environ.get(name)
    if v is None and alias:
        for a in (alias,) if isinstance(alias, str) else alias:
            v = os.environ.get(a)
            if v is not None:
                break
    return v


def _env_bool(name: str, alias, default: bool) -> bool:
    v = _env(name, alias)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, alias, default: int) -> int:
    v = _env(name, alias)
    return default if v is None else int(v)


def _env_float(name: str, alias, default: float) -> float:
    v = _env(name, alias)
    return default if v is None else float(v)


def _env_str(name: str, alias, default: str) -> str:
    v = _env(name, alias)
    return default if v is None else v


@dataclass
class RuntimeConfig:
    """Runtime toggles read by the streaming greedy path (env-overridable).

    ``use_pallas_att`` / ``use_pallas_joint`` keep the JAX package's names;
    in this package they select the hand-written CUDA kernels of
    ``ops/kernels/`` (fused attention block, fused joint step)."""

    # numerics / kernels
    use_pallas_joint: bool = False           # fused joint-step kernel
    use_pallas_att: bool = False             # fused attention-block kernel
                                             # (B=1 steady streaming chunks)
    quant: str = "none"                      # int8 weight-only quantization
                                             # scope: none|joint|encoder|all
    batched_decode: bool = True              # blank-run batched decode
    # decode behavior
    blank_penalty: float = 0.0               # PARAKEET_BLANK_PENALTY
    suppress_leading_punct: bool = True      # PARAKEET_ALLOW_LEADING_PUNCT inverts
    language: str = "en"                     # language prompt token <|xx|>
    extra_prompt: str = ""                   # comma-separated extra prompt tokens
    y0_override: int = -1                    # PARAKEET_Y0_OVERRIDE
    joint_dur_first: bool = False            # export head order [durations, tokens]
    # events
    partial_min_interval_ms: int = 100
    final_on_push: bool = False              # emit FinalText after every push
    # fault injection (reference PARAKEET_DISABLE_CACHE / _CACHE_LEN_OVERRIDE)
    disable_cache: bool = False
    cache_len_override: int = -1

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        d = cls()
        return cls(
            use_pallas_joint=_env_bool("TRT_ASR_PALLAS_JOINT", None, d.use_pallas_joint),
            use_pallas_att=_env_bool("TRT_ASR_PALLAS_ATT", None, d.use_pallas_att),
            quant=_env_str("TRT_ASR_QUANT", None, d.quant),
            batched_decode=_env_bool("TRT_ASR_BATCHED_DECODE", None, d.batched_decode),
            blank_penalty=_env_float("TRT_ASR_BLANK_PENALTY", "PARAKEET_BLANK_PENALTY", d.blank_penalty),
            suppress_leading_punct=not _env_bool(
                "TRT_ASR_ALLOW_LEADING_PUNCT",
                ("PARAKEET_ALLOW_LEADING_PUNCT",
                 "PARAKEET_DISABLE_PUNCT_SUPPRESSION"),
                not d.suppress_leading_punct),
            language=_env_str("TRT_ASR_LANG", None, d.language),
            extra_prompt=_env_str("TRT_ASR_EXTRA_PROMPT", None, d.extra_prompt),
            y0_override=_env_int("TRT_ASR_Y0_OVERRIDE", "PARAKEET_Y0_OVERRIDE", d.y0_override),
            joint_dur_first=_env_bool("TRT_ASR_JOINT_DUR_FIRST", "PARAKEET_JOINT_DUR_FIRST", d.joint_dur_first),
            partial_min_interval_ms=_env_int("TRT_ASR_PARTIAL_MIN_INTERVAL_MS", "PARAKEET_PARTIAL_MIN_INTERVAL_MS", d.partial_min_interval_ms),
            final_on_push=_env_bool("TRT_ASR_FINAL_ON_PUSH",
                                    "PARAKEET_EMIT_FINAL_EACH_CHUNK",
                                    d.final_on_push),
            disable_cache=_env_bool("TRT_ASR_DISABLE_CACHE", "PARAKEET_DISABLE_CACHE", d.disable_cache),
            cache_len_override=_env_int("TRT_ASR_CACHE_LEN_OVERRIDE", "PARAKEET_CACHE_LEN_OVERRIDE", d.cache_len_override),
        )
