"""Typed configuration: architecture (:class:`ModelConfig`, normally
derived from the contract, ``ModelConfig.from_contract``) and the runtime
and debug toggles (:class:`RuntimeConfig`).

Same field names, defaults and env-var names (``TRT_ASR_*``, with the
``PARAKEET_*`` aliases) as the JAX package's ``config.py``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterator, Optional, Tuple

if TYPE_CHECKING:
    from trt_asr_tpu_torch.contract import Contract


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
    def from_contract(cls, c: "Contract") -> "ModelConfig":
        """The architecture a contract (``contract.load_contract``) fixes."""
        return cls(
            feat_in=c.encoder.feat_in,
            num_layers=c.encoder.num_layers,
            d_model=c.encoder.d_model,
            n_heads=c.encoder.n_heads,
            ff_expansion_factor=c.encoder.ff_expansion_factor,
            conv_kernel_size=c.encoder.conv_kernel_size,
            subsampling_factor=c.encoder.subsampling.factor,
            subsampling_conv_channels=c.encoder.subsampling.conv_channels,
            pos_emb_max_len=c.encoder.pos_emb_max_len,
            use_bias=c.encoder.use_bias,
            xscaling=c.encoder.xscaling,
            pred_hidden=c.predictor.pred_hidden,
            pred_rnn_layers=c.predictor.pred_rnn_layers,
            vocab_size=c.tokenizer.vocab_size,
            joint_hidden=c.joint.joint_hidden,
            duration_values=tuple(c.joint.duration_values),
            att_cache_size=c.streaming.cache_last_channel_size,
            cache_drop_size=c.streaming.cache_drop_size,
            valid_out_len=c.streaming.valid_out_len,
            drop_extra_pre_encoded=c.streaming.drop_extra_pre_encoded,
            chunk_size_frames=tuple(c.streaming.chunk_size_frames),
            shift_size_frames=tuple(c.streaming.shift_size_frames),
            pre_encode_cache_size=tuple(c.streaming.pre_encode_cache_size),
            max_symbols_per_timestep=c.decode.max_symbols_per_timestep,
        )

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


@contextlib.contextmanager
def env_overrides(values: Dict[str, str]) -> Iterator[None]:
    """``values`` in ``os.environ`` for a block, each variable restored
    (or removed) after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    """Runtime and debug toggles (env-overridable).

    The ``use_pallas_*`` flags keep the JAX package's names; in this package
    they select the hand-written CUDA kernels of ``ops/kernels/``: the fused
    joint step, the fused attention block, the fused conv module (with
    int8 encoder weights and ``use_pallas_ffn`` also on: conv + FFN2 +
    output LayerNorm in one kernel) and the fused FFN. The weights' type is
    chosen where a model is made (``ParakeetTDT(weights_dtype=)``);
    ``compute_dtype`` and ``decode_dtype`` keep JAX's names and defaults and,
    as in JAX, only the engine set's manifest reads them
    (``runtime/engine.py``: recorded at build, compared at load)."""

    # numerics / kernels
    compute_dtype: str = "bfloat16"          # TRT_ASR_COMPUTE_DTYPE (manifest only)
    decode_dtype: str = "float32"            # TRT_ASR_DECODE_DTYPE (manifest only)
    use_pallas_joint: bool = False           # fused joint-step kernel
    use_pallas_att: bool = False             # fused attention-block kernel
                                             # (B=1 steady streaming chunks)
    use_pallas_conv: bool = False            # fused conv-module kernel (B=1)
    use_pallas_ffn: bool = False             # fused FFN kernel
    quant: str = "none"                      # int8 weight-only quantization
                                             # scope: none|joint|encoder|all
    batched_decode: bool = True              # JAX's route switch; both routes
                                             # are one blank-run loop here
    beam_width: int = 0                      # TRT_ASR_BEAM: > 0 selects the
                                             # CLI's beam session (--beam wins)
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
    sabotage: str = ""                       # "drop_time_carry": zero the decode
                                             # time carry after every chunk (the
                                             # gate-sensitivity fault)
    # debug / instrumentation (debug/*)
    nan_guard: bool = False                  # PARAKEET_NAN_GUARD_ALWAYS
    nan_guard_halt: bool = False             # PARAKEET_NAN_GUARD_HALT
    stage_markers: bool = False              # PARAKEET_DEBUG_STAGE_MARKERS
    debug_emit_tokens: bool = False          # PARAKEET_DEBUG_EMIT_TOKENS
    debug_tdt_steps: bool = False            # PARAKEET_DEBUG_TDT_STEPS
    tdt_trace_path: str = ""                 # NDJSON output for debug_tdt_steps
    snapshot_dir: str = ""                   # PARAKEET_TDT_SNAPSHOT_DIR
    tap_dir: str = ""                        # AUDIO_TAP_DIR
    tap_enabled: bool = False                # AUDIO_TAP_ENABLE
    slow_step_ms: float = 250.0              # PARAKEET_SLOW_ENQUEUE_MS analog
    profile_dir: str = ""                    # torch.profiler Chrome trace dir
    profile_chunks: int = 20                 # chunks captured per profile run
    debug_blank_scan: bool = False           # PARAKEET_DEBUG_BLANK_SCAN
    # cold start (runtime/engine.py)
    compile_cache_dir: str = ""              # TRT_ASR_COMPILE_CACHE: the kernel
                                             # libraries' directory, so a fresh
                                             # process finds them built

    @classmethod
    def from_env(cls) -> "RuntimeConfig":
        d = cls()
        return cls(
            compute_dtype=_env_str("TRT_ASR_COMPUTE_DTYPE", None, d.compute_dtype),
            decode_dtype=_env_str("TRT_ASR_DECODE_DTYPE", None, d.decode_dtype),
            use_pallas_joint=_env_bool("TRT_ASR_PALLAS_JOINT", None, d.use_pallas_joint),
            use_pallas_att=_env_bool("TRT_ASR_PALLAS_ATT", None, d.use_pallas_att),
            use_pallas_conv=_env_bool("TRT_ASR_PALLAS_CONV", None, d.use_pallas_conv),
            use_pallas_ffn=_env_bool("TRT_ASR_PALLAS_FFN", None, d.use_pallas_ffn),
            quant=_env_str("TRT_ASR_QUANT", None, d.quant),
            batched_decode=_env_bool("TRT_ASR_BATCHED_DECODE", None, d.batched_decode),
            beam_width=_env_int("TRT_ASR_BEAM", None, d.beam_width),
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
            sabotage=_env_str("TRT_ASR_SABOTAGE", None, d.sabotage),
            nan_guard=_env_bool("TRT_ASR_NAN_GUARD", "PARAKEET_NAN_GUARD_ALWAYS", d.nan_guard),
            nan_guard_halt=_env_bool("TRT_ASR_NAN_GUARD_HALT", "PARAKEET_NAN_GUARD_HALT", d.nan_guard_halt),
            stage_markers=_env_bool("TRT_ASR_STAGE_MARKERS", "PARAKEET_DEBUG_STAGE_MARKERS", d.stage_markers),
            debug_emit_tokens=_env_bool("TRT_ASR_DEBUG_EMIT_TOKENS", "PARAKEET_DEBUG_EMIT_TOKENS", d.debug_emit_tokens),
            debug_tdt_steps=_env_bool("TRT_ASR_DEBUG_TDT_STEPS", "PARAKEET_DEBUG_TDT_STEPS", d.debug_tdt_steps),
            tdt_trace_path=_env_str("TRT_ASR_TDT_TRACE_PATH", None, d.tdt_trace_path),
            snapshot_dir=_env_str("TRT_ASR_SNAPSHOT_DIR", "PARAKEET_TDT_SNAPSHOT_DIR", d.snapshot_dir),
            tap_dir=_env_str("TRT_ASR_TAP_DIR", "AUDIO_TAP_DIR", d.tap_dir),
            tap_enabled=_env_bool("TRT_ASR_TAP_ENABLE", "AUDIO_TAP_ENABLE", d.tap_enabled),
            slow_step_ms=_env_float("TRT_ASR_SLOW_STEP_MS",
                                    ("PARAKEET_SLOW_ENQUEUE_MS",
                                     "PARAKEET_SLOW_CHUNK_MS"), d.slow_step_ms),
            profile_dir=_env_str("TRT_ASR_PROFILE_DIR", None, d.profile_dir),
            profile_chunks=_env_int("TRT_ASR_PROFILE_CHUNKS", None, d.profile_chunks),
            debug_blank_scan=_env_bool("TRT_ASR_DEBUG_BLANK_SCAN", "PARAKEET_DEBUG_BLANK_SCAN", d.debug_blank_scan),
            compile_cache_dir=_env_str("TRT_ASR_COMPILE_CACHE", None, d.compile_cache_dir),
        )
