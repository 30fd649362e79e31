"""The deployment contract: the one JSON file (``contracts/``) that fixes
every numeric the runtime, the exporter and the parity checks agree on,
loaded into typed specs and checked for internal consistency.

Same specs, fields, defaults, checks and tolerance ladder as the JAX
package's ``contract.py``; ``DEFAULT_CONTRACT_PATH`` is found from this
package's own location (the repository's ``contracts/`` directory)."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CONTRACT_PATH = os.path.join(_REPO_ROOT, "contracts", "parakeet-tdt-0.6b-v3.json")


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


@dataclass(frozen=True)
class TimebaseSpec:
    feature_frame_shift_ms: int = 10
    encoder_subsampling_factor: int = 8
    encoder_frame_shift_ms: int = 80
    encoder_steps_per_second: float = 12.5
    duration_unit: str = "encoder_step"


@dataclass(frozen=True)
class TokenizerSpec:
    vocab_file: str = "vocab.txt"
    vocab_size: int = 8192
    blank_id: int = 8192
    token_head_size: int = 8193
    word_boundary_marker: str = "▁"
    prompt_tokens: Tuple[str, ...] = ("<|startoftranscript|>", "<|en|>")
    special_tokens: Tuple[str, ...] = ()


@dataclass(frozen=True)
class SubsamplingSpec:
    type: str = "dw_striding"
    factor: int = 8
    conv_channels: int = 256
    kernel: int = 3
    stride_stages: int = 3


@dataclass(frozen=True)
class EncoderSpec:
    feat_in: int = 128
    num_layers: int = 24
    d_model: int = 1024
    n_heads: int = 8
    ff_expansion_factor: int = 4
    conv_kernel_size: int = 9
    conv_norm_type: str = "batch_norm"
    self_attention_model: str = "rel_pos"
    untie_biases: bool = True
    xscaling: bool = False
    use_bias: bool = False
    pos_emb_max_len: int = 5000
    subsampling: SubsamplingSpec = field(default_factory=SubsamplingSpec)


@dataclass(frozen=True)
class PredictorSpec:
    pred_hidden: int = 640
    pred_rnn_layers: int = 2
    vocab_size: int = 8192
    blank_as_pad: bool = True
    embed_size: int = 8193


@dataclass(frozen=True)
class JointSpec:
    joint_hidden: int = 640
    activation: str = "relu"
    token_vocab_size: int = 8192
    blank_id: int = 8192
    token_head_offset: int = 0
    token_head_size: int = 8193
    duration_head_offset: int = 8193
    duration_values: Tuple[int, ...] = (0, 1, 2, 3, 4)
    joint_vocab_size: int = 8198


@dataclass(frozen=True)
class DecodeSpec:
    algorithm: str = "tdt_greedy"
    max_symbols_per_timestep: int = 8
    blank_duration_zero_policy: str = "disallow_duration_0_for_blank"
    partial_event_min_interval_ms: int = 100


@dataclass(frozen=True)
class StreamingSpec:
    chunk_size_frames: Tuple[int, int] = (41, 48)
    shift_size_frames: Tuple[int, int] = (17, 24)
    pre_encode_cache_size: Tuple[int, int] = (0, 9)
    drop_extra_pre_encoded: int = 2
    cache_drop_size: int = 3
    valid_out_len: int = 3
    cache_last_channel_size: int = 256
    cache_time_context_size: int = 4


@dataclass(frozen=True)
class Tolerances:
    cpu_f32_atol: float = 1e-4
    cpu_f32_rtol: float = 1e-4
    cache_last_time_atol: float = 0.1
    tpu_f32_p95: float = 5e-4
    tpu_f32_p100: float = 1e-3
    tpu_bf16_p95: float = 1.8e-3

    def rung_verdicts(self, enc_errs) -> Dict[str, Any]:
        """Evaluate a per-chunk encoder max-abs error series against the
        contract's tolerance ladder: the ``ort_f32`` rung is an atol on
        every chunk, ``trt_fp32`` a p95 and p100 bound, ``trt_fp16`` a p95
        bound. Returns each rung's verdict and the strictest rung passed
        (``best_rung``, None when none is). An empty series raises: it
        compared nothing, and a verdict on it would be a false pass."""
        e = np.asarray(list(enc_errs), dtype=np.float64)
        if e.size == 0:
            raise ValueError("rung_verdicts: empty error series — no chunks "
                             "were compared; refusing to emit a verdict")
        mx = float(e.max())
        p95 = float(np.percentile(e, 95))
        rungs = {
            "ort_f32": {
                "criterion": f"max_abs <= {self.cpu_f32_atol:g} on every chunk",
                "max_abs": mx,
                "pass": bool(mx <= self.cpu_f32_atol),
            },
            "trt_fp32": {
                "criterion": (f"p95 <= {self.tpu_f32_p95:g} and "
                              f"p100 <= {self.tpu_f32_p100:g}"),
                "p95": p95, "p100": mx,
                "pass": bool(p95 <= self.tpu_f32_p95 and mx <= self.tpu_f32_p100),
            },
            "trt_fp16": {
                "criterion": f"p95 <= {self.tpu_bf16_p95:g}",
                "p95": p95,
                "pass": bool(p95 <= self.tpu_bf16_p95),
            },
        }
        best = None
        for name in ("ort_f32", "trt_fp32", "trt_fp16"):  # strict -> loose
            if rungs[name]["pass"]:
                best = name
                break
        return {"rungs": rungs, "best_rung": best}


@dataclass(frozen=True)
class Contract:
    model_id: str
    frontend: FrontendSpec
    timebase: TimebaseSpec
    tokenizer: TokenizerSpec
    encoder: EncoderSpec
    predictor: PredictorSpec
    joint: JointSpec
    decode: DecodeSpec
    streaming: StreamingSpec
    tolerances: Tolerances
    raw: Dict[str, Any] = field(default_factory=dict, repr=False, compare=False)

    def validate(self) -> List[str]:
        """Cross-field consistency checks. Returns a list of violations."""
        errs: List[str] = []
        fe, tb, enc, st = self.frontend, self.timebase, self.encoder, self.streaming
        if fe.hop_length * 1000 != fe.sample_rate_hz * tb.feature_frame_shift_ms:
            errs.append("hop_length inconsistent with feature_frame_shift_ms")
        if tb.encoder_frame_shift_ms != tb.feature_frame_shift_ms * tb.encoder_subsampling_factor:
            errs.append("encoder_frame_shift_ms != frame_shift * subsampling")
        if enc.subsampling.factor != 2 ** enc.subsampling.stride_stages:
            errs.append("subsampling factor != 2**stride_stages")
        if enc.feat_in != fe.n_mels:
            errs.append("encoder.feat_in != frontend.n_mels")
        if self.joint.token_head_size != self.tokenizer.vocab_size + 1:
            errs.append("token_head_size != vocab_size + 1 (blank)")
        if self.joint.joint_vocab_size != self.joint.token_head_size + len(self.joint.duration_values):
            errs.append("joint_vocab_size != token_head + duration bins")
        if self.joint.blank_id != self.tokenizer.blank_id:
            errs.append("joint.blank_id != tokenizer.blank_id")
        if self.joint.duration_head_offset != self.joint.token_head_offset + self.joint.token_head_size:
            errs.append("duration head must follow token head")
        # Streaming arithmetic: each steady chunk must yield valid_out_len
        # new encoder steps (shift) plus cache_drop_size lookahead steps.
        f = enc.subsampling.factor
        if st.shift_size_frames[1] != st.valid_out_len * f:
            errs.append("steady shift_size != valid_out_len * subsampling")
        if st.chunk_size_frames[1] != (st.valid_out_len + st.cache_drop_size) * f:
            errs.append("steady chunk_size != (valid_out+cache_drop) * subsampling")
        if st.cache_time_context_size != (enc.conv_kernel_size - 1) // 2:
            errs.append("cache_time_context_size != (conv_kernel-1)//2")
        return errs


def _tup(x):
    """A (first chunk, steady chunk) pair from the JSON's list or scalar."""
    return tuple(x) if isinstance(x, (list, tuple)) else (x, x)


def load_contract(path: Optional[str] = None) -> Contract:
    """Load and validate a contract (default: the shipped one); raises
    ValueError on a violation of :meth:`Contract.validate`."""
    path = path or DEFAULT_CONTRACT_PATH
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)

    fe = raw["frontend"]
    nm = fe.get("normalize", {})
    frontend = FrontendSpec(
        sample_rate_hz=fe["sample_rate_hz"], n_fft=fe["n_fft"], n_mels=fe["n_mels"],
        hop_length=fe["hop_length"], win_length=fe["win_length"], window=fe["window"],
        preemphasis=fe.get("preemphasis", 0.0), mel_scale=fe.get("mel_scale", "htk"),
        mel_fmin_hz=fe.get("mel_fmin_hz", 0.0), mel_fmax_hz=fe.get("mel_fmax_hz", fe["sample_rate_hz"] / 2),
        log_floor=fe.get("log_floor", 1e-5),
        normalize=NormalizeSpec(
            mode=nm.get("mode", "per_feature"), scope=nm.get("scope", "utterance_time"),
            stats=nm.get("stats", "mean_std"), std_denominator=nm.get("std_denominator", "frames_minus_1"),
            std_epsilon=nm.get("std_epsilon", 1e-5),
            requires_full_utterance=nm.get("requires_full_utterance", True),
            streaming_safe=nm.get("streaming_safe", False),
        ),
    )
    tb = raw["timebase"]
    timebase = TimebaseSpec(
        feature_frame_shift_ms=tb["feature_frame_shift_ms"],
        encoder_subsampling_factor=tb["encoder_subsampling_factor"],
        encoder_frame_shift_ms=tb["encoder_frame_shift_ms"],
        encoder_steps_per_second=tb["encoder_steps_per_second"],
    )
    tk = raw["tokenizer"]
    tokenizer = TokenizerSpec(
        vocab_file=tk.get("vocab_file", "vocab.txt"), vocab_size=tk["vocab_size"],
        blank_id=tk["blank_id"], token_head_size=tk["token_head_size"],
        word_boundary_marker=tk.get("word_boundary_marker", "▁"),
        prompt_tokens=tuple(tk.get("prompt_tokens", ())),
        special_tokens=tuple(tk.get("special_tokens", ())),
    )
    en = raw["encoder"]
    ss = en["subsampling"]
    encoder = EncoderSpec(
        feat_in=en["feat_in"], num_layers=en["num_layers"], d_model=en["d_model"],
        n_heads=en["n_heads"], ff_expansion_factor=en["ff_expansion_factor"],
        conv_kernel_size=en["conv_kernel_size"], conv_norm_type=en["conv_norm_type"],
        self_attention_model=en["self_attention_model"], untie_biases=en["untie_biases"],
        xscaling=en["xscaling"], use_bias=en["use_bias"], pos_emb_max_len=en["pos_emb_max_len"],
        subsampling=SubsamplingSpec(
            type=ss["type"], factor=ss["factor"], conv_channels=ss["conv_channels"],
            kernel=ss.get("kernel", 3), stride_stages=ss.get("stride_stages", 3),
        ),
    )
    pr = raw["predictor"]
    predictor = PredictorSpec(
        pred_hidden=pr["pred_hidden"], pred_rnn_layers=pr["pred_rnn_layers"],
        vocab_size=pr["vocab_size"], blank_as_pad=pr["blank_as_pad"],
        embed_size=pr.get("embed_size", pr["vocab_size"] + 1),
    )
    jt = raw["joint"]
    joint = JointSpec(
        joint_hidden=jt["joint_hidden"], activation=jt["activation"],
        token_vocab_size=jt["token_vocab_size"], blank_id=jt["blank_id"],
        token_head_offset=jt["token_head"]["offset"], token_head_size=jt["token_head"]["size"],
        duration_head_offset=jt["duration_head"]["offset"],
        duration_values=tuple(jt["duration_values"]), joint_vocab_size=jt["joint_vocab_size"],
    )
    dc = raw["decode"]
    decode = DecodeSpec(
        algorithm=dc["algorithm"], max_symbols_per_timestep=dc["max_symbols_per_timestep"],
        blank_duration_zero_policy=dc["blank_duration_zero_policy"],
        partial_event_min_interval_ms=dc.get("partial_event_min_interval_ms", 100),
    )
    st = raw["streaming"]
    streaming = StreamingSpec(
        chunk_size_frames=_tup(st["chunk_size_frames"]),
        shift_size_frames=_tup(st["shift_size_frames"]),
        pre_encode_cache_size=_tup(st["pre_encode_cache_size"]),
        drop_extra_pre_encoded=st["drop_extra_pre_encoded"],
        cache_drop_size=st["cache_drop_size"], valid_out_len=st["valid_out_len"],
        cache_last_channel_size=st["cache_last_channel_size"],
        cache_time_context_size=st["cache_time_context_size"],
    )
    tl = raw.get("tolerances", {})
    cpu = tl.get("cpu_f32", {})
    tpu32 = tl.get("tpu_f32", {})
    tpu16 = tl.get("tpu_bf16", {})
    tolerances = Tolerances(
        cpu_f32_atol=cpu.get("default_atol", 1e-4), cpu_f32_rtol=cpu.get("default_rtol", 1e-4),
        cache_last_time_atol=cpu.get("cache_last_time_atol", 0.1),
        tpu_f32_p95=tpu32.get("encoder_output_p95_max_abs", 5e-4),
        tpu_f32_p100=tpu32.get("encoder_output_p100_max_abs", 1e-3),
        tpu_bf16_p95=tpu16.get("encoder_output_p95_max_abs", 1.8e-3),
    )

    c = Contract(
        model_id=raw["model_id"], frontend=frontend, timebase=timebase, tokenizer=tokenizer,
        encoder=encoder, predictor=predictor, joint=joint, decode=decode,
        streaming=streaming, tolerances=tolerances, raw=raw,
    )
    errs = c.validate()
    if errs:
        raise ValueError(f"contract {path} failed validation: {errs}")
    return c
