"""Streaming session: audio in, PARTIAL/FINAL events out.

Same behavior as the JAX package's ``streaming/session.py``
``StreamingSession`` for the streaming greedy path: log-mel frames with
overlap carried across pushes, the chunk schedule of ``schedule.py``, one
chunk step per chunk (streaming encoder + blank-run batched TDT greedy
decode), and events. Encoder caches are updated in place on the device;
``snapshot()`` copies them out.

With ``RuntimeConfig.use_pallas_att`` the steady chunks (the fixed 57-frame
shape) run the fused attention-block CUDA kernel, with the step axis padded
to 8; the first and the last chunk of an utterance take the plain path.
``use_pallas_joint`` routes the decode's joint through the fused joint-step
kernel.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Deque, List, Optional

import numpy as np
import torch

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch
from trt_asr_tpu_torch.decode.tdt_greedy import (DecodeState, init_decode_state,
                                                 prime_decode_state)
from trt_asr_tpu_torch.frontend.logmel import StreamingLogMel
from trt_asr_tpu_torch.frontend.normalize import apply_per_feature_norm
from trt_asr_tpu_torch.models.parakeet.encoder import (EncoderState, encode,
                                                       init_encoder_state,
                                                       precompute_pos_proj,
                                                       state_from_contract,
                                                       state_to_contract)
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.conv import subsampled_length
from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler, extract_chunk


class EventType(IntEnum):
    PARTIAL_TEXT = 0
    FINAL_TEXT = 1
    ERROR = 2


@dataclass
class Event:
    type: EventType
    segment_id: int
    text: str = ""
    error_message: str = ""
    tokens: List[int] = field(default_factory=list)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class StreamingSession:
    def __init__(self, model: ParakeetTDT, runtime: Optional[RuntimeConfig] = None,
                 feature_norm: str = "none", norm_stats: Optional[tuple] = None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.rt = runtime or model.runtime
        if not self.rt.batched_decode:
            raise NotImplementedError(
                "the per-step decode loop (batched_decode=False) is not ported yet")
        self.feature_norm = feature_norm
        self.norm_stats = norm_stats
        self._events: Deque[Event] = deque()
        self._lock = threading.Lock()
        self._segment = 0
        self._chunk_latencies_ms: List[float] = []
        cfg = self.cfg
        # steady chunk: 57 frames -> 8 steps - drop 2 = 6 (full-size regime)
        frames = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
        tq = subsampled_length(frames, cfg.stride_stages) - cfg.drop_extra_pre_encoded
        self._tq_steady = tq
        self._pos_proj = precompute_pos_proj(model.params, cfg, tq, cfg.att_cache_size)
        fs = self.model.frontend.spec
        self._enc_frame_s = fs.hop_length / fs.sample_rate_hz * cfg.subsampling_factor
        self._pos_proj_kernel = None
        self._pad_steps = 0
        if self.rt.use_pallas_att:
            tq_pad = _round_up(tq, 8)
            self._pad_steps = tq_pad - tq
            self._pos_proj_kernel = precompute_pos_proj(model.params, cfg, tq_pad,
                                                        cfg.att_cache_size)
        self._punct_mask = (torch.as_tensor(model.punct_mask, device=self.device)
                            if self.rt.suppress_leading_punct else None)
        self.reset_utterance()

    # -- lifecycle ------------------------------------------------------

    def reset_utterance(self) -> None:
        cfg = self.cfg
        self._mel = StreamingLogMel(self.model.frontend)
        self._feat_buf = np.zeros((0, cfg.feat_in), np.float32)
        self._sched = ChunkScheduler(cfg)
        self._enc_state = init_encoder_state(cfg, 1, device=self.device)
        self._dec_state = prime_decode_state(
            self.model.params, cfg, init_decode_state(cfg, 1, device=self.device),
            self.model.prompt_ids)
        self._tokens: List[int] = []
        self._token_frames: List[int] = []
        self._token_durs: List[int] = []
        self._token_logps: List[float] = []
        self._frames_base = 0
        self._last_partial_t = 0.0
        self._last_partial_len = 0
        self._finalized = False
        self._segment += 1

    # -- snapshot / restore ----------------------------------------------

    def snapshot(self) -> dict:
        """Copy the complete per-stream state out (numpy): encoder caches in
        contract layout, predictor state, tokens, time carry, scheduler
        progress. Restorable with :meth:`restore`."""
        enc = {k: v.cpu().numpy() for k, v in state_to_contract(self._enc_state).items()}
        d = self._dec_state
        return {
            "encoder": enc,
            "decoder": {"g": d.g.cpu().numpy(), "h": d.h.cpu().numpy(),
                        "c": d.c.cpu().numpy(), "y_id": d.y_id.cpu().numpy(),
                        "time_carry": d.time_carry.cpu().numpy()},
            "tokens": list(self._tokens),
            "token_frames": list(self._token_frames),
            "token_durs": list(self._token_durs),
            "token_logps": list(self._token_logps),
            "frames_base": self._frames_base,
            "feat_buf": self._feat_buf.copy(),
            "mel_carry": self._mel._carry.copy(),
            "sched": {"idx": self._sched._idx, "start": self._sched._start},
            "segment": self._segment,
            "finalized": self._finalized,
        }

    def restore(self, snap: dict) -> None:
        dev = self.device
        self._enc_state = state_from_contract(
            {k: torch.as_tensor(v, device=dev) for k, v in snap["encoder"].items()},
            self.model.params)
        dd = snap["decoder"]
        t = lambda a: torch.as_tensor(np.array(a), device=dev)  # noqa: E731
        self._dec_state = DecodeState(g=t(dd["g"]), h=t(dd["h"]), c=t(dd["c"]),
                                      y_id=t(dd["y_id"]), time_carry=t(dd["time_carry"]))
        self._tokens = list(snap["tokens"])
        self._token_frames = list(snap.get("token_frames", []))
        self._token_durs = list(snap.get("token_durs", []))
        self._token_logps = list(snap.get("token_logps", []))
        self._frames_base = snap.get("frames_base", 0)
        self._feat_buf = snap["feat_buf"].copy()
        self._mel._carry = snap["mel_carry"].copy()
        self._sched._idx = snap["sched"]["idx"]
        self._sched._start = snap["sched"]["start"]
        self._segment = snap["segment"]
        self._finalized = snap["finalized"]
        self._last_partial_len = len(self._tokens)

    # -- input ----------------------------------------------------------

    def push_audio(self, samples: np.ndarray) -> int:
        feats = self._mel.push(np.asarray(samples, np.float32))
        return self.push_features(feats)

    def push_features(self, feats: np.ndarray) -> int:
        """feats [T, C]. Returns the number of chunks processed."""
        if self._finalized:
            self._error("push after finalize; call reset_utterance")
            return 0
        try:
            if feats.size:
                feats = np.asarray(feats, np.float32)
                if feats.ndim != 2 or feats.shape[1] != self.cfg.feat_in:
                    raise ValueError(
                        f"push_features: expected [T, {self.cfg.feat_in}] "
                        f"features, got {feats.shape}")
                feats = self._normalize(feats)
                self._feat_buf = np.concatenate([self._feat_buf, feats], axis=0)
            done = 0
            while True:
                spec = self._sched.next_ready(self._feat_buf.shape[0])
                if spec is None:
                    break
                self._run_chunk(spec, is_last=False)
                done += 1
            self._maybe_partial()
            if self.rt.final_on_push and done:
                with self._lock:
                    self._events.append(Event(
                        EventType.FINAL_TEXT, self._segment,
                        self.model.tokenizer.decode(self._tokens),
                        tokens=list(self._tokens)))
            return done
        except Exception as e:  # noqa: BLE001 — surfaced as an ERROR event, then re-raised
            self._error(f"push_features failed: {e!r}")
            raise

    def finalize(self) -> None:
        """End of utterance: flush the final short chunk, emit FinalText."""
        if self._finalized:
            return
        spec = self._sched.flush(self._feat_buf.shape[0])
        if spec is not None:
            self._run_chunk(spec, is_last=True)
        self._finalized = True
        with self._lock:
            self._events.append(Event(EventType.FINAL_TEXT, self._segment,
                                      self.model.tokenizer.decode(self._tokens),
                                      tokens=list(self._tokens)))

    # -- events / results -------------------------------------------------

    def poll_event(self) -> Optional[Event]:
        with self._lock:
            return self._events.popleft() if self._events else None

    @property
    def text(self) -> str:
        return self.model.tokenizer.decode(self._tokens)

    @property
    def tokens(self) -> List[int]:
        return list(self._tokens)

    def token_timestamps(self) -> List[dict]:
        """Per emitted token: id, piece, decode-time log-prob and absolute
        [start_s, end_s] from its anchor frame and predicted duration."""
        from trt_asr_tpu_torch.decode.timestamps import token_intervals

        iv = token_intervals(self._token_frames, self._token_durs, self._enc_frame_s)
        return [{"token": int(t), "piece": self.model.tokenizer.token_at(int(t)),
                 "logp": round(lp, 4), **span}
                for t, lp, span in zip(self._tokens, self._token_logps, iv)]

    def word_timestamps(self) -> List[dict]:
        from trt_asr_tpu_torch.decode.timestamps import word_intervals

        return word_intervals(self._tokens, self._token_frames, self._token_durs,
                              self.model.tokenizer, self._enc_frame_s,
                              logps=self._token_logps)

    @property
    def chunk_latencies_ms(self) -> List[float]:
        return list(self._chunk_latencies_ms)

    # -- internals --------------------------------------------------------

    def _normalize(self, feats: np.ndarray) -> np.ndarray:
        if self.feature_norm == "per_feature":
            if self.norm_stats is None:
                raise ValueError("per_feature norm needs full-utterance stats; pass norm_stats")
            mean, std = self.norm_stats
            return apply_per_feature_norm(feats, mean, std).numpy()
        return feats

    def _run_chunk(self, spec, is_last: bool) -> None:
        cfg, rt = self.cfg, self.rt
        t0 = time.perf_counter()
        x = extract_chunk(self._feat_buf, spec)
        buflen = self._feat_buf.shape[0]
        # valid = implicit left zeros (unified first chunk) + real frames
        valid = (max(-spec.slice_start, 0)
                 + max(min(spec.slice_end, buflen) - max(spec.slice_start, 0), 0))
        if rt.disable_cache:
            self._enc_state = init_encoder_state(cfg, 1, device=self.device)
        if rt.cache_len_override >= 0:
            forced = min(rt.cache_len_override, cfg.att_cache_size)
            self._enc_state = self._enc_state._replace(
                cache_len=torch.full_like(self._enc_state.cache_len, forced))
        tq_chunk = subsampled_length(spec.frames, cfg.stride_stages) - spec.drop_extra
        kernel_att = self._pos_proj_kernel is not None and tq_chunk == self._tq_steady
        if kernel_att:
            pos_proj = self._pos_proj_kernel
        elif tq_chunk == self._tq_steady:
            pos_proj = self._pos_proj
        else:
            pos_proj = None
        toks, n, self._enc_state, self._dec_state, stamps, t_out = _session_step(
            self.model, torch.as_tensor(x[None], device=self.device), valid,
            self._enc_state, self._dec_state,
            drop_extra=spec.drop_extra,
            cache_drop=0 if is_last else cfg.cache_drop_size,
            valid_cap=None if is_last else cfg.valid_out_len,
            blank_penalty=rt.blank_penalty,
            emitted_so_far=len(self._tokens),
            punct_mask=self._punct_mask,
            pos_proj=pos_proj, pad_steps=self._pad_steps if kernel_att else 0,
            use_pallas_att=kernel_att, use_pallas_joint=rt.use_pallas_joint)
        n = int(n)
        self._token_frames.extend(self._frames_base + int(f) for f in stamps[0][:n])
        self._token_durs.extend(int(d) for d in stamps[1][:n])
        self._token_logps.extend(float(c) for c in stamps[2][:n])
        self._frames_base += t_out
        self._tokens.extend(int(t) for t in toks[:n])
        self._chunk_latencies_ms.append((time.perf_counter() - t0) * 1e3)

    def _maybe_partial(self) -> None:
        now = time.monotonic()
        if (len(self._tokens) != self._last_partial_len
                and (now - self._last_partial_t) * 1e3 >= self.rt.partial_min_interval_ms):
            self._last_partial_t = now
            self._last_partial_len = len(self._tokens)
            with self._lock:
                self._events.append(Event(EventType.PARTIAL_TEXT, self._segment,
                                          self.model.tokenizer.decode(self._tokens),
                                          tokens=list(self._tokens)))

    def _error(self, msg: str) -> None:
        with self._lock:
            self._events.append(Event(EventType.ERROR, self._segment, error_message=msg))


def _session_step(model: ParakeetTDT, feats: torch.Tensor, valid: int,
                  enc_state: EncoderState, dec_state: DecodeState, *,
                  drop_extra: int, cache_drop: int, valid_cap: Optional[int],
                  blank_penalty: float, emitted_so_far: int, punct_mask,
                  pos_proj=None, pad_steps: int = 0, use_pallas_att: bool = False,
                  use_pallas_joint: bool = False):
    """One chunk: streaming encoder step + blank-run batched TDT greedy
    decode. Returns (tokens, n, enc_state, dec_state, (frames, durs, logps),
    t_out) with tokens/stamps as host tensors and t_out the chunk's valid
    encoder step count (host int)."""
    cfg: ModelConfig = model.cfg
    lengths = torch.full((1,), valid, dtype=torch.int32, device=feats.device)
    enc, out_len, enc_state = encode(
        model.params, cfg, feats, lengths, enc_state, drop_extra=drop_extra,
        cache_drop=cache_drop, valid_cap=valid_cap, pad_steps=pad_steps,
        use_pallas_att=use_pallas_att, pos_proj=pos_proj, layers=model.layers)
    tq = enc.shape[1]
    toks, n, dec_state, stamps = tdt_greedy_decode_batch(
        model.params, cfg, enc, out_len, dec_state,
        max_tokens=cfg.max_symbols_per_timestep * tq, blank_penalty=blank_penalty,
        emitted_so_far=np.array([emitted_so_far]), punct_mask=punct_mask,
        use_punct_mask=punct_mask is not None, use_pallas_joint=use_pallas_joint,
        with_timestamps=True)
    fr, du, lp = stamps
    t_out = int(out_len[0])
    return toks[0], n[0], enc_state, dec_state, (fr[0], du[0], lp[0]), t_out
