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
``use_pallas_ffn`` and ``use_pallas_conv`` run the fused FFN and conv-module
kernels (with int8 encoder weights and both on, the fused conv + FFN2 +
output-LayerNorm kernel) on every chunk, whatever its step count.
``use_pallas_joint`` routes the decode's joint through the fused joint-step
kernel.

JAX's session decodes with its blank-run batched decoder unless
``batched_decode`` is False or a trace is asked for (``debug_tdt_steps``,
``debug_blank_scan``), which take its per-step chunk decoder with the
trace buffer. In the port both routes are one loop: at a session's sizes
(B = 1, a chunk's steps far under the batched decoder's 128/256 gates)
``tdt_greedy_decode_batch`` walks blank runs with the joint-step kernel
as ``tdt_greedy_decode_chunk`` does, so the session always calls it and
asks it for the trace when one is on; ``batched_decode=False`` runs the
same calls. The debug
surface of ``RuntimeConfig`` hooks in where the JAX session hooks it: audio
and feature taps, per-chunk snapshots, the NaN guard on the attention
cache, stage and slow-chunk markers, emitted-token lines, the decode trace
(``tdt_steps``, written as NDJSON at ``finalize`` to ``tdt_trace_path``),
the blank-scan summary, the profiler capture and the ``drop_time_carry``
sabotage. With every toggle at its default none of them runs.

``engines=`` (an ``EngineSet`` of ``runtime/engine.py``) looks each
chunk's signature up in the set (``_step_kwargs``, the one source of the
step's call, which ``session_program_specs`` reads too) and counts it in
``engine_hits`` or ``engine_misses``, as the JAX session does. A program
is the chunk step itself, so a hit and a miss run the same step; what the
set gives is its kernel libraries, bound at load.
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
from trt_asr_tpu_torch.debug.nan_guard import check_finite
from trt_asr_tpu_torch.debug.profiler import maybe_profiler
from trt_asr_tpu_torch.debug.snapshot import maybe_snapshot_chunk
from trt_asr_tpu_torch.debug.stage_markers import stage_marker
from trt_asr_tpu_torch.debug.taps import maybe_tap_run
from trt_asr_tpu_torch.debug.tdt_trace import records_from_buffer, write_ndjson
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
                 feature_norm: str = "none", norm_stats: Optional[tuple] = None,
                 engines=None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.rt = runtime or model.runtime
        self.feature_norm = feature_norm
        self.norm_stats = norm_stats
        self._engines = engines
        self._engine_key_memo: dict = {}
        self.engine_hits = 0
        self.engine_misses = 0
        self._events: Deque[Event] = deque()
        self._lock = threading.Lock()
        self._segment = 0
        self._chunk_latencies_ms: List[float] = []
        self._debug_ctx = ""
        self._taps = maybe_tap_run(self.rt)
        self._profiler = maybe_profiler(self.rt, self.device)
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
        stage_marker(self.rt, "reset_utterance enter")
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
        self.tdt_steps: List[dict] = []     # the decode trace's step records
        self._last_partial_t = 0.0
        self._last_partial_len = 0
        self._finalized = False
        self._segment += 1
        stage_marker(self.rt, "reset_utterance exit")

    def set_debug_context(self, ctx: str) -> None:
        """A caller's label for this stream (a C-ABI bridge passes one),
        kept as the JAX session keeps it."""
        self._debug_ctx = ctx

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

    def push_audio(self, samples: np.ndarray, stream_pos: Optional[int] = None) -> int:
        """``stream_pos``: this piece's sample offset in the source stream
        (optional); where the capture side dropped audio, the audio tap
        zero-fills the hole and counts it, so a replay stays aligned."""
        if self._taps is not None:
            self._taps.audio().write(np.asarray(samples, np.float32),
                                     {"ctx": self._debug_ctx}, stream_pos=stream_pos)
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
                if self._taps is not None:
                    self._taps.features(n_mels=self.cfg.feat_in).write(
                        feats, {"ctx": self._debug_ctx})
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
        rt = self.rt
        if rt.debug_tdt_steps and rt.tdt_trace_path:
            write_ndjson(rt.tdt_trace_path, self.tdt_steps,
                         {"type": "meta", "source": "device_while_loop",
                          "blank_id": self.cfg.blank_id, "emitted": len(self._tokens)})
        self._close_debug()
        if rt.debug_blank_scan and self.tdt_steps:
            # blank-vs-emit preference over the decode steps (PARAKEET_DEBUG_BLANK_SCAN)
            steps = len(self.tdt_steps)
            blanks = sum(r["is_blank"] for r in self.tdt_steps)
            clamped = sum(bool(r.get("blank_dur0_clamped")) for r in self.tdt_steps)
            stage_marker(rt, f"blank_scan: steps={steps} blank_pref={blanks} "
                             f"nonblank_pref={steps - blanks} dur0_clamped={clamped}",
                         force=True)
        with self._lock:
            self._events.append(Event(EventType.FINAL_TEXT, self._segment,
                                      self.model.tokenizer.decode(self._tokens),
                                      tokens=list(self._tokens)))

    def _close_debug(self) -> None:
        """Close the taps and end the profiler capture (at finalize)."""
        if self._taps is not None:
            self._taps.close()
        if self._profiler is not None:
            self._profiler.stop()

    # -- events / results -------------------------------------------------

    def poll_event(self) -> Optional[Event]:
        with self._lock:
            return self._events.popleft() if self._events else None

    @property
    def text(self) -> str:
        return self.model.tokenizer.decode(self._tokens)

    @property
    def stable_text(self) -> str:
        """The part of the transcript no later chunk can rewrite: greedy
        decoding never revises an emitted token, so all of it."""
        return self.text

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

    def _chunk_inputs(self, spec, kernels: bool = True):
        """The chunk prologue, shared with the beam session: the chunk's
        features on the device, its valid frame count, the encoder-state
        overrides of ``disable_cache`` and ``cache_len_override``, and the
        position projection (with ``kernels``, the attention kernel's padded
        one on a steady chunk). Returns (x [1, T, C], valid, pos_proj,
        kernel_att)."""
        cfg, rt = self.cfg, self.rt
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
        kernel_att = (kernels and self._pos_proj_kernel is not None
                      and tq_chunk == self._tq_steady)
        if kernel_att:
            pos_proj = self._pos_proj_kernel
        elif tq_chunk == self._tq_steady:
            pos_proj = self._pos_proj
        else:
            pos_proj = None
        return torch.as_tensor(x[None], device=self.device), valid, pos_proj, kernel_att

    def _step_kwargs(self, spec, is_last: bool):
        """The exact ``(args, kwargs)`` of the chunk step: the one source of
        the call, shared by :meth:`_run_chunk` and the engine set's build
        (``runtime/engine.py`` ``session_program_specs``), so that a program
        can never drift from the serving call. The valid frame count and the
        tokens emitted so far are numpy scalars, data as in JAX's call; the
        Python scalars are the statics a program key reads by value."""
        cfg, rt = self.cfg, self.rt
        x, valid, pos_proj, kernel_att = self._chunk_inputs(spec)
        args = (self.model, x, np.int32(valid), self._enc_state, self._dec_state)
        kwargs = dict(
            drop_extra=spec.drop_extra,
            cache_drop=0 if is_last else cfg.cache_drop_size,
            valid_cap=None if is_last else cfg.valid_out_len,
            blank_penalty=rt.blank_penalty,
            emitted_so_far=np.int32(len(self._tokens)),
            punct_mask=self._punct_mask,
            pos_proj=pos_proj, pad_steps=self._pad_steps if kernel_att else 0,
            use_pallas_att=kernel_att, use_pallas_joint=rt.use_pallas_joint,
            use_pallas_ffn=rt.use_pallas_ffn, use_pallas_conv=rt.use_pallas_conv,
            trace=rt.debug_tdt_steps or rt.debug_blank_scan)
        return args, kwargs

    def _count_engine(self, spec, is_last: bool, args, kwargs) -> None:
        """Count this call's program as a hit or a miss of the engine set.
        The key is memoized by the chunk's geometry and every static's
        value."""
        memo_key = (spec.frames, spec.drop_extra, is_last, tuple(sorted(
            (k, v) for k, v in kwargs.items()
            if isinstance(v, (bool, int, float, str, type(None))))))
        prog_key = self._engine_key_memo.get(memo_key)
        if prog_key is None:
            from trt_asr_tpu_torch.runtime.engine import program_key

            prog_key = self._engine_key_memo[memo_key] = program_key(args, kwargs)
        if self._engines.get(prog_key) is None:
            self.engine_misses += 1
        else:
            self.engine_hits += 1

    def _run_chunk(self, spec, is_last: bool) -> None:
        rt = self.rt
        stage_marker(rt, f"chunk {spec.idx} enter [{self._debug_ctx}]")
        if self._profiler is not None:
            self._profiler.chunk_start()
        t0 = time.perf_counter()
        args, kwargs = self._step_kwargs(spec, is_last)
        trace = kwargs["trace"]
        if self._engines is not None:
            self._count_engine(spec, is_last, args, kwargs)
        out = _session_step(*args, **kwargs)
        toks, n, self._enc_state, self._dec_state, stamps, t_out = out[:6]
        if trace:
            self.tdt_steps.extend(records_from_buffer(*out[6]))
        if rt.sabotage == "drop_time_carry":
            # fault injection (gate-sensitivity proof): drop the duration
            # overshoot at every chunk boundary
            self._dec_state = self._dec_state._replace(
                time_carry=torch.zeros_like(self._dec_state.time_carry))
        n = int(n)
        new = [int(t) for t in toks[:n]]
        self._token_frames.extend(self._frames_base + int(f) for f in stamps[0][:n])
        self._token_durs.extend(int(d) for d in stamps[1][:n])
        self._token_logps.extend(float(c) for c in stamps[2][:n])
        self._frames_base += t_out
        ms = (time.perf_counter() - t0) * 1e3
        self._chunk_latencies_ms.append(ms)
        if ms > rt.slow_step_ms:
            stage_marker(rt, f"SLOW chunk {spec.idx}: {ms:.1f} ms", force=True)
        if rt.nan_guard:
            check_finite(self._enc_state.att_cache, "att_cache", halt=rt.nan_guard_halt)
        self._tokens.extend(new)
        if rt.debug_emit_tokens and new:
            stage_marker(rt, f"chunk {spec.idx} emitted {new}", force=True)
        maybe_snapshot_chunk(rt, spec.idx, enc_state=self._enc_state,
                             dec_state=self._dec_state, tokens=new)
        if self._profiler is not None:
            self._profiler.chunk_end()
        stage_marker(rt, f"chunk {spec.idx} exit ({ms:.1f} ms, {n} tokens)")

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
                  use_pallas_joint: bool = False, use_pallas_ffn: bool = False,
                  use_pallas_conv: bool = False, trace: bool = False):
    """One chunk: streaming encoder step + blank-run TDT greedy decode.
    Returns (tokens, n, enc_state, dec_state, (frames, durs, logps), t_out)
    with tokens/stamps as host tensors and t_out the chunk's valid encoder
    step count (host int); with ``trace``, then ``(records, n_steps)``
    (``debug/tdt_trace.py``)."""
    cfg: ModelConfig = model.cfg
    lengths = torch.full((1,), valid, dtype=torch.int32, device=feats.device)
    enc, out_len, enc_state = encode(
        model.params, cfg, feats, lengths, enc_state, drop_extra=drop_extra,
        cache_drop=cache_drop, valid_cap=valid_cap, pad_steps=pad_steps,
        use_pallas_att=use_pallas_att, use_pallas_ffn=use_pallas_ffn,
        use_pallas_conv=use_pallas_conv, pos_proj=pos_proj, layers=model.layers)
    tq = enc.shape[1]
    out = tdt_greedy_decode_batch(
        model.params, cfg, enc, out_len, dec_state,
        max_tokens=cfg.max_symbols_per_timestep * tq, blank_penalty=blank_penalty,
        emitted_so_far=np.array([emitted_so_far]), punct_mask=punct_mask,
        use_punct_mask=punct_mask is not None, use_pallas_joint=use_pallas_joint,
        with_timestamps=True, joint_packed=model.joint_packed, trace=trace)
    toks, n, dec_state, (fr, du, lp) = out[:4]
    t_out = int(out_len[0])
    return (toks[0], n[0], enc_state, dec_state, (fr[0], du[0], lp[0]), t_out) + out[4:]
