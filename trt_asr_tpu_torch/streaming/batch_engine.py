"""Lockstep multi-stream streaming engine: up to B streams, one batched chunk
step per ``step()``.

Same behavior as the JAX package's ``streaming/batch_engine.py``
``BatchStreamingEngine`` on its greedy, single-device path: every ready
stream's chunk (the unified 57-frame shape) goes through one batched
streaming-encoder step and one lockstep batched TDT greedy decode
(:func:`_batch_step`). A stream without a full chunk runs with 0 valid
frames, a no-op on its caches and decode state; a finalizing stream's
keep-all flush chunk runs inside the same step as its neighbours' steady
chunks (per-row ``cache_drop_vec``/``valid_cap_vec``). Slots attach and
detach by row resets of the encoder caches and the decode state. The joint
step's kernel (``RuntimeConfig.use_pallas_joint``) takes the decode's
blank-run joints while B * Tq <= 128, as in the JAX package.

``beam > 1`` serves every slot with the batched device beam
(``decode/beam_device.py``, a [S, K, ...] frontier) in the same lockstep
step (:func:`_batch_beam_step`), with optional shallow fusion: ``lm_fn``
an ``NGramLM`` or ``BiasingLM`` compiled to device tables. Each slot's
n-best equals a standalone device beam session's; ``nbest(sid)`` ranks it.
The beam step runs with the kernels off, as the JAX beam step does.

``engines=`` (an ``EngineSet`` of ``runtime/engine.py``) looks the
lockstep step's signature up in the set (``_step_args`` and
``_step_kwargs``, which ``batch_program_specs`` reads too) and counts each
step in ``engine_hits`` or ``engine_misses``; a hit and a miss run the same
step, whose kernel libraries the set bound at load. ``mesh=`` (``parallel/mesh.py``): a one-device mesh is the
model's device, where the engine's states live, so the engine runs as with
``mesh=None``; a larger mesh raises. The JAX engine's refusals come
with them: ``engines`` with ``mesh``, a beam engine with either, a batch
size that dp does not divide.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from trt_asr_tpu_torch.config import RuntimeConfig
from trt_asr_tpu_torch.decode.batched import reset_decode_state_rows, tdt_greedy_decode_batch
from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state, prime_decode_state
from trt_asr_tpu_torch.frontend.logmel import StreamingLogMel
from trt_asr_tpu_torch.models.parakeet.encoder import (encode, init_encoder_state,
                                                       precompute_pos_proj,
                                                       reset_encoder_state_rows)
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.ops.conv import subsampled_length
from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler, extract_chunk
from trt_asr_tpu_torch.streaming.session import Event, EventType


def _batch_step(model: ParakeetTDT, feats, valid, enc_state, dec_state, emitted_so_far,
                cache_drop_vec, valid_cap_vec, *, drop_extra: int, max_tokens: int,
                blank_penalty: float = 0.0, punct_mask=None, pos_proj=None,
                pad_steps: int = 0, use_pallas_att: bool = False,
                use_pallas_conv: bool = False, use_pallas_ffn: bool = False,
                use_pallas_joint: bool = False):
    """One lockstep step for steady AND final-flush chunks: the batched
    streaming encoder (per-row cache_drop and emission cap) and the batched
    TDT greedy decode. feats [B, T, C] on the device; valid, emitted_so_far,
    cache_drop_vec, valid_cap_vec [B]. ``use_pallas_att`` (B=1, steps
    padded by ``pad_steps``), ``use_pallas_conv`` (B=1) and
    ``use_pallas_ffn`` as :func:`~trt_asr_tpu_torch.models.parakeet.
    encoder.encode` takes them; the engine leaves them off, as the JAX
    engine does. Returns
    (tokens, n, enc_state, dec_state, (frames, durs, logps), out_len),
    tokens, counts and stamps as host tensors."""
    cfg = model.cfg
    enc, out_len, enc_state = encode(
        model.params, cfg, feats, valid, enc_state, drop_extra=drop_extra,
        cache_drop_vec=cache_drop_vec, valid_cap_vec=valid_cap_vec, pos_proj=pos_proj,
        pad_steps=pad_steps, use_pallas_att=use_pallas_att, use_pallas_conv=use_pallas_conv,
        use_pallas_ffn=use_pallas_ffn, layers=model.layers)
    toks, n, dec_state, stamps = tdt_greedy_decode_batch(
        model.params, cfg, enc, out_len, dec_state, max_tokens=max_tokens,
        blank_penalty=blank_penalty, emitted_so_far=emitted_so_far, punct_mask=punct_mask,
        use_punct_mask=punct_mask is not None, use_pallas_joint=use_pallas_joint,
        with_timestamps=True, joint_packed=model.joint_packed)
    return toks, n, enc_state, dec_state, stamps, out_len


def _batch_beam_step(model: ParakeetTDT, feats, valid, enc_state, beam_state, cache_drop_vec,
                     valid_cap_vec, *, drop_extra: int, beam: int, expansion_k: int,
                     max_symbols: int, blank_penalty: float = 0.0, punct_mask=None,
                     pos_proj=None, lm_spec=None, lm_tables=None, lm_weight: float = 0.0,
                     rows: Optional[int] = None):
    """The beam's lockstep step: the batched streaming encoder and S
    lockstep device beams (``tdt_beam_chunk_device_batch``) over the first
    ``rows`` encoder rows (the largest emission cap in ``valid_cap_vec``, a
    host-side bound: no row past it is valid; all rows when None). Returns
    (enc_state, beam_state, out_len, n_best, toks_best, sat_live), the last
    three as host arrays: each slot's 1-best length and tokens [S, L] and
    whether a live hypothesis saturated its token buffer, so that the host
    reads O(S * L) values, never the [S, K, L] pool."""
    from trt_asr_tpu_torch.decode.beam_device import tdt_beam_chunk_device_batch

    cfg = model.cfg
    enc, out_len, enc_state = encode(
        model.params, cfg, feats, valid, enc_state, drop_extra=drop_extra,
        cache_drop_vec=cache_drop_vec, valid_cap_vec=valid_cap_vec, pos_proj=pos_proj,
        layers=model.layers)
    beam_state = tdt_beam_chunk_device_batch(
        model.params, cfg, enc[:, :rows], out_len, beam_state, beam=beam, expansion_k=expansion_k,
        max_symbols=max_symbols, blank_penalty=blank_penalty, punct_mask=punct_mask,
        use_punct_mask=punct_mask is not None, lm_spec=lm_spec, lm_tables=lm_tables,
        lm_weight=lm_weight)
    best = torch.argmax(beam_state.score, dim=1)                        # [S]
    rows = torch.arange(best.shape[0], device=best.device)
    n_best = beam_state.n_tok[rows, best]
    toks_best = beam_state.tokens[rows, best]
    sat_live = (beam_state.sat & torch.isfinite(beam_state.score)).any(dim=1)
    return (enc_state, beam_state, out_len.cpu().numpy(), n_best.cpu().numpy(),
            toks_best.cpu().numpy(), sat_live.cpu().numpy())


class BatchStreamingEngine:
    def __init__(self, model: ParakeetTDT, batch_size: int = 8,
                 runtime: Optional[RuntimeConfig] = None, mesh=None, engines=None,
                 beam: int = 1, expansion_k: int = 4, lm_fn=None, lm_weight: float = 0.0,
                 token_cap: int = 512, length_norm: float = 0.0):
        """``beam`` > 1 switches every slot to the batched device beam, with
        shallow fusion when ``lm_fn`` is an ``NGramLM`` or ``BiasingLM``
        (compiled to device tables as ``BeamStreamingSession(device=True)``
        compiles it); ``nbest(sid)`` ranks a slot's hypotheses."""
        self.model = model
        self.cfg = cfg = model.cfg
        self.device = model.device
        self.rt = runtime or model.runtime
        self.b = batch_size
        self.mesh = mesh
        self.beam = int(beam)
        if self.beam > 1:
            if mesh is not None:
                raise ValueError("beam serving is single-device: mesh "
                                 "sharding applies to the greedy engine")
            if engines is not None:
                raise ValueError("beam serving runs live-jit: AOT engine "
                                 "artifacts apply to the greedy engine")
        if engines is not None and mesh is not None:
            raise ValueError("AOT engines are single-device artifacts; "
                             "mesh-sharded serving uses the live jit "
                             "(GSPMD shardings are not serialized)")
        if mesh is not None:
            from trt_asr_tpu_torch.parallel.mesh import same_device

            dp = mesh.shape.get("dp", 1)
            if batch_size % dp != 0:
                raise ValueError(f"batch_size {batch_size} must divide over dp={dp} slots")
            # a one-device mesh is the model's device, where every state is
            # made; mesh.device() raises for a larger one
            if not same_device(mesh.device(), self.device):
                raise ValueError(f"the mesh's device {mesh.device()} is not the model's "
                                 f"({self.device})")
        self._engines = engines
        self._engine_key = None
        self.engine_hits = 0
        self.engine_misses = 0
        self.expansion_k = int(expansion_k)
        self.lm_fn = lm_fn
        self.lm_weight = float(lm_weight)
        self.token_cap = int(token_cap)
        self.length_norm = float(length_norm)
        self._lm_spec = self._lm_tables = None
        if self.beam > 1:
            if lm_fn is not None:
                from trt_asr_tpu_torch.decode.lm_device import to_device

                compiled = to_device(lm_fn, self.device)
                if compiled is None:
                    raise ValueError(
                        "batched beam supports lm_fn only for NGramLM / BiasingLM (compiled "
                        "to device tables); use a per-stream host BeamStreamingSession for "
                        "an arbitrary callable")
                self._lm_spec, self._lm_tables = compiled
        elif lm_fn is not None:
            raise ValueError("lm_fn requires beam > 1 (greedy decode cannot apply shallow "
                             "fusion)")
        self._frames = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
        self._tq = subsampled_length(self._frames, cfg.stride_stages) - cfg.drop_extra_pre_encoded
        self._pos_proj = precompute_pos_proj(model.params, cfg, self._tq, cfg.att_cache_size)
        self._punct_mask = (torch.as_tensor(model.punct_mask, device=self.device)
                            if self.rt.suppress_leading_punct else None)
        self._enc_state = init_encoder_state(cfg, batch_size, device=self.device)
        self._dec_state = self._fresh_decode_state()
        if self.beam > 1:
            self._beam_state = self._fresh_beam_state(self._dec_state)
            self._nbest: List[list] = [[] for _ in range(batch_size)]
            self._last_partial_toks: List[tuple] = [()] * batch_size
            self._sat_reported = [False] * batch_size
        self._active = [False] * batch_size
        self._mel = [StreamingLogMel(model.frontend) for _ in range(batch_size)]
        self._bufs = [np.zeros((0, cfg.feat_in), np.float32) for _ in range(batch_size)]
        self._scheds = [ChunkScheduler(cfg, unified=True) for _ in range(batch_size)]
        self._tokens: List[List[int]] = [[] for _ in range(batch_size)]
        self._token_frames: List[List[int]] = [[] for _ in range(batch_size)]
        self._token_durs: List[List[int]] = [[] for _ in range(batch_size)]
        self._token_logps: List[List[float]] = [[] for _ in range(batch_size)]
        self._frames_base = [0] * batch_size
        fs = model.frontend.spec
        self._enc_frame_s = fs.hop_length / fs.sample_rate_hz * cfg.subsampling_factor
        self._events: List[deque] = [deque() for _ in range(batch_size)]
        self._finalizing = [False] * batch_size
        self._finalized = [False] * batch_size
        self._segment = [0] * batch_size          # per-slot utterance counter
        self._last_partial_t = [0.0] * batch_size
        self._last_partial_len = [0] * batch_size
        self.step_latencies_ms: List[float] = []

    def _fresh_decode_state(self):
        return prime_decode_state(self.model.params, self.cfg,
                                  init_decode_state(self.cfg, self.b, device=self.device),
                                  self.model.prompt_ids)

    def _fresh_beam_state(self, dec_state):
        from trt_asr_tpu_torch.decode.beam_device import init_beam_device_state_batch

        return init_beam_device_state_batch(self.cfg, dec_state, beam=self.beam,
                                            token_cap=self.token_cap)

    def _row_mask(self, rows) -> torch.Tensor:
        mask = torch.zeros(self.b, dtype=torch.bool)
        mask[list(rows)] = True
        return mask.to(self.device)

    # -- stream lifecycle -------------------------------------------------

    def open_stream(self) -> int:
        for sid in range(self.b):
            if not self._active[sid]:
                self._reset_slot(sid)
                self._active[sid] = True
                return sid
        raise RuntimeError(f"all {self.b} stream slots busy")

    def close_stream(self, sid: int) -> None:
        self._active[sid] = False

    def _reset_slot(self, sid: int) -> None:
        mask = self._row_mask([sid])
        self._enc_state = reset_encoder_state_rows(self._enc_state, mask)
        self._dec_state = reset_decode_state_rows(self.model.params, self.cfg, self._dec_state,
                                                  mask, self.model.prompt_ids)
        if self.beam > 1:
            from trt_asr_tpu_torch.decode.beam_device import reset_beam_device_state_rows

            self._beam_state = reset_beam_device_state_rows(
                self._beam_state, mask, self.cfg, self._dec_state, beam=self.beam,
                token_cap=self.token_cap)
            self._nbest[sid] = []
            self._last_partial_toks[sid] = ()
            self._sat_reported[sid] = False
        self._mel[sid].reset()
        self._bufs[sid] = np.zeros((0, self.cfg.feat_in), np.float32)
        self._scheds[sid].reset()
        self._tokens[sid] = []
        self._token_frames[sid] = []
        self._token_durs[sid] = []
        self._token_logps[sid] = []
        self._frames_base[sid] = 0
        self._events[sid].clear()
        self._finalizing[sid] = False
        self._finalized[sid] = False
        self._segment[sid] += 1
        self._last_partial_t[sid] = 0.0
        self._last_partial_len[sid] = 0

    # -- input ------------------------------------------------------------

    def extract_features(self, sid: int, samples: np.ndarray) -> np.ndarray:
        """Stream sid's log-mel frames (its frontend carries the overlap)."""
        return self._mel[sid].push(np.asarray(samples, np.float32))

    def push_audio(self, sid: int, samples: np.ndarray) -> None:
        self.push_features(sid, self.extract_features(sid, samples))

    def push_features(self, sid: int, feats: np.ndarray) -> None:
        """As ``StreamingSession.push_features``: misuse surfaces as an ERROR
        event on the stream's queue (pushing to a closed stream or a wrong
        feature width also raises)."""
        if not self._active[sid]:
            self._error(sid, f"push to closed stream {sid}")
            raise RuntimeError(f"stream {sid} not open")
        if self._finalized[sid] or self._finalizing[sid]:
            self._error(sid, "push after finalize; reopen the slot")
            return
        if feats.size:
            feats = np.asarray(feats, np.float32)
            if feats.ndim != 2 or feats.shape[1] != self.cfg.feat_in:
                # the event's text and the exception's are JAX's, which differ
                self._error(sid, f"push_features: expected [T, {self.cfg.feat_in}], got "
                                 f"{feats.shape}")
                raise ValueError(f"push_features: expected [T, {self.cfg.feat_in}] features, "
                                 f"got {feats.shape}")
            self._bufs[sid] = np.concatenate([self._bufs[sid], feats], axis=0)

    def finalize_stream(self, sid: int) -> None:
        self._finalizing[sid] = True

    def _error(self, sid: int, msg: str) -> None:
        self._events[sid].append(Event(EventType.ERROR, self._segment[sid], error_message=msg))

    # -- the batched step -------------------------------------------------

    def _step_kwargs(self) -> dict:
        """The lockstep step's keywords: one source for step() and warmup()."""
        cfg = self.cfg
        return dict(drop_extra=cfg.drop_extra_pre_encoded,
                    max_tokens=cfg.max_symbols_per_timestep
                    * (self._frames // cfg.subsampling_factor + 1),
                    blank_penalty=self.rt.blank_penalty, punct_mask=self._punct_mask,
                    pos_proj=self._pos_proj, use_pallas_joint=self.rt.use_pallas_joint)

    def _beam_step_kwargs(self) -> dict:
        """The beam step's keywords: one source for step() and warmup(). The
        kernels stay off, as on every beam path."""
        cfg = self.cfg
        return dict(drop_extra=cfg.drop_extra_pre_encoded, beam=self.beam,
                    expansion_k=self.expansion_k, max_symbols=cfg.max_symbols_per_timestep,
                    blank_penalty=self.rt.blank_penalty, punct_mask=self._punct_mask,
                    pos_proj=self._pos_proj, lm_spec=self._lm_spec, lm_tables=self._lm_tables,
                    lm_weight=self.lm_weight)

    def _feed(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _step_args(self, feats, valid, emitted, cache_drop, valid_cap, enc=None, dec=None):
        """The lockstep step's positional arguments (host arrays in): the
        one source for step(), warmup() and the engine set's build
        (``runtime/engine.py`` ``batch_program_specs``)."""
        return (self.model, self._feed(feats), self._feed(valid),
                self._enc_state if enc is None else enc,
                self._dec_state if dec is None else dec, np.asarray(emitted, np.int32),
                self._feed(cache_drop), self._feed(valid_cap))

    def _count_engine(self, args, kwargs) -> None:
        """Count a lockstep step as a hit or a miss of the engine set. The
        step's signature is fixed for the engine's life: its key is
        computed once."""
        if self._engine_key is None:
            from trt_asr_tpu_torch.runtime.engine import program_key

            self._engine_key = program_key(args, kwargs)
        if self._engines.get(self._engine_key) is None:
            self.engine_misses += 1
        else:
            self.engine_hits += 1

    def warmup(self) -> float:
        """Run the lockstep step and the row resets once on scratch state,
        leaving the slots untouched: the kernels the step launches are built
        and loaded before the first client. Every scratch row holds a full
        chunk, since a step of empty rows decodes nothing and so would
        never reach the joint kernel. Returns wall seconds."""
        cfg = self.cfg
        t0 = time.perf_counter()
        mask = self._row_mask([0])
        enc = reset_encoder_state_rows(init_encoder_state(cfg, self.b, device=self.device), mask)
        dec = reset_decode_state_rows(self.model.params, cfg, self._fresh_decode_state(), mask,
                                      self.model.prompt_ids)
        args = self._step_args(np.zeros((self.b, self._frames, cfg.feat_in), np.float32),
                               np.full((self.b,), self._frames, np.int32),
                               np.zeros((self.b,), np.int32),
                               np.full((self.b,), cfg.cache_drop_size, np.int32),
                               np.full((self.b,), cfg.valid_out_len, np.int32), enc, dec)
        if self.beam > 1:
            _batch_beam_step(self.model, *args[1:3], enc, self._fresh_beam_state(dec),
                             *args[6:], **self._beam_step_kwargs())
        else:
            _batch_step(*args, **self._step_kwargs())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def pending(self) -> int:
        return sum(1 for sid in range(self.b) if self._active[sid] and self._peek_ready(sid))

    def _peek_ready(self, sid: int) -> bool:
        if self._scheds[sid].peek(self._bufs[sid].shape[0]) is not None:
            return True
        return self._finalizing[sid]

    def step(self) -> int:
        """One lockstep chunk over all ready streams, steady chunks and
        final-flush chunks in the same step. Returns the number of streams
        that made progress."""
        cfg = self.cfg
        feats = np.zeros((self.b, self._frames, cfg.feat_in), np.float32)
        valid = np.zeros((self.b,), np.int32)
        cache_drop = np.full((self.b,), cfg.cache_drop_size, np.int32)
        valid_cap = np.full((self.b,), cfg.valid_out_len, np.int32)
        progressed, flushing = [], []
        for sid in range(self.b):
            if not self._active[sid]:
                continue
            spec = self._scheds[sid].next_ready(self._bufs[sid].shape[0])
            if spec is None and self._finalizing[sid]:
                spec = self._scheds[sid].flush(self._bufs[sid].shape[0])
                if spec is None:
                    self._emit_final(sid)
                    continue
                cache_drop[sid] = 0          # keep-all flush semantics
                valid_cap[sid] = self._tq    # emit every valid step
                flushing.append(sid)
            if spec is None:
                continue
            feats[sid] = extract_chunk(self._bufs[sid], spec)
            valid[sid] = spec.valid_frames
            progressed.append(sid)
        if not progressed:
            return 0
        if self.rt.disable_cache:
            # as the session's nocache mode: the encoder caches start anew
            # before every chunk (the decode state persists), for all slots
            self._enc_state = reset_encoder_state_rows(self._enc_state,
                                                       self._row_mask(range(self.b)))
        t0 = time.perf_counter()
        if self.beam > 1:
            (self._enc_state, self._beam_state, out_len, n_best, toks_best,
             sat_live) = _batch_beam_step(
                self.model, self._feed(feats), self._feed(valid), self._enc_state,
                self._beam_state, self._feed(cache_drop), self._feed(valid_cap),
                rows=int(valid_cap[progressed].max()), **self._beam_step_kwargs())
            self.step_latencies_ms.append((time.perf_counter() - t0) * 1e3)
            for sid in progressed:
                # the ranked beam can rewrite earlier text: the transcript is
                # replaced by the 1-best, not appended to
                self._tokens[sid] = [int(x) for x in toks_best[sid, :n_best[sid]]]
                self._frames_base[sid] += int(out_len[sid])
                if sat_live[sid] and not self._sat_reported[sid]:
                    self._sat_reported[sid] = True
                    self._error(sid, f"device beam token_cap={self.token_cap} saturated: "
                                     "transcript truncated (head preserved); raise token_cap")
                if sid not in flushing:
                    self._maybe_partial(sid)
            for sid in flushing:
                self._emit_final(sid)
            return len(progressed)
        args = self._step_args(feats, valid, [len(t) for t in self._tokens], cache_drop,
                               valid_cap)
        kwargs = self._step_kwargs()
        if self._engines is not None:
            self._count_engine(args, kwargs)
        toks, n, self._enc_state, self._dec_state, stamps, out_len = _batch_step(*args, **kwargs)
        if self.rt.sabotage == "drop_time_carry":
            # the session's fault injection, on this surface too
            self._dec_state = self._dec_state._replace(
                time_carry=torch.zeros_like(self._dec_state.time_carry))
        toks, n = toks.numpy(), n.numpy()
        frames_b, durs_b, logps_b = (s.numpy() for s in stamps)
        out_len = out_len.cpu().numpy()
        self.step_latencies_ms.append((time.perf_counter() - t0) * 1e3)
        for sid in progressed:
            k = int(n[sid])
            if k:
                self._tokens[sid].extend(int(x) for x in toks[sid, :k])
                base = self._frames_base[sid]
                self._token_frames[sid].extend(base + int(f) for f in frames_b[sid, :k])
                self._token_durs[sid].extend(int(d) for d in durs_b[sid, :k])
                self._token_logps[sid].extend(float(c) for c in logps_b[sid, :k])
            self._frames_base[sid] += int(out_len[sid])
            if sid not in flushing:
                # as the session: the flush chunk emits FINAL_TEXT only
                self._maybe_partial(sid)
        for sid in flushing:
            self._emit_final(sid)
        return len(progressed)

    def _maybe_partial(self, sid: int) -> None:
        """The session's partial pacing: at most one PARTIAL a
        ``partial_min_interval_ms`` per stream, only when its tokens grew."""
        now = time.monotonic()
        if self.beam > 1:
            # content, not length: a re-ranked beam can rewrite the
            # transcript at constant length
            cur = tuple(self._tokens[sid])
            if (cur != self._last_partial_toks[sid]
                    and (now - self._last_partial_t[sid]) * 1e3 >= self.rt.partial_min_interval_ms):
                self._last_partial_t[sid] = now
                self._last_partial_toks[sid] = cur
                self._events[sid].append(Event(
                    EventType.PARTIAL_TEXT, self._segment[sid],
                    self.model.tokenizer.decode(self._tokens[sid]),
                    tokens=list(self._tokens[sid])))
            return
        if (len(self._tokens[sid]) != self._last_partial_len[sid]
                and (now - self._last_partial_t[sid]) * 1e3 >= self.rt.partial_min_interval_ms):
            self._last_partial_t[sid] = now
            self._last_partial_len[sid] = len(self._tokens[sid])
            self._events[sid].append(Event(
                EventType.PARTIAL_TEXT, self._segment[sid],
                self.model.tokenizer.decode(self._tokens[sid]), tokens=list(self._tokens[sid])))

    def _emit_final(self, sid: int) -> None:
        if not self._finalizing[sid]:
            return
        if self.beam > 1:
            # rank the slot's pool; the 1-best gives the transcript and the
            # emission stamps (the device state's frames are global)
            hyps = self._slot_finish(sid)
            self._nbest[sid] = hyps
            if hyps:
                best = hyps[0]
                self._tokens[sid] = list(best.tokens)
                self._token_frames[sid] = [f for f, _, _ in best.stamps]
                self._token_durs[sid] = [d for _, d, _ in best.stamps]
                self._token_logps[sid] = [lp for _, _, lp in best.stamps]
        self._finalizing[sid] = False
        self._finalized[sid] = True
        self._events[sid].append(Event(
            EventType.FINAL_TEXT, self._segment[sid],
            self.model.tokenizer.decode(self._tokens[sid]), tokens=list(self._tokens[sid])))

    def run_until_drained(self, max_steps: int = 10000) -> None:
        for _ in range(max_steps):
            if self.step() == 0:
                return

    # -- output -----------------------------------------------------------

    def poll_event(self, sid: int) -> Optional[Event]:
        return self._events[sid].popleft() if self._events[sid] else None

    def text(self, sid: int) -> str:
        return self.model.tokenizer.decode(self._tokens[sid])

    def _slot_finish(self, sid: int):
        from trt_asr_tpu_torch.decode.beam import BeamSearchState, beam_finish
        from trt_asr_tpu_torch.decode.beam_device import beam_device_row_to_hypotheses

        return beam_finish(BeamSearchState(active=beam_device_row_to_hypotheses(
            self._beam_state, sid)), beam=self.beam, length_norm=self.length_norm)

    def nbest(self, sid: int) -> List[tuple]:
        """Ranked (text, token_ids, score) of a beam stream: after finalize
        the finished n-best, mid-stream the current pool's order."""
        if self.beam <= 1:
            raise ValueError("nbest requires a beam>1 engine")
        hyps = self._nbest[sid] or self._slot_finish(sid)
        return [(self.model.tokenizer.decode(h.tokens), list(h.tokens), h.score) for h in hyps]

    def token_timestamps(self, sid: int) -> List[dict]:
        """Per-token [start_s, end_s] of a stream, as the session's."""
        from trt_asr_tpu_torch.decode.timestamps import token_intervals

        iv = token_intervals(self._token_frames[sid], self._token_durs[sid], self._enc_frame_s)
        return [{"token": int(t), "piece": self.model.tokenizer.token_at(int(t)),
                 "logp": round(lp, 4), **span}
                for t, lp, span in zip(self._tokens[sid], self._token_logps[sid], iv)]

    def word_timestamps(self, sid: int) -> List[dict]:
        from trt_asr_tpu_torch.decode.timestamps import word_intervals

        return word_intervals(self._tokens[sid], self._token_frames[sid], self._token_durs[sid],
                              self.model.tokenizer, self._enc_frame_s,
                              logps=self._token_logps[sid])
