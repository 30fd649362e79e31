"""Streaming beam-search session: n-best decoding over the live stream, as
the JAX package's ``streaming/beam_session.py``.

The TDT beam is advanced chunk by chunk with the streaming encoder,
carrying the hypothesis pool (scores, prefixes, per-branch predictor
states, time cursors) across pushes. A duration jump past a chunk's last
frame leaves a hypothesis waiting for later frames.

Per chunk, the streaming encoder step runs as in the greedy session (same
caches, schedule and chunk prologue, ``StreamingSession._chunk_inputs``)
and its output feeds one of two searches:

- host mode (default): the host beam (``decode/beam.py``) over the joint
  and predictor on the device, one call a frontier step;
- ``device=True``: the device beam (``decode/beam_device.py``) consumes the
  encoder rows in place, with no host round trip inside the search; only
  the small carried state is read back for partials. Its n-best equals
  the host search's.

The kernels (``use_pallas_*``) do not apply here: the beam encoder and
joint run the plain path, as the JAX beam path does. Of the debug surface
the beam session has what the JAX one has: the taps (through the
parent's ``push_audio``/``push_features``), stage and slow-chunk markers,
the NaN guard on the attention cache and the profiler capture. Partials carry the
current best hypothesis, which may rewrite earlier text when the ranking
flips; ``stable_text`` is the prefix no re-ranking can change. beam=1
reproduces the greedy session's tokens.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from trt_asr_tpu_torch.debug.nan_guard import check_finite
from trt_asr_tpu_torch.debug.stage_markers import stage_marker
from trt_asr_tpu_torch.decode.beam import (BeamSearchState, beam_advance, beam_best,
                                           beam_finish, beam_stable_prefix, beam_start,
                                           make_host_fns)
from trt_asr_tpu_torch.models.parakeet.encoder import encode
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.session import Event, EventType, StreamingSession


class BeamStreamingSession(StreamingSession):
    """StreamingSession with the TDT beam as the decoder: the same input
    surface (push_audio/push_features/finalize/poll_event) and chunk
    schedule; ``nbest()`` returns the ranked hypotheses."""

    def __init__(self, model: ParakeetTDT, *, beam: int = 4, expansion_k: int = 4,
                 length_norm: float = 0.0,
                 lm_fn: Optional[Callable[[List[int], int], float]] = None,
                 lm_weight: float = 0.0, device: bool = False, token_cap: int = 512, **kw):
        """``device=True`` runs the search on the device. An ``NGramLM`` or
        ``BiasingLM`` ``lm_fn`` compiles into device tables
        (``decode/lm_device.py``); any other callable needs the host beam.
        ``token_cap`` bounds the device search's per-hypothesis token
        buffers (the host beam's are unbounded)."""
        self.beam = int(beam)
        self.expansion_k = int(expansion_k)
        self.length_norm = float(length_norm)
        self.lm_fn = lm_fn
        self.lm_weight = float(lm_weight)
        self.on_device = bool(device)
        self.token_cap = int(token_cap)
        self._lm_spec = self._lm_tables = None
        if self.on_device and lm_fn is not None:
            from trt_asr_tpu_torch.decode.lm_device import to_device

            compiled = to_device(lm_fn, model.device)
            if compiled is None:
                raise ValueError(
                    "device beam supports lm_fn only for NGramLM / BiasingLM (compiled "
                    "to device tables); use device=False for an arbitrary host callable")
            self._lm_spec, self._lm_tables = compiled
        self._nbest_hyps = []
        k = self.expansion_k if self.beam > 1 else 1
        self._joint_fn, self._predictor_fn, self._joint_batch_fn = make_host_fns(
            model.params, model.device, joint_rows=self.beam, pred_rows=self.beam * k)
        super().__init__(model, **kw)

    # -- lifecycle ------------------------------------------------------

    def reset_utterance(self) -> None:
        super().reset_utterance()
        ds = self._dec_state   # prompt-primed by the parent's reset
        if self.on_device:
            from trt_asr_tpu_torch.decode.beam_device import init_beam_device_state

            self._dev_state = init_beam_device_state(self.cfg, ds, beam=self.beam,
                                                     token_cap=self.token_cap)
            self._beam_state = BeamSearchState()
        else:
            self._beam_state = beam_start(ds.g[0].cpu().numpy(), int(ds.y_id[0]),
                                          (ds.h, ds.c), emitted_so_far=0)
        self._nbest_hyps = []
        self._sat_reported = False   # the token_cap ERROR, once an utterance
        # () and not None: the no-tokens-yet state equals an empty decode,
        # so the first push emits no empty partial (nor does greedy)
        self._last_partial_tokens: Tuple[int, ...] = ()

    def snapshot(self) -> dict:
        raise NotImplementedError(
            "beam sessions carry a hypothesis pool; snapshot/restore (stream "
            "migration) is a greedy-session feature")

    def restore(self, snap: dict) -> None:
        raise NotImplementedError(
            "beam sessions carry a hypothesis pool; snapshot/restore (stream "
            "migration) is a greedy-session feature")

    # -- internals --------------------------------------------------------

    def _run_chunk(self, spec, is_last: bool) -> None:
        cfg, rt = self.cfg, self.rt
        stage_marker(rt, f"beam chunk {spec.idx} enter [{self._debug_ctx}]")
        if self._profiler is not None:
            self._profiler.chunk_start()
        t0 = time.perf_counter()
        x, valid, pos_proj, _ = self._chunk_inputs(spec, kernels=False)
        lengths = torch.full((1,), valid, dtype=torch.int32, device=self.device)
        enc, out_len, self._enc_state = encode(
            self.model.params, cfg, x, lengths, self._enc_state, drop_extra=spec.drop_extra,
            cache_drop=0 if is_last else cfg.cache_drop_size,
            valid_cap=None if is_last else cfg.valid_out_len, pos_proj=pos_proj,
            layers=self.model.layers)
        if self.on_device:
            from trt_asr_tpu_torch.decode.beam_device import tdt_beam_chunk_device

            # a steady chunk emits at most valid_out_len rows: the search
            # reads no row past them (rows past out_len are no-ops anyway)
            rows = enc.shape[1] if is_last else min(enc.shape[1], cfg.valid_out_len)
            self._dev_state = st = tdt_beam_chunk_device(
                self.model.params, cfg, enc[0, :rows], out_len[0], self._dev_state,
                beam=self.beam, expansion_k=self.expansion_k,
                max_symbols=cfg.max_symbols_per_timestep,
                blank_penalty=rt.blank_penalty, punct_mask=self._punct_mask,
                use_punct_mask=rt.suppress_leading_punct, lm_spec=self._lm_spec,
                lm_tables=self._lm_tables, lm_weight=self.lm_weight)
            # the 1-best, the saturation flag and out_len in one read-back
            best = torch.argmax(st.score)
            sat_live = (st.sat & torch.isfinite(st.score)).any()
            head = torch.stack([st.n_tok[best].to(torch.int32), sat_live.to(torch.int32),
                                out_len[0].to(torch.int32)])
            got = torch.cat([head, st.tokens[best].to(torch.int32)]).cpu().tolist()
            n, sat_live, t_out = got[:3]
            self._tokens = got[3:3 + n]
            # token_cap overflow: the search runs on with head-preserved
            # truncated buffers; a live saturated hypothesis is reported once
            if not self._sat_reported and sat_live:
                self._sat_reported = True
                self._error(
                    f"device beam token_cap={self.token_cap} saturated: transcript "
                    "truncated (head preserved); raise token_cap or decode with the "
                    "host beam (device=False)")
        else:
            t_out = int(out_len[0])
            punct_ids = (set(np.flatnonzero(self.model.punct_mask).tolist())
                         if rt.suppress_leading_punct else None)
            self._beam_state = beam_advance(
                self._beam_state, enc[0, :t_out].cpu().numpy(), self._joint_fn,
                self._predictor_fn, blank_id=cfg.blank_id,
                token_head_size=cfg.token_head_size, duration_values=cfg.duration_values,
                beam=self.beam, expansion_k=self.expansion_k,
                max_symbols=cfg.max_symbols_per_timestep, blank_penalty=rt.blank_penalty,
                punct_token_ids=punct_ids, lm_fn=self.lm_fn, lm_weight=self.lm_weight,
                joint_batch_fn=self._joint_batch_fn)
            best = beam_best(self._beam_state)
            self._tokens = list(best.tokens) if best is not None else []
        self._frames_base += t_out
        ms = (time.perf_counter() - t0) * 1e3
        self._chunk_latencies_ms.append(ms)
        if ms > rt.slow_step_ms:
            stage_marker(rt, f"SLOW beam chunk {spec.idx}: {ms:.1f} ms", force=True)
        if rt.nan_guard:
            check_finite(self._enc_state.att_cache, "att_cache", halt=rt.nan_guard_halt)
        if self._profiler is not None:
            self._profiler.chunk_end()
        stage_marker(rt, f"beam chunk {spec.idx} exit "
                         f"({ms:.1f} ms, {len(self._tokens)} tokens best)")

    def _maybe_partial(self) -> None:
        # content-based change detection: a re-ranked beam can rewrite the
        # transcript at constant length, which a length check would miss
        now = time.monotonic()
        cur = tuple(self._tokens)
        if (cur != self._last_partial_tokens
                and (now - self._last_partial_t) * 1e3 >= self.rt.partial_min_interval_ms):
            self._last_partial_t = now
            self._last_partial_tokens = cur
            with self._lock:
                self._events.append(Event(EventType.PARTIAL_TEXT, self._segment,
                                          self.model.tokenizer.decode(self._tokens),
                                          tokens=list(self._tokens)))

    # -- results ----------------------------------------------------------

    def _host_pool(self) -> BeamSearchState:
        """The active pool as host Hypothesis objects (read from the device
        in device mode), so that finish, n-best and the stable prefix share
        one implementation."""
        if self.on_device:
            from trt_asr_tpu_torch.decode.beam_device import beam_device_to_hypotheses

            return BeamSearchState(active=beam_device_to_hypotheses(self._dev_state))
        return self._beam_state

    def finalize(self) -> None:
        """End of utterance: flush the final short chunk, rank the pool and
        emit FINAL_TEXT for the 1-best; ``nbest()`` has the whole list."""
        if self._finalized:
            return
        spec = self._sched.flush(self._feat_buf.shape[0])
        if spec is not None:
            self._run_chunk(spec, is_last=True)
        self._nbest_hyps = beam_finish(self._host_pool(), beam=self.beam,
                                       length_norm=self.length_norm)
        self._tokens = list(self._nbest_hyps[0].tokens) if self._nbest_hyps else []
        if self._nbest_hyps:
            # the 1-best's emission stamps feed token_timestamps() and
            # word_timestamps() (the beam's frames are global already)
            stamps = self._nbest_hyps[0].stamps
            self._token_frames = [f for f, _, _ in stamps]
            self._token_durs = [d for _, d, _ in stamps]
            self._token_logps = [lp for _, _, lp in stamps]
        self._finalized = True
        self._close_debug()
        with self._lock:
            self._events.append(Event(EventType.FINAL_TEXT, self._segment,
                                      self.model.tokenizer.decode(self._tokens),
                                      tokens=list(self._tokens)))

    @property
    def stable_text(self) -> str:
        """The committed transcript prefix: every future hypothesis descends
        from an active one, so the token prefix all active hypotheses share
        is never rewritten. After finalize the whole 1-best is committed."""
        if self._finalized:
            return self.text
        return self.model.tokenizer.decode(beam_stable_prefix(self._host_pool()))

    def nbest(self) -> List[Tuple[str, List[int], float]]:
        """Ranked (text, token_ids, score): after finalize the finished
        n-best, mid-stream the current pool's order."""
        hyps = (self._nbest_hyps if self._nbest_hyps
                else beam_finish(self._host_pool(), beam=self.beam,
                                 length_norm=self.length_norm))
        return [(self.model.tokenizer.decode(h.tokens), list(h.tokens), h.score) for h in hyps]
