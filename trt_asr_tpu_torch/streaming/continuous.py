"""Continuous transcription: energy endpointing over an endless stream, as
the JAX package's ``streaming/continuous.py`` on the greedy path.

- ``EndpointDetector``: the hop-level state machine. Each 10 ms hop's RMS
  is held against an absolute threshold, with run-length hysteresis at
  onset and offset and a pre-roll ring, so that the first phones are kept.
  Host code, no model; ``is_speech_fn`` takes another speech test. The
  serving daemon (``serve.py``) runs one for each continuous client.
- ``ContinuousTranscriber``: a session behind a detector. Speech hops go
  to the session; at a sustained silence it finalizes the segment, records
  it with its times on the stream's clock, resets the session and listens
  on. Each segment is token-exact with a dedicated session fed the same
  samples.

The session sees only the samples from a segment's start (pre-roll
included) to its endpoint, so each segment keeps the session's invariance
to push sizes. ``feature_norm="per_feature"`` needs the whole utterance's
statistics and is refused, as the batch engine's audio slots refuse it.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

from trt_asr_tpu_torch.streaming.session import StreamingSession

HOP = 160          # 10 ms at 16 kHz: the mel hop


class EndpointDetector:
    """Feed audio of any size; get back an ordered list of events:

    ("onset",    (audio, start_sample)): speech began; audio is the
                                         pre-roll and the onset's hops
    ("speech",   hop_audio):             in-speech hops to forward
    ("endpoint", end_sample):            sustained silence; segment over

    Events fall at absolute hop positions (a part of a hop is carried to
    the next feed), so they do not depend on the push sizes."""

    def __init__(self, *, energy_threshold: float = 0.01,
                 silence_s: float = 0.6, min_speech_s: float = 0.12,
                 preroll_s: float = 0.2,
                 is_speech_fn: Optional[Callable[[np.ndarray], bool]] = None):
        self._is_speech = is_speech_fn or (
            lambda hop: float(np.sqrt(np.mean(hop ** 2))) > energy_threshold)
        self._need_on = max(1, int(min_speech_s * 16000 / HOP))
        self._need_off = max(1, int(silence_s * 16000 / HOP))
        # the ring holds the whole onset run and the pre-roll: sized for the
        # pre-roll alone, min_speech_s > preroll_s would drop onset hops
        self._preroll: deque = deque(
            maxlen=self._need_on + max(1, int(preroll_s * 16000 / HOP)))
        self._carry = np.zeros(0, np.float32)
        self._pos = 0                       # absolute sample of the next hop
        self.in_speech = False
        self._on_run = 0
        self._off_run = 0

    def feed(self, samples: np.ndarray) -> List[Tuple[str, object]]:
        buf = np.concatenate([self._carry, np.asarray(samples, np.float32)])
        n_hops = len(buf) // HOP
        events: List[Tuple[str, object]] = []
        run: List[np.ndarray] = []   # in-speech hops of this feed, sent as one
                                     # event (one feature extraction a feed)
        for k in range(n_hops):
            hop = buf[k * HOP:(k + 1) * HOP]
            speech = self._is_speech(hop)
            if not self.in_speech:
                self._on_run = self._on_run + 1 if speech else 0
                self._preroll.append(hop)
                if self._on_run >= self._need_on:
                    self.in_speech = True
                    self._off_run = 0
                    pre = list(self._preroll)
                    self._preroll.clear()
                    start = self._pos - (len(pre) - 1) * HOP
                    events.append(("onset", (np.concatenate(pre), start)))
            else:
                run.append(hop)
                self._off_run = 0 if speech else self._off_run + 1
                if self._off_run >= self._need_off:
                    events.append(("speech", np.concatenate(run)))
                    run = []
                    events.append(("endpoint", self._pos + HOP))
                    self.in_speech = False
                    self._on_run = 0
                    self._off_run = 0
            self._pos += HOP
        if run:
            events.append(("speech", np.concatenate(run)))
        self._carry = buf[n_hops * HOP:]
        return events

    @property
    def pending_end(self) -> Optional[int]:
        """The end sample a ``flush()`` would report, or None when no speech
        is in flight, without changing state: the daemon's slot rollover can
        fail, so it reads this first and flushes only once it succeeded."""
        return self._pos if self.in_speech else None

    def flush(self) -> Optional[int]:
        """End of stream: the end sample of the speech in flight, if any,
        and back to listening. The end is that of the last hop forwarded,
        so a re-decode of [start_s, end_s) sees exactly the samples the
        session saw (a carried part of a hop reached neither)."""
        if not self.in_speech:
            return None
        self.in_speech = False
        self._on_run = 0
        self._off_run = 0
        return self._pos


class ContinuousTranscriber:
    def __init__(self, session: StreamingSession, *,
                 energy_threshold: float = 0.01,
                 silence_s: float = 0.6,
                 min_speech_s: float = 0.12,
                 preroll_s: float = 0.2,
                 is_speech_fn: Optional[Callable[[np.ndarray], bool]] = None):
        if session.feature_norm == "per_feature":
            raise ValueError(
                "continuous mode streams unbounded audio; per_feature norm "
                "needs full-utterance stats (contract: "
                "normalize_requires_full_utterance)")
        self.session = session
        self._det = EndpointDetector(
            energy_threshold=energy_threshold, silence_s=silence_s,
            min_speech_s=min_speech_s, preroll_s=preroll_s,
            is_speech_fn=is_speech_fn)
        self._seg_start = 0
        self.segments: List[dict] = []

    def push_audio(self, samples: np.ndarray) -> int:
        """Feed any amount of audio; returns the segments it finalized."""
        done = 0
        for kind, payload in self._det.feed(samples):
            if kind == "onset":
                audio, self._seg_start = payload
                self.session.push_audio(audio)
            elif kind == "speech":
                self.session.push_audio(payload)
            else:
                self._endpoint(payload)
                done += 1
        return done

    def _endpoint(self, end_sample: int) -> None:
        s = self.session
        s.finalize()
        self.segments.append({
            "text": s.text,
            "tokens": s.tokens,
            "start_s": self._seg_start / 16000.0,
            "end_s": end_sample / 16000.0,
            "words": s.word_timestamps(),
        })
        # the segments are the result; drain the session's events so that
        # none of them leaks into the next segment
        while s.poll_event() is not None:
            pass
        s.reset_utterance()

    def flush(self) -> int:
        """End of stream: finalize a segment still in flight."""
        end = self._det.flush()
        if end is not None:
            self._endpoint(end)
            return 1
        return 0
