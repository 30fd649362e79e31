"""Python side of the C-ABI bridge, as the JAX package's
``runtime/capi_bridge.py``: the functions the port's native runtime calls
through its embedded interpreter (``native/src/backend_python.cpp``, which
imports this module by name), each taking the session object the C++ side
holds.

Models are cached by model directory (and device) under a lock, so sessions
share weights. The device is :func:`~trt_asr_tpu_torch.runtime.platform.
requested_device`'s: the card unless the environment asks for the CPU
(``JAX_PLATFORMS=cpu``); without a card and without that request, creating
a session raises, where JAX's bridge falls back to the CPU.
``TRT_ASR_BEAM`` > 0 selects the streaming beam session.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import numpy as np

_models: Dict[tuple, object] = {}
_lock = threading.Lock()


class _BridgeSession:
    def __init__(self, model_dir: str):
        from trt_asr_tpu_torch.config import RuntimeConfig
        from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
        from trt_asr_tpu_torch.runtime.platform import requested_device
        from trt_asr_tpu_torch.streaming.session import StreamingSession

        device = requested_device()
        with _lock:
            model = _models.get((model_dir, str(device)))
            if model is None:
                model = ParakeetTDT.from_model_dir(model_dir, device=device)
                _models[(model_dir, str(device))] = model
        self.model = model
        rt = RuntimeConfig.from_env()
        if rt.beam_width > 0:
            # the native surface's beam: FinalText carries the 1-best
            from trt_asr_tpu_torch.streaming.beam_session import BeamStreamingSession

            self.session = BeamStreamingSession(
                model, beam=rt.beam_width, runtime=rt, feature_norm="none")
        else:
            self.session = StreamingSession(model, rt, feature_norm="none")


def create_session(model_dir: str) -> _BridgeSession:
    return _BridgeSession(model_dir)


def destroy_session(s: _BridgeSession) -> None:
    s.session = None


def reset_session(s: _BridgeSession) -> None:
    s.session.reset_utterance()


def n_mels(s: _BridgeSession) -> int:
    return int(s.model.cfg.feat_in)


def push_features(s: _BridgeSession, buf, frames: int) -> int:
    feats = np.frombuffer(buf, dtype=np.float32).reshape(frames, -1)
    return int(s.session.push_features(feats))


def finalize(s: _BridgeSession) -> None:
    s.session.finalize()


def poll_event(s: _BridgeSession) -> Optional[Tuple[int, int, str, str]]:
    ev = s.session.poll_event()
    if ev is None:
        return None
    return (int(ev.type), int(ev.segment_id), ev.text, ev.error_message)


def stable_text(s: _BridgeSession) -> str:
    """Committed transcript prefix (the C ABI's trt_asr_stable_text): the
    whole transcript of a greedy session, the hypothesis pool's common
    prefix of a beam session."""
    return s.session.stable_text


def word_timestamps_tsv(s: _BridgeSession) -> str:
    """Word timings as TSV lines ``start_s\\tend_s\\tlogp\\tword`` (the C
    ABI's trt_asr_word_timestamps payload; logp is the word's decode-time
    log-probability)."""
    return "".join(
        f"{w['start_s']:.4f}\t{w['end_s']:.4f}\t{w.get('logp', 0.0):.4f}\t{w['word']}\n"
        for w in s.session.word_timestamps())
