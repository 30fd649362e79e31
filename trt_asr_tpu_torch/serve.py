"""Multi-client streaming ASR daemon over the lockstep ``BatchStreamingEngine``,
as the JAX package's ``serve.py`` on its greedy, single-device path: a TCP
server that multiplexes up to ``batch_size`` client streams through one
batched chunk step on the card.

    python -m trt_asr_tpu_torch.serve --model-dir DIR [--port 8057]
        [--batch-size 8] [--device cuda|cpu] [--no-warmup] [--engines DIR]
        [--beam N [--lm LM.json] [--lm-weight W] [--token-cap L]]

Runs on the CUDA device unless ``--device`` names another; without a card
it raises. ``--beam`` above 1 serves every slot with the engine's batched
device beam (``--lm``: an n-gram LM fused into it), and finals carry the
ranked ``nbest``. ``--engines DIR`` serves the lockstep step through an
engine set (``python -m trt_asr_tpu_torch.engine_build --batch N``): its
kernel libraries are bound from DIR, so the daemon runs no ``nvcc``.

Wire protocol: newline-delimited JSON, one connection per client stream.

  -> {"op": "open"}                                <- {"ok": true, "sid": N}
  -> {"op": "open", "continuous": true,
      "silence_s": 0.6, "energy_threshold": 0.01,
      "min_speech_s": 0.12, "preroll_s": 0.2}      <- {"ok": true, "sid": N}
  -> {"op": "push", "pcm": "<base64 f32le 16k>"}   <- {"ok": true}
  -> {"op": "push_features", "feats": "<base64 f32le [T,C]>", "frames": T}
  -> {"op": "finalize"}                            <- {"ok": true}
  -> {"op": "info"}                                <- {"ok": true, "info": ...}
  events (async, server->client):
     {"event": "partial"|"final"|"error", "segment": N, "text": ...,
      "tokens": [...]}
     finals also carry "words": [{word, start_s, end_s}], the TDT
     timestamps anchored at decode frames (decode/timestamps.py), and on
     a beam server "nbest": [{text, tokens, score}], best first.

Continuous clients run an ``EndpointDetector`` (streaming/continuous.py)
in their handler thread, on the host. Audio from a speech onset (with
pre-roll) to a sustained-silence endpoint flows into an engine slot; at
each endpoint the slot is finalized and swapped for a fresh one, and the
utterance arrives as
     {"event": "segment", "text": ..., "tokens": [...],
      "start_s": S, "end_s": E, "words": [...]}
with times on the stream's clock (words relative to the segment's start).
A finalize flushes a segment still in flight; its ack carries
{"total_segments": N}, the segment events this stream will have sent once
every retired slot drains, so a client can wait for exactly that many
(``transcribe_continuous`` does). A segment event is sent when the old
slot's flush drains, so it can arrive among the next segment's partials:
order segments by start_s.

Threads: all engine state is touched under one lock. A stepper thread runs
the lockstep step whenever a stream has a chunk ready and moves the events
onto per-stream outbound queues; it never writes a socket, so a stalled
client only grows its own queue, which its own sender thread drains.
Client handler threads run their slots' log-mel frontends outside the lock
(each slot's frontend has one owner) and take the lock to append features.
A step that fails is reported to every client, and the daemon serves on.
``start()`` runs the engine's warm-up before any thread starts, so that no
kernel is first built or loaded inside the stepper.
"""

from __future__ import annotations

import argparse
import base64
import json
import socket
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.device import resolve_device
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine
from trt_asr_tpu_torch.streaming.continuous import EndpointDetector
from trt_asr_tpu_torch.streaming.session import EventType

PROG = "trt-asr-tpu-torch-serve"


class AsrServer:
    def __init__(self, model: ParakeetTDT, batch_size: int = 8,
                 host: str = "127.0.0.1", port: int = 0,
                 runtime: Optional[RuntimeConfig] = None, engines=None, beam: int = 1,
                 lm_fn=None, lm_weight: float = 0.0, token_cap: int = 512):
        """``engines``: an ``EngineSet`` serving the lockstep step. ``beam``
        > 1: every slot runs the engine's batched device beam (with
        ``lm_fn`` an NGramLM or BiasingLM fused into it); FINAL events then
        carry the ranked ``nbest`` beside the 1-best."""
        self.engine = BatchStreamingEngine(model, batch_size=batch_size, runtime=runtime,
                                           engines=engines, beam=beam, lm_fn=lm_fn,
                                           lm_weight=lm_weight, token_cap=token_cap)
        self._elock = threading.Lock()      # serializes ALL engine access
        self._clients: Dict[int, socket.socket] = {}   # sid -> conn
        self._wlocks: Dict[int, threading.Lock] = {}   # per-conn write lock
        # per-sid outbound event queue and sender thread: the stepper never
        # touches a socket, so a slow client can only grow its own queue
        self._outq: Dict[int, "deque"] = {}
        self._outcv: Dict[int, threading.Condition] = {}
        self._finalizing: set = set()
        # continuous clients: sid -> {"det": EndpointDetector, "start": n,
        # "segments": k}, owned by that client's handler thread and moved to
        # the new sid at a rollover
        self._cont: Dict[int, dict] = {}
        # retired sid -> {"start_s", "end_s"}: a segment waiting for its
        # slot's FINAL event (sent by _drain_events)
        self._seg_pending: Dict[int, dict] = {}
        self._stop = threading.Event()
        self._srv = socket.create_server((host, port))
        self.addr = self._srv.getsockname()
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True),
            threading.Thread(target=self._step_loop, daemon=True),
        ]

    # -- lifecycle -------------------------------------------------------

    def start(self, warmup: bool = True) -> "AsrServer":
        if warmup:
            # build and load the step's kernels before accepting clients:
            # the first connection never waits for a build
            with self._elock:
                wall = self.engine.warmup()
            print(f"warmup: serving programs ready in {wall:.2f}s", flush=True)
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop accepting and stepping; waits (bounded) for a step in flight
        to end, so that no device work of this server outlives the call."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        stepper = self._threads[1]
        if stepper.is_alive() and stepper is not threading.current_thread():
            stepper.join(timeout_s)

    def serve_forever(self, warmup: bool = True) -> None:
        self.start(warmup=warmup)
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- accept / client handling ---------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._client_loop, args=(conn,), daemon=True).start()

    def _send(self, conn: socket.socket, obj: dict, sid: Optional[int] = None,
              lock: Optional[threading.Lock] = None) -> None:
        data = (json.dumps(obj) + "\n").encode()
        if lock is None:
            lock = self._wlocks.get(sid) if sid is not None else None
        try:
            if lock is not None:
                with lock:
                    conn.sendall(data)
            else:
                conn.sendall(data)
        except OSError:
            pass  # client gone; its stream is closed by _client_loop

    def _sender_loop(self, sid: int, conn: socket.socket) -> None:
        """Drains one stream's outbound queue to its socket, in a thread of
        its own. The write lock is taken once, as the queue is: a retired
        continuous slot's entries are popped while its last events are in
        flight, and those sends must still exclude the connection's other
        writers."""
        cv, q = self._outcv[sid], self._outq[sid]
        lock = self._wlocks.get(sid)
        while True:
            with cv:
                while not q:
                    cv.wait()
                item = q.popleft()
            if item is None:   # sentinel: client gone
                return
            self._send(conn, item, sid, lock=lock)

    def _enqueue(self, sid: int, obj: Optional[dict]) -> None:
        cv = self._outcv.get(sid)
        if cv is None:
            return
        with cv:
            self._outq[sid].append(obj)
            cv.notify()

    def _client_loop(self, conn: socket.socket) -> None:
        sid: Optional[int] = None
        buf = b""
        try:
            while not self._stop.is_set():
                chunk = conn.recv(1 << 16)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    sid = self._dispatch(conn, sid, line)
        except OSError:
            pass
        finally:
            if sid is not None:
                self._cont.pop(sid, None)
                with self._elock:
                    self._clients.pop(sid, None)
                    self._finalizing.discard(sid)
                    self.engine.close_stream(sid)
                self._enqueue(sid, None)   # stop the sender thread
                self._outq.pop(sid, None)
                self._outcv.pop(sid, None)
                self._wlocks.pop(sid, None)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, conn: socket.socket, sid: Optional[int],
                  line: bytes) -> Optional[int]:
        try:
            msg = json.loads(line)
            op = msg.get("op")
        except json.JSONDecodeError as e:
            self._send(conn, {"ok": False, "error": f"bad json: {e}"}, sid)
            return sid
        try:
            if op == "open":
                with self._elock:
                    new_sid = self.engine.open_stream()
                    self._clients[new_sid] = conn
                    self._wlocks[new_sid] = threading.Lock()
                    self._outq[new_sid] = deque()
                    self._outcv[new_sid] = threading.Condition()
                if msg.get("continuous"):
                    self._cont[new_sid] = {"det": EndpointDetector(
                        energy_threshold=float(msg.get("energy_threshold", 0.01)),
                        silence_s=float(msg.get("silence_s", 0.6)),
                        min_speech_s=float(msg.get("min_speech_s", 0.12)),
                        preroll_s=float(msg.get("preroll_s", 0.2))),
                        "start": 0, "segments": 0}
                threading.Thread(target=self._sender_loop, args=(new_sid, conn),
                                 daemon=True).start()
                self._send(conn, {"ok": True, "sid": new_sid}, new_sid)
                return new_sid
            if op == "info":
                self._send(conn, {"ok": True,
                                  "info": {"batch_size": self.engine.b,
                                           "n_mels": self.engine.cfg.feat_in}},
                           sid)
                return sid
            if sid is None:
                self._send(conn, {"ok": False, "error": "open a stream first"})
                return sid
            if op == "push":
                pcm = np.frombuffer(base64.b64decode(msg["pcm"]), np.float32)
                if sid in self._cont:
                    return self._push_continuous(conn, sid, pcm)
                # the slot's frontend runs outside the engine lock: this
                # handler thread is its only user
                feats = self.engine.extract_features(sid, pcm)
                with self._elock:
                    self.engine.push_features(sid, feats)
                self._send(conn, {"ok": True}, sid)
            elif op == "push_features":
                raw = np.frombuffer(base64.b64decode(msg["feats"]), np.float32)
                feats = raw.reshape(int(msg["frames"]), -1)
                with self._elock:
                    self.engine.push_features(sid, feats)
                self._send(conn, {"ok": True}, sid)
            elif op == "finalize":
                if sid in self._cont:
                    # continuous: flush a segment still in flight; the fresh
                    # slot stays open. The rollover can fail (slot capacity),
                    # so the detector is flushed only once it succeeded
                    det = self._cont[sid]["det"]
                    end = det.pending_end
                    if end is not None:
                        sid = self._segment_rollover(conn, sid, end)
                        det.flush()
                    # every rollover this client caused: it can wait for
                    # exactly that many segment events
                    self._send(conn, {"ok": True,
                                      "total_segments": self._cont[sid]["segments"]}, sid)
                    return sid
                with self._elock:
                    self.engine.finalize_stream(sid)
                    self._finalizing.add(sid)
                self._send(conn, {"ok": True}, sid)
            else:
                self._send(conn, {"ok": False, "error": f"unknown op {op!r}"}, sid)
        except Exception as e:  # noqa: BLE001 — the protocol's boundary: misuse
            # becomes an error reply and the daemon stays up for other streams
            self._send(conn, {"ok": False, "error": repr(e)}, sid)
        return sid

    # -- continuous clients ------------------------------------------------

    def _push_continuous(self, conn: socket.socket, sid: int, pcm: np.ndarray) -> int:
        """Run the client's endpoint detector over the audio; only speech
        (with pre-roll) reaches the slot. Returns the sid, which an endpoint
        moves to a fresh slot."""
        st = self._cont[sid]
        for kind, payload in st["det"].feed(pcm):
            if kind == "onset":
                audio, st["start"] = payload
            elif kind == "speech":
                audio = payload
            else:                       # endpoint
                sid = self._segment_rollover(conn, sid, payload)
                st = self._cont[sid]
                continue
            feats = self.engine.extract_features(sid, audio)
            with self._elock:
                self.engine.push_features(sid, feats)
        self._send(conn, {"ok": True}, sid)
        return sid

    def _segment_rollover(self, conn: socket.socket, old_sid: int, end_sample: int) -> int:
        """Finalize the current slot as one segment and give the client a
        fresh slot. _drain_events sends the segment when the old slot's
        flush drains (its FINAL event), with the times recorded here.

        A rollover holds two slots for a while (the retiring one until its
        flush drains, and the fresh one): size batch_size for it. The fresh
        slot is claimed first, so on a full server open_stream raises before
        anything changed, the client gets an error reply, and its detector
        and slot work on."""
        with self._elock:
            new_sid = self.engine.open_stream()   # may raise: state intact
            st = self._cont.pop(old_sid)
            st["segments"] += 1
            self.engine.finalize_stream(old_sid)
            self._seg_pending[old_sid] = {"start_s": st["start"] / 16000.0,
                                          "end_s": end_sample / 16000.0}
            self._clients[new_sid] = conn
            # both sids' sender threads write one socket: one lock
            self._wlocks[new_sid] = self._wlocks[old_sid]
            self._outq[new_sid] = deque()
            self._outcv[new_sid] = threading.Condition()
            self._cont[new_sid] = st
        threading.Thread(target=self._sender_loop, args=(new_sid, conn), daemon=True).start()
        return new_sid

    # -- the serving loop -------------------------------------------------

    def _step_loop(self) -> None:
        while not self._stop.is_set():
            advanced = 0
            try:
                with self._elock:
                    if self.engine.pending():
                        advanced = self.engine.step()
                    self._drain_events()
            except Exception as e:  # noqa: BLE001 — the stepper must survive a
                # failed step: report it on stderr and to every client, serve on
                print(f"{PROG}: step error: {e!r}", file=sys.stderr, flush=True)
                traceback.print_exc(file=sys.stderr)
                for sid in list(self._clients):
                    self._enqueue(sid, {"event": "error", "segment": -1, "text": "",
                                        "tokens": [], "error": f"server step failed: {e!r}"})
                time.sleep(0.5)
            if not advanced:
                time.sleep(0.005)

    def _drain_events(self) -> None:
        """Move each stream's events onto its outbound queue (the caller
        holds the engine lock; no socket I/O here, see _sender_loop)."""
        for sid in list(self._clients):
            while (ev := self.engine.poll_event(sid)) is not None:
                name = {EventType.PARTIAL_TEXT: "partial",
                        EventType.FINAL_TEXT: "final",
                        EventType.ERROR: "error"}[ev.type]
                if ev.type == EventType.FINAL_TEXT and sid in self._seg_pending:
                    # a continuous client's retired slot finished its flush:
                    # send the segment, then close the slot and its sender
                    # (the client already talks on a new sid)
                    meta = self._seg_pending.pop(sid)
                    self._enqueue(sid, {
                        "event": "segment", "text": ev.text, "tokens": list(ev.tokens),
                        "start_s": meta["start_s"], "end_s": meta["end_s"],
                        "words": self.engine.word_timestamps(sid)})
                    self.engine.close_stream(sid)
                    self._clients.pop(sid, None)
                    self._enqueue(sid, None)
                    self._outq.pop(sid, None)
                    self._outcv.pop(sid, None)
                    self._wlocks.pop(sid, None)   # the shared lock lives on
                    break
                out = {"event": name, "segment": ev.segment_id, "text": ev.text,
                       "tokens": list(ev.tokens)}
                if ev.type == EventType.ERROR:
                    out["error"] = ev.error_message
                if ev.type == EventType.FINAL_TEXT and sid in self._finalizing:
                    out["words"] = self.engine.word_timestamps(sid)
                    if self.engine.beam > 1:
                        out["nbest"] = [{"text": txt, "tokens": ids, "score": sc}
                                        for txt, ids, sc in self.engine.nbest(sid)]
                    self._finalizing.discard(sid)
                self._enqueue(sid, out)


# -- client helper --------------------------------------------------------


class _Client:
    """Blocking client core: connect, the open handshake, base64 pushes in
    chunks with each ack checked, events routed to a callback, and cleanup
    (the socket and its makefile dup must both close, or the server never
    sees EOF and the slot leaks)."""

    def __init__(self, host: str, port: int, timeout_s: float, open_msg: dict, on_event):
        self.conn = socket.create_connection((host, port), timeout=timeout_s)
        self.f = self.conn.makefile("rwb")
        self.on_event = on_event
        self.send(open_msg)
        r = self.recv()
        if not r.get("ok"):
            self.close()
            raise RuntimeError(r.get("error", "open failed"))

    def send(self, obj: dict) -> None:
        self.f.write((json.dumps(obj) + "\n").encode())
        self.f.flush()

    def recv(self) -> dict:
        line = self.f.readline()
        if not line:
            raise ConnectionError("server closed")
        return json.loads(line)

    def recv_routed(self) -> Optional[dict]:
        """One message: events go to on_event (errors raise), acks are
        returned once checked."""
        r = self.recv()
        if r.get("event") == "error":
            raise RuntimeError(f"stream error: {r.get('error', r)}")
        if "event" in r:
            self.on_event(r)
            return None
        if not r.get("ok", False):
            raise RuntimeError(r.get("error", f"request rejected: {r}"))
        return r

    def request(self, obj: dict) -> dict:
        """Send an op; route events until its ack arrives."""
        self.send(obj)
        while True:
            ack = self.recv_routed()
            if ack is not None:
                return ack

    def push_all(self, audio: np.ndarray, chunk_samples: int) -> None:
        audio = np.asarray(audio, np.float32)
        for s in range(0, len(audio), chunk_samples):
            self.request({"op": "push", "pcm": base64.b64encode(
                audio[s:s + chunk_samples].tobytes()).decode()})

    def close(self) -> None:
        try:
            self.f.close()
        except OSError:
            pass
        try:
            self.conn.close()
        except OSError:
            pass


def transcribe(host: str, port: int, audio: np.ndarray, chunk_samples: int = 8000,
               timeout_s: float = 300.0) -> dict:
    """Blocking client: stream ``audio`` (16 kHz f32) and return {"text",
    "tokens", "words", "partials"} from the stream's final event, and its
    "nbest" on a beam server."""
    partials = []
    final: List[dict] = []

    def on_event(r):
        if r.get("event") == "final":
            final.append(r)
        else:
            partials.append(r)

    cli = _Client(host, port, timeout_s, {"op": "open"}, on_event)
    try:
        cli.push_all(audio, chunk_samples)
        cli.request({"op": "finalize"})
        deadline = time.monotonic() + timeout_s
        while not final and time.monotonic() < deadline:
            cli.recv_routed()
    finally:
        cli.close()
    if not final:
        raise TimeoutError("no final event")
    out = {"text": final[0]["text"], "tokens": final[0]["tokens"],
           "words": final[0].get("words", []), "partials": partials}
    if "nbest" in final[0]:          # a beam server: the ranked hypotheses
        out["nbest"] = final[0]["nbest"]
    return out


def transcribe_continuous(host: str, port: int, audio: np.ndarray, chunk_samples: int = 8000,
                          timeout_s: float = 300.0, *, n_segments: Optional[int] = None,
                          **open_kw) -> list:
    """Blocking client of a continuous stream: push ``audio`` through a
    ``{"op": "open", "continuous": true}`` stream (``open_kw``: silence_s,
    energy_threshold, min_speech_s, preroll_s), flush, and return the
    segment events sorted by start_s. The finalize ack's total_segments
    says how many segment events to wait for (retired slots flush
    asynchronously); ``n_segments`` sets another count."""
    segments: List[dict] = []
    cli = _Client(host, port, timeout_s, {"op": "open", "continuous": True, **open_kw},
                  lambda r: segments.append(r) if r.get("event") == "segment" else None)
    try:
        cli.push_all(audio, chunk_samples)
        ack = cli.request({"op": "finalize"})
        want = n_segments if n_segments is not None else int(ack.get("total_segments", 0))
        deadline = time.monotonic() + timeout_s
        while len(segments) < want:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(segments)}/{want} segments before timeout")
            cli.recv_routed()
    finally:
        cli.close()
    segments.sort(key=lambda m: m["start_s"])
    return segments


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog=PROG, description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8057)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--model-dir", default="")
    ap.add_argument("--synthetic-model", choices=["tiny", "full"], default="",
                    help="random weights (seed 0) at ModelConfig.tiny() or ModelConfig()")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip building and loading the step's kernels at startup")
    ap.add_argument("--engines", default="",
                    help="engine set dir (python -m trt_asr_tpu_torch.engine_build --batch N): "
                         "the lockstep step through its program, its kernel libraries bound "
                         "from there; a signature miss runs the live step")
    ap.add_argument("--beam", type=int, default=1,
                    help="beam width > 1 serves every slot with the batched device beam "
                         "(n-best on FINAL events)")
    ap.add_argument("--lm", default="",
                    help="n-gram LM json (ngram-lm/v1) fused into the device beam; "
                         "requires --beam > 1")
    ap.add_argument("--lm-weight", type=float, default=0.6, help="fusion weight for --lm")
    ap.add_argument("--token-cap", type=int, default=512,
                    help="device beam's token buffer per hypothesis")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rt = RuntimeConfig.from_env()
    if args.model_dir:
        model = ParakeetTDT.from_model_dir(args.model_dir, runtime=rt, device=device)
    elif args.synthetic_model:
        cfg = ModelConfig.tiny() if args.synthetic_model == "tiny" else ModelConfig()
        model = ParakeetTDT.random(cfg, runtime=rt, device=device)
    else:
        ap.error("provide --model-dir or --synthetic-model")
    engines = None
    if args.engines:
        from trt_asr_tpu_torch.runtime.engine import EngineSet

        engines = EngineSet.load(args.engines, runtime=rt)
        print(f"{PROG} engines: {len(engines)} programs, "
              f"{len(engines.manifest['libraries'])} kernel libraries bound from "
              f"{args.engines}", flush=True)
    lm_fn = None
    if args.lm:
        from trt_asr_tpu_torch.decode.ngram_lm import NGramLM

        lm_fn = NGramLM.load(args.lm)
    srv = AsrServer(model, batch_size=args.batch_size, host=args.host, port=args.port,
                    runtime=rt, engines=engines, beam=args.beam, lm_fn=lm_fn,
                    lm_weight=args.lm_weight, token_cap=args.token_cap)
    print(f"{PROG} listening on {srv.addr[0]}:{srv.addr[1]} "
          f"(batch_size={args.batch_size}, device={device}"
          + (f", beam={args.beam}" if args.beam > 1 else "") + ")", flush=True)
    srv.serve_forever(warmup=not args.no_warmup)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
