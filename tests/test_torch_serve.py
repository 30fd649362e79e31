"""The PyTorch port's serving daemon (``serve.py``) against the JAX package's
on ``ModelConfig.tiny()``, the same weights on both sides: concurrent TCP
clients multiplexed through one lockstep engine transcribe exactly as the
port's engine and the JAX engine driven directly (tokens, text, words);
the JSON replies to malformed and over-capacity requests equal the JAX
daemon's; continuous clients get one segment event a speech span, a
rollover on a full server is an error reply the client survives, many
rollovers leak no slot, and ``transcribe_continuous`` returns the ordered
segments. These mirror ``tests/test_serve.py``. A beam
daemon (``beam=4``, with and without an n-gram LM) sends JAX's ranked
``nbest`` on its finals, in process and as a subprocess with ``--beam
--lm --lm-weight --token-cap``.
Also: the engine's warm-up reaches the joint kernel before any thread
starts, ``_batch_step`` passes the FFN and conv flags to the encoder, the
entry point refuses the CPU unless asked, serves from an engine set
(``--engines``), and serves as a subprocess importing nothing of JAX.

Every socket has a timeout, every server is stopped in a ``finally`` and
every join is bounded. Tolerance: none; tokens, texts, words, times and
replies are exact."""

import base64
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import np_tree, spy_calls, one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.serve import AsrServer as JServer
from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine as JEngine
from trt_asr_tpu_torch import serve
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.decode import greedy_loop
from trt_asr_tpu_torch.models.parakeet import encoder
from trt_asr_tpu_torch.models.parakeet.encoder import init_encoder_state
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.serve import AsrServer, transcribe, transcribe_continuous
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine, _batch_step
from trt_asr_tpu_torch.tokenizer import Tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RT = dict(suppress_leading_punct=False)


@pytest.fixture(scope="module")
def models():
    jm = JModel.random(JConfig.tiny(), seed=5)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params),
                     Tokenizer(list(jm.tokenizer.vocab), blank_id=jm.cfg.blank_id),
                     runtime=RuntimeConfig(), device="cpu")
    return jm, pm


def _audio(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * (250 + 30 * seed) * t / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _direct(model, audio, engine_cls=BatchStreamingEngine, rt_cls=RuntimeConfig):
    """(text, tokens, words) of ``audio`` through an engine driven directly."""
    eng = engine_cls(model, batch_size=2, runtime=rt_cls(**RT))
    sid = eng.open_stream()
    eng.push_audio(sid, audio)
    eng.finalize_stream(sid)
    eng.run_until_drained()
    return eng.text(sid), list(eng._tokens[sid]), eng.word_timestamps(sid)


class _Conn:
    """A raw protocol connection with a timeout on every read."""

    def __init__(self, addr, timeout=120):
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.f = self.sock.makefile("rwb")

    def send_raw(self, data: bytes):
        self.f.write(data)
        self.f.flush()

    def send(self, obj):
        self.send_raw((json.dumps(obj) + "\n").encode())

    def recv(self):
        line = self.f.readline()
        if not line:
            raise ConnectionError("server closed")
        return json.loads(line)

    def push(self, pcm):
        self.send({"op": "push", "pcm": base64.b64encode(pcm.tobytes()).decode()})

    def close(self):
        self.f.close()        # the makefile dup holds the fd: close both, or
        self.sock.close()     # the server never sees EOF and the slot leaks


def _run_threads(fn, keys, timeout=300):
    threads = [threading.Thread(target=fn, args=(k,)) for k in keys]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a client thread did not finish"


def test_concurrent_clients_match_port_and_jax_engines(models):
    jm, pm = models
    srv = AsrServer(pm, batch_size=4, runtime=RuntimeConfig(**RT)).start()
    audios = {k: _audio(28000 + 4000 * k, k + 1) for k in range(3)}
    results = {}

    def run(k):
        results[k] = transcribe(*srv.addr, audios[k], chunk_samples=6000, timeout_s=120)

    try:
        _run_threads(run, audios)
    finally:
        srv.stop()
    assert len(results) == len(audios)
    for k, audio in audios.items():
        text, toks, words = _direct(pm, audio)
        jtext, jtoks, jwords = _direct(jm, audio, JEngine, JRuntime)
        got = results[k]
        assert (got["text"], got["tokens"], got["words"]) == (text, toks, words), f"stream {k}"
        assert (text, toks, words) == (jtext, jtoks, jwords), f"stream {k}"
        assert toks, f"stream {k}: degenerate, no tokens"


def _reply(conn, events) -> dict:
    """The next reply (a message with ``ok``) on ``conn``; the event messages
    that come before it go to ``events``: the engine queues an ERROR event
    for a malformed request besides its reply, and the step loop forwards
    it whenever it runs, so under load it lands between replies."""
    while True:
        msg = conn.recv()
        if "ok" in msg:
            return msg
        events.append(msg)


def _drain(conn, events, quiet_s=1.0) -> None:
    """Move the events still on their way to ``events``: read until
    ``quiet_s`` passes without a message."""
    conn.sock.settimeout(quiet_s)
    try:
        while True:
            events.append(conn.recv())
    except (TimeoutError, socket.timeout, ConnectionError):
        pass


def _error_script(srv) -> tuple:
    """Malformed and over-capacity requests on a batch_size=1 daemon; the
    replies in order, and the events the daemon sent besides them."""
    out, events = [], []
    c1 = _Conn(srv.addr)
    c2 = None
    try:
        c1.send({"op": "open"})
        out.append(_reply(c1, events))
        c2 = _Conn(srv.addr)
        for raw in (b'{"op": "open"}\n', b'{"op": "push", "pcm": ""}\n',
                    b'not json\n{"op": "info"}\n', b'{"op": "frobnicate"}\n'):
            c2.send_raw(raw)
            out.append(_reply(c2, events))
        out.append(_reply(c2, events))             # the last reply of the four sends
        for msg in ({"op": "push_features", "frames": 2,
                     "feats": base64.b64encode(np.zeros(10, np.float32).tobytes()).decode()},
                    {"op": "push", "pcm": "@@not base64@@"},
                    {"op": "frobnicate"}, {"op": "finalize"}):
            c1.send(msg)
            out.append(_reply(c1, events))
        _drain(c1, events)
    finally:
        for c in (c1, c2):
            if c is not None:
                c.close()
    # the first client's slot frees on disconnect: a new open succeeds
    deadline = time.monotonic() + 30
    while True:
        c3 = _Conn(srv.addr)
        try:
            c3.send({"op": "open"})
            r = _reply(c3, events)
        finally:
            c3.close()
        if r["ok"] or time.monotonic() > deadline:
            out.append(r)
            return out, events
        time.sleep(0.1)


def test_error_replies_match_jax_daemon(models):
    jm, pm = models
    replies, events = [], []
    for server_cls, model, rt in ((JServer, jm, JRuntime(**RT)),
                                  (AsrServer, pm, RuntimeConfig(**RT))):
        srv = server_cls(model, batch_size=1, runtime=rt).start(warmup=False)
        try:
            r, e = _error_script(srv)
        finally:
            srv.stop()
        replies.append(r)
        events.append(e)
    got, want = replies
    assert got == want
    assert events[0] == events[1]
    assert got[1]["ok"] is False and "busy" in got[1]["error"]
    assert [r["info"] for r in got if "info" in r] == [{"batch_size": 1,
                                                        "n_mels": pm.cfg.feat_in}]
    assert sum(not r["ok"] for r in got) == 7
    assert got[-1] == {"ok": True, "sid": 0}


def _read_segments(conn, want, segs, timeout=120):
    conn.sock.settimeout(1.0)
    t0 = time.monotonic()
    while len(segs) < want and time.monotonic() - t0 < timeout:
        try:
            msg = conn.recv()
        except (TimeoutError, socket.timeout):
            continue
        if msg.get("event") == "segment":
            segs.append(msg)
    return segs


def _push_stream(conn, stream, segs, chunk=4000):
    for s in range(0, len(stream), chunk):
        conn.push(stream[s:s + chunk])
        while True:
            msg = conn.recv()
            if "ok" in msg:
                assert msg["ok"], msg
                break
            if msg.get("event") == "segment":
                segs.append(msg)


def test_continuous_client_segments(models):
    """One segment event a speech span, with times on the stream's clock;
    each segment equals the port's and the JAX engine driven directly on
    its samples; a plain client on the same daemon is unaffected."""
    jm, pm = models
    srv = AsrServer(pm, batch_size=4, runtime=RuntimeConfig(**RT)).start()
    z = np.zeros(16000, np.float32)
    stream = np.concatenate([z, _audio(12800, 1), z, _audio(12800, 2), z])
    plain = {}
    t = threading.Thread(target=lambda: plain.update(
        r=transcribe(*srv.addr, _audio(24000, 3), chunk_samples=6000, timeout_s=120)))
    t.start()
    try:
        conn = _Conn(srv.addr)
        try:
            conn.send({"op": "open", "continuous": True, "silence_s": 0.6})
            assert conn.recv()["ok"]
            segs = []
            _push_stream(conn, stream, segs)
            _read_segments(conn, 2, segs)
        finally:
            conn.close()
    finally:
        t.join(timeout=300)
        srv.stop()
    assert not t.is_alive() and len(segs) == 2, segs
    segs.sort(key=lambda m: m["start_s"])
    for seg in segs:
        a, b = int(round(seg["start_s"] * 16000)), int(round(seg["end_s"] * 16000))
        text, toks, words = _direct(pm, stream[a:b])
        assert (seg["text"], seg["tokens"], seg["words"]) == (text, toks, words), seg
        assert _direct(jm, stream[a:b], JEngine, JRuntime)[:2] == (text, toks)
    assert any(s["tokens"] for s in segs)
    assert segs[0]["start_s"] <= 1.02 and segs[1]["start_s"] <= 2.82
    assert plain["r"]["tokens"] == _direct(pm, _audio(24000, 3))[1]


def test_continuous_rollover_capacity_error_is_recoverable(models):
    """batch_size=1: an endpoint's rollover needs a second slot, so it is an
    error reply; the detector and slot stay intact, and once the client
    leaves the daemon serves a plain client."""
    pm = models[1]
    srv = AsrServer(pm, batch_size=1, runtime=RuntimeConfig(**RT)).start()
    try:
        conn = _Conn(srv.addr)
        try:
            conn.send({"op": "open", "continuous": True, "silence_s": 0.4})
            assert conn.recv()["ok"]
            z = np.zeros(16000, np.float32)
            stream = np.concatenate([z, _audio(12800, 1), z])
            errors = []
            for s in range(0, len(stream), 4000):
                conn.push(stream[s:s + 4000])
                while "ok" not in (msg := conn.recv()):
                    pass
                if not msg["ok"]:
                    errors.append(msg["error"])
        finally:
            conn.close()
        assert errors and all("busy" in e for e in errors), errors
        r = None
        for _ in range(100):             # the slot frees once the server sees EOF
            try:
                r = transcribe(*srv.addr, _audio(24000, 3), chunk_samples=8000, timeout_s=120)
                break
            except RuntimeError:
                time.sleep(0.2)
        assert r is not None, "slot never freed after disconnect"
        assert r["tokens"] == _direct(pm, _audio(24000, 3))[1]
    finally:
        srv.stop()


def test_many_rollovers_no_slot_leak(models):
    """Six utterances through one continuous client: each rollover retires
    the old slot when its flush drains; at the end one slot is active, no
    segment pending, and the per-sid maps hold only the live sid."""
    srv = AsrServer(models[1], batch_size=3, runtime=RuntimeConfig(**RT)).start()
    try:
        conn = _Conn(srv.addr)
        try:
            conn.send({"op": "open", "continuous": True, "silence_s": 0.4})
            assert conn.recv()["ok"]
            gap = np.zeros(int(0.7 * 16000), np.float32)
            parts = [gap]
            for k in range(6):
                parts += [_audio(int(0.45 * 16000), k + 1), gap]
            segs = []
            _push_stream(conn, np.concatenate(parts), segs)
            _read_segments(conn, 6, segs)
            assert len(segs) == 6, [s.get("text") for s in segs]
            starts = [s["start_s"] for s in segs]
            assert starts == sorted(starts)
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60:
                with srv._elock:
                    if (sum(srv.engine._active) == 1 and not srv._seg_pending
                            and len(srv._clients) == 1):
                        break
                time.sleep(0.2)
            with srv._elock:
                assert sum(srv.engine._active) == 1
                assert not srv._seg_pending and len(srv._clients) == 1
                assert len(srv._outq) == 1 and len(srv._wlocks) == 1
        finally:
            conn.close()
    finally:
        srv.stop()


def test_transcribe_continuous_helper(models):
    """The blocking helper returns the ordered segments, including one that
    only the finalize flush closes (no trailing silence)."""
    pm = models[1]
    srv = AsrServer(pm, batch_size=3, runtime=RuntimeConfig(**RT)).start()
    z = np.zeros(16000, np.float32)
    stream = np.concatenate([z, _audio(12800, 1), z, _audio(12800, 2)])
    try:
        segs = transcribe_continuous(*srv.addr, stream, chunk_samples=4000, timeout_s=120,
                                     silence_s=0.5)
    finally:
        srv.stop()
    assert len(segs) == 2 and segs[0]["start_s"] < segs[1]["start_s"]
    a, b = int(round(segs[1]["start_s"] * 16000)), int(round(segs[1]["end_s"] * 16000))
    assert b <= len(stream)
    assert segs[1]["tokens"] == _direct(pm, stream[a:b])[1]


def test_warmup_reaches_the_joint_kernel_before_threads_start(models, monkeypatch):
    """``start()`` warms the step up under the engine lock before the
    stepper exists, and the warm-up decodes, so the joint kernel's wrapper
    (its plain version on CPU tensors) is reached: on the card the kernel
    is built and loaded there, never first inside the stepper."""
    calls = spy_calls(monkeypatch, greedy_loop, ["joint_step"])
    srv = AsrServer(models[1], batch_size=2,
                    runtime=RuntimeConfig(use_pallas_joint=True, **RT))
    try:
        assert srv.engine.beam == 1
        srv.start()
        assert calls["joint_step"] > 0
        assert srv.engine._active == [False, False]
    finally:
        srv.stop()
    assert not srv._threads[1].is_alive()


@pytest.mark.parametrize("flag", ["use_pallas_ffn", "use_pallas_conv"])
def test_batch_step_passes_ffn_and_conv_flags(models, monkeypatch, flag):
    """``_batch_step(use_pallas_ffn=, use_pallas_conv=)`` reaches the
    encoder's kernels (plain versions on CPU tensors, so the tokens equal
    the step without them); the engine's own step leaves them off."""
    pm = models[1]
    eng = BatchStreamingEngine(pm, batch_size=1, runtime=RuntimeConfig(**RT))
    cfg = pm.cfg
    feats = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (1, eng._frames, cfg.feat_in)).astype(np.float32))
    args = (torch.full((1,), eng._frames, dtype=torch.int32),)
    vecs = (torch.full((1,), cfg.cache_drop_size, dtype=torch.int32),
            torch.full((1,), cfg.valid_out_len, dtype=torch.int32))
    kw = eng._step_kwargs()
    assert "use_pallas_ffn" not in kw and "use_pallas_conv" not in kw

    def step(**flags):        # fresh states: the step updates the caches in place
        return _batch_step(pm, feats, *args, init_encoder_state(cfg, 1),
                           eng._fresh_decode_state(), np.zeros(1, np.int32), *vecs, **kw,
                           **flags)

    plain = step()
    calls = spy_calls(monkeypatch, encoder, ["fused_ffn", "conv_block"])
    fused = step(**{flag: True})
    want = {"use_pallas_ffn": "fused_ffn", "use_pallas_conv": "conv_block"}[flag]
    assert calls[want] > 0 and sum(calls.values()) == calls[want]
    assert torch.equal(plain[0], fused[0]) and torch.equal(plain[1], fused[1])


def test_main_serves_from_an_engine_dir(tmp_path):
    """``--engines DIR``: the daemon as a subprocess loads an engine set built for its model at its batch size
    (``python -m trt_asr_tpu_torch.engine_build``), says so, and a client's
    tokens equal the engine driven directly."""
    from trt_asr_tpu_torch import engine_build

    eng_dir = str(tmp_path / "engines")
    assert engine_build.main(["--config", "tiny", "--outdir", eng_dir, "--batch", "2",
                              "--device", "cpu", "--no-smoke"]) == 0
    cmd = [sys.executable, "-m", "trt_asr_tpu_torch.serve", "--synthetic-model", "tiny",
           "--device", "cpu", "--port", "0", "--batch-size", "2", "--engines", eng_dir]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        lines = [proc.stdout.readline() for _ in range(2)]
        assert "engines: 5 programs, 0 kernel libraries bound from" in lines[0], lines
        assert "listening on" in lines[1], lines
        port = int(lines[1].split("listening on ")[1].split()[0].rsplit(":", 1)[1])
        audio = _audio(24000, 3)
        got = transcribe("127.0.0.1", port, audio, timeout_s=120)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    model = ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig(), device="cpu")
    eng = BatchStreamingEngine(model, batch_size=2, runtime=RuntimeConfig())
    sid = eng.open_stream()
    eng.push_audio(sid, audio)
    eng.finalize_stream(sid)
    eng.run_until_drained()
    assert got["tokens"] == list(eng._tokens[sid]) and got["text"] == eng.text(sid)


def _beam_lm(model, jax_side: bool):
    """An n-gram LM fitted from seeded token sequences, in either package."""
    if jax_side:
        from trt_asr_tpu.decode.ngram_lm import NGramLM as LM
    else:
        from trt_asr_tpu_torch.decode.ngram_lm import NGramLM as LM
    r = np.random.default_rng(11)
    return LM.fit([r.integers(0, 64, size=9).tolist() for _ in range(40)], vocab_size=65)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("fusion", [False, True])
def test_beam_daemon_nbest_matches_jax_daemon(models, fusion):
    """``AsrServer(beam=4)``, with and without an n-gram LM: two concurrent
    clients' finals carry the JAX daemon's text, tokens, words and ranked
    ``nbest`` (scores within 1e-4)."""
    jm, pm = models
    audios = {k: _audio(24000 + 8000 * k, k + 4) for k in range(2)}
    out = {}
    for name, server, model, rt_cls in (("port", AsrServer, pm, RuntimeConfig),
                                        ("jax", JServer, jm, JRuntime)):
        lm = dict(lm_fn=_beam_lm(model, name == "jax"), lm_weight=0.6) if fusion else {}
        srv = server(model, batch_size=2, runtime=rt_cls(**RT), beam=4, **lm).start()
        res = {}
        try:
            _run_threads(lambda k: res.__setitem__(k, transcribe(
                *srv.addr, audios[k], chunk_samples=6000, timeout_s=120)), audios)
        finally:
            srv.stop()
        out[name] = res
    for k in audios:
        got, want = out["port"][k], out["jax"][k]
        assert (got["text"], got["words"]) == (want["text"], want["words"])
        assert [(n["text"], n["tokens"]) for n in got["nbest"]] == \
            [(n["text"], n["tokens"]) for n in want["nbest"]]
        np.testing.assert_allclose([n["score"] for n in got["nbest"]],
                                   [n["score"] for n in want["nbest"]], atol=1e-4)
        assert got["tokens"] == got["nbest"][0]["tokens"] and got["tokens"]


def test_main_lm_needs_a_beam(tmp_path):
    """``--lm`` on a greedy daemon: the engine refuses it, as JAX's does."""
    path = str(tmp_path / "lm.json")
    _beam_lm(None, False).save(path)
    with pytest.raises(ValueError, match="lm_fn requires beam > 1"):
        serve.main(["--synthetic-model", "tiny", "--device", "cpu", "--port", "0",
                    "--lm", path])


def test_main_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--synthetic-model", "tiny", "--port", "0"])


def imported_modules(importtime_log: str) -> set:
    """Module names from ``python -X importtime`` output."""
    return {line.rsplit("|", 1)[1].strip() for line in importtime_log.splitlines()
            if line.startswith("import time:") and line.count("|") == 2}


def no_jax(mods: set) -> list:
    return sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "trt_asr_tpu"))


@pytest.mark.parametrize("warmup", [True, False])
def test_daemon_subprocess_serves_on_cpu_without_jax(tmp_path, warmup):
    """``python -m trt_asr_tpu_torch.serve --device cpu`` as a user starts
    it (with and without ``--no-warmup``): its listening line gives the
    port, a client's tokens equal the engine driven directly, and the
    process imported nothing of JAX."""
    err = tmp_path / "stderr.txt"
    cmd = [sys.executable, "-X", "importtime", "-m", "trt_asr_tpu_torch.serve",
           "--synthetic-model", "tiny", "--device", "cpu", "--port", "0",
           "--batch-size", "2"] + ([] if warmup else ["--no-warmup"])
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(err, "w") as ferr:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=ferr,
                                text=True)
        try:
            line = ""
            deadline = time.monotonic() + 120
            while "listening on" not in line and time.monotonic() < deadline:
                line = proc.stdout.readline()
                assert line or proc.poll() is None, "daemon exited before listening"
            assert "listening on" in line, line
            port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
            audio = _audio(24000, 3)
            got = transcribe("127.0.0.1", port, audio, timeout_s=120)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    log = err.read_text()
    assert "step error" not in log
    assert not no_jax(imported_modules(log))
    assert "trt_asr_tpu_torch.streaming.batch_engine" in imported_modules(log)
    model = ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig(), device="cpu")
    eng = BatchStreamingEngine(model, batch_size=2, runtime=RuntimeConfig())
    sid = eng.open_stream()
    eng.push_audio(sid, audio)
    eng.finalize_stream(sid)
    eng.run_until_drained()
    assert got["tokens"] == list(eng._tokens[sid]) and got["text"] == eng.text(sid)


def test_beam_daemon_subprocess_with_lm(tmp_path):
    """``python -m trt_asr_tpu_torch.serve --beam 4 --lm F --lm-weight 0.5
    --token-cap 64 --device cpu``: a client's final carries the n-best of
    the engine driven directly with the same LM, and the process imported
    nothing of JAX."""
    lm_path = str(tmp_path / "lm.json")
    lm = _beam_lm(None, False)
    lm.save(lm_path)
    err = tmp_path / "stderr.txt"
    cmd = [sys.executable, "-X", "importtime", "-m", "trt_asr_tpu_torch.serve",
           "--synthetic-model", "tiny", "--device", "cpu", "--port", "0", "--batch-size", "2",
           "--beam", "4", "--lm", lm_path, "--lm-weight", "0.5", "--token-cap", "64"]
    with open(err, "w") as ferr:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                                stdout=subprocess.PIPE, stderr=ferr, text=True)
        try:
            line = ""
            deadline = time.monotonic() + 120
            while "listening on" not in line and time.monotonic() < deadline:
                line = proc.stdout.readline()
                assert line or proc.poll() is None, "daemon exited before listening"
            assert "listening on" in line and "beam=4" in line, line
            port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
            audio = _audio(24000, 6)
            got = transcribe("127.0.0.1", port, audio, timeout_s=120)
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    log = err.read_text()
    assert "step error" not in log and not no_jax(imported_modules(log))
    model = ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig(), device="cpu")
    eng = BatchStreamingEngine(model, batch_size=2, runtime=RuntimeConfig(), beam=4,
                               lm_fn=lm, lm_weight=0.5, token_cap=64)
    sid = eng.open_stream()
    eng.push_audio(sid, audio)
    eng.finalize_stream(sid)
    eng.run_until_drained()
    assert [(n["text"], n["tokens"], n["score"]) for n in got["nbest"]] == \
        [tuple(n) for n in eng.nbest(sid)]
    assert got["tokens"] == eng.nbest(sid)[0][1]
