"""The decode trace and the per-step decode route of the PyTorch port
against the JAX package: ``tdt_greedy_decode_host`` (tokens, stamps and
trace records equal to JAX's over each package's own joint and predictor),
the chunk decoder's trace buffer record for record against the host trace
(f32, int8 and bf16 joint weights, the joint step's plain version on and
off), the session with ``batched_decode=False`` (JAX's per-step route, the
same blank-run loop in the port) against the default session and JAX's
per-step session on tiny (tokens, frames, durations and words exact,
log-probs within 1e-4 as in ``test_torch_session.py``; gate_r3's case is
in ``test_torch_debug.py``, beside the JAX compiles it shares),
``debug_tdt_steps`` (``tdt_steps`` and the NDJSON line for line equal to
JAX's) and the ``debug_blank_scan`` line."""

import json

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread, spy_calls  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JModelConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.decode.host_decode import tdt_greedy_decode_host as j_host_decode
from trt_asr_tpu.models.parakeet import init_params as j_init_params
from trt_asr_tpu.models.parakeet.joint import joint_single_step as j_joint_single_step
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.models.parakeet.predictor import predictor_step as j_predictor_step
from trt_asr_tpu.streaming.session import StreamingSession as JSession
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.debug.tdt_trace import records_from_buffer
from trt_asr_tpu_torch.decode import greedy_loop
from trt_asr_tpu_torch.decode.host_decode import tdt_greedy_decode_host
from trt_asr_tpu_torch.decode.tdt_greedy import (init_decode_state, prime_decode_state,
                                                 tdt_greedy_decode_chunk)
from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode
from trt_asr_tpu_torch.models.parakeet.joint import joint_single_step
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import (cast_params_for_compute,
                                                      params_from_numpy)
from trt_asr_tpu_torch.models.parakeet.predictor import predictor_step
from trt_asr_tpu_torch.models.parakeet.quant import quantize_params
from trt_asr_tpu_torch.streaming.session import StreamingSession

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYS = ("time_idx", "u", "y_id", "best_tok", "duration", "advance", "is_blank",
        "blank_dur0_clamped")


@pytest.fixture(scope="module")
def tiny_enc():
    """Tiny seed-3 weights and the offline encoder rows of 150 seeded
    feature frames (the input both packages' decoders share)."""
    cfg = ModelConfig.tiny()
    jparams = j_init_params(JModelConfig.tiny(), seed=3)
    feats = (0.6 * np.random.default_rng(0).standard_normal((1, 150, cfg.feat_in))
             ).astype(np.float32)
    enc, enc_len = offline_encode(params_from_numpy(jparams), cfg, torch.as_tensor(feats),
                                  torch.tensor([150], dtype=torch.int32))
    return cfg, jparams, enc[0, :int(enc_len[0])].numpy()


def host_decode(decode, joint_fn, pred_fn, cfg, enc, state, g, trace, stamps):
    toks, _, _, _ = decode(enc, joint_fn, pred_fn, state, g, cfg.blank_id,
                           blank_id=cfg.blank_id, token_head_size=cfg.token_head_size,
                           duration_values=cfg.duration_values,
                           max_symbols=cfg.max_symbols_per_timestep, trace=trace,
                           stamps_out=stamps, trace_topk=3)
    return toks


def port_host_fns(params):
    def joint_fn(enc_t, g):
        return joint_single_step(params["joint"], torch.as_tensor(enc_t)[None], g[None])[0].numpy()

    def pred_fn(tok, st):
        g, h, c = predictor_step(params["predictor"], torch.tensor([tok]), *st)
        return g[0], (h, c)
    return joint_fn, pred_fn


def port_host_trace(cfg, params, enc):
    ds = prime_decode_state(params, cfg, init_decode_state(cfg, 1), [])
    trace, stamps = [], []
    joint_fn, pred_fn = port_host_fns(params)
    toks = host_decode(tdt_greedy_decode_host, joint_fn, pred_fn, cfg, enc, (ds.h, ds.c),
                       ds.g[0], trace, stamps)
    return toks, trace, stamps


def test_host_decode_equals_jax(tiny_enc):
    cfg, jparams, enc = tiny_enc
    params = params_from_numpy(jparams)
    toks, trace, stamps = port_host_trace(cfg, params, enc)

    joint_jit = jax.jit(lambda p, e, g: j_joint_single_step(p, e[None], g[None])[0])
    pred_jit = jax.jit(j_predictor_step)

    def j_joint(enc_t, g):
        return np.asarray(joint_jit(jparams["joint"], enc_t, g))

    def j_pred(tok, st):
        g, h, c = pred_jit(jparams["predictor"], np.array([tok], np.int32), *st)
        return np.asarray(g)[0], (h, c)

    h0 = np.zeros((cfg.pred_rnn_layers, 1, cfg.pred_hidden), np.float32)
    g0, h, c = j_predictor_step(jparams["predictor"], np.array([cfg.blank_id], np.int32), h0, h0)
    j_trace, j_stamps = [], []
    j_toks = host_decode(j_host_decode, j_joint, j_pred, cfg, enc, (h, c), np.asarray(g0)[0],
                         j_trace, j_stamps)
    assert toks == j_toks and len(toks) >= 10
    assert [s[:2] for s in stamps] == [s[:2] for s in j_stamps]
    np.testing.assert_allclose([s[2] for s in stamps], [s[2] for s in j_stamps], atol=1e-4)
    assert len(trace) == len(j_trace)
    for i, (got, want) in enumerate(zip(trace, j_trace)):
        assert {k: got[k] for k in KEYS + ("best_dur_idx",)} == {
            k: want[k] for k in KEYS + ("best_dur_idx",)}, f"step {i}"
        assert [t for t, _ in got["topk"]] == [t for t, _ in want["topk"]], f"step {i}"


@pytest.mark.parametrize("weights", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "joint_step"])
def test_chunk_trace_equals_host_trace(tiny_enc, weights, use_kernel):
    """The chunk decoder's trace buffer equals the host trace record for
    record (``tests/test_decode.py`` holds JAX's so), with the joint step's
    wrapper (its plain version on CPU tensors) or the plain joint."""
    cfg, jparams, enc = tiny_enc
    params = params_from_numpy(jparams)
    if weights == "int8":
        params = quantize_params(params, "joint")
    elif weights == "bf16":
        params = cast_params_for_compute(params, torch.bfloat16)
    toks, trace, _ = port_host_trace(cfg, params, enc)
    ds = prime_decode_state(params, cfg, init_decode_state(cfg, 1), [])
    t = enc.shape[0]
    tokens, n, _, (buf, n_steps) = tdt_greedy_decode_chunk(
        params, cfg, torch.as_tensor(enc), t, ds, max_tokens=cfg.max_symbols_per_timestep * t,
        use_pallas_joint=use_kernel, trace=True)
    assert buf.shape == (t * cfg.max_symbols_per_timestep, 7) and buf.dtype == torch.int32
    dev_trace = records_from_buffer(buf, n_steps)
    assert tokens[:int(n)].tolist() == toks and len(toks) >= 10
    assert len(dev_trace) == len(trace) == int(n_steps)
    for i, (d, h) in enumerate(zip(dev_trace, trace)):
        assert {k: d[k] for k in KEYS} == {k: h[k] for k in KEYS}, f"first divergence at step {i}"
    assert (buf[int(n_steps):] == -1).all()


AUDIO_TINY = (0.4 * np.sin(np.arange(32000) * 0.15)).astype(np.float32)


def run(sess, audio, piece=16000):
    for i in range(0, len(audio), piece):
        sess.push_audio(audio[i:i + piece])
    sess.finalize()
    return sess


def timestamps(sess):
    return [{k: v for k, v in d.items() if k != "logp"} for d in sess.token_timestamps()]


def logps(sess):
    return [d["logp"] for d in sess.token_timestamps()]


def test_per_step_session_equals_batched_and_jax(tmp_path, monkeypatch, capfd):
    """``batched_decode=False`` runs the same loop: the same tokens, stamps
    and joint calls as the default session, and JAX's per-step session
    (run with its trace on) gives the same tokens, stamps, trace records,
    NDJSON lines and blank-scan line as the port's with its trace on."""
    model = ParakeetTDT.random(ModelConfig.tiny(), seed=5, runtime=RuntimeConfig(), device="cpu")
    jmodel = JModel.random(JModelConfig.tiny(), seed=5)
    audio = AUDIO_TINY
    calls = spy_calls(monkeypatch, greedy_loop, ["joint_step"])
    batched = run(StreamingSession(model, RuntimeConfig(use_pallas_joint=True)), audio)
    joint_batched = calls["joint_step"]
    step = run(StreamingSession(model, RuntimeConfig(use_pallas_joint=True,
                                                     batched_decode=False)), audio)
    assert calls["joint_step"] == 2 * joint_batched > 0
    assert step.tokens == batched.tokens and len(step.tokens) > 3
    assert timestamps(step) == timestamps(batched) and logps(step) == logps(batched)
    assert step.word_timestamps() == batched.word_timestamps()
    assert step.tdt_steps == []

    paths = {k: str(tmp_path / f"{k}.jsonl") for k in ("port", "jax")}
    capfd.readouterr()
    traced = run(StreamingSession(model, RuntimeConfig(
        batched_decode=False, debug_tdt_steps=True, tdt_trace_path=paths["port"],
        debug_blank_scan=True)), audio)
    port_err = capfd.readouterr().err
    jsess = run(JSession(jmodel, JRuntime(batched_decode=False, debug_tdt_steps=True,
                                          tdt_trace_path=paths["jax"], debug_blank_scan=True)),
                audio)
    jax_err = capfd.readouterr().err
    assert traced.tokens == jsess._tokens == step.tokens
    assert timestamps(traced) == timestamps(jsess)
    np.testing.assert_allclose(logps(traced), logps(jsess), atol=1e-4)
    nolog = lambda ws: [{k: v for k, v in w.items() if k != "logp"} for w in ws]  # noqa: E731
    assert nolog(traced.word_timestamps()) == nolog(jsess.word_timestamps())
    assert traced.tdt_steps == jsess.tdt_steps
    assert sum(not r["is_blank"] for r in traced.tdt_steps) == len(traced.tokens)
    port_lines, jax_lines = (open(paths[k]).read().splitlines() for k in ("port", "jax"))
    assert port_lines == jax_lines
    assert json.loads(port_lines[0]) == {"type": "meta", "source": "device_while_loop",
                                         "blank_id": model.cfg.blank_id,
                                         "emitted": len(traced.tokens)}

    def scan(err):
        lines = [ln.split("] ", 1)[1] for ln in err.splitlines() if "blank_scan:" in ln]
        assert len(lines) == 1, err
        return lines[0]
    assert scan(port_err) == scan(jax_err)
    assert scan(port_err).startswith(f"blank_scan: steps={len(traced.tdt_steps)} blank_pref=")
