"""Streaming session of the PyTorch port against the JAX package on the
trained ``gate_r3`` model: synthesized utterances pushed at 0.3/0.5/1.0 s
give the same transcript, tokens and token/word stamps as the JAX
``StreamingSession``, with the fused attention block and joint step off and
on (their plain versions on CPU tensors), and with every kernel flag on
(FFN and conv module too) in f32 and int8; the same with the bf16 weights of
``cast_params_for_compute`` (the JAX package's production type), kernels
off, attention + joint, every flag, and the fast arm (bf16 cast, then
``quant="all"``, as ``bench.py`` orders them); ``_session_step`` with a
bf16 encoder state (the graft entry's configuration) closed loop against
JAX's; the env names of the flags; the
event protocol, reset/reuse,
push-after-finalize and snapshot/restore; the language and extra prompt
tokens against the JAX model's on one synthetic vocabulary; the package imports nothing of
JAX; without a CUDA device the entry points raise unless asked for the CPU.

Tolerance: transcripts, tokens, frames and durations exact; per-token
log-probs 1e-4 absolute, and 5e-3 with bf16 weights and the attention
kernel on: its plain version rounds u = LN(x) to bf16, as the TPU kernel
does, and an f32 value one ulp apart on the two sides can round to the
neighbouring bf16 value (one flip in u moves the encoder output by up to
2.9e-3, ``tests/test_torch_encoder.py``); readings 8e-4 (0.5-bf16_fused)
and 3.4e-3 (0.5-fast), 1e-4 with the kernels off."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, spy_calls, synth_audio

from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.session import StreamingSession as JSession
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.session import EventType, StreamingSession

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_model():
    return JModel.from_model_dir(GATE_R3, runtime=JRuntime())


@pytest.fixture(scope="module")
def port_model():
    return ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")


def run(session, audio, piece):
    for i in range(0, len(audio), piece):
        session.push_audio(audio[i:i + piece])
    session.finalize()
    return session


def stamps(sess):
    return ([{k: v for k, v in d.items() if k != "logp"} for d in sess.token_timestamps()],
            [d["logp"] for d in sess.token_timestamps()], sess.word_timestamps())


def bf16_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| past one bf16 ulp of the larger of the two
    (floored at 1e-4, where one ulp is below f32 noise)."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs()).clamp_min(1e-30))) - 7)
    return float(((g - w).abs() - ulp.clamp_min(1e-4)).max())


def bf16_models(kw):
    """The JAX and port gate_r3 models with bf16 weights (``quant`` in kw:
    quantized after the cast)."""
    import jax.numpy as jnp

    from trt_asr_tpu.models.parakeet.params import cast_params_for_compute

    base = JModel.from_model_dir(GATE_R3)
    jm = JModel(base.cfg, cast_params_for_compute(base.params, jnp.bfloat16), base.tokenizer,
                runtime=JRuntime(**kw))
    return jm, ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(**kw), device="cpu",
                                          weights_dtype=torch.bfloat16)


# fused: the attention block and joint step kernels off (False) or on (True)
# with f32 weights; with bf16 weights off ("bf16") or on ("bf16_fused"), and
# the fast arm ("fast": bf16, then int8, kernels on)
@pytest.mark.parametrize("seconds,fused", [
    (0.3, False), (0.5, False), (1.0, False), (0.3, True), (0.5, True), (1.0, True),
    (0.3, "bf16"), (0.5, "bf16_fused"), (1.0, "bf16_fused"), (0.5, "fast")])
def test_session_matches_jax_on_gate_r3(jax_model, port_model, seconds, fused):
    bf16 = isinstance(fused, str)
    on = fused is True or fused in ("bf16_fused", "fast")
    audio = synth_audio(seed=int(seconds * 10) + 100 * on + 1000 * bf16, words=6)
    piece = int(seconds * 16000)
    kw = dict(use_pallas_att=on, use_pallas_joint=on)
    if fused == "fast":
        kw["quant"] = "all"
    jm, pm = bf16_models(kw) if bf16 else (jax_model, port_model)
    ref = run(JSession(jm, JRuntime(**kw)), audio, piece)
    got = run(StreamingSession(pm, RuntimeConfig(**kw)), audio, piece)
    assert len(ref._tokens) > 0
    assert got.tokens == ref._tokens
    assert got.text == ref.text
    (tok_g, lp_g, words_g), (tok_r, lp_r, words_r) = stamps(got), stamps(ref)
    assert tok_g == tok_r
    np.testing.assert_allclose(lp_g, lp_r, atol=5e-3 if bf16 and on else 1e-4)
    assert [{k: v for k, v in w.items() if k != "logp"} for w in words_g] == \
        [{k: v for k, v in w.items() if k != "logp"} for w in words_r]


@pytest.mark.parametrize("quant", ["none", "all", "bf16", "fast"])
def test_session_with_every_kernel_matches_jax(quant, monkeypatch):
    """Every kernel flag on (attention block, joint step, FFN, conv module;
    with int8 weights the fused conv + FFN2 + out-LN tail) on both sides,
    f32 and int8 (quant="all"), bf16 weights ("bf16") and bf16 then int8
    ("fast": the tail with bf16 taps); JAX's kernels in interpret mode. The
    FFN and conv kernels run on every chunk, the first and the flush chunk
    too."""
    from trt_asr_tpu_torch.models.parakeet import encoder as penc

    calls = spy_calls(monkeypatch, penc, ("fused_ffn", "conv_block", "conv_ffn_ln"))
    kw = dict(use_pallas_att=True, use_pallas_joint=True, use_pallas_ffn=True,
              use_pallas_conv=True, quant={"bf16": "none", "fast": "all"}.get(quant, quant))
    audio = synth_audio(seed=31, words=6)
    if quant in ("bf16", "fast"):
        jm, model = bf16_models(kw)
    else:
        jm = JModel.from_model_dir(GATE_R3, runtime=JRuntime(**kw))
        model = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(**kw), device="cpu")
    ref = run(JSession(jm, JRuntime(**kw)), audio, 8000)
    got = run(StreamingSession(model, RuntimeConfig(**kw)), audio, 8000)
    assert len(ref._tokens) > 0
    assert got.tokens == ref._tokens
    assert got.text == ref.text
    (tok_g, lp_g, words_g), (tok_r, lp_r, _) = stamps(got), stamps(ref)
    assert tok_g == tok_r
    np.testing.assert_allclose(lp_g, lp_r, atol=1e-4)
    layer_chunks = len(got.chunk_latencies_ms) * model.cfg.num_layers
    tail = kw["quant"] == "all"
    assert calls["conv_ffn_ln" if tail else "conv_block"] == layer_chunks
    assert calls["fused_ffn"] == layer_chunks * (1 if tail else 2)


@pytest.mark.parametrize("kernels", [False, True])
def test_session_step_with_bf16_state_matches_jax(kernels):
    """``_session_step`` as the graft entry runs it: ``cast_params_for_compute``
    bf16 weights and a bf16 encoder state, closed loop over a tiny model's
    chunk schedule (the kernels' plain versions on the attention block's
    steady chunks and the joint step with ``kernels``), against JAX's
    ``_session_step`` on the same weights and state. Tokens exact; each
    bf16 cache value within one bf16 ulp (or 1e-4 near zero) of JAX's: the
    same bf16 writes of f32 values 1e-6 apart, where one can round to the
    neighbouring bf16 value. With the kernels on, 2e-3 past that: the
    attention block rounds u to bf16, and one flip moves the conv module's
    rows, and so the time cache, by up to 7.3e-4 past one ulp (reading);
    the same loop with the port's kernel off (no rounding points) lies
    8.8e-3 past it."""
    import jax.numpy as jnp

    from torch_port_helpers import np_tree
    from trt_asr_tpu.config import ModelConfig as JConfig
    from trt_asr_tpu.decode import init_decode_state as j_init_dec
    from trt_asr_tpu.models.parakeet import encoder as jenc
    from trt_asr_tpu.models.parakeet.params import cast_params_for_compute, init_params
    from trt_asr_tpu.streaming.session import _session_step as j_step
    from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state
    from trt_asr_tpu_torch.models.parakeet import encoder as penc
    from trt_asr_tpu_torch.streaming.schedule import build_schedule, extract_chunk
    from trt_asr_tpu_torch.streaming.session import _session_step
    from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab

    cfg_j, cfg = JConfig.tiny(), ModelConfig.tiny()
    params_j = init_params(cfg_j, seed=6)
    model = ParakeetTDT(cfg, np_tree(params_j), Tokenizer(make_synthetic_vocab(cfg.vocab_size),
                                                          blank_id=cfg.blank_id),
                        runtime=RuntimeConfig(), device="cpu", weights_dtype=torch.bfloat16)
    params_j = cast_params_for_compute(params_j, jnp.bfloat16)
    es_j, ds_j = jenc.init_encoder_state(cfg_j, 1, dtype=jnp.bfloat16), j_init_dec(cfg_j, 1)
    es_p = penc.init_encoder_state(cfg, 1, dtype=torch.bfloat16)
    ds_p = init_decode_state(cfg, 1)
    total = 200
    feats = (0.5 * np.random.default_rng(6).standard_normal((total, cfg.feat_in))
             ).astype(np.float32)
    frames = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
    tq_steady = penc.subsampled_length(frames, cfg.stride_stages) - cfg.drop_extra_pre_encoded
    pad = (-tq_steady) % 8
    pos_kernel = penc.precompute_pos_proj(model.params, cfg, tq_steady + pad,
                                          cfg.att_cache_size)
    emitted, fused = 0, 0
    for spec in build_schedule(total, cfg):
        x = extract_chunk(feats, spec)
        valid = max(min(spec.slice_end, total) - max(spec.slice_start, 0), 0)
        tq = penc.subsampled_length(spec.frames, cfg.stride_stages) - spec.drop_extra
        att = kernels and tq == tq_steady
        fused += att
        kw = dict(drop_extra=spec.drop_extra,
                  cache_drop=0 if spec.is_last else cfg.cache_drop_size,
                  valid_cap=None if spec.is_last else cfg.valid_out_len, blank_penalty=0.0,
                  emitted_so_far=emitted, punct_mask=None, use_pallas_joint=kernels,
                  use_pallas_att=att, pad_steps=pad if att else 0)
        toks_j, n_j, es_j, ds_j = j_step(params_j, cfg_j, x[None], np.int32(valid), es_j, ds_j,
                                         use_punct_mask=False, **kw)
        toks_p, n_p, es_p, ds_p, _, _ = _session_step(
            model, torch.as_tensor(x[None]), valid, es_p, ds_p,
            pos_proj=pos_kernel if att else None, **kw)
        n = int(n_j)
        assert int(n_p) == n and toks_p[:n].tolist() == np.asarray(toks_j)[:n].tolist(), (
            f"chunk {spec.idx}")
        emitted += n
        for name in ("att_cache", "time_cache", "kv_cache"):
            got, want = getattr(es_p, name), getattr(es_j, name)
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            excess = bf16_excess(got, torch.as_tensor(np.asarray(want, np.float32)))
            assert excess <= (2e-3 if kernels else 0.0), f"chunk {spec.idx} {name}: {excess}"
    assert emitted > 0 and (fused >= 5 if kernels else fused == 0)


def test_runtime_flags_read_from_env(monkeypatch):
    monkeypatch.setenv("TRT_ASR_PALLAS_CONV", "1")
    monkeypatch.setenv("TRT_ASR_PALLAS_FFN", "1")
    rt, ref = RuntimeConfig.from_env(), JRuntime.from_env()
    assert rt.use_pallas_conv and rt.use_pallas_ffn
    assert (rt.use_pallas_conv, rt.use_pallas_ffn) == (ref.use_pallas_conv, ref.use_pallas_ffn)


def events_of(sess):
    out = []
    while (ev := sess.poll_event()) is not None:
        out.append(ev)
    return out


def test_event_protocol_reset_and_push_after_finalize(port_model):
    audio = synth_audio(seed=11, words=5)
    sess = run(StreamingSession(port_model, RuntimeConfig()), audio, 8000)
    events = events_of(sess)
    assert events[-1].type == EventType.FINAL_TEXT
    assert events[-1].text == sess.text and events[-1].tokens == sess.tokens
    assert any(e.type == EventType.PARTIAL_TEXT for e in events)
    first = sess.tokens

    sess.push_audio(audio[:8000])                   # after finalize: an ERROR event
    err = events_of(sess)
    assert [e.type for e in err] == [EventType.ERROR]
    assert "finalize" in err[0].error_message
    sess.finalize()                                 # idempotent
    assert events_of(sess) == []

    sess.reset_utterance()                          # reuse gives the same transcript
    run(sess, audio, 4800)
    assert sess.tokens == first
    assert events_of(sess)[-1].segment_id == events[-1].segment_id + 1


def test_snapshot_restore_continues_identically(port_model):
    audio = synth_audio(seed=12, words=6)
    rt = RuntimeConfig(use_pallas_att=True, use_pallas_joint=True)
    whole = run(StreamingSession(port_model, rt), audio, 8000)
    a = StreamingSession(port_model, rt)
    a.push_audio(audio[:24000])
    snap = a.snapshot()
    a.push_audio(audio[24000:32000])                # the snapshot is a copy, not a view
    b = StreamingSession(port_model, rt)
    b.restore(snap)
    for i in range(24000, len(audio), 8000):
        b.push_audio(audio[i:i + 8000])
    b.finalize()
    assert b.tokens == whole.tokens
    assert b.token_timestamps() == whole.token_timestamps()


def test_one_utterance_is_invariant_to_push_granularity(port_model):
    """The port's version of ``tests/test_session.py``'s chunking
    invariance: one utterance pushed in 0.2 s and 1 s pieces and whole
    gives the same tokens and stamps."""
    audio = synth_audio(seed=14, words=6)
    runs = [run(StreamingSession(port_model, RuntimeConfig()), audio, piece)
            for piece in (3200, 16000, len(audio))]
    assert len(runs[0].tokens) > 0
    for other in runs[1:]:
        assert other.tokens == runs[0].tokens
        assert other.token_timestamps() == runs[0].token_timestamps()


def test_fast_mode_production_invariants():
    """The port's version of ``tests/test_session.py``'s fast-mode test on
    gate_r3: int8 weights (quant="all") with the fused attention block and
    joint step (their plain versions on CPU tensors) and batched decode
    keep push-granularity invariance and snapshot/restore identity."""
    rt = RuntimeConfig(quant="all", use_pallas_att=True, use_pallas_joint=True,
                       batched_decode=True)
    qm = ParakeetTDT.from_model_dir(GATE_R3, runtime=rt, device="cpu")
    audio = synth_audio(seed=15, words=5)
    a, b = run(StreamingSession(qm, rt), audio, 3200), run(StreamingSession(qm, rt), audio, 16000)
    assert len(a.tokens) > 0
    assert a.tokens == b.tokens, "granularity invariance broke in fast mode"
    s1 = StreamingSession(qm, rt)
    s1.push_audio(audio[:16000])
    snap = s1.snapshot()
    s2 = StreamingSession(qm, rt)
    s2.restore(snap)
    for sess in (s1, s2):
        sess.push_audio(audio[16000:])
        sess.finalize()
    assert s2.tokens == s1.tokens == a.tokens


def test_concurrent_push_poll(port_model):
    """The port's version of ``tests/test_session.py``'s producer/consumer
    test: a poller drains the event queue while a pusher streams; the final
    transcript equals the serial run's and every event is well-formed."""
    import threading

    audio = synth_audio(seed=16, words=5)
    serial = events_of(run(StreamingSession(port_model, RuntimeConfig()), audio, 8000))
    sess = StreamingSession(port_model, RuntimeConfig())
    done, push_err, events = threading.Event(), [], []

    def pusher():
        try:
            run(sess, audio, 8000)
        except Exception as e:  # noqa: BLE001
            push_err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=pusher)
    t.start()
    while not done.is_set():
        ev = sess.poll_event()
        if ev is None:
            done.wait(0.001)                    # leave the pusher the interpreter
        else:
            events.append(ev)
    t.join()
    assert not push_err, push_err
    events += events_of(sess)
    assert all(e.type in (EventType.PARTIAL_TEXT, EventType.FINAL_TEXT) for e in events)
    finals = [e for e in events if e.type == EventType.FINAL_TEXT]
    assert finals and finals[-1].text == serial[-1].text and finals[-1].tokens == serial[-1].tokens


def prompt_models(prompt_tokens):
    """The JAX and the port's tiny random models on one synthetic vocabulary
    that holds ``prompt_tokens``."""
    from trt_asr_tpu.config import ModelConfig as JConfig
    from trt_asr_tpu.tokenizer import Tokenizer as JTokenizer
    from trt_asr_tpu.tokenizer import make_synthetic_vocab as j_vocab
    from trt_asr_tpu_torch.tokenizer import Tokenizer, make_synthetic_vocab

    jm = JModel.random(JConfig.tiny(), seed=1)
    jm.tokenizer = JTokenizer(j_vocab(64, prompt_tokens=prompt_tokens), blank_id=jm.cfg.blank_id)
    m = ParakeetTDT.random(ModelConfig.tiny(), seed=1, device="cpu")
    m.tokenizer = Tokenizer(make_synthetic_vocab(64, prompt_tokens=prompt_tokens),
                            blank_id=m.cfg.blank_id)
    assert m.tokenizer.vocab == jm.tokenizer.vocab
    return jm, m


def test_language_prompt_selection_matches_jax(monkeypatch):
    """The port's counterpart of tests/test_session.py's
    test_language_prompt_selection: the language prompt token follows
    ``language`` (TRT_ASR_LANG), a language missing from the vocabulary
    primes the start token alone, and the default is <|en|>, as the JAX
    model's ``prompt_ids`` on the same vocabulary."""
    jm, m = prompt_models(("<|startoftranscript|>", "<|en|>", "<|de|>"))
    tok = m.tokenizer
    sot = tok.token_id("<|startoftranscript|>")
    assert m.prompt_ids == jm.prompt_ids == [sot, tok.token_id("<|en|>")]
    for lang, want in (("de", [sot, tok.token_id("<|de|>")]), ("xx", [sot])):
        jm.runtime, m.runtime = JRuntime(language=lang), RuntimeConfig(language=lang)
        assert m.prompt_ids == jm.prompt_ids == want
    monkeypatch.setenv("TRT_ASR_LANG", "de")
    assert RuntimeConfig.from_env().language == JRuntime.from_env().language == "de"


def test_extra_prompt_tokens_match_jax(monkeypatch):
    """The port's counterpart of tests/test_session.py's
    test_extra_prompt_tokens: ``extra_prompt`` (TRT_ASR_EXTRA_PROMPT) primes
    its tokens after the start and language tokens, in order; absent tokens
    are skipped; the default primes none, as the JAX model's
    ``prompt_ids`` on the same vocabulary."""
    jm, m = prompt_models(("<|startoftranscript|>", "<|en|>"))
    tok = m.tokenizer
    sot, en, nopnc = (tok.token_id(t) for t in ("<|startoftranscript|>", "<|en|>", "<|nopnc|>"))
    assert nopnc >= 0
    assert m.prompt_ids == jm.prompt_ids == [sot, en]
    for extra, want in (("<|nopnc|>,<|noitn|>", [sot, en, nopnc, tok.token_id("<|noitn|>")]),
                        ("<|missing|>", [sot, en])):
        jm.runtime, m.runtime = JRuntime(extra_prompt=extra), RuntimeConfig(extra_prompt=extra)
        assert m.prompt_ids == jm.prompt_ids == want
    monkeypatch.setenv("TRT_ASR_EXTRA_PROMPT", "<|nopnc|>")
    assert RuntimeConfig.from_env().extra_prompt == JRuntime.from_env().extra_prompt == "<|nopnc|>"


def test_cache_fault_paths_match_jax(jax_model, port_model):
    audio = synth_audio(seed=13, words=4)
    for kw in (dict(disable_cache=True), dict(cache_len_override=5)):
        ref = run(JSession(jax_model, JRuntime(**kw)), audio, 8000)
        got = run(StreamingSession(port_model, RuntimeConfig(**kw)), audio, 8000)
        assert got.tokens == ref._tokens, kw


def test_port_imports_nothing_of_jax():
    code = (
        "import sys, numpy as np\n"
        "from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig\n"
        "from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT\n"
        "from trt_asr_tpu_torch.streaming.session import StreamingSession\n"
        "import trt_asr_tpu_torch.ops.kernels.build\n"
        "m = ParakeetTDT.random(ModelConfig.tiny(), seed=1, runtime=RuntimeConfig(), device='cpu')\n"
        "s = StreamingSession(m)\n"
        "s.push_audio(np.sin(np.arange(16000) * 0.05).astype(np.float32)); s.finalize()\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib'))\n"
        "       or k == 'trt_asr_tpu' or k.startswith('trt_asr_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(s.chunk_latencies_ms))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_entry_points_need_cuda_unless_asked_for_cpu():
    from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend

    if torch.cuda.is_available():
        assert ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        LogMelFrontend()
    m = ParakeetTDT.random(ModelConfig.tiny(), runtime=RuntimeConfig(), device="cpu")
    assert StreamingSession(m).device.type == "cpu"
