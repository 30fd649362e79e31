"""Lockstep multi-stream engine of the PyTorch port
(``streaming/batch_engine.py``) against the JAX package's
``BatchStreamingEngine`` on ``ModelConfig.tiny()`` (the same weights on both
sides) and on the trained ``gate_r3``: the cases of
``tests/test_batch_engine.py`` that need no beam and no mesh. Each stream's
tokens equal the JAX engine's and the port's own single-stream session's
(the invariant "batched decode == single-stream decode, token-exact"): streams of
different lengths pushed interleaved, slot reuse, slot exhaustion, a
sub-first-chunk utterance, the event protocol, a stream attached under
load, a flush inside the lockstep step, a wide engine (the per-row decode
regime), ``_batch_step`` with the attention block's kernel on, and
``warmup``. Also the encoder's per-row ``cache_drop_vec``/``valid_cap_vec``
closed loop against JAX, and ``reset_decode_state_rows`` against JAX.

Tolerance: tokens, events and segment ids exact; encoder outputs and
caches 1e-4 (f32 summation order); decode state 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, np_tree, synth_audio, t

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.config import RuntimeConfig as JRuntime
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.streaming.batch_engine import BatchStreamingEngine as JEngine
from trt_asr_tpu_torch.config import ModelConfig, RuntimeConfig
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.streaming.batch_engine import BatchStreamingEngine, _batch_step
from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler
from trt_asr_tpu_torch.streaming.session import StreamingSession
from trt_asr_tpu_torch.tokenizer import Tokenizer

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
    tt = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * (250 + 30 * seed) * tt / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _single_stream_tokens(model, audio):
    sess = StreamingSession(model, RuntimeConfig(**RT))
    sess._sched = ChunkScheduler(model.cfg, unified=True)  # the engine's chunk profile
    for s in range(0, len(audio), 8000):
        sess.push_audio(audio[s:s + 8000])
    sess.finalize()
    return sess.tokens


def _drain(eng, sid):
    evs = []
    while (e := eng.poll_event(sid)) is not None:
        evs.append(e)
    return evs


def _finals(eng, sid):
    return [e.tokens for e in _drain(eng, sid) if e.type == 1]


def both(models, batch_size, drive, **rt):
    """Run ``drive(engine)`` (which returns {key: sid}) on the JAX engine and
    on the port's; returns ({key: final tokens}) of each."""
    out = []
    for model, eng_cls, rt_cls in ((models[0], JEngine, JRuntime),
                                   (models[1], BatchStreamingEngine, RuntimeConfig)):
        eng = eng_cls(model, batch_size=batch_size, runtime=rt_cls(**RT, **rt))
        sids = drive(eng)
        out.append({k: _finals(eng, sid) for k, sid in sids.items()})
    return out


def test_batch_matches_single_streams(models):
    audios = {0: _audio(40000, 1), 1: _audio(56000, 2), 2: _audio(24000, 3)}
    hop = {0: 8000, 1: 12000, 2: 5000}

    def drive(eng):
        sids = {k: eng.open_stream() for k in audios}
        offs = dict.fromkeys(audios, 0)
        while any(offs[k] < len(a) for k, a in audios.items()):
            for k, a in audios.items():
                if offs[k] < len(a):
                    eng.push_audio(sids[k], a[offs[k]:offs[k] + hop[k]])
                    offs[k] += hop[k]
            eng.step()
        for k in audios:
            eng.finalize_stream(sids[k])
        eng.run_until_drained()
        return sids

    ref, got = both(models, 4, drive)
    for k, a in audios.items():
        assert got[k] == ref[k] == [_single_stream_tokens(models[1], a)], f"stream {k}"
        assert len(got[k][0]) > 0


def test_slot_reuse_no_leak(models):
    eng = BatchStreamingEngine(models[1], batch_size=2, runtime=RuntimeConfig(**RT))
    a = _audio(32000, 7)
    sid = eng.open_stream()
    eng.push_audio(sid, a)
    eng.finalize_stream(sid)
    eng.run_until_drained()
    t1 = eng.text(sid)
    eng.close_stream(sid)
    sid2 = eng.open_stream()                     # the same slot, the same audio
    assert sid2 == sid
    eng.push_audio(sid2, a)
    eng.finalize_stream(sid2)
    eng.run_until_drained()
    assert eng.text(sid2) == t1 and t1


def test_slot_exhaustion(models):
    eng = BatchStreamingEngine(models[1], batch_size=2)
    eng.open_stream()
    eng.open_stream()
    with pytest.raises(RuntimeError, match="busy"):
        eng.open_stream()


def test_short_utterance_flush(models):
    """A sub-first-chunk utterance goes through the flush path alone."""
    def drive(eng):
        sid = eng.open_stream()
        eng.push_audio(sid, _audio(4800, 9))     # 30 frames < 41
        eng.finalize_stream(sid)
        eng.run_until_drained()
        return {0: sid}

    ref, got = both(models, 2, drive)
    assert len(got[0]) == 1 and got == ref


def test_event_protocol_parity_with_session(models):
    """The engine's event protocol equals the session's and the JAX
    engine's: one FINAL with the session's tokens, segment ids, growing
    partial prefixes, ERROR on push-after-finalize, pacing, and a reused
    slot's new segment id."""
    audio = _audio(40000, 4)
    sess = StreamingSession(models[1], RuntimeConfig(**RT, partial_min_interval_ms=0))
    sess._sched = ChunkScheduler(models[1].cfg, unified=True)
    for s in range(0, len(audio), 8000):
        sess.push_audio(audio[s:s + 8000])
    sess.finalize()
    sev = []
    while (e := sess.poll_event()) is not None:
        sev.append(e)

    protocols = []
    for model, eng_cls, rt_cls in ((models[0], JEngine, JRuntime),
                                   (models[1], BatchStreamingEngine, RuntimeConfig)):
        eng = eng_cls(model, batch_size=2, runtime=rt_cls(**RT, partial_min_interval_ms=0))
        sid = eng.open_stream()
        for s in range(0, len(audio), 8000):
            eng.push_audio(sid, audio[s:s + 8000])
            while eng.step():
                pass
        eng.finalize_stream(sid)
        eng.run_until_drained()
        evs = _drain(eng, sid)
        eng.push_features(sid, np.zeros((5, model.cfg.feat_in), np.float32))
        err = _drain(eng, sid)
        eng2 = eng_cls(model, batch_size=2, runtime=rt_cls(**RT, partial_min_interval_ms=10**9))
        sid2 = eng2.open_stream()
        eng2.push_audio(sid2, audio)
        eng2.finalize_stream(sid2)
        eng2.run_until_drained()
        paced = [int(e.type) for e in _drain(eng2, sid2)]
        eng2.close_stream(sid2)
        sid3 = eng2.open_stream()
        eng2.push_audio(sid3, audio[:16000])
        eng2.finalize_stream(sid3)
        eng2.run_until_drained()
        reused = {e.segment_id for e in _drain(eng2, sid3)}
        protocols.append(([(int(e.type), e.segment_id, list(e.tokens)) for e in evs],
                          [(int(e.type), e.error_message) for e in err], paced, reused))
    (ref, ref_err, ref_paced, ref_reused), (got, err, paced, reused) = protocols
    assert got == ref and err == ref_err and paced == ref_paced == [1] and reused == ref_reused
    finals = [toks for typ, _, toks in got if typ == 1]
    assert finals == [[e.tokens for e in sev if e.type == 1][0]]
    assert {seg for _, seg, _ in got} == {1} and reused == {2}
    parts = [toks for typ, _, toks in got if typ == 0]
    assert parts and all(p == finals[0][:len(p)] for p in parts)
    assert all(len(b) > len(a) for a, b in zip(parts, parts[1:]))
    assert [typ for typ, _ in err] == [2] and "finalize" in err[0][1]


def test_mid_flight_attach_under_load(models):
    a0, a1 = _audio(48000, 11), _audio(32000, 12)

    def drive(eng):
        s0 = eng.open_stream()
        eng.push_audio(s0, a0[:24000])
        steps = 0
        while eng.step():
            steps += 1
        assert steps > 0, "stream 0 must be mid-utterance before the attach"
        s1 = eng.open_stream()                   # attach under load
        eng.push_audio(s1, a1)
        eng.push_audio(s0, a0[24000:])
        eng.finalize_stream(s1)
        eng.run_until_drained()
        eng.finalize_stream(s0)
        eng.run_until_drained()
        return {0: s0, 1: s1}

    ref, got = both(models, 4, drive)
    for k, a in ((0, a0), (1, a1)):
        assert got[k] == ref[k] == [_single_stream_tokens(models[1], a)], f"stream {k}"


def test_flush_inside_lockstep_batch(models, monkeypatch):
    """A finalizing stream's keep-all flush runs inside the lockstep step
    while the other stream goes on with steady chunks: one step holds a
    steady row and a flush row (cache_drop 3 and 0)."""
    from trt_asr_tpu_torch.streaming import batch_engine as be

    mixed = []
    step = be._batch_step

    def spy(*args, **kwargs):
        drop = args[6].tolist()
        mixed.append(sorted(set(d for d, v in zip(drop, args[2].tolist()) if v)))
        return step(*args, **kwargs)

    monkeypatch.setattr(be, "_batch_step", spy)
    a0, a1 = _audio(48000, 21), _audio(20000, 22)

    def drive(eng):
        s0, s1 = eng.open_stream(), eng.open_stream()
        eng.push_audio(s0, a0)
        eng.push_audio(s1, a1)
        eng.finalize_stream(s1)                  # s1 flushes while s0 has steady chunks
        eng.run_until_drained()
        eng.finalize_stream(s0)
        eng.run_until_drained()
        return {0: s0, 1: s1}

    ref, got = both(models, 2, drive)
    assert [0, models[1].cfg.cache_drop_size] in mixed
    for k, a in ((0, a0), (1, a1)):
        assert got[k] == ref[k] == [_single_stream_tokens(models[1], a)], f"stream {k}"


def test_large_batch_per_step_decode_regime(models):
    """A wide engine (B * Tq > 256: one joint a row and iteration) matches
    the JAX engine and the single-stream decode."""
    audios = {0: _audio(24000, 5), 1: _audio(30000, 6)}

    def drive(eng):
        sids = {k: eng.open_stream() for k in audios}
        offs = dict.fromkeys(audios, 0)
        while any(offs[k] < len(a) for k, a in audios.items()):
            for k, a in audios.items():
                if offs[k] < len(a):
                    eng.push_audio(sids[k], a[offs[k]:offs[k] + 8000])
                    offs[k] += 8000
            eng.step()
        for k in audios:
            eng.finalize_stream(sids[k])
        eng.run_until_drained()
        return sids

    ref, got = both(models, 36, drive)
    for k, a in audios.items():
        assert got[k] == ref[k] == [_single_stream_tokens(models[1], a)], f"stream {k}"


def test_batch_step_pallas_att_token_exact(models):
    """``_batch_step`` at B=1 with the attention block's kernel (its plain
    version here; steps padded to 8, per-row cache_drop_vec) is token-exact
    with the path without it and with the JAX ``_batch_step``, closed loop
    over five chunks."""
    from trt_asr_tpu.decode import init_decode_state as j_init_dec
    from trt_asr_tpu.models.parakeet import init_encoder_state as j_init_enc
    from trt_asr_tpu.streaming.batch_engine import _batch_step as j_batch_step
    from trt_asr_tpu_torch.decode.tdt_greedy import init_decode_state
    from trt_asr_tpu_torch.models.parakeet.encoder import init_encoder_state, precompute_pos_proj

    jm, pm = models
    cfg = pm.cfg
    eng = BatchStreamingEngine(pm, batch_size=1)
    frames, tq = eng._frames, eng._tq
    pad = (-tq) % 8
    pos_kernel = precompute_pos_proj(pm.params, cfg, tq + pad, cfg.att_cache_size)
    kw = dict(drop_extra=cfg.drop_extra_pre_encoded, max_tokens=32)
    valid, emitted = np.full((1,), frames, np.int32), np.zeros((1,), np.int32)
    cdv = np.full((1,), cfg.cache_drop_size, np.int32)
    vcv = np.full((1,), cfg.valid_out_len, np.int32)
    es_j, ds_j = j_init_enc(jm.cfg, 1), j_init_dec(jm.cfg, 1)
    states = [(init_encoder_state(cfg, 1), init_decode_state(cfg, 1)) for _ in range(2)]
    rng = np.random.default_rng(3)
    for k in range(5):
        f = rng.standard_normal((1, frames, cfg.feat_in)).astype(np.float32)
        toks_j, n_j, es_j, ds_j = j_batch_step(
            jm.params, jm.cfg, jnp.asarray(f), jnp.asarray(valid), es_j, ds_j,
            jnp.asarray(emitted), jnp.asarray(cdv), jnp.asarray(vcv), use_pallas_joint=False,
            **kw)
        want = np.asarray(toks_j)[0, :int(n_j[0])].tolist()
        for i, fused in enumerate((False, True)):
            es, ds = states[i]
            toks, n, es, ds, _, _ = _batch_step(
                pm, t(f), t(valid), es, ds, emitted, t(cdv), t(vcv),
                pos_proj=pos_kernel if fused else eng._pos_proj, pad_steps=pad if fused else 0,
                use_pallas_att=fused, **kw)
            states[i] = (es, ds)
            assert toks[0, :int(n[0])].tolist() == want, f"chunk {k} fused={fused}"


def test_warmup_leaves_slots_and_serving_unchanged(models):
    audio = _audio(30000, 5)
    rt = RuntimeConfig(**RT)
    cold = BatchStreamingEngine(models[1], batch_size=2, runtime=rt)
    s0 = cold.open_stream()
    cold.push_audio(s0, audio)
    cold.finalize_stream(s0)
    cold.run_until_drained()
    want = list(cold._tokens[s0])
    warm = BatchStreamingEngine(models[1], batch_size=2, runtime=rt)
    sid = warm.open_stream()
    warm.push_audio(sid, audio[:4000])          # a stream in flight before the warm-up
    warm.step()
    mid = list(warm._tokens[sid])
    assert warm.warmup() > 0
    assert warm._tokens[sid] == mid and warm._active[sid] and not warm._finalized[sid]
    warm.push_audio(sid, audio[4000:])
    warm.finalize_stream(sid)
    warm.run_until_drained()
    assert list(warm._tokens[sid]) == want and want


def test_not_ported_options_raise(models):
    """``mesh=`` and ``engines=`` are ported (``tests/test_torch_mesh.py``,
    ``tests/test_torch_runtime.py``): a mesh of two devices raises, and so
    does an engine set with a mesh, as in JAX."""
    from trt_asr_tpu_torch.parallel.mesh import make_mesh
    from trt_asr_tpu_torch.runtime.engine import EngineSet

    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        BatchStreamingEngine(models[1], batch_size=2, mesh=make_mesh(dp=2, devices=[cpu, cpu]))
    with pytest.raises(ValueError, match="AOT engines are single-device artifacts"):
        BatchStreamingEngine(models[1], batch_size=2, engines=EngineSet({}, {}),
                             mesh=make_mesh(devices=[cpu]))
    # the beam is ported (tests/test_torch_batch_beam.py): a greedy engine
    # has no n-best, as JAX's has none
    with pytest.raises(ValueError, match="nbest requires a beam>1 engine"):
        BatchStreamingEngine(models[1], batch_size=2).nbest(0)


@pytest.mark.parametrize("joint", [False, True])
def test_gate_r3_engine_matches_jax_engine(joint):
    """The trained gate_r3: three streams of spoken words in one engine, the
    joint step's kernel off and on (its plain version here), token-exact with
    the JAX engine and with the port's single-stream sessions."""
    audios = [synth_audio(seed=40 + k, words=3 + 2 * k) for k in range(3)]

    def drive(eng):
        sids = {k: eng.open_stream() for k in range(3)}
        for k, a in enumerate(audios):
            eng.push_audio(sids[k], a[:8000 * (k + 1)])
        eng.step()
        for k, a in enumerate(audios):
            eng.push_audio(sids[k], a[8000 * (k + 1):])
            eng.finalize_stream(sids[k])
        eng.run_until_drained()
        return sids

    models = (JModel.from_model_dir(GATE_R3, runtime=JRuntime()),
              ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu"))
    ref, got = both(models, 4, drive, use_pallas_joint=joint)
    for k, a in enumerate(audios):
        assert got[k] == ref[k] == [_single_stream_tokens(models[1], a)], f"stream {k}"
        assert len(got[k][0]) > 0


def test_encode_with_per_row_vectors_matches_jax(models):
    """``encode(cache_drop_vec=, valid_cap_vec=)`` closed loop at B=2 against
    JAX: row 0 steady, row 1 flushing (cache_drop 0, every valid step
    emitted) at every other chunk; outputs, lengths and caches."""
    from trt_asr_tpu.models.parakeet import encoder as jenc
    from trt_asr_tpu_torch.models.parakeet import encoder as penc

    jm, pm = models
    cfg = pm.cfg
    frames = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
    tq = penc.subsampled_length(frames, cfg.stride_stages) - cfg.drop_extra_pre_encoded
    st_j, st_p = jenc.init_encoder_state(jm.cfg, 2), penc.init_encoder_state(cfg, 2)
    rng = np.random.default_rng(12)
    layers = penc.layer_params(pm.params, cfg.num_layers)
    for k in range(6):
        x = (0.5 * rng.standard_normal((2, frames, cfg.feat_in))).astype(np.float32)
        valid = np.array([frames, frames - 7 * (k % 2)], np.int32)
        cdv = np.array([cfg.cache_drop_size, 0 if k % 2 else cfg.cache_drop_size], np.int32)
        vcv = np.array([cfg.valid_out_len, tq if k % 2 else cfg.valid_out_len], np.int32)
        kw = dict(drop_extra=cfg.drop_extra_pre_encoded)
        enc_j, len_j, st_j = jenc.encode(jm.params, jm.cfg, x, valid, st_j, cache_drop_vec=cdv,
                                         valid_cap_vec=vcv, **kw)
        enc_p, len_p, st_p = penc.encode(pm.params, cfg, t(x), t(valid), st_p,
                                         cache_drop_vec=t(cdv), valid_cap_vec=t(vcv),
                                         layers=layers, **kw)
        np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
        for b in range(2):
            n = int(np.asarray(len_j)[b])
            np.testing.assert_allclose(enc_p[b, :n].numpy(), np.asarray(enc_j)[b, :n],
                                       atol=1e-4, rtol=1e-4, err_msg=f"chunk {k} row {b}")
        for name in ("att_cache", "time_cache", "kv_cache"):
            np.testing.assert_allclose(getattr(st_p, name).numpy(),
                                       np.asarray(getattr(st_j, name)), atol=1e-4, rtol=1e-4,
                                       err_msg=f"chunk {k} {name}")
        for name in ("cache_len", "cursor"):
            np.testing.assert_array_equal(getattr(st_p, name).numpy(),
                                          np.asarray(getattr(st_j, name)))
    assert int(st_p.cache_len[0]) != int(st_p.cache_len[1])


def test_reset_decode_state_rows_matches_jax(models):
    """A primed, then advanced batch-3 decode state with row 1 reset."""
    from trt_asr_tpu.decode import init_decode_state as j_init, prime_decode_state as j_prime
    from trt_asr_tpu.decode.batched import reset_decode_state_rows as j_reset
    from trt_asr_tpu.models.parakeet.predictor import predictor_step as j_pred
    from trt_asr_tpu_torch.decode.batched import reset_decode_state_rows
    from trt_asr_tpu_torch.decode.tdt_greedy import DecodeState

    jm, pm = models
    prompt = [3, 7]
    st = j_prime(jm.params, jm.cfg, j_init(jm.cfg, 3), prompt)
    g, h, c = j_pred(jm.params["predictor"], jnp.asarray([5, 9, 11]), st.h, st.c)
    st = st._replace(g=g, h=h, c=c, y_id=jnp.asarray([5, 9, 11], jnp.int32),
                     time_carry=jnp.asarray([1, 2, 3], jnp.int32))
    mask = np.array([False, True, False])
    want = j_reset(jm.params, jm.cfg, st, jnp.asarray(mask), prompt)
    got = reset_decode_state_rows(pm.params, pm.cfg,
                                  DecodeState(*[torch.as_tensor(np.array(v)) for v in st]),
                                  torch.as_tensor(mask), prompt)
    for name, g_, w_ in zip(DecodeState._fields, got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), atol=1e-6, err_msg=name)
    assert got.time_carry.tolist() == [1, 0, 3]
