"""Offline transcription of the PyTorch port against the JAX package:
``offline_encode`` (mixed-length batch, padded tails masked or not, flash
attention off and on, with the flash wrapper called once per layer; in
bf16 too, with the rel-shift wrapper forced on the path),
``tdt_greedy_decode_chunk`` (tokens, frames, durations, confidences and
state, with the blank penalty, the leading-punct mask, the ``max_symbols``
cap, ``time_carry`` over chunks and the fused joint step; equal to
``tdt_greedy_decode_batch`` at B=1), ``transcribe_offline`` and
``transcribe_batch`` on tiny random weights and on the trained gate_r3
(windows, length buckets, an empty list and a zero-length audio; batch equal
to per-utterance), and the batch CLI.

Tolerance: encoder outputs 1e-4 absolute and relative (f32, 2 layers) and
one bf16 ulp (bf16);
tokens, counts, frames, durations and time_carry exact; confidences 1e-4
and predictor state 1e-5 absolute; transcripts token-exact."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (GATE_R3, assert_within_bf16_ulp, np_tree, spy_calls,
                                synth_audio, t)

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.decode import tdt_greedy as jtdt
from trt_asr_tpu.models.parakeet import encoder as jenc
from trt_asr_tpu.models.parakeet.model import ParakeetTDT as JModel
from trt_asr_tpu.models.parakeet.params import cast_params_for_compute as j_cast
from trt_asr_tpu.models.parakeet.params import init_params as j_init
from trt_asr_tpu_torch import transcribe_batch as cli
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.decode import tdt_greedy as ptdt
from trt_asr_tpu_torch.decode.batched import tdt_greedy_decode_batch
from trt_asr_tpu_torch.io.wav import load_wav, save_wav
from trt_asr_tpu_torch.models.parakeet import encoder as penc
from trt_asr_tpu_torch.models.parakeet import cast_params_for_compute
from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT
from trt_asr_tpu_torch.models.parakeet.params import params_from_numpy
from trt_asr_tpu_torch.ops import attention as patt

ATOL = RTOL = 1e-4
PROMPT = [5, 17]


@pytest.fixture(scope="module")
def models():
    cfg_j = JConfig.tiny()
    params_j = j_init(cfg_j, seed=11)
    return cfg_j, params_j, ModelConfig.tiny(), params_from_numpy(np_tree(params_j))


@pytest.fixture(scope="module")
def cast_models(models):
    """The tiny models with cast_params_for_compute's bf16 weights."""
    cfg_j, params_j, cfg, params = models
    return (cfg_j, j_cast(params_j, jnp.bfloat16), cfg,
            cast_params_for_compute(params, torch.bfloat16))


def encoder_inputs(cfg):
    """Features of two utterances, 168 and 111 frames, padded to 168."""
    feats = (0.5 * np.random.default_rng(2).standard_normal((2, 168, cfg.feat_in))
             ).astype(np.float32)
    return feats, np.array([168, 111], np.int32)


@pytest.mark.parametrize("mask_pad", [False, True])
@pytest.mark.parametrize("flash", [False, True])
def test_offline_encode_matches_jax(models, mask_pad, flash, monkeypatch):
    cfg_j, params_j, cfg, params = models
    calls = spy_calls(monkeypatch, patt, ("flash_bias_attention", "rel_pos_bias_shifted"))
    feats, lengths = encoder_inputs(cfg)
    want, wl = jenc.offline_encode(params_j, cfg_j, feats, lengths, use_flash_att=flash,
                                   mask_pad_subsample=mask_pad)
    got, gl = penc.offline_encode(params, cfg, t(feats), t(lengths), use_flash_att=flash,
                                  mask_pad_subsample=mask_pad)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    for i in range(2):
        n = int(gl[i])
        np.testing.assert_allclose(got[i, :n].numpy(), np.asarray(want)[i, :n],
                                   atol=ATOL, rtol=RTOL)
    assert calls == {"flash_bias_attention": cfg.num_layers if flash else 0,
                     "rel_pos_bias_shifted": 0}


def jax_offline_encode_bf16(params_j, cfg_j, feats, lengths, **kw):
    """The JAX package's bf16 offline_encode, compiled with XLA's excess
    precision off, so that every bf16 value the program names is rounded
    where the program says (XLA may otherwise keep f32 between fused ops)."""
    fn = jax.jit(functools.partial(jenc.offline_encode, cfg=cfg_j,
                                   compute_dtype=jnp.bfloat16, **kw))
    args = dict(feats=jnp.asarray(feats), lengths=jnp.asarray(lengths))
    compiled = fn.lower(params_j, **args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(params_j, **args)


KERNEL_FLAGS = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("weights,flash,shift_kernel", [
    pytest.param(w, f, s, id=f"{f}-{s}" if w == "f32" else f"bf16w-{f}-{s}")
    for w in ("f32", "bf16") for f, s in KERNEL_FLAGS])
def test_offline_encode_bf16_matches_jax(models, cast_models, weights, flash, shift_kernel,
                                         monkeypatch):
    """bf16 offline_encode (padded tails masked) against the JAX package in
    bf16, with f32 weights and with the weights of cast_params_for_compute
    (bf16 but the norm parameters: the JAX package's bf16 configuration):
    the rounding points of the subsampler, the layers, the positional
    projection and the offline attention, with the flash wrapper and, forced,
    the rel-shift wrapper on the path. XLA's CPU backend expands a bf16
    logistic as 1 / (1 + exp(-x)) with each step rounded to bf16, where
    torch.sigmoid (and the TPU's f32 logistic) rounds the f32 sigmoid once;
    the JAX side takes its sigmoid so rounded, and every other op as it is.

    Tolerance: one bf16 ulp of each value (the readings are 0: the two agree
    bit for bit). A subsampler that rounds its depthwise weights to bf16
    puts about half of a row's values past it, and so does XLA's own bf16
    sigmoid (the next test)."""
    cfg_j, params_j, cfg, params = models if weights == "f32" else cast_models
    xla_sigmoid = jax.nn.sigmoid
    monkeypatch.setattr(jax.nn, "sigmoid",
                        lambda a: xla_sigmoid(a.astype(jnp.float32)).astype(a.dtype))
    if shift_kernel:
        monkeypatch.setattr(penc, "rel_pos_attention_kv", functools.partial(
            patt.rel_pos_attention_kv, use_shift_kernel=True))
    calls = spy_calls(monkeypatch, patt, ("flash_bias_attention", "rel_pos_bias_shifted"))
    feats, lengths = encoder_inputs(cfg)
    want, wl = jax_offline_encode_bf16(params_j, cfg_j, feats, lengths, use_flash_att=flash,
                                       mask_pad_subsample=True)
    got, gl = penc.offline_encode(params, cfg, t(feats), t(lengths),
                                  compute_dtype=torch.bfloat16, use_flash_att=flash,
                                  mask_pad_subsample=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    want = np.array(want.astype(jnp.float32))
    for i in range(2):
        n = int(gl[i])
        assert_within_bf16_ulp(got[i, :n], want[i, :n])
    assert calls == {"flash_bias_attention": cfg.num_layers if flash else 0,
                     "rel_pos_bias_shifted": cfg.num_layers if shift_kernel else 0}


def test_bf16_tolerance_sees_one_rounding_point(models):
    """The one-ulp tolerance above sees a single rounding point: with XLA's
    own bf16 sigmoid (four rounded steps where the port rounds once) the
    JAX encoder lies past it on a large share of the values."""
    cfg_j, params_j, cfg, params = models
    feats, lengths = encoder_inputs(cfg)
    want, _ = jax_offline_encode_bf16(params_j, cfg_j, feats, lengths, use_flash_att=True,
                                      mask_pad_subsample=True)
    got, gl = penc.offline_encode(params, cfg, t(feats), t(lengths),
                                  compute_dtype=torch.bfloat16, use_flash_att=True,
                                  mask_pad_subsample=True)
    for i in range(2):
        n = int(gl[i])
        w = torch.from_numpy(np.array(want[i, :n].astype(jnp.float32)))
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
        share = float(((got[i, :n].float() - w).abs() > ulp).float().mean())
        assert share > 0.2, f"row {i}: only {share:.2%} of the values past one bf16 ulp"


def test_padded_row_equals_its_exact_length_run(models):
    """mask_pad_subsample: a padded batch row encodes as its own run."""
    _, _, cfg, params = models
    feats = torch.randn(2, 200, cfg.feat_in, generator=torch.Generator().manual_seed(0))
    got, gl = penc.offline_encode(params, cfg, feats, torch.tensor([200, 90]),
                                  mask_pad_subsample=True)
    alone, al = penc.offline_encode(params, cfg, feats[1:, :90], torch.tensor([90]))
    n = int(al[0])
    assert int(gl[1]) == n
    np.testing.assert_allclose(got[1, :n].numpy(), alone[0, :n].numpy(), atol=1e-5, rtol=1e-5)


def decode_both(models, enc, t_enc, sj, sp, emitted, *, kernel, **kw):
    cfg_j, params_j, cfg, params = models
    tj, nj, sj, (fj, dj, lj) = jtdt.tdt_greedy_decode_chunk(
        params_j, cfg_j, jnp.asarray(enc), jnp.int32(t_enc), sj,
        emitted_so_far=jnp.int32(emitted), use_pallas_joint=kernel, pallas_interpret=True,
        with_timestamps=True, **{k: jnp.asarray(v) if k == "punct_mask" else v
                                 for k, v in kw.items()})
    tp, np_, sp, (fp, dp, lp) = ptdt.tdt_greedy_decode_chunk(
        params, cfg, t(enc), t_enc, sp, emitted_so_far=emitted, use_pallas_joint=kernel,
        with_timestamps=True, **kw)
    assert int(np_) == int(nj)
    for got, want in ((tp, tj), (fp, fj), (dp, dj)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_array_equal(sp.time_carry.numpy(), np.asarray(sj.time_carry))
    for name in ("g", "h", "c"):
        np.testing.assert_allclose(getattr(sp, name).numpy(), np.asarray(getattr(sj, name)),
                                   atol=1e-5)
    return sj, sp, int(np_)


@pytest.mark.parametrize("penalty,punct,kernel,max_symbols,tq", [
    (0.0, False, False, None, 20),
    (1.5, True, True, None, 20),
    (-2.0, False, False, 1, 9),       # emits on most steps: the cap and time_carry
    (0.5, True, True, 2, 160),        # longer than the batched decoder's blank-run limit
])
def test_decode_chunk_matches_jax(models, penalty, punct, kernel, max_symbols, tq):
    cfg_j, params_j, cfg, params = models
    rng = np.random.default_rng(tq)
    pmask = np.zeros(cfg.token_head_size, bool)
    pmask[rng.integers(0, cfg.vocab_size, size=cfg.vocab_size // 3)] = True
    sj = jtdt.prime_decode_state(params_j, cfg_j, jtdt.init_decode_state(cfg_j, 1), PROMPT)
    sp = ptdt.prime_decode_state(params, cfg, ptdt.init_decode_state(cfg, 1), PROMPT)
    emitted = carried = 0
    for _ in range(3):
        enc = (rng.standard_normal((tq, cfg.d_model)) * 1.5).astype(np.float32)
        t_enc = int(rng.integers(tq // 2, tq + 1))
        sj, sp, n = decode_both(models, enc, t_enc, sj, sp, emitted, kernel=kernel,
                                max_tokens=cfg.max_symbols_per_timestep * tq,
                                max_symbols=max_symbols, blank_penalty=penalty,
                                punct_mask=pmask, use_punct_mask=punct)
        emitted += n
        carried = max(carried, int(sp.time_carry[0]))
    assert emitted > 0
    if max_symbols == 1:
        assert carried > 0


def test_decode_chunk_equals_batch_at_one_row(models):
    _, _, cfg, params = models
    rng = np.random.default_rng(5)
    enc = t((rng.standard_normal((1, 30, cfg.d_model)) * 1.5).astype(np.float32))
    state = ptdt.prime_decode_state(params, cfg, ptdt.init_decode_state(cfg, 1), PROMPT)
    kw = dict(max_tokens=cfg.max_symbols_per_timestep * 30, blank_penalty=0.3,
              with_timestamps=True)
    tc, nc, sc, stamps_c = ptdt.tdt_greedy_decode_chunk(params, cfg, enc[0], 27, state, **kw)
    tb, nb, sb, stamps_b = tdt_greedy_decode_batch(params, cfg, enc, torch.tensor([27]),
                                                   state, **kw)
    assert int(nc) == int(nb[0]) > 0
    assert torch.equal(tc, tb[0])
    for x, y in zip(stamps_c, stamps_b):
        assert torch.equal(x, y[0])
    for x, y in zip(sc, sb):
        assert torch.equal(x, y)


def sine_audios():
    rng = np.random.default_rng(4)
    out = []
    for i, n in enumerate((16000, 24000, 30000)):
        s = np.arange(n)
        out.append((0.4 * np.sin(2 * np.pi * (260 + 60 * i) * s / 16000)
                    + 0.1 * rng.standard_normal(n)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def tiny_pair():
    jm = JModel.random(JConfig.tiny(), seed=5)
    pm = ParakeetTDT(ModelConfig.tiny(), np_tree(jm.params), jm.tokenizer, device="cpu")
    return jm, pm


@pytest.mark.parametrize("windows", [dict(), dict(max_frames=64, pad_multiple=32)])
def test_transcribe_matches_jax_tiny(tiny_pair, windows):
    jm, pm = tiny_pair
    audios = sine_audios()
    per_utt = dict(max_frames=windows["max_frames"]) if windows else {}
    want = [jm.transcribe_offline(a, **per_utt) for a in audios]
    assert any(ids for _, ids in want), "degenerate: nothing emitted"
    got = [pm.transcribe_offline(a, **per_utt) for a in audios]
    assert got == want
    assert pm.transcribe_batch(audios, **windows) == want


def test_transcribe_degenerate_inputs(tiny_pair):
    jm, pm = tiny_pair
    audio = sine_audios()[0]
    assert pm.transcribe_batch([]) == jm.transcribe_batch([]) == []
    got = pm.transcribe_batch([np.zeros(0, np.float32), audio])
    assert got == jm.transcribe_batch([np.zeros(0, np.float32), audio])
    assert got[0] == ("", []) and got[1] == pm.transcribe_offline(audio)
    assert pm.transcribe_offline(np.zeros(0, np.float32)) == ("", [])
    # a one-device mesh (parallel/mesh.py) transcribes as no mesh; more raise
    from trt_asr_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    assert pm.transcribe_batch([audio], mesh=make_mesh(devices=[cpu])) == [got[1]]
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pm.transcribe_batch([audio], mesh=make_mesh(dp=2, devices=[cpu, cpu]))


def test_transcribe_matches_jax_gate_r3():
    jm = JModel.from_model_dir(GATE_R3)
    pm = ParakeetTDT.from_model_dir(GATE_R3, device="cpu")
    audios = [synth_audio(seed=s, words=w) for s, w in ((41, 7), (42, 4))]
    want = [jm.transcribe_offline(a) for a in audios]
    assert all(ids for _, ids in want)
    assert [pm.transcribe_offline(a) for a in audios] == want
    assert pm.transcribe_batch(audios) == jm.transcribe_batch(audios) == want


def test_decode_batch_with_cast_gate_r3_matches_jax():
    """The offline bench path's decode with cast_params_for_compute's bf16
    weights (bf16 predictor embedding and LSTM, bf16 joint): gate_r3, the
    JAX package's bf16 encoder output of two utterances, decoded by both
    packages token for token."""
    from trt_asr_tpu.decode import batched as jbat

    jm = JModel.from_model_dir(GATE_R3)
    pm = ParakeetTDT.from_model_dir(GATE_R3, device="cpu")
    params_j = j_cast(jm.params, jnp.bfloat16)
    params = cast_params_for_compute(pm.params, torch.bfloat16)
    x, lens = pm.batch_features([synth_audio(seed=s, words=w) for s, w in ((43, 7), (44, 4))])
    enc, t_enc = jax_offline_encode_bf16(params_j, jm.cfg, x.numpy(), lens,
                                         mask_pad_subsample=True)
    enc = np.array(enc.astype(jnp.float32))
    t_enc = np.asarray(t_enc).astype(np.int32)
    kw = dict(max_tokens=pm.cfg.max_symbols_per_timestep * enc.shape[1], use_pallas_joint=True,
              with_timestamps=True)
    sj = jtdt.prime_decode_state(params_j, jm.cfg, jtdt.init_decode_state(jm.cfg, 2),
                                 jm.prompt_ids)
    sp = ptdt.prime_decode_state(params, pm.cfg, ptdt.init_decode_state(pm.cfg, 2),
                                 pm.prompt_ids)
    tj, nj, sj, stamps_j = jbat.tdt_greedy_decode_batch(
        params_j, jm.cfg, jnp.asarray(enc), jnp.asarray(t_enc), sj, pallas_interpret=True, **kw)
    tp, np_, sp, stamps_p = tdt_greedy_decode_batch(params, pm.cfg, t(enc), t(t_enc), sp, **kw)
    assert int(np.asarray(nj).min()) > 0
    np.testing.assert_array_equal(np_.numpy(), np.asarray(nj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    for got, want in zip(stamps_p[:2], stamps_j[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sp.y_id.numpy(), np.asarray(sj.y_id))


def test_batch_cli(tmp_path, capsys):
    audios = sine_audios()[:2]
    paths = []
    for i, a in enumerate(audios):
        paths.append(str(tmp_path / f"u{i}.wav"))
        save_wav(paths[-1], a)
    model = ParakeetTDT.random(ModelConfig.tiny(), device="cpu")
    want = model.transcribe_batch([load_wav(p) for p in paths])
    assert cli.main([*paths, "--synthetic-model", "tiny", "--json", "--device", "cpu",
                     "--batch", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["audio"], x["text"], x["tokens"]) for x in lines] == \
        [(p, text, ids) for p, (text, ids) in zip(paths, want)]
