"""The port's training step (``trt_asr_tpu_torch/train/``) against the JAX
package on the CPU: the LSTM, predictor and joint sequences, the TDT NLL
of ``training_forward`` (offline and through the serving chunk schedule),
the parameter gradients, remat, the optimizers and their schedules with
clipping and accumulation, the SpecAugment step, learning, the toy entry
point, and the encoder state under autograd (built out of place) beside
the serving one (written in place).

Tolerances: ``lstm_sequence``, ``predictor_sequence`` and ``joint_apply``
1e-5; the NLL 1e-4 (relative and absolute); each parameter gradient leaf
max |diff| <= 1e-4 * max(1, max |g|) against ``jax.grad`` without remat
(computed in a subprocess); remat against no remat on the port 1e-6;
``streaming_encode_train`` against the port's serving chunk loop 1e-5 on
the steps both emit; parameters after 3 optimizer steps within 1e-6 of
optax's; two accumulated half batches against one full batch (SGD) rtol
1e-5, atol 1e-7, as tests/test_augment.py holds JAX."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import np_tree, one_torch_thread, start_jax_subprocess, t  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.models.parakeet import init_params as j_init
from trt_asr_tpu.models.parakeet.joint import joint_apply as j_joint_apply
from trt_asr_tpu.models.parakeet.predictor import predictor_sequence as j_pred_seq
from trt_asr_tpu.train import make_optimizer as j_make_optimizer
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet import encoder as penc
from trt_asr_tpu_torch.models.parakeet.joint import joint_apply
from trt_asr_tpu_torch.models.parakeet.params import init_params, params_from_numpy
from trt_asr_tpu_torch.models.parakeet.predictor import init_predictor_state, predictor_sequence
from trt_asr_tpu_torch.ops.lstm import lstm_sequence
from trt_asr_tpu_torch.train import make_optimizer, make_train_step, optim, training_forward
from trt_asr_tpu_torch.train.train_step import Batch, streaming_encode_train

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TINY_TRAIN = dict(num_layers=1, d_model=32, n_heads=4, subsampling_conv_channels=8,
                  vocab_size=16, pred_hidden=16, joint_hidden=16, feat_in=16)


def multi_batch(cfg):
    """Two rows over several chunks (T 200 and 150), unequal label counts."""
    rng = np.random.default_rng(0)
    b, t_len, u = 2, 200, 4
    return Batch(feats=rng.standard_normal((b, t_len, cfg.feat_in)).astype(np.float32),
                 feat_len=np.array([t_len, 150], np.int32),
                 labels=rng.integers(0, cfg.vocab_size, (b, u)).astype(np.int32),
                 label_len=np.array([u, 3], np.int32))


def tiny_batch(cfg):
    """tests/test_training.py's fixture batch: 2 rows of 57 frames, 3 labels."""
    rng = np.random.default_rng(0)
    b, t_len, u = 2, 57, 3
    return Batch(feats=rng.standard_normal((b, t_len, cfg.feat_in)).astype(np.float32),
                 feat_len=np.full((b,), t_len, np.int32),
                 labels=np.array([[3, 7, 11], [5, 2, 9]], np.int32),
                 label_len=np.full((b,), u, np.int32))


def port_params(cfg, seed=0):
    return init_params(cfg, seed=seed)


def port_grads(params, cfg, batch, **kw):
    leaves = optim.tree_leaves(params)
    live = [x.detach().clone().requires_grad_(True) for x in leaves]
    p = optim.tree_unflatten(params, live)
    nll = training_forward(p, cfg, batch, **kw)
    return nll.detach().numpy(), [g.numpy() for g in torch.autograd.grad(nll.mean(), live)]


# --- sequences -----------------------------------------------------------


def test_lstm_predictor_joint_sequences_match_jax():
    cfg = ModelConfig.tiny()
    np_p = np_tree(j_init(JConfig.tiny(), seed=2))
    pp = params_from_numpy(np_p)
    rng = np.random.default_rng(4)
    b, u, tt = 2, 5, 7
    y = rng.integers(0, cfg.vocab_size + 1, (b, u)).astype(np.int32)
    y[:, 0] = cfg.blank_id                      # the start symbol indexes its zero row
    h0 = rng.standard_normal((cfg.pred_rnn_layers, b, cfg.pred_hidden)).astype(np.float32)
    c0 = rng.standard_normal((cfg.pred_rnn_layers, b, cfg.pred_hidden)).astype(np.float32)
    g, h, c = predictor_sequence(pp["predictor"], t(y), t(h0), t(c0))
    jg, jh, jc = j_pred_seq(np_p["predictor"], jnp.asarray(y), h0, c0)
    for got, want in ((g, jg), (h, jh), (c, jc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    x = rng.standard_normal((b, u, cfg.pred_hidden)).astype(np.float32)
    out, _, _ = lstm_sequence(pp["predictor"]["lstm"], t(x), t(h0), t(c0))
    from trt_asr_tpu.ops.lstm import lstm_sequence as j_lstm_seq
    jout, _, _ = j_lstm_seq(np_p["predictor"]["lstm"], jnp.asarray(x), h0, c0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=1e-5)
    z0, zc = init_predictor_state(cfg, b)
    assert z0.shape == (cfg.pred_rnn_layers, b, cfg.pred_hidden) and not z0.any() and not zc.any()
    enc = rng.standard_normal((b, tt, cfg.d_model)).astype(np.float32)
    logits = joint_apply(pp["joint"], t(enc), g)
    want = j_joint_apply(np_p["joint"], jnp.asarray(enc), jnp.asarray(g.numpy()))
    assert logits.shape == (b, tt, u, cfg.joint_vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# --- the encoder state: fresh under autograd, in place when serving -------


def test_encoder_state_out_of_place_under_grad_in_place_serving():
    cfg = ModelConfig.tiny()
    params = port_params(cfg)
    rng = np.random.default_rng(5)
    x = t(rng.standard_normal((1, 57, cfg.feat_in)).astype(np.float32))
    kw = dict(drop_extra=cfg.drop_extra_pre_encoded, cache_drop=cfg.cache_drop_size,
              valid_cap=cfg.valid_out_len)
    s0 = penc.init_encoder_state(cfg, 1)
    s0.att_cache.normal_()
    before = [c.clone() for c in s0[:3]]
    # serving: the caches are written in place and the new state holds them
    e_srv, _, s_srv = penc.encode(params, cfg, x, torch.tensor([57]), s0, **kw)
    assert all(a is b for a, b in zip(s_srv[:3], s0[:3]))
    assert not torch.equal(s0.att_cache, before[0])
    # under autograd: fresh caches, the state passed in left as it was
    s1 = penc.init_encoder_state(cfg, 1)
    s1.att_cache.copy_(before[0])
    live = optim.tree_unflatten(params, [v.clone().requires_grad_(True)
                                         for v in optim.tree_leaves(params)])
    e_tr, _, s_tr = penc.encode(live, cfg, x, torch.tensor([57]), s1, **kw)
    assert all(a is not b for a, b in zip(s_tr[:3], s1[:3]))
    torch.testing.assert_close(s1.att_cache, before[0], atol=0, rtol=0)
    for a, b in zip(s_tr, s_srv):
        torch.testing.assert_close(a.detach(), b, atol=0, rtol=0)
    torch.testing.assert_close(e_tr.detach(), e_srv, atol=0, rtol=0)
    # the kernels have no backward
    with pytest.raises(ValueError, match="no backward"):
        penc.encode(live, cfg, x, torch.tensor([57]), s1, use_pallas_ffn=True, **kw)


def test_streaming_encode_train_matches_serving_chunk_loop():
    """JAX's test of the same name on the port: the chunk loop of training
    emits, on every step the steady chunks emit, what the serving schedule
    (``ChunkScheduler(unified=True)`` over ``encode``) emits."""
    from trt_asr_tpu_torch.ops.conv import subsampled_length
    from trt_asr_tpu_torch.streaming.schedule import ChunkScheduler, extract_chunk

    cfg = ModelConfig.tiny(num_layers=2, d_model=32, n_heads=4, subsampling_conv_channels=8,
                           vocab_size=16, pred_hidden=16, joint_hidden=16, feat_in=16,
                           att_cache_size=16)
    params = port_params(cfg, seed=1)
    rng = np.random.default_rng(3)
    lens = [173, 141]
    b, tt = len(lens), max(lens)
    feats = rng.standard_normal((b, tt, cfg.feat_in)).astype(np.float32)
    for i, n in enumerate(lens):
        feats[i, n:] = 0.0
    enc, enc_len = streaming_encode_train(params, cfg, t(feats), torch.tensor(lens))
    assert enc_len.tolist() == subsampled_length(torch.tensor(lens), cfg.stride_stages).tolist()
    for i, n in enumerate(lens):
        sched = ChunkScheduler(cfg, unified=True)
        state = penc.init_encoder_state(cfg, 1)
        got = []
        while True:
            spec = sched.next_ready(n)
            is_last = spec is None
            if is_last:
                spec = sched.flush(n)
            if spec is None:
                break
            x = extract_chunk(feats[i, :n], spec)
            valid = (max(-spec.slice_start, 0)
                     + max(min(spec.slice_end, n) - max(spec.slice_start, 0), 0))
            e, out_len, state = penc.encode(
                params, cfg, t(x)[None], torch.tensor([valid]), state,
                drop_extra=spec.drop_extra, cache_drop=0 if is_last else cfg.cache_drop_size,
                valid_cap=None if is_last else cfg.valid_out_len)
            got.append(e[0, :int(out_len[0])].numpy())
            if is_last:
                break
        ref = np.concatenate(got, axis=0)
        n_steady = (len(got) - 1) * cfg.valid_out_len
        assert int(enc_len[i]) >= n_steady
        np.testing.assert_allclose(enc[i, :n_steady].numpy(), ref[:n_steady], rtol=0, atol=1e-5)
        assert ref.shape[0] == int(enc_len[i]), "flush tail must tile to sub_len"


def test_streaming_rejects_regimes_serving_does_not_run():
    params = port_params(ModelConfig.tiny())
    x, n = torch.zeros((1, 60, 32)), torch.tensor([60])
    with pytest.raises(ValueError, match="nemo_compat_chunk0"):
        streaming_encode_train(params, ModelConfig.tiny(nemo_compat_chunk0=True), x, n)
    with pytest.raises(ValueError, match="does not tile"):
        streaming_encode_train(params, ModelConfig.tiny(shift_size_frames=(16, 24)), x, n)


def test_training_refuses_int8_leaves_and_other_dtypes():
    from trt_asr_tpu_torch.models.parakeet.quant import quantize_params

    cfg = ModelConfig.tiny(**TINY_TRAIN)
    batch = tiny_batch(cfg)
    with pytest.raises(TypeError, match="int8"):
        training_forward(quantize_params(port_params(cfg), "encoder"), cfg, batch)
    with pytest.raises(ValueError, match="float32"):
        training_forward(port_params(cfg), cfg, batch, compute_dtype=torch.bfloat16)


# --- the optimizers against optax ----------------------------------------


def _opt_params():
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "layers": [rng.standard_normal(5).astype(np.float32),
                       rng.standard_normal((2, 2)).astype(np.float32)],
            "b": rng.standard_normal(3).astype(np.float32)}


def _grads(k, scale):
    rng = np.random.default_rng(100 + k)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                        _opt_params())


OPTIMIZERS = {
    # name: (port transformation, optax transformation, gradient scale)
    "adam": (lambda: optim.adam(1e-2), lambda: optax.adam(1e-2), 1.0),
    "adamw": (lambda: optim.adamw(1e-2), lambda: optax.adamw(1e-2), 1.0),
    "sgd": (lambda: optim.sgd(1e-2), lambda: optax.sgd(1e-2), 1.0),
}
for _sched in ("noam", "cosine_warmup", "constant"):
    for _clip, _scale in (("clipped", 10.0), ("unclipped", 0.01)):
        OPTIMIZERS[f"{_sched}_{_clip}"] = (
            functools.partial(lambda s: make_optimizer(1e-2, schedule=s, warmup_steps=2,
                                                       total_steps=6)[0], _sched),
            functools.partial(lambda s: j_make_optimizer(1e-2, schedule=s, warmup_steps=2,
                                                         total_steps=6)[0], _sched),
            _scale)
OPTIMIZERS["accum2"] = (lambda: make_optimizer(1e-2, schedule="constant", accum_steps=2)[0],
                        lambda: j_make_optimizer(1e-2, schedule="constant", accum_steps=2)[0],
                        1.0)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """3 updates of the same gradients: parameters and every state leaf (in
    optax's leaf order) within 1e-6; the clipped cases' global norms reach
    the limit (1.0), the unclipped ones' stay under it."""
    port_tx, optax_tx, scale = OPTIMIZERS[name]
    jp = jax.tree.map(jnp.asarray, _opt_params())
    pp = params_from_numpy(_opt_params())
    tx, jtx = port_tx(), optax_tx()
    ps, js = tx.init(pp), jtx.init(jp)
    assert len(optim.tree_leaves(ps)) == len(jax.tree.leaves(js))
    moved = []
    for k in range(3):
        g = _grads(k, scale)
        if "clipped" in name:
            norm = float(optax.global_norm(g))
            assert (norm >= 1.0) == name.endswith("_clipped"), norm
        ju, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        pu, ps = tx.update(params_from_numpy(g), ps, pp)
        pp = optim.apply_updates(pp, pu)
        moved.append(float(max(np.abs(np.asarray(x)).max() for x in jax.tree.leaves(ju))))
    for a, b in zip(optim.tree_leaves(pp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    for a, b in zip(optim.tree_leaves(ps), jax.tree.leaves(js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    if name.startswith("cosine"):
        assert moved[0] == 0.0           # the warmup starts at lr 0
    if name == "accum2":
        assert moved[0] == 0.0 and moved[1] > 0 and moved[2] == 0.0


def test_schedules_match_optax():
    for sched, steps in (("noam", [0, 1, 50, 100, 1000]),
                         ("cosine_warmup", [0, 5, 10, 55, 100, 150]), ("constant", [0, 7])):
        _, pf = make_optimizer(1e-3, schedule=sched, warmup_steps=10 if sched != "noam" else 100,
                               total_steps=100, min_lr_ratio=0.1)
        _, jf = j_make_optimizer(1e-3, schedule=sched, warmup_steps=10 if sched != "noam" else 100,
                                 total_steps=100, min_lr_ratio=0.1)
        for s in steps:
            got = float(pf(torch.tensor(s, dtype=torch.int32)))
            np.testing.assert_allclose(got, float(jf(jnp.int32(s))), rtol=1e-6, atol=1e-12)
    assert float(make_optimizer(1e-3, schedule="cosine_warmup")[1](torch.tensor(0))) == 0.0
    with pytest.raises(ValueError):
        make_optimizer(1e-3, schedule="nope")


def test_gradient_accumulation_matches_full_batch():
    """Two half batches under accumulation == one full batch (SGD, whose
    update is linear in the mean gradient); with make_optimizer's
    accumulation the parameters stay put after the first half and move
    after the second."""
    cfg = ModelConfig.tiny()
    rng = np.random.default_rng(0)
    b, tt, u = 4, 90, 5
    full = Batch(feats=rng.standard_normal((b, tt, cfg.feat_in)).astype(np.float32),
                 feat_len=np.full((b,), tt, np.int32),
                 labels=rng.integers(0, cfg.vocab_size, size=(b, u)).astype(np.int32),
                 label_len=np.full((b,), u, np.int32))
    halves = [Batch(*(x[i * 2:(i + 1) * 2] for x in full)) for i in range(2)]
    params = port_params(cfg, seed=1)
    init_f, step_f = make_train_step(cfg, optimizer=optim.sgd(1e-2))
    p_full, _, _ = step_f(params, init_f(params), full)
    init_a, step_a = make_train_step(cfg, optimizer=optim.multi_steps(optim.sgd(1e-2), 2))
    opt, p_acc = init_a(params), params
    for h in halves:
        p_acc, opt, _ = step_a(p_acc, opt, h)
    for x, y in zip(optim.tree_leaves(p_full), optim.tree_leaves(p_acc)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-7)

    tx_m, _ = make_optimizer(1e-3, schedule="constant", accum_steps=2)
    init_m, step_m = make_train_step(cfg, optimizer=tx_m)
    opt = init_m(params)
    p1, opt, _ = step_m(params, opt, halves[0])
    assert all(torch.equal(a, c) for a, c in zip(optim.tree_leaves(params), optim.tree_leaves(p1)))
    p2, opt, _ = step_m(p1, opt, halves[1])
    assert any(not torch.equal(a, c) for a, c in zip(optim.tree_leaves(p1), optim.tree_leaves(p2)))


# --- learning -------------------------------------------------------------


def _greedy_hits(params, cfg, batch) -> int:
    from trt_asr_tpu_torch.decode.tdt_greedy import (init_decode_state, prime_decode_state,
                                                     tdt_greedy_decode_chunk)
    from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode

    with torch.no_grad():
        enc, enc_len = offline_encode(params, cfg, t(batch.feats), t(batch.feat_len))
        hits = 0
        for i in range(enc.shape[0]):
            ds = prime_decode_state(params, cfg, init_decode_state(cfg, 1), [])
            toks, n, _ = tdt_greedy_decode_chunk(params, cfg, enc[i], enc_len[i], ds,
                                                 max_tokens=32)
            hits += [int(x) for x in toks[:int(n)]] == list(batch.labels[i])
    return hits


def test_training_reduces_loss_and_overfits():
    """tests/test_training.py's overfit on the port, in 50 steps of its 150
    (the port reads 1% of the start loss and 2 of 2 targets there): the
    loss falls below half its start and greedy decode recovers at least 1
    of the 2 targets."""
    cfg = ModelConfig.tiny(**TINY_TRAIN)
    params = port_params(cfg)
    batch = tiny_batch(cfg)
    init_opt, step = make_train_step(cfg, optim.adam(3e-3))
    opt_state = init_opt(params)
    loss0 = float(training_forward(params, cfg, batch).mean())
    losses = []
    for _ in range(50):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * loss0, f"loss {loss0:.3f} -> {losses[-1]:.3f}"
    assert _greedy_hits(params, cfg, batch) >= 1


def test_train_step_with_augment_and_schedule():
    """The SpecAugment variant takes a generator; the masks reach the loss."""
    cfg = ModelConfig.tiny()
    batch = multi_batch(cfg)
    params = port_params(cfg, seed=1)
    tx, _ = make_optimizer(1e-3, schedule="noam", warmup_steps=10)
    aug = dict(freq_masks=2, freq_width=8, time_masks=2, time_width=0.1)
    init_opt, step = make_train_step(cfg, optimizer=tx, augment=aug)
    p1, opt, m1 = step(params, init_opt(params), batch, torch.Generator().manual_seed(0))
    _, _, m2 = step(p1, opt, batch, torch.Generator().manual_seed(1))
    assert np.isfinite(float(m1["loss"])) and np.isfinite(float(m2["loss"]))
    assert float(m1["grad_norm"]) > 0
    _, _, ma = step(params, init_opt(params), batch, torch.Generator().manual_seed(2))
    _, _, mb = step(params, init_opt(params), batch, torch.Generator().manual_seed(3))
    assert float(ma["loss"]) != float(mb["loss"])


def test_toy_entry_point(capsys):
    """``python -m trt_asr_tpu_torch.train.toy`` on the CPU: it overfits,
    round-trips its checkpoint and decodes; without a card and without
    ``--device`` it raises rather than fall back to the CPU."""
    from trt_asr_tpu_torch.train import toy

    assert toy.main(["--device", "cpu", "--steps", "30"]) == 0
    out = capsys.readouterr().out
    losses = [float(ln.split("loss")[1].split()[0]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert losses[-1] < 0.5 * losses[0], out
    recovered = int(out.strip().splitlines()[-1].split()[1].split("/")[0])
    assert recovered >= 1, out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            toy.main(["--steps", "1"])


# --- the NLL and the gradients against JAX --------------------------------
# (last in the module: the subprocess that JAX computes them in starts with
# the module and runs beside the tests above)


@pytest.fixture(scope="module", autouse=True)
def jax_reference_run(tmp_path_factory):
    """JAX's per-example NLL and its parameter gradients (mean NLL, no
    remat), offline and streaming, on ModelConfig.tiny() (2 layers,
    several chunks) and :func:`multi_batch`, computed in a subprocess
    started with the module."""
    out = str(tmp_path_factory.mktemp("train") / "ref.npz")
    code = """
import jax.numpy as jnp, numpy as np
from trt_asr_tpu.config import ModelConfig
from trt_asr_tpu.models.parakeet import init_params
from trt_asr_tpu.train import training_forward
from trt_asr_tpu.train.train_step import Batch
cfg = ModelConfig.tiny()
params = init_params(cfg, seed=0)
rng = np.random.default_rng(0)
b, t_len, u = 2, 200, 4
batch = Batch(feats=rng.standard_normal((b, t_len, cfg.feat_in)).astype(np.float32),
              feat_len=np.array([t_len, 150], np.int32),
              labels=rng.integers(0, cfg.vocab_size, (b, u)).astype(np.int32),
              label_len=np.array([u, 3], np.int32))
res = {}
for mode, s in (("offline", False), ("streaming", True)):
    def loss(p):
        nll = training_forward(p, cfg, batch, streaming=s)
        return jnp.mean(nll), nll
    (_, nll), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    res[mode + "_nll"] = np.asarray(nll)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        res[f"{mode}_g{i:03d}"] = np.asarray(leaf)
np.savez(OUT, **res)
"""
    result = start_jax_subprocess(code, out)
    yield result
    result.kill()


@pytest.fixture(scope="module")
def jax_reference(jax_reference_run):
    return jax_reference_run()


@pytest.fixture(scope="module")
def port_results():
    cfg = ModelConfig.tiny()
    params = port_params(cfg)
    batch = multi_batch(cfg)
    return {(mode, remat): port_grads(params, cfg, batch, streaming=mode == "streaming",
                                      remat=remat)
            for mode in ("offline", "streaming") for remat in (False, True)}


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_training_forward_nll_matches_jax(mode, jax_reference, port_results):
    nll, _ = port_results[(mode, False)]
    np.testing.assert_allclose(nll, jax_reference[f"{mode}_nll"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_parameter_gradients_match_jax(mode, jax_reference, port_results):
    """Every leaf, in JAX's leaf order (the port's ``optim.tree_leaves``)."""
    _, grads = port_results[(mode, False)]
    want = [jax_reference[k] for k in sorted(jax_reference) if k.startswith(f"{mode}_g")]
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= tol, (mode, i, float(np.abs(g - w).max()), tol)


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_remat_leaves_gradients_unchanged(mode, port_results):
    (nll0, g0), (nll1, g1) = port_results[(mode, False)], port_results[(mode, True)]
    np.testing.assert_allclose(nll1, nll0, rtol=0, atol=1e-6)
    assert max(float(np.abs(a - b).max()) for a, b in zip(g0, g1)) <= 1e-6
