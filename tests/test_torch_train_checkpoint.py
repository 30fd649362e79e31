"""Checkpoints of the port against the JAX package's format: a port
``save_checkpoint`` loads in JAX's ``load_checkpoint`` exactly and the
reverse; a JAX train state loads into the port optimizer's template (the
same leaves in the same order); the port's train state resumes bitwise
(k steps, save, load, n - k steps equal n straight) and refuses a tampered
leaf or another optimizer's template."""

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_tree_equal, np_tree, one_torch_thread  # noqa: F401

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.models.parakeet import init_params as j_init
from trt_asr_tpu.models.parakeet.params import load_checkpoint as j_load
from trt_asr_tpu.models.parakeet.params import num_params as j_num_params
from trt_asr_tpu.models.parakeet.params import save_checkpoint as j_save
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet.params import (init_params, load_checkpoint,
                                                      num_params, params_to_numpy,
                                                      save_checkpoint)
from trt_asr_tpu_torch.train import make_optimizer, make_train_step, optim
from trt_asr_tpu_torch.train.checkpoint import load_train_state, save_train_state
from trt_asr_tpu_torch.train.train_step import Batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFG = dict(num_layers=1, d_model=32, n_heads=4, subsampling_conv_channels=8, vocab_size=16,
           pred_hidden=16, joint_hidden=16, feat_in=16)


def tiny_batch(cfg):
    rng = np.random.default_rng(0)
    return Batch(feats=rng.standard_normal((2, 57, cfg.feat_in)).astype(np.float32),
                 feat_len=np.full((2,), 57, np.int32),
                 labels=np.array([[3, 7, 11], [5, 2, 9]], np.int32),
                 label_len=np.full((2,), 3, np.int32))


def test_weights_cross_load_with_jax(tmp_path):
    jp = np_tree(j_init(JConfig.tiny(), seed=3))
    pp = init_params(ModelConfig.tiny(), seed=3)
    assert num_params(pp) == j_num_params(jp)
    save_checkpoint(str(tmp_path / "port"), pp, {"by": "port"})
    assert_tree_equal(np_tree(j_load(str(tmp_path / "port"))), params_to_numpy(pp))
    j_save(str(tmp_path / "jax"), jp, {"by": "jax"})
    assert_tree_equal(params_to_numpy(load_checkpoint(str(tmp_path / "jax"))), jp)
    import json
    for d in ("port", "jax"):
        with open(tmp_path / d / "manifest.json") as f:
            man = json.load(f)
        assert man["format"] == "trt-asr-tpu/npz/v1" and man["num_params"] == num_params(pp)


def test_jax_train_state_loads_into_port_template(tmp_path):
    """optax's leaves and the port optimizer's come in one order."""
    import jax

    from trt_asr_tpu.train import make_optimizer as j_make_optimizer
    from trt_asr_tpu.train.checkpoint import save_train_state as j_save_state

    jp = j_init(JConfig.tiny(**CFG), seed=0)
    jtx, _ = j_make_optimizer(1e-3, schedule="cosine_warmup", warmup_steps=3, total_steps=9,
                              accum_steps=2)
    js = jtx.init(jp)
    js = jax.tree.map(lambda x: x + 1 if x.dtype == np.float32 else x + 2, js)
    j_save_state(str(tmp_path / "ts"), jp, js, step=4)
    tx, _ = make_optimizer(1e-3, schedule="cosine_warmup", warmup_steps=3, total_steps=9,
                           accum_steps=2)
    template = tx.init(init_params(ModelConfig.tiny(**CFG)))
    p, s, step = load_train_state(str(tmp_path / "ts"), template)
    assert step == 4
    for a, b in zip(optim.tree_leaves(s), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert_tree_equal(params_to_numpy(p), np_tree(jp))


def test_train_state_resume_bitwise(tmp_path):
    cfg = ModelConfig.tiny(**CFG)
    params0 = init_params(cfg, seed=0)
    batch = tiny_batch(cfg)
    tx, _ = make_optimizer(3e-3, schedule="cosine_warmup", warmup_steps=2, total_steps=10)
    init_opt, step = make_train_step(cfg, tx)

    p, o, losses = params0, init_opt(params0), []
    for _ in range(5):
        p, o, m = step(p, o, batch)
        losses.append(float(m["loss"]))

    p2, o2 = params0, init_opt(params0)
    for _ in range(3):
        p2, o2, _ = step(p2, o2, batch)
    save_train_state(str(tmp_path / "ts"), p2, o2, step=3, meta={"note": "resume-test"})
    p3, o3, got_step = load_train_state(str(tmp_path / "ts"), init_opt(params0))
    assert got_step == 3
    losses2 = []
    for _ in range(2):
        p3, o3, m = step(p3, o3, batch)
        losses2.append(float(m["loss"]))
    assert losses2 == losses[3:]
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(p), optim.tree_leaves(p3)))
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(o), optim.tree_leaves(o3)))

    # another optimizer's template is refused
    with pytest.raises(ValueError, match="leaves"):
        load_train_state(str(tmp_path / "ts"), optim.adam(1e-3).init(params0))
    # a tampered leaf is refused
    npz_path = tmp_path / "ts" / "opt_state.npz"
    data = dict(np.load(npz_path))
    key = next(k for k in sorted(data) if data[k].size > 1)
    bad = data[key].copy()
    bad.reshape(-1).view(np.uint8)[0] ^= 0xFF
    data[key] = bad
    np.savez(npz_path, **data)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_train_state(str(tmp_path / "ts"), init_opt(params0))
