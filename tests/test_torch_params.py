"""PyTorch port parameters against the JAX package: seeded init is bit for
bit the same, gate_r3 loads to the same tensors, the manifest check rejects
a corrupted tensor, the weight bridge round-trips, int8 quantization is
exact for every scope, and ``cast_params_for_compute`` (the bf16-weights
configuration) casts the same leaves to the same values."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, assert_tree_equal, np_tree

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.models.parakeet.params import cast_params_for_compute as j_cast
from trt_asr_tpu.models.parakeet.params import init_params as j_init
from trt_asr_tpu.models.parakeet.params import load_checkpoint as j_load
from trt_asr_tpu.models.parakeet.quant import quantize_params as j_quantize
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.models.parakeet import cast_params_for_compute
from trt_asr_tpu_torch.models.parakeet.params import (
    init_params,
    load_checkpoint,
    params_from_numpy,
    params_to_numpy,
)
from trt_asr_tpu_torch.models.parakeet.quant import quantize_params


@pytest.mark.parametrize("overrides,seed", [({}, 0), ({"vocab_size": 1120, "joint_hidden": 64,
                                                      "att_cache_size": 64}, 3)])
def test_init_params_bit_exact(overrides, seed):
    cfg_j, cfg_p = JConfig.tiny(**overrides), ModelConfig.tiny(**overrides)
    assert_tree_equal(params_to_numpy(init_params(cfg_p, seed=seed)),
                      np_tree(j_init(cfg_j, seed=seed)))


def test_model_config_matches():
    import dataclasses

    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JConfig())
    for name in ("blank_id", "token_head_size", "num_duration_bins", "joint_vocab_size",
                 "head_dim", "conv_context_size", "stride_stages"):
        assert getattr(ModelConfig(), name) == getattr(JConfig(), name), name
        assert getattr(ModelConfig.tiny(), name) == getattr(JConfig.tiny(), name), name


def test_gate_r3_loads_same_tensors():
    assert_tree_equal(params_to_numpy(load_checkpoint(GATE_R3)), np_tree(j_load(GATE_R3)))


def test_manifest_rejects_corrupted_tensor(tmp_path):
    d = tmp_path / "model"
    shutil.copytree(GATE_R3, d)
    npz = dict(np.load(d / "params.npz"))
    key = sorted(npz)[0]
    bad = npz[key].copy()
    bad.reshape(-1)[0] += 1.0
    npz[key] = bad
    np.savez(d / "params.npz", **npz)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        load_checkpoint(str(d))
    load_checkpoint(str(d), verify=False)          # the bytes themselves still load
    manifest = json.loads((d / "manifest.json").read_text())
    assert key in manifest["tensors"]


@pytest.mark.parametrize("scope", ["none", "joint", "encoder", "all"])
def test_bridge_round_trip_and_quant_scopes(scope):
    cfg = JConfig.tiny()
    jq = np_tree(j_quantize(j_init(cfg, seed=4), scope))
    bridged = params_from_numpy(jq)
    assert_tree_equal(params_to_numpy(bridged), jq)
    # the port's own quantization of the same f32 weights is bit-exact
    ported = quantize_params(init_params(ModelConfig.tiny(), seed=4), scope)
    assert_tree_equal(params_to_numpy(ported), jq)


def test_from_model_dir_device_and_joint_dur_first():
    from trt_asr_tpu_torch.config import RuntimeConfig
    from trt_asr_tpu_torch.models.parakeet.model import ParakeetTDT

    m = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(), device="cpu")
    p = ParakeetTDT.from_model_dir(GATE_R3, runtime=RuntimeConfig(joint_dur_first=True),
                                   device="cpu")
    nd, ths = m.cfg.num_duration_bins, m.cfg.token_head_size
    w, wp = m.params["joint"]["out"]["w"].numpy(), p.params["joint"]["out"]["w"].numpy()
    np.testing.assert_array_equal(wp[:, :ths], w[:, nd:nd + ths])
    np.testing.assert_array_equal(wp[:, ths:], w[:, :nd])
    assert str(m.params["joint"]["out"]["w"].device) == "cpu"
    assert os.path.exists(os.path.join(GATE_R3, "vocab.txt"))
    assert len(m.tokenizer) == m.cfg.vocab_size


@pytest.mark.parametrize("model", ["tiny", "gate_r3"])
def test_cast_params_for_compute_matches_jax(model):
    """Leaf for leaf: the same type (bf16 weights, f32 norm parameters) and
    bit-equal values, after the JAX tree goes through the weight bridge."""
    if model == "tiny":
        jp, pp = j_init(JConfig.tiny(), seed=6), init_params(ModelConfig.tiny(), seed=6)
    else:
        jp, pp = j_load(GATE_R3), load_checkpoint(GATE_R3)
    want = params_from_numpy(np_tree(j_cast(jp, jnp.bfloat16)))
    got = cast_params_for_compute(pp, torch.bfloat16)
    kept = []

    def compare(g, w, path):
        if isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                compare(g[k], w[k], f"{path}/{k}")
        elif isinstance(g, list):
            assert len(g) == len(w), path
            for i, (x, y) in enumerate(zip(g, w)):
                compare(x, y, f"{path}/{i}")
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert torch.equal(g, w), path
            if g.dtype == torch.float32:
                kept.append(path.rsplit("/", 1)[-1])

    compare(got, want, "")
    assert kept and all(k.endswith(("ln_g", "ln_b", "bn_g", "bn_b", "bn_m", "bn_v"))
                        for k in kept)
    assert got["encoder"]["layers"]["att_wq"].dtype == torch.bfloat16


def test_cast_params_for_compute_refuses_a_quantized_tree():
    with pytest.raises(TypeError, match="before quantizing"):
        cast_params_for_compute(quantize_params(init_params(ModelConfig.tiny(), seed=1), "all"),
                                torch.bfloat16)
