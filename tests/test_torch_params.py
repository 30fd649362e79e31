"""PyTorch port parameters against the JAX package: seeded init is bit for
bit the same, gate_r3 loads to the same tensors, the manifest check rejects
a corrupted tensor, the weight bridge round-trips, and int8 quantization is
exact for every scope."""

import json
import os
import shutil

import numpy as np
import pytest

from torch_port_helpers import GATE_R3, assert_tree_equal, np_tree

from trt_asr_tpu.config import ModelConfig as JConfig
from trt_asr_tpu.models.parakeet.params import init_params as j_init
from trt_asr_tpu.models.parakeet.params import load_checkpoint as j_load
from trt_asr_tpu.models.parakeet.quant import quantize_params as j_quantize
from trt_asr_tpu_torch.config import ModelConfig
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
