"""The port's ONNX weight path against the JAX package: the wire format
(``io/onnx_lite.py``) read and written across the two packages, inline and
with external data, nodes and attributes included; ``export_params_to_onnx``
writing the same four ``.onnx`` files (and external data) as JAX's, byte
for byte, for the tiny config and for gate_r3, with equal
``model_meta.json``; each package's loader reading the other's export leaf
for leaf; the strict missing-initializer error; ``read_model_meta`` on both
schemas; a reference-layout export (wrapper prefixes, the reference meta
schema; JAX's own test fixture) loading strictly; the port's exported
graphs run by ``tools/onnx_exec.py`` against the port's torch encoder,
predictor and joint (JAX's tolerances: 1e-4 encoder, 1e-5 predictor and
joint); and ``python -m trt_asr_tpu_torch.import_onnx`` against
``tools/import_onnx_model.py`` on one export: the same model dir (config,
leaves, sha256 manifest, vocab) and the same ``--verify`` line."""

import filecmp
import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from torch_port_helpers import GATE_R3, assert_tree_equal, t

from trt_asr_tpu.config import ModelConfig as JaxConfig
from trt_asr_tpu.io import onnx_lite as jax_lite
from trt_asr_tpu.io import onnx_weights as jax_ow
from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.io import onnx_lite as port_lite
from trt_asr_tpu_torch.io import onnx_weights as port_ow
from trt_asr_tpu_torch.models.parakeet.params import (init_params_numpy, load_checkpoint_numpy,
                                                      params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPONENTS = ("encoder", "encoder_streaming", "predictor", "joint")


def gate_r3_config(cls):
    with open(os.path.join(ROOT, GATE_R3, "config.json")) as f:
        raw = json.load(f)
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in raw.items()})


MODELS = {"tiny": lambda cls: (cls.tiny(), init_params_numpy(ModelConfig.tiny(), seed=11)),
          "gate_r3": lambda cls: (gate_r3_config(cls),
                                  load_checkpoint_numpy(os.path.join(ROOT, GATE_R3)))}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Each model exported by each package (external data above 4096 B for
    tiny, the default 1 MiB for gate_r3): {(model, package): dir}."""
    root = tmp_path_factory.mktemp("exports")
    out = {}
    for name, make in MODELS.items():
        thr = 4096 if name == "tiny" else 1 << 20
        for pkg, cls, ow in (("port", ModelConfig, port_ow), ("jax", JaxConfig, jax_ow)):
            cfg, params = make(cls)
            d = str(root / f"{name}_{pkg}")
            ow.export_params_to_onnx(params, cfg, d, external_threshold=thr)
            out[(name, pkg)] = d
    return out


# ---- the wire format ------------------------------------------------------------

@pytest.mark.parametrize("threshold", [None, 1024], ids=["inline", "external"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wire_roundtrip_across_packages(tmp_path, writer, threshold):
    rng = np.random.default_rng(3)
    tensors = {"small.f32": rng.standard_normal((3, 5)).astype(np.float32),
               "int.i64": np.arange(7, dtype=np.int64),
               "big.f32": rng.standard_normal((200, 300)).astype(np.float32)}
    w, r = (port_lite, jax_lite) if writer == "port" else (jax_lite, port_lite)
    p = str(tmp_path / "m.onnx")
    w.write_onnx(p, "g", tensors, ["in0"], ["out0"], external_threshold=threshold)
    assert os.path.exists(p + ".data") == (threshold is not None)
    model = r.read_onnx(p)
    assert (model.graph_name, model.inputs, model.outputs) == ("g", ["in0"], ["out0"])
    assert set(model.initializers) == set(tensors)
    for name, want in tensors.items():
        got = model.initializers[name].array
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the other package writes the same bytes (the file names its data file)
    os.makedirs(tmp_path / "again")
    q = str(tmp_path / "again" / "m.onnx")
    r.write_onnx(q, "g", tensors, ["in0"], ["out0"], external_threshold=threshold)
    for suffix in ("", ".data") if threshold else ("",):
        assert filecmp.cmp(p + suffix, q + suffix, shallow=False), suffix


@pytest.mark.parametrize("comp", COMPONENTS)
def test_readers_agree_on_graphs(exports, comp):
    """Both readers parse an exported component alike: IO, initializers,
    and every node with its attributes."""
    path = os.path.join(exports[("tiny", "jax")], f"{comp}.onnx")
    a, b = port_lite.read_onnx(path), jax_lite.read_onnx(path)
    assert (a.graph_name, a.inputs, a.outputs, a.node_ops) == (
        b.graph_name, b.inputs, b.outputs, b.node_ops)
    assert a.nodes and len(a.nodes) == len(b.nodes)
    for x, y in zip(a.nodes, b.nodes):
        assert (x.op_type, x.inputs, x.outputs, x.name) == (y.op_type, y.inputs, y.outputs, y.name)
        assert set(x.attrs) == set(y.attrs)
        for k in x.attrs:
            np.testing.assert_array_equal(np.asarray(x.attrs[k]), np.asarray(y.attrs[k]))
    assert set(a.initializers) == set(b.initializers)
    for k, v in a.initializers.items():
        assert (v.dims, v.dtype_code) == (b.initializers[k].dims, b.initializers[k].dtype_code)
        np.testing.assert_array_equal(v.array, b.initializers[k].array)


# ---- the export and the loaders -----------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
def test_export_bytes_equal_jax(exports, model):
    a, b = exports[(model, "port")], exports[(model, "jax")]
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for comp in COMPONENTS:
        assert filecmp.cmp(os.path.join(a, f"{comp}.onnx"), os.path.join(b, f"{comp}.onnx"),
                           shallow=False), comp
    datas = [f for f in os.listdir(a) if f.endswith(".data")]
    assert bool(datas) == (model == "tiny")
    for f in datas:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f
    with open(os.path.join(a, "model_meta.json")) as fa, \
            open(os.path.join(b, "model_meta.json")) as fb:
        assert json.load(fa) == json.load(fb)


@pytest.mark.parametrize("model", list(MODELS))
def test_loaders_read_each_others_export(exports, model):
    src = MODELS[model](ModelConfig)[1]
    got = port_ow.load_params_from_onnx(MODELS[model](ModelConfig)[0], exports[(model, "jax")])
    assert_tree_equal(got, src)
    import jax

    want = jax.tree.map(np.asarray, jax_ow.load_params_from_onnx(
        MODELS[model](JaxConfig)[0], exports[(model, "port")]))
    assert_tree_equal(want, src)


def test_torch_tree_exports_like_numpy(exports, tmp_path):
    cfg, params = MODELS["tiny"](ModelConfig)
    port_ow.export_params_to_onnx(params_from_numpy(params), cfg, str(tmp_path),
                                  external_threshold=4096)
    for f in os.listdir(tmp_path):
        assert filecmp.cmp(str(tmp_path / f), os.path.join(exports[("tiny", "port")], f),
                           shallow=False), f


def test_missing_initializer_strict(tmp_path):
    cfg = ModelConfig.tiny()
    out = str(tmp_path / "export")
    port_ow.export_params_to_onnx(init_params_numpy(cfg), cfg, out, external_threshold=None)
    m = port_lite.read_onnx(os.path.join(out, "joint.onnx"))
    inits = {k: v.array for k, v in m.initializers.items() if k != "joint.enc.weight"}
    port_lite.write_onnx(os.path.join(out, "joint.onnx"), "joint", inits)
    with pytest.raises(KeyError, match="joint.enc.weight"):
        port_ow.load_params_from_onnx(cfg, out)
    loose = port_ow.load_params_from_onnx(cfg, out, strict=False)
    # the missing leaf keeps the skeleton's value (init_params_numpy, seed 0)
    np.testing.assert_array_equal(loose["joint"]["enc"]["w"],
                                  init_params_numpy(cfg, seed=0)["joint"]["enc"]["w"])


def test_loader_skeleton_draws_nothing(exports, monkeypatch):
    """The strict loader's skeleton (``empty_params_numpy``) has the seeded
    tree's structure, shapes, dtypes and constant leaves, and no seeded
    tree is drawn when every initializer is found."""
    from trt_asr_tpu_torch.models.parakeet import params as port_params

    cfg = ModelConfig.tiny()
    seeded, empty = init_params_numpy(cfg, seed=0), port_params.empty_params_numpy(cfg)
    assert_tree_equal(empty["encoder"]["layers"]["conv_bn_v"],
                      seeded["encoder"]["layers"]["conv_bn_v"])

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tree.shape, tree.dtype

    assert shapes(empty) == shapes(seeded)

    def no_draw(*a, **k):
        raise AssertionError("the strict loader drew a seeded tree")

    monkeypatch.setattr(port_params, "init_params_numpy", no_draw)
    assert_tree_equal(port_ow.load_params_from_onnx(cfg, exports[("tiny", "port")]),
                      MODELS["tiny"](ModelConfig)[1])


def reference_fixture(cfg, params, out, streaming=True):
    """JAX's reference-layout export fixture (tests/test_onnx_weights.py)."""
    from test_onnx_weights import _reference_style_fixture

    _reference_style_fixture(cfg, params, out, streaming=streaming)


def test_read_model_meta_both_schemas(exports, tmp_path):
    cfg = ModelConfig.tiny()
    ours = exports[("tiny", "port")]
    m = port_ow.read_model_meta(ours)
    assert (m["vocab_size"], m["blank_id"], m["joint_vocab_size"], m["n_mels"]) == (
        cfg.vocab_size, cfg.blank_id, cfg.joint_vocab_size, cfg.feat_in)
    ref = str(tmp_path / "ref")
    reference_fixture(JaxConfig.tiny(), init_params_numpy(cfg, seed=5), ref)
    legacy = str(tmp_path / "legacy")
    os.makedirs(legacy)
    with open(os.path.join(legacy, "model_meta.json"), "w") as f:
        json.dump({"format": "trt-asr-tpu/onnx-weights/v1",
                   "config": {"vocab_size": 64, "feat_in": 80}}, f)
    for d in (ours, ref, legacy):
        got, want = port_ow.read_model_meta(d), jax_ow.read_model_meta(d)
        assert got == want
    assert port_ow.read_model_meta(ref)["duration_values"] == list(cfg.duration_values)
    with open(os.path.join(ref, "model_meta.json")) as f:
        bad = json.load(f)
    bad["joint_vocab_size"] += 1
    os.makedirs(tmp_path / "bad")
    with open(tmp_path / "bad" / "model_meta.json", "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError, match="joint_vocab_size"):
        port_ow.read_model_meta(str(tmp_path / "bad"))


@pytest.mark.parametrize("streaming", [True, False])
def test_reference_export_fixture_loads_strict(tmp_path, streaming):
    cfg = ModelConfig.tiny()
    params = init_params_numpy(cfg, seed=5)
    out = str(tmp_path / "ref_export")
    reference_fixture(JaxConfig.tiny(), params, out, streaming=streaming)
    assert_tree_equal(port_ow.load_params_from_onnx(cfg, out), params)


# ---- the exported graphs against the port's modules ----------------------------------

@pytest.fixture(scope="module")
def run_graph():
    sys.path.insert(0, ROOT)
    from tools.onnx_exec import run_graph as fn

    return fn


def test_predictor_and_joint_graphs_match_port(exports, run_graph):
    from trt_asr_tpu_torch.models.parakeet.joint import joint_apply
    from trt_asr_tpu_torch.models.parakeet.predictor import predictor_sequence

    cfg, params = MODELS["tiny"](ModelConfig)
    tp = params_from_numpy(params)
    rng = np.random.default_rng(4)
    b, u, steps = 2, 4, 6
    y = rng.integers(0, cfg.vocab_size, (b, u)).astype(np.int32)
    h = rng.standard_normal((cfg.pred_rnn_layers, b, cfg.pred_hidden)).astype(np.float32)
    c = rng.standard_normal((cfg.pred_rnn_layers, b, cfg.pred_hidden)).astype(np.float32)
    d = exports[("tiny", "port")]
    got = run_graph(port_lite.read_onnx(os.path.join(d, "predictor.onnx")),
                    {"y": y, "h": h, "c": c})
    g, h2, c2 = predictor_sequence(tp["predictor"], t(y), t(h), t(c))
    np.testing.assert_allclose(got["g"], g.numpy().transpose(0, 2, 1), atol=1e-5)
    np.testing.assert_allclose(got["h_out"], h2.numpy(), atol=1e-5)
    np.testing.assert_allclose(got["c_out"], c2.numpy(), atol=1e-5)
    enc = rng.standard_normal((b, cfg.d_model, steps)).astype(np.float32)
    pred = rng.standard_normal((b, cfg.pred_hidden, u)).astype(np.float32)
    got = run_graph(port_lite.read_onnx(os.path.join(d, "joint.onnx")),
                    {"encoder_output": enc, "predictor_output": pred})["joint_output"]
    want = joint_apply(tp["joint"], t(enc.transpose(0, 2, 1)), t(pred.transpose(0, 2, 1)))
    assert got.shape == (b, steps, u, cfg.joint_vocab_size)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)


def test_encoder_graph_matches_port(exports, run_graph):
    """encoder.onnx (static T 256, as exported) against the port's
    ``offline_encode``, on a full and on a zero-padded short input."""
    from trt_asr_tpu_torch.models.parakeet.encoder import offline_encode

    cfg, params = MODELS["tiny"](ModelConfig)
    tp = params_from_numpy(params)
    model = port_lite.read_onnx(os.path.join(exports[("tiny", "port")], "encoder.onnx"))
    t_in = 256
    feats = np.random.default_rng(6).standard_normal((1, t_in, cfg.feat_in)).astype(np.float32)
    for n in (t_in, 70):
        x = np.zeros_like(feats)
        x[:, :n] = feats[:, :n]
        got = run_graph(model, {"audio_signal": x.transpose(0, 2, 1),
                                "length": np.array([n], np.int64)})
        with torch.no_grad():
            enc, out_len = offline_encode(tp, cfg, t(x), torch.tensor([n]))
        steps = int(out_len[0])
        assert int(got["encoded_lengths"][0]) == steps
        np.testing.assert_allclose(got["encoder_output"][:, :, :steps],
                                   enc[:, :steps].numpy().transpose(0, 2, 1), atol=1e-4)


# ---- the importer ----------------------------------------------------------------

def jax_import_main(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "import_onnx_model", os.path.join(ROOT, "tools", "import_onnx_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["import_onnx_model.py"] + argv)
    return mod.main()


def run_both(export_dir, tmp_path, monkeypatch, extra=()):
    from trt_asr_tpu_torch.import_onnx import main as port_main

    outs = {}
    for name, fn, dev in (("port", port_main, ["--device", "cpu"]),
                          ("jax", lambda a: jax_import_main(a, monkeypatch), [])):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert fn([export_dir, "--out", str(tmp_path / name), *extra, *dev]) == 0
        outs[name] = buf.getvalue()
    return outs


def test_import_onnx_matches_jax_tool(exports, tmp_path, monkeypatch):
    """gate_r3's export imported by both tools: equal model dirs, the
    imported leaves equal the source, the same --verify transcript."""
    export = exports[("gate_r3", "port")]
    with open(os.path.join(ROOT, GATE_R3, "vocab.txt")) as f:
        (tmp_path / "vocab.txt").write_text(f.read())
    outs = run_both(export, tmp_path, monkeypatch,
                    ["--vocab", str(tmp_path / "vocab.txt"), "--verify"])
    a, b = tmp_path / "port", tmp_path / "jax"
    for f in ("config.json", "manifest.json"):
        assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
    assert (a / "vocab.txt").read_bytes() == (b / "vocab.txt").read_bytes()
    assert_tree_equal(load_checkpoint_numpy(str(a)), load_checkpoint_numpy(str(b)))
    assert_tree_equal(load_checkpoint_numpy(str(a)), MODELS["gate_r3"](ModelConfig)[1])
    imported = {k: [ln.replace(str(tmp_path / k), "OUT") for ln in v.splitlines()
                    if ln.startswith("imported ")] for k, v in outs.items()}
    assert len(imported["port"]) == 1 and imported["port"] == imported["jax"]
    verify = {k: [ln.replace(" on cpu", "") for ln in v.splitlines() if ln.startswith("verify:")]
              for k, v in outs.items()}
    assert len(verify["port"]) == 1 and verify["port"] == verify["jax"]


def test_import_onnx_nemo_compat_and_contract_check(exports, tmp_path, monkeypatch):
    """--nemo-compat-chunk0 lands in both configs; a reference export with
    no config block takes the contract's architecture, whose vocab the tiny
    export contradicts: both tools refuse it with the same message."""
    export = exports[("tiny", "port")]
    from trt_asr_tpu_torch.tokenizer import make_synthetic_vocab, write_vocab

    write_vocab(str(tmp_path / "vocab.txt"), make_synthetic_vocab(ModelConfig.tiny().vocab_size))
    run_both(export, tmp_path, monkeypatch, ["--vocab", str(tmp_path / "vocab.txt"),
                                             "--nemo-compat-chunk0"])
    for name in ("port", "jax"):
        assert json.loads((tmp_path / name / "config.json").read_text())["nemo_compat_chunk0"]
    ref = str(tmp_path / "ref")
    reference_fixture(JaxConfig.tiny(), init_params_numpy(ModelConfig.tiny(), seed=5), ref)
    from trt_asr_tpu_torch.import_onnx import main as port_main

    msgs = []
    for fn in (port_main, lambda a: jax_import_main(a, monkeypatch)):
        with pytest.raises(SystemExit) as e:
            fn([ref, "--out", str(tmp_path / "x"), "--vocab", str(tmp_path / "vocab.txt")])
        msgs.append(str(e.value))
    assert "contradicts" in msgs[0] and msgs[0] == msgs[1]
