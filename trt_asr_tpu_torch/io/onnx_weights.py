"""ONNX component weight interchange: the port's copy of the JAX package's
``io/onnx_weights.py``, on numpy trees (the trees ``params_to_numpy`` and
``params_from_numpy`` carry across; a torch tree is read leaf by leaf).

Replaces the reference's export/load pipeline role (tools/export_onnx
produced {encoder,encoder_streaming,predictor,joint}.onnx whose
initializers the runtime consumed): we export our parameter pytree to
weight-carrying ONNX component files using NeMo/torch state-dict naming and
torch tensor layouts, and load such files back (so a real NeMo Parakeet
export with standard initializer names maps onto the pytree).

The name map is declarative data; ``load_params_from_onnx`` accepts an
override map (JSON) for artifacts with different naming. Unknown names are
reported, not silently dropped (the reference's loader resolved tensors by
name, never index, with explicit fallbacks — parakeet_trt.cpp:1081-1142).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.io.onnx_lite import read_onnx, write_onnx

# transforms between torch layout (export) and ours (pytree)
_T = lambda a: np.ascontiguousarray(np.swapaxes(a, -1, -2))  # noqa: E731


def _conv2d_ours_to_torch(a):  # [kh,kw,in,out] -> [out,in,kh,kw]
    return np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))


def _conv2d_torch_to_ours(a):
    return np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))


def _pw1d_ours_to_torch(a):   # [in,out] -> [out,in,1]
    return np.ascontiguousarray(a.T[..., None])


def _pw1d_torch_to_ours(a):
    return np.ascontiguousarray(a[..., 0].T)


def _dw1d_ours_to_torch(a):   # [K,D] -> [D,1,K]
    return np.ascontiguousarray(a.T[:, None, :])


def _dw1d_torch_to_ours(a):
    return np.ascontiguousarray(a[:, 0, :].T)


def _ident(a):
    return np.ascontiguousarray(a)


def encoder_name_map(cfg: ModelConfig) -> List[Tuple[str, str, Callable, Callable]]:
    """(pytree_path, onnx_name, ours_to_torch, torch_to_ours)."""
    m: List[Tuple[str, str, Callable, Callable]] = [
        ("encoder/pre_encode/conv_in/w", "encoder.pre_encode.conv.0.weight",
         _conv2d_ours_to_torch, _conv2d_torch_to_ours),
        ("encoder/pre_encode/conv_in/b", "encoder.pre_encode.conv.0.bias", _ident, _ident),
        ("encoder/pre_encode/out/w", "encoder.pre_encode.out.weight", _T, _T),
        ("encoder/pre_encode/out/b", "encoder.pre_encode.out.bias", _ident, _ident),
    ]
    # dw_striding stages: Sequential indices 2,3 then 5,6 (ReLU between)
    for s in range(cfg.stride_stages - 1):
        base = 2 + 3 * s
        m += [
            (f"encoder/pre_encode/stages/{s}/dw_w", f"encoder.pre_encode.conv.{base}.weight",
             _conv2d_ours_to_torch, _conv2d_torch_to_ours),
            (f"encoder/pre_encode/stages/{s}/dw_b", f"encoder.pre_encode.conv.{base}.bias",
             _ident, _ident),
            (f"encoder/pre_encode/stages/{s}/pw_w", f"encoder.pre_encode.conv.{base+1}.weight",
             _conv2d_ours_to_torch, _conv2d_torch_to_ours),
            (f"encoder/pre_encode/stages/{s}/pw_b", f"encoder.pre_encode.conv.{base+1}.bias",
             _ident, _ident),
        ]
    per_layer = [
        ("ff1_ln_g", "norm_feed_forward1.weight", _ident, _ident),
        ("ff1_ln_b", "norm_feed_forward1.bias", _ident, _ident),
        ("ff1_w1", "feed_forward1.linear1.weight", _T, _T),
        ("ff1_w2", "feed_forward1.linear2.weight", _T, _T),
        ("att_ln_g", "norm_self_att.weight", _ident, _ident),
        ("att_ln_b", "norm_self_att.bias", _ident, _ident),
        ("att_wq", "self_attn.linear_q.weight", _T, _T),
        ("att_wk", "self_attn.linear_k.weight", _T, _T),
        ("att_wv", "self_attn.linear_v.weight", _T, _T),
        ("att_wo", "self_attn.linear_out.weight", _T, _T),
        ("att_wpos", "self_attn.linear_pos.weight", _T, _T),
        ("att_bias_u", "self_attn.pos_bias_u", _ident, _ident),
        ("att_bias_v", "self_attn.pos_bias_v", _ident, _ident),
        ("conv_ln_g", "norm_conv.weight", _ident, _ident),
        ("conv_ln_b", "norm_conv.bias", _ident, _ident),
        ("conv_pw1", "conv.pointwise_conv1.weight", _pw1d_ours_to_torch, _pw1d_torch_to_ours),
        ("conv_dw", "conv.depthwise_conv.weight", _dw1d_ours_to_torch, _dw1d_torch_to_ours),
        ("conv_bn_g", "conv.batch_norm.weight", _ident, _ident),
        ("conv_bn_b", "conv.batch_norm.bias", _ident, _ident),
        ("conv_bn_m", "conv.batch_norm.running_mean", _ident, _ident),
        ("conv_bn_v", "conv.batch_norm.running_var", _ident, _ident),
        ("conv_pw2", "conv.pointwise_conv2.weight", _pw1d_ours_to_torch, _pw1d_torch_to_ours),
        ("ff2_ln_g", "norm_feed_forward2.weight", _ident, _ident),
        ("ff2_ln_b", "norm_feed_forward2.bias", _ident, _ident),
        ("ff2_w1", "feed_forward2.linear1.weight", _T, _T),
        ("ff2_w2", "feed_forward2.linear2.weight", _T, _T),
        ("out_ln_g", "norm_out.weight", _ident, _ident),
        ("out_ln_b", "norm_out.bias", _ident, _ident),
    ]
    for li in range(cfg.num_layers):
        for key, name, fwd, bwd in per_layer:
            m.append((f"encoder/layers/{key}[{li}]",
                      f"encoder.layers.{li}.{name}", fwd, bwd))
    return m


def predictor_name_map(cfg: ModelConfig) -> List[Tuple[str, str, Callable, Callable]]:
    m = [("predictor/embed", "prediction.embed.weight", _ident, _ident)]
    for li in range(cfg.pred_rnn_layers):
        m += [
            (f"predictor/lstm/{li}/wi", f"prediction.dec_rnn.lstm.weight_ih_l{li}", _T, _T),
            (f"predictor/lstm/{li}/wh", f"prediction.dec_rnn.lstm.weight_hh_l{li}", _T, _T),
            (f"predictor/lstm/{li}/bi", f"prediction.dec_rnn.lstm.bias_ih_l{li}", _ident, _ident),
            (f"predictor/lstm/{li}/bh", f"prediction.dec_rnn.lstm.bias_hh_l{li}", _ident, _ident),
        ]
    return m


def joint_name_map(cfg: ModelConfig) -> List[Tuple[str, str, Callable, Callable]]:
    return [
        ("joint/enc/w", "joint.enc.weight", _T, _T),
        ("joint/enc/b", "joint.enc.bias", _ident, _ident),
        ("joint/pred/w", "joint.pred.weight", _T, _T),
        ("joint/pred/b", "joint.pred.bias", _ident, _ident),
        ("joint/out/w", "joint.joint_net.2.weight", _T, _T),
        ("joint/out/b", "joint.joint_net.2.bias", _ident, _ident),
    ]


def _get_path(params: Dict[str, Any], path: str) -> np.ndarray:
    """Resolve 'a/b/c' or 'a/layers/key[i]' into the pytree."""
    if "[" in path:
        base, idx = path[:-1].rsplit("[", 1)
        return np.asarray(_get_path(params, base))[int(idx)]
    node: Any = params
    for part in path.split("/"):
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    return np.asarray(node)


def _set_path(params: Dict[str, Any], path: str, value: np.ndarray) -> None:
    if "[" in path:
        base, idx = path[:-1].rsplit("[", 1)
        # the loader's skeleton is a fresh numpy tree: a layer is written
        # into its stacked array in place
        parts = base.split("/")
        node: Any = params
        for part in parts[:-1]:
            node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
        node[parts[-1]][int(idx)] = value
        return
    parts = path.split("/")
    node = params
    for part in parts[:-1]:
        node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
    last = parts[-1]
    if isinstance(node, (list, tuple)):
        node[int(last)] = value
    else:
        node[last] = value


# IO signatures of the reference export (tools/export_onnx/export.py:614-820):
# encoder.onnx is the OFFLINE component (2-in/2-out); encoder_streaming.onnx
# carries the 5-in/5-out cache IO. Initializer prefixes come from the export
# wrappers' attribute names (StreamingEncoderWrapper.encoder,
# PredictorWrapper.predictor, JointWrapper.joint); the offline encoder is
# exported unwrapped (no prefix).
STREAMING_ENCODER_INPUTS = ["audio_signal", "length", "cache_last_channel",
                            "cache_last_time", "cache_last_channel_len"]
STREAMING_ENCODER_OUTPUTS = ["encoder_output", "encoded_lengths",
                             "cache_last_channel_out", "cache_last_time_out",
                             "cache_last_channel_len_out"]
# the static input length (frames) of the executable offline encoder graph
ENCODER_STATIC_T_IN = 256


def export_params_to_onnx(params: Dict[str, Any], cfg: ModelConfig, out_dir: str,
                          external_threshold: Optional[int] = 1 << 20) -> Dict[str, str]:
    """Write the reference export's component layout: encoder.onnx (offline,
    unprefixed names) + encoder_streaming.onnx (5-in/5-out cache IO,
    'encoder.'-prefixed names) + predictor.onnx + joint.onnx (torch layouts,
    NeMo state-dict names) + model_meta.json (reference schema,
    export.py:970-997).

    ALL FOUR component files are EXECUTABLE programs (real compute nodes
    over the same initializers — io/onnx_graphs.py), restoring
    the reference export's runnable-outside-the-repo property (its ORT
    smoke, export.py:819-852). The offline encoder graph is emitted at the
    STATIC input length ``ENCODER_STATIC_T_IN``; encoder_streaming.onnx is
    one steady cache-aware chunk step at the unified window with the
    reference's 5-in/5-out contract-layout cache IO. ``params`` is a numpy
    or torch tree (torch leaves are read once, from any device)."""
    from trt_asr_tpu_torch.io.onnx_graphs import (encoder_graph, joint_graph,
                                                  predictor_graph,
                                                  streaming_encoder_graph)
    from trt_asr_tpu_torch.models.parakeet.params import params_to_numpy

    os.makedirs(out_dir, exist_ok=True)
    params = params_to_numpy(params)
    paths = {}
    enc_map = encoder_name_map(cfg)
    enc_nodes, enc_consts, enc_io = encoder_graph(cfg, ENCODER_STATIC_T_IN)
    st_nodes, st_consts, st_io = streaming_encoder_graph(cfg)
    pred_nodes, pred_consts, pred_io = predictor_graph(cfg)
    joint_nodes, joint_consts, joint_io = joint_graph(cfg)
    unpref = [(p, n.split(".", 1)[1], f, b) for p, n, f, b in enc_map]
    comps = {
        "encoder": (unpref, ["audio_signal", "length"],
                    ["encoder_output", "encoded_lengths"],
                    enc_nodes, enc_consts, enc_io),
        "encoder_streaming": (enc_map, STREAMING_ENCODER_INPUTS,
                              STREAMING_ENCODER_OUTPUTS,
                              st_nodes, st_consts, st_io),
        "predictor": (predictor_name_map(cfg), ["y", "h", "c"],
                      ["g", "h_out", "c_out"], pred_nodes, pred_consts, pred_io),
        "joint": (joint_name_map(cfg), ["encoder_output", "predictor_output"],
                  ["joint_output"], joint_nodes, joint_consts, joint_io),
    }
    for comp, (name_map, ins, outs, nodes, consts, io_types) in comps.items():
        inits = {}
        for path, onnx_name, fwd, _bwd in name_map:
            inits[onnx_name] = fwd(_get_path(params, path)).astype(np.float32)
        inits.update(consts)
        p = os.path.join(out_dir, f"{comp}.onnx")
        write_onnx(p, comp, inits, ins, outs,
                   external_threshold=external_threshold,
                   nodes=nodes, io_types=io_types)
        paths[comp] = p
    meta = {
        # reference model_meta.json schema (export.py:970-997)
        "model_name": "parakeet-tdt-0.6b-v3",
        "sample_rate": 16000,
        "blank_id": cfg.blank_id,
        "tokenizer_vocab_size": cfg.vocab_size,
        "joint_vocab_size": cfg.joint_vocab_size,
        "duration_values": list(cfg.duration_values),
        "tensor_layout_contract": {
            "encoder_input": "audio_signal: [B, n_mels, T]",
            "encoder_output": f"encoder_output: [B, D_enc(={cfg.d_model}), T_enc]",
            "predictor_input": "y: [B, U], h/c: [L, B, H]",
            "predictor_output": f"g: [B, H(={cfg.pred_hidden}), U] (transposed from NeMo [B,U,H])",
            "joint_input": f"encoder_output: [B, {cfg.d_model}, T], predictor_output: [B, {cfg.pred_hidden}, U]",
            "joint_output": f"joint_output: [B, T, U, V_joint(={cfg.joint_vocab_size})]",
        },
        "features": {"type": "log-mel", "n_fft": 512, "n_mels": cfg.feat_in,
                     "hop_length": 160},
        # static shape the executable offline encoder graph was emitted at
        "encoder_static_t_in": ENCODER_STATIC_T_IN,
        # extra (ours): the COMPLETE structural config for exact
        # ModelConfig reconstruction — a consumer (trt_asr_tpu_torch.import_onnx)
        # rebuilds the model from the export dir alone; real reference
        # exports lack this block and derive the architecture from the
        # contract instead. conv_context_size is derived, kept for
        # consumers that read it directly (tools/onnx_pipeline.py:79)
        "config": {**dataclasses.asdict(cfg),
                   "conv_context_size": cfg.conv_context_size},
        # extra (ours): the cache-aware schedule + decode constants a
        # third-party runtime needs to drive encoder_streaming.onnx closed
        # loop (the reference kept these in the contract JSON; embedding
        # them makes the export dir self-contained — tools/onnx_pipeline.py
        # consumes exactly this section)
        "streaming": {
            "chunk_size_frames": list(cfg.chunk_size_frames),
            "shift_size_frames": list(cfg.shift_size_frames),
            "pre_encode_cache_size": list(cfg.pre_encode_cache_size),
            "drop_extra_pre_encoded": cfg.drop_extra_pre_encoded,
            "cache_drop_size": cfg.cache_drop_size,
            "valid_out_len": cfg.valid_out_len,
            "att_cache_size": cfg.att_cache_size,
            "subsampling_factor": cfg.subsampling_factor,
            "max_symbols_per_timestep": cfg.max_symbols_per_timestep,
            # predictor priming tokens the producing runtime uses (none:
            # NeMo's blank-priming fallback), in the JAX export's schema
            "prompt_ids": [],
        },
    }
    with open(os.path.join(out_dir, "model_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return paths


def read_model_meta(onnx_dir: str) -> Dict[str, Any]:
    """Read model_meta.json in either the reference export schema
    (export.py:970-997: model_name/blank_id/tokenizer_vocab_size/
    joint_vocab_size/duration_values/features) or this repo's legacy v1
    schema, normalized to one dict. Cross-checks against the contract-style
    arithmetic (joint = tokenizer + 1 blank + duration bins)."""
    with open(os.path.join(onnx_dir, "model_meta.json")) as f:
        raw = json.load(f)
    if raw.get("format") == "trt-asr-tpu/onnx-weights/v1":   # legacy v1
        c = raw["config"]
        return {"vocab_size": c["vocab_size"], "blank_id": c["vocab_size"],
                "joint_vocab_size": None, "duration_values": None,
                "n_mels": c["feat_in"], "config": c, "raw": raw}
    meta = {
        "vocab_size": raw.get("tokenizer_vocab_size"),
        "blank_id": raw.get("blank_id"),
        "joint_vocab_size": raw.get("joint_vocab_size"),
        "duration_values": raw.get("duration_values"),
        "n_mels": (raw.get("features") or {}).get("n_mels"),
        "config": raw.get("config"),
        "raw": raw,
    }
    jv, v, dv = meta["joint_vocab_size"], meta["vocab_size"], meta["duration_values"]
    if jv is not None and v is not None and dv is not None:
        if jv != v + 1 + len(dv):
            raise ValueError(
                f"model_meta inconsistent: joint_vocab_size {jv} != "
                f"tokenizer {v} + 1 blank + {len(dv)} duration bins")
    return meta


def load_params_from_onnx(cfg: ModelConfig, onnx_dir: str,
                          name_map_override: Optional[str] = None,
                          strict: bool = True) -> Dict[str, Any]:
    """Load encoder/predictor/joint.onnx initializers into a numpy parameter
    tree (``ParakeetTDT`` and ``params_from_numpy`` take it). The name maps
    cover every leaf, and the skeleton (``empty_params_numpy``) draws
    nothing. A missing initializer raises; with ``strict=False`` its leaf
    takes the JAX loader's skeleton value instead (``init_params_numpy(cfg,
    seed=0)``, drawn only then). name_map_override: JSON file {our_path:
    onnx_name} replacing defaults for foreign artifacts."""
    from trt_asr_tpu_torch.models.parakeet.params import (empty_params_numpy,
                                                          init_params_numpy)

    params = empty_params_numpy(cfg)
    override: Dict[str, str] = {}
    if name_map_override:
        with open(name_map_override) as f:
            override = json.load(f)

    # The streaming encoder export carries the same weights as the offline
    # one; prefer it when present (real export dirs ship both — its
    # 'encoder.'-prefixed names match our canonical map directly).
    enc_file = "encoder_streaming.onnx" if os.path.exists(
        os.path.join(onnx_dir, "encoder_streaming.onnx")) else "encoder.onnx"

    missing: List[str] = []
    missing_paths: List[str] = []
    for comp_file, name_map in ((enc_file, encoder_name_map(cfg)),
                                ("predictor.onnx", predictor_name_map(cfg)),
                                ("joint.onnx", joint_name_map(cfg))):
        model = read_onnx(os.path.join(onnx_dir, comp_file))
        inits = model.initializers
        # wrapper-prefix tolerance: the export wrappers prepend their
        # attribute name (e.g. 'predictor.prediction.embed.weight' from
        # PredictorWrapper.predictor); resolve by unique dotted suffix.
        by_suffix: Dict[str, List[str]] = {}
        for k in inits:
            parts = k.split(".")
            for i in range(len(parts)):
                by_suffix.setdefault(".".join(parts[i:]), []).append(k)
        for path, onnx_name, _fwd, bwd in name_map:
            name = override.get(path, onnx_name)
            t = inits.get(name)
            if t is None:
                # tolerate exporter prefixes both ways: our name with its
                # first segment stripped, an 'onnx::' mangling, or any
                # initializer whose dotted suffix matches uniquely
                for cand in (name, name.split(".", 1)[-1], "onnx::" + name):
                    if cand in inits:
                        t = inits[cand]
                        break
                    hits = by_suffix.get(cand, [])
                    if len(hits) == 1:
                        t = inits[hits[0]]
                        break
            if t is None or t.array is None:
                missing.append(f"{comp_file}:{name}")
                missing_paths.append(path)
                continue
            _set_path(params, path, bwd(t.array).astype(np.float32))
    if missing:
        if strict:
            raise KeyError(f"missing {len(missing)} initializers, e.g. {missing[:5]}")
        seeded = init_params_numpy(cfg, seed=0)
        for path in missing_paths:
            _set_path(params, path, _get_path(seeded, path))
    return params
