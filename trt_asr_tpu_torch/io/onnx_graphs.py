"""Executable ONNX compute graphs for the encoder, predictor and joint: the
port's copy of the JAX package's ``io/onnx_graphs.py`` (the same nodes, in
the same order, so that both exports are equal byte for byte).

The reference's export produced *runnable* ONNX programs smoke-tested under
ORT (tools/export_onnx/export.py:819-852); its parity harnesses then
executed them as an op-level-independent oracle. This module restores that
property for our export: ALL FOUR component files (encoder.onnx offline,
encoder_streaming.onnx cache-aware chunk step, predictor.onnx, joint.onnx)
carry real compute nodes (Conv/Softmax/LayerNormalization/GatherElements/
LSTM/MatMul/...) over the SAME NeMo-state-dict-named, torch-layout
initializers the weight loader consumes — layout adaptation (weight
transposes, torch ifgo -> ONNX iofc LSTM gate reorder, contract-cache
alignment rolls) happens *inside the graph*, so the stored weights stay
byte-identical to the initializer-only export and real-NeMo artifacts
remain loadable.

Graph IO contracts (reference model_meta.json tensor_layout_contract,
export.py:970-997):
  predictor: y [B,U] int32, h/c [L,B,H] -> g [B,H,U], h_out/c_out [L,B,H]
  joint: encoder_output [B,D,T], predictor_output [B,H,U]
         -> joint_output [B,T,U,V]

A pure-numpy interpreter for exactly this op set lives in
tools/onnx_exec.py; tests/test_torch_onnx.py runs the port's exported
graphs through it against the port's torch encoder, predictor and joint.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from trt_asr_tpu_torch.config import ModelConfig
from trt_asr_tpu_torch.io.onnx_lite import OnnxNode

# ONNX TensorProto elem types used in IO value infos
F32, I32, I64 = 1, 6, 7


def _n(op: str, ins: List[str], outs: List[str], **attrs) -> OnnxNode:
    return OnnxNode(op, list(ins), list(outs), name=outs[0], attrs=dict(attrs))


def _ifgo_to_iofc(prefix: str, src: str, nodes: List[OnnxNode],
                  consts: Dict[str, np.ndarray]) -> str:
    """Reorder a torch LSTM parameter (gate blocks i,f,g,o along axis 0)
    into ONNX LSTM order (i,o,f,c where ONNX's c IS torch's g), then add
    the leading num_directions axis. Runs as graph nodes so the stored
    initializer keeps the torch layout."""
    parts = [f"{prefix}_g{i}" for i in range(4)]
    nodes.append(_n("Split", [src], parts, axis=0, num_outputs=4))
    cat = f"{prefix}_iofc"
    i, f, g, o = parts
    nodes.append(_n("Concat", [i, o, f, g], [cat], axis=0))
    consts.setdefault("__axes0", np.array([0], np.int64))
    out = f"{prefix}_dir"
    nodes.append(_n("Unsqueeze", [cat, "__axes0"], [out]))
    return out


def encoder_graph(cfg: ModelConfig, t_in: int) -> Tuple[List[OnnxNode],
                                                        Dict[str, np.ndarray],
                                                        Dict[str, Tuple[int, Tuple]]]:
    """Compute nodes for encoder.onnx (OFFLINE full-utterance encode) at a
    STATIC input length ``t_in`` — the executable-export analog of the
    reference's fixed TRT shape profiles (its ONNX used dynamic axes; a
    static-shape runnable program serves the same independent-execution
    role and is recorded in model_meta.json as encoder_static_t_in).

    Mirrors models/parakeet/encoder.py offline semantics node for node:
    dw_striding 8x subsample -> per layer [macaron FFN1 (silu, 1/2
    residual) -> rel-pos MHA (Transformer-XL shift via Pad/Reshape/Slice,
    exactly ops/attention.py:93-96) -> conv module (GLU, depthwise k=9
    over a zero-padded window, BatchNorm inference, silu) -> FFN2 ->
    LayerNorm]. `length` drives the same valid-step masking the runtime
    applies (attention-key mask + input/pre-conv zeroing — encoder.py
    :240,:362,:370), so inputs shorter than the static t_in are
    length-exact: zero-pad to t_in and pass the true length, exactly like
    a fixed-shape TRT profile.

    Initializers keep the unprefixed NeMo state-dict names/layouts of the
    weight-interchange export; layout adaptation (torch [out,in] linear
    transposes, pointwise-conv squeeze) happens in-graph, so the stored
    weights stay byte-identical."""
    nodes, consts = _emit_encoder_body(cfg, t_in, c_size=0, drop=0)
    t = _sub_len(t_in, cfg.stride_stages)
    io_types = {
        "audio_signal": (F32, (1, cfg.feat_in, t_in)),
        "length": (I64, (1,)),
        "encoder_output": (F32, (1, cfg.d_model, t)),
        "encoded_lengths": (I64, (1,)),
    }
    return nodes, consts, io_types


def _sub_len(t: int, stages: int) -> int:
    for _ in range(stages):
        t = (t - 1) // 2 + 1
    return t


def _emit_encoder_body(cfg: ModelConfig, t_in: int, c_size: int,
                       drop: int, prefix: str = "") -> Tuple[List[OnnxNode],
                                                            Dict[str, np.ndarray]]:
    """Shared conformer emission for the offline (c_size=0) and streaming
    (c_size=attention-cache capacity, drop=drop_extra_pre_encoded) graphs.

    Streaming additions, mirroring models/parakeet/encoder.py semantics:
    attention keys/values are [channel-cache u ++ current u] with the
    invalid cache prefix masked out of the softmax; the depthwise conv's
    left zero-pad is replaced by the time cache; per-layer cache updates
    keep the first (Tq - cache_drop) current steps. Internally caches are
    RIGHT-aligned (newest last, zeros-then-valid) so every shape and the
    rel-pos distance matrix stay static — the same trick the runtime uses
    (ops/attention.py module docstring); the public graph IO converts
    from/to the contract's LEFT-aligned chronological layout
    (encoder.py:state_to_contract) via GatherElements rolls."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    f_in = cfg.feat_in
    streaming = c_size > 0

    # static post-subsample geometry (ops/conv.py:subsampled_length)
    t = _sub_len(t_in, cfg.stride_stages) - drop
    f_sub = _sub_len(f_in, cfg.stride_stages)
    s_kv = c_size + t                  # attention key/value length
    r = t + s_kv - 1                   # rel-pos table rows
    k_ctx = cfg.conv_context_size
    cache_keep = max(t - cfg.cache_drop_size, 0) if streaming else 0
    n_l = cfg.num_layers

    nodes: List[OnnxNode] = []
    consts: Dict[str, np.ndarray] = {
        "__axes1": np.array([1], np.int64),
        "__axes2": np.array([2], np.int64),
        "__i_1": np.array([1], np.int64),
        "__i_2": np.array([2], np.int64),
        "__zero": np.array([0], np.int64),
        # Clip min/max must be SCALARS (empty shape) per the ONNX-13 spec —
        # shape-[1] bounds are rejected by strict checkers
        "__s0": np.int64(0),
        "__s_t": np.int64(t),
    }

    def n(op, ins, outs, **attrs):
        nodes.append(_n(op, ins, outs, **attrs))
        return outs[0]

    cache_u_in, time_in, cache_u_out, time_out = [], [], [], []
    if streaming:
        # ---- cache layout conversion: contract LEFT-aligned -> internal
        # RIGHT-aligned. right[j] = left[j - (C - len)] for j >= C - len.
        consts["__c_cap"] = np.array([c_size], np.int64)
        consts["__range_c"] = np.arange(c_size, dtype=np.int64)       # [C]
        consts["__s_cm1"] = np.int64(c_size - 1)
        consts["__s_cap"] = np.int64(c_size)
        # cache-update slice bounds (graph-wide: every layer keeps the same
        # first cache_keep current steps)
        consts["__i_keep"] = np.array([cache_keep], np.int64)
        consts["__i_keep_c"] = np.array([cache_keep + c_size], np.int64)
        consts["__i_keep_k"] = np.array([cache_keep + k_ctx], np.int64)
        consts["__cch_shape"] = np.array([1, n_l, c_size, d], np.int64)
        shift = n("Sub", ["__c_cap", "cache_last_channel_len"], ["cc_shift"])
        idx = n("Sub", ["__range_c", shift], ["cc_idx_raw"])          # [C]
        idx = n("Clip", [idx, "__s0", "__s_cm1"], ["cc_idx"])
        idx4 = n("Reshape", [idx, "__cc_idx_shape"], ["cc_idx4"])
        consts["__cc_idx_shape"] = np.array([1, 1, c_size, 1], np.int64)
        idx4 = n("Expand", [idx4, "__cch_shape"], ["cc_idx_exp"])
        g_all = n("GatherElements", ["cache_last_channel", idx4],
                  ["cc_gathered"], axis=2)
        valid = n("GreaterOrEqual", ["__range_c", shift], ["cc_valid"])  # [C]
        vm = n("Reshape", [valid, "__cc_idx_shape"], ["cc_valid4"])
        right_all = n("Where", [vm, g_all, "__f_zero"], ["cc_right"])
        for li in range(n_l):
            consts[f"__li{li}"] = np.array([li], np.int64)
            consts[f"__li{li + 1}e"] = np.array([li + 1], np.int64)
            cu = n("Slice", [right_all, f"__li{li}", f"__li{li + 1}e",
                             "__axes1"], [f"cu_{li}_4"])              # [1,1,C,D]
            cu = n("Squeeze", [cu, "__axes1"], [f"cu_{li}"])          # [1,C,D]
            cache_u_in.append(cu)
            tc = n("Slice", ["cache_last_time", f"__li{li}",
                             f"__li{li + 1}e", "__axes1"], [f"tc_{li}_4"])
            tc = n("Squeeze", [tc, "__axes1"], [f"tc_{li}_dk"])       # [1,D,K]
            tc = n("Transpose", [tc], [f"tc_{li}"], perm=[0, 2, 1])   # [1,K,D]
            time_in.append(tc)

    # ---- pre-encode: [1, F, T_in] -> NCHW [1, 1, T_in, F] ----
    x = n("Transpose", ["audio_signal"], ["pe_tf"], perm=[0, 2, 1])
    x = n("Unsqueeze", [x, "__axes1"], ["pe_nchw"])
    x = n("Conv", [x, f"{prefix}pre_encode.conv.0.weight",
                   f"{prefix}pre_encode.conv.0.bias"],
          ["pe_c0"], strides=[2, 2], pads=[1, 1, 1, 1], kernel_shape=[3, 3])
    x = n("Relu", [x], ["pe_r0"])
    ch = cfg.subsampling_conv_channels
    for s in range(cfg.stride_stages - 1):
        base = 2 + 3 * s
        x = n("Conv", [x, f"{prefix}pre_encode.conv.{base}.weight",
                       f"{prefix}pre_encode.conv.{base}.bias"], [f"pe_dw{s}"],
              strides=[2, 2], pads=[1, 1, 1, 1], kernel_shape=[3, 3], group=ch)
        x = n("Conv", [x, f"{prefix}pre_encode.conv.{base + 1}.weight",
                       f"{prefix}pre_encode.conv.{base + 1}.bias"], [f"pe_pw{s}"],
              strides=[1, 1], pads=[0, 0, 0, 0], kernel_shape=[1, 1])
        x = n("Relu", [x], [f"pe_r{s + 1}"])
    # torch flattening order: [1,C,T,F'] -> [1,T,C,F'] -> [1,T,C*F']
    x = n("Transpose", [x], ["pe_tcf"], perm=[0, 2, 1, 3])
    consts["__pe_flat"] = np.array([1, t + drop, ch * f_sub], np.int64)
    x = n("Reshape", [x, "__pe_flat"], ["pe_flat"])
    w = n("Transpose", [f"{prefix}pre_encode.out.weight"], ["pe_outW_t"],
          perm=[1, 0])
    x = n("MatMul", [x, w], ["pe_mm"])
    x = n("Add", [x, f"{prefix}pre_encode.out.bias"], ["x_enc_pre"])
    if drop:
        consts["__i_drop"] = np.array([drop], np.int64)
        consts["__imax0"] = np.array([np.iinfo(np.int64).max], np.int64)
        x = n("Slice", [x, "__i_drop", "__imax0", "__axes1"], ["x_enc0"])
    else:
        x = n("Identity", [x], ["x_enc0"])

    # ---- valid-length arithmetic (hoisted: the streaming masks below need
    # it). encoded_lengths = subsampled(length) [- drop_extra when
    # streaming]. Each stride-2 stage is ceil(n/2), emitted as (n+1)/2 —
    # for n >= 0 this is identical under floor AND truncate-toward-zero
    # division (ONNX Div is trunc), unlike floor((n-1)/2)+1 which diverges
    # at n == 0 between the two semantics.
    ll = "length"
    for st in range(cfg.stride_stages):
        a = n("Add", [ll, "__i_1"], [f"len_a{st}"])
        ll = n("Div", [a, "__i_2"], [f"len_d{st}"])
    if drop:
        ll = n("Sub", [ll, "__i_drop"], ["len_dropped"])
    # clamp to [0, T_enc]: the drop can push a tiny flush negative, and an
    # over-length input must not report more steps than the static output
    # carries (runtime: min(sub_len, steps) — encoder.py:437)
    ll = n("Clip", [ll, "__s0", "__s_t"], ["len_final"])

    # ---- valid-length masking, mirroring the runtime exactly (encoder.py
    # time_mask at :240,:362,:370 — applied OFFLINE too: offline_encode
    # masks padded frames the same way, so encoder.onnx honors `length`
    # like a real NeMo export): steps at or past the valid post-drop
    # length are (1) zeroed at the layer-stack input, (2) masked out of
    # every attention softmax, (3) zeroed before each depthwise conv so
    # the tail lookahead never reads them. For full windows / full-length
    # inputs all three are identities. NOTE the streaming graph's static
    # cache updates still assume a full window — cache outputs are only
    # meaningful for full chunks, which is the only case the schedule
    # feeds mid-stream (a short chunk is always the last, after which the
    # caches are dead).
    consts["__f_zero"] = np.float32(0.0)
    consts["__range_t"] = np.arange(t, dtype=np.int64)
    cur_ok = n("Less", ["__range_t", ll], ["cur_ok"])                # [t]
    consts["__cm3_shape"] = np.array([1, t, 1], np.int64)
    cur_mask3 = n("Reshape", [cur_ok, "__cm3_shape"], ["cur_mask3"])
    x = n("Where", [cur_mask3, x, "__f_zero"], ["x_masked"])

    # shared constants. Pos table built in pure numpy (identical math to
    # ops/attention.py:sinusoidal_pos_table — descending positions, sin
    # even / cos odd) so the exporter never touches a jax device.
    positions = np.arange(s_kv - 1, -t, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64)
                 * -(np.log(10000.0) / d))
    pe = np.zeros((r, d), np.float64)
    pe[:, 0::2] = np.sin(positions * div)
    pe[:, 1::2] = np.cos(positions * div)
    consts["__pos_table"] = pe.astype(np.float32)            # [R, D]
    consts["__att_scale"] = np.float32(1.0 / np.sqrt(dh))
    consts["__half"] = np.float32(0.5)
    consts["__conv_zpad"] = np.zeros((1, k_ctx, d), np.float32)
    consts["__q4"] = np.array([1, t, h, dh], np.int64)
    consts["__kv4"] = np.array([1, s_kv, h, dh], np.int64)
    consts["__flat_d"] = np.array([1, t, d], np.int64)
    consts["__pd_flat"] = np.array([1, h, t * (r + 1)], np.int64)
    consts["__pd_back"] = np.array([1, h, t, r], np.int64)
    consts["__pos_hdr"] = np.array([r, h, dh], np.int64)
    consts["__bias_r"] = np.array([h, 1, dh], np.int64)
    consts["__pad_last1"] = np.array([0, 0, 0, 1, 0, 0, 0, 0], np.int64)
    consts["__imax"] = np.array([np.iinfo(np.int64).max], np.int64)
    consts["__i_t"] = np.array([t], np.int64)
    consts["__i_skv"] = np.array([s_kv], np.int64)
    consts["__axes3"] = np.array([3], np.int64)
    # softmax mask over the kv axis: current slot j' attends iff j' < valid
    # post-drop steps ("cur_ok"); streaming prepends the cache slots, where
    # slot j attends iff j >= C - len (right-aligned cache, "cc_valid")
    if streaming:
        kv_ok = n("Concat", ["cc_valid", "cur_ok"], ["kv_ok"], axis=0)
    else:
        kv_ok = "cur_ok"                                  # s_kv == t offline
    consts["__kvm_shape"] = np.array([1, 1, 1, s_kv], np.int64)
    kv_mask = n("Reshape", [kv_ok, "__kvm_shape"], ["kv_mask"])
    consts["__neg_big"] = np.float32(-1e30)

    def ln(xi, g, b, out):
        return n("LayerNormalization", [xi, g, b], [out], axis=-1,
                 epsilon=1e-5)

    def silu(xi, tag):
        s = n("Sigmoid", [xi], [f"{tag}_sg"])
        return n("Mul", [xi, s], [f"{tag}_silu"])

    for li in range(cfg.num_layers):
        p = f"{prefix}layers.{li}"
        lt = f"l{li}"

        def mm_t(src, wname, out):
            wt = n("Transpose", [wname], [f"{out}_Wt"], perm=[1, 0])
            return n("MatMul", [src, wt], [out])

        # ---- macaron FFN1 ----
        def half_ffn(xi, which):
            tag = f"{lt}_{which}"
            u0 = ln(xi, f"{p}.norm_{which}.weight", f"{p}.norm_{which}.bias",
                    f"{tag}_ln")
            m1 = mm_t(u0, f"{p}.{which}.linear1.weight", f"{tag}_m1")
            a = silu(m1, tag)
            m2 = mm_t(a, f"{p}.{which}.linear2.weight", f"{tag}_m2")
            sc = n("Mul", [m2, "__half"], [f"{tag}_half"])
            return n("Add", [xi, sc], [f"{tag}_res"])

        x = half_ffn(x, "feed_forward1")

        # ---- rel-pos self-attention ----
        u = ln(x, f"{p}.norm_self_att.weight", f"{p}.norm_self_att.bias",
               f"{lt}_att_ln")
        if streaming:
            # keys/values over [cached u ++ current u]; projections are
            # bias-free so projecting the cached u here equals the
            # runtime's projected-kv cache exactly (encoder.py:184-190)
            u_kv = n("Concat", [cache_u_in[li], u], [f"{lt}_ukv"], axis=1)
        else:
            u_kv = u
        q = mm_t(u, f"{p}.self_attn.linear_q.weight", f"{lt}_q")
        kk = mm_t(u_kv, f"{p}.self_attn.linear_k.weight", f"{lt}_k")
        vv = mm_t(u_kv, f"{p}.self_attn.linear_v.weight", f"{lt}_v")
        q4 = n("Reshape", [q, "__q4"], [f"{lt}_q4"])
        q4 = n("Transpose", [q4], [f"{lt}_q4t"], perm=[0, 2, 1, 3])  # [1,H,T,dh]
        k4 = n("Reshape", [kk, "__kv4"], [f"{lt}_k4"])
        kT = n("Transpose", [k4], [f"{lt}_kT"], perm=[0, 2, 3, 1])   # [1,H,dh,S]
        v4 = n("Reshape", [vv, "__kv4"], [f"{lt}_v4"])
        v4 = n("Transpose", [v4], [f"{lt}_v4t"], perm=[0, 2, 1, 3])  # [1,H,S,dh]
        bu = n("Reshape", [f"{p}.self_attn.pos_bias_u", "__bias_r"],
               [f"{lt}_bu"])
        bv = n("Reshape", [f"{p}.self_attn.pos_bias_v", "__bias_r"],
               [f"{lt}_bv"])
        qu = n("Add", [q4, bu], [f"{lt}_qu"])
        qv = n("Add", [q4, bv], [f"{lt}_qv"])
        # positional projection in-graph: pos_proj = pos_table @ W_pos^T
        pw = n("Transpose", [f"{p}.self_attn.linear_pos.weight"],
               [f"{lt}_posW_t"], perm=[1, 0])
        pp = n("MatMul", ["__pos_table", pw], [f"{lt}_pp"])         # [R, D]
        pp = n("Reshape", [pp, "__pos_hdr"], [f"{lt}_pp3"])          # [R,H,dh]
        ppT = n("Transpose", [pp], [f"{lt}_ppT"], perm=[1, 2, 0])    # [H,dh,R]
        ac = n("MatMul", [qu, kT], [f"{lt}_ac"])                     # [1,H,T,T]
        pd = n("MatMul", [qv, ppT], [f"{lt}_pd"])                    # [1,H,T,R]
        # Transformer-XL relative shift (ops/attention.py:93-96)
        pad = n("Pad", [pd, "__pad_last1"], [f"{lt}_pdp"])           # [1,H,T,R+1]
        fl = n("Reshape", [pad, "__pd_flat"], [f"{lt}_pdf"])
        sl = n("Slice", [fl, "__i_t", "__imax", "__axes2"], [f"{lt}_pds"])
        bk = n("Reshape", [sl, "__pd_back"], [f"{lt}_pdb"])          # [1,H,T,R]
        bd = n("Slice", [bk, "__zero", "__i_skv", "__axes3"],
               [f"{lt}_bd"])                                         # [1,H,T,S]
        sc = n("Add", [ac, bd], [f"{lt}_sc"])
        sc = n("Mul", [sc, "__att_scale"], [f"{lt}_scs"])
        sc = n("Where", [kv_mask, sc, "__neg_big"], [f"{lt}_scm"])
        at = n("Softmax", [sc], [f"{lt}_sm"], axis=3)
        av = n("MatMul", [at, v4], [f"{lt}_av"])                     # [1,H,T,dh]
        av = n("Transpose", [av], [f"{lt}_avt"], perm=[0, 2, 1, 3])
        av = n("Reshape", [av, "__flat_d"], [f"{lt}_avf"])
        ao = mm_t(av, f"{p}.self_attn.linear_out.weight", f"{lt}_ao")
        x = n("Add", [x, ao], [f"{lt}_att_res"])
        if streaming:
            # channel-cache update: keep last C of [cache ++ first
            # cache_keep current u] (right-aligned; encoder.py:199)
            kept = n("Slice", [u, "__zero", "__i_keep", "__axes1"],
                     [f"{lt}_u_kept"])
            cat = n("Concat", [cache_u_in[li], kept], [f"{lt}_cu_cat"],
                    axis=1)                                  # [1,C+keep,D]
            cache_u_out.append(n("Slice", [cat, "__i_keep", "__i_keep_c",
                                           "__axes1"], [f"{lt}_cu_new"]))

        # ---- convolution module ----
        c = ln(x, f"{p}.norm_conv.weight", f"{p}.norm_conv.bias",
               f"{lt}_cv_ln")
        pw1 = n("Squeeze", [f"{p}.conv.pointwise_conv1.weight", "__axes2"],
                [f"{lt}_pw1s"])
        pw1 = n("Transpose", [pw1], [f"{lt}_pw1t"], perm=[1, 0])
        c = n("MatMul", [c, pw1], [f"{lt}_cv_pw1"])                  # [1,T,2D]
        g1, g2 = f"{lt}_glu_a", f"{lt}_glu_b"
        nodes.append(_n("Split", [c], [g1, g2], axis=2, num_outputs=2))
        gs = n("Sigmoid", [g2], [f"{lt}_glu_sg"])
        c = n("Mul", [g1, gs], [f"{lt}_glu"])                        # [1,T,D]
        # zero padded steps pre-conv AND pre-cache (encoder.py:240) so the
        # depthwise tail lookahead never reads invalid steps
        c = n("Where", ["cur_mask3", c, "__f_zero"], [f"{lt}_glu_m"])
        if streaming:
            # time cache replaces the left zero-pad (encoder.py:241-243);
            # update keeps the last K of [cache ++ first cache_keep steps]
            kept_c = n("Slice", [c, "__zero", "__i_keep", "__axes1"],
                       [f"{lt}_c_kept"])
            tcat = n("Concat", [time_in[li], kept_c], [f"{lt}_tc_cat"],
                     axis=1)                                 # [1,K+keep,D]
            time_out.append(n("Slice", [tcat, "__i_keep", "__i_keep_k",
                                        "__axes1"], [f"{lt}_tc_new"]))
            left_pad = time_in[li]
        else:
            left_pad = "__conv_zpad"
        c = n("Concat", [left_pad, c, "__conv_zpad"], [f"{lt}_cv_ext"],
              axis=1)                                                # [1,T+2K,D]
        c = n("Transpose", [c], [f"{lt}_cv_ncw"], perm=[0, 2, 1])
        c = n("Conv", [c, f"{p}.conv.depthwise_conv.weight"], [f"{lt}_cv_dw"],
              strides=[1], pads=[0, 0], kernel_shape=[cfg.conv_kernel_size],
              group=d)                                               # [1,D,T]
        c = n("BatchNormalization",
              [c, f"{p}.conv.batch_norm.weight", f"{p}.conv.batch_norm.bias",
               f"{p}.conv.batch_norm.running_mean",
               f"{p}.conv.batch_norm.running_var"], [f"{lt}_cv_bn"],
              epsilon=1e-5)
        c = n("Transpose", [c], [f"{lt}_cv_twd"], perm=[0, 2, 1])    # [1,T,D]
        c = silu(c, f"{lt}_cv")
        pw2 = n("Squeeze", [f"{p}.conv.pointwise_conv2.weight", "__axes2"],
                [f"{lt}_pw2s"])
        pw2 = n("Transpose", [pw2], [f"{lt}_pw2t"], perm=[1, 0])
        c = n("MatMul", [c, pw2], [f"{lt}_cv_pw2"])
        x = n("Add", [x, c], [f"{lt}_cv_res"])

        # ---- FFN2 + out LN ----
        x = half_ffn(x, "feed_forward2")
        x = ln(x, f"{p}.norm_out.weight", f"{p}.norm_out.bias",
               f"{lt}_out_ln")

    # reference layout [B, D, T_enc]
    n("Transpose", [x], ["encoder_output"], perm=[0, 2, 1])
    n("Identity", [ll], ["encoded_lengths"])

    if streaming:
        # ---- cache outputs: internal RIGHT-aligned -> contract LEFT-
        # aligned chronological. left[j] = right[j + (C - len_out)] for
        # j < len_out, else 0 (state_to_contract zero-pads the invalid
        # suffix).
        len_out = n("Add", ["cache_last_channel_len", "__i_keep"],
                    ["len_plus"])
        len_out = n("Clip", [len_out, "__s0", "__s_cap"],
                    ["cache_last_channel_len_out"])
        stk = []
        for li in range(n_l):
            stk.append(n("Unsqueeze", [cache_u_out[li], "__axes1"],
                         [f"cu_out_{li}_4"]))               # [1,1,C,D]
        right_out = n("Concat", stk, ["cc_out_right"], axis=1)  # [1,L,C,D]
        shift_o = n("Sub", ["__c_cap", "cache_last_channel_len_out"],
                    ["cc_shift_out"])
        idx_o = n("Add", ["__range_c", shift_o], ["cc_oidx_raw"])
        idx_o = n("Clip", [idx_o, "__s0", "__s_cm1"], ["cc_oidx"])
        idx_o = n("Reshape", [idx_o, "__cc_idx_shape"], ["cc_oidx4"])
        idx_o = n("Expand", [idx_o, "__cch_shape"], ["cc_oidx_exp"])
        g_o = n("GatherElements", [right_out, idx_o], ["cc_out_gath"],
                axis=2)
        ok_o = n("Less", ["__range_c", "cache_last_channel_len_out"],
                 ["cc_out_ok"])
        ok_o = n("Reshape", [ok_o, "__cc_idx_shape"], ["cc_out_ok4"])
        n("Where", [ok_o, g_o, "__f_zero"], ["cache_last_channel_out"])
        tstk = []
        for li in range(n_l):
            tt = n("Transpose", [time_out[li]], [f"tc_out_{li}_dk"],
                   perm=[0, 2, 1])                          # [1,D,K]
            tstk.append(n("Unsqueeze", [tt, "__axes1"], [f"tc_out_{li}_4"]))
        n("Concat", tstk, ["cache_last_time_out"], axis=1)  # [1,L,D,K]

    return nodes, consts


def streaming_encoder_graph(cfg: ModelConfig) -> Tuple[List[OnnxNode],
                                                       Dict[str, np.ndarray],
                                                       Dict[str, Tuple[int, Tuple]]]:
    """Compute nodes for encoder_streaming.onnx: ONE steady cache-aware
    chunk step with the reference's 5-in/5-out cache IO
    (onnx_weights.STREAMING_ENCODER_INPUTS/OUTPUTS; reference
    export.py:660-750 exports the same signature). Static window =
    steady_chunk + pre_encode feature frames (the unified profile the
    runtime serves, schedule.py); drop_extra applied in-graph; cache IO in
    the contract's left-aligned chronological layout
    (encoder.py:state_to_contract), converted internally to right-aligned
    static-shape math. `length` drives BOTH encoded_lengths and the
    in-graph valid-step masking (the runtime's time_mask), so a short
    flush chunk zero-padded to the window is exact on its emitted steps;
    only the cache OUTPUTS assume a full window (the sole mid-stream case
    — after a short chunk the stream ends and caches are dead)."""
    window = cfg.chunk_size_frames[1] + cfg.pre_encode_cache_size[1]
    nodes, consts = _emit_encoder_body(cfg, window,
                                       c_size=cfg.att_cache_size,
                                       drop=cfg.drop_extra_pre_encoded,
                                       prefix="encoder.")
    t = _sub_len(window, cfg.stride_stages) - cfg.drop_extra_pre_encoded
    c, d, k = cfg.att_cache_size, cfg.d_model, cfg.conv_context_size
    io_types = {
        "audio_signal": (F32, (1, cfg.feat_in, window)),
        "length": (I64, (1,)),
        "cache_last_channel": (F32, (1, cfg.num_layers, c, d)),
        "cache_last_time": (F32, (1, cfg.num_layers, d, k)),
        "cache_last_channel_len": (I64, (1,)),
        "encoder_output": (F32, (1, d, t)),
        "encoded_lengths": (I64, (1,)),
        "cache_last_channel_out": (F32, (1, cfg.num_layers, c, d)),
        "cache_last_time_out": (F32, (1, cfg.num_layers, d, k)),
        "cache_last_channel_len_out": (I64, (1,)),
    }
    return nodes, consts, io_types


def predictor_graph(cfg: ModelConfig) -> Tuple[List[OnnxNode],
                                               Dict[str, np.ndarray],
                                               Dict[str, Tuple[int, Tuple]]]:
    """Compute nodes for predictor.onnx: embedding gather + L ONNX LSTM
    layers + the reference's [B,U,H]->[B,H,U] output transpose."""
    nodes: List[OnnxNode] = []
    consts: Dict[str, np.ndarray] = {}
    H = cfg.pred_hidden
    L = cfg.pred_rnn_layers

    nodes.append(_n("Gather", ["prediction.embed.weight", "y"], ["emb"], axis=0))
    nodes.append(_n("Transpose", ["emb"], ["x0"], perm=[1, 0, 2]))  # [U,B,E]

    h_outs, c_outs = [], []
    x = "x0"
    for li in range(L):
        w = _ifgo_to_iofc(f"W{li}", f"prediction.dec_rnn.lstm.weight_ih_l{li}",
                          nodes, consts)
        r = _ifgo_to_iofc(f"R{li}", f"prediction.dec_rnn.lstm.weight_hh_l{li}",
                          nodes, consts)
        bi = _ifgo_to_iofc(f"Bi{li}", f"prediction.dec_rnn.lstm.bias_ih_l{li}",
                           nodes, consts)
        bh = _ifgo_to_iofc(f"Bh{li}", f"prediction.dec_rnn.lstm.bias_hh_l{li}",
                           nodes, consts)
        b = f"B{li}_onnx"
        nodes.append(_n("Concat", [bi, bh], [b], axis=1))  # [1, 8H]
        consts[f"__sl_start{li}"] = np.array([li], np.int64)
        consts[f"__sl_end{li}"] = np.array([li + 1], np.int64)
        consts.setdefault("__sl_axis0", np.array([0], np.int64))
        h0, c0 = f"h0_{li}", f"c0_{li}"
        nodes.append(_n("Slice", ["h", f"__sl_start{li}", f"__sl_end{li}",
                                  "__sl_axis0"], [h0]))
        nodes.append(_n("Slice", ["c", f"__sl_start{li}", f"__sl_end{li}",
                                  "__sl_axis0"], [c0]))
        y_all, y_h, y_c = f"Y{li}", f"Yh{li}", f"Yc{li}"
        nodes.append(_n("LSTM", [x, w, r, b, "", h0, c0], [y_all, y_h, y_c],
                        hidden_size=H))
        consts.setdefault("__axes1", np.array([1], np.int64))
        nxt = f"x{li + 1}"
        nodes.append(_n("Squeeze", [y_all, "__axes1"], [nxt]))  # [U,B,H]
        x = nxt
        h_outs.append(y_h)
        c_outs.append(y_c)

    nodes.append(_n("Concat", h_outs, ["h_out"], axis=0))
    nodes.append(_n("Concat", c_outs, ["c_out"], axis=0))
    # reference g layout is [B, H, U] (model_meta tensor_layout_contract)
    nodes.append(_n("Transpose", [x], ["g"], perm=[1, 2, 0]))

    io_types = {
        "y": (I32, ("B", "U")),
        "h": (F32, (L, "B", H)),
        "c": (F32, (L, "B", H)),
        "g": (F32, ("B", H, "U")),
        "h_out": (F32, (L, "B", H)),
        "c_out": (F32, (L, "B", H)),
    }
    return nodes, consts, io_types


def joint_graph(cfg: ModelConfig) -> Tuple[List[OnnxNode],
                                           Dict[str, np.ndarray],
                                           Dict[str, Tuple[int, Tuple]]]:
    """Compute nodes for joint.onnx: two input projections, broadcast add,
    ReLU, output projection -> raw logits [B,T,U,V] (no LogSoftmax — the
    reference asserts its absence, tools/inspect_onnx/check_joint_output.py)."""
    nodes: List[OnnxNode] = []
    consts: Dict[str, np.ndarray] = {
        "__axes1": np.array([1], np.int64),
        "__axes2": np.array([2], np.int64),
    }
    nodes.append(_n("Transpose", ["encoder_output"], ["enc_btd"], perm=[0, 2, 1]))
    nodes.append(_n("Transpose", ["joint.enc.weight"], ["Wenc_t"], perm=[1, 0]))
    nodes.append(_n("MatMul", ["enc_btd", "Wenc_t"], ["enc_mm"]))
    nodes.append(_n("Add", ["enc_mm", "joint.enc.bias"], ["enc_proj"]))

    nodes.append(_n("Transpose", ["predictor_output"], ["pred_buh"], perm=[0, 2, 1]))
    nodes.append(_n("Transpose", ["joint.pred.weight"], ["Wpred_t"], perm=[1, 0]))
    nodes.append(_n("MatMul", ["pred_buh", "Wpred_t"], ["pred_mm"]))
    nodes.append(_n("Add", ["pred_mm", "joint.pred.bias"], ["pred_proj"]))

    nodes.append(_n("Unsqueeze", ["enc_proj", "__axes2"], ["enc_btuj"]))   # [B,T,1,J]
    nodes.append(_n("Unsqueeze", ["pred_proj", "__axes1"], ["pred_btuj"]))  # [B,1,U,J]
    nodes.append(_n("Add", ["enc_btuj", "pred_btuj"], ["sum_btuj"]))
    nodes.append(_n("Relu", ["sum_btuj"], ["act"]))
    nodes.append(_n("Transpose", ["joint.joint_net.2.weight"], ["Wout_t"], perm=[1, 0]))
    nodes.append(_n("MatMul", ["act", "Wout_t"], ["out_mm"]))
    nodes.append(_n("Add", ["out_mm", "joint.joint_net.2.bias"], ["joint_output"]))

    io_types = {
        "encoder_output": (F32, ("B", cfg.d_model, "T")),
        "predictor_output": (F32, ("B", cfg.pred_hidden, "U")),
        "joint_output": (F32, ("B", "T", "U", cfg.joint_vocab_size)),
    }
    return nodes, consts, io_types
