"""Fused attention block of the PyTorch port (``ops/kernels/att_block.py``)
against the JAX package on a warm ring cache: its plain version against
``att_block_pallas`` in interpret mode and against the XLA attention
section of ``_conformer_layer``, with f32 and int8 weights. The CUDA
kernel is held against the plain version in ``test_torch_kernels_cuda.py``.

Tolerances: f32 2e-5 absolute (summation order); int8 2e-3 absolute — both
sides round the same operands to bf16, but an f32 value that differs in its
last bit can round to a neighbouring bf16 value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

from trt_asr_tpu.ops.pallas.att_block_kernel import att_block_pallas, build_rel_selection
from trt_asr_tpu.ops.quant import quantize_tensor as j_quantize
from trt_asr_tpu_torch.ops.kernels.att_block import att_block, att_block_plain
from trt_asr_tpu_torch.ops.quant import QuantTensor

D, H, C, TQ = 64, 4, 32, 8
CASES = [(7, 19, 6), (0, 0, 6), (5, 32, 8), (31, 32, 1)]   # cursor, cache_len, valid_tq


def make_inputs(seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=r(TQ, D, sc=1.0), ln_g=1.0 + r(D, sc=0.2), ln_b=r(D, sc=0.1),
                ws=[r(D, D) for _ in range(4)], bu=r(H, D // H), bv=r(H, D // H),
                kv=r(C, 2 * D), pos=r(2 * TQ + C - 1, D))


def jax_kernel(inp, ws, cursor, cache_len, valid_tq):
    r_pad = s_pad = 128
    posT = jnp.zeros((D, r_pad)).at[:, :inp["pos"].shape[0]].set(inp["pos"].T)
    g_dtype = jnp.bfloat16 if hasattr(ws[0], "q") else jnp.float32
    g_sel, mask = build_rel_selection(jnp.int32(cursor), jnp.int32(cache_len), C, TQ,
                                      jnp.int32(valid_tq), s_pad, r_pad, dtype=g_dtype)
    return att_block_pallas(jnp.asarray(inp["x"]), inp["ln_g"], inp["ln_b"], *ws,
                            inp["bu"], inp["bv"], posT, jnp.asarray(inp["kv"]),
                            g_sel, mask, n_heads=H, interpret=True)


def port_plain(inp, ws, cursor, cache_len, valid_tq):
    meta = torch.tensor([cursor, cache_len, valid_tq], dtype=torch.int32)
    return att_block_plain(t(inp["x"]), t(inp["ln_g"]), t(inp["ln_b"]), *ws, t(inp["bu"]),
                           t(inp["bv"]), t(inp["pos"]), t(inp["kv"]), meta, n_heads=H)


def compare(got, want, valid_tq, atol):
    names = ("y", "u", "k_new", "v_new")
    for name, g, w in zip(names, got, want):
        g, w = g.numpy(), np.asarray(w)
        if name == "y":                         # padded query rows are don't-care
            g, w = g[:valid_tq], w[:valid_tq]
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("cursor,cache_len,valid_tq", CASES)
def test_plain_matches_pallas_interpret_f32(cursor, cache_len, valid_tq):
    inp = make_inputs(cursor + 100 * valid_tq)
    want = jax_kernel(inp, [jnp.asarray(w) for w in inp["ws"]], cursor, cache_len, valid_tq)
    got = port_plain(inp, [t(w) for w in inp["ws"]], cursor, cache_len, valid_tq)
    compare(got, want, valid_tq, 2e-5)


@pytest.mark.parametrize("cursor,cache_len,valid_tq", CASES[:2])
def test_plain_matches_pallas_interpret_int8(cursor, cache_len, valid_tq):
    inp = make_inputs(7 + cursor)
    jw = [j_quantize(jnp.asarray(w)) for w in inp["ws"]]
    pw = [QuantTensor(t(np.asarray(q.q)), t(np.asarray(q.s))) for q in jw]
    want = jax_kernel(inp, jw, cursor, cache_len, valid_tq)
    got = port_plain(inp, pw, cursor, cache_len, valid_tq)
    compare(got, want, valid_tq, 2e-3)


def test_plain_matches_xla_attention_section():
    """The same function as encoder._conformer_layer's XLA attention path
    (LN, projections, rel_pos_attention_kv over ring cache ++ new rows)."""
    from trt_asr_tpu.ops.attention import rel_pos_attention_kv
    from trt_asr_tpu.ops.common import layer_norm, matmul

    cursor, cache_len, valid_tq = 7, 19, 6
    inp = make_inputs(11)
    wq, wk, wv, wo = [jnp.asarray(w) for w in inp["ws"]]
    dh = D // H
    x = jnp.asarray(inp["x"])
    age = ((cursor - 1 - np.arange(C)) % C) + 1
    idx_cache = (C + TQ - 1) - (age[None, :] + np.arange(TQ)[:, None])
    ii, jj = np.arange(TQ)[:, None], np.arange(TQ)[None, :]
    rel_idx = jnp.asarray(np.concatenate([idx_cache, (C + TQ - 1) - (ii - jj)], 1))[None]
    kv_mask = jnp.asarray(np.concatenate([age <= cache_len, np.arange(TQ) < valid_tq]))[None]
    u = layer_norm(x, inp["ln_g"], inp["ln_b"])
    kv = jnp.asarray(inp["kv"])
    k_full = jnp.concatenate([kv[None, :, :D], matmul(u, wk)[None]], 1)
    v_full = jnp.concatenate([kv[None, :, D:], matmul(u, wv)[None]], 1)
    y_ref = x + rel_pos_attention_kv(
        matmul(u, wq).reshape(1, TQ, H, dh), k_full.reshape(1, C + TQ, H, dh),
        v_full.reshape(1, C + TQ, H, dh), jnp.asarray(inp["pos"]).reshape(-1, H, dh),
        inp["bu"], inp["bv"], wo, kv_mask=kv_mask, rel_idx=rel_idx)[0]
    got = port_plain(inp, [t(w) for w in inp["ws"]], cursor, cache_len, valid_tq)
    compare(got, (y_ref, u, matmul(u, wk), matmul(u, wv)), valid_tq, 3e-5)


def test_wrapper_takes_plain_version_on_cpu():
    inp = make_inputs(3)
    meta = torch.tensor([3, 10, 6], dtype=torch.int32)
    args = (t(inp["x"]), t(inp["ln_g"]), t(inp["ln_b"]), *[t(w) for w in inp["ws"]],
            t(inp["bu"]), t(inp["bv"]), t(inp["pos"]), t(inp["kv"]), meta)
    before = att_block.launches
    for g, w in zip(att_block(*args, n_heads=H), att_block_plain(*args, n_heads=H)):
        assert torch.equal(g, w)
    assert att_block.launches == before           # no kernel launch on the CPU
