"""Fused conv module and conv + FFN2 + output LayerNorm of the PyTorch port
(``ops/kernels/conv_block.py``) against the JAX package: the plain versions
against ``conv_block_pallas`` and ``conv_ffn_ln_pallas`` in interpret mode,
with f32 and int8 weights (the same ``QuantTensor`` values on both sides),
padded rows and a non-zero time cache, and with the bf16 weights of
``cast_params_for_compute`` (bf16 pw1, pw2 and taps; the time cache f32 or
bf16, as a bf16 encoder state stores it); the plain conv module against the
XLA conv section of ``_conformer_layer``. The CUDA kernels are held against
the plain versions in ``test_torch_kernels_cuda.py``.

Tolerances: 1e-5 absolute and relative on y and c in f32 and in int8
(observed gaps 2.4e-7 to 7.2e-7): both sides round the same operands to
bf16 with int8 weights, so they differ only where an f32 value one bit
apart rounds to a neighbouring bf16 value, and none does at these seeds.
bf16 weights: the same 1e-5 (the same rounding points)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

from trt_asr_tpu.ops.pallas.conv_block_kernel import conv_block_pallas, conv_ffn_ln_pallas
from trt_asr_tpu.ops.quant import quantize_tensor as j_quantize
from trt_asr_tpu_torch.ops.kernels.conv_block import (conv_block, conv_block_plain,
                                                      conv_ffn_ln, conv_ffn_ln_plain)
from trt_asr_tpu_torch.ops.quant import QuantTensor

D, E, KK = 64, 128, 9       # ModelConfig.tiny()
TOL = 1e-5
CASES = [(8, 6), (6, 6), (8, 8), (3, 1)]     # Tq, valid steps


def make_inputs(seed, tq, valid):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(
        x=r(tq, D, sc=1.0), g=1.0 + r(D, sc=0.2), b=r(D, sc=0.1),
        pw1=r(D, 2 * D, sc=D ** -0.5), dw=r(KK, D),
        bn=[1.0 + r(D, sc=0.1), r(D, sc=0.1), r(D, sc=0.1), np.abs(r(D)) * 0.5 + 0.8],
        pw2=r(D, D, sc=D ** -0.5), tc=r((KK - 1) // 2, D, sc=1.0),
        mask=(np.arange(tq) < valid).astype(np.float32)[:, None],
        fg=1.0 + r(D, sc=0.2), fb=r(D, sc=0.1), w1=r(D, E, sc=D ** -0.5),
        w2=r(E, D, sc=E ** -0.5), og=1.0 + r(D, sc=0.2), ob=r(D, sc=0.1))


def weights(inp, names, kind):
    if kind == "f32":
        return [jnp.asarray(inp[k]) for k in names], [t(inp[k]) for k in names]
    if kind.startswith("bf16"):
        return ([jnp.asarray(inp[k]).astype(jnp.bfloat16) for k in names],
                [t(inp[k]).to(torch.bfloat16) for k in names])
    jw = [j_quantize(jnp.asarray(inp[k])) for k in names]
    return jw, [QuantTensor(t(np.asarray(q.q)), t(np.asarray(q.s))) for q in jw]


def conv_args(inp, pw1, pw2, conv):
    """Argument tuple of the conv module; ``conv`` maps numpy to a side."""
    return (conv(inp["x"]), conv(inp["g"]), conv(inp["b"]), pw1, conv(inp["dw"]),
            *[conv(a) for a in inp["bn"]], pw2, conv(inp["tc"]), conv(inp["mask"]))


def compare(got, want):
    for name, g, w in zip(("y", "c"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16", "bf16-tc"])
@pytest.mark.parametrize("tq,valid", CASES)
def test_conv_block_plain_matches_pallas_interpret(kind, tq, valid):
    """``bf16``: bf16 weights and taps (the JAX encoder passes the taps as
    stored; the kernel widens them), an f32 time cache; ``bf16-tc``: the
    time cache bf16 too."""
    inp = make_inputs(tq * 10 + valid, tq, valid)
    jw, pw = weights(inp, ("pw1", "pw2"), kind)
    jargs = list(conv_args(inp, jw[0], jw[1], jnp.asarray))
    pargs = list(conv_args(inp, pw[0], pw[1], t))
    if kind.startswith("bf16"):
        jargs[4], pargs[4] = jargs[4].astype(jnp.bfloat16), pargs[4].to(torch.bfloat16)
    if kind == "bf16-tc":
        jargs[10], pargs[10] = jargs[10].astype(jnp.bfloat16), pargs[10].to(torch.bfloat16)
    want = conv_block_pallas(*jargs, interpret=True)
    got = conv_block_plain(*pargs)
    compare(got, want)
    assert float(got[1][valid:].abs().sum()) == 0.0              # padded rows: c = 0


@pytest.mark.parametrize("tq,valid", CASES[:2])
def test_conv_ffn_ln_plain_matches_pallas_interpret(tq, valid):
    inp = make_inputs(100 + tq, tq, valid)
    jw, pw = weights(inp, ("pw1", "pw2", "w1", "w2"), "int8")
    tail = lambda conv, w1, w2: (conv(inp["fg"]), conv(inp["fb"]), w1, w2,  # noqa: E731
                                 conv(inp["og"]), conv(inp["ob"]))
    want = conv_ffn_ln_pallas(*conv_args(inp, jw[0], jw[1], jnp.asarray),
                              *tail(jnp.asarray, jw[2], jw[3]), interpret=True)
    got = conv_ffn_ln_plain(*conv_args(inp, pw[0], pw[1], t), *tail(t, pw[2], pw[3]))
    compare(got, want)


def test_conv_block_plain_matches_xla_conv_section():
    """The same function as the XLA conv module of _conformer_layer (LN,
    pw1, GLU, mask, depthwise conv over time cache ++ rows ++ zeros, BN,
    SiLU, pw2, residual)."""
    from trt_asr_tpu.ops.common import batch_norm_inference, glu, layer_norm, matmul, silu
    from trt_asr_tpu.ops.conv import depthwise_conv1d

    tq, valid = 8, 6
    inp = make_inputs(9, tq, valid)
    x = jnp.asarray(inp["x"])
    c = glu(matmul(layer_norm(x, inp["g"], inp["b"]), inp["pw1"]), axis=-1) * inp["mask"]
    ext = jnp.concatenate([inp["tc"], c, jnp.zeros(((KK - 1) // 2, D))], axis=0)
    cv = batch_norm_inference(depthwise_conv1d(ext[None], inp["dw"])[0], *inp["bn"])
    want = (x + matmul(silu(cv), inp["pw2"]), c)
    compare(conv_block_plain(*conv_args(inp, t(inp["pw1"]), t(inp["pw2"]), t)), want)


def test_conv_ffn_ln_takes_int8_weights_only():
    inp = make_inputs(2, 8, 6)
    args = (*conv_args(inp, t(inp["pw1"]), t(inp["pw2"]), t), t(inp["fg"]), t(inp["fb"]),
            t(inp["w1"]), t(inp["w2"]), t(inp["og"]), t(inp["ob"]))
    for fn in (conv_ffn_ln, conv_ffn_ln_plain):
        with pytest.raises(TypeError, match="int8"):
            fn(*args)


def test_wrappers_take_plain_version_on_cpu():
    inp = make_inputs(3, 8, 6)
    _, pw = weights(inp, ("pw1", "pw2", "w1", "w2"), "int8")
    args = conv_args(inp, pw[0], pw[1], t)
    tail = (t(inp["fg"]), t(inp["fb"]), pw[2], pw[3], t(inp["og"]), t(inp["ob"]))
    before = (conv_block.launches, conv_ffn_ln.launches)
    for g, w in zip(conv_block(*args), conv_block_plain(*args)):
        assert torch.equal(g, w)
    for g, w in zip(conv_ffn_ln(*args, *tail), conv_ffn_ln_plain(*args, *tail)):
        assert torch.equal(g, w)
    assert (conv_block.launches, conv_ffn_ln.launches) == before
