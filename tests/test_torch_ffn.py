"""Fused FFN of the PyTorch port (``ops/kernels/ffn.py``) against the JAX
package: its plain version against ``fused_ffn_pallas`` in interpret mode
and against the XLA FFN of ``_conformer_layer``, with f32 and int8 weights
(the same ``QuantTensor`` values on both sides) and with the bf16 weights of
``cast_params_for_compute`` (the LayerNorm's parameters stay f32), on [T, D]
and [B, T, D] inputs. The CUDA kernel is held against the plain version in
``test_torch_kernels_cuda.py``.

Tolerances: 1e-5 absolute and relative in f32 (summation order; the TPU
kernel also sums the expansion axis in grid blocks). int8 1e-5: both sides
round the same operands (LN output, silu(h)) to bf16 and multiply exact
integers, so they differ only where an f32 value one bit apart rounds to a
neighbouring bf16 value; none does at these seeds (observed gap 1.2e-7).
bf16 weights: the same rounding points, the same 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

from trt_asr_tpu.ops.common import layer_norm, matmul, silu
from trt_asr_tpu.ops.pallas.ffn_kernel import fused_ffn_pallas
from trt_asr_tpu.ops.quant import quantize_tensor as j_quantize
from trt_asr_tpu_torch.ops.kernels.ffn import fused_ffn, fused_ffn_plain
from trt_asr_tpu_torch.ops.quant import QuantTensor

D, E = 64, 128              # ModelConfig.tiny(): d_model 64, expansion 2
TOL = 1e-5


def make_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(x=r(*shape, D, sc=1.0), g=1.0 + r(D, sc=0.2), b=r(D, sc=0.1),
                w1=r(D, E, sc=D ** -0.5), w2=r(E, D, sc=E ** -0.5))


def weights(inp, kind):
    """(JAX weights, port weights): f32 arrays, or one quantization shared."""
    if kind == "f32":
        return [jnp.asarray(inp["w1"]), jnp.asarray(inp["w2"])], [t(inp["w1"]), t(inp["w2"])]
    if kind == "bf16":
        return ([jnp.asarray(inp[k]).astype(jnp.bfloat16) for k in ("w1", "w2")],
                [t(inp[k]).to(torch.bfloat16) for k in ("w1", "w2")])
    jw = [j_quantize(jnp.asarray(inp[k])) for k in ("w1", "w2")]
    return jw, [QuantTensor(t(np.asarray(q.q)), t(np.asarray(q.s))) for q in jw]


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("shape", [(8,), (6,), (1, 8), (2, 3)])
def test_plain_matches_pallas_interpret(kind, shape):
    inp = make_inputs(len(shape) * 10 + shape[-1], shape)
    jw, pw = weights(inp, kind)
    want = fused_ffn_pallas(jnp.asarray(inp["x"]), inp["g"], inp["b"], *jw, scale=0.5,
                            interpret=True)
    got = fused_ffn_plain(t(inp["x"]), t(inp["g"]), t(inp["b"]), *pw, 0.5)
    assert got.shape == inp["x"].shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_plain_matches_xla_ffn(kind):
    """The same function as the XLA FFN of encoder._conformer_layer (with
    int8 weights: q8_matmul's bf16 activation rounding)."""
    inp = make_inputs(3, (1, 6))
    jw, pw = weights(inp, kind)
    x = jnp.asarray(inp["x"])
    want = x + 0.5 * matmul(silu(matmul(layer_norm(x, inp["g"], inp["b"]), jw[0])), jw[1])
    got = fused_ffn_plain(t(inp["x"]), t(inp["g"]), t(inp["b"]), *pw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_int8_rounding_points_are_visible():
    """The int8 tolerance tells the plain version from one without the bf16
    rounding points (the same product on the dequantized f32 weights)."""
    inp = make_inputs(5, (8,))
    _, pw = weights(inp, "int8")
    deq = [q.q.float() * q.s for q in pw]
    args = (t(inp["x"]), t(inp["g"]), t(inp["b"]))
    gap = (fused_ffn_plain(*args, *pw) - fused_ffn_plain(*args, *deq)).abs().max()
    assert float(gap) > 10 * TOL


def test_wrapper_takes_plain_version_on_cpu():
    inp = make_inputs(4, (1, 8))
    args = (t(inp["x"]), t(inp["g"]), t(inp["b"]), t(inp["w1"]), t(inp["w2"]))
    before = fused_ffn.launches
    assert torch.equal(fused_ffn(*args), fused_ffn_plain(*args))
    assert fused_ffn.launches == before           # no kernel launch on the CPU
