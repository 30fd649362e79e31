"""The rel-shift kernel's plain version (``ops/kernels/rel_shift.py``) against
the JAX package: its Pallas kernel ``rel_pos_bias_shifted`` in interpret
mode and the XLA path it replaces (einsum, then pad + reshape + slice,
``trt_asr_tpu/ops/attention.py:125-129``), in f32 and bf16; the shift view
against an explicit index; the wrapper on CPU tensors.

Tolerance: f32 1e-6 of the largest output magnitude (the same products
summed in another order: a few f32 ulps of values up to ~40); bf16 one bf16
ulp (an f32 sum in another order, rounded once)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_within_bf16_ulp, t

from trt_asr_tpu.ops.common import einsum as j_einsum
from trt_asr_tpu.ops.pallas.rel_shift_kernel import rel_pos_bias_shifted as j_shifted
from trt_asr_tpu_torch.ops.kernels.rel_shift import (rel_pos_bias_shifted,
                                                     rel_pos_bias_shifted_plain, rel_shift)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def xla_skew(q_v, pos):
    """The JAX package's offline XLA bias: einsum, then the static shift."""
    b, tq, h, _ = q_v.shape
    pd = j_einsum("bthd,rhd->bhtr", q_v, pos.astype(q_v.dtype))
    r = pd.shape[-1]
    padded = jnp.pad(pd, ((0, 0), (0, 0), (0, 0), (1, 0)))
    return padded.reshape(b, h, tq * (r + 1))[..., tq:].reshape(b, h, tq, r)[..., :tq]


def assert_matches(got: torch.Tensor, want, kind: str) -> None:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape
    if kind == "f32":
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale)
    else:
        assert_within_bf16_ulp(got, want)


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("shape", [(1, 57, 2, 32), (2, 130, 2, 64)])
def test_plain_matches_jax_kernel_and_xla_skew(shape, kind):
    jdt, tdt = DTYPES[kind]
    b, tq, h, dh = shape
    rng = np.random.default_rng(tq)
    q_v = rng.standard_normal((b, tq, h, dh)).astype(np.float32)
    pos = rng.standard_normal((2 * tq - 1, h, dh)).astype(np.float32)
    got = rel_pos_bias_shifted_plain(t(q_v).to(tdt), t(pos), tkv=tq)
    assert got.dtype == tdt
    jq = jnp.asarray(q_v).astype(jdt)
    assert_matches(got.float(), j_shifted(jq, jnp.asarray(pos).astype(jdt), tkv=tq,
                                          interpret=True), kind)
    assert_matches(got.float(), xla_skew(jq, jnp.asarray(pos)), kind)


@pytest.mark.parametrize("tq,tkv", [(5, 5), (4, 9), (9, 4)])
def test_shift_is_the_static_index(tq, tkv):
    """bd[..., t, s] = pd[..., t, Tq - 1 - t + s], for Tq != Tkv too."""
    pd = torch.arange(2 * 3 * tq * (tq + tkv - 1), dtype=torch.float32).reshape(
        2, 3, tq, tq + tkv - 1)
    ti = torch.arange(tq)[:, None]
    si = torch.arange(tkv)[None, :]
    want = pd[..., ti, tq - 1 - ti + si]
    assert torch.equal(rel_shift(pd, tkv), want)


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    q_v = t(rng.standard_normal((1, 12, 2, 8)).astype(np.float32))
    pos = t(rng.standard_normal((30, 2, 8)).astype(np.float32))   # longer than 2*12-1
    before = rel_pos_bias_shifted.launches
    got = rel_pos_bias_shifted(q_v, pos, tkv=12)
    assert rel_pos_bias_shifted.launches == before
    assert torch.equal(got, rel_pos_bias_shifted_plain(q_v, pos, tkv=12))
