"""Fused joint step of the PyTorch port (``ops/kernels/joint_step.py``)
against the JAX package: the plain version against ``joint_step_pallas`` in
interpret mode with f32 and int8 weights and with the bf16 weights and
biases of ``cast_params_for_compute``, with and without a blank penalty,
and on a constructed tie. The CUDA kernel is held against the plain version
in ``test_torch_kernels_cuda.py``.

Tolerance: logits 1e-5 absolute (f32 summation order); tokens and
durations exact (the inputs are drawn with clear top-2 margins, and the tie
case must pick the first maximal index on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t

from trt_asr_tpu.ops.pallas.joint_step_kernel import joint_step_pallas
from trt_asr_tpu.ops.quant import quantize_tensor as j_quantize
from trt_asr_tpu_torch.ops.kernels.joint_step import joint_step, joint_step_plain
from trt_asr_tpu_torch.ops.quant import QuantTensor

ROWS, P, J, VOCAB, NDUR = 8, 32, 48, 64, 5
THS = VOCAB + 1
V = THS + NDUR
BLANK = VOCAB


def make_inputs(seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    return dict(e=r(ROWS, J), g=r(ROWS, P, sc=0.5), wp=r(P, J, sc=0.3), bp=r(J, sc=0.1),
                wo=r(J, V, sc=0.3), bo=r(V, sc=0.1))


def run_both(inp, quant, penalty):
    """``quant``: int8 weights (True), f32 (False), or ``"bf16"``: bf16
    weights and biases."""
    kw = dict(ths=THS, ndur=NDUR, blank_id=BLANK, blank_penalty=penalty)
    if quant == "bf16":
        bf = lambda k: jnp.asarray(inp[k]).astype(jnp.bfloat16)  # noqa: E731
        want = joint_step_pallas(jnp.asarray(inp["e"]), jnp.asarray(inp["g"]), bf("wp"),
                                 bf("bp"), bf("wo"), bf("bo"), interpret=True, **kw)
        pb = lambda k: t(inp[k]).to(torch.bfloat16)  # noqa: E731
        got = joint_step_plain(t(inp["e"]), t(inp["g"]), pb("wp"), pb("bp"), pb("wo"),
                               pb("bo"), **kw)
        return got, want
    if quant:
        jwp, jwo = j_quantize(jnp.asarray(inp["wp"])), j_quantize(jnp.asarray(inp["wo"]))
        pwp = QuantTensor(t(np.array(jwp.q)), t(np.array(jwp.s)))
        pwo = QuantTensor(t(np.array(jwo.q)), t(np.array(jwo.s)))
    else:
        jwp, jwo = jnp.asarray(inp["wp"]), jnp.asarray(inp["wo"])
        pwp, pwo = t(inp["wp"]), t(inp["wo"])
    want = joint_step_pallas(jnp.asarray(inp["e"]), jnp.asarray(inp["g"]), jwp,
                             jnp.asarray(inp["bp"]), jwo, jnp.asarray(inp["bo"]),
                             interpret=True, **kw)
    got = joint_step_plain(t(inp["e"]), t(inp["g"]), pwp, t(inp["bp"]), pwo, t(inp["bo"]), **kw)
    return got, want


@pytest.mark.parametrize("quant", [False, True, "bf16"])
@pytest.mark.parametrize("penalty", [0.0, 1.5])
def test_plain_matches_pallas_interpret(quant, penalty):
    (tok, dur, logits), (jtok, jdur, jlogits) = run_both(make_inputs({False: 1, True: 2, "bf16": 5}[quant]), quant,
                                                        penalty)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))
    assert tok.dtype == torch.int32 and dur.dtype == torch.int32


def test_blank_penalty_only_moves_the_token_head():
    inp = make_inputs(3)
    (tok0, dur0, lg0), _ = run_both(inp, False, 0.0)
    (tok1, dur1, lg1), (jtok1, _, _) = run_both(inp, False, 1e6)
    assert torch.equal(lg0, lg1)                   # logits are returned pre-penalty
    assert torch.equal(dur0, dur1)
    assert not (tok1 == BLANK).any()
    np.testing.assert_array_equal(tok1.numpy(), np.asarray(jtok1))


def test_tie_picks_first_index():
    """Two token columns and two duration columns with identical weights
    and biases tie exactly; both sides must return the smaller index."""
    inp = make_inputs(4)
    wo, bo = inp["wo"], inp["bo"]
    wo[:, 9] = wo[:, 5]
    bo[5] = bo[9] = 50.0                           # the tied pair dominates
    wo[:, THS + 3] = wo[:, THS + 1]
    bo[THS + 1] = bo[THS + 3] = 50.0
    (tok, dur, _), (jtok, jdur, _) = run_both(inp, False, 0.0)
    assert (tok == 5).all() and (dur == 1).all()
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(jdur))


def test_wrapper_takes_plain_version_on_cpu():
    inp = make_inputs(5)
    args = [t(inp[k]) for k in ("e", "g", "wp", "bp", "wo", "bo")]
    kw = dict(ths=THS, ndur=NDUR, blank_id=BLANK, blank_penalty=0.5)
    before = joint_step.launches
    for a, b in zip(joint_step(*args, **kw), joint_step_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert joint_step.launches == before
