"""The port's TDT loss (``trt_asr_tpu_torch/train/tdt_loss.py``) against the
JAX package's and against brute-force path enumeration on tiny lattices.

Tolerances: values rtol 1e-5 (atol 1e-5 against the brute force, as
tests/test_tdt_loss.py holds JAX); the gradient with respect to the logits
atol 1e-5 against ``jax.grad``. JAX's values and gradients are computed in
a subprocess (see ``start_jax_subprocess``)."""

import numpy as np
import pytest
import torch

from test_tdt_loss import brute_force_nll
from torch_port_helpers import one_torch_thread, start_jax_subprocess, t  # noqa: F401

from trt_asr_tpu_torch.train.tdt_loss import tdt_loss

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DURS, THS, BLANK = (0, 1, 2, 3, 4), 8, 7
# (durations, t_len per row, u_len per row, T, U): padded rows, an empty
# label row, a row at t_len 1, no duration 0, long overshoots
CASES = {
    "batched": (DURS, [6, 4, 5, 1], [4, 2, 0, 1], 6, 4),
    "no_d0": ((1, 2), [5, 2], [2, 2], 5, 2),
    "wide_d": ((0, 2, 5), [7, 6], [3, 1], 8, 3),
}


def case_arrays(name):
    durs, tl, ul, t_max, u_max = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + t_max)
    b = len(tl)
    logits = rng.standard_normal((b, t_max, u_max + 1, THS + len(durs))).astype(np.float32)
    labels = rng.integers(0, BLANK, size=(b, u_max)).astype(np.int32)
    return durs, logits, labels, np.asarray(tl, np.int32), np.asarray(ul, np.int32)


def port_loss(durs, logits, labels, tl, ul):
    return tdt_loss(logits, t(labels), t(tl), t(ul), duration_values=durs,
                    token_head_size=THS, blank_id=BLANK)


@pytest.mark.parametrize("t_len,u_len,durs", [
    (3, 2, (0, 1, 2)),
    (4, 0, (0, 1, 2)),
    (5, 3, (0, 1, 2, 3, 4)),
    (2, 2, (1, 2)),        # no duration 0
])
def test_tdt_loss_matches_brute_force(t_len, u_len, durs):
    """tests/test_tdt_loss.py's brute-force cases on the port."""
    rng = np.random.default_rng(t_len * 10 + u_len)
    ths, blank = 6, 5
    t_max, u_max = t_len + 1, max(u_len, 1)
    logits = rng.standard_normal((1, t_max, u_max + 1, ths + len(durs))).astype(np.float32)
    labels = rng.integers(0, blank, size=(1, u_max)).astype(np.int32)
    got = float(tdt_loss(t(logits), t(labels), torch.tensor([t_len]), torch.tensor([u_len]),
                         duration_values=durs, token_head_size=ths, blank_id=blank)[0])
    want = brute_force_nll(logits[0], labels[0], t_len, u_len, durs, ths, blank)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def jax_results_run(tmp_path_factory):
    """JAX's loss per row and ``jax.grad`` of the summed loss with respect
    to the logits, each case, in a subprocess started with the module."""
    out = str(tmp_path_factory.mktemp("tdt") / "jax.npz")
    code = f"""
import jax.numpy as jnp, numpy as np
from trt_asr_tpu.train import tdt_loss
cases = {CASES!r}
res = {{}}
def case_arrays(name):
    durs, tl, ul, t_max, u_max = cases[name]
    rng = np.random.default_rng(len(name) * 7 + t_max)
    b = len(tl)
    logits = rng.standard_normal((b, t_max, u_max + 1, {THS} + len(durs))).astype(np.float32)
    labels = rng.integers(0, {BLANK}, size=(b, u_max)).astype(np.int32)
    return durs, logits, labels, np.asarray(tl, np.int32), np.asarray(ul, np.int32)
for name in cases:
    durs, logits, labels, tl, ul = case_arrays(name)
    def f(lg):
        nll = tdt_loss(lg, labels, tl, ul, duration_values=durs, token_head_size={THS},
                       blank_id={BLANK})
        return jnp.sum(nll), nll
    (_, nll), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(logits))
    res[name + "_nll"], res[name + "_grad"] = np.asarray(nll), np.asarray(g)
np.savez(OUT, **res)
"""
    result = start_jax_subprocess(code, out)
    yield result
    result.kill()


@pytest.fixture(scope="module")
def jax_results(jax_results_run):
    return jax_results_run()


@pytest.mark.parametrize("name", sorted(CASES))
def test_tdt_loss_matches_jax(name, jax_results):
    durs, logits, labels, tl, ul = case_arrays(name)
    got = port_loss(durs, t(logits), labels, tl, ul).numpy()
    want = jax_results[name + "_nll"]
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a batch equals its rows alone
    for i in range(len(tl)):
        solo = port_loss(durs, t(logits[i:i + 1]), labels[i:i + 1], tl[i:i + 1], ul[i:i + 1])
        np.testing.assert_allclose(float(solo[0]), got[i], rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tdt_loss_grad_matches_jax(name, jax_results):
    durs, logits, labels, tl, ul = case_arrays(name)
    lg = t(logits).requires_grad_(True)
    port_loss(durs, lg, labels, tl, ul).sum().backward()
    g = lg.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, jax_results[name + "_grad"], rtol=0, atol=1e-5)
    # frames at or past t_len get no gradient
    for i, n in enumerate(tl):
        assert np.abs(g[i, n:]).max(initial=0.0) < 1e-6
