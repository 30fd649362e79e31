"""The port's SpecAugment (``trt_asr_tpu_torch/train/augment.py``): its
apply, fed the widths and starts that the JAX package's ``_band_mask``
draws with ``jax.random`` (redrawn here exactly as it draws them), equals
JAX's ``spec_augment`` bit for bit; its own draw (a ``torch.Generator``)
keeps the band bounds, the adaptive time width, the untouched padding and
the generator's determinism."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import one_torch_thread, t  # noqa: F401

from trt_asr_tpu.train.augment import spec_augment as j_spec_augment
from trt_asr_tpu_torch.train.augment import (SpecAugmentMasks, apply_masks, draw_masks,
                                             spec_augment)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def jax_draw(key, n_masks, max_width, valid_len):
    """``trt_asr_tpu/train/augment.py:_band_mask``'s widths and starts."""
    k_w, k_s = jax.random.split(key)
    b = valid_len.shape[0]
    w = jax.random.randint(k_w, (b, n_masks), 0, jnp.maximum(max_width, 0)[:, None] + 1)
    span = jnp.maximum(valid_len[:, None] - w, 1)
    s = (jax.random.uniform(k_s, (b, n_masks)) * span).astype(jnp.int32)
    return w, s


@functools.partial(jax.jit, static_argnames=("n_freq", "freq_masks", "freq_width",
                                             "time_masks", "time_width"))
def _jax_mask_draws(key, fl, n_freq, freq_masks, freq_width, time_masks, time_width):
    """The widths and starts ``spec_augment(key, ...)`` draws (one compile a
    case: the draws eagerly compile dozens of small programs)."""
    k_f, k_t = jax.random.split(key)
    b = fl.shape[0]
    fw, fs = jax_draw(k_f, freq_masks, jnp.full((b,), freq_width, jnp.int32),
                      jnp.full((b,), n_freq, jnp.int32))
    if time_width < 1.0:
        max_w = (fl.astype(jnp.float32) * time_width).astype(jnp.int32)
    else:
        max_w = jnp.full((b,), int(time_width), jnp.int32)
    tw, ts = jax_draw(k_t, time_masks, max_w, fl)
    return fw, fs, tw, ts


def jax_masks(seed, feat_len, n_freq, **kw):
    """The bands ``spec_augment(PRNGKey(seed), ...)`` masks."""
    draws = _jax_mask_draws(jnp.asarray(jax.random.PRNGKey(seed)),
                            jnp.asarray(feat_len, jnp.int32), n_freq, **kw)
    return SpecAugmentMasks(*(t(np.asarray(x)) for x in draws))


CASES = {
    "defaults": dict(freq_masks=2, freq_width=27, time_masks=10, time_width=0.05),
    "adaptive": dict(freq_masks=2, freq_width=8, time_masks=4, time_width=0.2),
    "fixed_width": dict(freq_masks=1, freq_width=5, time_masks=3, time_width=7.0),
    "time_only": dict(freq_masks=0, freq_width=1, time_masks=6, time_width=0.3),
    "mask_value": dict(freq_masks=3, freq_width=10, time_masks=2, time_width=0.1,
                       mask_value=-1.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 7])
def test_apply_equals_jax_bit_for_bit(name, seed):
    kw = dict(CASES[name])
    mask_value = kw.pop("mask_value", 0.0)
    rng = np.random.default_rng(seed)
    b, tt, f = 3, 200, 32
    feats = rng.standard_normal((b, tt, f)).astype(np.float32)
    feat_len = np.array([200, 140, 37], np.int32)
    want = np.asarray(j_spec_augment(jax.random.PRNGKey(seed), jnp.asarray(feats),
                                     jnp.asarray(feat_len), mask_value=mask_value, **kw))
    got = apply_masks(t(feats), t(feat_len), jax_masks(seed, feat_len, f, **kw),
                      mask_value=mask_value).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != feats).any()


def test_draw_bounds_padding_and_determinism():
    b, tt, f = 3, 300, 40
    feat_len = torch.tensor([300, 120, 25])
    kw = dict(freq_masks=3, freq_width=9, time_masks=8, time_width=0.1)
    m = draw_masks(torch.Generator().manual_seed(3), feat_len, f, **kw)
    max_w = (feat_len.float() * 0.1).to(torch.int64)
    assert m.freq_w.shape == (b, 3) and m.time_w.shape == (b, 8)
    assert int(m.freq_w.min()) >= 0 and int(m.freq_w.max()) <= 9
    assert bool((m.time_w <= max_w[:, None]).all()) and int(m.time_w.min()) >= 0
    assert bool((m.freq_s < torch.clamp_min(f - m.freq_w, 1)).all())
    assert bool((m.time_s < torch.clamp_min(feat_len[:, None] - m.time_w, 1)).all())
    assert int(m.time_s.min()) >= 0
    m2 = draw_masks(torch.Generator().manual_seed(3), feat_len, f, **kw)
    assert all(torch.equal(x, y) for x, y in zip(m, m2))
    m3 = draw_masks(torch.Generator().manual_seed(4), feat_len, f, **kw)
    assert not all(torch.equal(x, y) for x, y in zip(m, m3))

    feats = torch.ones((b, tt, f))
    out = spec_augment(torch.Generator().manual_seed(0), feats, feat_len, freq_masks=0,
                       freq_width=1, time_masks=3, time_width=0.1)
    masked_rows = (out == 0.0).all(dim=2)
    for i, n in enumerate(feat_len.tolist()):
        assert int(masked_rows[i].sum()) <= 3 * int(n * 0.1)
        assert not bool(masked_rows[i, n:].any())
    changed = out != feats
    assert bool(changed.any()) and bool((out[changed] == 0.0).all())
