"""The flash-attention kernel's plain version (``ops/kernels/flash_att.py``)
against the JAX package's Pallas kernel ``flash_bias_attention`` in
interpret mode, with mixed lengths and a zero-length row; the offline
branch of ``rel_pos_attention_kv`` against JAX with flash off and on; the
flash gate's warning and counters; which wrappers the offline branch calls.

Tolerance: f32 atol 2e-5 / rtol 1e-4 (JAX's own flash test); bf16 atol 2e-2
/ rtol 1e-2 (the rounding of p to bf16 flips with exp's last bit). Where T
is not a multiple of the TPU kernel's block, its padded kv columns (v = 0)
enter a fully masked row's average, so such a row is compared only where T
is block-aligned, and there only where its masked scores are all equal
(``masked_scores_are_equal``: every aligned case but T 64 at dh 128);
everywhere it must be finite. T = 150 spans two 128-key blocks of the
online softmax and T = 65 two of the CUDA kernel's 64-row query tiles; dh
20 is not a multiple of 16 (the CUDA kernel zero-fills it), dh 128 is the
full-width model's. Offline attention 1e-5."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import spy_calls, t

from trt_asr_tpu.ops import attention as jatt
from trt_asr_tpu.ops.pallas.flash_att_kernel import flash_bias_attention as j_flash
from trt_asr_tpu_torch.ops import attention as patt
from trt_asr_tpu_torch.ops.kernels.flash_att import (copy_bytes, copy_widths,
                                                     flash_bias_attention,
                                                     flash_bias_attention_plain)
from trt_asr_tpu_torch.ops.kernels.rel_shift import rel_pos_bias_shifted_plain

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2, 1e-2)}


def masked_scores_are_equal(q, k, dtype) -> bool:
    """Whether every masked score of a row, q . k + (-1e9), is -1e9 in f32:
    |q . k| < 32, half the f32 ulp at 1e9. Only then is a fully masked
    row's result the same under any rounding of the scaled scores: XLA's
    CPU backend does not round ``(s + bd) * scale - m`` where the program
    says (it gives p = 33.8 > 1 at dh 128), while the kernels round it."""
    qk = [t(x).to(dtype).double().numpy() for x in (q, k)]
    return bool(np.abs(np.einsum("thd,shd->hts", *qk)).max() < 32)


@pytest.mark.parametrize("kind", DTYPES)
@pytest.mark.parametrize("t_len,lens,aligned", [(37, [37, 29, 0], False),
                                                (64, [64, 50, 0], True),
                                                (65, [65, 33, 0], False),
                                                (150, [150, 97, 0], False)])
@pytest.mark.parametrize("dh", [20, 32, 128])
def test_plain_matches_jax_kernel(kind, t_len, lens, aligned, dh):
    jdt, tdt, atol, rtol = DTYPES[kind]
    b, h = len(lens), 2
    rng = np.random.default_rng(t_len)
    q, k, v = (rng.standard_normal((b, t_len, h, dh)).astype(np.float32) for _ in range(3))
    bd = rng.standard_normal((b, h, t_len, t_len)).astype(np.float32)
    mask = np.arange(t_len)[None, :] < np.array(lens)[:, None]
    got = flash_bias_attention_plain(*(t(x).to(tdt) for x in (q, k, v, bd)), t(mask))
    want = np.asarray(j_flash(*(jnp.asarray(x).astype(jdt) for x in (q, k, v, bd)),
                              jnp.asarray(mask), interpret=True))
    assert got.dtype == torch.float32 and got.shape == (b, t_len, h * dh)
    assert bool(torch.isfinite(got).all())
    # the one aligned case whose zero-length row has unequal masked scores
    unequal = (t_len, dh) == (64, 128)
    for i, n in enumerate(lens):
        if aligned and n == 0:
            assert masked_scores_are_equal(q[i], k[i], tdt) != unequal
        if aligned and (n or not unequal):
            n = t_len
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], atol=atol, rtol=rtol)


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q = t(rng.standard_normal((2, 9, 2, 8)).astype(np.float32))
    bd = t(rng.standard_normal((2, 2, 9, 9)).astype(np.float32))
    mask = torch.tensor([[True] * 9, [True] * 4 + [False] * 5])
    before = flash_bias_attention.launches
    got = flash_bias_attention(q, q, q, bd, mask)
    assert flash_bias_attention.launches == before
    assert torch.equal(got, flash_bias_attention_plain(q, q, q, bd, mask))


def bf16_at(numel: int, offset: int = 0) -> torch.Tensor:
    """A bf16 buffer of ``numel`` values starting ``offset`` values past a
    16-byte boundary."""
    buf = torch.zeros(numel + offset + 8, dtype=torch.bfloat16)
    skip = (-buf.data_ptr() % 16) // 2
    return buf[skip + offset:skip + offset + numel]


def shifted_bd(b, t_len, h):
    """The plain shift's view of a bf16 bias (row stride 2T - 1)."""
    return rel_pos_bias_shifted_plain(torch.zeros(b, t_len, h, 8, dtype=torch.bfloat16),
                                      torch.zeros(2 * t_len - 1, h, 8), tkv=t_len)


# name -> (q/k/v [B, T, H, dh], bd [B, H, T, T], expected copy widths in bytes)
COPY_CASES = {
    "offline batch": (lambda: bf16_at(2 * 368 * 8 * 128).view(2, 368, 8, 128),
                      lambda: bf16_at(2 * 8 * 368 * 368).view(2, 8, 368, 368), (16, 16)),
    "shifted view": (lambda: bf16_at(2 * 37 * 2 * 64).view(2, 37, 2, 64),
                     lambda: shifted_bd(2, 37, 2), (16, 2)),
    "rows of 68 keys": (lambda: bf16_at(2 * 68 * 2 * 32).view(2, 68, 2, 32),
                        lambda: bf16_at(2 * 2 * 68 * 68).view(2, 2, 68, 68), (16, 8)),
    "rows of 66 keys, dh 20": (lambda: bf16_at(2 * 66 * 1 * 20).view(2, 66, 1, 20),
                               lambda: bf16_at(2 * 66 * 66).view(2, 1, 66, 66), (8, 4)),
    "rows of 65 keys": (lambda: bf16_at(2 * 65 * 2 * 32).view(2, 65, 2, 32),
                        lambda: bf16_at(2 * 2 * 65 * 65).view(2, 2, 65, 65), (16, 2)),
    "q 8 bytes off": (lambda: bf16_at(64 * 2 * 32, offset=4).view(1, 64, 2, 32),
                      lambda: bf16_at(2 * 64 * 64).view(1, 2, 64, 64), (8, 16)),
    "bd 2 bytes off": (lambda: bf16_at(64 * 2 * 32).view(1, 64, 2, 32),
                       lambda: bf16_at(2 * 64 * 64, offset=1).view(1, 2, 64, 64), (16, 2)),
    "odd plane stride": (lambda: bf16_at(64 * 2 * 32).view(1, 64, 2, 32),
                         lambda: bf16_at(2 * 4097).as_strided((1, 2, 64, 64), (8194, 4097, 64, 1)),
                         (16, 2)),
    "one plane": (lambda: bf16_at(64 * 32).view(1, 64, 1, 32),
                  lambda: bf16_at(4097).as_strided((1, 1, 64, 64), (4097, 4097, 64, 1)),
                  (16, 16)),
    "padded rows": (lambda: bf16_at(64 * 2 * 32).view(1, 64, 2, 32),
                    lambda: bf16_at(2 * 64 * 72).view(1, 2, 64, 72)[..., :64], (16, 16)),
}


@pytest.mark.parametrize("case", COPY_CASES)
def test_copy_widths_follow_row_alignment(case):
    """The bf16 kernel's copy widths (its template parameters) on CPU views:
    the widest of 16, 8, 4, 2 bytes that divides the rows' base addresses
    and strides."""
    make_q, make_bd, want = COPY_CASES[case]
    q, bd = make_q(), make_bd()
    assert copy_widths(q, q, q, bd) == want
    v_off = bf16_at(q.numel(), offset=4).view(q.shape)     # 8 bytes off: v counts as q does
    assert copy_widths(q, q, v_off, bd) == (8, want[1])


def test_copy_bytes():
    assert copy_bytes(0, ()) == 16
    assert [copy_bytes(a, ()) for a in (8, 4, 2, 1, 48)] == [8, 4, 2, 1, 16]
    assert copy_bytes(32, (130,)) == 2 and copy_bytes(32, (132, 64)) == 4


def attention_inputs(b=2, tq=19, tkv=19, h=2, dh=16, lens=(19, 11), seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)  # noqa: E731
    mask = np.arange(tkv)[None, :] < np.array(lens)[:, None]
    return (r(b, tq, h, dh), r(b, tkv, h, dh), r(b, tkv, h, dh), r(tq + tkv - 1, h, dh),
            r(h, dh, sc=0.3), r(h, dh, sc=0.3), r(h * dh, h * dh, sc=(h * dh) ** -0.5), mask)


@pytest.mark.parametrize("flash", [False, True])
def test_offline_attention_matches_jax(flash):
    """rel_idx=None: the static shift (and the flash kernel) on both sides."""
    args = attention_inputs()
    lens = (19, 11)
    want = np.asarray(jatt.rel_pos_attention_kv(*(jnp.asarray(a) for a in args[:7]),
                                                kv_mask=jnp.asarray(args[7]), use_flash=flash))
    got = patt.rel_pos_attention_kv(*(t(a) for a in args[:7]), kv_mask=t(args[7]),
                                    use_flash=flash)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n].numpy(), want[i, :n], atol=1e-5, rtol=1e-5)


def test_flash_gate_warns_and_counts():
    """tq != tkv: the flash kernel is not taken; a warning and the
    requested/taken counters say so, as in the JAX package."""
    q, k, v, pos, bu, bv, wo, _ = attention_inputs(b=1, tq=4, tkv=6, lens=(6,))
    before = dict(patt.flash_trace_counts)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = patt.rel_pos_attention_kv(*(t(a) for a in (q, k, v, pos, bu, bv, wo)),
                                        use_flash=True)
    assert out.shape == (1, 4, 32)
    assert patt.flash_trace_counts == {"requested": before["requested"] + 1,
                                       "taken": before["taken"]}
    assert any("use_flash requested but unavailable (tq=4 != tkv=6)" in str(w.message)
               for w in rec)
    patt.rel_pos_attention_kv(*(t(a) for a in (q, q, q, pos[:7], bu, bv, wo)), use_flash=True)
    assert patt.flash_trace_counts == {"requested": before["requested"] + 2,
                                       "taken": before["taken"] + 1}


def test_offline_branch_routing(monkeypatch):
    """On CPU bf16 the auto gate keeps the plain shift even at Tq >= 128 (the
    kernel's gate needs a CUDA tensor); use_shift_kernel=True calls the
    wrapper; use_flash calls the flash wrapper once."""
    calls = spy_calls(monkeypatch, patt, ("rel_pos_bias_shifted", "flash_bias_attention"))
    args = attention_inputs(b=1, tq=130, tkv=130, lens=(130,))
    bf = [t(a).to(torch.bfloat16) for a in args[:7]]
    patt.rel_pos_attention_kv(*bf)
    assert calls == {"rel_pos_bias_shifted": 0, "flash_bias_attention": 0}
    patt.rel_pos_attention_kv(*bf, use_shift_kernel=True, use_flash=True)
    assert calls == {"rel_pos_bias_shifted": 1, "flash_bias_attention": 1}
