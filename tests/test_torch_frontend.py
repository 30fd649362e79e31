"""Log-mel frontend of the PyTorch port against the JAX package:
``LogMelFrontend`` and ``StreamingLogMel`` on the same audio, the per-feature
normalization, and the fused log-mel's plain version against the Pallas
``logmel_from_frames_pallas`` (TPU interpret mode). The CUDA kernel is held
against the plain version in ``test_torch_kernels_cuda.py``.

Tolerance: 2e-5 absolute plus 5e-5 relative on log-mel values (float32
matmul summation order; log-mel values reach ~10)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import t

from trt_asr_tpu.contract import FrontendSpec as JSpec
from trt_asr_tpu.frontend.logmel import LogMelFrontend as JFrontend
from trt_asr_tpu.frontend.logmel import StreamingLogMel as JStreaming
from trt_asr_tpu.frontend.normalize import apply_per_feature_norm as j_apply
from trt_asr_tpu.frontend.normalize import compute_per_feature_stats as j_stats
from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend, StreamingLogMel
from trt_asr_tpu_torch.frontend.normalize import (apply_per_feature_norm,
                                                  compute_per_feature_stats)
from trt_asr_tpu_torch.ops.kernels.mel import logmel, logmel_plain

ATOL, RTOL = 2e-5, 5e-5


def audio(n, seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(n)
    return (0.4 * np.sin(2 * np.pi * 440 * tt / 16000)
            + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("n_mels,shape", [(128, (16000,)), (32, (2, 6000)), (80, (300,))])
def test_logmel_frontend_matches_jax(n_mels, shape):
    a = audio(int(np.prod(shape))).reshape(shape)
    got = LogMelFrontend(FrontendSpec(n_mels=n_mels), device="cpu")(a).numpy()
    want = np.asarray(JFrontend(JSpec(n_mels=n_mels))(a))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("draw", [0, 13])
def test_logmel_low_energy_bins_match_jax(draw):
    """The audio of ``test_native_logmel_parity``, taken as the ``draw``-th
    of its kind from ``default_rng(0)``, as the session's shared ``rng``
    hands it out after earlier draws. At draw 13 float32 CPU sums put the
    log-mel of a low-energy bin 7.4e-4 from JAX's."""
    rng = np.random.default_rng(0)
    rng.standard_normal(20000 * draw)
    a = (0.3 * np.sin(np.arange(20000) * 0.13)
         + 0.05 * rng.standard_normal(20000)).astype(np.float32)
    got = LogMelFrontend(device="cpu")(a).numpy()
    want = np.asarray(JFrontend()(a))
    assert got.shape == want.shape == (123, 128)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("piece", [160, 4800, 8000])
def test_streaming_logmel_matches_jax(piece):
    a = audio(24000, seed=1)
    ours = StreamingLogMel(LogMelFrontend(FrontendSpec(n_mels=32), device="cpu"))
    ref = JStreaming(JFrontend(JSpec(n_mels=32)))
    got = [ours.push(a[i:i + piece]) for i in range(0, len(a), piece)]
    want = [ref.push(a[i:i + piece]) for i in range(0, len(a), piece)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(ours._carry, ref._carry)


def test_per_feature_norm_matches_jax():
    f = np.random.default_rng(2).standard_normal((37, 32)).astype(np.float32)
    mean, std = compute_per_feature_stats(t(f))
    jm, js = j_stats(f)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(apply_per_feature_norm(t(f), mean, std).numpy(),
                               np.asarray(j_apply(f, jm, js)), atol=1e-5)


def test_mel_plain_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    from trt_asr_tpu.ops.pallas.mel_kernel import logmel_from_frames_pallas

    fe = LogMelFrontend(FrontendSpec(n_mels=128), device="cpu")
    frames = (np.random.default_rng(3).standard_normal((50, 400)) * 0.3).astype(np.float32)
    got = logmel_plain(t(frames), fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(logmel_from_frames_pallas(
            frames, fe._wcos.numpy(), fe._wsin.numpy(), fe._mel.numpy(), fe.spec.log_floor))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_kernel_flag_takes_plain_version_on_cpu():
    a = audio(8000, seed=4)
    before = logmel.launches
    on = LogMelFrontend(FrontendSpec(n_mels=32), use_kernel=True, device="cpu")(a)
    off = LogMelFrontend(FrontendSpec(n_mels=32), device="cpu")(a)
    torch.testing.assert_close(on, off, atol=0, rtol=0)
    assert logmel.launches == before
