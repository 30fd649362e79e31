"""Launch plan, packed bases and work split of the log-mel kernel of the
PyTorch port (``ops/kernels/mel.py``; ``csrc/mel.cu`` checks the same
shared-memory layout at launch): clusters of 16 blocks, one a tile of 8
frames, its blocks a sixteenth of the DFT bins each, every (frame, DFT bin)
in exactly one block. A plain-torch replay of the kernel's split (each
bin's DFT sum cut into runs of the window added in order; the power; each
block's partial mel sums over its bins; the 16 blocks' partials added in
order; the log) is held to ``logmel_plain`` and to the JAX package's
``logmel_from_frames_pallas`` in interpret mode at the streaming push's
T = 50, at T = 1 and 51 (a tile cut short) and at a flush-sized T.

Tolerance: 2e-5 absolute + 5e-5 relative on the log-mel values, as
``test_torch_frontend.py`` holds the plain version to the Pallas kernel
(f32 sums in another order). The kernel itself is held against its plain
version on the card (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import t

from trt_asr_tpu.ops.pallas.mel_kernel import logmel_from_frames_pallas
from trt_asr_tpu_torch.contract import FrontendSpec
from trt_asr_tpu_torch.frontend.logmel import LogMelFrontend
from trt_asr_tpu_torch.ops.kernels.conv_block import SMEM_PER_BLOCK
from trt_asr_tpu_torch.ops.kernels.mel import (MAX_FRAME_TILES, MEL_CL, MEL_FT, MEL_KS,
                                               logmel, logmel_plain, logmel_plan, mel_pitch,
                                               pack_logmel_basis)

ATOL, RTOL = 2e-5, 5e-5
H100_SMS = 132


@pytest.mark.parametrize("frames", [1, 50, 51, 300])
def test_plan_covers_every_frame_and_bin_once(frames):
    win, nb, nm = 400, 257, 128
    plan = logmel_plan(frames, win, nb, nm)
    assert plan.smem <= SMEM_PER_BLOCK and plan.bins == 17 and plan.pitch == 20
    seen = np.zeros((frames, nb), dtype=np.int64)
    for ft in range(plan.frame_tiles):
        rows = list(range(ft * MEL_FT, min(frames, (ft + 1) * MEL_FT)))
        assert rows                                   # no cluster without frames
        for b in range(MEL_CL):
            bins = list(range(b * plan.bins, min(nb, (b + 1) * plan.bins)))
            assert bins                                   # no block without bins at 257
            seen[np.ix_(rows, bins)] += 1
    assert (seen == 1).all()
    # each block's sixteenth of the mel bands: every band reduced once
    cm = -(-nm // MEL_CL)
    assert sorted(m for b in range(MEL_CL) for m in range(b * cm, min(nm, (b + 1) * cm))) == \
        list(range(nm))
    if frames == 50:                                  # a 0.5 s push: most of the card's SMs
        assert plan.frame_tiles * MEL_CL == 112 <= H100_SMS


@pytest.mark.parametrize("frames,win,nb,nm,match", [
    (50, 398, 257, 128, "multiples of 4"),
    (50, 400, 257, 126, "multiples of 4"),
    (0, 400, 257, 128, "T >= 1"),
    (8 * MAX_FRAME_TILES + 1, 400, 257, 128, "frame tiles"),
    (50, 400, 273, 128, "exceed"),
    (50, 4000, 257, 128, "exceeds"),
])
def test_plan_raises_on_shapes_the_kernel_does_not_take(frames, win, nb, nm, match):
    with pytest.raises(ValueError, match=match):
        logmel_plan(frames, win, nb, nm)


@pytest.mark.parametrize("nb", [257, 201, 16])
def test_packed_bases_read_back(nb):
    rng = np.random.default_rng(nb)
    wcos, wsin = (torch.as_tensor(rng.standard_normal((400, nb)).astype(np.float32))
                  for _ in range(2))
    packed = pack_logmel_basis(wcos, wsin)
    bins = -(-nb // MEL_CL)
    assert packed.shape == (MEL_CL, 2, 400, mel_pitch(bins)) and packed.is_contiguous()
    cut = packed[..., :bins].permute(1, 2, 0, 3).reshape(2, 400, MEL_CL * bins)
    assert torch.equal(cut[0, :, :nb], wcos) and torch.equal(cut[1, :, :nb], wsin)
    assert not cut[:, :, nb:].any() and not packed[..., bins:].any()


def replay(frames, wcos, wsin, mel, log_floor):
    """The kernel's work split in plain torch."""
    n_t, win = frames.shape
    nb, nm = mel.shape
    plan = logmel_plan(n_t, win, nb, nm)
    w4 = win // 4
    per = -(-w4 // MEL_KS)
    acc = torch.zeros(n_t, nm)
    for b in range(MEL_CL):
        k0, k1 = min(nb, b * plan.bins), min(nb, (b + 1) * plan.bins)
        re, im = torch.zeros(n_t, k1 - k0), torch.zeros(n_t, k1 - k0)
        for s in range(MEL_KS):                       # runs of the window, added in order
            n0, n1 = 4 * min(w4, s * per), 4 * min(w4, s * per + per)
            re = re + frames[:, n0:n1] @ wcos[n0:n1, k0:k1]
            im = im + frames[:, n0:n1] @ wsin[n0:n1, k0:k1]
        acc = acc + (re * re + im * im) @ mel[k0:k1]  # the blocks' partials, in order
    return torch.log(acc + log_floor)


def frontend_inputs(frames, seed):
    fe = LogMelFrontend(FrontendSpec(n_mels=128), device="cpu")
    x = (np.random.default_rng(seed).standard_normal((frames, 400)) * 0.3).astype(np.float32)
    return x, (fe._wcos, fe._wsin, fe._mel, fe.spec.log_floor)


@pytest.mark.parametrize("frames", [1, 50, 51, 300])
def test_replay_of_the_kernels_split_matches_plain(frames):
    x, consts = frontend_inputs(frames, seed=frames)
    got = replay(t(x), *consts)
    torch.testing.assert_close(got, logmel_plain(t(x), *consts), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("frames", [1, 50, 51])
def test_replay_of_the_kernels_split_matches_pallas_interpret(frames):
    from jax.experimental.pallas import tpu as pltpu

    x, (wcos, wsin, mel, log_floor) = frontend_inputs(frames, seed=10 + frames)
    got = replay(t(x), wcos, wsin, mel, log_floor).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(logmel_from_frames_pallas(x, wcos.numpy(), wsin.numpy(), mel.numpy(),
                                                    log_floor))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_wrapper_takes_the_plain_version_on_cpu_for_any_frames():
    x, consts = frontend_inputs(3, seed=4)
    before = logmel.launches
    torch.testing.assert_close(logmel(t(x), *consts), logmel_plain(t(x), *consts),
                               atol=0, rtol=0)
    assert logmel(t(x[:0]), *consts).shape == (0, 128)
    assert logmel.launches == before
