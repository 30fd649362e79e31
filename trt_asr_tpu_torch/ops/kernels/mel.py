"""Fused log-mel (window-folded DFT + power + mel + log): the CUDA kernel
``csrc/mel.cu`` and its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/mel_kernel.py:logmel_from_frames_pallas``.
At streaming shapes (~50 frames per 0.5 s push) it is latency-bound: the
kernel spreads a call over clusters of 16 blocks, one cluster a tile of
frames and one block a sixteenth of the DFT bins, laid out by
:func:`logmel_plan`; it reads the bases as :func:`pack_logmel_basis` lays
them out (a bin tile's columns contiguous), and keeps the power spectrum
and the partial mel sums on chip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb
from trt_asr_tpu_torch.ops.kernels.conv_block import SMEM_PER_BLOCK

MEL_CL = 16              # blocks a cluster: bin tiles of a frame tile (csrc/mel.cu)
MEL_FT = 8               # frames a tile
MEL_KS = 20              # runs of the window a bin's sum is split into
MEL_MAX_BT = 17          # bins a tile at most
MAX_FRAME_TILES = 65535  # the grid's y extent: longer inputs take several launches
CPU_F32_TOL = 2e-5       # log-mel error kept from float32 sums on the CPU (logmel_plain)


class MelPlan(NamedTuple):
    """Launch plan of ``csrc/mel.cu``: a (MEL_CL, frame_tiles) grid."""
    frame_tiles: int     # clusters: MEL_FT frames each
    bins: int            # DFT bins a block (a sixteenth of them)
    pitch: int           # floats of a basis row in shared memory
    smem: int            # dynamic shared bytes a block


def mel_pitch(bins: int) -> int:
    """Floats of a basis row in shared memory (``mel_pitch`` in the source):
    ``bins`` rounded up to a multiple of 4, an odd number of 4-float steps."""
    p = -(-bins // 4) * 4
    return p if p % 8 else p + 4


def logmel_plan(t: int, win: int, nb: int, nm: int,
                smem_limit: int = SMEM_PER_BLOCK) -> MelPlan:
    """The grid and shared memory of the log-mel kernel for T frames of
    ``win`` samples, ``nb`` DFT bins and ``nm`` mel bands. Mirrors
    ``mel_smem`` in the source, which checks it at launch. Raises
    ValueError for shapes the kernel does not take (win or n_mels not a
    multiple of 4, more than 16 x MEL_MAX_BT bins, T past one launch's frame
    tiles) or whose staging does not fit."""
    if t < 1 or win < 4 or win % 4 or nb < 1 or nm < 4 or nm % 4:
        raise ValueError(f"logmel: needs T >= 1 and win, n_mels multiples of 4 (T={t}, "
                         f"win={win}, bins={nb}, n_mels={nm})")
    bins = -(-nb // MEL_CL)
    if bins > MEL_MAX_BT:
        raise ValueError(f"logmel: {nb} bins exceed the kernel's {MEL_CL} x {MEL_MAX_BT}")
    frame_tiles = -(-t // MEL_FT)
    if frame_tiles > MAX_FRAME_TILES:
        raise ValueError(f"logmel: T={t} needs more than {MAX_FRAME_TILES} frame tiles")
    pitch = mel_pitch(bins)
    smem = 4 * (MEL_FT * (win + 4) + 2 * win * pitch + bins * nm
                + 2 * MEL_KS * MEL_FT * bins + MEL_FT * bins + MEL_FT * nm)
    if smem > smem_limit:
        raise ValueError(f"logmel: {smem} B of shared memory a block at win={win}, "
                         f"n_mels={nm} exceeds {smem_limit} B")
    return MelPlan(frame_tiles, bins, pitch, smem)


def logmel_plain(frames: torch.Tensor, wcos: torch.Tensor, wsin: torch.Tensor,
                 mel: torch.Tensor, log_floor: float) -> torch.Tensor:
    """frames [T, win] f32 -> log-mel [T, n_mels] f32.

    On the CPU a value whose float32 sums lie more than ``CPU_F32_TOL`` from
    the float64 ones takes the float64 value: in a low-energy bin, where the
    DFT's terms cancel, torch's float32 CPU matmul lay 7.4e-4 from the JAX
    reference's log-mel, past the frontend's bound to it
    (``tests/test_torch_frontend.py``). The other values keep the float32
    sums, the reference's design: float64 throughout moves every value by
    the reference's own rounding, which the int8 arm turned into 2e-3 in a
    token's log-prob (``tests/test_torch_session.py``)."""
    out = _logmel_sums(frames, wcos, wsin, mel, log_floor)
    if frames.device.type == "cpu":
        exact = _logmel_sums(*(x.double() for x in (frames, wcos, wsin, mel)),
                             log_floor).to(out.dtype)
        out = torch.where((out - exact).abs() > CPU_F32_TOL, exact, out)
    return out


def _logmel_sums(frames, wcos, wsin, mel, log_floor):
    re = frames @ wcos
    im = frames @ wsin
    power = re * re + im * im
    return torch.log(power @ mel + log_floor)


def pack_logmel_basis(wcos: torch.Tensor, wsin: torch.Tensor) -> torch.Tensor:
    """The window-folded DFT bases [win, bins] as the log-mel kernel's
    blocks read them: [MEL_CL, 2, win, pitch] f32, tile b holding bins
    b * ceil(bins / MEL_CL) .. of wcos, then of wsin, each row padded to
    the pitch (:func:`mel_pitch`) with zeros, and zero past the bins. Made
    once with the frontend (``LogMelFrontend(use_kernel=True)``, 1.0 MB at
    n_fft 512)."""
    win, nb = wcos.shape
    bins = -(-nb // MEL_CL)
    out = wcos.new_zeros((2, win, MEL_CL * bins))
    out[0, :, :nb] = wcos
    out[1, :, :nb] = wsin
    out = out.view(2, win, MEL_CL, bins).permute(2, 0, 1, 3)
    return torch.nn.functional.pad(out, (0, mel_pitch(bins) - bins)).contiguous()


def logmel(frames: torch.Tensor, wcos: torch.Tensor, wsin: torch.Tensor,
           mel: torch.Tensor, log_floor: float, packed=None) -> torch.Tensor:
    """Fused log-mel; same arguments and result as :func:`logmel_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise), one launch for every MAX_FRAME_TILES * MEL_FT frames.
    ``packed``: the bases as :func:`pack_logmel_basis` lays them out, made
    once with the frontend; without it they are packed anew at that call."""
    if frames.device.type == "cpu":
        return logmel_plain(frames, wcos, wsin, mel, log_floor)
    t, win = frames.shape
    nb, nm = mel.shape
    if wcos.shape != (win, nb) or wsin.shape != (win, nb):
        raise ValueError("logmel: basis shape mismatch")
    if any(x.dtype != torch.float32 for x in (frames, wcos, wsin, mel)):
        raise TypeError("logmel: f32 inputs only")
    if packed is None:
        packed = pack_logmel_basis(wcos, wsin)
    bins = -(-nb // MEL_CL)
    want = (MEL_CL, 2, win, mel_pitch(bins))
    if packed.dtype != torch.float32 or tuple(packed.shape) != want:
        raise ValueError(f"logmel: packed bases {packed.dtype} {tuple(packed.shape)} are not "
                         f"f32 {want} (see pack_logmel_basis)")
    kb.require_cuda("logmel", frames, packed, mel)
    kb.require_aligned("logmel", 4, frames, packed, mel)    # copied 16 bytes at a time
    out = torch.empty((t, nm), dtype=torch.float32, device=frames.device)
    step = MAX_FRAME_TILES * MEL_FT
    for t0 in range(0, t, step):
        _launch(frames[t0:t0 + step], packed, mel, log_floor, out[t0:t0 + step])
    return out


def _launch(frames, packed, mel, log_floor, out) -> None:
    t, win = frames.shape
    nb, nm = mel.shape
    plan = logmel_plan(t, win, nb, nm)
    lib = kb.load("mel")
    rc = lib.logmel_launch(frames.data_ptr(), t, win, packed.data_ptr(), nb, mel.data_ptr(), nm,
                           float(log_floor), plan.frame_tiles, plan.smem, out.data_ptr(),
                           kb.stream_ptr(frames.device))
    kb.check(lib, rc, "logmel")
    logmel.launches += 1


logmel.launches = 0
