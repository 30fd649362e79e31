"""Fused log-mel (window-folded DFT + power + mel + log): the CUDA kernel
``csrc/mel.cu`` and its plain PyTorch version.

Replaces ``trt_asr_tpu/ops/pallas/mel_kernel.py:logmel_from_frames_pallas``.
At streaming shapes (~50 frames per 0.5 s push) it is latency-bound; the
kernel keeps the power spectrum in shared memory.
"""

from __future__ import annotations

import torch

from trt_asr_tpu_torch.ops.kernels import build as kb


def logmel_plain(frames: torch.Tensor, wcos: torch.Tensor, wsin: torch.Tensor,
                 mel: torch.Tensor, log_floor: float) -> torch.Tensor:
    """frames [T, win] f32 -> log-mel [T, n_mels] f32."""
    re = frames @ wcos
    im = frames @ wsin
    power = re * re + im * im
    return torch.log(power @ mel + log_floor)


def logmel(frames: torch.Tensor, wcos: torch.Tensor, wsin: torch.Tensor,
           mel: torch.Tensor, log_floor: float) -> torch.Tensor:
    """Fused log-mel; same arguments and result as :func:`logmel_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if frames.device.type == "cpu":
        return logmel_plain(frames, wcos, wsin, mel, log_floor)
    t, win = frames.shape
    nb, nm = mel.shape
    if wcos.shape != (win, nb) or wsin.shape != (win, nb):
        raise ValueError("logmel: basis shape mismatch")
    if any(x.dtype != torch.float32 for x in (frames, wcos, wsin, mel)):
        raise TypeError("logmel: f32 inputs only")
    kb.require_cuda("logmel", frames, wcos, wsin, mel)
    lib = kb.load("mel")
    out = torch.empty((t, nm), dtype=torch.float32, device=frames.device)
    rc = lib.logmel_launch(frames.data_ptr(), t, win, wcos.data_ptr(),
                           wsin.data_ptr(), nb, mel.data_ptr(), nm,
                           float(log_floor), out.data_ptr(),
                           kb.stream_ptr(frames.device))
    kb.check(lib, rc, "logmel")
    logmel.launches += 1
    return out


logmel.launches = 0
