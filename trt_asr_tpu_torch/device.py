"""Device selection and the f32 precision policy of the PyTorch port.

Precision policy, stated once: a float32 matrix product or convolution on
the card runs in full float32. cuBLAS defaults to that already, but cuDNN
(which serves the subsampler's ``conv2d``) defaults to TF32, which keeps
about three decimal digits and breaks closed-loop streaming parity. Both
switches are turned off when the package is imported. This plays the role
of the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_f32_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Without a CUDA device and without an explicit request this
    raises; it never carries on on the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
