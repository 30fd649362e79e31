"""Device selection and the f32 precision policy of the PyTorch port.

Precision policy, stated once: a float32 matrix product or convolution on
the card runs in full float32. cuBLAS defaults to that already, but cuDNN
(which serves the subsampler's ``conv2d``) defaults to TF32, which keeps
about three decimal digits and breaks closed-loop streaming parity. Both
switches are turned off when the package is imported. This plays the role
of the JAX package's ``Precision.HIGHEST``. A bf16 x bf16 product
(``ops/common.matmul`` with bf16 weights) runs on the tensor cores; its
split-K partial sums are kept f32 (cuBLAS may otherwise reduce them in
bf16), so that it rounds once, as JAX's ``preferred_element_type=f32``
followed by a cast to bf16 does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_f32_policy() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def f32_policy() -> dict:
    """This process's f32 policy, as :func:`set_f32_policy` sets it (an
    engine set's manifest records it)."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "bf16_reduced_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}


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
