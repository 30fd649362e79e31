"""PyTorch/CUDA port of trt_asr_tpu: streaming Parakeet-TDT transcription on
an NVIDIA H100.

The JAX package ``trt_asr_tpu`` is the reference; this package imports
nothing of it. Hand-written CUDA kernels for Hopper live in ``csrc/`` and
are bound in ``ops/kernels/``.
"""

from trt_asr_tpu_torch.device import resolve_device, set_f32_policy

set_f32_policy()

__all__ = ["resolve_device", "set_f32_policy"]
