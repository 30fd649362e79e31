"""Parakeet-TDT model: parameters, encoder, predictor, joint."""

from trt_asr_tpu_torch.models.parakeet.params import cast_params_for_compute

__all__ = ["cast_params_for_compute"]
