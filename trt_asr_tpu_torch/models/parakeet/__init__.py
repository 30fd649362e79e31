"""Parakeet-TDT model: parameters, encoder, predictor, joint."""
