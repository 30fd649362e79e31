"""Evaluation helpers of the port: the manifests training reads."""
