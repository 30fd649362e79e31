"""Audio file input/output."""
