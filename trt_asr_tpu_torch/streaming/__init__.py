"""Chunk schedule and the streaming session."""
