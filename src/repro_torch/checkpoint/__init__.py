"""Atomic, async checkpoints of the port."""
