"""Atomic, async, retained checkpoints (``manager``)."""
