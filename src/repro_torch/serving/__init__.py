"""Continuous-batching serving: the engine and its samplers."""
