"""Fault-tolerance utilities (``fault``); sharding waits for the multi-GPU
slice."""
