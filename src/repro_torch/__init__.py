"""repro_torch — the PyTorch + CUDA port of the ``repro`` package.

The port mirrors the ``repro`` tree module for module (so
``repro_torch/core/packing.py`` is the port of ``repro/core/packing.py``)
and runs on an NVIDIA H100: every Pallas TPU kernel on the ported path is
a CUDA C++ kernel in ``repro_torch/csrc/``, built with ``nvcc`` at first
use and bound with ``ctypes`` (``repro_torch.kernels._build``).

The port imports ``torch`` and never ``jax``, and nothing of ``repro``.
Entry points that create tensors run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without that request they raise.
Each kernel wrapper takes its plain PyTorch version only for CPU tensors.
"""
