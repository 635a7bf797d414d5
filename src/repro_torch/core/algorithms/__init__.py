"""Calibration-based PTQ algorithms (GPTQ, AWQ, SmoothQuant, OmniQuant,
QuaRot). Port of ``repro/core/algorithms/``: each runs in PyTorch on its
weight's device and returns int8 codes and f32 scales (plus AWQ's and
SmoothQuant's ``pre_scale``, QuaRot's ``rot``) for ``qlinear.finish_quant``.
Codes equal the reference's bit for bit: where the reference's numpy
arithmetic fixes an order (a sequential column mean, ``powf``), the port
keeps that order."""
