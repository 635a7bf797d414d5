"""Quantization core: recipes, int4 packing, RTN quantization, Integer
Scale, the quantized linear and post-training quantization."""
