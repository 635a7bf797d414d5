"""Plain PyTorch oracles with the operand contracts of
``repro/kernels/ref.py``.

Every oracle takes the same packed/quantized operands as its kernel. Each
is its Hopper kernel's plain version, defined beside the wrapper and
re-exported here under the reference's name, so there is one plain
version per kernel.
"""
from .act_quant import act_quant_plain as act_quant_ref
from .w4a16_gemm import w4a16_gemm_plain as w4a16_gemm_ref
from .w4a8_gemm import fg_gemm_integer_scale_plain as fg_gemm_is_ref
from .w4a8_gemm_fscale import fg_gemm_float_scale_plain as fg_gemm_fs_ref

__all__ = ["act_quant_ref", "fg_gemm_fs_ref", "fg_gemm_is_ref",
           "w4a16_gemm_ref"]
