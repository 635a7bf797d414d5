"""Int4 nibble packing, in the reference's (K/2, N) layout.

The *layout unit* is 128 consecutive k-rows, independent of the
quantization scale group. Within each unit, packed byte-row ``b`` (of 64)
holds

    low nibble  -> k = unit_start + b
    high nibble -> k = unit_start + 64 + b

so unpacking a unit needs two shift pairs and no permutation, and the
activations need no re-layout (the Hopper GEMMs in ``csrc/`` read
exactly this layout; ``w4a8_ring.cuh`` and ``w4a16_ring.cuh`` unpack it
in registers). Small K (smoke configs) packs the whole K as one unit.

Packed shape: (K/2, N) int8. Port of ``repro/core/packing.py``.
"""
from __future__ import annotations

import torch

LAYOUT_UNIT = 128  # k-rows per packing unit


def layout_unit_for(K: int) -> int:
    """128 when possible; small-K fallback (smoke configs) packs K as one
    unit (K must be even)."""
    if K % LAYOUT_UNIT == 0:
        return LAYOUT_UNIT
    if K % 2 != 0:
        raise ValueError(f"K={K} must be even to nibble-pack")
    return K


def pack_int4(q: torch.Tensor, unit: int | None = None) -> torch.Tensor:
    """(K, N) int8 in [-8,7] -> (K/2, N) int8 nibble-packed (layout above)."""
    K, N = q.shape
    u = unit or layout_unit_for(K)
    h = u // 2
    q3 = q.reshape(K // u, u, N).to(torch.int32)
    lo = q3[:, :h, :] & 0xF
    hi = q3[:, h:, :] & 0xF
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return packed.reshape(K // 2, N)


def unpack_int4(packed: torch.Tensor, unit: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> (K, N) int8, sign-extended."""
    Kh, N = packed.shape
    K = Kh * 2
    u = unit or layout_unit_for(K)
    h = u // 2
    p3 = packed.reshape(K // u, h, N).to(torch.int32)
    # sign-extend each nibble: (v ^ 8) - 8 maps 0..15 onto -8..7
    lo = ((p3 & 0xF) ^ 8) - 8
    hi = (((p3 >> 4) & 0xF) ^ 8) - 8
    q3 = torch.cat([lo, hi], dim=1)  # (K/u, u, N) natural order
    return q3.reshape(K, N).to(torch.int8)
