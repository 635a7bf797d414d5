"""Fine-grained W4A8 / W8A8 GEMM with Integer Scale (paper Eq. 2): the
wrapper around ``csrc/w4a8_gemm_is.cu`` and its plain PyTorch version.

Port of ``repro/kernels/w4a8_gemm.py::fg_gemm_integer_scale``. Same
operands: int8 activations (M, K), per-token ``sa`` (M, 1), nibble-packed
int4 weights (K/2, N) (or int8 (K, N) with ``w_bits=8``), int32 group
scales (K/g, N). The kernel reads ``sa`` and the amplifier on the device
and forms the per-row factor ``sa / alpha`` in its epilogue (one IEEE
division a row, the plain version's op order), then one convert and one
multiply; the output is bit-identical to
:func:`fg_gemm_integer_scale_plain` at every K split.

The module also holds the tiling that every GEMM kernel of the port
shares: the row tiles (:func:`pick_tile_m`) and the K split
(:func:`launch_plan`), used by this kernel, the float-scale one, the
grouped W4A8 ones and the W4A16 ones (dense and grouped).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.packing import LAYOUT_UNIT, unpack_int4
from repro_torch.core.quant import group_partials

from . import _build

TILE_M = (16, 64)  # the GEMM kernels' row tiles: decode, prefill
TILE_N = 64        # their column tile (BN in csrc/w4a8_ring.cuh and
                   # csrc/w4a16_ring.cuh)
MAX_SPLITS = 16    # the most K splits a launch plan takes
MAX_GROUP = 1 << 16  # csrc/w4a8_ring.cuh's bound on its x16 int32 partials

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FS_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def fg_gemm_integer_scale_plain(
    xq: torch.Tensor,        # int8 (M, K)
    sa: torch.Tensor,        # f32 (M, 1)
    qvalue: torch.Tensor,    # int8 (K/2, N) packed (w4) or (K, N) (w8)
    int_scale: torch.Tensor, # int32 (K/g, N)
    *,
    group_size: int,
    alpha,                   # python float, or an f32 tensor of 1 value
    w_bits: int = 4,
) -> torch.Tensor:
    """Eq. 2: int32 group accumulation, single final convert.

    Group partials come from ``core.quant.group_partials`` (exact
    float64, or an int32 product in the analysis's traces), then are
    summed in int32 like the reference's accumulator.
    """
    w = unpack_int4(qvalue) if w_bits == 4 else qvalue
    part = group_partials(xq, w, group_size)  # (G, M, N) int32
    acc = torch.sum(part * int_scale[:, None, :], dim=0, dtype=torch.int32)
    return acc.float() * (sa / alpha)


def pick_tile_m(M: int, bm: int = 0) -> int:
    """Row tile: 16 for decode-sized M, 64 above; ``bm`` forces one."""
    if bm:
        if bm not in TILE_M:
            raise ValueError(f"bm={bm}: the kernel has row tiles {TILE_M}")
        return bm
    return 16 if M <= 16 else 64


def launch_plan(M: int, N: int, K: int, sms: int, bm: int = 0,
                experts: int = 1, splits: int = 0) -> dict:
    """The launch of a GEMM kernel for ``experts`` products (M, K) x (K, N)
    on a card with ``sms`` SMs: row tile ``bm`` (:func:`pick_tile_m`),
    number of K ``splits`` (split s takes packing units
    [s U / splits, (s + 1) U / splits) of the U = K / 128) and the
    ``workspace`` elements of the splits' partials (0 without a split).

    K is split so that about two blocks run on each SM, and never fewer
    blocks than SMs where K has the units for it (on the H100 two a SM
    measured fastest at LLaMA-2-7B's shapes, decode and prefill). The
    experts count as blocks: Mixtral's grouped shapes (8 experts) fill
    the card unsplit. ``splits`` forces the split (1 .. K / 128)."""
    bm = pick_tile_m(M, bm)
    if splits:
        if not 1 <= splits <= K // LAYOUT_UNIT:
            raise ValueError(f"splits={splits}: K={K} has "
                             f"{K // LAYOUT_UNIT} packing units")
    else:
        base = -(-N // TILE_N) * -(-M // bm) * experts
        splits = max(-(-sms // base), (2 * sms + base // 2) // base)
        splits = max(1, min(splits, K // LAYOUT_UNIT, MAX_SPLITS))
    return {"bm": bm, "splits": splits,
            "workspace": splits * experts * M * N if splits > 1 else 0}


def launch_plan_on(device: torch.device, M: int, N: int, K: int,
                   bm: int = 0, experts: int = 1, splits: int = 0) -> dict:
    """:func:`launch_plan` on the CUDA ``device`` (its SM count)."""
    index = device.index
    return launch_plan(M, N, K, _sm_count(
        torch.cuda.current_device() if index is None else index), bm,
        experts, splits)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def amplifiers(alpha, E: int, device) -> torch.Tensor:
    """f32 (E,) amplifiers on ``device`` from a python float or a tensor
    of 1 or E values: the stored per-layer tensor itself when it already
    is one (no copy, no launch); a fill, not a host copy, for a float, so
    it can be graph-captured."""
    if isinstance(alpha, torch.Tensor):
        return alpha.to(device=device, dtype=torch.float32).reshape(
            -1).expand(E).contiguous()
    return torch.full((E,), float(alpha), dtype=torch.float32, device=device)


def check_group(name: str, K: int, gs: int) -> None:
    """What the W4A8 kernels refuse of K and the group size."""
    if K % LAYOUT_UNIT:
        raise ValueError(f"{name}: K={K} is not a multiple of "
                         f"{LAYOUT_UNIT}; only the plain version takes it")
    if gs <= 0 or K % gs or gs % 32 or gs > MAX_GROUP:
        raise ValueError(f"{name}: group_size={gs} must divide K={K}, be a "
                         f"multiple of 32 and at most {MAX_GROUP}")


def launch_ring(name: str, xq, sa, alpha, qvalue, scale, gs: int,
                w_bits: int, plan: dict) -> torch.Tensor:
    """Launch the dense W4A8 kernel ``name`` (``w4a8_gemm_is`` with the
    amplifier ``alpha`` (1,), or ``w4a8_gemm_fs`` with None) on checked,
    16-byte aligned operands with the row tile and K split of ``plan``
    (:func:`launch_plan`), and its workspace (4-byte elements, int32 or
    f32 as the kernel reads them) when it splits K."""
    M, K = xq.shape
    N = qvalue.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    ws = (torch.empty(plan["workspace"], dtype=torch.float32,
                      device=xq.device) if plan["workspace"] else None)
    head = [xq.data_ptr(), sa.data_ptr()]
    if alpha is not None:
        head.append(alpha.data_ptr())
    fn = _build.function(name, f"{name}_launch",
                         _FS_ARGS if alpha is None else _ARGS)
    with torch.cuda.device(xq.device):
        err = fn(*head, qvalue.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), M, N, K, gs, w_bits,
                 plan["bm"], plan["splits"], _build.stream_of(xq))
    _build.check(err, name)
    _build.count(name)
    return out


def aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernels' cp.async)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def fg_gemm_integer_scale(
    xq: torch.Tensor,
    sa: torch.Tensor,
    qvalue: torch.Tensor,
    int_scale: torch.Tensor,
    *,
    group_size: int = 128,
    alpha=1024.0,
    w_bits: int = 4,
    bm: int = 0,
) -> torch.Tensor:
    """Eq. 2 GEMM; returns f32 (M, N). ``alpha`` is a python float or an
    f32 tensor of one value (the layer's stored amplifier, read on the
    device). CPU tensors take the plain version; CUDA tensors launch the
    kernel (``bm`` picks its row tile, 0 = by M; the K split follows from
    the shape, :func:`launch_plan`)."""
    if _build.takes_plain("w4a8_gemm_is", xq):
        return fg_gemm_integer_scale_plain(
            xq, sa, qvalue, int_scale, group_size=group_size, alpha=alpha,
            w_bits=w_bits)
    _build.require_cuda("w4a8_gemm_is", xq, sa, qvalue, int_scale)
    M, K = xq.shape
    N = qvalue.shape[1]
    gs = group_size
    check_group("w4a8_gemm_is", K, gs)
    rows = K // 2 if w_bits == 4 else K
    if (xq.dtype != torch.int8 or qvalue.dtype != torch.int8
            or int_scale.dtype != torch.int32 or w_bits not in (4, 8)
            or tuple(qvalue.shape) != (rows, N)
            or tuple(int_scale.shape) != (K // gs, N) or sa.numel() != M):
        raise ValueError("w4a8_gemm_is: operands do not match the contract")
    return launch_ring("w4a8_gemm_is", aligned(xq),
                       sa.reshape(M).float().contiguous(),
                       amplifiers(alpha, 1, xq.device), aligned(qvalue),
                       aligned(int_scale), gs, w_bits,
                       launch_plan_on(xq.device, M, N, K, bm))
