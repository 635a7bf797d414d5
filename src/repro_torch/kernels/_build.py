"""Build and load the port's CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so <name>.cu

The file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header is
rebuilt. Nothing is built at import: :func:`function` builds on
first use, and :func:`build` compiles several sources at once (one
``nvcc`` each, all started together). ``--use_fast_math`` is deliberately
absent: it makes ``/`` approximate and would break the bit-exact codes.

The qlint fixtures (``csrc/fixtures/<name>.cu``, :data:`FIXTURES`: kernels
seeded with one defect each, ``analysis/fixtures.py``) build the same way.
:func:`ptx` gives the PTX of any of these sources, for qlint's PTX level:
``build(names, ptx=True)`` runs ``nvcc -ptx -arch=sm_90a`` with the same
flags less ``-shared``, ``-Xcompiler -fPIC`` and ``-Xptxas -v`` (the
libraries hold only ``sm_90a`` SASS, so no PTX can be read back from
them), cached under the same content hash.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0. :data:`LAUNCHES` counts the
launches of each kernel; only a wrapper that has just launched its kernel
adds to it (:func:`count`). Under a CUDA graph capture the wrappers launch
nothing: ``serving/graphs.py`` takes the capture's counts back out and
adds them again on every replay (:func:`add_launches`), so the counts stay
device launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

KERNELS = ("act_quant", "w4a8_gemm_is", "flash_attention", "w4a8_gemm_fs",
           "w4a16_gemm", "moe_w4a8_is", "moe_w4a8_fs", "moe_w4a16",
           "flash_attention_bwd")

FIXTURES = ("broken_fp32_dot", "broken_no_preferred", "broken_narrowing",
            "broken_index_map", "broken_divisibility")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# <repo>/build/repro_torch when run from a checkout (src/repro_torch/...)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PTX_FLAGS = ("-ptx", "-arch=sm_90a", "-std=c++17", "-O3")

#: kernel name -> launches since the last :func:`reset_launches` (a
#: fixture's name joins at its first launch)
LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
#: kernel name -> nvcc's output from the build in this process (ptxas -v)
BUILD_LOG: dict[str, str] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}  # (name, symbol) -> declared fn
_LOCK = threading.Lock()


def count(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def add_launches(launches: dict[str, int]) -> None:
    """Count a replayed CUDA graph's kernel launches."""
    for name, n in launches.items():
        LAUNCHES[name] += n


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of ``nvcc``; raises when there is none."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def source(name: str) -> Path:
    """The CUDA source of kernel or fixture ``name``."""
    if name in FIXTURES:
        return CSRC / "fixtures" / f"{name}.cu"
    return CSRC / f"{name}.cu"


def _target(name: str, ptx: bool = False) -> Path:
    flags = PTX_FLAGS if ptx else NVCC_FLAGS
    digest = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.{'ptx' if ptx else 'so'}"


def build(names=KERNELS, ptx: bool = False) -> dict[str, float]:
    """Compile every missing library (``ptx``: PTX file) among ``names`` in
    parallel; returns {name: seconds} for the ones compiled. Raises on a
    failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = PTX_FLAGS if ptx else NVCC_FLAGS
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name, ptx)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags, "-o", str(tmp), str(source(name))]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    times, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if not ptx:
            BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def ptx(name: str) -> str:
    """The PTX of kernel or fixture ``name`` (compiled on first use)."""
    build([name], ptx=True)
    return _target(name, ptx=True).read_text()


def function(name: str, symbol: str, argtypes: list):
    """The C entry point ``symbol`` of kernel library ``name``, built and
    loaded on first use, with ``argtypes`` declared and an int result."""
    fn = _FNS.get((name, symbol))
    if fn is not None:
        return fn
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_target(name)))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError_t {err})")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


# Devices whose tensors take a kernel's plain version: the CPU (the tests'
# device) and ``meta`` (shapes only, no data: the dry-run's device).
PLAIN_DEVICES = ("cpu", "meta")


def takes_plain(name: str, t) -> bool:
    """The wrappers' device rule: True where ``t`` lies on the CPU or on
    ``meta`` (the plain version), False on CUDA (the kernel); any other
    device raises."""
    kind = t.device.type
    if kind in PLAIN_DEVICES:
        return True
    if kind == "cuda":
        return False
    raise ValueError(f"{name}: expected CUDA, CPU or meta tensors, got "
                     f"{t.device}")


def require_cuda(name: str, *tensors) -> None:
    """The kernel's side of :func:`takes_plain`: every operand on CUDA."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
