"""Build and load the hand-written CUDA kernels of the port.

Every ``*.cu`` file under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, which is
loaded with ``ctypes``. The build happens at first use, from the sources in
the checkout only, into ``pilotguru_tpu_torch/build/`` (git-ignored); the
library's file name carries a digest of the sources, so an edited kernel is
rebuilt and a stale library is never loaded.

Each C entry point takes raw device pointers, the sizes and the CUDA stream,
launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check_launch`` turns a non-zero value into an
exception.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# C signature of each entry point: (argtypes, restype).
_SIGNATURES = {
    # img, raw, nms, h, w, threshold, stream
    "pg_fast_nms": ([_VOIDP, _VOIDP, _VOIDP, _INT, _INT, ctypes.c_float, _VOIDP], _INT),
    # img, yx, out, h, w, k, radius, stream
    "pg_gather_patches": ([_VOIDP, _VOIDP, _VOIDP, _INT, _INT, _INT, _INT, _VOIDP], _INT),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of pilotguru_tpu_torch build with "
        "the CUDA toolkit's nvcc (on PATH or under /usr/local/cuda/bin)"
    )


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def build() -> BuildResult:
    """Compile csrc/*.cu into build/libpgkernels-<digest>.so (if needed)."""
    sources = _sources()
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / f"libpgkernels-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, target)
    return BuildResult(target, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build().path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


@dataclasses.dataclass
class KernelCounter:
    """Launch bookkeeping for one kernel's wrapper.

    ``launches`` counts kernel launches made by the wrapper; ``plain_cuda_calls``
    counts calls of the plain PyTorch version with CUDA tensors, which the
    main path never makes (only the comparisons in chip_smoke.py do)."""

    name: str
    launches: int = 0
    plain_cuda_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_cuda_calls = 0
