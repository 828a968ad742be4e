"""Build and load the hand-written CUDA kernels of the port.

Every ``*.cu`` file under ``csrc/`` (with the ``*.cuh`` headers there) is
compiled by its own ``nvcc`` process
for Hopper (``sm_90a``), all started together, into a shared library with a
plain C interface, loaded with ``ctypes``; ``library(stem)`` builds and loads
one source alone (the training path's, so that it does not wait for the VO
kernels' builds). The build happens at first use,
from the sources in the checkout only, into ``pilotguru_tpu_torch/build/``
(git-ignored); each library's file name carries a digest of its source, the
headers and the flags, so an edited kernel is rebuilt and a stale library
is never loaded.

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
import threading
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
MAX_LEVELS = 8  # kMaxLevels of the level tables in csrc/


class FastLevels(ctypes.Structure):
    """PgFastLevels of csrc/fast_nms.cu: the images of one launch."""

    _fields_ = [
        ("img", _VOIDP * MAX_LEVELS), ("raw", _VOIDP * MAX_LEVELS),
        ("nms", _VOIDP * MAX_LEVELS), ("h", _INT * MAX_LEVELS),
        ("w", _INT * MAX_LEVELS), ("count", _INT),
    ]


class PatchLevels(ctypes.Structure):
    """PgPatchLevels of csrc/patch_gather.cu: the images of one launch and
    each one's keypoints."""

    _fields_ = [
        ("img", _VOIDP * MAX_LEVELS), ("yx", _VOIDP * MAX_LEVELS),
        ("h", _INT * MAX_LEVELS), ("w", _INT * MAX_LEVELS),
        ("num_keypoints", _INT * MAX_LEVELS), ("count", _INT),
    ]


class BlurLevels(ctypes.Structure):
    """PgBlurLevels of csrc/blur_patch_gather.cu: the images of one launch
    and how many of the keypoints each holds."""

    _fields_ = [
        ("img", _VOIDP * MAX_LEVELS), ("h", _INT * MAX_LEVELS),
        ("w", _INT * MAX_LEVELS), ("num_keypoints", _INT * MAX_LEVELS),
        ("count", _INT),
    ]


class BnArgs(ctypes.Structure):
    """PgBn of csrc/bn_relu.cuh: one call's tensors and sizes."""

    _fields_ = [
        ("x", _VOIDP), ("g", _VOIDP), ("out", _VOIDP), ("scale", _VOIDP), ("bias", _VOIDP),
        ("mean_ra", _VOIDP), ("var_ra", _VOIDP), ("stats", _VOIDP), ("grads", _VOIDP),
        ("partial", _VOIDP), ("rows", ctypes.c_longlong), ("channels", _INT), ("vec", _INT),
        ("tiles", _INT), ("parts", _INT), ("groups", _INT), ("eps", ctypes.c_float),
        ("momentum", ctypes.c_float), ("one_minus_momentum", ctypes.c_float),
    ]


class ConvArgs(ctypes.Structure):
    """PgConv of csrc/conv_bwd.cuh: one call's tensors and sizes."""

    _fields_ = [
        ("x", _VOIDP), ("dy", _VOIDP), ("w", _VOIDP), ("dx", _VOIDP), ("partial", _VOIDP),
        ("dw", _VOIDP), ("db", _VOIDP),
        *((name, _INT) for name in ("batch", "hin", "win", "hout", "wout", "ksize", "stride",
                                    "groups", "cin", "m", "cout", "tile", "long_threads",
                                    "splits", "chunk", "rows", "cols")),
    ]


_FLOATP = ctypes.POINTER(ctypes.c_float)
# C signature of each entry point: (argtypes, restype).
_SIGNATURES = {
    # levels, threshold, stream
    "pg_fast_nms_levels": ([ctypes.POINTER(FastLevels), ctypes.c_float, _VOIDP], _INT),
    # levels, out, radius, stream
    "pg_gather_patches_levels": ([ctypes.POINTER(PatchLevels), _VOIDP, _INT, _VOIDP], _INT),
    # levels, yx, taps (host), out, radius, blur radius, stream
    "pg_blur_patch_gather_levels": (
        [ctypes.POINTER(BlurLevels), _VOIDP, _FLOATP, _VOIDP, _INT, _INT, _VOIDP], _INT
    ),
    # args, stream
    **{f"pg_bn_relu_{way}_{dtype}": ([ctypes.POINTER(BnArgs), _VOIDP], _INT)
       for way in ("forward", "backward") for dtype in ("f32", "bf16")},
    # args, stream
    **{f"pg_conv_{way}_f32": ([ctypes.POINTER(ConvArgs), _VOIDP], _INT)
       for way in ("dgrad", "wgrad")},
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    paths: tuple  # one library per source, in source order
    seconds: float  # wall time of the parallel build; 0.0 when all were built
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


def _sources(stem=None):
    sources = sorted(CSRC_DIR.glob("*.cu" if stem is None else f"{stem}.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA source {stem or '*'}.cu under {CSRC_DIR}")
    return sources


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):  # what a source may include
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpg_{src.stem}-{digest.hexdigest()[:16]}.so"


def build(stem=None) -> BuildResult:
    """Compile each csrc/*.cu (or csrc/<stem>.cu alone) into
    build/libpg_<name>-<digest>.so where not built yet, one nvcc process per
    source, all running at once."""
    sources = _sources(stem)
    targets = [_target(src) for src in sources]
    todo = [(src, t) for src, t in zip(sources, targets) if not t.exists()]
    if not todo:
        return BuildResult(tuple(targets), 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    jobs = []
    for src, target in todo:
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((cmd, proc, tmp, target))
    logs, failures = [], []
    for cmd, proc, tmp, target in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    return BuildResult(tuple(targets), time.perf_counter() - start, "".join(logs))


class _Kernels:
    """The entry points of the loaded kernel libraries, as attributes; with
    every library loaded, each entry point is found exactly once."""

    def __init__(self, libs, every_source):
        for name, (argtypes, restype) in _SIGNATURES.items():
            found = [getattr(lib, name) for lib in libs if hasattr(lib, name)]
            if len(found) > 1 or (every_source and not found):
                raise RuntimeError(
                    f"CUDA entry point {name} found in {len(found)} kernel libraries"
                )
            if not found:
                continue
            fn = found[0]
            fn.argtypes = argtypes
            fn.restype = restype
            setattr(self, name, fn)


@functools.cache
def library(stem=None) -> _Kernels:
    """The loaded kernel libraries, built on first call: every source's, or
    csrc/<stem>.cu's alone."""
    return _Kernels([ctypes.CDLL(str(path)) for path in build(stem).paths], stem is None)


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
    main path never makes (only the comparisons in chip_smoke.py do). The
    extractor runs on the feature prefetcher's worker thread while other
    threads may read or reset the counts, so every update takes the lock."""

    name: str
    launches: int = 0
    plain_cuda_calls: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def count_launch(self) -> None:
        with self._lock:
            self.launches += 1

    def count_plain_cuda_call(self) -> None:
        with self._lock:
            self.plain_cuda_calls += 1

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.plain_cuda_calls = 0
