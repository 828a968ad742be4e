"""Build and load the hand-written CUDA kernels of the port.

Every ``*.cu`` file under ``csrc/`` (with the ``*.cuh`` headers there) is
compiled by its own ``nvcc`` process for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. ``build()``
compiles every source at once; ``library(stem, signatures)`` builds and
loads one source alone, at the first launch of its kernels, so a path waits
for no other path's build. The builds read the sources in the checkout only
and write ``pilotguru_tpu_torch/build/`` (git-ignored); each library's file
name carries a digest of its source, the headers and the flags, so an
edited kernel is rebuilt and a stale library is never loaded.

This module knows no kernel. Each wrapper module (``vo/fast_kernel.py``,
``vo/patch_kernel.py``, ``ml/bn_relu_kernel.py``, ``ml/conv_kernel.py``)
holds its sources' ctypes structs and entry-point signatures and decides
when its kernels run. Each C entry point takes raw device pointers, the
sizes and the CUDA stream, launches on that stream without synchronising,
and returns ``cudaGetLastError()``; ``check_launch`` turns a non-zero value
into an exception.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


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


def bind(lib, signatures) -> types.SimpleNamespace:
    """The entry points of ``lib`` that ``signatures`` names, as
    attributes, each given its ``(argtypes, restype)``; no other entry point
    is bound. A name ``lib`` lacks raises."""
    bound = {}
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name, None)
        if fn is None:
            raise RuntimeError(f"CUDA entry point {name} not found in {lib}")
        fn.argtypes = argtypes
        fn.restype = restype
        bound[name] = fn
    return types.SimpleNamespace(**bound)


_LIBRARIES = {}
_LOAD_LOCK = threading.Lock()


def library(stem: str, signatures) -> types.SimpleNamespace:
    """csrc/<stem>.cu's library, built and loaded on the first call, with
    the entry points of ``signatures`` ({name: (argtypes, restype)})
    bound. The module that launches a source's kernels owns its signatures;
    later calls return the first call's binding."""
    with _LOAD_LOCK:
        if stem not in _LIBRARIES:
            _LIBRARIES[stem] = bind(ctypes.CDLL(str(build(stem).paths[0])), signatures)
        return _LIBRARIES[stem]


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
