"""The benchmark's runner: finds a cell's files by name, runs its traffic
driver, reads the per-layer metrics, checks that no JAX module was loaded,
and prints the result.

Everything a cell needs is a file found by name: ``workloads/<cell>.json``
(its configuration, traffic, chips, why, limits and harness settings),
``configs/<config>.json``, ``traffic/<traffic>.json`` (its parameters and
the ``driver`` module under ``drivers/`` that reads them), one reader per
per-layer metric under ``metrics/`` and one work file per hand kernel under
``kernels/``. Adding any of them is adding a file.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "pilotguru_tpu")


def _load(folder: str, name: str) -> dict:
    path = HERE / folder / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"gpubench: no {folder[:-1]} named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def names(folder: str, suffix: str = ".json") -> list:
    return sorted(p.stem for p in (HERE / folder).glob(f"*{suffix}")
                  if not p.stem.startswith("_"))


def cell(name: str) -> dict:
    return {"name": name, **_load("workloads", name)}


def config(name: str) -> dict:
    return _load("configs", name)


def traffic(name: str) -> dict:
    return _load("traffic", name)


def metric_readers() -> dict:
    """{metric name: its module under metrics/}, every reader the folder
    holds."""
    return {name: importlib.import_module(f"gpubench.metrics.{name}")
            for name in names("metrics", ".py")}


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES,
    compared whole (``pilotguru_tpu_torch`` is not ``pilotguru_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)


@dataclass
class Check:
    """One number compared, beside its limit: correct while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # name -> (value, unit)
    layer: dict  # what the per-layer readers read
    checks: list
    memory_peak_bytes: int
    trace: Optional[object] = None  # devtrace.TraceSummary of a traced run
    notes: dict = field(default_factory=dict)


@dataclass
class Run:
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # wall clock at process start
    out_root: str
    # "tf32": the program's float32 products and convolutions in TF32;
    # "bfloat16": the plain extractor in bfloat16 in the program's place (VO).
    precision: str = "float32"

    def apply_precision(self) -> None:
        """TF32 on for a control run, off otherwise (the package's policy,
        which an earlier control run in the process may have changed). The
        package is imported first: importing it sets its policy."""
        import torch

        import pilotguru_tpu_torch  # noqa: F401

        torch.backends.cuda.matmul.allow_tf32 = self.precision == "tf32"
        torch.backends.cudnn.allow_tf32 = self.precision == "tf32"


def execute(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
            cell_spec: Optional[dict] = None, config_spec: Optional[dict] = None,
            traffic_spec: Optional[dict] = None, precision: str = "float32") -> Outcome:
    """One run of a cell on ``device``; the specs replace the files' (the
    tests run the same path at small sizes on the CPU)."""
    cspec = cell_spec or cell(name)
    tspec = traffic_spec or traffic(cspec["traffic"])
    driver = importlib.import_module(f"gpubench.drivers.{tspec['driver']}")
    out_root = tempfile.mkdtemp(prefix=f"gpubench-{name}-")
    try:
        run = Run(name, cspec, config_spec or config(cspec["config"]), tspec, seed, seconds,
                  trace, device, t_start, out_root, precision)
        run.apply_precision()
        return driver.run(run)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)


def layer_metrics(outcome: Outcome) -> dict:
    """Every per-layer reader's value, where it found something to read."""
    out = {}
    for name, reader in metric_readers().items():
        value = reader.read(outcome.layer)
        if value is not None:
            out[name] = {"value": value, "unit": reader.UNIT}
    return out


def result_line(outcome: Outcome, trace: bool, device_info: dict) -> dict:
    correct = all(c.ok for c in outcome.checks)
    if trace:
        metrics = layer_metrics(outcome)
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in outcome.end_to_end.items()}
    device = dict(device_info, memory_peak_bytes=int(outcome.memory_peak_bytes))
    line = {"correct": correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": outcome.trace.device_ops,
                             "idle_gaps": outcome.trace.idle_gaps}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv, t_start: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"gpubench: {args.workload} needs {spec['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    outcome = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start)
    found = forbidden_loaded()
    if found:
        print(f"gpubench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": spec["chips"]}
    line = result_line(outcome, bool(args.trace), info)
    if outcome.notes:
        print(f"gpubench notes: {json.dumps(outcome.notes)}", file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
