"""The port's profiler hook (utils/profiling.py: maybe_profiler_trace, the
counterpart of the JAX package's maybe_jax_profiler_trace) on the CPU:
with PILOTGURU_TPU_PROFILE_DIR set it writes a torch.profiler Chrome trace
of the region under <dir>/<region>/, holding the region's operations;
unset it writes nothing. The fit_motion CLI wraps its run in it, as the
JAX CLI does, and its outputs are the same with the trace as without."""

import json
import os

import torch

from pilotguru_tpu_torch.cli import fit_motion
from pilotguru_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RIDE = os.path.join(REPO, "tests", "golden", "inputs", "ride")


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_written_when_the_variable_is_set(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
    with profiling.maybe_profiler_trace("region"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = tmp_path / "region" / "trace.json"
    assert path.is_file()
    names = {e.get("name") for e in _trace_events(path)}
    assert any(name and "matmul" in name for name in names)


def test_nothing_written_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_profiler_trace("region"):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_fit_motion_cli_writes_its_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOTGURU_TPU_PLATFORM", "cpu")
    outputs = {}
    for traced in (False, True):
        out = tmp_path / ("traced" if traced else "plain")
        out.mkdir()
        if traced:
            monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "profile"))
        else:
            monkeypatch.delenv(profiling.PROFILE_DIR_ENV, raising=False)
        assert fit_motion.main([
            f"--rotations_json={RIDE}/rotations.json",
            f"--accelerations_json={RIDE}/accelerations.json",
            f"--locations_json={RIDE}/locations.json", "--locations_batch_size=20",
            f"--velocities_out_json={out}/v.json", f"--steering_out_json={out}/s.json",
            f"--forward_axis_out_json={out}/f.json"]) == 0
        outputs[traced] = {n: (out / n).read_bytes() for n in ("v.json", "s.json", "f.json")}
    assert outputs[True] == outputs[False]
    trace = tmp_path / "profile" / "fit_motion" / "trace.json"
    assert trace.is_file() and len(_trace_events(trace)) > 100
