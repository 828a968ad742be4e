"""The harness loads no JAX, no JAX package and no root script; its
references load nothing of the program either; without a card, or without
the program beside it, a run prints no result and fails."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ROOT_SCRIPTS = {p.stem for p in ROOT.glob("*.py")}


def loaded_after(imports):
    code = ("import sys, json\n" + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted(sys.modules)))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=env, cwd=ROOT)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_harness_loads_no_jax():
    tops = loaded_after(["gpubench.harness", "gpubench.drivers.vo_ride",
                         "gpubench.drivers.pilotnet", "gpubench.control"]
                        + [f"gpubench.metrics.{m.stem}"
                           for m in (ROOT / "gpubench" / "metrics").glob("[a-z]*.py")])
    # Whole top-level names: pilotguru_tpu_torch is not pilotguru_tpu.
    assert not tops & {"jax", "jaxlib", "flax", "pilotguru_tpu"}


def test_references_load_nothing_of_the_program():
    tops = loaded_after(["gpubench.reference.orb", "gpubench.reference.ride",
                         "gpubench.reference.pilotnet"])
    assert not tops & {"jax", "jaxlib", "flax", "pilotguru_tpu", "pilotguru_tpu_torch"}
    assert not tops & ROOT_SCRIPTS


def test_reference_sources_import_only_plain_modules():
    for path in (ROOT / "gpubench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in {"__future__", "contextlib", "json", "math",
                                              "typing", "numpy", "torch"}, (path, name)


def run_cli(cwd, env=None):
    return subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                           "pilotnet-train-x3-b1024", "--seed", "2147483659", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_cli(ROOT, env)
    assert out.returncode != 0 and not out.stdout.strip()


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_cli(tmp_path, env)
    assert out.returncode != 0 and not out.stdout.strip()
