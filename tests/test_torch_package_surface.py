"""The port's package surface and linear-algebra entries against the JAX
package, on the CPU:

- every name each JAX subpackage ``__init__`` exports (read by AST from the
  JAX files, which are not imported) imports from the port's subpackage, in
  a process where jax is never imported, but the names NOT_PORTED lists;
- the functions the JAX ``calib`` exports that the port lacked:
  rotations_complementary_to_axis and window_loss against the JAX
  functions (float64);
- utils/linalg.py's svd and solve_ex on a CPU tensor equal to
  torch.linalg.svd and torch.linalg.solve_ex to the bit, in float32 and
  float64 (the CPU keeps LAPACK; only a CUDA float32 tensor is routed).
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilotguru_tpu.calib import accelerometer as jax_accelerometer
from pilotguru_tpu.calib import rotation_axis as jax_rotation_axis
from pilotguru_tpu_torch.calib import accelerometer, rotation_axis
from pilotguru_tpu_torch.utils import linalg

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("calib", "vo", "solvers", "timeseries", "geometry", "formats", "ml", "video",
               "parallel")
# Exports not ported by design (ROADMAP.md Queue 1 item 5: what targets
# only the JAX runtime): CorpusBuckets sizes the shapes that the JAX
# corpus pads each ride to, so that XLA compiles once a bucket; the port
# compiles nothing and pads nothing.
NOT_PORTED = {"calib": {"CorpusBuckets"}}


def _exported_names(subpackage):
    """The names pilotguru_tpu/<subpackage>/__init__.py imports."""
    with open(os.path.join(REPO, "pilotguru_tpu", subpackage, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [alias.asname or alias.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for alias in node.names]


def test_every_jax_export_imports_from_the_port_without_jax():
    names = {sub: [n for n in _exported_names(sub) if n not in NOT_PORTED.get(sub, ())]
             for sub in SUBPACKAGES}
    assert sum(map(len, names.values())) >= 70
    code = (
        "import importlib, json, sys\n"
        f"names = {names!r}\n"
        "missing = [f'{sub}.{n}' for sub, ns in names.items()\n"
        "           for n in ns if not hasattr(importlib.import_module(\n"
        "               'pilotguru_tpu_torch.' + sub), n)]\n"
        "print(json.dumps([missing, sorted(k for k in sys.modules if k in ('jax', 'cv2')\n"
        "                   or k.split('.')[0] == 'pilotguru_tpu')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[[], []]"


def test_rotations_complementary_to_axis_matches_jax():
    rng = np.random.default_rng(0)
    rates = rng.normal(size=(50, 3))
    axis = np.array([0.2, -0.9, 0.35])  # not unit: the function divides by its norm
    got = rotation_axis.rotations_complementary_to_axis(torch.from_numpy(rates),
                                                        torch.from_numpy(axis))
    want = jax_rotation_axis.rotations_complementary_to_axis(jnp.asarray(rates),
                                                             jnp.asarray(axis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)
    # What is left has no component along the axis.
    np.testing.assert_allclose(got.numpy() @ axis, 0.0, atol=1e-15)


def test_window_loss_matches_jax():
    rng = np.random.default_rng(1)
    pieces, segments = 40, 6
    rates = rng.normal(scale=0.05, size=(pieces, 3))
    acc = rng.normal(scale=0.5, size=(pieces, 3)) + [0.0, 0.0, 9.81]
    dt = rng.uniform(0.004, 0.006, size=pieces)
    segment_ids = np.sort(rng.integers(0, segments, size=pieces)).astype(np.int32)
    speeds = rng.uniform(5.0, 10.0, size=segments)
    params = rng.normal(scale=[0.1] * 3 + [0.05] * 3 + [3.0] * 3)
    args = (params, rates, acc, dt, segment_ids, speeds)
    want = jax_accelerometer.window_loss(*(jnp.asarray(a) for a in args), segments)
    got = accelerometer.window_loss(*(torch.from_numpy(a) for a in args), segments)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12, atol=0)


def test_names_not_ported_are_jax_exports_absent_from_the_port():
    """NOT_PORTED names only what the JAX package exports and the port
    does not define."""
    import importlib

    for sub, names in NOT_PORTED.items():
        assert names <= set(_exported_names(sub))
        port = importlib.import_module(f"pilotguru_tpu_torch.{sub}")
        assert not any(hasattr(port, n) for n in names)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape,full_matrices", [((128, 8, 9), True), ((300, 9), False),
                                                 ((3, 3), True), ((64, 12, 12), False)])
def test_svd_entry_is_torch_svd_on_the_cpu(dtype, shape, full_matrices):
    a = torch.from_numpy(np.random.default_rng(2).normal(size=shape)).to(dtype)
    got = linalg.svd(a, full_matrices=full_matrices)
    want = torch.linalg.svd(a, full_matrices=full_matrices)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_entry_is_torch_solve_on_the_cpu(dtype):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(60, 60)) + 60 * np.eye(60)).to(dtype)
    b = torch.from_numpy(rng.normal(size=60)).to(dtype)
    (x, info), (want, want_info) = linalg.solve_ex(a, b), torch.linalg.solve_ex(a, b)
    assert torch.equal(x, want) and torch.equal(info, want_info)
