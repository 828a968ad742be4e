"""The PyTorch port imports torch and never jax; cv2 only inside its video
decode and camera-YAML functions."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    root = os.path.join(REPO, "pilotguru_tpu_torch")
    mods = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_neither_jax_nor_cv2():
    mods = _port_modules()
    assert "pilotguru_tpu_torch.vo.tracking" in mods and len(mods) >= 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(k for k in ('jax', 'jaxlib', 'cv2') if k in sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_no_jax():
    code = (
        "import sys; import chip_smoke, profile_vo\n"
        "print('jax' in sys.modules, 'cv2' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False False"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No CUDA device here: the smoke exits non-zero and prints no result."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300,
    )
    if torch.cuda.is_available():
        return  # the card is there: the smoke runs for real (chip_smoke.py)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
