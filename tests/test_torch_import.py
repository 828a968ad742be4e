"""The PyTorch port imports torch and never jax, and no module of the JAX
package pilotguru_tpu (not even one free of JAX); cv2 only inside the
functions named in CV2_FUNCTIONS: the last-resort routes of its frame
input, and the calls that draw, encode or calibrate. Its trajectory files
are byte-identical to the JAX package's."""

import ast
import os
import subprocess
import sys

import numpy as np
import torch

from pilotguru_tpu.formats import trajectory as jax_trajectory
from pilotguru_tpu_torch.formats import trajectory

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
    assert "pilotguru_tpu_torch.vo.tracking" in mods and len(mods) >= 30
    assert {"pilotguru_tpu_torch.calib.fit_motion", "pilotguru_tpu_torch.calib.accelerometer",
            "pilotguru_tpu_torch.calib.pieces", "pilotguru_tpu_torch.calib.rotation_axis",
            "pilotguru_tpu_torch.geometry.strapdown", "pilotguru_tpu_torch.timeseries.merge",
            "pilotguru_tpu_torch.utils.profiling", "pilotguru_tpu_torch.utils.strings",
            "pilotguru_tpu_torch.cli.fit_motion", "pilotguru_tpu_torch.calib.corpus",
            "pilotguru_tpu_torch.calib.interpolate", "pilotguru_tpu_torch.calib.integrate",
            "pilotguru_tpu_torch.calib.forward_axis_calibrator",
            "pilotguru_tpu_torch.solvers.gradient_descent", "pilotguru_tpu_torch.formats.can",
            "pilotguru_tpu_torch.timeseries.interval_average", "pilotguru_tpu_torch.utils.fma",
            "pilotguru_tpu_torch.utils.segments", "pilotguru_tpu_torch.cli.preprocess_corpus",
            "pilotguru_tpu_torch.cli.preprocess_all", "pilotguru_tpu_torch.cli.process_can_frames",
            "pilotguru_tpu_torch.cli.interpolate_velocity",
            "pilotguru_tpu_torch.cli.integrate_motion", "pilotguru_tpu_torch.cli.annotate_frames",
            "pilotguru_tpu_torch.cli.smooth_heading_directions",
            "pilotguru_tpu_torch.cli.project_translations",
            "pilotguru_tpu_torch.cli.make_linear_adjusted_label_shift",
            "pilotguru_tpu_torch.video.imgproc", "pilotguru_tpu_torch.video.png",
            "pilotguru_tpu_torch.utils.msgpack", "pilotguru_tpu_torch.ml.models",
            "pilotguru_tpu_torch.ml.convert", "pilotguru_tpu_torch.ml.training",
            "pilotguru_tpu_torch.ml.prediction", "pilotguru_tpu_torch.cli.predict_video",
            "pilotguru_tpu_torch.cli.make_steering_dataset", "pilotguru_tpu_torch.ml.data",
            "pilotguru_tpu_torch.ml.weighting", "pilotguru_tpu_torch.ml.augmentation",
            "pilotguru_tpu_torch.ml.folded", "pilotguru_tpu_torch.cli.train",
            "pilotguru_tpu_torch.cli.hyperparams_search",
            "pilotguru_tpu_torch.utils.latest_value", "pilotguru_tpu_torch.utils.kahan",
            "pilotguru_tpu_torch.cli.predict_live", "pilotguru_tpu_torch.video.render",
            "pilotguru_tpu_torch.cli.render_motion",
            "pilotguru_tpu_torch.cli.render_frame_numbers",
            "pilotguru_tpu_torch.cli.render_input_pixel_importance",
            "pilotguru_tpu_torch.cli.calibrate", "pilotguru_tpu_torch.vo.map_io",
            "pilotguru_tpu_torch.vo.viewer"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(k for k in sys.modules if k in ('jax', 'jaxlib', 'cv2')\n"
        "             or k.split('.')[0] == 'pilotguru_tpu'))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


# The only functions of the port that import cv2: the last routes of frame
# input (an image that is not a PNG, a video without the native reader) and
# INTER_AREA upscaling, which video/imgproc.py does not reproduce; then the
# calls that draw, encode or calibrate, as the JAX package's: writing a
# video, the render tools, predict_live's capture device and preview, the
# saliency overlay, calibrate, and the VO pipeline's overlay and live view
# (taken only with --visualize, --output_per_segment_videos or
# --visualize_live_port).
CV2_FUNCTIONS = {
    ("pilotguru_tpu_torch/video/io.py", "_read_image_rgb"),
    ("pilotguru_tpu_torch/video/io.py", "_read_video_cv2"),
    ("pilotguru_tpu_torch/video/io.py", "read_frames_rgb"),
    ("pilotguru_tpu_torch/video/imgproc.py", "_upscale_with_cv2"),
    ("pilotguru_tpu_torch/video/io.py", "consume"),  # VideoWriterRgb
    ("pilotguru_tpu_torch/video/render.py", "render_steering"),
    ("pilotguru_tpu_torch/video/render.py", "render_velocity"),
    ("pilotguru_tpu_torch/video/render.py", "render_frame_number"),
    ("pilotguru_tpu_torch/cli/render_motion.py", "main"),
    ("pilotguru_tpu_torch/cli/predict_live.py", "_capture_into"),
    ("pilotguru_tpu_torch/cli/predict_live.py", "_show_preview"),
    ("pilotguru_tpu_torch/cli/predict_live.py", "_close_preview"),
    ("pilotguru_tpu_torch/cli/render_input_pixel_importance.py", "overlay"),
    ("pilotguru_tpu_torch/cli/calibrate.py", "detect_pattern"),
    ("pilotguru_tpu_torch/cli/calibrate.py", "main"),
    ("pilotguru_tpu_torch/vo/pipeline.py", "_overlay_frame"),
    ("pilotguru_tpu_torch/vo/viewer.py", "publish_frame"),
}

# The VO, dataset, inference and training paths: modules whose functions
# import no cv2 except the visualization pair above.
CV2_FREE_PATHS = ("pilotguru_tpu_torch/vo/", "pilotguru_tpu_torch/ml/",
                  "pilotguru_tpu_torch/cli/optical_trajectories.py",
                  "pilotguru_tpu_torch/cli/make_steering_dataset.py",
                  "pilotguru_tpu_torch/cli/predict_video.py",
                  "pilotguru_tpu_torch/cli/train.py",
                  "pilotguru_tpu_torch/cli/hyperparams_search.py")
VISUALIZATION_ONLY = {("pilotguru_tpu_torch/vo/pipeline.py", "_overlay_frame"),
                      ("pilotguru_tpu_torch/vo/viewer.py", "publish_frame")}


def _imports_cv2(node) -> bool:
    return any(
        (isinstance(n, ast.Import) and any(a.name.split(".")[0] == "cv2" for a in n.names))
        or (isinstance(n, ast.ImportFrom) and (n.module or "").split(".")[0] == "cv2")
        for n in ast.walk(node))


def test_cv2_only_in_the_last_resort_functions():
    """No module imports cv2 at module level, only CV2_FUNCTIONS import it
    at all, the VO, dataset, inference and training paths none but the
    visualization pair; chip_smoke.py does not."""
    found = set()
    for dirpath, _, files in os.walk(os.path.join(REPO, "pilotguru_tpu_torch")):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, REPO)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in tree.body:
                if isinstance(node, (ast.Import, ast.ImportFrom)):
                    assert not _imports_cv2(node), f"{rel} imports cv2 at module level"
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                        _imports_cv2(stmt) for stmt in node.body):
                    found.add((rel, node.name))
    assert found == CV2_FUNCTIONS
    assert {f for f in found if f[0].startswith(CV2_FREE_PATHS)} == VISUALIZATION_ONLY
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not _imports_cv2(ast.parse(f.read()))


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py and the measurement scripts beside it."""
    code = (
        "import sys; import chip_smoke, profile_vo, ride_seeds, integrate_stages, train_rounding\n"
        "print('jax' in sys.modules, 'cv2' in sys.modules,\n"
        "      [k for k in sys.modules if k.split('.')[0] == 'pilotguru_tpu'])\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False False []"


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


def _trajectory(cls):
    rng = np.random.default_rng(0)
    n = 7
    rotations = rng.normal(size=(n, 4))
    rotations /= np.linalg.norm(rotations, axis=1, keepdims=True)
    return cls(
        time_usec=np.arange(n, dtype=np.int64) * 33_367 + 5,
        frame_id=np.arange(n, dtype=np.int64) + 3,
        is_lost=np.zeros(n, bool),
        translations=rng.normal(size=(n, 3)) * 1e3,
        rotations=rotations,
        plane=rng.normal(size=(2, 3)),
        planar_directions=rng.normal(size=(n, 2)),
        turn_angles=rng.normal(size=n) * 1e-2,
    )


def test_trajectory_json_is_byte_identical(tmp_path):
    port_file, jax_file = tmp_path / "port.json", tmp_path / "jax.json"
    trajectory.write_trajectory(_trajectory(trajectory.Trajectory), str(port_file), 2)
    jax_trajectory.write_trajectory(_trajectory(jax_trajectory.Trajectory), str(jax_file), 2)
    assert port_file.read_bytes() == jax_file.read_bytes()
    # Each package reads the other's file back to the same values.
    for read in (trajectory.read_trajectory, jax_trajectory.read_trajectory):
        for path in (port_file, jax_file):
            got = read(str(path))
            want = _trajectory(trajectory.Trajectory)
            np.testing.assert_array_equal(got.frame_id, want.frame_id - 2)
            np.testing.assert_array_equal(got.time_usec, want.time_usec)
            np.testing.assert_array_equal(got.translations, want.translations)
            np.testing.assert_array_equal(got.rotations, want.rotations)
            np.testing.assert_array_equal(got.plane, want.plane)
            np.testing.assert_array_equal(got.planar_directions, want.planar_directions)
            # The format stores angular velocities (turn / (dt + 1e-10), so a
            # round trip is off by 3e-9 relative) and writes 0 for the first.
            assert got.turn_angles[0] == 0.0
            np.testing.assert_allclose(got.turn_angles[1:], want.turn_angles[1:], rtol=1e-8)
