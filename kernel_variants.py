"""Time the compile-time variants of K1 (FAST + NMS), K2 (patch gather) and
K3 (fused blur + patch gather) on one NVIDIA card, each held against its
plain version first.

    python3 kernel_variants.py [--reps 30]

The sources under pilotguru_tpu_torch/csrc take their tuning choices as
macros (PG_FAST_COMPASS, PG_FAST_ROWS, PG_FAST_PROBE; PG_PATCH_KEYPOINTS,
PG_PATCH_THREADS, PG_PATCH_PROBE; PG_BLUR_RUN_V, PG_BLUR_RUN_H,
PG_BLUR_THREADS). This script builds one library per variant with nvcc (all
at once), puts it in the place of the default library, checks the wrapper's
result against the plain PyTorch version (exact equality) and prints the
device time (CUPTI, as chip_smoke.time_ms) of the one-level call at
1280x720 and of the all-level call over the 8 pyramid levels of a 720p
frame: K1 on a uniform-noise image (nearly every pixel passes the compass
test) and on a rendered ride frame (most pixels are flat); K2 and K3 with
434 keypoints on one level and with the extractor's 2000 over 8 levels
(plus 36 near the border and in the corners per level), beside K2's two
floors: an empty kernel on its grid and, from a probe build, its stores
and index walk without the loads. The
first variant of each list is the one the sources default to.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np

import chip_smoke

FAST_VARIANTS = [
    {"PG_FAST_COMPASS": 1, "PG_FAST_ROWS": 8},
    {"PG_FAST_COMPASS": 0, "PG_FAST_ROWS": 8},
    {"PG_FAST_COMPASS": 1, "PG_FAST_ROWS": 16},
    {"PG_FAST_COMPASS": 0, "PG_FAST_ROWS": 16},
    # Probes (wrong results, not checked): no scoring at all; masks only.
    {"PG_FAST_COMPASS": 0, "PG_FAST_ROWS": 8, "PG_FAST_PROBE": 1},
    {"PG_FAST_COMPASS": 0, "PG_FAST_ROWS": 8, "PG_FAST_PROBE": 2},
]
PATCH_VARIANTS = [
    {"PG_PATCH_KEYPOINTS": 4, "PG_PATCH_THREADS": 512},
    {"PG_PATCH_KEYPOINTS": 4, "PG_PATCH_THREADS": 256},
    {"PG_PATCH_KEYPOINTS": 8, "PG_PATCH_THREADS": 256},
    {"PG_PATCH_KEYPOINTS": 1, "PG_PATCH_THREADS": 128},
    {"PG_PATCH_KEYPOINTS": 2, "PG_PATCH_THREADS": 256},
    {"PG_PATCH_KEYPOINTS": 4, "PG_PATCH_THREADS": 1024},
    {"PG_PATCH_KEYPOINTS": 8, "PG_PATCH_THREADS": 512},
    {"PG_PATCH_KEYPOINTS": 8, "PG_PATCH_THREADS": 1024},
    # Probe (wrong results, not checked): stores and index walk, no loads.
    {"PG_PATCH_KEYPOINTS": 4, "PG_PATCH_THREADS": 512, "PG_PATCH_PROBE": 1},
]
BLUR_VARIANTS = [
    {"PG_BLUR_RUN_V": 20, "PG_BLUR_RUN_H": 13, "PG_BLUR_THREADS": 128},
    {"PG_BLUR_RUN_V": 10, "PG_BLUR_RUN_H": 7, "PG_BLUR_THREADS": 256},
    {"PG_BLUR_RUN_V": 13, "PG_BLUR_RUN_H": 13, "PG_BLUR_THREADS": 192},
    {"PG_BLUR_RUN_V": 20, "PG_BLUR_RUN_H": 10, "PG_BLUR_THREADS": 160},
]


def build_variants(cuda_lib):
    """{(source stem, index): library path}, one nvcc process per variant."""
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem, variants in (("fast_nms", FAST_VARIANTS), ("patch_gather", PATCH_VARIANTS),
                           ("blur_patch_gather", BLUR_VARIANTS)):
        for i, defines in enumerate(variants):
            target = cuda_lib.BUILD_DIR / f"libpg_{stem}-variant{i}.so"
            cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS,
                   *(f"-D{k}={v}" for k, v in defines.items()),
                   "-o", str(target), str(cuda_lib.CSRC_DIR / f"{stem}.cu")]
            jobs[(stem, i)] = (target, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for key, (target, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        print(f"{key}: {' '.join(line for line in out.splitlines() if 'registers' in line)}",
              flush=True)
        paths[key] = target
    return paths


def use_variant(cuda_lib, default_paths, stem, path):
    """Make the wrappers launch ``path`` in the place of ``stem``'s library."""
    libs = [ctypes.CDLL(str(path if p.name.startswith(f"libpg_{stem}-") else p))
            for p in default_paths]
    kernels = cuda_lib._Kernels(libs)
    cuda_lib.library = lambda: kernels


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=30)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import pilotguru_tpu_torch  # noqa: F401  (precision policy)
    from pilotguru_tpu_torch import cuda_lib
    from pilotguru_tpu_torch.vo import fast_kernel, features, patch_kernel

    print(f"card: {chip_smoke.card_name_and_power()}", flush=True)
    default_paths = cuda_lib.build().paths
    paths = build_variants(cuda_lib)
    rng = np.random.default_rng(0)

    def pyramid(level0):
        return [level0] + [features.resize_linear(level0, h, w)
                           for h, w in chip_smoke.LEVEL_SHAPES_720P[1:]]

    noise = pyramid(torch.from_numpy(rng.uniform(0, 1, (720, 1280)).astype(np.float32)).cuda())
    frame = next(iter(chip_smoke.render_loop_ride(frames=1)))
    ride = pyramid(torch.from_numpy(frame.astype(np.float32) / 255.0).cuda())
    floors = chip_smoke.build_floors()
    for name, images in (("720p", noise[:1]), ("201x357", noise[-1:]), ("8 levels", noise)):
        empty_ms, copy_ms = chip_smoke.time_fast_floors(floors, images, args.reps)
        print(f"K1 floors on the grid of {name}: empty kernel {empty_ms:.4f} ms, copy of the "
              f"same bytes {copy_ms:.4f} ms", flush=True)
    for i, defines in enumerate(FAST_VARIANTS):
        use_variant(cuda_lib, default_paths, "fast_nms", paths[("fast_nms", i)])
        row = {}
        for name, levels in (("noise", noise), ("ride", ride)):
            for (raw, nms), image in zip(fast_kernel.fast_nms_levels(levels), levels):
                want_raw, want_nms = fast_kernel.fast_nms_plain(image)
                one_raw, one_nms = fast_kernel.fast_nms(image)
                if "PG_FAST_PROBE" in defines:
                    continue
                if not (torch.equal(raw, want_raw) and torch.equal(nms, want_nms)
                        and torch.equal(one_raw, want_raw) and torch.equal(one_nms, want_nms)):
                    raise AssertionError(f"K1 variant {defines} differs from plain on {name} "
                                         f"at {tuple(image.shape)}")
            row[f"{name} 720p"] = chip_smoke.time_ms(
                lambda: fast_kernel.fast_nms(levels[0]), args.reps)[0]
            row[f"{name} 201x357"] = chip_smoke.time_ms(
                lambda: fast_kernel.fast_nms(levels[-1]), args.reps)[0]
            row[f"{name} 8 levels"] = chip_smoke.time_ms(
                lambda: fast_kernel.fast_nms_levels(levels), args.reps)[0]
        print(f"K1 {defines}: {'probe' if 'PG_FAST_PROBE' in defines else 'exact'}; device ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)

    budgets = features.pyramid_level_budgets(2000, 8, 1.2)
    yx = [torch.from_numpy(chip_smoke._keypoints_720p(rng, h, w, k)).cuda()
          for (h, w), k in zip(chip_smoke.LEVEL_SHAPES_720P, budgets)]
    yx434 = yx[0][:434].contiguous()
    blurred = [features.gaussian_blur(image) for image in noise]
    for name, keypoints in (("K=434", [yx434]), (f"K={sum(t.shape[0] for t in yx)}", yx)):
        blocks = -(-sum(t.shape[0] for t in keypoints) // 4)
        empty_ms = chip_smoke.time_ms(lambda: cuda_lib.check_launch(
            "floor_empty", floors.pg_floor_empty(blocks, 512, cuda_lib.current_stream(
                noise[0].device))), args.reps)[0]
        print(f"K2 floor, {name}: an empty kernel on the grid of 4 keypoints a block "
              f"({blocks} blocks of 512) {empty_ms:.4f} ms", flush=True)
    for i, defines in enumerate(PATCH_VARIANTS):
        use_variant(cuda_lib, default_paths, "patch_gather", paths[("patch_gather", i)])
        got = patch_kernel.gather_patches_levels(blurred, yx)
        for patches, image, level_yx in zip(got, blurred, yx):
            want = patch_kernel.gather_patches_plain(image, level_yx)
            if "PG_PATCH_PROBE" in defines:
                continue
            if not (torch.equal(patches, want) and torch.equal(
                    patch_kernel.gather_patches(image, level_yx), want)):
                raise AssertionError(f"K2 variant {defines} differs from plain at "
                                     f"{tuple(image.shape)}")
        one = chip_smoke.time_ms(
            lambda: patch_kernel.gather_patches(blurred[0], yx434), args.reps)[0]
        every = chip_smoke.time_ms(
            lambda: patch_kernel.gather_patches_levels(blurred, yx), args.reps)[0]
        print(f"K2 {defines}: {'probe' if 'PG_PATCH_PROBE' in defines else 'exact'}; device "
              f"ms 720p K=434 {one:.4f}, 8 levels K={sum(t.shape[0] for t in yx)} "
              f"{every:.4f}", flush=True)
    for i, defines in enumerate(BLUR_VARIANTS):
        use_variant(cuda_lib, default_paths, "blur_patch_gather",
                    paths[("blur_patch_gather", i)])
        got = patch_kernel.gather_blurred_patches_levels(noise, yx)
        for patches, image, level_yx in zip(got, noise, yx):
            want = patch_kernel.gather_blurred_patches_plain(image, level_yx)
            if not (torch.equal(patches, want) and torch.equal(
                    patch_kernel.gather_blurred_patches(image, level_yx), want)):
                raise AssertionError(f"K3 variant {defines} differs from plain at "
                                     f"{tuple(image.shape)}")
        one = chip_smoke.time_ms(
            lambda: patch_kernel.gather_blurred_patches(noise[0], yx434), args.reps)[0]
        # The all-level call also concatenates the keypoint sets (one more
        # kernel, counted in its device time).
        every = chip_smoke.time_ms(
            lambda: patch_kernel.gather_blurred_patches_levels(noise, yx), args.reps)[0]
        print(f"K3 {defines}: exact; device ms 720p K=434 {one:.4f}, 8 levels "
              f"K={sum(t.shape[0] for t in yx)} {every:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
