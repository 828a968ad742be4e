"""Shared CLI plumbing: gflags-style argument handling and device setup."""

from __future__ import annotations

import argparse
import os

import torch


def make_parser(description: str) -> argparse.ArgumentParser:
    # gflags accepts both --flag=value and --flag value; argparse does too.
    return argparse.ArgumentParser(description=description, allow_abbrev=False)


def setup_device(dtype_flag: str = "auto"):
    """Choose the compute device and the geometry dtype. Returns
    (torch.device, torch.dtype).

    PILOTGURU_TPU_PLATFORM=cpu|cuda selects the device (the variable the
    JAX CLIs read to force a platform); unset means cuda. A cuda request
    without a CUDA device raises instead of falling back to the CPU.
    ``--dtype auto`` is float64 on the CPU and float32 on CUDA."""
    platform = os.environ.get("PILOTGURU_TPU_PLATFORM") or "cuda"
    if platform not in ("cpu", "cuda"):
        raise ValueError(
            f"PILOTGURU_TPU_PLATFORM={platform!r}: pilotguru_tpu_torch runs on "
            "'cpu' or 'cuda'"
        )
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; set PILOTGURU_TPU_PLATFORM=cpu to "
            "run pilotguru_tpu_torch on the CPU"
        )
    device = torch.device(platform)
    if dtype_flag == "auto":
        dtype_flag = "float64" if platform == "cpu" else "float32"
    return device, {"float64": torch.float64, "float32": torch.float32}[dtype_flag]


def patch_impl_from_env() -> str:
    """The extractor's blurred-patch path from the reference's switch
    PGTPU_PATCH_IMPL: 'fused' selects the fused blur + gather kernel (K3);
    'auto', 'jnp', 'pallas' or unset keep blur-then-gather (K2), since the
    jnp/Pallas choice is a TPU one."""
    choice = os.environ.get("PGTPU_PATCH_IMPL") or "auto"
    if choice == "fused":
        return "fused"
    if choice in ("auto", "jnp", "pallas"):
        return "blur_then_gather"
    raise ValueError(
        f"PGTPU_PATCH_IMPL={choice!r}: want 'fused', 'auto', 'jnp' or 'pallas'"
    )


def add_dtype_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--dtype",
        choices=["auto", "float32", "float64"],
        default="auto",
        help="Geometry precision; auto = float64 on CPU, float32 on CUDA.",
    )
