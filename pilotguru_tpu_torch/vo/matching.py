"""Brute-force binary descriptor matching (port of pilotguru_tpu/vo/matching.py).

Hamming distance via the +-1 trick: with bits mapped to {-1, +1},
dot(a, b) = 256 - 2 * hamming(a, b). The dot is a float32 matmul: every
partial sum is an integer of magnitude <= 256, so it is exact (TF32 is off,
see pilotguru_tpu_torch/__init__.py).

Ties resolve as in the reference: ``argmin``/``argmax`` return the first
extremum, and the histogram top-k puts lower bins first among equal counts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pilotguru_tpu_torch.vo.features import DESCRIPTOR_BITS

# ORBmatcher thresholds (ORBmatcher.cc TH_LOW / TH_HIGH).
HAMMING_LOW = 50
HAMMING_HIGH = 100
_NO_MATCH = DESCRIPTOR_BITS + 1


class Matches(NamedTuple):
    index: torch.Tensor  # [Na] int32 — best match in B per A row (or -1)
    distance: torch.Tensor  # [Na] int32
    valid: torch.Tensor  # [Na] bool


def hamming_table(desc_a, desc_b, valid_a=None, valid_b=None):
    """Pairwise Hamming distances [Na, Nb] int32 (invalid rows/cols -> 257)."""
    a = desc_a.to(torch.float32) * 2 - 1
    b = desc_b.to(torch.float32) * 2 - 1
    dot = a @ b.T
    dist = ((DESCRIPTOR_BITS - dot) * 0.5).to(torch.int32)
    big = torch.full_like(dist, _NO_MATCH)
    if valid_a is not None:
        dist = torch.where(valid_a[:, None], dist, big)
    if valid_b is not None:
        dist = torch.where(valid_b[None, :], dist, big)
    return dist


def _best_and_second(dist):
    best_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(dist.shape[1], device=dist.device)
    masked = torch.where(
        cols[None, :] == best_idx[:, None], torch.full_like(dist, _NO_MATCH), dist
    )
    second = masked.min(dim=1).values
    return best_idx, best, second


def _finish(best_idx, best, ok):
    return Matches(
        index=torch.where(ok, best_idx, torch.full_like(best_idx, -1)).to(torch.int32),
        distance=best.to(torch.int32),
        valid=ok,
    )


def match_descriptors(
    desc_a,
    desc_b,
    valid_a=None,
    valid_b=None,
    max_distance: int = HAMMING_LOW,
    ratio: float = 0.9,
    mutual: bool = True,
) -> Matches:
    """Best-match search with Lowe ratio + optional mutual-best check."""
    dist = hamming_table(desc_a, desc_b, valid_a, valid_b)
    best_idx, best, second = _best_and_second(dist)
    ok = (best <= max_distance) & (
        best.to(torch.float32) < ratio * second.to(torch.float32)
    )
    if mutual:
        best_rev = torch.argmin(dist, dim=0)
        ok = ok & (best_rev[best_idx] == torch.arange(dist.shape[0], device=dist.device))
    if valid_a is not None:
        ok = ok & valid_a
    return _finish(best_idx, best, ok)


def match_projected(
    desc_a,
    xy_a,
    desc_b,
    xy_b,
    search_radius: float,
    valid_a=None,
    valid_b=None,
    max_distance: int = HAMMING_HIGH,
    ratio: float = 0.9,
    level_a=None,
    level_b=None,
    scale: float = 1.2,
    level_window: int = 2,
) -> Matches:
    """Window-constrained matching: candidates must lie within
    ``search_radius`` (scaled by scale**level_a when levels are given) and
    within ``level_window`` octaves (ORBmatcher::SearchByProjection)."""
    dist = hamming_table(desc_a, desc_b, valid_a, valid_b)
    a2 = (xy_a * xy_a).sum(-1)
    b2 = (xy_b * xy_b).sum(-1)
    d2 = a2[:, None] + b2[None, :] - 2.0 * (xy_a @ xy_b.T)
    if level_a is not None:
        radius = search_radius * scale ** level_a.to(xy_a.dtype)
        in_window = d2 <= (radius**2)[:, None]
        if level_b is not None:
            level_gap = (level_a[:, None] - level_b[None, :]).abs()
            in_window = in_window & (level_gap <= level_window)
    else:
        in_window = d2 <= search_radius**2
    dist = torch.where(in_window, dist, torch.full_like(dist, _NO_MATCH))
    best_idx, best, second = _best_and_second(dist)
    ok = (best <= max_distance) & (
        best.to(torch.float32) < ratio * second.to(torch.float32)
    )
    if valid_a is not None:
        ok = ok & valid_a
    return _finish(best_idx, best, ok)


ROTATION_HISTO_BINS = 30  # ORBmatcher.cc HISTO_LENGTH
ROTATION_KEEP_BINS = 3  # ComputeThreeMaxima keeps the 3 dominant bins


def rotation_consistency(
    angle_a,
    angle_b,
    matches: Matches,
    bins: int = ROTATION_HISTO_BINS,
    keep: int = ROTATION_KEEP_BINS,
) -> Matches:
    """Keep matches whose orientation difference falls in one of the ``keep``
    most-populated histogram bins (a bin must also hold >= 10% of the best
    bin) — ORBmatcher.cc CheckOrientation / ComputeThreeMaxima."""
    idx = matches.index.clamp_min(0).long()
    diff = angle_b[idx] - angle_a
    frac = torch.remainder(diff / torch.full_like(diff, 2.0 * math.pi), 1.0)
    bin_idx = (frac * bins).to(torch.int64).clamp(0, bins - 1)
    hist = torch.zeros(bins, dtype=torch.int64, device=diff.device).index_add_(
        0, bin_idx, matches.valid.to(torch.int64)
    )
    counts, order = torch.sort(hist, descending=True, stable=True)
    top_counts, top_bins = counts[:keep], order[:keep]
    keep_mask = top_counts.to(torch.float32) >= 0.1 * top_counts[0].to(torch.float32)
    in_top = (
        (bin_idx[:, None] == top_bins[None, :]) & keep_mask[None, :]
    ).any(dim=1)
    ok = matches.valid & in_top
    return Matches(
        index=torch.where(ok, matches.index, torch.full_like(matches.index, -1)),
        distance=matches.distance,
        valid=ok,
    )
