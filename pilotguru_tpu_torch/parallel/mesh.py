"""Device lists for spreading work over several cards (port of
pilotguru_tpu/parallel/mesh.py).

The JAX package names three parallel axes: ``windows`` (fit_motion's
sliding-window batch, sharded in preprocess_corpus --shard_windows),
``data`` and ``ensemble`` (hyperparams_search's super-ensemble of nets),
and it spreads the VO prefetcher's frames over every local device. Its
programs are compiled over a ``jax.sharding.Mesh`` and XLA places the
blocks and the collectives. The port runs in one process with explicit
devices: a ``Mesh`` here is the list of ``torch.device`` s and its axis
names, ``shard_leading_axis`` cuts each array's leading axis into the
contiguous per-device blocks that ``NamedSharding(mesh, P(axis))`` gives,
``replicate`` copies a tree to every device, and ``gather_leading_axis``
puts the blocks back together on one device, in order. The caller runs
each block on its device and reduces after the gather, so every reduction
keeps the order of the unsharded run.

A device list may name one device more than once (``[cpu] * 3`` in the
tests, ``[cuda:0, cuda:0]`` on a machine with one card): the blocks are
then cut and gathered as over distinct devices, on the one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """Devices laid out row-major over named axes (``jax.sharding.Mesh``'s
    layout): ``devices[i]`` sits at the mesh coordinate that
    ``np.unravel_index(i, axis_sizes)`` gives."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def cuda_devices() -> List[torch.device]:
    """Every visible card, ``cuda:0`` to ``cuda:n-1`` (CUDA_VISIBLE_DEVICES
    chooses them): the port's ``jax.devices()``. Raises when no card is
    visible; it never returns the CPU in place of a card."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is visible; a device list over the cards needs one")
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """A mesh over ``devices`` (default: every visible card).

    With no explicit sizes, all devices go to the first axis and the other
    axes get size 1. Raises ValueError when the sizes do not cover the
    devices, as the JAX package's make_mesh does."""
    devices = [torch.device(d) for d in (devices if devices is not None else cuda_devices())]
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = [len(devices)] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != len(devices):
        raise ValueError(f"axis sizes {axis_sizes} do not cover {len(devices)} devices")
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} axis names")
    return Mesh(tuple(devices), axis_names, tuple(int(s) for s in axis_sizes))


def pad_to_multiple(array: np.ndarray, multiple: int, axis: int = 0):
    """Pad an axis up to a multiple (for even sharding). Returns (array, n)."""
    n = array.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return array, n
    pad = [(0, 0)] * array.ndim
    pad[axis] = (0, target - n)
    return np.pad(array, pad), n


def block_bounds(length: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous (lo, hi) blocks of ``range(length)`` for ``parts``
    devices: equal where ``parts`` divides ``length`` (NamedSharding's
    blocks), else the first ``length % parts`` blocks one longer. Never
    padded; a block may be empty when ``length < parts``."""
    if parts < 1:
        raise ValueError(f"{parts} parts")
    base, extra = divmod(int(length), parts)
    bounds, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _tree_map(fn, tree):
    """``fn`` over the leaves (tensors, arrays) of nested dicts, lists,
    tuples and NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))


def _axis_blocks(mesh: Mesh, axis_name: str) -> List[int]:
    """Each mesh device's block index along ``axis_name``."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"no axis {axis_name!r} in the mesh's {mesh.axis_names}")
    axis = mesh.axis_names.index(axis_name)
    coords = np.unravel_index(np.arange(mesh.size), mesh.axis_sizes)
    return [int(c) for c in coords[axis]]


def shard_leading_axis(tree, mesh: Mesh, axis_name: str) -> list:
    """One tree per mesh device, in the mesh's device order: each leaf's
    leading axis cut into ``mesh.shape[axis_name]`` contiguous blocks
    (``block_bounds``), the device's block copied to it. Devices that
    differ only along other axes hold the same block, as under
    ``NamedSharding(mesh, P(axis_name))``."""
    leaves = [_tensor(leaf) for leaf in _leaves(tree)]
    if any(leaf.dim() == 0 for leaf in leaves):
        raise ValueError("shard_leading_axis: a scalar leaf has no leading axis")
    lengths = {leaf.shape[0] for leaf in leaves}
    if len(lengths) > 1:
        raise ValueError(f"shard_leading_axis: leading axes of lengths {sorted(lengths)}")
    blocks = _axis_blocks(mesh, axis_name)
    bounds = block_bounds(lengths.pop(), mesh.shape[axis_name])
    return [_tree_map(lambda leaf, d=device, b=bounds[block]: _tensor(leaf)[b[0]:b[1]].to(d),
                      tree)
            for device, block in zip(mesh.devices, blocks)]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per mesh device, in the mesh's device order."""
    return [_tree_map(lambda leaf, d=device: _tensor(leaf).to(d), tree)
            for device in mesh.devices]


def gather_leading_axis(shards: Sequence, device) -> object:
    """The blocks of ``shard_leading_axis`` (trees of one structure, in
    block order) concatenated along the leading axis on ``device``."""
    shards = list(shards)
    leaves = [_leaves(s) for s in shards]
    joined = iter([torch.cat([parts[i].to(device) for parts in leaves])
                   for i in range(len(leaves[0]))])
    return _tree_map(lambda _: next(joined), shards[0])
