"""Steering-model checkpoints (port of pilotguru_tpu/ml/training.py's
save_net, load_net and load_ensemble_params; the training loop is not
ported yet).

A checkpoint is the JAX package's file: flax's msgpack of
{"params": ..., "batch_stats": ...} for one net, written and read by the
port's own codec (utils/msgpack.py) byte for byte as flax does, with the
weights carried across by ml/convert.py. A file the port writes loads in
the JAX package's ``training.load_net`` and the other way round.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np

from pilotguru_tpu_torch.ml import convert
from pilotguru_tpu_torch.utils import msgpack


def save_net(net, path: str) -> None:
    """Serialise one net (flax msgpack)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(convert.flax_variables(net)))


def load_net(path: str) -> Dict[str, Any]:
    """One checkpoint as its flax tree of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def load_ensemble_params(paths: List[str]) -> Dict[str, Any]:
    """Per-net checkpoint files stacked into ensemble trees (leading axis:
    the net), as the JAX package's load_ensemble_params."""
    loaded = [load_net(p) for p in paths]
    return {"params": _stack([t["params"] for t in loaded]),
            "batch_stats": _stack([t["batch_stats"] for t in loaded])}
