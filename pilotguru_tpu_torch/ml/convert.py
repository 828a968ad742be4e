"""Weights across the two packages: a flax variables tree of numpy arrays
({"params": ..., "batch_stats": ...}, as the JAX package's checkpoints hold
it) <-> a net of ``ml/models.py``.

Names: flax's ``ConvBlock_i/Conv_0``, ``ConvBlock_i/BatchNorm_0``,
``FcBlock_i/Dense_0``, ``FcBlock_i/BatchNorm_0``, ``Dense_i`` and
``LinearBias_i/Dense_0`` are the port's ``conv_blocks[i].layer``,
``conv_blocks[i].bn``, ``fc_blocks[i].layer``, ``fc_blocks[i].bn``,
``denses[i]`` and ``linear_biases[i].dense``. Layouts: a conv kernel is
HWIO in flax and OIHW in torch, a dense kernel (in, out) and a torch
weight (out, in); batch norm's scale / bias are weight / bias, its
batch_stats mean / var are running_mean / running_var. The first dense
layer needs no permutation: the port flattens in flax's (H, W, C) order.

The training state (ml/training.py) keeps the flax names and layouts in
stacked ``[N, ...]`` tensors: ``ensemble_from_flax`` / ``ensemble_to_flax``
carry it across, and ``module_tensors`` hands one net of it to a module.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from pilotguru_tpu_torch.ml import models


def _layers(net: models._ImageNetBase) -> Iterator[Tuple[str, nn.Module, str]]:
    """(flax path, port module, kind) for every layer with parameters:
    kind is "conv", "dense" or "bn"."""
    for i, block in enumerate(net.conv_blocks):
        yield f"ConvBlock_{i}/Conv_0", block.layer, "conv"
        if block.bn is not None:
            yield f"ConvBlock_{i}/BatchNorm_0", block.bn, "bn"
    for i, block in enumerate(net.fc_blocks):
        yield f"FcBlock_{i}/Dense_0", block.layer, "dense"
        if block.bn is not None:
            yield f"FcBlock_{i}/BatchNorm_0", block.bn, "bn"
    for i, dense in enumerate(net.denses):
        yield f"Dense_{i}", dense, "dense"
    for i, bias in enumerate(net.linear_biases):
        yield f"LinearBias_{i}/Dense_0", bias.dense, "dense"


def _get(tree: dict, path: str) -> dict:
    node = tree
    for part in path.split("/"):
        if part not in node:
            raise KeyError(f"flax tree has no {path} (missing {part})")
        node = node[part]
    return node


def _put(tree: dict, path: str, leaves: dict) -> None:
    node = tree
    for part in path.split("/"):
        node = node.setdefault(part, {})
    node.update(leaves)


def _copy(target: torch.Tensor, array) -> None:
    """``target`` <- the flax array (same shape, float32)."""
    array = np.asarray(array, np.float32)
    if array.shape != tuple(target.shape):
        raise ValueError(f"flax array of shape {array.shape}, want {tuple(target.shape)}")
    target.copy_(torch.from_numpy(array.copy()))


@torch.no_grad()
def load_flax_variables(net: models._ImageNetBase, variables: Dict) -> None:
    """Copy a flax variables tree into ``net`` (in place). Every flax leaf
    must find its layer and every layer its leaves."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    used = set()
    for path, layer, kind in _layers(net):
        p = _get(params, path)
        used.add(path)
        if kind == "conv":
            _copy(layer.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
            _copy(layer.bias, p["bias"])
        elif kind == "dense":
            _copy(layer.weight, np.asarray(p["kernel"]).T)
            if layer.bias is not None:
                _copy(layer.bias, p["bias"])
        else:
            s = _get(stats, path)
            _copy(layer.weight, p["scale"])
            _copy(layer.bias, p["bias"])
            _copy(layer.running_mean, s["mean"])
            _copy(layer.running_var, s["var"])
    extra = set(_layer_paths(params)) - used
    if extra:
        raise KeyError(f"flax tree holds layers the net lacks: {sorted(extra)}")


def _layer_paths(node: dict, prefix: str = "") -> Iterator[str]:
    """The paths of a flax tree's layers: the dicts that hold arrays."""
    for key, value in node.items():
        if any(isinstance(v, dict) for v in value.values()):
            yield from _layer_paths(value, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}"


def _np(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().float().numpy()


def flax_variables(net: models._ImageNetBase) -> Dict:
    """``net``'s weights as a flax variables tree of float32 numpy arrays,
    the layout the JAX package's ``save_net`` writes."""
    params, stats = {}, {}
    for path, layer, kind in _layers(net):
        if kind == "conv":  # OIHW -> HWIO
            leaves = {"kernel": np.ascontiguousarray(_np(layer.weight).transpose(2, 3, 1, 0)),
                      "bias": _np(layer.bias)}
        elif kind == "dense":
            leaves = {"kernel": np.ascontiguousarray(_np(layer.weight).T)}
            if layer.bias is not None:
                leaves["bias"] = _np(layer.bias)
        else:
            leaves = {"scale": _np(layer.weight), "bias": _np(layer.bias)}
            _put(stats, path, {"mean": _np(layer.running_mean), "var": _np(layer.running_var)})
        _put(params, path, leaves)
    return {"params": params, "batch_stats": stats}


def module_tensors(net: models._ImageNetBase, params: Dict, batch_stats: Dict) -> Dict:
    """One net's flax-layout tensors (a slice of the training state's
    stacked trees) as ``net``'s parameter and buffer names, for
    ``torch.func.functional_call``: the layouts are transposed by views, so
    gradients reach the flax-layout tensors, and the batch statistics are
    the given tensors themselves, so a train-mode forward updates them in
    place."""
    names = {id(t): name for name, t in
             itertools.chain(net.named_parameters(), net.named_buffers())}
    out = {}
    for path, layer, kind in _layers(net):
        p = _get(params, path)
        if kind == "conv":
            out[names[id(layer.weight)]] = p["kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
            out[names[id(layer.bias)]] = p["bias"]
        elif kind == "dense":
            out[names[id(layer.weight)]] = p["kernel"].t()
            if layer.bias is not None:
                out[names[id(layer.bias)]] = p["bias"]
        else:
            s = _get(batch_stats, path)
            out[names[id(layer.weight)]] = p["scale"]
            out[names[id(layer.bias)]] = p["bias"]
            out[names[id(layer.running_mean)]] = s["mean"]
            out[names[id(layer.running_var)]] = s["var"]
    return out


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ensemble_from_flax(params: Dict, batch_stats: Dict, device="cpu"):
    """The JAX package's stacked ``EnsembleState.params`` / ``batch_stats``
    (numpy, or anything numpy reads; leading axis the net) as the port's
    stacked float32 tensors on ``device``: the same names and layouts."""
    def put(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return tree_map(put, params), tree_map(put, batch_stats)


def ensemble_to_flax(params: Dict, batch_stats: Dict):
    """The port's stacked training state as the JAX package's: nested dicts
    of float32 numpy arrays, leading axis the net."""
    return tree_map(_np, params), tree_map(_np, batch_stats)
