"""The port's device-list helpers (pilotguru_tpu_torch/parallel/mesh.py)
against the JAX package's (pilotguru_tpu/parallel/mesh.py), on the CPU,
where tests/conftest.py gives JAX 8 virtual devices:

- make_mesh raises the JAX package's error when the sizes do not cover the
  devices, and pad_to_multiple is the JAX package's;
- shard_leading_axis's blocks are the index ranges of the JAX arrays'
  addressable shards where the length divides, on a one-axis and a
  two-axis mesh; where it does not, the blocks are contiguous, in order,
  never padded, and differ in length by at most one;
- replicate and gather_leading_axis round-trip a tree of dicts, tuples
  and NamedTuples;
- cuda_devices lists the visible cards and raises when there is none.
"""

from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pilotguru_tpu.parallel import mesh as jax_mesh
from pilotguru_tpu_torch import parallel
from pilotguru_tpu_torch.parallel import mesh

CPU = torch.device("cpu")


class Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


def test_exports_the_jax_names():
    for name in ("make_mesh", "pad_to_multiple", "shard_leading_axis", "replicate"):
        assert callable(getattr(parallel, name))


@pytest.mark.parametrize("names, sizes", [(("windows",), (3,)), (("a", "b"), (2, 3)),
                                          (("data",), [5])])
def test_make_mesh_raises_as_the_jax_package_does(names, sizes):
    devices = jax.devices()
    assert len(devices) == 8
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(names, sizes, devices)
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(names, sizes, [CPU] * len(devices))
    assert str(got.value) == str(want.value)


def test_make_mesh_defaults_put_every_device_on_the_first_axis():
    m = mesh.make_mesh(("ensemble", "data"), None, ["cpu"] * 4)
    j = jax_mesh.make_mesh(("ensemble", "data"), None, jax.devices()[:4])
    assert m.shape == dict(j.shape) == {"ensemble": 4, "data": 1}
    assert m.size == j.size == 4 and m.devices == (CPU,) * 4


@pytest.mark.parametrize("shape, multiple, axis", [((7, 3), 4, 0), ((8, 3), 4, 0),
                                                   ((2, 5), 3, 1), ((0,), 2, 0)])
def test_pad_to_multiple_is_the_jax_packages(shape, multiple, axis):
    array = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1
    want, want_n = jax_mesh.pad_to_multiple(array, multiple, axis)
    got, got_n = mesh.pad_to_multiple(array, multiple, axis)
    assert got_n == want_n
    np.testing.assert_array_equal(got, want)


def _jax_rows(array, sharding):
    """Per device of the sharding's mesh (in mesh order), the rows its
    addressable shard holds, as a (lo, hi) range."""
    placed = jax.device_put(array, sharding)
    by_device = {s.device: s.index[0] for s in placed.addressable_shards}
    ranges = []
    for device in sharding.mesh.devices.flat:
        rows = by_device[device]
        ranges.append((rows.start or 0, array.shape[0] if rows.stop is None else rows.stop))
    return ranges


@pytest.mark.parametrize("length", [8, 16, 40])
def test_blocks_are_the_jax_shards_where_the_length_divides(length):
    array = np.arange(length * 3, dtype=np.float32).reshape(length, 3)
    jm = jax_mesh.make_mesh(("windows",), (8,), jax.devices())
    want = _jax_rows(array, NamedSharding(jm, P("windows")))
    assert mesh.block_bounds(length, 8) == want
    shards = mesh.shard_leading_axis({"x": array}, mesh.make_mesh(("windows",), (8,),
                                                                   [CPU] * 8), "windows")
    for (lo, hi), shard in zip(want, shards):
        np.testing.assert_array_equal(shard["x"].numpy(), array[lo:hi])


def test_blocks_on_a_two_axis_mesh_are_the_jax_shards():
    array = np.arange(12 * 2, dtype=np.int64).reshape(12, 2)
    jm = jax_mesh.make_mesh(("a", "b"), (2, 4), jax.devices())
    m = mesh.make_mesh(("a", "b"), (2, 4), [CPU] * 8)
    for axis in ("a", "b"):
        want = _jax_rows(array, NamedSharding(jm, P(axis)))
        got = mesh.shard_leading_axis(array, m, axis)
        assert len(got) == 8
        for (lo, hi), shard in zip(want, got):
            np.testing.assert_array_equal(shard.numpy(), array[lo:hi])


@pytest.mark.parametrize("length, parts", [(10, 3), (7, 8), (3, 2), (150, 8), (5, 5), (0, 3)])
def test_uneven_blocks_are_contiguous_and_differ_by_at_most_one(length, parts):
    bounds = mesh.block_bounds(length, parts)
    assert len(bounds) == parts and bounds[0][0] == 0 and bounds[-1][1] == length
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)
    array = torch.arange(length)
    shards = mesh.shard_leading_axis(array, mesh.make_mesh(("x",), None, [CPU] * parts), "x")
    assert torch.equal(mesh.gather_leading_axis(shards, CPU), array)


def test_shard_replicate_and_gather_keep_the_tree():
    rng = np.random.default_rng(0)
    tree = {"p": Pair(torch.as_tensor(rng.normal(size=(6, 2, 3))), torch.arange(6)),
            "opt": {"count": torch.zeros(6, dtype=torch.int32)}, "lr": rng.random(6)}
    m = mesh.make_mesh(("ensemble",), None, ["cpu"] * 3)
    shards = mesh.shard_leading_axis(tree, m, "ensemble")
    assert [s["p"].b.tolist() for s in shards] == [[0, 1], [2, 3], [4, 5]]
    assert isinstance(shards[1]["p"], Pair)
    back = mesh.gather_leading_axis(shards, CPU)
    assert torch.equal(back["p"].a, tree["p"].a) and torch.equal(back["p"].b, tree["p"].b)
    assert back["opt"]["count"].dtype == torch.int32
    np.testing.assert_array_equal(back["lr"].numpy(), tree["lr"])
    copies = mesh.replicate(tree, m)
    assert len(copies) == 3
    for copy in copies:
        assert torch.equal(copy["p"].a, tree["p"].a)
        np.testing.assert_array_equal(copy["lr"].numpy(), tree["lr"])


def test_shard_leading_axis_refuses_what_has_no_common_leading_axis():
    m = mesh.make_mesh(("x",), None, ["cpu"] * 2)
    with pytest.raises(ValueError, match="scalar"):
        mesh.shard_leading_axis({"a": torch.tensor(1.0)}, m, "x")
    with pytest.raises(ValueError, match="lengths"):
        mesh.shard_leading_axis((torch.zeros(4), torch.zeros(5)), m, "x")
    with pytest.raises(ValueError, match="no axis"):
        mesh.shard_leading_axis(torch.zeros(4), m, "y")


def test_cuda_devices_lists_the_visible_cards_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert mesh.cuda_devices() == [torch.device("cuda", i) for i in range(3)]
    assert mesh.make_mesh(("windows",)).devices == tuple(mesh.cuda_devices())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.cuda_devices()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.cuda_devices()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(("windows",))
