"""Port of the matching pilotguru_tpu package (see pilotguru_tpu_torch/__init__.py),
with the names it exports and the helpers the port's sharded paths use."""

from pilotguru_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    block_bounds,
    cuda_devices,
    gather_leading_axis,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_leading_axis,
)
