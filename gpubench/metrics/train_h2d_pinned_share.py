"""The share of the training loop's host-to-device bytes that left from
page-locked buffers on a copy stream, %: the port's tally
``train.h2d_pinned_bytes`` over ``train.h2d_bytes`` over the traced window.
Read where the driver put the port's tallies in the layer's readings and
the window copied something; a program without the pinned tally reads
nothing."""

LAYER = "Training loop"
SOURCE = "program_counter"
UNIT = "%"
BETTER = "higher"
MOVES = "train_net_examples_per_s"


def read(layer: dict):
    tallies = (layer.get("train") or {}).get("tallies") or {}
    total = tallies.get("train.h2d_bytes")
    pinned = tallies.get("train.h2d_pinned_bytes")
    if not total or pinned is None:
        return None
    return 100.0 * pinned / total
