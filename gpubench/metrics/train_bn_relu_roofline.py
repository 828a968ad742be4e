"""The fused batch norm + ReLU pair's share of its memory roofline over the
traced window, %: the bytes the pair must move a train step (at every
train-mode batch norm, x and the upstream gradient read once, y and dx
written once; counted from the configuration's layer shapes by the
driver) times the window's steps, at the card's 3.35 TB/s, over the
device seconds of the pair's kernels in the trace. Read where the window
ran the pair (the port's ``folded.bn_fused`` tally)."""

import re

from gpubench import workmodel

LAYER = "Train step kernels"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "higher"
MOVES = "train_net_examples_per_s"

KERNELS = re.compile(r"\bbn_(stats|apply)_kernel\b")


def read(layer: dict):
    train = layer.get("train")
    if (not train or train["trace"] is None or not train.get("tallies", {}).get("folded.bn_fused")
            or not train["steps"]):
        return None
    seconds = sum(s for name, (_, s) in train["trace"].by_name.items() if KERNELS.search(name))
    if not seconds:
        return None
    bound_s = train["bn_relu_bytes_per_step"] * train["steps"] / workmodel.PEAK_BYTES_PER_S
    return 100.0 * bound_s / seconds
