"""PilotNet's model FLOPs over the traced window's wall time against the
card's float32 peak, %: forward multiply-adds counted from the layer
shapes, times 3 for the forward and backward passes, times the
net-examples the window trained."""

from gpubench import workmodel

LAYER = "Whole train step"
SOURCE = "host_clock"
UNIT = "%"
BETTER = "higher"
MOVES = "train_net_examples_per_s"


def read(layer: dict):
    train = layer.get("train")
    if not train or train["trace"] is None:
        return None
    rate = train["net_examples"] * train["flops_per_net_example"] / train["window_s"]
    return 100.0 * rate / workmodel.PEAK_FP32_PER_S
