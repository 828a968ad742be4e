"""Device ms a train step: the union of device busy intervals over the
traced window (whole epochs) over the steps it ran."""

LAYER = "Train step kernels"
SOURCE = "device_trace"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_net_examples_per_s"


def read(layer: dict):
    train = layer.get("train")
    if not train or train["trace"] is None or not train["steps"]:
        return None
    return 1e3 * train["trace"].busy_s / train["steps"]
