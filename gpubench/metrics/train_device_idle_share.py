"""The share of the traced training window (whole epochs, validation and
checkpoints included) in which nothing ran on the device, %: one minus the
union of kernel and copy intervals over the window's wall time."""

LAYER = "Training loop"
SOURCE = "device_trace"
UNIT = "%"
BETTER = "lower"
MOVES = "train_net_examples_per_s"


def read(layer: dict):
    train = layer.get("train")
    if not train or train["trace"] is None or not train["trace"].window_s:
        return None
    return 100.0 * (1.0 - train["trace"].busy_s / train["trace"].window_s)
