"""Host ms a train step inside the port's ``train.step`` spans (the step's
dispatch: forward, backward and update enqueued, and any wait for the
device within), over the traced window's steps."""

LAYER = "Train step dispatch"
SOURCE = "program_span"
UNIT = "ms"
BETTER = "lower"
MOVES = "train_net_examples_per_s"


def read(layer: dict):
    train = layer.get("train")
    if not train or not train.get("step_spans") or not train["steps"]:
        return None
    return sum(end - start for start, end in train["step_spans"]) / 1e6 / train["steps"]
