"""Per-example training-weight policies (copied from
pilotguru_tpu/ml/weighting.py, which imports no JAX; the port keeps its own
copy).

The reference's python/sample_weighting.py, as host-side numpy state
(the weight tables are indexed by global example id and updated from
per-example losses each step, which is cheap scatter work the host does
while the device runs the next step).
"""

from __future__ import annotations

import numpy as np

NAME = "name"
UNIFORM = "uniform"
LABEL_L1 = "label_l1"
EXP_RECENT_LOSS = "exp_recent_loss"

LABEL_L1_WEIGHT_SCALE = "label_l1_weight_scale"
RECENT_LOSS_LR = "recent_loss_lr"
RECENT_LOSS_EXP_SCALE = "recent_loss_exp_scale"
RAW_WEIGHT_CLIP = "raw_weight_clip"


class UniformWeighter:
    def get_weights(self, indices):
        return np.ones(np.asarray(indices).shape, dtype=np.float32)

    def register_losses(self, indices, losses):
        pass

    def step(self):
        pass


class LabelL1Weighter:
    """Weight proportional to |label|, normalized to mean 1
    (sample_weighting.py:28-48)."""

    def __init__(self, extra_weight_scale, labels):
        labels = np.asarray(labels)
        if extra_weight_scale < 0:
            raise ValueError("extra_weight_scale must be >= 0")
        self.weights = np.abs(labels) * extra_weight_scale + 1.0
        self.weights /= np.sum(self.weights.astype(np.float64)) / labels.size

    def get_weights(self, indices):
        return self.weights[np.asarray(indices)].astype(np.float32)

    def register_losses(self, indices, losses):
        pass

    def step(self):
        pass


class ExpRecentLossWeighter:
    """AdaBoost-ish exp(EMA loss) weights, clipped + normalized per epoch
    (sample_weighting.py:50-81)."""

    def __init__(self, num_samples, recent_loss_lr, loss_scale, max_raw_weight_clip):
        if num_samples <= 0 or recent_loss_lr < 0 or loss_scale < 0:
            raise ValueError("invalid ExpRecentLossWeighter parameters")
        if max_raw_weight_clip < 1.0:
            raise ValueError("max_raw_weight_clip must be >= 1.0")
        self.total_losses = np.zeros([num_samples], dtype=np.float64)
        self.lr = recent_loss_lr
        self.loss_scale = loss_scale
        self.max_raw_weight_clip = max_raw_weight_clip
        self.weights = np.ones([num_samples], dtype=np.float32)
        self.step()

    def get_weights(self, indices):
        return self.weights[np.asarray(indices)]

    def register_losses(self, indices, losses):
        indices = np.asarray(indices)
        self.total_losses[indices] *= 1.0 - self.lr
        self.total_losses[indices] += np.asarray(losses) * self.lr

    def step(self):
        raw = np.exp(self.loss_scale * self.total_losses)
        clipped = np.clip(raw, 1.0, self.max_raw_weight_clip)
        self.weights = (clipped / (np.sum(clipped) / clipped.size)).astype(
            np.float32
        )


def make_sample_weighter(options, labels):
    """Factory matching MakeSampleWeighter (sample_weighting.py:83-95)."""
    name = options[NAME]
    if name == UNIFORM:
        return UniformWeighter()
    if name == LABEL_L1:
        return LabelL1Weighter(options[LABEL_L1_WEIGHT_SCALE], labels)
    if name == EXP_RECENT_LOSS:
        return ExpRecentLossWeighter(
            num_samples=np.asarray(labels).shape[0],
            recent_loss_lr=options[RECENT_LOSS_LR],
            loss_scale=options[RECENT_LOSS_EXP_SCALE],
            max_raw_weight_clip=options[RAW_WEIGHT_CLIP],
        )
    raise ValueError(f"Unknown weighter name: {name}")
