"""Steering models: the net zoo, checkpoints and ensemble inference.
It re-exports the names of the matching pilotguru_tpu package."""

from pilotguru_tpu_torch.ml import augmentation, data, models, training, weighting  # noqa: F401
