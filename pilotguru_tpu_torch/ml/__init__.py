"""Steering models: the net zoo, checkpoints and ensemble inference."""
