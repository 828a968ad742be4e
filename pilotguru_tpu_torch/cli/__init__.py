"""Port of the matching pilotguru_tpu package (see pilotguru_tpu_torch/__init__.py)."""
