"""Kahan compensated summation (own numpy copy of
pilotguru_tpu/utils/kahan.py).

The reference accumulates the forward-axis velocity sum with a KahanSum
(include/math/math.hpp:8-25) because it adds hundreds of thousands of
float64 terms one after another. The port's pipelines reduce on the device
instead; this utility serves host loops that do add sequentially.
"""

from __future__ import annotations

import numpy as np


class KahanSum:
    """Compensated accumulator for scalars or numpy arrays (float64)."""

    def __init__(self, zero=0.0):
        self._sum = np.asarray(zero, dtype=np.float64).copy()
        self._compensation = np.zeros_like(self._sum)

    def add(self, value) -> "KahanSum":
        y = np.asarray(value, dtype=np.float64) - self._compensation
        t = self._sum + y
        self._compensation = (t - self._sum) - y
        self._sum = t
        return self

    @property
    def sum(self):
        return self._sum.copy()


def kahan_sum(values, axis=0):
    """Compensated reduction of an array along ``axis`` (numpy, float64)."""
    values = np.asarray(values, np.float64)
    acc = KahanSum(np.zeros(np.delete(values.shape, axis)))
    for i in range(values.shape[axis]):
        acc.add(np.take(values, i, axis=axis))
    return acc.sum
