"""Condvar-guarded latest-value cell for realtime producer/consumer links
(own copy of pilotguru_tpu/utils/latest_value.py; no torch needed).

The reference's threading_helpers.SynchronizedTimestampedValue
(python/threading_helpers.py:3-27) and the single-slot case of
TimestampedHistory::wait_get_next (include/car/timestamped_history.hpp):
a producer overwrites the cell, consumers block until a value NEWER than
the one they last saw appears. Stale values are dropped by construction,
the input-side analog of the CONFLATE socket on the prediction wire.
"""

from __future__ import annotations

import threading
from typing import Any, Optional, Tuple


class SynchronizedLatestValue:
    """Single-slot latest-value cell with monotonically increasing ids."""

    def __init__(self):
        self._cond = threading.Condition()
        self._value: Any = None
        self._update_id = 0

    def set(self, value) -> int:
        """Publish a new value; wakes all waiting consumers."""
        with self._cond:
            self._value = value
            self._update_id += 1
            self._cond.notify_all()
            return self._update_id

    def get_next(
        self, prev_update_id: int = 0, timeout: Optional[float] = None
    ) -> Tuple[Any, int]:
        """Block until an update newer than ``prev_update_id`` exists.

        Returns (value, update_id); on timeout returns (None,
        prev_update_id), so callers loop on the id without special cases."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._update_id > prev_update_id, timeout=timeout
            ):
                return None, prev_update_id
            return self._value, self._update_id

    def latest(self) -> Tuple[Any, int]:
        """Non-blocking read of the current value (None if never set)."""
        with self._cond:
            return self._value, self._update_id
