"""Sequence pretty-printing for log lines (copied from
pilotguru_tpu/utils/strings.py).

Parity with the reference's ``logging/strings`` header
(the reference's include/logging/strings.hpp:8-20), which stream-formats a
``std::vector`` as ``{a, b, c}`` for CHECK/LOG messages. Python's ``list``
repr differs (square brackets, quoted strings), so CLIs that mirror
reference log output format through this helper instead.
"""

from __future__ import annotations

from typing import Iterable


def format_sequence(values: Iterable) -> str:
    """Format an iterable as ``{a, b, c}`` (reference operator<< layout)."""
    return "{" + ", ".join(str(v) for v in values) + "}"
