"""Kernel `csrc/beam_select.cu`: its share of the roofline, in %: the least time
of the beam's work that the window's blocks need, over the device time of
its launches in the window."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _roofline import share  # noqa: E402


def read(record) -> float | None:
    return share(record, "beam_select", "beam_select_kernel")
