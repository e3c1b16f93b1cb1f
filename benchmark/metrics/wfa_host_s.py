"""Host prepare: the device WFA's host side around its launches (align/wfa_device.py align_pairs_device: linearising and packing, each rung's sizing, launches and unpacking), seconds a job summed over the prepare threads; span wfa.ladder less its waits wfa.scratch_lock and wfa.device_wait."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("wfa.ladder",),
                     ("wfa.scratch_lock", "wfa.device_wait"))
