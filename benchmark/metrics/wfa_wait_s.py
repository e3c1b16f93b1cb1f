"""Host prepare: the device WFA's waits, for the scratch lock and for each rung's results from the card, seconds a job summed over the prepare threads; spans wfa.scratch_lock and wfa.device_wait."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("wfa.scratch_lock", "wfa.device_wait"))
