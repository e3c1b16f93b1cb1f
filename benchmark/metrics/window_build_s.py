"""Host prepare, dual mode on the device WFA: pass 1 of global_realign._load_full_read_segments_device (fetch every read, build its window graph), seconds a job summed over the prepare threads; span prepare.windows."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("prepare.windows",))
