"""Host prepare: the prepare threads' own CPU time (time.thread_time_ns) in span prepare, seconds a job summed over the threads. Against prepare_s, the difference is time the threads waited: the interpreter lock, the scratch lock, the card."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("prepare",), field="cpu")
