"""The pipeline: the main thread waiting on the prepare pool for the next prepared block (parallel/orchestrator.py iter_prepared), seconds a job; span prepared_wait."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("prepared_wait",))
