"""The solver: the host waiting on a beam batch (parallel/orchestrator.py BatchedDeviceSolver._materialize, sharding.gather_chunks), seconds a job on the main thread; span solve.beam_wait."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("solve.beam_wait",))
