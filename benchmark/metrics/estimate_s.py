"""The solver: the --stats-file estimated_cost sweep (parallel/orchestrator.py _stats_from_beam, astar.calculate_astar_heuristic), seconds a job on the main thread; span solve.estimate."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _span import mean_span  # noqa: E402


def read(record) -> float | None:
    return mean_span(record, ("solve.estimate",))
