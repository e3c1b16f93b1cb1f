"""The batched device solver (parallel/orchestrator.py BatchedDeviceSolver and the beam chain): seconds a job on the main thread, submit and drain."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _stage import mean_stage  # noqa: E402


def read(record) -> float | None:
    return mean_stage(record, "solve")
