"""Block generation (phasing/block_gen.py): seconds a job, on the thread that pulls blocks."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _stage import mean_stage  # noqa: E402


def read(record) -> float | None:
    return mean_stage(record, "block_gen")
