"""Host prepare (allele assignment; in dual mode with global realignment through the graph WFA): seconds a job, summed over the prepare threads."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _stage import mean_stage  # noqa: E402


def read(record) -> float | None:
    return mean_stage(record, "prepare")
