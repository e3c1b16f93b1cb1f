"""Shared by the stage metrics: the mean over the window's jobs of one stage
of the program's ``cli.LAST_RUN_STATS["stage_seconds"]``, which
``cli.main`` rewrites at the end of each job."""

from __future__ import annotations


def mean_stage(record, stage: str) -> float | None:
    values = [j["stats"].get("stage_seconds", {}).get(stage)
              for j in record.jobs]
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None
