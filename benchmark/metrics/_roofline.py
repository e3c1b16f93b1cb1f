"""Shared by the beam kernels' roofline shares: the least time of the work
the window's blocks need (``roofline.block_bound_ms`` over every solved
block of every job's --stats-file, at the configured width) over the
profiler's device time of the kernel's launches in the window, in %."""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from roofline import block_bound_ms  # noqa: E402


def stats_rows(out_dir: str):
    with open(os.path.join(out_dir, "stats.tsv")) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            yield dict(zip(header, line.rstrip("\n").split("\t")))


def device_seconds(record, kernel: str) -> float:
    return sum(s for name, s in record.trace.device_s.items()
               if kernel in name)


def share(record, kernel: str, symbol: str) -> float | None:
    seconds = device_seconds(record, symbol)
    if seconds <= 0:
        return None
    width = int(record.cell.flags["--phase-min-queue-size"])
    bound_ms = 0.0
    for job in record.jobs:
        for row in stats_rows(job["out_dir"]):
            if row["num_alleles"]:
                bound_ms += block_bound_ms(kernel, int(row["num_variants"]),
                                           int(row["num_alleles"]), width)
    return 100.0 * bound_ms / 1e3 / seconds
