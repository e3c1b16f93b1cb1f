"""Kernel `csrc/wfa_forward_backward.cu` (the graph WFA of dual mode on the
card): its device time a job, in ms, from the profiler's trace."""

from __future__ import annotations


def read(record) -> float | None:
    seconds = sum(s for name, s in record.trace.device_s.items()
                  if "wfa_kernel" in name)
    if seconds <= 0 or not record.jobs:
        return None
    return 1e3 * seconds / len(record.jobs)
