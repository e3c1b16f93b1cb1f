"""The traced window: torch.profiler over CPU and CUDA activity, reduced to
what the per-layer metrics and the breakdown read.

The union of the device's intervals against the traced window is the frozen
arithmetic of ``chip_smoke.py::profiled``. The benchmark marks its own spans
in the trace with ``record_function`` ("bench.window", "bench.job <i>"),
so that each idle gap of the device is labelled by the job it fell in and
the profiler's host op in progress then. The profiler also records each
such span as a range on the device; those ranges are not device work.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

WINDOW_SPAN = "bench.window"
JOB_SPAN = "bench.job"


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    # device time by name: kernel, copy or set
    device_s: dict[str, float] = field(default_factory=dict)
    device_calls: dict[str, int] = field(default_factory=dict)
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)


def profiler(enabled: bool):
    if not enabled:
        return contextlib.nullcontext(None)
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span(name: str, enabled: bool):
    if not enabled:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def _union(intervals):
    """Merged, sorted device intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof, top: int = 10) -> Trace:
    """Device busy time, device time by name and the longest idle gaps of
    the window marked ``WINDOW_SPAN`` (times in the profiler's µs)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, jobs = [], [], []
    window = None
    t = Trace()
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == cuda and not e.name.startswith("bench."):
            device.append((a, b))
            t.device_s[e.name] = t.device_s.get(e.name, 0.0) + (b - a) / 1e6
            t.device_calls[e.name] = t.device_calls.get(e.name, 0) + 1
        elif e.device_type == cuda:
            continue  # the GPU-side range of a benchmark span
        elif e.name == WINDOW_SPAN:
            window = (a, b)
        elif e.name.startswith(JOB_SPAN):
            jobs.append((a, b, e.name[len("bench."):]))
        else:
            host.append((a, b, e.name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    merged = [[max(a, w0), min(b, w1)] for a, b in _union(device)
              if b > w0 and a < w1]
    t.window_s = (w1 - w0) / 1e6
    t.busy_s = sum(b - a for a, b in merged) / 1e6
    gaps, cursor = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    for g0, g1 in gaps[:top]:
        mid = (g0 + g1) / 2
        where = next((n for a, b, n in jobs if a <= mid <= b), "between jobs")
        # the innermost host op in progress: the latest to start of those
        # that cover the gap's middle
        op = None
        for a, b, n in host:
            if a > mid:
                break
            if b >= mid:
                op = n
        t.idle_gaps.append((f"{where}: {op or 'no torch op'}",
                            (g1 - g0) / 1e6))
    return t


def breakdown(t: Trace, top: int = 10) -> dict:
    ops = sorted(t.device_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in t.idle_gaps[:top]]}
