"""The device: the share of the traced window, in %, in which no kernel,
copy or set ran on the card (1 - the union of the CUDA intervals over the
window, the arithmetic of chip_smoke.py's profiled)."""

from __future__ import annotations


def read(record) -> float | None:
    t = record.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
