"""Shared by the span metrics: the mean over the window's jobs of sums of
the program's span totals, ``cli.LAST_RUN_STATS["spans"]`` (``{name:
{"wall": s, "cpu": s, "n": count}}``, summed over threads), which
``cli.main`` rewrites at the end of each job. A job whose stats have no
``spans`` (a program without them) gives nothing; a span that a job with
spans never opened counts 0 s."""

from __future__ import annotations


def mean_span(record, add: tuple[str, ...], sub: tuple[str, ...] = (),
              field: str = "wall") -> float | None:
    """Mean over the jobs of Σ ``add`` − Σ ``sub`` of the spans' ``field``
    (``wall`` or ``cpu``), in seconds; None when no job has spans."""
    values = []
    for job in record.jobs:
        spans = job["stats"].get("spans")
        if spans is None:
            continue

        def total(names):
            return sum(spans.get(n, {}).get(field, 0.0) for n in names)

        values.append(total(add) - total(sub))
    return sum(values) / len(values) if values else None
