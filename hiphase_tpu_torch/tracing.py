"""Spans of one run: where a job's time goes, on every thread of the run.

`cli.main` makes one `Recorder` a run and passes it to the code it times:
block generation, the prepare pool and the device WFA's host side and
waits, the wait for prepared blocks, the solver and its ``estimated_cost``
sweep, the writer thread. A span is opened per block, per band-ladder rung
or per solver call, never per read, so a job records tens of spans.

A span records its name, the thread, its wall time, the thread's CPU time
(``time.thread_time_ns``: a span whose CPU time is well under its wall time
waited, on the interpreter lock, a lock or the device) and its parent, the
span enclosing it on the same thread. The recorder keeps two things:

* totals by name, always: ``{name: {"wall": s, "cpu": s, "n": count}}``,
  summed over threads;
* with ``log``, every span's interval as ``[name, thread, start_ns,
  end_ns, parent]``, stamped on ``CLOCK_REALTIME`` (``time.time_ns``), the
  clock on which torch.profiler stamps its events, so that a span and a
  profiled op or device interval compare with no offset. The profiler
  records the ops of the thread that started it only; the log holds every
  thread's spans.

The recorder opens no profiler range (no ``record_function``, no NVTX): a
traced device timeline holds exactly the work of the program.
"""

from __future__ import annotations

import contextlib
import threading
import time

# the clock of the interval log: that of torch.profiler's events
CLOCK = "CLOCK_REALTIME"


class Recorder:
    """Spans of one run, from any thread; ``log`` keeps their intervals."""

    def __init__(self, log: bool = False):
        self._lock = threading.Lock()
        self._totals: dict[str, list[int]] = {}   # name → [wall, cpu, n] ns
        self._local = threading.local()           # each thread's open spans
        self._log: list[list] | None = [] if log else None

    def span(self, name: str) -> _Span:
        """A context manager that records the time inside it as ``name``."""
        return _Span(self, name)

    def _stack(self) -> list[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, wall: int, cpu: int, entry) -> None:
        with self._lock:
            t = self._totals.get(name)
            if t is None:
                self._totals[name] = [wall, cpu, 1]
            else:
                t[0] += wall
                t[1] += cpu
                t[2] += 1
            if entry is not None:
                self._log.append(entry)

    def totals(self) -> dict:
        with self._lock:
            return {name: {"wall": w / 1e9, "cpu": c / 1e9, "n": n}
                    for name, (w, c, n) in sorted(self._totals.items())}

    def trace(self) -> dict | None:
        """The interval log, in the order the spans ended; None without
        ``log``."""
        if self._log is None:
            return None
        with self._lock:
            return {"clock": CLOCK, "spans": [list(e) for e in self._log]}

    def summary(self) -> str:
        """The totals on one line: name wall/cpu s ×n."""
        return ", ".join(f"{name} {t['wall']:.3f}/{t['cpu']:.3f} s ×{t['n']}"
                         for name, t in self.totals().items())


class _Span:
    __slots__ = ("rec", "name", "parent", "w0", "c0", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self) -> _Span:
        stack = self.rec._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if self.rec._log is not None:
            self.t0 = time.time_ns()
        self.c0 = time.thread_time_ns()
        self.w0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        wall = time.perf_counter_ns() - self.w0
        cpu = time.thread_time_ns() - self.c0
        entry = None
        if self.rec._log is not None:
            entry = [self.name, threading.current_thread().name, self.t0,
                     time.time_ns(), self.parent]
        self.rec._stack().pop()
        self.rec._add(self.name, wall, cpu, entry)


class _Off(Recorder):
    """The recorder of code that nobody times: its spans record nothing."""

    _NULL = contextlib.nullcontext()

    def span(self, name: str):
        return self._NULL


OFF = _Off()
