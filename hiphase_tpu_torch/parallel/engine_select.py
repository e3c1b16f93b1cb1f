"""Engine selection for the torch port.

``--engine auto`` with devices rates the device engine against the host
rung on one seeded in-memory batch shaped like the local bench
configuration (`rating_workload`): the device engine
(`BatchedDeviceSolver` at the run's widths, through submit and drain) on
the whole batch, and the native C++ beam at the run's thread count or,
when the native library does not load, the host A* oracle, each on the
batch's first blocks, its rate scaled per het. The device wins only when
its rate in hets/s beats the host rung's by RATE_MARGIN. Without devices
(no CUDA device and none given) the choice is the native C++ beam when its
library loads, else the host A* oracle, and nothing is rated. An explicit
engine is never rated.

The rates are a property of the hardware and the code, not of the moment,
so they are kept in a JSON file (`choose_engine`'s ``rate_cache``; the
CLI's default is DEFAULT_RATE_CACHE) for RATE_CACHE_TTL seconds, under a
key of everything that sets them (`rate_cache_key`). A hit skips the
rating; with a ``cuda`` verdict the kernels are still built.

`BackgroundChoice` runs `choose_engine` on a thread of its own, and
`DeferredUpgradeSolver` starts the run on the native beam at once and
moves to the device engine at the first block after a ``cuda`` verdict:
the engines give the same bytes, so the switch changes no output. An
error of the kernel build or of the rating ends the run; at the end of
the run a rating still going is stopped between passes and joined.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections.abc import Sequence
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from hiphase_tpu_torch.io import native

logger = logging.getLogger(__name__)

ENGINES = ("auto", "cuda", "native", "astar")

# the device engine must beat the host rung's rate by this factor (the JAX
# package's margin)
RATE_MARGIN = 1.2

# the rating batch: the local bench configuration's shape (bench.py's
# defaults): 250 kb blocks with a het every 800 bp (312 a block), 30x
# coverage of 15 kb reads (about 19 hets a read), 1 % allele errors.
# Allele quals as prepare_block gives them on that dataset: 60 at SNVs,
# 7 at the 16 % of variants that are indels.
RATING_SEED = 0
RATING_BLOCKS = 64
BLOCK_BP = 250_000
HET_SPACING = 800
READ_LENGTH = 15_000
COVERAGE = 30
ALLELE_ERROR = 0.01
INDEL_SHARE = 0.16
SNV_QUAL, INDEL_QUAL = 60, 7
# timed passes, the fastest of which counts: the device engine's over the
# whole batch, after one warm-up pass of its first block (padded, as every
# batch is, to the bucket's 64 rows: it binds and first launches every
# kernel at the batch's shapes); the native beam's over its first
# NATIVE_BLOCKS_PER_THREAD blocks a thread, with no warm-up (it has nothing
# to build); the host A* oracle's (about 100 hets/s) once over the first
# ASTAR_BLOCKS blocks
RATING_REPS = 2
NATIVE_BLOCKS_PER_THREAD = 2
ASTAR_BLOCKS = 1

# the rate cache: the CLI's file (the JAX package keeps its rates in
# ~/.cache/hiphase_tpu/device_probe.json), and how long an entry holds
DEFAULT_RATE_CACHE = "~/.cache/hiphase_tpu_torch/engine_rates.json"
RATE_CACHE_TTL = 3600.0


class RatingStopped(Exception):
    """The rating was asked to stop (`BackgroundChoice.stop`) before it
    ended; nothing was chosen or cached."""


@dataclass
class EngineChoice:
    engine: str
    # hets/s by engine; empty when nothing was rated
    rates: dict[str, float] = field(default_factory=dict)
    # the rating's wall time (workload, warm-ups and timed passes, or the
    # cache lookup) and, before it, the kernel builds
    seconds: float = 0.0
    build_seconds: float = 0.0
    # the rates came from the rate cache
    cached: bool = False


def rating_workload(seed: int = RATING_SEED, blocks: int = RATING_BLOCKS,
                    block_bp: int = BLOCK_BP) -> list:
    """The rating batch: ``blocks`` prepared blocks (`BlockData`) of
    simulated reads, the same for the same arguments."""
    from hiphase_tpu_torch.core.read_segments import ReadSegment
    from hiphase_tpu_torch.core.variants import Variant
    from hiphase_tpu_torch.phasing.block_gen import PhaseBlock
    from hiphase_tpu_torch.phasing.phaser import BlockData

    rng = np.random.default_rng(seed)
    n_het = block_bp // HET_SPACING
    span = READ_LENGTH // HET_SPACING
    n_reads = COVERAGE * block_bp // READ_LENGTH
    # the blocks share one list of variants: no solver changes a variant
    variants = [Variant.new_snv(0, HET_SPACING * (j + 1), b"A", b"C", 0, 1)
                for j in range(n_het)]
    out = []
    for b in range(blocks):
        h1 = rng.integers(0, 2, size=n_het).astype(np.uint8)
        quals = np.where(rng.random(n_het) < INDEL_SHARE, INDEL_QUAL,
                         SNV_QUAL).astype(np.uint8)
        starts = rng.integers(1 - span, n_het, size=n_reads)
        haps = rng.integers(0, 2, size=n_reads).astype(np.uint8)
        errors = rng.random((n_reads, span)) < ALLELE_ERROR
        # read r covers columns [lo, hi); row r holds them from its start
        lo = np.maximum(starts, 0)
        hi = np.minimum(starts + span, n_het)
        cols = np.minimum(lo[:, None] + np.arange(span), n_het - 1)
        alleles = h1[cols] ^ haps[:, None] ^ errors.astype(np.uint8)
        q = quals[cols]
        reads = [ReadSegment(f"rating{b}_{r}", alleles[r, :n], q[r, :n],
                             int(lo[r]), int(hi[r]))
                 for r, n in enumerate((hi - lo).tolist())]
        block = PhaseBlock.new(b, "chr1", 0, 0, "SAMPLE", 1)
        for v in variants:
            block.add_locus_variant("chr1", v.position, 0)
        out.append(BlockData(phase_block=block, variants=variants,
                             hom_variants=[], read_segments=reads,
                             phasable_segments=[], read_stats=None))
    return out


def _pass_seconds(make_solver, blocks: list, reps: int,
                  warmup: list | None = None,
                  stop: threading.Event | None = None) -> float:
    """Wall seconds of the fastest of ``reps`` passes of ``blocks``, each
    through a new solver (submit each block, then drain), after one
    untimed pass of ``warmup``. A pass ends with every block's result on
    the host. Raises RatingStopped before a pass once ``stop`` is set."""
    def one_pass(blocks) -> float:
        if stop is not None and stop.is_set():
            raise RatingStopped
        t0 = time.perf_counter()
        solver = make_solver()
        results = []
        for data in blocks:
            results.extend(solver.submit(data))
        results.extend(solver.drain())
        if len(results) != len(blocks):
            raise RuntimeError(f"the rating pass returned {len(results)} "
                               f"results for {len(blocks)} blocks")
        return time.perf_counter() - t0

    if warmup:
        one_pass(warmup)
    return min(one_pass(blocks) for _ in range(reps))


def _hets(blocks: list) -> int:
    return sum(len(d.variants) for d in blocks)


def measure_rates(devices: Sequence[torch.device], threads: int,
                  solver_kw: dict, workload: list,
                  stop: threading.Event | None = None) -> dict[str, float]:
    """hets/s of the device engine on ``devices`` and of the host rung on
    ``workload`` (the host rung on its first blocks, see RATING_REPS),
    keyed by engine. Raises RatingStopped between passes once ``stop`` is
    set."""
    from hiphase_tpu_torch.parallel.orchestrator import BatchedDeviceSolver
    rates = {"cuda": _hets(workload) / _pass_seconds(
        lambda: BatchedDeviceSolver(devices, **solver_kw), workload,
        RATING_REPS, warmup=workload[:1], stop=stop)}
    if native.available():
        from hiphase_tpu_torch.phasing.native_beam import NativeBeamSolver
        blocks = workload[:NATIVE_BLOCKS_PER_THREAD * max(threads, 1)]
        rates["native"] = _hets(blocks) / _pass_seconds(
            lambda: NativeBeamSolver(threads=threads, **solver_kw), blocks,
            RATING_REPS, stop=stop)
    else:
        from hiphase_tpu_torch.cli import HostAStarSolver
        blocks = workload[:ASTAR_BLOCKS]
        rates["astar"] = _hets(blocks) / _pass_seconds(
            lambda: HostAStarSolver(solver_kw["min_queue_size"],
                                    solver_kw["queue_increment"]), blocks, 1,
            stop=stop)
    return rates


def _file_digest(path) -> str | None:
    if path is None:
        return None
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()[:16]


def rate_cache_key(devices: Sequence[torch.device], threads: int,
                   solver_kw: dict) -> dict:
    """Everything that sets the rates: the rated devices, torch and its
    CUDA, the kernel libraries (named by the hash of their sources and
    flags), the host library, the host's cores and --threads, the run's
    solver widths and the rating workload's constants."""
    from hiphase_tpu_torch import kernels
    native.available()
    return {
        "devices": [torch.cuda.get_device_name(d) if d.type == "cuda"
                    else str(d) for d in devices],
        "torch": torch.__version__, "torch_cuda": torch.version.cuda,
        "kernels": [kernels.build.library_path(n).name
                    for n in sorted(kernels.KERNELS)],
        "host_library": [native.LOADED.get("origin"),
                         native.LOADED.get("codec"),
                         _file_digest(native.LOADED.get("path"))],
        "cpu_count": os.cpu_count(), "threads": threads,
        "solver": {k: solver_kw[k] for k in sorted(solver_kw)},
        "workload": [RATING_SEED, RATING_BLOCKS, BLOCK_BP, HET_SPACING,
                     READ_LENGTH, COVERAGE, ALLELE_ERROR, INDEL_SHARE,
                     SNV_QUAL, INDEL_QUAL, RATING_REPS,
                     NATIVE_BLOCKS_PER_THREAD, ASTAR_BLOCKS]}


def _cache_entries(path: Path) -> list:
    """The file's entries; an unreadable or malformed file has none."""
    try:
        entries = json.loads(path.read_text())["entries"]
    except (OSError, ValueError, KeyError, TypeError):
        return []
    return entries if isinstance(entries, list) else []


def cache_lookup(path: Path, key: dict) -> dict[str, float] | None:
    """The rates stored under ``key`` less than RATE_CACHE_TTL seconds
    ago, else None."""
    now = time.time()
    for e in _cache_entries(path):
        try:
            if e["key"] == key and 0 <= now - e["time"] < RATE_CACHE_TTL:
                return {k: float(v) for k, v in e["rates"].items()}
        except (KeyError, TypeError, AttributeError, ValueError):
            continue
    return None


def cache_store(path: Path, key: dict, rates: dict[str, float]) -> None:
    """Store ``rates`` under ``key``, keeping the file's other live
    entries. The file is written under a temporary name and renamed into
    place: ranks and concurrent runs may share it."""
    now = time.time()
    keep = [e for e in _cache_entries(path)
            if isinstance(e, dict) and e.get("key") != key
            and isinstance(e.get("time"), (int, float))
            and 0 <= now - e["time"] < RATE_CACHE_TTL]
    keep.append({"key": key, "rates": rates, "time": now})
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    tmp.write_text(json.dumps({"entries": keep}, indent=1))
    os.replace(tmp, path)


def choose_engine(requested: str,
                  devices: Sequence[torch.device] | None = None,
                  threads: int = 1, rate_cache: str | os.PathLike | None = None,
                  stop: threading.Event | None = None,
                  **solver_kw) -> EngineChoice:
    """Resolve the --engine flag. ``devices`` are the devices the cuda
    engine would run on, None when there are none; ``rate_cache`` is the
    rate cache's file (``~`` expands), None for none; ``stop`` ends a
    rating between passes (RatingStopped); ``solver_kw`` are the run's
    solver widths (beam_width, batch_size, min_queue_size,
    queue_increment)."""
    if requested != "auto":
        return EngineChoice(requested)
    host = "native" if native.available() else "astar"
    if devices is None:
        why = ("no CUDA device; native library loaded" if host == "native"
               else "no CUDA device and no native library")
        logger.info("Engine 'auto' resolved to %r (%s)", host, why)
        return EngineChoice(host)

    t0 = time.perf_counter()
    cache = key = rates = None
    if rate_cache is not None:
        cache = Path(rate_cache).expanduser()
        key = rate_cache_key(devices, threads, solver_kw)
        rates = cache_lookup(cache, key)
        if rates is not None and set(rates) != {"cuda", host}:
            rates = None   # an entry edited by hand: rate again
    lookup_s = time.perf_counter() - t0
    build_s = 0.0
    if devices[0].type == "cuda" and (
            rates is None or _verdict(rates, host) == "cuda"):
        from hiphase_tpu_torch import kernels
        if stop is not None and stop.is_set():
            raise RatingStopped
        t0 = time.perf_counter()
        kernels.build_all()
        build_s = time.perf_counter() - t0
    cached = rates is not None
    if cached:
        seconds = lookup_s
    else:
        t0 = time.perf_counter()
        rates = measure_rates(devices, threads, solver_kw, rating_workload(),
                              stop=stop)
        seconds = time.perf_counter() - t0
        if cache is not None:
            try:
                cache_store(cache, key, rates)
            except OSError as e:
                logger.warning("The engine rates were not cached in %s: %s",
                               cache, e)
    engine = _verdict(rates, host)
    logger.info("Engine 'auto': the device engine on %s %s %.0f "
                "hets/s, %s %.0f hets/s%s (margin %.1fx) -> %r; %s "
                "%.2f s after %.2f s of kernel builds",
                ", ".join(map(str, devices)),
                "was rated (cached) at" if cached else "measured",
                rates["cuda"], host, rates[host],
                f" over the first {ASTAR_BLOCKS} block(s)"
                if host == "astar" else "", RATE_MARGIN, engine,
                "cache lookup" if cached else "rating", seconds, build_s)
    return EngineChoice(engine, rates, seconds, build_s, cached)


def _verdict(rates: dict[str, float], host: str) -> str:
    return "cuda" if rates["cuda"] > RATE_MARGIN * rates[host] else host


class BackgroundChoice:
    """`choose_engine` for ``auto`` on a thread of its own, started here.

    `done` says whether it has ended, `result` waits for it and returns
    the choice or raises the choice's error, and `stop` asks a rating
    still going to end before its next pass, then joins the thread (a
    kernel build in progress ends first: no nvcc process outlives it)."""

    def __init__(self, devices: Sequence[torch.device], threads: int,
                 rate_cache: str | os.PathLike | None, **solver_kw):
        self._stop = threading.Event()
        self._ended = threading.Event()
        self._choice: EngineChoice | None = None
        self._error: BaseException | None = None
        self.started = time.perf_counter()
        self.ended_at: float | None = None   # perf_counter at its end
        self._thread = threading.Thread(
            target=self._run, name="engine-rating",
            args=(devices, threads, rate_cache, solver_kw))
        self._thread.start()

    def _run(self, devices, threads, rate_cache, solver_kw) -> None:
        try:
            self._choice = choose_engine("auto", devices, threads,
                                         rate_cache=rate_cache,
                                         stop=self._stop, **solver_kw)
        except BaseException as e:  # re-raised by result() on the caller
            self._error = e
        finally:
            self.ended_at = time.perf_counter()
            self._ended.set()

    def done(self) -> bool:
        return self._ended.is_set()

    def result(self) -> EngineChoice | None:
        """The choice; None when `stop` ended the rating first. Raises the
        error of the build or the rating."""
        self._thread.join()
        if isinstance(self._error, RatingStopped):
            return None
        if self._error is not None:
            raise self._error
        return self._choice

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


class DeferredUpgradeSolver:
    """The run's solver for ``auto`` while `BackgroundChoice` decides: the
    native beam at first, and, from the first `submit` after a ``cuda``
    verdict, the device engine (`make_device_solver`, called once on this
    thread), after the native beam drains. The solver interface of
    `BatchedDeviceSolver`.

    An error of the choice is raised at the next `submit` or at `drain`.
    `drain` stops a rating still going, joins it and drains the solver in
    use. ``blocks`` counts the blocks each engine was given; ``upgrade``
    is (the block index of the first block given to the device, the number
    of blocks given to native before it, seconds from ``started``) or
    None; ``late_blocks`` counts blocks given to native after the choice
    had ended (0 unless the switch lags the choice)."""

    def __init__(self, native_solver, choice: BackgroundChoice,
                 make_device_solver, started: float | None = None):
        self.native = native_solver
        self.device = None
        self._choice = choice
        self._make = make_device_solver
        self.started = time.perf_counter() if started is None else started
        self.engine = "native"
        self.choice: EngineChoice | None = None
        self.blocks = {"native": 0, "cuda": 0}
        self.upgrade: tuple[int, int, float] | None = None
        self.late_blocks = 0

    def _resolve(self, wait: bool) -> list:
        """Take the choice once it has ended (or, with ``wait``, stop and
        join it); returns the native results drained at a switch."""
        if self._choice is None or not (wait or self._choice.done()):
            return []
        choice, self._choice = self._choice, None
        if wait:
            choice.stop()
        self.choice = choice.result()
        if wait or self.choice is None or self.choice.engine != "cuda":
            return []
        out = self.native.drain()
        self.device = self._make()
        self.engine = "cuda"
        logger.info("Engine 'auto': the rating chose the device engine; "
                    "blocks from here on go to it (%d block(s) went to "
                    "native)", self.blocks["native"])
        return out

    def submit(self, data):
        t0 = time.perf_counter()
        out = self._resolve(wait=False)
        if self.engine == "cuda":
            if self.upgrade is None:
                self.upgrade = (data.phase_block.block_index,
                                self.blocks["native"], t0 - self.started)
            out.extend(self.device.submit(data))
        else:
            ended = self._choice.ended_at if self._choice else None
            if ended is not None and ended < t0:
                self.late_blocks += 1
            out.extend(self.native.submit(data))
        self.blocks[self.engine] += 1
        return out

    def drain(self):
        self._resolve(wait=True)
        return (self.device or self.native).drain()
