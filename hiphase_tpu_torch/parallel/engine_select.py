"""Engine selection for the torch port.

``--engine auto`` resolves once, before the run. Given the devices the
cuda engine would run on, it rates the device engine against the host
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

The choice is logged and holds for the whole run; a device error ends the
run instead of switching engines. Nothing is cached: PERF.md gives the
rating's cost on the card.
"""

from __future__ import annotations

import logging
import time
from collections.abc import Sequence
from dataclasses import dataclass, field

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


@dataclass
class EngineChoice:
    engine: str
    # hets/s by engine; empty when nothing was rated
    rates: dict[str, float] = field(default_factory=dict)
    # the rating's wall time (workload, warm-ups and timed passes) and,
    # before it, the kernel builds
    seconds: float = 0.0
    build_seconds: float = 0.0


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
                  warmup: list | None = None) -> float:
    """Wall seconds of the fastest of ``reps`` passes of ``blocks``, each
    through a new solver (submit each block, then drain), after one
    untimed pass of ``warmup``. A pass ends with every block's result on
    the host."""
    def one_pass(blocks) -> float:
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
                  solver_kw: dict, workload: list) -> dict[str, float]:
    """hets/s of the device engine on ``devices`` and of the host rung on
    ``workload`` (the host rung on its first blocks, see RATING_REPS),
    keyed by engine."""
    from hiphase_tpu_torch.parallel.orchestrator import BatchedDeviceSolver
    rates = {"cuda": _hets(workload) / _pass_seconds(
        lambda: BatchedDeviceSolver(devices, **solver_kw), workload,
        RATING_REPS, warmup=workload[:1])}
    if native.available():
        from hiphase_tpu_torch.phasing.native_beam import NativeBeamSolver
        blocks = workload[:NATIVE_BLOCKS_PER_THREAD * max(threads, 1)]
        rates["native"] = _hets(blocks) / _pass_seconds(
            lambda: NativeBeamSolver(threads=threads, **solver_kw), blocks,
            RATING_REPS)
    else:
        from hiphase_tpu_torch.cli import HostAStarSolver
        blocks = workload[:ASTAR_BLOCKS]
        rates["astar"] = _hets(blocks) / _pass_seconds(
            lambda: HostAStarSolver(solver_kw["min_queue_size"],
                                    solver_kw["queue_increment"]), blocks, 1)
    return rates


def choose_engine(requested: str,
                  devices: Sequence[torch.device] | None = None,
                  threads: int = 1, **solver_kw) -> EngineChoice:
    """Resolve the --engine flag. ``devices`` are the devices the cuda
    engine would run on, None when there are none; ``solver_kw`` are the
    run's solver widths (beam_width, batch_size, min_queue_size,
    queue_increment)."""
    if requested != "auto":
        return EngineChoice(requested)
    host = "native" if native.available() else "astar"
    if devices is None:
        why = ("no CUDA device; native library loaded" if host == "native"
               else "no CUDA device and no native library")
        logger.info("Engine 'auto' resolved to %r (%s)", host, why)
        return EngineChoice(host)

    build_s = 0.0
    if devices[0].type == "cuda":
        from hiphase_tpu_torch import kernels
        t0 = time.perf_counter()
        kernels.build_all()
        build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rates = measure_rates(devices, threads, solver_kw, rating_workload())
    seconds = time.perf_counter() - t0
    engine = "cuda" if rates["cuda"] > RATE_MARGIN * rates[host] else host
    logger.info("Engine 'auto': the device engine on %s measured %.0f "
                "hets/s, %s %.0f hets/s%s (margin %.1fx) -> %r; rating "
                "%.2f s after %.2f s of kernel builds",
                ", ".join(map(str, devices)), rates["cuda"], host,
                rates[host],
                f" over the first {ASTAR_BLOCKS} block(s)"
                if host == "astar" else "", RATE_MARGIN, engine, seconds,
                build_s)
    return EngineChoice(engine, rates, seconds, build_s)
