"""Batched device solver over the torch devices of one host — the
counterpart of ``hiphase_tpu/parallel/orchestrator.py``.

Prepared blocks are bucketed by slot count and padded into fixed batches.
A batch is split into one contiguous row chunk per device
(`parallel.sharding.dispatch_chunks`, as the JAX solver's ``P("data")``
mesh splits it); each chunk crosses to its device in exactly two
host→device copies (packed inputs and the skip mask); the beam state is
created on the device; the tile chain, the backtrace and the stats packing
are enqueued on the device's current stream without waiting, and up to
``PIPELINE_DEPTH`` batches stay in flight while the host prepares more. A
batch materializes with two device→host copies a chunk (stats,
haplotypes), joined in row order. Blocks not provably optimal at the fast
width re-solve at the full width.
"""

from __future__ import annotations

from collections import deque
from collections.abc import Sequence
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from hiphase_tpu_torch.phasing.astar import astar_solver
from hiphase_tpu_torch.phasing.phaser import (
    AMB, BlockData, beam_phase_stats, finalize_block,
)
from hiphase_tpu_torch.writers.phase_stats import PhaseStats
from hiphase_tpu_torch.parallel.sharding import (
    Chunk, dispatch_chunks, gather_chunks,
)
from hiphase_tpu_torch.phasing.beam import (
    PACK_PAD, assign_slots, max_hets_for, pack_inputs, tensorize_block,
)
from hiphase_tpu_torch.tracing import OFF, Recorder

# slot-bucket ladder (padded concurrent-read capacities); beyond it the
# block goes to the host A* oracle
READ_BUCKETS = (128, 512, 1024)
# blocks per device batch for each slot bucket; each batch is padded to it
BUCKET_BATCH = {128: 64, 512: 16, 1024: 8}
# variant-tile size: columns per tile of the chain
TILE = 128
# in-flight device batches before the oldest is forced to materialize
PIPELINE_DEPTH = 2


def _bucket_of(n: int, ladder: tuple[int, ...]) -> int | None:
    for b in ladder:
        if n <= b:
            return b
    return None


def _pad_width(w: int) -> int:
    """Round a width up to a multiple of 64."""
    return max(64, ((w + 63) // 64) * 64)


def _stats_from_beam(data: BlockData, h1, h2, cost: int, pruned: int,
                     estimate: bool = False, min_queue_size: int = 1000,
                     queue_increment: int = 3,
                     spans: Recorder = OFF) -> PhaseStats:
    """The block's PhaseStats in the host A* oracle's units, which the
    --stats-file reports (`phaser.beam_phase_stats`), and with ``estimate``
    the oracle's heuristic estimate (span ``solve.estimate``)."""
    estimated = None
    if estimate:
        # --stats-file semantics: estimated_cost is the root value of the
        # reference's right-to-left heuristic sweep
        from hiphase_tpu_torch.phasing.astar import (
            MAX_SEGMENT_SIZE, _BlockReads, calculate_astar_heuristic,
        )
        with spans.span("solve.estimate"):
            reads = _BlockReads(data.read_segments, len(data.variants))
            heuristics, _bad = calculate_astar_heuristic(
                len(data.variants), MAX_SEGMENT_SIZE, reads, min_queue_size,
                queue_increment, [v.is_ignored for v in data.variants])
        estimated = heuristics[0]
    return beam_phase_stats(data, h1, h2, cost, pruned, estimated,
                            oracle_units=True)


@dataclass
class _Pending:
    data: BlockData
    packed: np.ndarray          # [rb, vp] int32 (see beam.pack_inputs)
    skip: np.ndarray            # [vp] bool


@dataclass
class _Job:
    """One dispatched device batch; its chunks are still being computed."""

    pending: list[_Pending]
    width: int
    chunks: list[Chunk]         # one a device, in row order
    escalated: bool = False


class BatchedDeviceSolver:
    """Buckets prepared blocks into fixed-shape padded batches and solves
    them on ``device`` (one torch device, or a list: one row chunk of each
    batch a device); results flow back through a bounded pipeline."""

    def __init__(self, device: torch.device | Sequence[torch.device],
                 beam_width: int | None = None, batch_size: int = 32,
                 min_queue_size: int = 1000, queue_increment: int = 3,
                 tile: int = TILE, compute_estimates: bool = False,
                 spans: Recorder = OFF):
        self.devices = ((device,) if isinstance(device, torch.device)
                        else tuple(device))
        self.device = self.devices[0]
        self.compute_estimates = compute_estimates
        self.spans = spans
        # default: solve once at the full queue-size width; an explicit
        # smaller beam_width enables the fast-then-escalate schedule
        self.full_width = _pad_width(min_queue_size)
        self.fast_width = self.full_width if beam_width is None \
            else _pad_width(beam_width)
        self.full_width = max(self.fast_width, self.full_width)
        self.batch_cap = max(batch_size, 1)
        self.min_queue_size = min_queue_size
        self.queue_increment = queue_increment
        self.tile = tile
        self._buckets: dict[int, list[_Pending]] = {}
        self._esc_buckets: dict[int, list[_Pending]] = {}
        self._jobs: deque[_Job] = deque()
        self.device_batches = 0
        self.device_transfers = 0

    def _batch_size_for(self, rb: int) -> int:
        b = min(BUCKET_BATCH[rb], self.batch_cap)
        n = len(self.devices)
        if n > 1:
            b = max(((b + n - 1) // n) * n, n)
        return b

    def submit(self, data: BlockData):
        """Queue one prepared block; returns finalized results whose device
        work has completed."""
        nv = len(data.variants)
        _slots, n_slots = assign_slots(data.read_segments) \
            if data.read_segments else ([], 1)
        rb = _bucket_of(n_slots, READ_BUCKETS)
        if rb is None or nv > max_hets_for(self.full_width):
            # beyond the slot ladder (pathological coverage): host oracle
            result = astar_solver(data.phase_block.block_index, data.variants,
                                  data.read_segments, self.min_queue_size,
                                  self.queue_increment)
            return [finalize_block(data, result.haplotype_1,
                                   result.haplotype_2, result.statistics)]
        vp = ((max(nv, 1) + self.tile - 1) // self.tile) * self.tile
        alleles, quals, skip, resets = tensorize_block(
            data.read_segments, data.variants, rb, vp, slotted=True)
        bucket = self._buckets.setdefault(rb, [])
        bucket.append(_Pending(data, pack_inputs(alleles, quals, resets),
                               skip))
        out = []
        if len(bucket) >= self._batch_size_for(rb):
            self._dispatch(self._buckets.pop(rb), rb, self.fast_width)
        while len(self._jobs) > PIPELINE_DEPTH:
            out.extend(self._materialize(self._jobs.popleft()))
        return out

    def _dispatch(self, pending: list[_Pending], rb: int, width: int,
                  escalated: bool = False) -> None:
        """Pad a bucket to its batch size and enqueue the whole batch, one
        row chunk a device: two host→device copies a chunk, then the tile
        chain, the backtrace and the stats packing, none of which waits for
        a device."""
        B = self._batch_size_for(rb)
        assert len(pending) <= B
        vp = max(p.packed.shape[1] for p in pending)
        # vp+1 columns: the trailing PACK_PAD column feeds the last column's
        # lookahead reset plane
        PK = np.full((B, rb, vp + 1), PACK_PAD, dtype=np.int32)
        S = np.ones((B, vp), dtype=bool)
        for i, p in enumerate(pending):
            v = p.packed.shape[1]
            PK[i, :, :v] = p.packed
            S[i, :v] = p.skip
        chunks = dispatch_chunks(self.devices, PK, S, width, self.tile)
        self.device_batches += 1
        self.device_transfers += 2 * len(chunks)
        self._jobs.append(_Job(pending, width, chunks, escalated))

    def _materialize(self, job: _Job):
        """Wait for a dispatched batch (one stats and one haplotype copy to
        the host a chunk) and finalize it; blocks that aren't provably
        optimal at the fast width re-enter at the full width."""
        with self.spans.span("solve.beam_wait"):
            (cost, _hets, pruned), (h1a, h2a) = gather_chunks(job.chunks)

        out = []
        for i, p in enumerate(job.pending):
            blk_pruned = int(pruned[i])
            if (blk_pruned > 0 and not job.escalated
                    and self.full_width > job.width):
                rb = p.packed.shape[0]
                esc = self._esc_buckets.setdefault(rb, [])
                esc.append(p)
                if len(esc) >= self._batch_size_for(rb):
                    self._dispatch(self._esc_buckets.pop(rb), rb,
                                   self.full_width, escalated=True)
                continue
            nv = len(p.data.variants)
            bh1 = [int(x) for x in h1a[i, :nv]]
            bh2 = [int(x) for x in h2a[i, :nv]]
            stats = _stats_from_beam(p.data, bh1, bh2, int(cost[i]),
                                     blk_pruned,
                                     estimate=self.compute_estimates,
                                     min_queue_size=self.min_queue_size,
                                     queue_increment=self.queue_increment,
                                     spans=self.spans)
            out.append(finalize_block(p.data, bh1, bh2, stats))
        return out

    def drain(self):
        out = []
        for rb in sorted(self._buckets.keys()):
            self._dispatch(self._buckets.pop(rb), rb, self.fast_width)
        while self._jobs:
            out.extend(self._materialize(self._jobs.popleft()))
        # escalation rounds: anything re-queued solves at full width
        while self._esc_buckets or self._jobs:
            for rb in sorted(self._esc_buckets.keys()):
                self._dispatch(self._esc_buckets.pop(rb), rb, self.full_width,
                               escalated=True)
            while self._jobs:
                out.extend(self._materialize(self._jobs.popleft()))
        return out


def iter_prepared(block_iterator, prepare_fn, classify,
                  threads: int = 1, window: int = 40, spans: Recorder = OFF):
    """Yield (kind, item) per block preserving stream order, preparing up
    to ``window × threads`` blocks ahead on a pool (the reference's
    40×threads in-flight backpressure, ref: main.rs:328); the caller's
    waits for a prepared block are spans ``prepared_wait``.

    ``classify(block)`` returns 'solve' (item = prepare_fn(block)) or
    another kind (item = the block itself)."""
    if threads <= 1:
        for block in block_iterator:
            kind = classify(block)
            yield (kind, prepare_fn(block) if kind == "solve" else block)
        return

    def result(future):
        with spans.span("prepared_wait"):
            return future.result()

    max_inflight = window * threads
    with ThreadPoolExecutor(max_workers=threads,
                            thread_name_prefix="prepare") as pool:
        inflight = []  # list of (kind, future-or-block)
        for block in block_iterator:
            kind = classify(block)
            if kind == "solve":
                inflight.append(("solve", pool.submit(prepare_fn, block)))
            else:
                inflight.append((kind, block))
            while len(inflight) >= max_inflight:
                kind, item = inflight.pop(0)
                yield (kind, result(item) if kind == "solve" else item)
        for kind, item in inflight:
            yield (kind, result(item) if kind == "solve" else item)
