"""Native host beam engine without JAX — the twin of
``hiphase_tpu/phasing/native_beam.py`` for ``--engine native`` and for A/B
checks of the device engine.

The C++ solver (``hn_beam_solve_batch`` in ``native/hiphase_native.cc``,
reached through this package's ``io/native.py``) ranks candidates
with the same packed key as the device kernels and escalates any block that
is not provably optimal at the fast width to the full width, so its result
is bit-identical to the device engine's.
"""

from __future__ import annotations

import numpy as np

from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.phasing.astar import astar_solver
from hiphase_tpu_torch.phasing.phaser import BlockData, finalize_block
from hiphase_tpu_torch.parallel.orchestrator import _pad_width, _stats_from_beam
from hiphase_tpu_torch.phasing.beam import max_hets_for
from hiphase_tpu_torch.tracing import OFF, Recorder

# Escalation schedule: every block first solves at this width; blocks whose
# result is not provably optimal re-solve at the full queue-size width.
FAST_WIDTH = 64


class NativeBeamSolver:
    """Buckets prepared blocks into batches for the native C++ beam, with
    the submit/drain interface of the device solver."""

    def __init__(self, beam_width: int | None = None, batch_size: int = 32,
                 min_queue_size: int = 1000, queue_increment: int = 3,
                 threads: int = 2, compute_estimates: bool = False,
                 spans: Recorder = OFF):
        # widths as the device solver's: an explicit --beam-width above the
        # queue floor raises the full width too
        self.full_width = _pad_width(min_queue_size)
        if beam_width is None:
            self.fast_width = min(FAST_WIDTH, self.full_width)
        else:
            self.fast_width = _pad_width(beam_width)
            self.full_width = max(self.full_width, self.fast_width)
        self.min_queue_size = min_queue_size
        self.queue_increment = queue_increment
        self.threads = max(threads, 1)
        self.compute_estimates = compute_estimates
        self.spans = spans
        self.batch_cap = max(batch_size, 1)
        self._pending: list[BlockData] = []
        self.total_expansions = 0

    def _max_nv(self) -> int:
        # ranking-key capacity at the full width (see hn_beam_solve_batch)
        return max_hets_for(self.full_width)

    def _astar(self, d: BlockData):
        res = astar_solver(d.phase_block.block_index, d.variants,
                           d.read_segments, self.min_queue_size,
                           self.queue_increment)
        return finalize_block(d, res.haplotype_1, res.haplotype_2,
                              res.statistics)

    def submit(self, data: BlockData):
        if len(data.variants) > self._max_nv():
            return [self._astar(data)]
        self._pending.append(data)
        if len(self._pending) >= self.batch_cap:
            return self._solve_batch()
        return []

    def drain(self):
        return self._solve_batch()

    def _solve_batch(self):
        pending, self._pending = self._pending, []
        if not pending:
            return []

        nv = np.array([len(d.variants) for d in pending], dtype=np.int32)
        skip_off = np.zeros(len(pending) + 1, dtype=np.int64)
        np.cumsum(nv, out=skip_off[1:])
        skip = np.zeros(int(skip_off[-1]), dtype=np.uint8)
        for i, d in enumerate(pending):
            base = skip_off[i]
            for j, v in enumerate(d.variants):
                if v.is_ignored:
                    skip[base + j] = 1

        read_off = np.zeros(len(pending) + 1, dtype=np.int64)
        read_off[1:] = np.cumsum([len(d.read_segments) for d in pending])
        total_reads = int(read_off[-1])
        seg_start = np.empty(total_reads, dtype=np.int32)
        seg_lens = np.empty(total_reads, dtype=np.int64)
        blobs_a: list[np.ndarray] = []
        blobs_q: list[np.ndarray] = []
        r = 0
        for d in pending:
            for rs in d.read_segments:
                seg_start[r] = rs.start
                seg_lens[r] = len(rs.alleles)
                blobs_a.append(rs.alleles)
                blobs_q.append(rs.quals)
                r += 1
        seg_off = np.zeros(total_reads + 1, dtype=np.int64)
        np.cumsum(seg_lens, out=seg_off[1:])
        alleles = (np.concatenate(blobs_a) if blobs_a
                   else np.empty(0, dtype=np.uint8))
        quals = (np.concatenate(blobs_q) if blobs_q
                 else np.empty(0, dtype=np.uint8))

        out = native.beam_solve_batch_native(
            nv, skip_off, skip, read_off, seg_start, seg_off, alleles, quals,
            self.fast_width, self.full_width, self.threads)
        if out is None:  # native library unavailable: the host A* oracle
            return [self._astar(d) for d in pending]

        h1, h2, cost, _hets, pruned, expansions = out
        self.total_expansions += int(expansions.sum())
        results = []
        for i, d in enumerate(pending):
            sl = slice(int(skip_off[i]), int(skip_off[i + 1]))
            bh1 = [int(x) for x in h1[sl]]
            bh2 = [int(x) for x in h2[sl]]
            stats = _stats_from_beam(d, bh1, bh2, int(cost[i]),
                                     int(pruned[i]),
                                     estimate=self.compute_estimates,
                                     min_queue_size=self.min_queue_size,
                                     queue_increment=self.queue_increment,
                                     spans=self.spans)
            results.append(finalize_block(d, bh1, bh2, stats))
        return results
