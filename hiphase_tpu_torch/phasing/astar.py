"""Exact A* diplotype solver — host-side golden reference.

Faithful reimplementation of the reference's weighted-MEC A* search
(ref: src/astar_phaser.rs): right-to-left heuristic sweep via an unpruned
mini-A* subsolver, main search with queue-size-scheduled pruning, expansion
order 0|1, 1|0, 0/0, 1/1 with symmetry breaking, and tie-breaking by
(min cost, max num_hets, min node index).

This solver is the parity oracle for the production TPU beam engine
(`hiphase_tpu.phasing.beam`): within a lockstep beam all candidates share a
depth, so the heuristic cancels out of the ranking and the beam engine needs
none; this module keeps it for A*'s cross-depth priority and for the
``estimated_cost`` statistic.

The heuristic sweep runs in C++ where the native library of
``csrc/astar_sweep.cc`` is bound (`io.native.astar_heuristic`, an exact
twin), else in Python (`python_astar_heuristic`, the oracle the tests hold
the C++ to).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from dataclasses import dataclass

import numpy as np

from hiphase_tpu_torch.core.read_segments import ReadSegment
from hiphase_tpu_torch.core.variants import AlleleType, VariantType
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.writers.phase_stats import PhaseStats

REF = int(AlleleType.REFERENCE)
ALT = int(AlleleType.ALTERNATE)
AMB = int(AlleleType.AMBIGUOUS)

# extension order: heterozygous options first (ref: astar_phaser.rs:535-540)
HAP_ORDER = ((REF, ALT), (ALT, REF), (REF, REF), (ALT, ALT))

MAX_SEGMENT_SIZE = 40  # heuristic lookahead (ref: astar_phaser.rs:466)


class _Node:
    """One A* search node. Carries per-read running costs against both
    haplotypes so extension is incremental (the reference recomputes
    ``score_partial_haplotype`` per overlapping read; same totals)."""

    __slots__ = ("node_index", "cost", "heuristic", "h1", "h2", "num_hets",
                 "identical", "read_costs")

    def __init__(self, node_index, cost, heuristic, h1, h2, num_hets,
                 identical, read_costs):
        self.node_index = node_index
        self.cost = cost              # frozen + fluid actual cost
        self.heuristic = heuristic
        self.h1 = h1                  # tuple of alleles
        self.h2 = h2
        self.num_hets = num_hets
        self.identical = identical
        self.read_costs = read_costs  # dict read_id -> (c1, c2)

    def total_cost(self) -> int:
        return self.cost + self.heuristic

    def priority(self):
        """min-heap key ≡ reference's (Reverse(cost), hets, Reverse(idx))
        max-queue (ref: astar_phaser.rs:131-133)."""
        return (self.total_cost(), -self.num_hets, self.node_index)

    def depth(self) -> int:
        return len(self.h1)


class _BlockReads:
    """Dense tensor view of the block's reads for fast cost deltas, built
    at the first use of one of its arrays (the native sweep reads the
    segments alone)."""

    _DENSE = ("alleles", "quals", "starts", "ends", "overlapping")

    def __init__(self, read_segments: list[ReadSegment], num_variants: int):
        self.read_segments = read_segments
        self.num_reads = len(read_segments)
        self.num_variants = num_variants

    def __getattr__(self, name):
        if name not in _BlockReads._DENSE:
            raise AttributeError(name)
        self._build_dense()
        return self.__dict__[name]

    def _build_dense(self) -> None:
        read_segments, num_variants = self.read_segments, self.num_variants
        self.alleles = np.full((self.num_reads, num_variants), 3, dtype=np.uint8)
        self.quals = np.zeros((self.num_reads, num_variants), dtype=np.int64)
        self.starts = np.zeros(self.num_reads, dtype=np.int64)
        self.ends = np.zeros(self.num_reads, dtype=np.int64)
        for i, rs in enumerate(read_segments):
            a, q = rs.to_padded(num_variants)
            self.alleles[i] = a
            self.quals[i] = q
            self.starts[i] = rs.start
            self.ends[i] = rs.end
        # reads overlapping each variant index
        self.overlapping = [
            np.flatnonzero((self.starts <= j) & (self.ends > j))
            for j in range(num_variants)
        ]

    def delta(self, read_id: int, var_index: int, allele: int) -> int:
        """Cost of appending ``allele`` at ``var_index`` for one read."""
        if allele >= AMB:
            return 0
        a = self.alleles[read_id, var_index]
        return int(self.quals[read_id, var_index]) if a != allele else 0


def _extend(node: _Node, a1: int, a2: int, heuristic: int,
            reads: _BlockReads, next_index: int, hap_offset: int) -> _Node:
    """Create the (a1, a2)-extended child (ref: astar_phaser.rs:69-119)."""
    j = node.depth() + hap_offset
    read_costs = dict(node.read_costs)
    cost = node.cost
    for rid in reads.overlapping[j]:
        rid = int(rid)
        c1, c2 = read_costs.get(rid, (0, 0))
        old = min(c1, c2)
        c1 += reads.delta(rid, j, a1)
        c2 += reads.delta(rid, j, a2)
        read_costs[rid] = (c1, c2)
        cost += min(c1, c2) - old
    return _Node(next_index, cost, heuristic,
                 node.h1 + (a1,), node.h2 + (a2,),
                 node.num_hets + (1 if a1 != a2 else 0),
                 node.identical and a1 == a2,
                 read_costs)


def astar_subsolver(problem_offset: int, problem_size: int, reads: _BlockReads,
                    heuristic_costs: list[int], bad_variants: list[bool],
                    min_queue_size: int, queue_increment: int) -> tuple[int, int]:
    """Unpruned windowed mini-A*: max over x of best_path(o..o+x) + H[o+x]
    with a small visit budget (ref: astar_phaser.rs:311-405)."""
    assert heuristic_costs[problem_offset] == 0
    counter = itertools.count(1)
    root = _Node(0, 0, heuristic_costs[problem_offset + 1], (), (), 0, True, {})
    heap = [(root.priority(), root)]
    next_expected = 0
    max_cost_so_far = 0
    max_visits = min_queue_size + queue_increment * problem_size
    nodes_visited = 0

    while heap[0][1].depth() < problem_size and nodes_visited < max_visits:
        _, top = heapq.heappop(heap)
        allele_count = top.depth()
        nodes_visited += 1
        if allele_count == next_expected:
            max_cost_so_far = max(max_cost_so_far, top.total_cost())
            next_expected += 1
        h_next = heuristic_costs[problem_offset + allele_count + 1]
        if bad_variants[problem_offset + allele_count]:
            child = _extend(top, AMB, AMB, h_next, reads, next(counter), problem_offset)
            assert child.total_cost() == top.total_cost()
            heapq.heappush(heap, (child.priority(), child))
        else:
            for a1, a2 in HAP_ORDER:
                if a1 == ALT and a2 == REF and top.identical:
                    continue
                child = _extend(top, a1, a2, h_next, reads, next(counter), problem_offset)
                heapq.heappush(heap, (child.priority(), child))

    if heap[0][1].depth() == problem_size:
        max_cost_so_far = max(max_cost_so_far, heap[0][1].total_cost())
        next_expected += 1
    return max_cost_so_far, next_expected - 1


# blocks swept by each path in this process (a forked worker counts in its
# own copy); `cli.main` takes them per run
_SWEEPS = {"native": 0, "python": 0}
_SWEEPS_LOCK = threading.Lock()


def take_sweep_counts() -> dict[str, int]:
    """The blocks swept natively and in Python since the last call."""
    with _SWEEPS_LOCK:
        counts = dict(_SWEEPS)
        _SWEEPS.update(native=0, python=0)
    return counts


def calculate_astar_heuristic(num_variants: int, max_segment_size: int,
                              reads: _BlockReads, min_queue_size: int,
                              queue_increment: int,
                              bad_variants: list[bool] | None
                              ) -> tuple[list[int], list[bool]]:
    """Right-to-left sweep building the admissible-ish estimate array H[0..n]
    (ref: astar_phaser.rs:246-292). ``bad_variants`` detection stays disabled
    as in the reference; ignored variants seed the array. In C++ where its
    library is bound, else `python_astar_heuristic`: the same arrays."""
    assert max_segment_size >= 2
    if bad_variants is None:
        bad_variants = [False] * num_variants
    else:
        assert len(bad_variants) == num_variants
    out = _native_astar_heuristic(num_variants, max_segment_size,
                                  reads.read_segments, min_queue_size,
                                  queue_increment, bad_variants)
    with _SWEEPS_LOCK:
        _SWEEPS["python" if out is None else "native"] += 1
    if out is not None:
        return out
    return python_astar_heuristic(num_variants, max_segment_size, reads,
                                  min_queue_size, queue_increment,
                                  bad_variants)


def _native_astar_heuristic(num_variants, max_segment_size, read_segments,
                            min_queue_size, queue_increment, bad_variants):
    """`native.astar_heuristic` on the segments packed as they are (O(reads),
    no dense view), as Python lists; None where it does not run."""
    if not native.port_available():
        return None
    n = len(read_segments)
    seg_start = np.fromiter((rs.start for rs in read_segments), np.int32, n)
    seg_end = np.fromiter((rs.end for rs in read_segments), np.int32, n)
    seg_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(rs.alleles) for rs in read_segments),
                          np.int64, n), out=seg_off[1:])
    empty = np.empty(0, dtype=np.uint8)
    alleles = np.concatenate([rs.alleles for rs in read_segments]) if n \
        else empty
    quals = np.concatenate([rs.quals for rs in read_segments]) if n \
        else empty
    out = native.astar_heuristic(
        num_variants, max_segment_size, seg_start, seg_end, seg_off,
        alleles, quals, np.asarray(bad_variants, dtype=bool),
        min_queue_size, queue_increment)
    if out is None:
        return None
    heuristics, bad = out
    return heuristics.tolist(), bad.tolist()


def python_astar_heuristic(num_variants: int, max_segment_size: int,
                           reads: _BlockReads, min_queue_size: int,
                           queue_increment: int, bad_variants: list[bool]
                           ) -> tuple[list[int], list[bool]]:
    """The sweep in Python: the oracle of ``hn_astar_heuristic``."""
    heuristics = [0] * (num_variants + 1)
    bad_variants = list(bad_variants)
    max_clip_size = 1
    for v_index in range(num_variants - 1, -1, -1):
        max_estimate, solve_size = astar_subsolver(
            v_index, max_clip_size, reads, heuristics, bad_variants,
            min_queue_size // 10, queue_increment)
        assert solve_size >= min(max_clip_size, 2)
        if bad_variants[v_index]:
            heuristics[v_index] = heuristics[v_index + 1]
        else:
            assert max_estimate >= heuristics[v_index + 1]
            heuristics[v_index] = max_estimate
        max_clip_size = min(solve_size + 1, max_segment_size)
    return heuristics, bad_variants


@dataclass
class AstarResult:
    haplotype_1: list[int]
    haplotype_2: list[int]
    statistics: PhaseStats


def astar_solver(block_index: int, variants, read_segments: list[ReadSegment],
                 min_queue_size: int = 1000, queue_increment: int = 3) -> AstarResult:
    """Main search with progressive queue pruning (ref: astar_phaser.rs:426-633).

    ``variants`` is the block's Variant list (``is_ignored`` seeds bad
    variants); reads with alleles at ignored variants must be NoOverlap there.
    """
    num_variants = len(variants)
    reads = _BlockReads(read_segments, num_variants)

    for rs in read_segments:
        for var_index, v in enumerate(variants):
            if v.is_ignored:
                assert rs.allele(var_index) == 3

    bad_seed = [v.is_ignored for v in variants]
    heuristic_costs, bad_variants = calculate_astar_heuristic(
        num_variants, MAX_SEGMENT_SIZE, reads, min_queue_size,
        queue_increment, bad_seed)

    curr_queue_size_threshold = min_queue_size
    max_queue_size = 10 * min_queue_size
    min_progress = 0
    num_pruned = 0
    estimated_cost = heuristic_costs[0]
    next_expected = 0

    counter = itertools.count(1)
    root = _Node(0, 0, heuristic_costs[0], (), (), 0, True, {})
    heap = [(root.priority(), root)]
    # haplotype-length histogram tracker (ref: astar_phaser.rs:171-231)
    length_counts = [0] * (num_variants + 1)
    length_counts[0] = 1
    tracked = 1  # count of nodes with depth >= min_progress

    while heap[0][1].depth() < num_variants:
        _, top = heapq.heappop(heap)
        allele_count = top.depth()
        length_counts[allele_count] -= 1
        if allele_count >= min_progress:
            tracked -= 1
        if allele_count == next_expected:
            next_expected += 1
            if num_pruned == 0:
                curr_queue_size_threshold += queue_increment
        if allele_count < min_progress:
            if num_pruned == 0:
                curr_queue_size_threshold = min_queue_size
            num_pruned += 1
            continue

        h_next = heuristic_costs[allele_count + 1]
        if bad_variants[allele_count]:
            child = _extend(top, AMB, AMB, h_next, reads, next(counter), 0)
            assert child.total_cost() == top.total_cost()
            heapq.heappush(heap, (child.priority(), child))
            length_counts[allele_count + 1] += 1
            if allele_count + 1 >= min_progress:
                tracked += 1
        else:
            for a1, a2 in HAP_ORDER:
                if a1 == ALT and a2 == REF and top.identical:
                    continue
                child = _extend(top, a1, a2, h_next, reads, next(counter), 0)
                heapq.heappush(heap, (child.priority(), child))
                length_counts[allele_count + 1] += 1
                if allele_count + 1 >= min_progress:
                    tracked += 1

        while tracked > curr_queue_size_threshold and min_progress < next_expected:
            min_progress += 1
            tracked -= length_counts[min_progress - 1]
            if len(heap) > max_queue_size:
                # the reference's "full prune": immediately discard nodes that
                # are below min_progress instead of waiting to pop them
                # (ref: astar_phaser.rs:570-584); they count as pruned there
                # because clearing their priority pops them right away
                survivors = []
                for p, n in heap:
                    if n.depth() < min_progress:
                        if num_pruned == 0:
                            curr_queue_size_threshold = min_queue_size
                        num_pruned += 1
                        length_counts[n.depth()] -= 1
                    else:
                        survivors.append((p, n))
                heap = survivors
                heapq.heapify(heap)

    _, top = heapq.heappop(heap)
    assert top.depth() == num_variants, "A* failed to find a full solution"
    haplotype_1 = list(top.h1)
    haplotype_2 = list(top.h2)
    actual_cost = top.total_cost()

    phased = phased_snvs = homozygous = skipped = 0
    for i, (a1, a2) in enumerate(zip(haplotype_1, haplotype_2)):
        if a1 != a2:
            phased += 1
            if variants[i].variant_type == VariantType.SNV:
                phased_snvs += 1
        elif a1 == AMB:
            skipped += 1
        else:
            homozygous += 1

    stats = PhaseStats.astar_new(num_pruned, estimated_cost, actual_cost,
                                 phased, phased_snvs, homozygous, skipped)
    return AstarResult(haplotype_1, haplotype_2, stats)
