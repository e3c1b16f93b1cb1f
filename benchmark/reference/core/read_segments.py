"""Read-allele segments: the per-read row of the phase-block allele matrix.

Re-designs the reference's ReadSegment (ref: src/data_types/read_segments.rs)
with numpy-backed rows so a phase block tensorizes directly into the dense
``[reads × variants]`` allele/qual matrices consumed by the TPU kernels.

Allele codes follow AlleleType: 0=Reference, 1=Alternate, 2=Ambiguous,
3=NoOverlap. An allele is "set" iff < 2. Quals are the 0↔1 flip costs;
unset alleles carry qual 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from reference.core.variants import AlleleType

AMBIGUOUS = int(AlleleType.AMBIGUOUS)
NO_OVERLAP = int(AlleleType.NO_OVERLAP)


@dataclass
class ReadSegment:
    """One read's allele calls over a phase block, trimmed to the window
    [start, end) between its first and last set allele
    (ref: read_segments.rs:40-62 — the v1.5.0 memory optimization).
    """

    read_name: str
    alleles: np.ndarray  # uint8, length end-start
    quals: np.ndarray    # uint8, length end-start
    start: int
    end: int

    @classmethod
    def new(cls, read_name: str, alleles: Sequence[int], quals: Sequence[int]) -> "ReadSegment":
        alleles = np.asarray(alleles, dtype=np.uint8)
        quals = np.asarray(quals, dtype=np.uint8)
        assert alleles.shape == quals.shape
        set_mask = alleles < AMBIGUOUS
        idx = np.flatnonzero(set_mask)
        if idx.size == 0:
            start = end = len(alleles)
        else:
            start = int(idx[0])
            end = int(idx[-1]) + 1
        return cls(read_name, alleles[start:end].copy(), quals[start:end].copy(), start, end)

    def allele(self, index: int) -> int:
        if self.start <= index < self.end:
            return int(self.alleles[index - self.start])
        return NO_OVERLAP

    def qual(self, index: int) -> int:
        if self.start <= index < self.end:
            return int(self.quals[index - self.start])
        return 0

    @property
    def region(self) -> range:
        return range(self.start, self.end)

    def get_num_set(self) -> int:
        """Count of set (0/1) alleles (ref: read_segments.rs:151-155)."""
        return int(np.count_nonzero(self.alleles < AMBIGUOUS))

    def score_haplotype(self, haplotype: Sequence[int]) -> int:
        assert self.end <= len(haplotype)
        return self.score_partial_haplotype(haplotype, 0)

    def score_partial_haplotype(self, haplotype: Sequence[int], offset: int) -> int:
        """Weighted-MEC cost of this read against a (partial) haplotype:
        Σ qual over positions where both the read allele and the haplotype
        allele are set and they disagree (ref: read_segments.rs:177-206).

        ``haplotype[i]`` corresponds to block variant ``offset + i``.
        """
        hap = np.asarray(haplotype, dtype=np.uint8)
        if len(hap) + offset <= self.start or offset >= self.end:
            return 0
        lo = max(self.start, offset)
        hi = min(self.end, offset + len(hap))
        a = self.alleles[lo - self.start:hi - self.start]
        q = self.quals[lo - self.start:hi - self.start]
        h = hap[lo - offset:hi - offset]
        mismatch = (h < AMBIGUOUS) & (a != h)
        return int(q[mismatch].astype(np.uint64).sum())

    def to_padded(self, num_variants: int) -> tuple[np.ndarray, np.ndarray]:
        """Expand back to a full-width (alleles, quals) row pair for
        tensorization into the block matrix."""
        alleles = np.full(num_variants, NO_OVERLAP, dtype=np.uint8)
        quals = np.zeros(num_variants, dtype=np.uint8)
        alleles[self.start:self.end] = self.alleles
        quals[self.start:self.end] = self.quals
        return alleles, quals


def read_segments_from_rows(names: Sequence[str], alleles2d: np.ndarray,
                            quals2d: np.ndarray,
                            rows: np.ndarray) -> list[ReadSegment]:
    """Vectorized ReadSegment.new over selected matrix rows (the native
    realigner returns whole-block [records x variants] matrices; per-row
    flatnonzero was a measurable share of prepare time at WGS scale)."""
    A = alleles2d[rows]
    Q = quals2d[rows]
    nv = A.shape[1]
    set_mask = A < AMBIGUOUS
    any_set = set_mask.any(axis=1)
    first = set_mask.argmax(axis=1)
    last = nv - set_mask[:, ::-1].argmax(axis=1)
    out = []
    for k, name in enumerate(names):
        if any_set[k]:
            s, e = int(first[k]), int(last[k])
        else:
            s = e = nv
        out.append(ReadSegment(name, A[k, s:e].copy(), Q[k, s:e].copy(),
                               s, e))
    return out


def collapse_read_segments(read_segments: Sequence[ReadSegment]) -> ReadSegment:
    """Merge multiple mappings of one read (supplementals, multi-SMRT-cell):
    agreeing set alleles keep max qual; conflicts → Ambiguous with qual 0
    (ref: read_segments.rs:71-121).
    """
    assert read_segments
    if len(read_segments) == 1:
        return read_segments[0]

    read_name = read_segments[0].read_name
    max_end = max(rs.end for rs in read_segments)
    alleles = np.full(max_end, NO_OVERLAP, dtype=np.uint8)
    quals = np.zeros(max_end, dtype=np.uint8)

    for rs in read_segments:
        assert rs.read_name == read_name
        for i in range(rs.start, rs.end):
            rsa = rs.alleles[i - rs.start]
            if rsa == NO_OVERLAP:
                continue
            if alleles[i] == NO_OVERLAP:
                alleles[i] = rsa
                quals[i] = rs.quals[i - rs.start]
            elif alleles[i] == AMBIGUOUS:
                pass  # stays ambiguous, qual stays 0
            elif alleles[i] == rsa:
                quals[i] = max(quals[i], rs.quals[i - rs.start])
            else:
                alleles[i] = AMBIGUOUS
                quals[i] = 0

    return ReadSegment.new(read_name, alleles, quals)
