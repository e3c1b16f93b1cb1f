"""Whole-genome FASTA store (ref: src/data_types/reference_genome.rs).

Loads the full FASTA (plain or gzip, sniffed by extension) into memory as
uppercased byte strings per contig, preserving file order of contigs.
"""

from __future__ import annotations

import gzip
import logging

logger = logging.getLogger(__name__)


class ReferenceGenome:
    def __init__(self, filename: str | None = None):
        self._contigs: dict[str, bytes] = {}
        self.filename = filename
        if filename is not None:
            self._load(filename)

    @classmethod
    def from_fasta(cls, filename: str) -> "ReferenceGenome":
        return cls(filename)

    @classmethod
    def from_dict(cls, contigs: dict[str, bytes]) -> "ReferenceGenome":
        rg = cls(None)
        rg._contigs = {k: bytes(v).upper() for k, v in contigs.items()}
        return rg

    def _load(self, filename: str) -> None:
        """Bulk-vectorized parse: a 3 Gb genome is a few numpy passes, not
        ~40M Python line iterations (the reference loads the same data in
        ~20 s via Rust; this takes a comparable few seconds)."""
        import numpy as np

        opener = gzip.open if filename.endswith(".gz") else open
        with opener(filename, "rb") as fh:
            data = fh.read()
        arr = np.frombuffer(data, dtype=np.uint8)
        if len(arr) == 0:
            return
        # line starts: offset 0 plus after every newline
        nl = np.flatnonzero(arr == 10)
        line_starts = np.concatenate(([0], nl + 1))
        line_starts = line_starts[line_starts < len(arr)]
        header_starts = line_starts[arr[line_starts] == ord(">")]
        bounds = np.concatenate((header_starts, [len(arr)]))
        for k in range(len(header_starts)):
            h0 = int(bounds[k])
            h_end = data.find(b"\n", h0)
            if h_end < 0:
                h_end = len(data)
            name = data[h0 + 1:h_end].split()[0].decode()
            region = arr[h_end + 1:int(bounds[k + 1])]
            seq = region[(region != 10) & (region != 13)]
            # uppercase a-z in place of Python .upper() over gigabytes
            lower = (seq >= 97) & (seq <= 122)
            if lower.any():
                seq = np.where(lower, seq - 32, seq)
            self._contigs[name] = seq.tobytes()

    def contig_keys(self) -> list[str]:
        """Contig names in file order (ref: reference_genome.rs:65)."""
        return list(self._contigs.keys())

    def has_contig(self, chrom: str) -> bool:
        return chrom in self._contigs

    def contig_length(self, chrom: str) -> int:
        return len(self._contigs[chrom])

    def get_full_chromosome(self, chrom: str) -> bytes:
        return self._contigs[chrom]

    def get_slice(self, chrom: str, start: int, end: int) -> bytes:
        """[start, end) slice with clamping warnings
        (ref: reference_genome.rs:78-90)."""
        seq = self._contigs[chrom]
        if start > len(seq) or end > len(seq):
            logger.warning(
                "get_slice(%s, %d, %d) clamped to contig length %d",
                chrom, start, end, len(seq))
            start = min(start, len(seq))
            end = min(end, len(seq))
        return seq[start:end]
