"""Algorithm statistics: per-block read/phasing stats and the --stats-file
writer (ref: src/writers/phase_stats.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from reference.core.variants import VariantType

NUM_TYPES = int(VariantType.UNKNOWN) + 1


def _zeros() -> np.ndarray:
    return np.zeros(NUM_TYPES, dtype=np.uint64)


@dataclass
class ReadStats:
    """Per-block allele-assignment statistics; per-type arrays are indexed by
    VariantType value (ref: phase_stats.rs:11-128)."""

    num_reads: int = 0
    skipped_reads: int = 0
    num_alleles: int = 0
    exact_matches: np.ndarray = field(default_factory=_zeros)
    inexact_matches: np.ndarray = field(default_factory=_zeros)
    failed_matches: np.ndarray = field(default_factory=_zeros)
    allele0_matches: np.ndarray = field(default_factory=_zeros)
    allele1_matches: np.ndarray = field(default_factory=_zeros)
    global_aligned: int = 0
    local_aligned: int = 0

    def validate(self) -> None:
        """Invariants (ref: phase_stats.rs:63-65)."""
        assert self.num_alleles >= self.num_reads
        assert self.num_alleles == int(self.exact_matches.sum()) + int(self.inexact_matches.sum())
        assert self.num_alleles == int(self.allele0_matches.sum()) + int(self.allele1_matches.sum())

    def __iadd__(self, rhs: "ReadStats") -> "ReadStats":
        self.num_reads += rhs.num_reads
        self.skipped_reads += rhs.skipped_reads
        self.num_alleles += rhs.num_alleles
        self.exact_matches += rhs.exact_matches
        self.inexact_matches += rhs.inexact_matches
        self.failed_matches += rhs.failed_matches
        self.allele0_matches += rhs.allele0_matches
        self.allele1_matches += rhs.allele1_matches
        self.global_aligned += rhs.global_aligned
        self.local_aligned += rhs.local_aligned
        return self

    def total_aligned(self) -> int:
        return self.local_aligned + self.global_aligned


@dataclass
class PhaseStats:
    """Solver statistics (ref: phase_stats.rs:130-199). ``pruned_solutions ==
    0`` means the result is provably optimal."""

    pruned_solutions: int | None = None
    estimated_cost: int | None = None
    actual_cost: int | None = None
    phased_variants: int | None = None
    phased_snvs: int | None = None
    homozygous_variants: int | None = None
    skipped_variants: int | None = None

    @classmethod
    def astar_new(cls, pruned_solutions, estimated_cost, actual_cost,
                  phased_variants, phased_snvs, homozygous_variants,
                  skipped_variants) -> "PhaseStats":
        assert actual_cost >= estimated_cost
        return cls(pruned_solutions, estimated_cost, actual_cost,
                   phased_variants, phased_snvs, homozygous_variants,
                   skipped_variants)

    def get_cost_ratio(self) -> float | None:
        if self.estimated_cost is None or self.actual_cost is None:
            return None
        if self.actual_cost == 0:
            assert self.estimated_cost == 0
            return 1.0
        return self.estimated_cost / self.actual_cost


STATS_COLUMNS = [
    "block_index", "sample_name", "chrom", "start", "end", "num_variants",
    "num_reads", "skipped_reads", "num_alleles", "allele_matches",
    "allele_partials", "allele_failures", "allele0_assigned",
    "allele1_assigned", "global_aligned", "local_aligned",
    "pruned_solutions", "estimated_cost", "actual_cost", "cost_ratio",
    "phased_variants", "homozygous_variants", "skipped_variants",
]


def _fmt_array(a: np.ndarray) -> str:
    """Rust Debug-format of a u64 array, e.g. '[1, 0, 2]'
    (ref: phase_stats.rs:293-297 uses format!("{:?}"))."""
    return "[" + ", ".join(str(int(v)) for v in a) + "]"


def _opt(v) -> str:
    return "" if v is None else str(v)


class StatsWriter:
    """--stats-file output: one row per input phase block
    (ref: phase_stats.rs:202-373). Delimiter by extension (.csv → comma)."""

    def __init__(self, filename: str):
        self.delimiter = "," if filename.endswith(".csv") else "\t"
        self._fh = open(filename, "w")
        self._fh.write(self.delimiter.join(STATS_COLUMNS) + "\n")

    def write_stats(self, phase_result) -> None:
        pb = phase_result.phase_block
        rs: ReadStats | None = phase_result.read_statistics
        ps: PhaseStats | None = phase_result.statistics
        row = [
            str(pb.block_index), pb.sample_name, pb.chrom,
            str(pb.start), str(pb.end), str(pb.num_variants),
        ]
        if rs is not None:
            row += [str(rs.num_reads), str(rs.skipped_reads), str(rs.num_alleles),
                    _fmt_array(rs.exact_matches), _fmt_array(rs.inexact_matches),
                    _fmt_array(rs.failed_matches), _fmt_array(rs.allele0_matches),
                    _fmt_array(rs.allele1_matches), str(rs.global_aligned),
                    str(rs.local_aligned)]
        else:
            row += [""] * 10
        if ps is not None:
            cr = ps.get_cost_ratio()
            row += [_opt(ps.pruned_solutions), _opt(ps.estimated_cost),
                    _opt(ps.actual_cost), "" if cr is None else repr(cr),
                    _opt(ps.phased_variants), _opt(ps.homozygous_variants),
                    _opt(ps.skipped_variants)]
        else:
            row += [""] * 7
        self._fh.write(self.delimiter.join(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
