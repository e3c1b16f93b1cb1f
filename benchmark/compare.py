"""The comparison that decides ``correct``: every job of the window against
the first, and the first against the reference (reference/oracle.py).

Every number is a count of things that differ, and its limit is 0: the
program's outputs are exact (HiPhase's search and alignments are exact, and
every engine of the program must give the same bytes).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

from reference.oracle import (
    ENGINE_COLUMNS, STATS_KEY_COLUMNS, BlockExpect, Expectation)
from reference.writers.phase_stats import STATS_COLUMNS as STATS_HEADER


@dataclass
class JobOutputs:
    vcf: list[str]                     # data lines of the phased VCF
    stats_header: list[str]
    stats: dict[str, list[str]]        # block index -> row
    blocks: list[list[str]]            # --blocks-file rows


def read_outputs(out_dir: str) -> JobOutputs:
    with gzip.open(f"{out_dir}/out.vcf.gz", "rt") as fh:
        vcf = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    with open(f"{out_dir}/stats.tsv") as fh:
        header = fh.readline().rstrip("\n").split("\t")
        stats = {}
        for line in fh:
            row = line.rstrip("\n").split("\t")
            stats[row[0]] = row
    with open(f"{out_dir}/blocks.tsv") as fh:
        fh.readline()
        blocks = [line.rstrip("\n").split("\t") for line in fh]
    return JobOutputs(vcf, header, stats, blocks)


def read_input_vcf(path: str) -> list[str]:
    with gzip.open(path, "rt") as fh:
        return [line.rstrip("\n") for line in fh if not line.startswith("#")]


def _engine_free(header: list[str], row: list[str]) -> list[str]:
    drop = {header.index(c) for c in ENGINE_COLUMNS if c in header}
    return [v for i, v in enumerate(row) if i not in drop]


def jobs_unlike(first: JobOutputs, other: JobOutputs) -> bool:
    """Whether two jobs over the same inputs gave different outputs (the
    engine's own statistics aside)."""
    if first.vcf != other.vcf or first.blocks != other.blocks:
        return True
    if first.stats.keys() != other.stats.keys():
        return True
    return any(_engine_free(first.stats_header, first.stats[k])
               != _engine_free(other.stats_header, other.stats[k])
               for k in first.stats)


def against_reference(out: JobOutputs, exp: Expectation,
                      input_vcf: list[str],
                      notes: list[str] | None = None) -> dict[str, int]:
    """Counts of what differs between one job's outputs and the reference."""
    # every block of the dataset, with the whole row of an unphased one
    want = {k[0]: k for k in exp.blocks}
    unphased = {str(k): row for k, row in exp.unphased.items()}
    blocks = len(want.keys() ^ out.stats.keys())
    for key, cols in want.items():
        row = out.stats.get(key)
        if row is None:
            continue
        if key in unphased:
            blocks += row != unphased[key]
        else:
            # a solved block: its key columns, and read and solver
            # statistics in every column that the reference fills
            blocks += (row[:STATS_KEY_COLUMNS] != cols
                       or not all(row[STATS_KEY_COLUMNS:]))
    # every record: the input's fields up to INFO, in the input's order
    records = abs(len(out.vcf) - len(input_vcf)) + sum(
        a.split("\t", 8)[:8] != b.split("\t", 8)[:8]
        for a, b in zip(out.vcf, input_vcf))
    sampled = sampled_unlike(project(out, exp), exp.sampled, notes)
    return {"blocks_unlike_ref": blocks,
            "records_unlike_input": records, **sampled}


def project(out: JobOutputs, exp: Expectation) -> dict[int, BlockExpect]:
    """A job's outputs for the blocks the reference sampled, in the
    reference's form (None where a block has no stats row)."""
    by_pos: dict[tuple[str, int], str] = {}
    for line in out.vcf:
        chrom, pos, _ = line.split("\t", 2)
        by_pos[(chrom, int(pos) - 1)] = line
    got = {}
    for bi, be in exp.sampled.items():
        row = out.stats.get(str(bi))
        chrom = be.stats_row[2]
        got[bi] = BlockExpect(
            bi, row,
            [r for r in out.blocks if r[0] == str(bi)],
            {p: by_pos.get((chrom, p)) for p in be.vcf_lines})
    return got


def sampled_unlike(got: dict[int, BlockExpect],
                   want: dict[int, BlockExpect],
                   notes: list[str] | None = None) -> dict[str, int]:
    """What differs in the sampled blocks: --stats-file cells (the engine's
    own statistics aside), blocks whose --blocks-file rows differ, and VCF
    records. ``notes`` collects the first differences, in words."""
    notes = [] if notes is None else notes
    header = _engine_free(STATS_HEADER, STATS_HEADER)
    cells = sub_blocks = records = 0
    for bi, w in want.items():
        g = got.get(bi)
        want_row = _engine_free(STATS_HEADER, w.stats_row)
        if g is None or g.stats_row is None:
            cells += len(want_row)
            sub_blocks += 1
            records += len(w.vcf_lines)
            continue
        g_row = _engine_free(STATS_HEADER, g.stats_row)
        cells += abs(len(g_row) - len(want_row))
        for name, a, b in zip(header, g_row, want_row):
            if a != b:
                cells += 1
                notes.append(f"block {bi} stats {name}: {a} against {b}")
        if g.block_rows != w.block_rows:
            sub_blocks += 1
            notes.append(f"block {bi} blocks rows: {g.block_rows} against "
                         f"{w.block_rows}")
        for p, line in w.vcf_lines.items():
            if g.vcf_lines.get(p) != line:
                records += 1
                notes.append(f"block {bi} record: {g.vcf_lines.get(p)!r} "
                             f"against {line!r}")
    return {"sampled_stats_cells_unlike_ref": cells,
            "sampled_subblocks_unlike_ref": sub_blocks,
            "sampled_records_unlike_ref": records}


def checks(jobs: list[JobOutputs], failed: int, exp: Expectation,
           input_vcf: list[str], notes: list[str] | None = None
           ) -> dict[str, dict]:
    """Every number compared, each with its limit, in the order printed;
    ``notes`` collects the first differences with the reference."""
    out: dict[str, dict] = {
        "jobs_failed": {"value": failed, "limit": 0},
        "jobs_compared": {"value": len(jobs), "limit": 1, "at_least": True},
        "sampled_blocks": {"value": len(exp.sampled), "limit": 1,
                           "at_least": True},
    }
    if jobs:
        out["jobs_unlike_first"] = {
            "value": sum(jobs_unlike(jobs[0], j) for j in jobs[1:]),
            "limit": 0}
        for name, v in against_reference(jobs[0], exp, input_vcf,
                                          notes).items():
            out[name] = {"value": v, "limit": 0}
    return out


def passed(check: dict) -> bool:
    if check.get("at_least"):
        return check["value"] >= check["limit"]
    return check["value"] <= check["limit"]
