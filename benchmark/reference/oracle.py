"""The plain reference of a phasing job: what every output of the job must
hold, worked out from the generated inputs alone.

It runs the frozen host modules beside this file (pure Python and NumPy,
the host A* oracle, the host graph WFA; see README.md) and imports nothing
of the program. For a dataset and a cell's settings it gives:

* every phase block of the dataset (block generation over all of it), with
  the leading columns of its --stats-file row, and the whole row of a block
  left unphased;
* for a sample of the solved blocks, drawn from the seed: the whole
  --stats-file row, the --blocks-file rows of its sub-blocks, and every
  output VCF record in its span, as the program's writers must give them.

The sampled blocks are solved in a pool of worker processes (spawned, one
reference genome each).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import random
from dataclasses import dataclass, field

# the program leaves these out of the comparison: the host A* oracle counts
# its own pruned nodes, the beam engines theirs (an engine's statistic)
ENGINE_COLUMNS = ("pruned_solutions",)


@dataclass(frozen=True)
class Settings:
    """The settings of a job, as the cell's configuration states them (the
    program gets the same as command-line flags)."""

    reference_buffer: int = 15
    min_matched_alleles: int = 2
    min_mapq: int = 5
    min_vcf_qual: int = 0
    min_spanning_reads: int = 1
    supplemental_joins: bool = True
    phase_singletons: bool = False
    min_queue_size: int = 1000
    queue_increment: int = 3
    global_realignment: dict | None = None  # GlobalRealignmentConfig kwargs


@dataclass
class Dataset:
    fasta: str
    vcf: str
    bam: str


@dataclass
class BlockExpect:
    """What the outputs must hold for one sampled block."""

    block_index: int
    stats_row: list[str]
    block_rows: list[list[str]]
    vcf_lines: dict[int, str]       # 0-based position -> record line
    seconds: float = 0.0


@dataclass
class Expectation:
    blocks: list[list[str]]          # every block: leading stats columns
    unphased: dict[int, list[str]]   # block index -> whole stats row
    sampled: dict[int, BlockExpect] = field(default_factory=dict)
    block_gen_seconds: float = 0.0


STATS_KEY_COLUMNS = 6  # block_index, sample_name, chrom, start, end, num_variants


def _block_iterator(ds: Dataset, st: Settings, sample: str):
    from reference.phasing.block_gen import (
        MultiPhaseBlockIterator, PhaseBlockIterator)
    return MultiPhaseBlockIterator([PhaseBlockIterator(
        [ds.vcf], [ds.bam], sample, min_quality=st.min_vcf_qual,
        min_mapq=st.min_mapq, min_spanning_reads=st.min_spanning_reads,
        allow_supplemental_joins=st.supplemental_joins)])


def should_solve(block, st: Settings) -> bool:
    """The program's rule (cli.main): a block is solved unless it is
    marked unphased, empty, or a singleton without --phase-singletons."""
    return (not block.unphased_block
            and (st.phase_singletons or block.num_variants > 1)
            and block.num_variants > 0)


def key_columns(block) -> list[str]:
    return [str(block.block_index), block.sample_name, block.chrom,
            str(block.start), str(block.end), str(block.num_variants)]


def stats_row(phase_result) -> list[str]:
    """One --stats-file row, as the writer formats it."""
    from reference.writers.phase_stats import _fmt_array, _opt
    row = key_columns(phase_result.phase_block)
    rs = phase_result.read_statistics
    ps = phase_result.statistics
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
    return row


def block_rows(phase_result) -> list[list[str]]:
    """The --blocks-file rows of one result's sub-blocks."""
    return [[str(b.block_index), b.sample_name, str(b.start + 1), b.chrom,
             str(b.start + 1), str(b.end + 1), str(b.num_variants)]
            for b in phase_result.sub_phase_blocks]


def vcf_lines(phase_result, vcf_path: str, min_vcf_qual: int
              ) -> dict[int, str]:
    """Every input record in the block's span as the ordered VCF writer
    rewrites it: the solver's alleles and PS where it phased a variant, the
    genotype unphased and sorted elsewhere (writers/vcf_writer.py)."""
    from reference.io.vcf import VcfReader
    from reference.phasing.block_gen import is_phasable_variant
    from reference.writers.vcf_rewrite import (
        UNDETERMINED_ALLELE, transform_record)

    pb = phase_result.phase_block
    by_pos = {}
    for i, h1 in enumerate(phase_result.haplotype_1):
        v = phase_result.variants[i]
        by_pos[v.position] = (v.convert_index(h1),
                              v.convert_index(phase_result.haplotype_2[i]),
                              phase_result.block_ids[i] + 1)
    reader = VcfReader(vcf_path)
    sample_index = reader.header.samples.index(pb.sample_name)
    out = {}
    for record in reader.fetch(pb.chrom, pb.start, pb.end + 1):
        if record.pos0 < pb.start or record.pos0 > pb.end:
            continue
        phased, flagged = {}, {}
        if is_phasable_variant(record, sample_index, min_vcf_qual, False):
            h1, h2, block_id = by_pos[record.pos0]
            if h1 == h2:
                if h1 == UNDETERMINED_ALLELE:
                    flagged[sample_index] = b"TR_OVERLAP"
            else:
                phased[sample_index] = (h1, h2, block_id)
        transform_record(record, phased, flagged)
        out[record.pos0] = b"\t".join(record.fields).decode()
    return out


# ---------------------------------------------------------------------------
# the pool of solving workers

_WORKER: dict = {}


def _init_worker(ds: Dataset, st: Settings, sample: str):
    from reference.core.reference_genome import ReferenceGenome
    _WORKER.update(ds=ds, st=st, sample=sample,
                   genome=ReferenceGenome.from_fasta(ds.fasta))


def _solve_one(block) -> BlockExpect:
    import time

    from reference.phasing.phaser import solve_block
    from reference.phasing.read_parsing import GlobalRealignmentConfig
    t0 = time.perf_counter()
    ds, st = _WORKER["ds"], _WORKER["st"]
    g = (GlobalRealignmentConfig(**st.global_realignment)
         if st.global_realignment is not None else None)
    result, _haplotags = solve_block(
        block, [ds.vcf], [ds.bam], _WORKER["genome"],
        reference_buffer=st.reference_buffer,
        min_matched_alleles=st.min_matched_alleles, min_mapq=st.min_mapq,
        min_queue_size=st.min_queue_size,
        queue_increment=st.queue_increment, global_config=g, solver="astar")
    return BlockExpect(block.block_index, stats_row(result),
                       block_rows(result),
                       vcf_lines(result, ds.vcf, st.min_vcf_qual),
                       time.perf_counter() - t0)


def sample_blocks(solvable: list[int], k: int, seed: int) -> list[int]:
    """``k`` block indices drawn from the seed (all of them when fewer)."""
    if len(solvable) <= k:
        return sorted(solvable)
    return sorted(random.Random(seed).sample(solvable, k))


def expect(ds: Dataset, st: Settings, sample: str, k: int, seed: int,
           workers: int, control: dict | None = None) -> Expectation:
    """The reference's expectation of a job over ``ds``. ``control``
    (Settings fields) solves the sampled blocks with those settings in
    place of the configuration's: the control, which breaks a guarantee
    that the configuration states. Block generation keeps the
    configuration's settings."""
    import time
    t0 = time.perf_counter()
    blocks = list(_block_iterator(ds, st, sample))
    exp = Expectation(blocks=[key_columns(b) for b in blocks],
                      unphased={b.block_index: key_columns(b) + [""] * 17
                                for b in blocks if not should_solve(b, st)},
                      block_gen_seconds=time.perf_counter() - t0)
    solvable = [b.block_index for b in blocks if should_solve(b, st)]
    chosen = set(sample_blocks(solvable, k, seed))
    todo = [b for b in blocks if b.block_index in chosen]
    # the largest first, so that the pool ends together
    todo.sort(key=lambda b: -b.num_variants)
    if not todo:
        return exp
    if control:
        st = dataclasses.replace(st, **control)
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(max(1, min(workers, len(todo))), initializer=_init_worker,
                    initargs=(ds, st, sample))
    try:
        for be in pool.imap_unordered(_solve_one, todo):
            exp.sampled[be.block_index] = be
        pool.close()
    finally:
        pool.terminate()
        pool.join()
    return exp
