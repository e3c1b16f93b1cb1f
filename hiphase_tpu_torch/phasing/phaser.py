"""Per-block phasing driver (ref: src/phaser.rs).

Split into prepare → solve → finalize so the orchestrator can run the solve
stage as a batched device beam over many blocks at once while
prepare/finalize stay host-side:

  prepare_block()  — load variants + reads, TR-overlap suppression; with
                     ``--wfa-engine device`` the dual-mode reads are aligned
                     on a torch device
  solve:            exact A* (host oracle, `solve_block`) or the batched
                     device beam (`parallel.orchestrator`)
  finalize_block() — post-solve block splitting, sub-block regen, haplotagging
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np

from hiphase_tpu_torch.core.read_segments import ReadSegment
from hiphase_tpu_torch.core.reference_genome import ReferenceGenome
from hiphase_tpu_torch.core.variants import AlleleType, Variant, VariantType
from hiphase_tpu_torch.io.vcf import VcfReader
from hiphase_tpu_torch.phasing import read_parsing
from hiphase_tpu_torch.phasing.astar import astar_solver
from hiphase_tpu_torch.phasing.block_gen import (
    PhaseBlock, get_variant_type, is_phasable_variant,
)
from hiphase_tpu_torch.tracing import OFF, Recorder
from hiphase_tpu_torch.writers.phase_stats import PhaseStats, ReadStats

if TYPE_CHECKING:
    import torch

    from hiphase_tpu_torch.align.wfa_device import WfaCounters

logger = logging.getLogger(__name__)

REF = int(AlleleType.REFERENCE)
AMB = int(AlleleType.AMBIGUOUS)


class PhaserError(Exception):
    pass


def _iter_block_variants(region: PhaseBlock, vcf_paths: list[str],
                         is_hom_allowed: bool):
    """Yield (vcf_index, pos, VariantType, gt_index0, gt_index1, alleles)
    for the block's phasable records, merged by (pos, vcf_index) — from the
    native chrom-scan arrays when available, else the streaming-record path
    (identical semantics; ref: phaser.rs:105-175)."""
    from hiphase_tpu_torch.io.vcf_scan import scan_chrom

    scans = []
    sample_indices = []
    for p in vcf_paths:
        from hiphase_tpu_torch.io.vcf import VcfReader
        samples = _vcf_samples(p)
        try:
            sample_indices.append(samples.index(region.sample_name))
        except ValueError:
            raise PhaserError(
                f"Sample name {region.sample_name!r} was not found in VCF: {p}")
        scan = scan_chrom(p, region.chrom, len(samples))
        scans.append(scan)

    if all(s is not None for s in scans):
        yield from _iter_block_variants_arrays(region, scans, sample_indices,
                                               is_hom_allowed)
        return
    yield from _iter_block_variants_records(region, vcf_paths, sample_indices,
                                            is_hom_allowed)


_VCF_SAMPLES_CACHE: dict[tuple[str, float], list[str]] = {}


def _vcf_samples(path: str) -> list[str]:
    import os

    from hiphase_tpu_torch.io.vcf import VcfReader
    key = (os.path.abspath(path), os.path.getmtime(path))
    hit = _VCF_SAMPLES_CACHE.get(key)
    if hit is None:
        if len(_VCF_SAMPLES_CACHE) > 64:
            _VCF_SAMPLES_CACHE.clear()
        hit = _VCF_SAMPLES_CACHE[key] = list(VcfReader(path).samples)
    return hit


def _iter_block_variants_arrays(region, scans, sample_indices,
                                is_hom_allowed: bool):
    import numpy as np

    cursors = []
    queue: list[tuple[int, int]] = []
    masks = []
    for vcf_index, (scan, sidx) in enumerate(zip(scans, sample_indices)):
        lo = int(np.searchsorted(scan.pos, region.start, "left"))
        hi = int(np.searchsorted(scan.pos, region.end, "right"))
        cursors.append([lo, hi])
        masks.append(scan.phasable_mask(sidx, region.min_quality,
                                        is_hom_allowed))
        if lo < hi:
            heapq.heappush(queue, (int(scan.pos[lo]), vcf_index))

    while queue:
        _pos, pop_index = heapq.heappop(queue)
        scan = scans[pop_index]
        sidx = sample_indices[pop_index]
        cur = cursors[pop_index]
        i = cur[0]
        cur[0] += 1
        if cur[0] < cur[1]:
            heapq.heappush(queue, (int(scan.pos[cur[0]]), pop_index))

        if scan.needs_python(i, sidx) or scan.ploidy[i, sidx] > 2:
            # identical errors/assertions via the record path
            record = scan.record(i)
            if not is_phasable_variant(record, sidx, region.min_quality,
                                       is_hom_allowed):
                continue
            gt, _ph = record.genotype(sidx)
            assert len(gt) <= 2
            ia0 = gt[0]
            ia1 = gt[1] if len(gt) > 1 else gt[0]
            assert ia0 is not None and ia1 is not None
            yield (pop_index, record.pos0, get_variant_type(record), ia0,
                   ia1, record.alleles())
            continue
        if not masks[pop_index][i]:
            continue
        yield (pop_index, int(scan.pos[i]), VariantType(int(scan.vtype[i])),
               int(scan.gt0[i, sidx]), int(scan.gt1[i, sidx]),
               scan.alleles(i))


def _iter_block_variants_records(region, vcf_paths, sample_indices,
                                 is_hom_allowed: bool):
    readers = [VcfReader(p) for p in vcf_paths]
    streams = []
    queue: list[tuple[int, int]] = []
    for vcf_index, rd in enumerate(readers):
        gen = rd.fetch(region.chrom, region.start, region.end + 1)
        head = next(gen, None)
        streams.append([head, gen])
        if head is not None:
            heapq.heappush(queue, (head.pos0, vcf_index))

    while queue:
        _pos, pop_index = heapq.heappop(queue)
        sample_index = sample_indices[pop_index]
        record = streams[pop_index][0]
        nxt = next(streams[pop_index][1], None)
        streams[pop_index][0] = nxt
        if nxt is not None:
            heapq.heappush(queue, (nxt.pos0, pop_index))

        position = record.pos0
        if position < region.start:
            continue  # long indel spanning a block break; already written
        if not is_phasable_variant(record, sample_index, region.min_quality,
                                   is_hom_allowed):
            continue
        gt, _phased = record.genotype(sample_index)
        assert len(gt) <= 2
        index_allele0 = gt[0]
        index_allele1 = gt[1] if len(gt) > 1 else gt[0]
        assert index_allele0 is not None and index_allele1 is not None
        yield (pop_index, position, get_variant_type(record), index_allele0,
               index_allele1, record.alleles())


def load_variant_calls(region: PhaseBlock, vcf_paths: list[str],
                       reference_genome: ReferenceGenome,
                       reference_buffer: int, is_hom_allowed: bool
                       ) -> tuple[list[Variant], list[Variant]]:
    """Load and normalize the block's variants (ref: phaser.rs:27-323).

    Returns (het variants, hom variants); homs are only collected when
    ``is_hom_allowed`` (global realignment on).
    """
    if region.num_variants == 0:
        return [], []

    variants: list[Variant] = []
    hom_variants: list[Variant] = []
    previous_het_end = 0

    for (pop_index, position, variant_type, index_allele0, index_allele1,
         all_alleles) in _iter_block_variants(region, vcf_paths,
                                              is_hom_allowed):
        if index_allele0 > index_allele1:
            index_allele0, index_allele1 = index_allele1, index_allele0

        # hom-alt loads as pseudo-het with allele0 = REF (ref: phaser.rs:161-169)
        is_homozygous = index_allele0 == index_allele1
        assert not is_homozygous or is_hom_allowed
        if is_homozygous:
            index_allele0 = 0

        ref_len = len(all_alleles[0])
        allele0 = all_alleles[index_allele0]
        allele1 = all_alleles[index_allele1]

        ctor = {
            VariantType.SNV: lambda: Variant.new_snv(
                pop_index, position, allele0, allele1, index_allele0, index_allele1),
            VariantType.DELETION: lambda: Variant.new_deletion(
                pop_index, position, ref_len, allele0, allele1, index_allele0, index_allele1),
            VariantType.INSERTION: lambda: Variant.new_insertion(
                pop_index, position, allele0, allele1, index_allele0, index_allele1),
            VariantType.INDEL: lambda: Variant.new_indel(
                pop_index, position, ref_len, allele0, allele1, index_allele0, index_allele1),
            VariantType.SV_DELETION: lambda: Variant.new_sv_deletion(
                pop_index, position, ref_len, allele0, allele1, index_allele0, index_allele1),
            VariantType.SV_INSERTION: lambda: Variant.new_sv_insertion(
                pop_index, position, ref_len, allele0, allele1, index_allele0, index_allele1),
            VariantType.TANDEM_REPEAT: lambda: Variant.new_tandem_repeat(
                pop_index, position, ref_len, allele0, allele1, index_allele0, index_allele1),
        }.get(variant_type)
        if ctor is None:
            raise PhaserError(f"no impl for {variant_type!r}")
        try:
            new_variant = ctor()
        except Exception as e:
            raise PhaserError(
                f"Error processing variant in VCF#{pop_index} at "
                f"{region.chrom}:{position + 1} : {e}")

        if reference_buffer > 0 and not is_homozygous:
            ref_prefix_start = max(position - reference_buffer, 0)
            ref_postfix_start = position + ref_len

            # IUPAC-tolerant REF-vs-genome check (ref: phaser.rs:247-269)
            ref_sequence = reference_genome.get_slice(
                region.chrom, position, ref_postfix_start)
            if all_alleles[0] != ref_sequence:
                masked = bytes(c if c in b"ACGT" else ord("N")
                               for c in ref_sequence)
                if all_alleles[0] != masked:
                    raise PhaserError(
                        f"Reference mismatch error: variant at "
                        f"{region.chrom}:{position + 1} has REF allele = "
                        f"\"{all_alleles[0].decode(errors='replace')}\", but "
                        f"reference genome has "
                        f"\"{ref_sequence.decode(errors='replace')}\".")

            # truncate the previous variant's postfix if we crowd it
            if ref_prefix_start < previous_het_end:
                v = variants[-1]
                current_end = v.position + v.ref_len + v.postfix_len
                truncate_length = min(current_end - position, v.postfix_len)
                v.truncate_reference_postfix(truncate_length)
                ref_prefix_start = min(previous_het_end, position)

            prefix = reference_genome.get_slice(
                region.chrom, ref_prefix_start, position)
            new_variant.add_reference_prefix(prefix)
            postfix = reference_genome.get_slice(
                region.chrom, ref_postfix_start,
                ref_postfix_start + reference_buffer)
            new_variant.add_reference_postfix(postfix)
            previous_het_end = position + ref_len

        if is_homozygous:
            hom_variants.append(new_variant)
        else:
            variants.append(new_variant)

    assert len(variants) == region.num_variants, \
        f"loaded {len(variants)} variants, block expects {region.num_variants}"
    return variants, hom_variants


@dataclass
class PhaseResult:
    """(ref: phaser.rs:326-343)"""

    phase_block: PhaseBlock
    variants: list[Variant]
    haplotype_1: list[int]
    haplotype_2: list[int]
    block_ids: list[int]
    sub_phase_blocks: list[PhaseBlock]
    read_statistics: ReadStats | None
    statistics: PhaseStats | None


@dataclass
class HaplotagResult:
    """(ref: phaser.rs:697-702): read name → (phase block id, haplotag 0/1)"""

    phase_block: PhaseBlock
    reads: dict[str, tuple[int, int]] = field(default_factory=dict)


def get_solution_span_counts(read_segments: list[ReadSegment],
                             haplotype_1: list[int], haplotype_2: list[int]
                             ) -> list[int]:
    """Spanning-read counts per juncture, ignoring homozygous-converted head/
    tail variants (ref: phaser.rs:350-388)."""
    assert len(haplotype_1) == len(haplotype_2)
    het = np.asarray(haplotype_1) != np.asarray(haplotype_2)
    # each read spans junctures [first het .. last het) of its window;
    # accumulate via a difference array instead of a per-juncture loop
    diff = np.zeros(len(haplotype_1) + 1, dtype=np.int64)
    for rs in read_segments:
        idx = np.flatnonzero(het[rs.start:rs.end])
        if idx.size >= 2:
            diff[rs.start + idx[0]] += 1
            diff[rs.start + idx[-1]] -= 1
    return np.cumsum(diff[:-2]).tolist()


def haplotag_reads(read_segments: list[ReadSegment], haplotype_1: list[int],
                   haplotype_2: list[int], block_tags: list[int]
                   ) -> dict[str, tuple[int, int]]:
    """Assign each read to the lower-cost haplotype; ties stay untagged
    (ref: phaser.rs:714-750)."""
    out: dict[str, tuple[int, int]] = {}
    segs = [rs for rs in read_segments if rs.end > rs.start]
    if not segs:
        return out
    h1 = np.asarray(haplotype_1, dtype=np.uint8)
    h2 = np.asarray(haplotype_2, dtype=np.uint8)
    het = h1 != h2
    # flat layout over all segments: per-read reductions via reduceat
    n = len(segs)
    lens = np.fromiter((rs.end - rs.start for rs in segs), np.int64, n)
    starts = np.fromiter((rs.start for rs in segs), np.int64, n)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    a = np.concatenate([rs.alleles for rs in segs])
    q = np.concatenate([rs.quals for rs in segs]).astype(np.int64)
    gidx = (np.arange(offs[-1], dtype=np.int64)
            - np.repeat(offs[:-1], lens) + np.repeat(starts, lens))
    hh1 = h1[gidx]
    hh2 = h2[gidx]
    s1 = np.add.reduceat(np.where((hh1 < AMB) & (a != hh1), q, 0), offs[:-1])
    s2 = np.add.reduceat(np.where((hh2 < AMB) & (a != hh2), q, 0), offs[:-1])
    # block id comes from the first het, resolved variant the read covers
    big = np.int64(2**62)
    firsts = np.minimum.reduceat(
        np.where(het[gidx] & (a < AMB), gidx, big), offs[:-1])
    for i in np.flatnonzero(s1 != s2):
        rs = segs[i]
        haplotag = 0 if s1[i] < s2[i] else 1
        assert firsts[i] < big
        assert rs.read_name not in out
        out[rs.read_name] = (block_tags[int(firsts[i])], haplotag)
    return out


@dataclass
class BlockData:
    """Host-side prepared inputs for one block's solve."""

    phase_block: PhaseBlock
    variants: list[Variant]
    hom_variants: list[Variant]
    read_segments: list[ReadSegment]
    phasable_segments: list[ReadSegment]
    read_stats: ReadStats


def _mark_tr_overlaps(variant_calls: list[Variant],
                      hom_calls: list[Variant]) -> None:
    """Ignore non-TR variants fully contained in a TandemRepeat span
    (ref: phaser.rs:448-511)."""
    tr_spans = [(v.position, v.position + v.ref_len)
                for v in variant_calls + hom_calls
                if v.variant_type == VariantType.TANDEM_REPEAT]
    if not tr_spans:
        return
    for v in variant_calls + hom_calls:
        if v.variant_type == VariantType.TANDEM_REPEAT:
            continue
        start, end = v.position, v.position + v.ref_len
        if any(s <= start and e >= end for s, e in tr_spans):
            v.set_ignored()


def prepare_block(phase_problem: PhaseBlock, vcf_paths: list[str],
                  bam_paths: list[str], reference_genome: ReferenceGenome,
                  reference_buffer: int, min_matched_alleles: int,
                  min_mapq: int,
                  global_config: read_parsing.GlobalRealignmentConfig | None,
                  device: torch.device | None = None,
                  wfa_counters: WfaCounters | None = None,
                  spans: Recorder = OFF) -> BlockData:
    """Load variants + reads for one block (the host half of solve_block).
    With ``--wfa-engine device`` the reads' window graphs are aligned on
    ``device``, counted in ``wfa_counters``, and the parts of the work are
    spans of ``spans``."""
    load_homs = global_config is not None
    with spans.span("prepare.variants"):
        variant_calls, hom_calls = load_variant_calls(
            phase_problem, vcf_paths, reference_genome, reference_buffer,
            load_homs)
        _mark_tr_overlaps(variant_calls, hom_calls)

    if global_config is not None:
        from hiphase_tpu_torch.phasing.global_realign import load_full_read_segments
        read_segments, phasable_segments, read_stats = load_full_read_segments(
            phase_problem, bam_paths, variant_calls, hom_calls,
            reference_genome, min_matched_alleles, min_mapq, global_config,
            device, wfa_counters, spans)
    else:
        read_segments, phasable_segments, read_stats = \
            read_parsing.load_read_segments(
                phase_problem, bam_paths, variant_calls,
                min_matched_alleles, min_mapq)
    return BlockData(phase_problem, variant_calls, hom_calls,
                     read_segments, phasable_segments, read_stats)


def finalize_block(data: BlockData, haplotype_1: list[int],
                   haplotype_2: list[int], statistics: PhaseStats
                   ) -> tuple[PhaseResult, HaplotagResult]:
    """Post-solve block splitting, sub-block regeneration and haplotagging
    (ref: phaser.rs:546-649)."""
    phase_problem = data.phase_block
    variant_calls = data.variants

    span_counts = get_solution_span_counts(
        data.read_segments, haplotype_1, haplotype_2)
    block_split = [c == 0 for c in span_counts]

    block_tags = [0] * len(variant_calls)
    current_tag = variant_calls[0].position
    for i, variant in enumerate(variant_calls):
        if i > 0 and block_split[i - 1]:
            current_tag = variant.position
        block_tags[i] = current_tag

    # regenerate non-empty sub-blocks for the stats outputs
    sub_phase_blocks: list[PhaseBlock] = []
    current_block = PhaseBlock.new(
        phase_problem.block_index, phase_problem.chrom,
        phase_problem.chrom_index, phase_problem.min_quality,
        phase_problem.sample_name, len(phase_problem.vcf_index_counts))
    current_tag = block_tags[0]
    for i, variant in enumerate(variant_calls):
        h1, h2 = haplotype_1[i], haplotype_2[i]
        if h1 < AMB and h2 < AMB and h1 != h2:
            if current_tag != block_tags[i]:
                if current_block.num_variants > 0:
                    sub_phase_blocks.append(current_block)
                    current_block = PhaseBlock.new(
                        phase_problem.block_index, phase_problem.chrom,
                        phase_problem.chrom_index, phase_problem.min_quality,
                        phase_problem.sample_name,
                        len(phase_problem.vcf_index_counts))
                current_tag = block_tags[i]
            current_block.add_locus_variant(
                phase_problem.chrom, variant.position, variant.vcf_index)
    if current_block.num_variants > 0:
        sub_phase_blocks.append(current_block)

    haplotagged = haplotag_reads(data.read_segments, haplotype_1,
                                 haplotype_2, block_tags)
    for name, val in haplotag_reads(data.phasable_segments, haplotype_1,
                                    haplotype_2, block_tags).items():
        assert name not in haplotagged
        haplotagged[name] = val

    phase_result = PhaseResult(
        phase_block=phase_problem,
        variants=variant_calls,
        haplotype_1=haplotype_1,
        haplotype_2=haplotype_2,
        block_ids=block_tags,
        sub_phase_blocks=sub_phase_blocks,
        read_statistics=data.read_stats,
        statistics=statistics,
    )
    haplotag_result = HaplotagResult(phase_block=phase_problem,
                                     reads=haplotagged)
    return phase_result, haplotag_result


def _empty_result(phase_problem: PhaseBlock) -> tuple[PhaseResult, HaplotagResult]:
    assert phase_problem.start == 0 and phase_problem.end == 0
    return (PhaseResult(phase_problem, [], [], [], [], [], None, None),
            HaplotagResult(phase_problem))


def create_unphased_result(phase_problem: PhaseBlock
                           ) -> tuple[PhaseResult, HaplotagResult]:
    """Dummy result for a block left unphased: all-Reference haplotypes are
    the 'leave unphased' sentinel (ref: phaser.rs:656-693)."""
    num_variants = phase_problem.num_variants
    variant_calls: list[Variant] = []
    for vcf_index, count in enumerate(phase_problem.vcf_index_counts):
        for _ in range(count):
            variant_calls.append(Variant.new_snv(
                vcf_index, phase_problem.start, b"\x00", b"\x01", 0, 1))
    assert len(variant_calls) == num_variants
    return (PhaseResult(
        phase_block=phase_problem,
        variants=variant_calls,
        haplotype_1=[REF] * num_variants,
        haplotype_2=[REF] * num_variants,
        block_ids=[phase_problem.start] * num_variants,
        sub_phase_blocks=[],
        read_statistics=None,
        statistics=None,
    ), HaplotagResult(phase_block=phase_problem))


def unset_allele_cost(data: BlockData) -> int:
    """What the host A* oracle adds to the cost of every solution of a
    block: the quals of each read's unset alleles (ambiguous, or no overlap
    inside its window) at the variants it phases, which it charges against
    both haplotypes (`astar._BlockReads.delta`). The beam leaves this
    constant out of its cost."""
    segs = data.read_segments
    if not segs:
        return 0
    alleles = np.concatenate([rs.alleles for rs in segs])
    quals = np.concatenate([rs.quals for rs in segs])
    starts = np.fromiter((rs.start for rs in segs), np.int64, len(segs))
    lens = np.fromiter((len(rs.alleles) for rs in segs), np.int64, len(segs))
    # the variant of each concatenated allele: its read's start plus its
    # offset inside the read
    variant = np.arange(alleles.size) + np.repeat(
        starts - (np.cumsum(lens) - lens), lens)
    ignored = np.fromiter((v.is_ignored for v in data.variants), bool,
                          len(data.variants))
    unset = (alleles >= AMB) & ~ignored[variant]
    return int(quals[unset].sum(dtype=np.int64))


def beam_phase_stats(data: BlockData, h1: list[int], h2: list[int],
                     cost: int, pruned: int, estimated_cost: int | None = None,
                     *, oracle_units: bool) -> PhaseStats:
    """PhaseStats of a beam solution: phased, SNV, homozygous and skipped
    counts from its haplotypes, and its cost in one of two units. The
    beam's own cost leaves out `unset_allele_cost`; `solve_block` reports
    it so, as the JAX package's does. With ``oracle_units`` the constant is
    added, so that the cost equals the host A* oracle's: the batched
    engines report it so in the --stats-file. ``estimated_cost`` (in the
    same units) defaults to the reported cost."""
    if oracle_units:
        cost += unset_allele_cost(data)
    if estimated_cost is None:
        estimated_cost = cost
    phased = sum(1 for a, b in zip(h1, h2) if a != b)
    phased_snvs = sum(
        1 for i, (a, b) in enumerate(zip(h1, h2))
        if a != b and data.variants[i].variant_type == VariantType.SNV)
    skipped = sum(1 for a, b in zip(h1, h2) if a == b == AMB)
    hom = len(h1) - phased - skipped
    return PhaseStats(pruned, estimated_cost, cost, phased, phased_snvs, hom,
                      skipped)


def solve_block(phase_problem: PhaseBlock, vcf_paths: list[str],
                bam_paths: list[str], reference_genome: ReferenceGenome,
                reference_buffer: int = 15, min_matched_alleles: int = 2,
                min_mapq: int = 5, min_queue_size: int = 1000,
                queue_increment: int = 3,
                global_config: read_parsing.GlobalRealignmentConfig | None = None,
                solver: str = "astar", *,
                device: torch.device | None = None
                ) -> tuple[PhaseResult, HaplotagResult]:
    """Single-block convenience path (ref: phaser.rs:406-649): the host A*
    oracle for ``solver="astar"``, else the beam on ``device`` (None: the
    CUDA device, raising `DeviceUnavailableError` without one) at width
    256, or at ``min_queue_size`` for ``"beam-full"``, unpadded. The beam
    engines batch many blocks around prepare/finalize
    (`parallel.orchestrator`, `phasing.native_beam`)."""
    if phase_problem.num_variants == 0:
        return _empty_result(phase_problem)
    if solver != "astar":
        from hiphase_tpu_torch.device import resolve_device
        device = resolve_device(device)

    data = prepare_block(phase_problem, vcf_paths, bam_paths,
                         reference_genome, reference_buffer,
                         min_matched_alleles, min_mapq, global_config)

    if solver == "astar":
        result = astar_solver(phase_problem.block_index, data.variants,
                              data.read_segments, min_queue_size,
                              queue_increment)
        return finalize_block(data, result.haplotype_1, result.haplotype_2,
                              result.statistics)
    from hiphase_tpu_torch.phasing.beam import solve_blocks, tensorize_block
    nv = len(data.variants)
    nr = max(len(data.read_segments), 1)
    alleles, quals, skip = tensorize_block(data.read_segments, data.variants,
                                           nr, nv)
    beam_width = min_queue_size if solver == "beam-full" else 256
    res = solve_blocks(alleles[None], quals[None], skip[None],
                       beam_width=beam_width, device=device)
    h1 = [int(x) for x in res.h1[0][:nv]]
    h2 = [int(x) for x in res.h2[0][:nv]]
    return finalize_block(data, h1, h2, beam_phase_stats(
        data, h1, h2, int(res.cost[0]), int(res.pruned[0]),
        oracle_units=False))
