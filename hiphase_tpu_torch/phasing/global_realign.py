"""Dual-mode allele assignment on the device WFA engine — the port's twin
of the per-read path of ``hiphase_tpu/phasing/global_realign.py``.

Only the aligner differs: the window graph's alignment runs through this
package's `align_reads_device` on an explicit torch device. Everything
around it is the JAX package's: the window graph from
``WFAGraph.from_reference_variants_with_hom``, `WFAGraphError` when the
device score exceeds ``--global-realignment-max-ed``, the host aligner for
reads the band ladder cannot certify (the reference's exactness rule, not
a device fallback), the NOV/AMB merge, 2× qualities, and the failure
ladder in encounter order (ref: read_parsing.rs:595-600). The host WFA
engine (``--wfa-engine host``) is the shared JAX-free module's.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from hiphase_tpu.align.wfa_graph import WFAGraph, WFAGraphError, WFAResult
from hiphase_tpu.core.read_segments import ReadSegment
from hiphase_tpu.core.reference_genome import ReferenceGenome
from hiphase_tpu.core.variants import Variant
from hiphase_tpu.io.bam import BamRecord, cached_alignment
from hiphase_tpu.phasing import global_realign as shared
from hiphase_tpu.phasing.block_gen import PhaseBlock, filter_out_alignment_record
from hiphase_tpu.phasing.global_realign import (
    AMB, NOV, USIZE_MAX, WfaBlockPack, _finish_groups, _GLOBAL_BASELINE,
)
from hiphase_tpu.phasing.read_parsing import (
    GlobalRealignmentConfig, build_r2q, local_realignment,
)
from hiphase_tpu.writers.phase_stats import ReadStats
from hiphase_tpu_torch.align.wfa_device import WfaCounters, align_reads_device

logger = logging.getLogger(__name__)


def read_window(phase_problem: PhaseBlock, read: BamRecord,
                variant_calls: list[Variant], hom_calls: list[Variant],
                reference_genome: ReferenceGenome, max_edit_distance: int,
                wfa_pack: WfaBlockPack | None = None):
    """The read's aligned subsequence and the window graph over the het and
    hom variants its mapping overlaps: (read_align, graph, node_to_alleles,
    first het overlap), or None when it overlaps no het
    (ref: read_parsing.rs:652-720)."""
    r2q, base = build_r2q(read)
    mapped = np.flatnonzero(r2q >= 0)
    assert mapped.size > 0
    min_position = base + int(mapped[0])
    max_position = base + int(mapped[-1])

    if wfa_pack is not None:
        lo = int(np.searchsorted(wfa_pack.het_pos, min_position, "left"))
        hi = int(np.searchsorted(wfa_pack.het_pos, max_position, "right"))
        first_overlap = lo if hi > lo else None
        last_overlap = hi
        num_overlaps = hi - lo
        hlo = int(np.searchsorted(wfa_pack.hom_pos, min_position, "left"))
        hhi = int(np.searchsorted(wfa_pack.hom_pos, max_position, "right"))
        first_hom_overlap = hlo if hhi > hlo else 0
        last_hom_overlap = hhi
    else:
        first_overlap = None
        last_overlap = 0
        num_overlaps = 0
        for i, variant in enumerate(variant_calls):
            if min_position <= variant.position <= max_position:
                if first_overlap is None:
                    first_overlap = i
                last_overlap = i + 1
                num_overlaps += 1
        first_hom_overlap = None
        last_hom_overlap = 0
        for i, variant in enumerate(hom_calls):
            if min_position <= variant.position <= max_position:
                if first_hom_overlap is None:
                    first_hom_overlap = i
                last_hom_overlap = i + 1
        if first_hom_overlap is None:
            first_hom_overlap = 0

    if num_overlaps == 0:
        return None

    read_sequence = read.query_sequence()
    read_start = int(r2q[min_position - base])
    read_end = int(r2q[max_position - base])
    read_align = read_sequence[read_start:read_end + 1]

    chrom_seq = reference_genome.get_full_chromosome(phase_problem.chrom)
    wfa_graph, node_to_alleles = WFAGraph.from_reference_variants_with_hom(
        chrom_seq,
        variant_calls[first_overlap:last_overlap],
        hom_calls[first_hom_overlap:last_hom_overlap],
        min_position, max_position + 1,
        max_edit_distance)
    return read_align, wfa_graph, node_to_alleles, first_overlap


def global_realignment(phase_problem: PhaseBlock, read: BamRecord,
                       variant_calls: list[Variant], hom_calls: list[Variant],
                       reference_genome: ReferenceGenome,
                       wfa_prune_distance: int, global_max_edit_distance: int,
                       device: torch.device,
                       wfa_pack: WfaBlockPack | None = None,
                       counters: WfaCounters | None = None
                       ) -> tuple[np.ndarray, np.ndarray, ReadStats, int]:
    """(ref: read_parsing.rs:652-867) with the graph aligned on
    ``device``. Raises WFAGraphError on max-ED."""
    num_variants = len(variant_calls)
    stats = ReadStats()
    window = read_window(phase_problem, read, variant_calls, hom_calls,
                         reference_genome, global_max_edit_distance,
                         wfa_pack)
    if window is None:
        stats.skipped_reads = 1
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint8), stats, USIZE_MAX)
    read_align, wfa_graph, node_to_alleles, first_overlap = window

    alleles = np.full(num_variants, NOV, dtype=np.uint8)
    got = align_reads_device(wfa_graph, [read_align], device,
                             counters=counters)[0]
    if got is not None:
        dev_score, traversed = got
        if dev_score > global_max_edit_distance:
            raise WFAGraphError(global_max_edit_distance)
        wfa_result = WFAResult(dev_score, traversed)
    else:
        # uncertified (band ladder exhausted): the host aligner decides
        wfa_result = wfa_graph.edit_distance_with_pruning(
            read_align, wfa_prune_distance)  # raises on max-ED
    score = wfa_result.score
    for node_index in wfa_result.traversed_nodes:
        for var_index, allele_assignment in node_to_alleles.get(
                node_index, []):
            ci = first_overlap + var_index
            if alleles[ci] == NOV:
                alleles[ci] = allele_assignment
            elif alleles[ci] != allele_assignment:
                alleles[ci] = AMB

    quals = np.zeros(num_variants, dtype=np.uint8)
    for i in range(num_variants):
        a = alleles[i]
        vt = variant_calls[i].variant_type
        vt_index = int(vt)
        if a == NOV:
            continue
        if a == AMB:
            stats.failed_matches[vt_index] += 1
            continue
        quals[i] = 2 * _GLOBAL_BASELINE[vt]  # global quals are 2× baseline
        stats.inexact_matches[vt_index] += 1  # all global matches count inexact
        if a == 0:
            stats.allele0_matches[vt_index] += 1
        else:
            stats.allele1_matches[vt_index] += 1
        stats.num_alleles += 1

    stats.global_aligned = 1
    return alleles, quals, stats, score


def load_full_read_segments(phase_problem: PhaseBlock, bam_paths: list[str],
                            variant_calls: list[Variant],
                            hom_calls: list[Variant],
                            reference_genome: ReferenceGenome,
                            min_matched_alleles: int, min_mapq: int,
                            config: GlobalRealignmentConfig,
                            device: torch.device | None,
                            counters: WfaCounters | None = None
                            ) -> tuple[list, list, ReadStats]:
    """Dual-mode loading with the failure ladder
    (ref: read_parsing.rs:520-637). ``--wfa-engine device`` aligns on
    ``device``; ``host`` is the shared module's path (``device`` unused)."""
    if config.wfa_engine != "device":
        return shared.load_full_read_segments(
            phase_problem, bam_paths, variant_calls, hom_calls,
            reference_genome, min_matched_alleles, min_mapq, config)
    from hiphase_tpu.io import native as native_mod
    from hiphase_tpu.phasing.variant_pack import build_variant_pack

    read_groups: dict = {}
    joint_stats = ReadStats()
    local_pack = build_variant_pack(variant_calls)
    wfa_pack = WfaBlockPack(variant_calls, hom_calls) \
        if native_mod.available() else None

    global_disabled = False
    num_global_failures = 0.0
    total_parsed = 0.0

    for bam_path in bam_paths:
        bam = cached_alignment(bam_path)
        for read in bam.fetch(phase_problem.chrom, phase_problem.start,
                              phase_problem.end + 1):
            if filter_out_alignment_record(read, min_mapq):
                continue
            if global_disabled:
                alleles, quals, read_stats = local_realignment(
                    read, variant_calls, pack=local_pack)
            else:
                try:
                    alleles, quals, read_stats, _score = global_realignment(
                        phase_problem, read, variant_calls, hom_calls,
                        reference_genome, config.wfa_prune_distance,
                        config.max_edit_distance, device, wfa_pack=wfa_pack,
                        counters=counters)
                except WFAGraphError:
                    logger.debug("Reverting to local re-alignment for %s...",
                                 read.read_name)
                    alleles, quals, read_stats = local_realignment(
                        read, variant_calls, pack=local_pack)

            if read_stats.skipped_reads == 0:
                read_groups.setdefault(read.read_name, []).append(
                    ReadSegment.new(read.read_name, alleles, quals))
                assert read_stats.total_aligned() == 1
                num_global_failures += read_stats.local_aligned
                total_parsed += 1.0
                if (not global_disabled
                        and num_global_failures >= config.global_failure_minimum
                        and num_global_failures / total_parsed
                        >= config.global_failure_ratio):
                    global_disabled = True
                    logger.info(
                        "B#%d Detected broad global realignment failure, "
                        "reverting to local for the rest of the block.",
                        phase_problem.block_index)
            joint_stats += read_stats

    return _finish_groups(read_groups, joint_stats, min_matched_alleles)
