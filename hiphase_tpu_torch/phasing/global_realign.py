"""Global realignment: graph-WFA allele assignment with the deterministic
fallback ladder (ref: src/read_parsing.rs:520-867).

Per read: build the window WFA graph over the het+hom variants the mapping
overlaps, align the read's aligned subsequence, and map traversed branch
nodes back to allele assignments (conflicts → Ambiguous). Qualities are
exactly 2× the per-type baselines. On MaxEditDistance the read falls back to
local realignment; once failures reach the configured count AND ratio, the
whole block reverts to local for the remainder (encounter order preserved —
a determinism requirement, ref: CHANGELOG.md:33-46).

Two aligners, chosen by ``--wfa-engine``:

  * ``host`` — the reference's host path (the C++ wavefront aligner through
    ``io/native.py``, batched per fetched record chunk, else the Python
    aligner read by read). This is ``hiphase_tpu/phasing/global_realign.py``.
  * ``device`` — the banded graph DP of `align.wfa_device` on an explicit
    torch device, in two passes over a block's reads: pass 1 finds every
    read's window and aligns all of them in one batched band ladder (a few
    kernel launches per block). Where the block's BAMs fetch raw, pass 1
    finds the windows in C++, one call over the block's raw records
    (``csrc/wfa_windows.cc``, `_native_pass1`), and in Python
    (`_aligned_span`) elsewhere. Pass 2 walks the reads in BAM order as the
    host path does — the host aligner for reads the ladder could not
    certify (the reference's exactness rule, not a device fallback),
    ``WFAGraphError`` when the device score exceeds
    ``--global-realignment-max-ed``, and the failure ladder. Results of
    reads after the ladder trips are discarded unused. The ladder's first
    step builds every window's graph in the kernel's batch layout in C++
    (the native window packer, ``csrc/wfa_pack.cc``), and pass 2 assigns a
    certified read's alleles from the packer's (node, variant, allele)
    triples; a read's Python window graph (`read_window`) is built only
    where the packer refused the window (every window, where its library
    is not bound) or the ladder certified no result.
"""

from __future__ import annotations

import logging

import numpy as np

from hiphase_tpu_torch.align.wfa_graph import WFAGraph, WFAGraphError, WFAResult
from hiphase_tpu_torch.core.read_segments import ReadSegment, collapse_read_segments
from hiphase_tpu_torch.core.reference_genome import ReferenceGenome
from hiphase_tpu_torch.core.variants import Variant, VariantType
from hiphase_tpu_torch.io.bam import BamRecord, cached_alignment
from hiphase_tpu_torch.phasing.block_gen import PhaseBlock, filter_out_alignment_record
from hiphase_tpu_torch.phasing.read_parsing import (
    GlobalRealignmentConfig, INDEL_QUAL, SNV_QUAL, SV_INDEL_QUAL, TR_QUAL,
    build_r2q, local_realignment,
)
from hiphase_tpu_torch.tracing import OFF
from hiphase_tpu_torch.writers.phase_stats import ReadStats

logger = logging.getLogger(__name__)

USIZE_MAX = 2**63 - 1

_GLOBAL_BASELINE = {
    VariantType.SNV: SNV_QUAL,
    VariantType.DELETION: INDEL_QUAL,
    VariantType.INSERTION: INDEL_QUAL,
    VariantType.INDEL: INDEL_QUAL,
    VariantType.SV_DELETION: SV_INDEL_QUAL,
    VariantType.SV_INSERTION: SV_INDEL_QUAL,
    VariantType.TANDEM_REPEAT: TR_QUAL,
}

NOV = 3
AMB = 2


class WfaBlockPack:
    """Block-level arrays for the native graph builder: the merged
    (het + hom, position-sorted) variant windows and truncated-allele blobs
    are constant across a block's reads, so they are packed once. Het
    entries carry their absolute variant index; homs carry -1."""

    def __init__(self, variant_calls: list[Variant], hom_calls: list[Variant]):
        # sorted position arrays for the per-read overlap searches
        self.het_pos = np.fromiter((v.position for v in variant_calls),
                                   np.int64, len(variant_calls))
        self.hom_pos = np.fromiter((v.position for v in hom_calls),
                                   np.int64, len(hom_calls))
        merged = [(v, i) for i, v in enumerate(variant_calls)
                  if not v.is_ignored] + \
                 [(v, -1) for v in hom_calls if not v.is_ignored]
        merged.sort(key=lambda t: t[0].position)
        n = len(merged)
        self.n = n
        self.pos = np.fromiter((v.position for v, _ in merged), np.int64, n)
        self.ref_len = np.fromiter((v.ref_len for v, _ in merged), np.int64, n)
        self.var_index = np.fromiter((i for _, i in merged), np.int32, n)
        self.a0_is_alt = np.fromiter((v.index_allele0 != 0 for v, _ in merged),
                                     np.uint8, n)
        chunks = []
        self.a0_off = np.zeros(n, np.int64)
        self.a0_len = np.zeros(n, np.int64)
        self.a1_off = np.zeros(n, np.int64)
        self.a1_len = np.zeros(n, np.int64)
        off = 0
        for k, (v, _) in enumerate(merged):
            t0 = v.get_truncated_allele0()
            t1 = v.get_truncated_allele1()
            self.a0_off[k] = off
            self.a0_len[k] = len(t0)
            chunks.append(t0)
            off += len(t0)
            self.a1_off[k] = off
            self.a1_len[k] = len(t1)
            chunks.append(t1)
            off += len(t1)
        self.blob = np.frombuffer(b"".join(chunks), np.uint8) if off else \
            np.zeros(1, np.uint8)


def _native_global_assign(pack: WfaBlockPack, chrom_seq: bytes,
                          ref_start: int, ref_end: int, read_align: bytes,
                          wfa_prune_distance: int, max_edit_distance: int,
                          alleles: np.ndarray):
    """Native fast path: build the window graph and align in C++, writing
    allele assignments for traversed branches into ``alleles``.
    Returns the WFA score, or None to use the Python path."""
    from hiphase_tpu_torch.io import native
    if not native.available():
        return None
    built = native.wfa_build(chrom_seq, ref_start, ref_end, pack.pos,
                             pack.ref_len, pack.var_index, pack.a0_is_alt,
                             pack.blob, pack.a0_off, pack.a0_len,
                             pack.a1_off, pack.a1_len)
    if built is None:
        return None
    node_off, node_blob, edge_off, edge_dst, (an, av, aa) = built
    out = native.wfa_align(node_blob, node_off, edge_dst, edge_off,
                           read_align, min(wfa_prune_distance, USIZE_MAX),
                           min(max_edit_distance, USIZE_MAX))
    if out is None:
        return None
    score, traversed = out
    if score < 0:
        raise WFAGraphError(max_edit_distance)
    for k in range(len(an)):
        if not traversed[an[k]]:
            continue
        vi = int(av[k])
        if vi < 0:
            continue  # hom branch
        if alleles[vi] == NOV:
            alleles[vi] = aa[k]
        elif alleles[vi] != aa[k]:
            alleles[vi] = AMB
    return score


def _read_overlaps(read: BamRecord, variant_calls: list[Variant],
                   hom_calls: list[Variant], wfa_pack: WfaBlockPack | None):
    """The read's mapped span and the het/hom variants it overlaps:
    (r2q, base, min_position, max_position, first_overlap, last_overlap,
    num_overlaps, first_hom_overlap, last_hom_overlap)."""
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
    return (r2q, base, min_position, max_position, first_overlap,
            last_overlap, num_overlaps, first_hom_overlap, last_hom_overlap)


def _mark_traversed(alleles: np.ndarray, wfa_result: WFAResult,
                    node_to_alleles: dict, first_overlap: int) -> None:
    """Allele assignments of the traversed branch nodes; a variant reached
    with two different alleles becomes Ambiguous."""
    for node_index in wfa_result.traversed_nodes:
        for var_index, allele_assignment in node_to_alleles.get(
                node_index, []):
            ci = first_overlap + var_index
            if alleles[ci] == NOV:
                alleles[ci] = allele_assignment
            elif alleles[ci] != allele_assignment:
                alleles[ci] = AMB


def _global_quals(alleles: np.ndarray, variant_calls: list[Variant],
                  stats: ReadStats) -> np.ndarray:
    """2× baseline qualities of the assigned alleles, counted in ``stats``."""
    num_variants = len(variant_calls)
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
    return quals


def global_realignment(phase_problem: PhaseBlock, read: BamRecord,
                       variant_calls: list[Variant], hom_calls: list[Variant],
                       reference_genome: ReferenceGenome,
                       wfa_prune_distance: int, global_max_edit_distance: int,
                       wfa_pack: WfaBlockPack | None = None
                       ) -> tuple[np.ndarray, np.ndarray, ReadStats, int]:
    """(ref: read_parsing.rs:652-867) on the host aligner. Raises
    WFAGraphError on max-ED."""
    num_variants = len(variant_calls)
    stats = ReadStats()

    (r2q, base, min_position, max_position, first_overlap, last_overlap,
     num_overlaps, first_hom_overlap, last_hom_overlap) = _read_overlaps(
        read, variant_calls, hom_calls, wfa_pack)

    if num_overlaps == 0:
        stats.skipped_reads = 1
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint8), stats, USIZE_MAX)

    read_sequence = read.query_sequence()
    read_start = int(r2q[min_position - base])
    read_end = int(r2q[max_position - base])
    read_align = read_sequence[read_start:read_end + 1]

    chrom_seq = reference_genome.get_full_chromosome(phase_problem.chrom)
    alleles = np.full(num_variants, NOV, dtype=np.uint8)
    score = None
    if wfa_pack is not None:
        # fast path: block-level pack → native build + align, zero per-read
        # python graph work (the C++ builder window-filters identically)
        score = _native_global_assign(
            wfa_pack, chrom_seq, min_position, max_position + 1, read_align,
            wfa_prune_distance, global_max_edit_distance, alleles)
    if score is None:
        wfa_graph, node_to_alleles = WFAGraph.from_reference_variants_with_hom(
            chrom_seq,
            variant_calls[first_overlap:last_overlap],
            hom_calls[first_hom_overlap:last_hom_overlap],
            min_position, max_position + 1,
            global_max_edit_distance)
        wfa_result = wfa_graph.edit_distance_with_pruning(
            read_align, wfa_prune_distance)  # raises on max-ED
        score = wfa_result.score
        _mark_traversed(alleles, wfa_result, node_to_alleles, first_overlap)

    quals = _global_quals(alleles, variant_calls, stats)
    return alleles, quals, stats, score


def _finish_groups(read_groups, joint_stats, min_matched_alleles
                   ) -> tuple[list[ReadSegment], list[ReadSegment], ReadStats]:
    """Collapse per-name segment groups and split by min_matched_alleles
    (ref: read_parsing.rs:611-629)."""
    read_segments: list[ReadSegment] = []
    phasable_segments: list[ReadSegment] = []
    for _name, group in read_groups.items():
        collapsed = collapse_read_segments(group)
        num_set = collapsed.get_num_set()
        if num_set >= min_matched_alleles:
            read_segments.append(collapsed)
            joint_stats.num_reads += len(group)
        else:
            joint_stats.skipped_reads += len(group)
            if num_set > 0:
                phasable_segments.append(collapsed)
    return read_segments, phasable_segments, joint_stats


class _Ladder:
    """Mutable failure-ladder state shared across BAMs of a block
    (ref: read_parsing.rs:595-600)."""

    def __init__(self, config: GlobalRealignmentConfig):
        self.config = config
        self.disabled = False
        self.failures = 0.0
        self.total = 0.0

    def record(self, was_local_fallback: bool) -> None:
        self.failures += 1.0 if was_local_fallback else 0.0
        self.total += 1.0
        if (not self.disabled
                and self.failures >= self.config.global_failure_minimum
                and self.failures / self.total
                >= self.config.global_failure_ratio):
            self.disabled = True


def _block_reads(phase_problem: PhaseBlock, bam_paths: list[str],
                 min_mapq: int):
    """The block's reads that pass the filters, BAM by BAM, in encounter
    order."""
    for bam_path in bam_paths:
        bam = cached_alignment(bam_path)
        for read in bam.fetch(phase_problem.chrom, phase_problem.start,
                              phase_problem.end + 1):
            if not filter_out_alignment_record(read, min_mapq):
                yield read


def _assign_in_order(reads, assign_global, phase_problem: PhaseBlock,
                     variant_calls: list[Variant], local_pack,
                     config: GlobalRealignmentConfig, read_groups,
                     joint_stats: ReadStats) -> None:
    """The failure ladder over a block's reads in encounter order (the
    determinism contract, ref: read_parsing.rs:595-629): read i is assigned
    by ``assign_global(i, read)`` (alleles, quals, stats; raises
    WFAGraphError on max-ED, which sends the read to local realignment)
    until the ladder trips, and by local realignment after it. Fills
    ``read_groups`` and ``joint_stats``."""
    ladder = _Ladder(config)
    for i, read in enumerate(reads):
        if ladder.disabled:
            alleles, quals, read_stats = local_realignment(
                read, variant_calls, pack=local_pack)
        else:
            try:
                alleles, quals, read_stats = assign_global(i, read)
            except WFAGraphError:
                logger.debug("Reverting to local re-alignment for %s...",
                             read.read_name)
                alleles, quals, read_stats = local_realignment(
                    read, variant_calls, pack=local_pack)

        if read_stats.skipped_reads == 0:
            read_groups.setdefault(read.read_name, []).append(
                ReadSegment.new(read.read_name, alleles, quals))
            assert read_stats.total_aligned() == 1
            if not ladder.disabled:
                ladder.record(read_stats.local_aligned > 0)
                if ladder.disabled:
                    logger.info(
                        "B#%d Detected broad global realignment failure, "
                        "reverting to local for the rest of the block.",
                        phase_problem.block_index)
        joint_stats += read_stats


def _global_batch_chunk(raw, rec_off, rec_size, phase_problem, variant_calls,
                        hom_calls, reference_genome, config, wfa_pack,
                        local_pack, chrom_seq, ladder: _Ladder,
                        read_groups, joint_stats) -> bool:
    """Batched dual-mode assignment for one fetched record chunk: one native
    graph-WFA call over all records (threaded), batched local realignment
    for the fallbacks, ladder decisions applied host-side in encounter order
    (the determinism contract, ref: CHANGELOG.md:33-46). Returns False to
    use the per-read path."""
    from hiphase_tpu_torch.io import native as native_mod

    het_pos = np.fromiter((v.position for v in variant_calls), np.int64,
                          len(variant_calls))
    out = native_mod.wfa_batch(raw, rec_off, rec_size, chrom_seq, het_pos,
                               wfa_pack, min(config.wfa_prune_distance,
                                             USIZE_MAX),
                               min(config.max_edit_distance, USIZE_MAX))
    if out is None:
        return False
    scores, gall = out
    n = len(rec_off)
    local_rows: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}

    def run_local(idxs) -> bool:
        idxs = np.asarray(idxs, dtype=np.int64)
        if not len(idxs):
            return True
        lr = native_mod.realign_block(raw, rec_off[idxs], rec_size[idxs],
                                      local_pack, SV_INDEL_QUAL)
        if lr is None:
            return False
        la, lq, lnov, lstats = lr
        nt = lstats[:55].reshape(5, 11)
        joint_stats.failed_matches += nt[0].astype(np.uint64)
        joint_stats.exact_matches += nt[1].astype(np.uint64)
        joint_stats.inexact_matches += nt[2].astype(np.uint64)
        joint_stats.allele0_matches += nt[3].astype(np.uint64)
        joint_stats.allele1_matches += nt[4].astype(np.uint64)
        joint_stats.num_alleles += int(lstats[55])
        joint_stats.skipped_reads += int(lstats[56])
        joint_stats.local_aligned += int(lstats[57])
        for j, idx in enumerate(idxs):
            local_rows[int(idx)] = (la[j], lq[j], int(lnov[j]))
        return True

    if not run_local(np.flatnonzero(scores == -1)):
        return False

    # per-read host path for scratch-overflow records (rare)
    py_rows: dict[int, tuple] = {}
    for i in np.flatnonzero(scores == -3):
        i = int(i)
        rec = BamRecord.parse(raw[int(rec_off[i]):
                                  int(rec_off[i]) + int(rec_size[i])].tobytes())
        try:
            alleles, quals, rstats, _sc = global_realignment(
                phase_problem, rec, variant_calls, hom_calls,
                reference_genome, config.wfa_prune_distance,
                config.max_edit_distance, wfa_pack=None)
            py_rows[i] = ("global", alleles, quals, rstats)
        except WFAGraphError:
            alleles, quals, rstats = local_realignment(rec, variant_calls,
                                                       pack=local_pack)
            py_rows[i] = ("local", alleles, quals, rstats)

    # walk 1: apply the ladder in encounter order; reads after the flipping
    # read use local for the rest of the block (ref: read_parsing.rs:595-600)
    if ladder.disabled:
        flip_at = 0
    else:
        flip_at = n
        for i in range(n):
            s = int(scores[i])
            if s == -2:
                continue  # no het overlap: skipped, no ladder update
            if s == -3:
                kind, _a, _q, rstats = py_rows[i]
                if rstats.skipped_reads == 0:
                    ladder.record(kind == "local")
            elif s == -1:
                if local_rows[i][2] > 0:
                    ladder.record(True)
            else:
                ladder.record(False)
            if ladder.disabled:
                flip_at = i + 1
                break

    # post-flip records all use local (ref: read_parsing.rs:556-558)
    need_local = [i for i in range(flip_at, n) if i not in local_rows]
    if not run_local(need_local):
        return False

    # walk 2: emit segments + global stats in encounter order
    qual2x = (2 * local_pack.baseline).astype(np.uint8)
    vt = local_pack.vt_index
    g_rows = []
    for i in range(n):
        use_local = i >= flip_at or int(scores[i]) == -1
        off = int(rec_off[i])
        l_name = int(raw[off + 8])
        name = raw[off + 32:off + 32 + l_name - 1].tobytes().decode()
        if use_local:
            la, lq, lnov = local_rows[i]
            if lnov > 0:
                read_groups.setdefault(name, []).append(
                    ReadSegment.new(name, la, lq))
            continue
        s = int(scores[i])
        if s == -2:
            joint_stats.skipped_reads += 1
            continue
        if s == -3:
            kind, alleles, quals, rstats = py_rows[i]
            if rstats.skipped_reads == 0:
                read_groups.setdefault(name, []).append(
                    ReadSegment.new(name, alleles, quals))
            joint_stats += rstats
            continue
        row = gall[i]
        quals = np.where(row < 2, qual2x, 0).astype(np.uint8)
        read_groups.setdefault(name, []).append(
            ReadSegment.new(name, row, quals))
        g_rows.append(i)

    if g_rows:
        G = gall[np.asarray(g_rows)]
        vt_b = np.broadcast_to(vt, G.shape)
        np.add.at(joint_stats.failed_matches, vt_b[G == 2], 1)
        set_mask = G < 2
        np.add.at(joint_stats.inexact_matches, vt_b[set_mask], 1)
        np.add.at(joint_stats.allele0_matches, vt_b[G == 0], 1)
        np.add.at(joint_stats.allele1_matches, vt_b[G == 1], 1)
        joint_stats.num_alleles += int(set_mask.sum())
        joint_stats.global_aligned += len(g_rows)
    return True


def load_full_read_segments(phase_problem: PhaseBlock, bam_paths: list[str],
                            variant_calls: list[Variant],
                            hom_calls: list[Variant],
                            reference_genome: ReferenceGenome,
                            min_matched_alleles: int, min_mapq: int,
                            config: GlobalRealignmentConfig,
                            device=None, counters=None, spans=OFF
                            ) -> tuple[list[ReadSegment], list[ReadSegment], ReadStats]:
    """Dual-mode loading with the failure ladder
    (ref: read_parsing.rs:520-637). ``--wfa-engine device`` aligns on the
    torch ``device``, counted in ``counters`` (an `align.wfa_device.WfaCounters`),
    its parts timed as spans of ``spans`` (a `tracing.Recorder`); the host
    engine uses none of them."""
    if config.wfa_engine == "device":
        return _load_full_read_segments_device(
            phase_problem, bam_paths, variant_calls, hom_calls,
            reference_genome, min_matched_alleles, min_mapq, config, device,
            counters, spans)
    from hiphase_tpu_torch.io import native as native_mod
    from hiphase_tpu_torch.phasing.variant_pack import build_variant_pack

    read_groups: dict[str, list[ReadSegment]] = {}
    joint_stats = ReadStats()
    local_pack = build_variant_pack(variant_calls)
    wfa_pack = WfaBlockPack(variant_calls, hom_calls) \
        if native_mod.available() else None

    if wfa_pack is not None:
        ladder = _Ladder(config)
        chrom_seq = reference_genome.get_full_chromosome(phase_problem.chrom)
        batched_ok = True
        for bam_path in bam_paths:
            bam = cached_alignment(bam_path)
            chunks = bam.fetch_raw(phase_problem.chrom,
                                   phase_problem.start,
                                   phase_problem.end + 1, min_mapq)
            if chunks is None:
                batched_ok = False
                break
            for raw, rec_off, rec_size in chunks:
                if not _global_batch_chunk(
                        raw, rec_off, rec_size, phase_problem,
                        variant_calls, hom_calls, reference_genome,
                        config, wfa_pack, local_pack, chrom_seq, ladder,
                        read_groups, joint_stats):
                    batched_ok = False
                    break
            if not batched_ok:
                break
        if batched_ok:
            return _finish_groups(read_groups, joint_stats,
                                  min_matched_alleles)
        read_groups = {}
        joint_stats = ReadStats()

    _assign_in_order(
        _block_reads(phase_problem, bam_paths, min_mapq),
        lambda _i, read: global_realignment(
            phase_problem, read, variant_calls, hom_calls, reference_genome,
            config.wfa_prune_distance, config.max_edit_distance,
            wfa_pack=wfa_pack)[:3],
        phase_problem, variant_calls, local_pack, config, read_groups,
        joint_stats)
    return _finish_groups(read_groups, joint_stats, min_matched_alleles)


# ---------------------------------------------------------------------------
# --wfa-engine device

def _aligned_span(read: BamRecord, variant_calls: list[Variant],
                  hom_calls: list[Variant], wfa_pack: WfaBlockPack | None):
    """The read's aligned subsequence and where its mapping lies: (read_align,
    min_position, max_position, first_overlap, last_overlap,
    first_hom_overlap, last_hom_overlap), or None when it overlaps no het
    (ref: read_parsing.rs:652-690)."""
    (r2q, base, min_position, max_position, first_overlap, last_overlap,
     num_overlaps, first_hom_overlap, last_hom_overlap) = _read_overlaps(
        read, variant_calls, hom_calls, wfa_pack)
    if num_overlaps == 0:
        return None

    read_sequence = read.query_sequence()
    read_start = int(r2q[min_position - base])
    read_end = int(r2q[max_position - base])
    return (read_sequence[read_start:read_end + 1], min_position,
            max_position, first_overlap, last_overlap, first_hom_overlap,
            last_hom_overlap)


def read_window(phase_problem: PhaseBlock, read: BamRecord,
                variant_calls: list[Variant], hom_calls: list[Variant],
                reference_genome: ReferenceGenome, max_edit_distance: int,
                wfa_pack: WfaBlockPack | None = None):
    """The read's aligned subsequence and the window graph over the het and
    hom variants its mapping overlaps: (read_align, graph, node_to_alleles,
    first het overlap), or None when it overlaps no het
    (ref: read_parsing.rs:652-720)."""
    span = _aligned_span(read, variant_calls, hom_calls, wfa_pack)
    if span is None:
        return None
    (read_align, min_position, max_position, first_overlap, last_overlap,
     first_hom_overlap, last_hom_overlap) = span
    chrom_seq = reference_genome.get_full_chromosome(phase_problem.chrom)
    wfa_graph, node_to_alleles = WFAGraph.from_reference_variants_with_hom(
        chrom_seq,
        variant_calls[first_overlap:last_overlap],
        hom_calls[first_hom_overlap:last_hom_overlap],
        min_position, max_position + 1,
        max_edit_distance)
    return read_align, wfa_graph, node_to_alleles, first_overlap


def _device_assign(window, aligned, variant_calls: list[Variant],
                   wfa_prune_distance: int, global_max_edit_distance: int
                   ) -> tuple[np.ndarray, np.ndarray, ReadStats, int]:
    """Allele assignment of one read from its window and its band-ladder
    result (None: uncertified, the host aligner decides). Raises
    WFAGraphError on max-ED."""
    stats = ReadStats()
    if window is None:
        stats.skipped_reads = 1
        return (np.zeros(0, np.uint8), np.zeros(0, np.uint8), stats, USIZE_MAX)
    read_align, wfa_graph, node_to_alleles, first_overlap = window
    if aligned is not None:
        dev_score, traversed = aligned
        if dev_score > global_max_edit_distance:
            raise WFAGraphError(global_max_edit_distance)
        wfa_result = WFAResult(dev_score, traversed)
    else:
        wfa_result = wfa_graph.edit_distance_with_pruning(
            read_align, wfa_prune_distance)  # raises on max-ED
    alleles = np.full(len(variant_calls), NOV, dtype=np.uint8)
    _mark_traversed(alleles, wfa_result, node_to_alleles, first_overlap)
    quals = _global_quals(alleles, variant_calls, stats)
    return alleles, quals, stats, wfa_result.score


class _PackedWindows:
    """A block's read windows for the ladder. Pass 1 gives each read's
    window [ref_start[k], ref_end[k]) and aligned bases
    read_blob[read_off[k]:read_off[k + 1]]; `batch`, which the ladder calls
    inside its span, packs them (`wfa_device.PairBatch.from_windows`: the
    native window packer, and `read_window` for the windows it refuses);
    `assign` gives a read's alleles from the packer's triples where the
    ladder certified it, and from its Python window (`window`, built on
    demand) elsewhere."""

    def __init__(self, wfa_pack: WfaBlockPack | None, chrom_seq: bytes,
                 ref_start, ref_end, read_blob, read_off, python_window):
        self.wfa_pack = wfa_pack
        self.chrom_seq = chrom_seq
        self.ref_start = np.asarray(ref_start, np.int64)
        self.ref_end = np.asarray(ref_end, np.int64)
        self.read_blob = np.asarray(read_blob, np.uint8)
        self.read_off = np.asarray(read_off, np.int64)
        self._python_window = python_window     # pair index → read_window
        self._windows: dict[int, tuple] = {}
        self.native = None
        self.triples = None

    def window(self, k: int):
        """Pair k's Python window (`read_window`)."""
        if k not in self._windows:
            self._windows[k] = self._python_window(k)
        return self._windows[k]

    def batch(self):
        """Every window packed, one graph a pair, in their order: a
        `wfa_device.PairBatch` (`align_pairs_device`'s ``make_batch``)."""
        from hiphase_tpu_torch.align.wfa_device import PairBatch

        batch, self.native, self.triples = PairBatch.from_windows(
            self.wfa_pack, self.chrom_seq, self.ref_start, self.ref_end,
            self.read_blob, self.read_off, lambda k: self.window(k)[1])
        return batch

    def assign(self, k: int, aligned, variant_calls: list[Variant],
               wfa_prune_distance: int, global_max_edit_distance: int
               ) -> tuple[np.ndarray, np.ndarray, ReadStats]:
        """`_device_assign` of pair k, from the packer's triples when the
        ladder certified it. Raises WFAGraphError on max-ED."""
        if aligned is None or not self.native[k]:
            return _device_assign(self.window(k), aligned, variant_calls,
                                  wfa_prune_distance,
                                  global_max_edit_distance)[:3]
        dev_score, traversed = aligned
        if dev_score > global_max_edit_distance:
            raise WFAGraphError(global_max_edit_distance)
        tri_off, node, var, val = self.triples
        lo, hi = int(tri_off[k]), int(tri_off[k + 1])
        hit = np.isin(node[lo:hi], np.asarray(traversed, np.int32))
        var, val = var[lo:hi][hit], val[lo:hi][hit]
        seen = np.zeros((2, len(variant_calls)), bool)
        seen[val, var] = True
        # a variant reached with both alleles is Ambiguous
        alleles = np.where(seen[0] & seen[1], AMB,
                           np.where(seen[0], 0, np.where(seen[1], 1, NOV))
                           ).astype(np.uint8)
        stats = ReadStats()
        quals = _global_quals(alleles, variant_calls, stats)
        return alleles, quals, stats


def _native_pass1(phase_problem: PhaseBlock, bam_paths: list[str],
                  min_mapq: int, wfa_pack: WfaBlockPack):
    """Pass 1 in C++ (`io.native.wfa_windows`), one call over the raw
    records of the block's BAMs (`BamReader.fetch_raw`): the reads, as
    `_block_reads` gives them, and (has_window [reads], then for the reads
    with a window: ref_start, ref_end, read_blob, read_off). None where a
    BAM cannot be fetched raw (CRAM, no index, no host library), the
    port's library is not bound, or the call refuses a record."""
    from hiphase_tpu_torch.io import native

    if not native.port_available():
        return None
    chunks = []
    for bam_path in bam_paths:
        got = cached_alignment(bam_path).fetch_raw(
            phase_problem.chrom, phase_problem.start, phase_problem.end + 1,
            min_mapq)
        if got is None:
            return None
        chunks += got
    out = native.wfa_windows(chunks, wfa_pack.het_pos)
    if out is None:
        return None
    has_window, ref_start, ref_end, read_blob, read_off = out
    reads = [BamRecord.parse(buf[o:o + n].tobytes())
             for buf, rec_off, rec_size in chunks
             for o, n in zip(rec_off.tolist(), rec_size.tolist())]
    # a read without a window has no bases: the pairs' offsets are those
    # of the reads with one, then the end
    pairs = np.flatnonzero(has_window)
    return reads, (has_window, ref_start[pairs], ref_end[pairs], read_blob,
                   np.append(read_off[pairs], read_off[-1]))


def _python_pass1(phase_problem: PhaseBlock, bam_paths: list[str],
                  min_mapq: int, variant_calls: list[Variant],
                  hom_calls: list[Variant], wfa_pack: WfaBlockPack | None):
    """Pass 1 in Python, read by read (`_block_reads`, `_aligned_span`):
    what `_native_pass1` returns."""
    reads = list(_block_reads(phase_problem, bam_paths, min_mapq))
    spans = [_aligned_span(read, variant_calls, hom_calls, wfa_pack)
             for read in reads]
    has_window = np.array([a is not None for a in spans], bool)
    return reads, (has_window,
                   *_window_arrays([a for a in spans if a is not None]))


def _window_arrays(spans: list[tuple]):
    """`_aligned_span`'s tuples as the arrays `_PackedWindows` takes:
    ref_start, ref_end, read_blob, read_off."""
    # a window is [min_position, max_position + 1)
    return ([a[1] for a in spans], [a[2] + 1 for a in spans],
            np.frombuffer(b"".join(a[0] for a in spans), np.uint8),
            np.cumsum([0] + [len(a[0]) for a in spans]))


def _load_full_read_segments_device(phase_problem, bam_paths, variant_calls,
                                    hom_calls, reference_genome,
                                    min_matched_alleles, min_mapq, config,
                                    device, counters, spans):
    """``--wfa-engine device``: pass 1 finds every read's window
    (`_native_pass1`, else `_python_pass1`) and aligns all windows of the
    block in one batched band ladder; pass 2 walks the reads in BAM order
    exactly as the per-read path does. Spans: pass 1's windows
    ``prepare.windows`` (the fetch, the overlap search and the read's
    aligned bases; the records' parse on the native path), the ladder
    ``wfa.ladder`` (the windows' graphs and its waits), pass 2
    ``prepare.assign``."""
    from hiphase_tpu_torch.align.wfa_device import align_pairs_device
    from hiphase_tpu_torch.io import native as native_mod
    from hiphase_tpu_torch.phasing.variant_pack import build_variant_pack

    # pass 1: windows of every read, then one ladder over all of them
    with spans.span("prepare.windows"):
        local_pack = build_variant_pack(variant_calls)
        wfa_pack = WfaBlockPack(variant_calls, hom_calls) \
            if native_mod.port_available() or native_mod.available() \
            else None
        found = _native_pass1(phase_problem, bam_paths, min_mapq, wfa_pack) \
            if wfa_pack is not None else None
        if counters is not None:
            counters.add_pass1(found is not None)
        if found is None:
            found = _python_pass1(phase_problem, bam_paths, min_mapq,
                                  variant_calls, hom_calls, wfa_pack)
        reads, (has_window, *windows) = found
    with_window = np.flatnonzero(has_window).tolist()
    pair_of = {i: k for k, i in enumerate(with_window)}
    aligned = [None] * len(reads)
    if with_window:
        packed = _PackedWindows(
            wfa_pack,
            reference_genome.get_full_chromosome(phase_problem.chrom),
            *windows,
            lambda k: read_window(phase_problem, reads[with_window[k]],
                                  variant_calls, hom_calls, reference_genome,
                                  config.max_edit_distance, wfa_pack))
        got = align_pairs_device(packed.batch, device, counters=counters,
                                 spans=spans)
        for i, r in zip(with_window, got):
            aligned[i] = r

    def assign_global(i, _read):
        if not has_window[i]:
            return _device_assign(None, None, variant_calls,
                                  config.wfa_prune_distance,
                                  config.max_edit_distance)[:3]
        return packed.assign(pair_of[i], aligned[i], variant_calls,
                             config.wfa_prune_distance,
                             config.max_edit_distance)

    # pass 2: the failure ladder in encounter order
    with spans.span("prepare.assign"):
        read_groups: dict[str, list[ReadSegment]] = {}
        joint_stats = ReadStats()
        _assign_in_order(reads, assign_global, phase_problem, variant_calls,
                         local_pack, config, read_groups, joint_stats)
        return _finish_groups(read_groups, joint_stats,
                              min_matched_alleles)
