"""Read→allele conversion (ref: src/read_parsing.rs).

Local realignment mode: per variant, excise the read subsequence between the
nearest aligned anchors around the (reference-context-extended) allele window
and match it exactly, then by edit distance. Qualities are per-type baselines
scaled by the harmonic mean of base qualities (capped at 40).

Global realignment (graph-WFA) lives in `hiphase_tpu.align.wfa_graph` and is
wired through ``load_full_read_segments`` with the deterministic
failure-ratio fallback ladder.
"""

from __future__ import annotations

import logging

import numpy as np

from reference.core.read_segments import ReadSegment, collapse_read_segments
from reference.core.variants import AlleleType, Variant, VariantType
from reference.io.bam import BamRecord, cached_alignment
from reference.phasing.block_gen import PhaseBlock, filter_out_alignment_record
from reference.writers.phase_stats import ReadStats

logger = logging.getLogger(__name__)

# Baseline quality values (ref: read_parsing.rs:18-22). Global realignment
# assigns exactly 2× these; local scales by harmonic-mean base quality.
SNV_QUAL = 80
TR_QUAL = 40
SV_INDEL_QUAL = 20
INDEL_QUAL = 10
MISSING_QUAL = 0

_BASELINE = {
    VariantType.SNV: SNV_QUAL,
    VariantType.DELETION: INDEL_QUAL,
    VariantType.INSERTION: INDEL_QUAL,
    VariantType.INDEL: INDEL_QUAL,
    VariantType.SV_DELETION: SV_INDEL_QUAL,
    VariantType.SV_INSERTION: SV_INDEL_QUAL,
    VariantType.TANDEM_REPEAT: TR_QUAL,
}

REF = int(AlleleType.REFERENCE)
ALT = int(AlleleType.ALTERNATE)
AMB = int(AlleleType.AMBIGUOUS)
NOV = int(AlleleType.NO_OVERLAP)


class GlobalRealignmentConfig:
    """(ref: read_parsing.rs:25-34)"""

    def __init__(self, max_edit_distance: int = 500,
                 wfa_prune_distance: int = 500,
                 global_failure_ratio: float = 0.5,
                 global_failure_minimum: int = 50,
                 wfa_engine: str = "host"):
        self.max_edit_distance = max_edit_distance
        self.wfa_prune_distance = wfa_prune_distance
        self.global_failure_ratio = global_failure_ratio
        self.global_failure_minimum = global_failure_minimum
        # 'host' = C++/Python wavefront aligner; 'device' = banded-DP
        # accelerator kernel (align/wfa_device.py) with per-read host
        # fallback for reads its band ladder cannot certify
        self.wfa_engine = wfa_engine


def build_r2q(read: BamRecord) -> tuple[np.ndarray, int]:
    """Vectorized CIGAR walk: r2q[rc - read.pos] = read position of aligned
    reference coordinate rc, or -1 (the array form of the reference's
    coordinate_lookup hashmap, ref: read_parsing.rs:136-148)."""
    base = read.pos
    span = max(read.reference_end() - base, 1)
    r2q = np.full(span, -1, dtype=np.int64)
    qpos = 0
    rpos = 0
    for op, length in read.cigar():
        if op in "M=X":
            r2q[rpos:rpos + length] = np.arange(qpos, qpos + length)
            qpos += length
            rpos += length
        elif op in "IS":
            qpos += length
        elif op in "DN":
            rpos += length
    return r2q, base


def local_realignment(read: BamRecord, variant_calls: list[Variant],
                      pack=None) -> tuple[np.ndarray, np.ndarray, ReadStats]:
    """Assign an allele + qual per variant for one read
    (ref: read_parsing.rs:121-503). ``pack`` is the per-block VariantPack
    (built once per block for the native window matcher)."""
    from reference.io import native as native_mod
    from reference.phasing.variant_pack import build_variant_pack

    num_variants = len(variant_calls)
    stats = ReadStats()

    r2q, base = build_r2q(read)
    mapped = np.flatnonzero(r2q >= 0)
    min_position = read.pos
    max_position = base + int(mapped[-1]) if mapped.size else read.pos
    aligned_end = max_position + 1  # aligned range is [min_position, aligned_end)

    read_sequence = read.query_sequence()
    read_qualities = read.query_qualities()

    alleles = np.full(num_variants, NOV, dtype=np.uint8)
    quals = np.zeros(num_variants, dtype=np.uint8)
    exact_flags = np.zeros(num_variants, dtype=bool)
    overlap_flags = np.zeros(num_variants, dtype=bool)
    pendings: list[tuple[int, bytes, int, int]] = []  # (vi, obs, hc, tc)
    num_overlaps = 0

    if pack is None:
        pack = build_variant_pack(variant_calls)

    # sequential host pass: ignored variants, SV deletions (they set the
    # suppression window) and variants inside a detected deletion
    # (ref: read_parsing.rs:180-194, :354-451)
    skip_flags = pack.python_only.copy()
    last_deletion_end = 0
    # only variants positioned inside the read's aligned span can be
    # suppressed or produce an SV-deletion call; everything outside resolves
    # to NoOverlap (window anchors can't exist past the alignment)
    lo = int(np.searchsorted(pack.pos, min_position, "left"))
    hi = int(np.searchsorted(pack.pos, aligned_end, "left"))
    for vi in range(lo, hi):
        variant = variant_calls[vi]
        if variant.is_ignored:
            skip_flags[vi] = True
            continue
        if variant.position < last_deletion_end:
            alleles[vi] = AMB
            overlap_flags[vi] = True
            skip_flags[vi] = True
            continue
        if variant.variant_type == VariantType.SV_DELETION:
            (alleles[vi], quals[vi], exact_flags[vi], overlap_flags[vi],
             last_deletion_end) = _sv_deletion_allele(
                variant, r2q, base, min_position, aligned_end,
                last_deletion_end)
            skip_flags[vi] = True

    native_out = native_mod.window_alleles(
        r2q, base, read_sequence, read_qualities, min_position, aligned_end,
        pack, skip_flags)
    if native_out is not None:
        na, nq, nx, no = native_out
        todo = ~skip_flags
        alleles[todo] = na[todo]
        quals[todo] = nq[todo]
        exact_flags[todo] = nx[todo].astype(bool)
        overlap_flags[todo] = no[todo].astype(bool)
    else:
        coordinate_lookup = {base + int(rc): int(r2q[rc]) for rc in mapped}
        for vi in np.flatnonzero(~skip_flags):
            variant = variant_calls[vi]
            allele, qual, exact_allele, overlaps_allele, pending = \
                _window_allele(variant, coordinate_lookup, min_position,
                               aligned_end, read_sequence, read_qualities)
            if pending is not None:
                obs, hc, tc = pending
                pendings.append((vi, obs, hc, tc))
            alleles[vi] = allele
            quals[vi] = qual
            exact_flags[vi] = exact_allele
            overlap_flags[vi] = overlaps_allele

    # one batched edit-distance resolution for all inexact matches of this
    # read (ref per-variant path: variants.rs:624-641; native kernel when
    # available)
    if pendings:
        from reference.align.edit_distance import edit_distance_batch
        a0s = [variant_calls[vi].allele0[hc:len(variant_calls[vi].allele0) - tc]
               for vi, _obs, hc, tc in pendings]
        a1s = [variant_calls[vi].allele1[hc:len(variant_calls[vi].allele1) - tc]
               for vi, _obs, hc, tc in pendings]
        obs_list = [obs for _vi, obs, _hc, _tc in pendings]
        n = len(pendings)
        lq = max(max(len(o) for o in obs_list), 1)
        lt = max(max(len(a) for a in a0s + a1s), 1)
        Q = np.zeros((2 * n, lq), dtype=np.uint8)
        T = np.zeros((2 * n, lt), dtype=np.uint8)
        qlens = np.zeros(2 * n, dtype=np.int32)
        tlens = np.zeros(2 * n, dtype=np.int32)
        for i, obs in enumerate(obs_list):
            arr = np.frombuffer(obs, dtype=np.uint8)
            Q[2 * i, :len(obs)] = arr
            Q[2 * i + 1, :len(obs)] = arr
            qlens[2 * i] = qlens[2 * i + 1] = len(obs)
            T[2 * i, :len(a0s[i])] = np.frombuffer(a0s[i], dtype=np.uint8)
            tlens[2 * i] = len(a0s[i])
            T[2 * i + 1, :len(a1s[i])] = np.frombuffer(a1s[i], dtype=np.uint8)
            tlens[2 * i + 1] = len(a1s[i])
        dists = edit_distance_batch(Q, qlens, T, tlens)
        for i, (vi, _obs, _hc, _tc) in enumerate(pendings):
            d0, d1 = int(dists[2 * i]), int(dists[2 * i + 1])
            # ties → Ambiguous; qual keeps the harmonic-scaled value either
            # way, matching the reference's inexact path (read_parsing.rs:283)
            alleles[vi] = REF if d0 < d1 else (ALT if d1 < d0 else AMB)

    # stats pass, vectorized (counts identical to the reference's inline
    # accumulation)
    vt = pack.vt_index
    amb_mask = overlap_flags & (alleles == AMB)
    set_mask = overlap_flags & (alleles < AMB)
    np.add.at(stats.failed_matches, vt[amb_mask], 1)
    np.add.at(stats.exact_matches, vt[set_mask & exact_flags], 1)
    np.add.at(stats.inexact_matches, vt[set_mask & ~exact_flags], 1)
    np.add.at(stats.allele0_matches, vt[set_mask & (alleles == REF)], 1)
    np.add.at(stats.allele1_matches, vt[set_mask & (alleles == ALT)], 1)
    num_overlaps = int(set_mask.sum())
    stats.num_alleles = num_overlaps

    stats.skipped_reads = 1 if num_overlaps == 0 else 0
    stats.local_aligned = 1 - stats.skipped_reads
    return alleles, quals, stats


def _window_allele(variant: Variant, coordinate_lookup: dict[int, int],
                   aligned_start: int, aligned_end: int,
                   read_sequence: bytes, read_qualities: bytes):
    """Anchor-window excision + exact/inexact matching for non-SV-DEL types
    (ref: read_parsing.rs:196-353)."""
    variant_pos = variant.position
    ref_allele_len = variant.ref_len
    prefix_len = variant.prefix_len
    postfix_len = variant.postfix_len

    first_start = variant_pos - prefix_len
    last_start = variant_pos + 1       # exclusive bound includes variant_pos
    first_end = variant_pos + ref_allele_len
    last_end = first_end + postfix_len + 1

    closest_start = None
    for sc in range(last_start - 1, first_start - 1, -1):
        si = coordinate_lookup.get(sc)
        if si is not None:
            closest_start = si
            break
    closest_end = None
    for ec in range(first_end, last_end):
        ei = coordinate_lookup.get(ec)
        if ei is not None:
            closest_end = ei
            break

    start_coordinate = None
    start_clip = 0
    end_coordinate = None
    end_clip = 0
    if closest_start is not None and closest_end is not None:
        for sc in range(first_start, last_start):
            start_clip += 1
            si = coordinate_lookup.get(sc)
            if si is None:
                continue
            # outlier guard: displaced anchors (ref: :245-247)
            if closest_start - si > 2 * prefix_len:
                continue
            start_coordinate = si
            for ec in range(last_end - 1, first_end - 1, -1):
                end_clip += 1
                ei = coordinate_lookup.get(ec)
                if ei is None:
                    continue
                if ei - closest_end > 2 * postfix_len:
                    continue
                end_coordinate = ei
                break
            break

    if start_coordinate is not None and end_coordinate is not None:
        ss, se = start_coordinate, end_coordinate
        obs = read_sequence[ss:se]
        allele = variant.match_allele(obs)
        pending = None
        if allele == AMB:
            # defer the two edit distances to one batched call per read
            # (hot loop #3; native kernel when built)
            pending = (obs, start_clip - 1, end_clip - 1)
            exact_allele = False
        else:
            exact_allele = True
        # harmonic-mean base-quality scaling capped at 40 (ref: :290-327)
        qs = read_qualities[ss:se]
        if len(qs) == 0:
            qual_factor = 1.0  # matches Rust NaN.min(1.0) == 1.0
        else:
            denom = sum(1.0 / q if q > 0 else float("inf") for q in qs)
            harmonic = len(qs) / denom if denom > 0 else 0.0
            qual_factor = min(harmonic / 40.0, 1.0)
        baseline = _BASELINE[variant.variant_type]
        qual = int(max(baseline * qual_factor, 1.0))
        return allele, qual, exact_allele, True, pending

    if aligned_start <= variant_pos < aligned_end:
        return AMB, MISSING_QUAL, False, True, None
    return NOV, MISSING_QUAL, False, False, None


def _sv_deletion_allele(variant: Variant, r2q: np.ndarray, base: int,
                        aligned_start: int, aligned_end: int,
                        last_deletion_end: int):
    """Whole-variant deleted-base counting for SV deletions
    (ref: read_parsing.rs:354-451)."""

    def contains(rc: int) -> bool:
        return 0 <= rc - base < len(r2q) and r2q[rc - base] >= 0

    variant_pos = variant.position
    ref_allele_len = variant.ref_len
    if not (aligned_start <= variant_pos < aligned_end):
        return NOV, MISSING_QUAL, False, False, last_deletion_end

    last_start = variant_pos + 1
    first_end = variant_pos + ref_allele_len
    if not (aligned_start <= first_end < aligned_end):
        # partial overlap without reaching the far end
        return AMB, MISSING_QUAL, False, True, last_deletion_end

    expected_deleted = first_end - last_start
    start_anchor = last_start
    while not contains(start_anchor):
        if start_anchor <= aligned_start:
            logger.warning("Reached start of read without finding start_anchor"
                           ", using POS (%d) instead.", start_anchor)
            break
        start_anchor -= 1
    end_anchor = first_end
    while not contains(end_anchor):
        end_anchor += 1
        if end_anchor >= aligned_end:
            logger.warning("Reached end of read without finding end_anchor, "
                           "using max (%d) found instead.", end_anchor)
            break

    lo = max(start_anchor - base, 0)
    hi = max(end_anchor - base, lo)
    deleted_count = int(np.count_nonzero(r2q[lo:hi] < 0))
    match_window = 0.33
    deleted_ratio = deleted_count / expected_deleted if expected_deleted else 0.0
    if deleted_ratio < match_window:
        qual = int(max(SV_INDEL_QUAL * (1.0 - deleted_ratio), 1.0))
        return REF, qual, deleted_ratio == 0.0, True, last_deletion_end
    if abs(1.0 - deleted_ratio) < match_window:
        qual_frac = 1.0 - abs(1.0 - deleted_ratio)
        qual = int(max(SV_INDEL_QUAL * qual_frac, 1.0))
        # anything inside a detected deletion is suppressed downstream
        return ALT, qual, deleted_ratio == 1.0, True, first_end
    return AMB, MISSING_QUAL, False, True, last_deletion_end


def _realign_block_native(bam, phase_problem, pack, joint_stats,
                          read_groups, min_mapq) -> bool:
    """Whole-block native path: bulk region inflate + one C realignment call
    per chunk (parse, CIGAR walk, SV-deletion windows, anchor matching,
    stats). Returns False to use the per-read Python path."""
    from reference.io import native as native_mod

    chunks = bam.fetch_raw(phase_problem.chrom, phase_problem.start,
                           phase_problem.end + 1, min_mapq)
    if chunks is None:
        return False
    for raw, rec_off, rec_size in chunks:
        out = native_mod.realign_block(raw, rec_off, rec_size, pack,
                                       SV_INDEL_QUAL)
        if out is None:
            return False
        alleles2d, quals2d, noverlap, stats = out
        rows = np.flatnonzero(noverlap > 0)
        names = []
        for i in rows:
            off = int(rec_off[i])
            l_name = int(raw[off + 8])
            names.append(raw[off + 32:off + 32 + l_name - 1].tobytes()
                         .decode())
        from reference.core.read_segments import read_segments_from_rows
        for name, seg in zip(names, read_segments_from_rows(
                names, alleles2d, quals2d, rows)):
            read_groups.setdefault(name, []).append(seg)
        nt = stats[:55].reshape(5, 11)
        joint_stats.failed_matches += nt[0].astype(np.uint64)
        joint_stats.exact_matches += nt[1].astype(np.uint64)
        joint_stats.inexact_matches += nt[2].astype(np.uint64)
        joint_stats.allele0_matches += nt[3].astype(np.uint64)
        joint_stats.allele1_matches += nt[4].astype(np.uint64)
        joint_stats.num_alleles += int(stats[55])
        joint_stats.skipped_reads += int(stats[56])
        joint_stats.local_aligned += int(stats[57])
    return True


def load_read_segments(phase_problem: PhaseBlock, bam_paths: list[str],
                       variant_calls: list[Variant],
                       min_matched_alleles: int, min_mapq: int
                       ) -> tuple[list[ReadSegment], list[ReadSegment], ReadStats]:
    """Local-only loading path (ref: read_parsing.rs:48-114). Returns
    (read_segments for phasing, phasable-but-thin segments, stats)."""
    from reference.phasing.variant_pack import build_variant_pack

    read_groups: dict[str, list[ReadSegment]] = {}
    joint_stats = ReadStats()
    pack = build_variant_pack(variant_calls)

    for bam_path in bam_paths:
        bam = cached_alignment(bam_path)
        if _realign_block_native(bam, phase_problem, pack, joint_stats,
                                 read_groups, min_mapq):
            continue
        for read in bam.fetch(phase_problem.chrom, phase_problem.start,
                              phase_problem.end + 1):
            if filter_out_alignment_record(read, min_mapq):
                continue
            alleles, quals, read_stats = local_realignment(
                read, variant_calls, pack)
            if read_stats.skipped_reads == 0:
                read_groups.setdefault(read.read_name, []).append(
                    ReadSegment.new(read.read_name, alleles, quals))
            joint_stats += read_stats

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
