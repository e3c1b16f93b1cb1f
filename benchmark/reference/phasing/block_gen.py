"""Phase-block generation: streaming work decomposition (ref: src/block_gen.rs).

Walks each sample's VCF(s) merged by position, connecting consecutive phasable
variants into blocks whenever ≥ ``min_spanning_reads`` alignments span them
(with optional supplemental-alignment joins), and grouping unphasable
stretches into "unphased blocks" so downstream writers can stream them
cheaply. Block boundary semantics are a parity requirement: PS tags derive
from block composition.

In the TPU design this layer is the host-side producer that feeds batches of
independent blocks to the device solver; it never touches the accelerator.
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass, field

from reference.core.variants import VariantType, Zygosity
from reference.io.bam import BamRecord, open_alignment
from reference.io.vcf import VcfReader, VcfRecord

logger = logging.getLogger(__name__)

U64_MAX = 2**63 - 1  # effectively-infinite sentinel position


class BlockGenError(Exception):
    pass


def filter_out_alignment_record(rec: BamRecord, min_mapq: int) -> bool:
    """True if the alignment should be ignored: unmapped/secondary/qcfail/
    duplicate flags or low MAPQ (ref: block_gen.rs:96-101)."""
    return (rec.is_unmapped or rec.is_secondary or rec.is_qcfail
            or rec.is_duplicate or rec.mapq < min_mapq)


def get_variant_type(rec: VcfRecord) -> VariantType:
    """Classify a VCF record (ref: block_gen.rs:222-312): SVTYPE info tag
    → Sv*; symbolic ALT (<DEL> etc.) → Unknown; TRID tag → TandemRepeat;
    else by REF/ALT lengths."""
    svtype = rec.info_get("SVTYPE")
    if svtype is not None:
        alleles = rec.alleles()
        if len(alleles) != 2:
            raise BlockGenError(
                f"SVTYPE record must have exactly one ALT allele: "
                f"{rec.chrom}:{rec.pos0 + 1}")
        alt = alleles[1]
        if alt.startswith(b"<") and alt.endswith(b">"):
            return VariantType.UNKNOWN
        sv_map = {
            b"DEL": VariantType.SV_DELETION,
            b"INS": VariantType.SV_INSERTION,
            b"DUP": VariantType.SV_DUPLICATION,
            b"INV": VariantType.SV_INVERSION,
            b"BND": VariantType.SV_BREAKEND,
        }
        if svtype not in sv_map:
            raise BlockGenError(f"Unhandled SVTYPE tag: {svtype!r}")
        return sv_map[svtype]

    if rec.info_get("TRID") is not None:
        return VariantType.TANDEM_REPEAT

    alleles = rec.alleles()
    if len(alleles) <= 1:
        return VariantType.UNKNOWN
    ref_len = len(alleles[0])
    max_alt_len = max(len(a) for a in alleles[1:])
    if ref_len == 1:
        return VariantType.SNV if max_alt_len == 1 else VariantType.INSERTION
    return VariantType.DELETION if max_alt_len == 1 else VariantType.INDEL


def get_variant_zygosity(rec: VcfRecord, sample_index: int) -> Zygosity:
    """(ref: block_gen.rs:167-217). Missing alleles → Unknown; single-entry
    (haploid) GT is treated as homozygous."""
    alleles, _phased = rec.genotype(sample_index)
    if not alleles:
        raise BlockGenError(
            f"Encountered empty GT field for record: {rec.chrom}:{rec.pos0}")
    gt1 = alleles[0]
    if gt1 is None:
        return Zygosity.UNKNOWN
    gt2 = alleles[1] if len(alleles) > 1 else gt1
    if gt2 is None:
        return Zygosity.UNKNOWN
    if gt1 == gt2:
        return (Zygosity.HOMOZYGOUS_REFERENCE if gt1 == 0
                else Zygosity.HOMOZYGOUS_ALTERNATE)
    return Zygosity.HETEROZYGOUS


_PHASABLE_TYPES = frozenset({
    VariantType.SNV, VariantType.INSERTION, VariantType.DELETION,
    VariantType.INDEL, VariantType.SV_INSERTION, VariantType.SV_DELETION,
    VariantType.TANDEM_REPEAT,
})


def is_phasable_variant(rec: VcfRecord, sample_index: int, min_quality: int,
                        is_hom_allowed: bool) -> bool:
    """(ref: block_gen.rs:115-158). Het required (hom-alt allowed only when
    requested); GQ ≥ min when a GQ value is present; allowed types only."""
    zygosity = get_variant_zygosity(rec, sample_index)
    if zygosity in (Zygosity.UNKNOWN, Zygosity.HOMOZYGOUS_REFERENCE):
        return False
    if zygosity == Zygosity.HOMOZYGOUS_ALTERNATE and not is_hom_allowed:
        return False
    gq = rec.gq(sample_index)
    if gq is not None and gq < min_quality:
        return False
    return get_variant_type(rec) in _PHASABLE_TYPES


def get_sample_bams(bam_paths: list[str], sample_name: str) -> list[str]:
    """Select the BAMs whose read groups belong to ``sample_name``; error on
    BAMs without RG/SM or with multiple samples (ref: block_gen.rs:44-89)."""
    out = []
    for path in bam_paths:
        with open_alignment(path) as bam:
            read_groups = bam.header.read_groups()
            if not read_groups:
                raise BlockGenError(
                    f"BAM file has no read groups (RG) tag: {path}")
            samples = set()
            for rg in read_groups:
                if "SM" not in rg:
                    raise BlockGenError(
                        "BAM file has read group with no sample name (SM) "
                        f"tag: {path}")
                samples.add(rg["SM"])
            if len(samples) > 1:
                raise BlockGenError(
                    "BAM file with multiple sample reads groups detected, "
                    f"this is not supported: {path}")
            if sample_name in samples:
                out.append(path)
    return out


@dataclass(order=True)
class PhaseBlock:
    """One independent phasing problem (ref: block_gen.rs:316-462).
    Field order matters: derived comparisons use it."""

    block_index: int
    chrom: str
    chrom_index: int
    start: int = 0          # first variant position, inclusive (0-based)
    end: int = 0            # last variant position, inclusive
    num_variants: int = 0
    vcf_index_counts: list[int] = field(default_factory=list)
    min_quality: int = 0
    sample_name: str = ""
    unphased_block: bool = False

    @classmethod
    def new(cls, block_index: int, chrom: str, chrom_index: int,
            min_quality: int, sample_name: str, num_vcfs: int) -> "PhaseBlock":
        return cls(block_index, chrom, chrom_index, 0, 0, 0,
                   [0] * num_vcfs, min_quality, sample_name, False)

    def bp_len(self) -> int:
        return self.end - self.start + 1

    def add_locus_variant(self, chrom: str, pos: int, vcf_index: int) -> None:
        assert self.chrom == chrom
        if self.start > pos or self.num_variants == 0:
            self.start = pos
        if self.end < pos:
            self.end = pos
        self.num_variants += 1
        self.vcf_index_counts[vcf_index] += 1

    def is_overlapping(self, other_start: int, other_end: int) -> bool:
        return max(self.start, other_start) < min(self.end + 1, other_end)

    def region_str(self) -> str:
        return f"{self.chrom}:{self.start}-{self.end}"


class _PeekableVcf:
    """Buffered per-VCF record stream for the positional merge."""

    def __init__(self, gen):
        self._gen = gen
        self._head: VcfRecord | None = None
        self._advance()

    def _advance(self):
        self._head = next(self._gen, None)

    def peek(self) -> VcfRecord | None:
        return self._head

    def pop(self) -> VcfRecord:
        rec = self._head
        assert rec is not None
        self._advance()
        return rec


class PhaseBlockIterator:
    """Streaming per-sample block producer (ref: block_gen.rs:465-998)."""

    def __init__(self, vcf_paths: list[str], bam_paths: list[str],
                 sample_name: str, min_quality: int = 0, min_mapq: int = 5,
                 min_spanning_reads: int = 1,
                 allow_supplemental_joins: bool = True):
        assert min_spanning_reads > 0
        self.vcf_paths = list(vcf_paths)
        self.vcf_readers = [VcfReader(p) for p in vcf_paths]
        self.sample_name = sample_name
        self.sample_indices = []
        for p, rd in zip(vcf_paths, self.vcf_readers):
            try:
                self.sample_indices.append(rd.samples.index(sample_name))
            except ValueError:
                raise BlockGenError(
                    f"Sample name {sample_name!r} was not found in VCF: {p}")
        contig_sets = [set(rd.header.contigs()) for rd in self.vcf_readers]
        if any(cs != contig_sets[0] for cs in contig_sets[1:]):
            raise BlockGenError("Contig sets in the VCF files do not match")
        self.contigs = self.vcf_readers[0].header.contigs()
        self.bam_readers = [open_alignment(p) for p in bam_paths]
        # one-pass native span index replaces per-variant BAM fetches; the
        # fetch-based path below remains as the no-native fallback (and the
        # parity oracle, tests/test_span_index.py)
        from reference.io.span_index import BamSpanIndex
        self._span_indexes = [BamSpanIndex(p, min_mapq) for p in bam_paths]
        self.min_quality = min_quality
        self.min_mapq = min_mapq
        self.min_spanning_reads = min_spanning_reads
        self.allow_supplemental_joins = allow_supplemental_joins
        self.next_block_index = 0
        self.chrom_index = 0
        self.chrom_position = 0
        # (chrom, VariantType, Zygosity) -> count, for the summary file
        self.variant_stats: dict[tuple[str, VariantType, Zygosity], int] = {}

    # ---- BAM helpers ----

    def _contig_length(self, chrom: str) -> int:
        for bam in self.bam_readers:
            tid = bam.tid(chrom)
            if tid >= 0:
                return bam.header.ref_lengths[tid]
        return U64_MAX

    def _chrom_spans(self, chrom: str):
        """Per-BAM ChromSpans via the one-pass native index, or None to use
        the per-locus fetch fallback."""
        spans = []
        for idx in self._span_indexes:
            cs = idx.chrom(chrom)
            if cs is None:
                return None
            spans.append(cs)
        return spans

    def get_longest_multispan(self, chrom: str, pos: int) -> int:
        """End of the ``min_spanning_reads``-th farthest filtered read covering
        ``pos``; ``pos`` itself when not enough reads (ref: block_gen.rs:630-669)."""
        import numpy as np
        k = self.min_spanning_reads
        spans = self._chrom_spans(chrom)
        if spans is not None:
            ends = np.concatenate([s.covering_ends(pos) for s in spans])
            if len(ends) < k:
                return pos
            return int(np.partition(ends, len(ends) - k)[len(ends) - k])
        span_list = []
        for bam in self.bam_readers:
            for read in bam.fetch(chrom, pos, pos + 1):
                if filter_out_alignment_record(read, self.min_mapq):
                    continue
                span_list.append(read.reference_end())
        if len(span_list) < k:
            return pos
        span_list.sort()
        return span_list[len(span_list) - k]

    def get_next_mapped(self, chrom: str, pos: int) -> int:
        """Position of the ``min_spanning_reads``-th next filtered read start
        after ``pos`` (ref: block_gen.rs:675-716)."""
        import numpy as np
        k = self.min_spanning_reads
        spans = self._chrom_spans(chrom)
        if spans is not None:
            starts = np.concatenate([s.next_starts(pos, k) for s in spans])
            if len(starts) >= k:
                return int(np.partition(starts, k - 1)[k - 1])
            return U64_MAX
        next_positions = []
        end = self._contig_length(chrom)
        for bam in self.bam_readers:
            counted = 0
            for read in bam.fetch(chrom, pos, end):
                if filter_out_alignment_record(read, self.min_mapq):
                    continue
                next_positions.append(read.pos)
                counted += 1
                if counted >= k:
                    break
        if len(next_positions) >= k:
            next_positions.sort()
            return next_positions[k - 1]
        return U64_MAX

    def is_supplemental_overlap(self, chrom: str, pos: int,
                                phase_block: PhaseBlock) -> bool:
        """≥ min_spanning_reads reads at ``pos`` whose SA (supplementary
        alignment) intervals overlap the block (ref: block_gen.rs:722-799).
        The SA start is used as parsed (1-based in the tag) for parity with
        the reference."""
        import numpy as np
        spans = self._chrom_spans(chrom)
        if spans is not None:
            overlap_count = 0
            for s in spans:
                sa_s, sa_e, sa_q, rows = s.sa_entries(pos)
                if not len(rows):
                    continue
                hit = ((sa_q >= self.min_mapq)
                       & (np.maximum(phase_block.start, sa_s)
                          < np.minimum(phase_block.end + 1, sa_e)))
                overlap_count += len(np.unique(rows[hit]))
            return overlap_count >= self.min_spanning_reads
        overlap_count = 0
        for bam in self.bam_readers:
            for read in bam.fetch(chrom, pos, pos + 1):
                if filter_out_alignment_record(read, self.min_mapq):
                    continue
                sa_tag = read.get_tag("SA")
                if sa_tag is None:
                    continue
                for sa_str in sa_tag.rstrip(";").split(";"):
                    if not sa_str:
                        continue
                    frags = sa_str.split(",")
                    assert len(frags) == 6, f"bad SA entry: {sa_str!r}"
                    sa_chrom, sa_pos, _strand, sa_cigar, sa_mapq, _nm = frags
                    if sa_chrom != chrom or int(sa_mapq) < self.min_mapq:
                        continue
                    sa_start = int(sa_pos)
                    sa_end = sa_start
                    num = 0
                    for ch in sa_cigar:
                        if ch.isdigit():
                            num = num * 10 + int(ch)
                        else:
                            if ch in "MD=X":
                                sa_end += num
                            elif ch not in "SI":
                                raise BlockGenError(
                                    f"Unhandled cigar type in SA: {ch}")
                            num = 0
                    if phase_block.is_overlapping(sa_start, sa_end):
                        overlap_count += 1
                        break
        return overlap_count >= self.min_spanning_reads

    # ---- iteration ----

    def __iter__(self):
        return self

    def _chrom_scans(self, chrom_name: str):
        """Per-VCF native chrom scans + phasability masks for this sample,
        or None to use the streaming-record fallback."""
        cached = getattr(self, "_scan_state", None)
        if cached is not None and cached[0] == chrom_name:
            return cached[1]
        from reference.io.vcf_scan import scan_chrom
        out = []
        for path, rd, sidx in zip(self.vcf_paths, self.vcf_readers,
                                  self.sample_indices):
            scan = scan_chrom(path, chrom_name, len(rd.samples))
            if scan is None:
                out = None
                break
            out.append((scan, scan.phasable_mask(sidx, self.min_quality,
                                                 False)))
        self._scan_state = (chrom_name, out)
        return out

    def __next__(self) -> PhaseBlock:
        if self.chrom_index >= len(self.contigs):
            raise StopIteration
        scans = self._chrom_scans(self.contigs[self.chrom_index])
        if scans is not None:
            return self._next_from_arrays(scans)
        return self._next_from_records()

    def _next_from_arrays(self, scans) -> PhaseBlock:
        """Array-cursor version of the merge loop below — identical block
        boundary decisions, driven by the native chrom scan instead of
        per-record Python parsing (ref: block_gen.rs:823-974)."""
        import numpy as np

        chrom_name = self.contigs[self.chrom_index]
        phase_block = PhaseBlock.new(
            self.next_block_index, chrom_name, self.chrom_index,
            self.min_quality, self.sample_name, len(self.vcf_readers))
        self.next_block_index += 1

        cursors = [int(np.searchsorted(scan.pos, self.chrom_position, "left"))
                   for scan, _m in scans]
        variant_queue: list[tuple[int, int]] = []
        for vcf_index, ((scan, _m), cur) in enumerate(zip(scans, cursors)):
            if cur < len(scan.pos):
                heapq.heappush(variant_queue, (int(scan.pos[cur]), vcf_index))

        if not variant_queue:
            self.chrom_index += 1
            return phase_block

        vt_enum = [VariantType(v) for v in range(int(VariantType.UNKNOWN) + 1)]
        zy_enum = [Zygosity(z) for z in range(int(Zygosity.UNKNOWN) + 1)]
        previous_pos = 0
        max_span = 0
        next_valid_read_pos = 0

        while variant_queue:
            pop_pos, pop_index = heapq.heappop(variant_queue)
            scan, mask = scans[pop_index]
            sample_index = self.sample_indices[pop_index]
            i = cursors[pop_index]
            cursors[pop_index] += 1
            variant_pos = pop_pos

            vt_code = int(scan.vtype[i])
            zy_code = int(scan.zyg[i, sample_index])
            if vt_code == -1 or zy_code == -1:
                # records the native parser could not classify re-parse in
                # Python so errors surface exactly like the record path
                record = scan.record(i)
                phasable = is_phasable_variant(record, sample_index,
                                               self.min_quality, False)
                vt_code = int(get_variant_type(record))
                zy_code = int(get_variant_zygosity(record, sample_index))
            else:
                phasable = bool(mask[i])

            if phasable:
                if phase_block.num_variants == 0:
                    phase_block.add_locus_variant(chrom_name, variant_pos,
                                                  pop_index)
                    max_span = self.get_longest_multispan(chrom_name,
                                                          variant_pos)
                    if max_span == variant_pos:
                        phase_block.unphased_block = True
                        next_valid_read_pos = self.get_next_mapped(
                            chrom_name, variant_pos)
                        max_span += 1
                elif max_span > variant_pos:
                    phase_block.add_locus_variant(chrom_name, variant_pos,
                                                  pop_index)
                elif phase_block.unphased_block:
                    if variant_pos < next_valid_read_pos:
                        phase_block.add_locus_variant(chrom_name, variant_pos,
                                                      pop_index)
                    else:
                        self.chrom_position = variant_pos
                        return phase_block
                else:
                    max_span = self.get_longest_multispan(chrom_name,
                                                          previous_pos)
                    assert max_span != previous_pos
                    if max_span > variant_pos:
                        phase_block.add_locus_variant(chrom_name, variant_pos,
                                                      pop_index)
                    elif not self.allow_supplemental_joins:
                        self.chrom_position = variant_pos
                        return phase_block
                    elif self.is_supplemental_overlap(chrom_name, variant_pos,
                                                      phase_block):
                        phase_block.add_locus_variant(chrom_name, variant_pos,
                                                      pop_index)
                    else:
                        self.chrom_position = variant_pos
                        return phase_block
                previous_pos = variant_pos

            key = (chrom_name, vt_enum[vt_code], zy_enum[zy_code])
            self.variant_stats[key] = self.variant_stats.get(key, 0) + 1

            cur = cursors[pop_index]
            if cur < len(scan.pos):
                heapq.heappush(variant_queue, (int(scan.pos[cur]), pop_index))

        self.chrom_index += 1
        self.chrom_position = 0
        return phase_block

    def _next_from_records(self) -> PhaseBlock:
        chrom_name = self.contigs[self.chrom_index]
        phase_block = PhaseBlock.new(
            self.next_block_index, chrom_name, self.chrom_index,
            self.min_quality, self.sample_name, len(self.vcf_readers))
        self.next_block_index += 1

        streams = [_PeekableVcf(rd.fetch(chrom_name, self.chrom_position, U64_MAX))
                   for rd in self.vcf_readers]
        # (position, vcf_index) min-queue over stream heads
        variant_queue: list[tuple[int, int]] = []
        for vcf_index, st in enumerate(streams):
            head = st.peek()
            if head is not None:
                heapq.heappush(variant_queue, (head.pos0, vcf_index))

        if not variant_queue:
            self.chrom_index += 1
            return phase_block

        previous_pos = 0
        max_span = 0
        next_valid_read_pos = 0

        while variant_queue:
            pop_pos, pop_index = heapq.heappop(variant_queue)
            sample_index = self.sample_indices[pop_index]
            record = streams[pop_index].pop()
            variant_pos = record.pos0
            assert variant_pos == pop_pos

            if variant_pos >= self.chrom_position:
                if is_phasable_variant(record, sample_index,
                                       self.min_quality, False):
                    if phase_block.num_variants == 0:
                        phase_block.add_locus_variant(chrom_name, variant_pos, pop_index)
                        max_span = self.get_longest_multispan(chrom_name, variant_pos)
                        if max_span == variant_pos:
                            # not enough reads here: group the unphasable
                            # stretch (ref: block_gen.rs:903-910)
                            phase_block.unphased_block = True
                            next_valid_read_pos = self.get_next_mapped(chrom_name, variant_pos)
                            max_span += 1
                    elif max_span > variant_pos:
                        phase_block.add_locus_variant(chrom_name, variant_pos, pop_index)
                    elif phase_block.unphased_block:
                        if variant_pos < next_valid_read_pos:
                            phase_block.add_locus_variant(chrom_name, variant_pos, pop_index)
                        else:
                            self.chrom_position = variant_pos
                            return phase_block
                    else:
                        max_span = self.get_longest_multispan(chrom_name, previous_pos)
                        assert max_span != previous_pos
                        if max_span > variant_pos:
                            phase_block.add_locus_variant(chrom_name, variant_pos, pop_index)
                        elif not self.allow_supplemental_joins:
                            self.chrom_position = variant_pos
                            return phase_block
                        elif self.is_supplemental_overlap(chrom_name, variant_pos, phase_block):
                            phase_block.add_locus_variant(chrom_name, variant_pos, pop_index)
                        else:
                            self.chrom_position = variant_pos
                            return phase_block
                    previous_pos = variant_pos

                # stats for every processed (non-skipped) variant
                vt = get_variant_type(record)
                zyg = get_variant_zygosity(record, sample_index)
                key = (chrom_name, vt, zyg)
                self.variant_stats[key] = self.variant_stats.get(key, 0) + 1

            head = streams[pop_index].peek()
            if head is not None:
                heapq.heappush(variant_queue, (head.pos0, pop_index))

        self.chrom_index += 1
        self.chrom_position = 0
        return phase_block


class MultiPhaseBlockIterator:
    """Merges per-sample iterators by (chrom_index, start, end) and renumbers
    block_index to global order (ref: block_gen.rs:1003-1107)."""

    def __init__(self, sub_iterators: list[PhaseBlockIterator]):
        self.sub_iterators = sub_iterators
        self._queue: list[tuple[tuple[int, int, int], int, PhaseBlock]] = []
        self._joint_block_index = 0
        for index, it in enumerate(sub_iterators):
            block = next(it, None)
            if block is None:
                logger.warning("First block in iterator %d was empty.", index)
            else:
                heapq.heappush(self._queue, (self._key(block), index, block))

    @staticmethod
    def _key(block: PhaseBlock) -> tuple[int, int, int]:
        return (block.chrom_index, block.start, block.end)

    def variant_stats(self) -> dict[tuple[str, str, VariantType, Zygosity], int]:
        ret = {}
        for it in self.sub_iterators:
            for (chrom, vt, zyg), count in it.variant_stats.items():
                ret[(it.sample_name, chrom, vt, zyg)] = count
        return ret

    def __iter__(self):
        return self

    def __next__(self) -> PhaseBlock:
        if not self._queue:
            raise StopIteration
        _key, source_index, block = heapq.heappop(self._queue)
        nxt = next(self.sub_iterators[source_index], None)
        if nxt is not None:
            heapq.heappush(self._queue, (self._key(nxt), source_index, nxt))
        block.block_index = self._joint_block_index
        self._joint_block_index += 1
        return block
