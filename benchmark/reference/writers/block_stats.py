"""Block statistics: --blocks-file and --summary-file outputs
(ref: src/writers/block_stats.rs)."""

from __future__ import annotations

from reference.core.reference_genome import ReferenceGenome
from reference.core.variants import VariantType, Zygosity
from reference.phasing.block_gen import PhaseBlock

BLOCK_COLUMNS = ["source_block_index", "sample_name", "phase_block_id",
                 "chrom", "start", "end", "num_variants"]

SUMMARY_COLUMNS = [
    "sample_name", "chromosome", "num_variants", "num_heterozygous",
    "num_phased", "num_unphased", "num_het_snv", "num_phased_snv",
    "num_blocks", "num_singletons",
    "variants_per_block_median", "variants_per_block_mean",
    "variants_per_block_min", "variants_per_block_max",
    "variants_per_block_sum",
    "basepairs_per_block_median", "basepairs_per_block_mean",
    "basepairs_per_block_min", "basepairs_per_block_max",
    "basepairs_per_block_sum", "block_ng50",
]


def _delim(filename: str) -> str:
    return "," if filename.endswith(".csv") else "\t"


def calculate_block_ng50(sorted_blocks: list[int], contig_length: int) -> int:
    """NG50 of block lengths against contig length
    (ref: block_stats.rs:324-346)."""
    target_length = (contig_length + 1) // 2
    length_sum = 0
    for block_size in reversed(sorted_blocks):
        length_sum += block_size
        if length_sum >= target_length:
            return block_size
    return 0


class BlockStatsCollector:
    """Accumulates final sub-blocks and phased-SNV counts
    (ref: block_stats.rs:14-106)."""

    def __init__(self):
        self.blocks: list[PhaseBlock] = []
        self.phased_snvs: dict[tuple[str, str], int] = {}

    def add_block(self, block: PhaseBlock) -> None:
        self.blocks.append(block)

    def add_result(self, result) -> None:
        stats = result.statistics
        if stats is not None and stats.phased_snvs is not None:
            key = (result.phase_block.sample_name, result.phase_block.chrom)
            self.phased_snvs[key] = self.phased_snvs.get(key, 0) + stats.phased_snvs

    def write_blocks(self, filename: str) -> None:
        """--blocks-file: one row per final phase block, 1-based coords
        (ref: block_stats.rs:111-135)."""
        d = _delim(filename)
        self.blocks.sort(key=lambda b: (
            b.block_index, b.chrom, b.chrom_index, b.start, b.end))
        with open(filename, "w") as fh:
            fh.write(d.join(BLOCK_COLUMNS) + "\n")
            for b in self.blocks:
                fh.write(d.join(str(x) for x in [
                    b.block_index, b.sample_name, b.start + 1, b.chrom,
                    b.start + 1, b.end + 1, b.num_variants]) + "\n")

    def write_block_stats(self, sample_order: list[str], filename: str,
                          reference_genome: ReferenceGenome,
                          variant_counts: dict) -> None:
        """--summary-file: per-chromosome + 'all' rollups per sample
        (ref: block_stats.rs:142-231)."""
        d = _delim(filename)
        total_contig_length = sum(
            reference_genome.contig_length(c)
            for c in reference_genome.contig_keys())
        with open(filename, "w") as fh:
            fh.write(d.join(SUMMARY_COLUMNS) + "\n")
            for sample_name in sample_order:
                blocks_by_chrom: dict[str, list[PhaseBlock]] = {}
                all_sample_blocks: list[PhaseBlock] = []
                for b in self.blocks:
                    if b.sample_name == sample_name:
                        blocks_by_chrom.setdefault(b.chrom, []).append(b)
                        all_sample_blocks.append(b)

                num_variants: dict[str, int] = {}
                num_heterozygous: dict[str, int] = {}
                num_het_snv: dict[str, int] = {}
                for (sample, chrom, vt, zyg), count in sorted(
                        variant_counts.items(),
                        key=lambda kv: (kv[0][0], kv[0][1], int(kv[0][2]),
                                        int(kv[0][3]))):
                    if (sample == sample_name and vt != VariantType.UNKNOWN
                            and zyg not in (Zygosity.HOMOZYGOUS_REFERENCE,
                                            Zygosity.UNKNOWN)):
                        num_variants[chrom] = num_variants.get(chrom, 0) + count
                        if zyg == Zygosity.HETEROZYGOUS:
                            num_heterozygous[chrom] = num_heterozygous.get(chrom, 0) + count
                            if vt == VariantType.SNV:
                                num_het_snv[chrom] = num_het_snv.get(chrom, 0) + count

                for contig in reference_genome.contig_keys():
                    contig_length = reference_genome.contig_length(contig)
                    row = self._summary_row(
                        sample_name, contig,
                        blocks_by_chrom.get(contig, []),
                        num_variants.get(contig, 0),
                        num_heterozygous.get(contig, 0),
                        num_het_snv.get(contig, 0),
                        self.phased_snvs.get((sample_name, contig), 0),
                        contig_length)
                    fh.write(d.join(str(x) for x in row) + "\n")

                row = self._summary_row(
                    sample_name, "all", all_sample_blocks,
                    sum(num_variants.values()), sum(num_heterozygous.values()),
                    sum(num_het_snv.values()),
                    sum(c for (s, _), c in self.phased_snvs.items()
                        if s == sample_name),
                    total_contig_length)
                fh.write(d.join(str(x) for x in row) + "\n")

    @staticmethod
    def _summary_row(sample_name, chrom, blocks, num_variants,
                     num_heterozygous, num_het_snv, num_phased_snv,
                     contig_length):
        """(ref: block_stats.rs:244-315)"""
        assert all(b.sample_name == sample_name for b in blocks)
        num_blocks = len(blocks)
        num_singletons = sum(1 for b in blocks if b.num_variants == 1)
        block_variants = sorted(b.num_variants for b in blocks)
        block_lengths = sorted(b.bp_len() for b in blocks)
        num_phased = sum(block_variants)
        num_unphased = num_heterozygous - num_phased

        def _median(v):
            return v[len(v) // 2] if v else 0

        def _mean(v):
            return sum(v) // len(v) if v else 0

        ng50 = (calculate_block_ng50(block_lengths, contig_length)
                if contig_length != 0 else "")
        return [
            sample_name, chrom, num_variants, num_heterozygous, num_phased,
            num_unphased, num_het_snv, num_phased_snv, num_blocks,
            num_singletons,
            _median(block_variants), _mean(block_variants),
            min(block_variants, default=0), max(block_variants, default=0),
            sum(block_variants),
            _median(block_lengths), _mean(block_lengths),
            min(block_lengths, default=0), max(block_lengths, default=0),
            sum(block_lengths), ng50,
        ]
