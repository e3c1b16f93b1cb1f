"""Block preparation for the port — the twin of
``hiphase_tpu.phasing.phaser.prepare_block`` whose dual-mode branch loads
reads through this package's `load_full_read_segments` (the JAX package's
reaches its JAX aligner through a lazy import). Local mode is the shared
JAX-free module's.
"""

from __future__ import annotations

import torch

from hiphase_tpu.core.reference_genome import ReferenceGenome
from hiphase_tpu.phasing import phaser as shared
from hiphase_tpu.phasing.block_gen import PhaseBlock
from hiphase_tpu.phasing.phaser import BlockData, _mark_tr_overlaps, load_variant_calls
from hiphase_tpu.phasing.read_parsing import GlobalRealignmentConfig
from hiphase_tpu_torch.align.wfa_device import WfaCounters
from hiphase_tpu_torch.phasing.global_realign import load_full_read_segments


def prepare_block(phase_problem: PhaseBlock, vcf_paths: list[str],
                  bam_paths: list[str], reference_genome: ReferenceGenome,
                  reference_buffer: int, min_matched_alleles: int,
                  min_mapq: int,
                  global_config: GlobalRealignmentConfig | None,
                  device: torch.device | None = None,
                  wfa_counters: WfaCounters | None = None) -> BlockData:
    """Load variants + reads for one block (the host half of a solve).
    With ``--wfa-engine device`` the reads' window graphs are aligned on
    ``device``, counted in ``wfa_counters``."""
    if global_config is None:
        return shared.prepare_block(
            phase_problem, vcf_paths, bam_paths, reference_genome,
            reference_buffer, min_matched_alleles, min_mapq, global_config)
    variant_calls, hom_calls = load_variant_calls(
        phase_problem, vcf_paths, reference_genome, reference_buffer, True)
    _mark_tr_overlaps(variant_calls, hom_calls)
    read_segments, phasable_segments, read_stats = load_full_read_segments(
        phase_problem, bam_paths, variant_calls, hom_calls, reference_genome,
        min_matched_alleles, min_mapq, global_config, device, wfa_counters)
    return BlockData(phase_problem, variant_calls, hom_calls,
                     read_segments, phasable_segments, read_stats)
