"""Process-pool workers for the host A* engine (ref: src/main.rs:325-462).

The reference fans `solve_block` out to a shared-memory thread pool; CPython
threads cannot parallelize the Python/NumPy portions of the solve, so the
equivalent here is a **fork**-based process pool. Fork (not spawn) matters:
the whole-genome `ReferenceGenome` is loaded in the parent before the pool
starts and shared copy-on-write — zero per-worker copy, matching the
reference's `Arc<ReferenceGenome>` (ref: main.rs:240-260). Workers open
their own BAM/VCF handles inside `solve_block`, exactly like the reference's
thread-local readers (ref: phaser.rs:43-45).

Failure propagation is fail-fast: a worker exception re-raises in the parent
on result collection (the analog of `pool.panic_count()` aborting the run,
ref: main.rs:338-342).
"""

from __future__ import annotations

from typing import Any

# Parent-side state, inherited by forked workers copy-on-write.
_STATE: dict[str, Any] = {}


def init_parent(reference_genome, vcf_paths, sample_to_bams, *,
                reference_buffer, min_matched_alleles, min_mapq,
                min_queue_size, queue_increment, global_config) -> None:
    """Install the shared solve context in the parent BEFORE forking."""
    _STATE.update(
        reference_genome=reference_genome,
        vcf_paths=list(vcf_paths),
        sample_to_bams=dict(sample_to_bams),
        reference_buffer=reference_buffer,
        min_matched_alleles=min_matched_alleles,
        min_mapq=min_mapq,
        min_queue_size=min_queue_size,
        queue_increment=queue_increment,
        global_config=global_config,
    )


def solve_block_worker(block):
    """Run one block through the full host solve (prepare + A* + finalize).
    Executed inside a forked worker; reads `_STATE` copy-on-write."""
    from hiphase_tpu_torch.phasing.phaser import solve_block

    s = _STATE
    return solve_block(
        block, s["vcf_paths"], s["sample_to_bams"][block.sample_name],
        s["reference_genome"],
        reference_buffer=s["reference_buffer"],
        min_matched_alleles=s["min_matched_alleles"],
        min_mapq=s["min_mapq"],
        min_queue_size=s["min_queue_size"],
        queue_increment=s["queue_increment"],
        global_config=s["global_config"],
        solver="astar")
