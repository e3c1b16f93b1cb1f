"""The torch port's orchestrator helpers against the JAX package's, and the
batched device solver's accounting, on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import hiphase_tpu.parallel.orchestrator as jorch
import hiphase_tpu_torch.parallel.orchestrator as torch_orch
from hiphase_tpu.core.read_segments import ReadSegment
from hiphase_tpu.core.variants import Variant
from hiphase_tpu.phasing.phaser import BlockData
from hiphase_tpu_torch.phasing import phaser as tphaser
from hiphase_tpu_torch.phasing.native_beam import NativeBeamSolver

from tests.test_solver import make_block

torch.set_num_threads(2)


def test_constants_match():
    for name in ("READ_BUCKETS", "BUCKET_BATCH", "TILE", "PIPELINE_DEPTH",
                 "AMB"):
        assert getattr(torch_orch, name) == getattr(jorch, name), name


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 128, 129, 1000, 1024,
                               1025, 2560])
def test_bucket_and_width_helpers_match(n):
    assert (torch_orch._bucket_of(n, torch_orch.READ_BUCKETS)
            == jorch._bucket_of(n, jorch.READ_BUCKETS))
    assert torch_orch._pad_width(n) == jorch._pad_width(n)


@pytest.mark.parametrize("threads", [1, 3])
def test_iter_prepared_matches(threads):
    blocks = list(range(100))

    def classify(b):
        return "solve" if b % 3 else "unphased"

    def prep(b):
        return b * 10

    got = list(torch_orch.iter_prepared(iter(blocks), prep, classify,
                                        threads=threads, window=2))
    want = list(jorch.iter_prepared(iter(blocks), prep, classify,
                                    threads=threads, window=2))
    assert got == want


def _block_data(seed, nv=12, nr=16):
    from hiphase_tpu.phasing.block_gen import PhaseBlock
    rng = np.random.default_rng(seed)
    variants, reads, _, _ = make_block(rng, nv, nr, window=6)
    block = PhaseBlock.new(seed, "chr1", 0, 0, "S", 1)
    for v in variants:
        block.add_locus_variant("chr1", v.position, 0)
    return BlockData(block, variants, [], reads, [], None)


@pytest.mark.parametrize("estimate", [False, True])
def test_stats_from_beam_matches(estimate):
    data = _block_data(4)
    h1 = [0, 1, 2, 0, 1, 1, 0, 0, 1, 0, 1, 2]
    h2 = [1, 0, 2, 1, 1, 0, 1, 0, 0, 1, 0, 2]
    got = torch_orch._stats_from_beam(data, h1, h2, 77, 3, estimate=estimate)
    want = jorch._stats_from_beam(data, h1, h2, 77, 3, estimate=estimate)
    # each package has its own PhaseStats class: compare the fields
    assert type(got).__name__ == type(want).__name__ == "PhaseStats"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _block_with_unset_alleles(seed):
    """A block whose reads carry quals at unset alleles: every third allele
    inside a read's window made ambiguous, and one variant ignored."""
    data = _block_data(seed)
    for i, rs in enumerate(data.read_segments):
        rs.alleles[1:-1:3] = torch_orch.AMB
        rs.quals[1:-1:3] = 20 + i
    data.variants[5].is_ignored = True
    return data


@pytest.mark.parametrize("estimate", [False, True])
def test_stats_from_beam_adds_the_unset_allele_cost(estimate):
    """The port's batched engines report the beam's cost in the host A*
    oracle's units: the JAX package's cost plus the quals of the reads'
    unset alleles at the variants that are not ignored."""
    data = _block_with_unset_alleles(4)
    unset = sum(int(q) for rs in data.read_segments
                for k, (a, q) in enumerate(zip(rs.alleles, rs.quals))
                if a >= torch_orch.AMB
                and not data.variants[rs.start + k].is_ignored)
    assert unset > 0
    assert tphaser.unset_allele_cost(data) == unset
    h1 = [0, 1, 2, 0, 1, 1, 0, 0, 1, 0, 1, 2]
    h2 = [1, 0, 2, 1, 1, 0, 1, 0, 0, 1, 0, 2]
    got = dataclasses.asdict(
        torch_orch._stats_from_beam(data, h1, h2, 77, 3, estimate=estimate))
    want = dataclasses.asdict(
        jorch._stats_from_beam(data, h1, h2, 77, 3, estimate=estimate))
    want["actual_cost"] += unset
    if not estimate:
        want["estimated_cost"] += unset
    assert got == want


def test_batched_solver_matches_native_and_counts_transfers():
    """Partial buckets drain; two host→device copies per batch; the
    fast→full escalation gives the same haplotypes as the native engine."""
    cpu = torch.device("cpu")
    blocks = [_block_data(s, nv=10 + s, nr=14) for s in range(7)]
    dev = torch_orch.BatchedDeviceSolver(cpu, beam_width=64, batch_size=3)
    nat = NativeBeamSolver(beam_width=64, batch_size=3)
    got, want = [], []
    for d in blocks:
        got += dev.submit(d)
        want += nat.submit(d)
    got += dev.drain()
    want += nat.drain()
    assert len(got) == len(want) == len(blocks)
    by_block = {pr.phase_block.block_index: pr for pr, _ in got}
    for pr, _ in want:
        mine = by_block[pr.phase_block.block_index]
        assert mine.haplotype_1 == pr.haplotype_1
        assert mine.haplotype_2 == pr.haplotype_2
        assert mine.statistics == pr.statistics
    assert dev.device_batches > 3      # 3 fast-width batches + escalations
    assert dev.device_transfers == 2 * dev.device_batches


def test_reads_in_one_slot_share_it():
    variants = [Variant.new_snv(0, 10 * (j + 1), b"A", b"C", 0, 1)
                for j in range(6)]
    reads = [ReadSegment.new("a", [0, 1, 3, 3, 3, 3], [30, 30, 0, 0, 0, 0]),
             ReadSegment.new("b", [3, 3, 3, 1, 0, 3], [0, 0, 0, 30, 30, 0])]
    assert torch_orch.assign_slots(reads) == ([0, 0], 1)
    _a, _q, _s, resets = torch_orch.tensorize_block(reads, variants, 2, 6,
                                                    slotted=True)
    assert resets[0].tolist() == [False, False, False, True, False, False]
