"""The port's single-block path, ``phaser.solve_block``, against the JAX
package's on the CPU: every multi-variant block of a small seeded dataset
through both, on the beam at width 256 (``"beam"``), on the beam at
``min_queue_size`` unpadded (``"beam-full"``: W = 1000 and W = 200), and
on the host A* oracle as the control, at both queue settings of
tests/test_stats_parity.py.

Every field of PhaseResult and HaplotagResult must be equal, enums by
value: the tolerance is 0. The port's beam runs its kernels' plain PyTorch
versions here because the tests pass ``device=torch.device("cpu")``.
"""

import pytest
import torch

from hiphase_tpu.core.reference_genome import ReferenceGenome as JaxReference
from hiphase_tpu.phasing import block_gen as jax_block_gen
from hiphase_tpu.phasing import phaser as jax_phaser
from hiphase_tpu_torch.core.reference_genome import ReferenceGenome
from hiphase_tpu_torch.device import DeviceUnavailableError
from hiphase_tpu_torch.phasing import block_gen, phaser
from hiphase_tpu_torch.utils.compare import plain_values

from tests.sim import build_dataset

torch.set_num_threads(2)
CPU = torch.device("cpu")

QUEUE_SETTINGS = {"default": dict(min_queue_size=1000, queue_increment=3),
                  "q200": dict(min_queue_size=200, queue_increment=7)}


def _blocks(mod, vcf, bam):
    """The blocks the CLI would solve (more than one variant)."""
    it = mod.PhaseBlockIterator([vcf], [bam], "SAMPLE", min_quality=0,
                                min_mapq=5, min_spanning_reads=1,
                                allow_supplemental_joins=True)
    return [b for b in it if not b.unphased_block and b.num_variants > 1]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("solve_block")
    fasta, vcf, bam, _contigs, _ = build_dataset(
        d, seed=41, n_contigs=3, contig_len=6000, coverage=15)
    return {"vcf": vcf, "bam": bam,
            "jax": (JaxReference.from_fasta(fasta),
                    _blocks(jax_block_gen, vcf, bam)),
            "port": (ReferenceGenome.from_fasta(fasta),
                     _blocks(block_gen, vcf, bam))}


@pytest.mark.parametrize("queue", sorted(QUEUE_SETTINGS))
@pytest.mark.parametrize("solver", ["beam", "beam-full", "astar"])
def test_solve_block_matches_jax(dataset, monkeypatch, solver, queue):
    kw = QUEUE_SETTINGS[queue]
    jax_ref, jax_blocks = dataset["jax"]
    ref, blocks = dataset["port"]
    assert len(blocks) == len(jax_blocks) >= 3
    if solver == "astar":
        # the host oracle takes no device and never asks for CUDA
        def no_cuda():
            raise AssertionError("solve_block(solver='astar') asked for CUDA")
        monkeypatch.setattr(torch.cuda, "is_available", no_cuda)
    device = None if solver == "astar" else CPU
    for jb, pb in zip(jax_blocks, blocks):
        want = jax_phaser.solve_block(jb, [dataset["vcf"]], [dataset["bam"]],
                                      jax_ref, solver=solver, **kw)
        got = phaser.solve_block(pb, [dataset["vcf"]], [dataset["bam"]], ref,
                                 solver=solver, device=device, **kw)
        assert plain_values(got) == plain_values(want), pb.block_index
        stats = got[0].statistics
        if solver != "astar":
            assert stats.estimated_cost == stats.actual_cost


def test_beam_solve_block_without_a_cuda_device_raises(dataset, monkeypatch):
    ref, blocks = dataset["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="CUDA device"):
        phaser.solve_block(blocks[0], [dataset["vcf"]], [dataset["bam"]], ref,
                           solver="beam")
