"""The torch port's data parallelism over the devices of one host, on the
CPU: ``[cpu] * N`` stands in for N devices (each entry one row chunk of a
batch, run on the kernels' plain versions), against the JAX package's
sharded solve on the 8 virtual CPU devices that tests/conftest.py gives
JAX, the JAX production solver's batching, and the host A* oracle."""

import numpy as np
import pytest
import torch

import hiphase_tpu.parallel.orchestrator as jorch
import hiphase_tpu.parallel.sharding as jshard
import hiphase_tpu_torch.parallel.orchestrator as torch_orch
import hiphase_tpu_torch.parallel.sharding as shard
from __graft_entry__ import _synthetic_block_data
from hiphase_tpu.io.bam import BamReader
from hiphase_tpu.io.vcf import VcfReader
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.device import DeviceUnavailableError, resolve_devices
from hiphase_tpu_torch.phasing.astar import astar_solver

from tests.sim import build_dataset
from tests.test_parallel import _rand_block

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("tile", [None, 3])
def test_sharded_solve_matches_jax_sharded_solve(tile):
    """tests/test_parallel.py's 13 blocks padded to 16, over 8 devices:
    every output equal to the JAX package's mesh solve, and the padding
    rows inert. ``tile`` = 3 pads V = 8 to 9 columns."""
    rng = np.random.default_rng(0)
    blocks = [_rand_block(rng) for _ in range(13)]
    mesh = jshard.make_mesh()
    assert mesh.devices.size == 8
    A, Q, S, n_real = shard.pad_batch(blocks, 8)
    assert A.shape[0] == 16 and n_real == 13

    got = shard.solve_blocks_sharded([CPU] * 8, A, Q, S, beam_width=16,
                                     tile=tile)
    want = jshard.solve_blocks_sharded(mesh, A, Q, S, beam_width=16,
                                       tile=tile)
    for g, w in zip(got[:5], want[:5]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g, w)
    assert got[5] == want[5] and got[5]["blocks"] == 16
    cost, pruned = got[2], got[4]
    assert (cost[n_real:] == 0).all() and (pruned[n_real:] == 0).all()
    assert (got[0][n_real:] == 2).all() and (got[1][n_real:] == 2).all()


def test_sharded_solve_needs_a_divisible_batch():
    rng = np.random.default_rng(1)
    A, Q, S, _ = shard.pad_batch([_rand_block(rng) for _ in range(3)], 1)
    with pytest.raises(AssertionError, match="not divisible"):
        shard.solve_blocks_sharded([CPU] * 2, A, Q, S, beam_width=16)


@pytest.mark.parametrize("n_blocks,multiple", [(13, 8), (16, 8), (1, 3),
                                               (5, 1)])
def test_pad_batch_matches_jax(n_blocks, multiple):
    rng = np.random.default_rng(n_blocks)
    blocks = [_rand_block(rng) for _ in range(n_blocks)]
    got = shard.pad_batch(blocks, multiple)
    want = jshard.pad_batch(blocks, multiple)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3] == n_blocks


def test_row_chunks_split_the_batch_axis_as_the_mesh_does():
    assert shard.row_chunks(16, 8) == [slice(2 * k, 2 * k + 2)
                                       for k in range(8)]
    assert shard.row_chunks(6, 1) == [slice(0, 6)]
    with pytest.raises(ValueError, match="not divisible"):
        shard.row_chunks(6, 4)


class _CountingSolver(torch_orch.BatchedDeviceSolver):
    """Records whether each dispatch was an escalation."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.dispatches = []

    def _dispatch(self, pending, rb, width, escalated=False):
        self.dispatches.append((len(pending), width, escalated))
        super()._dispatch(pending, rb, width, escalated)


def _solve_all(solver, blocks):
    results = []
    for b in blocks:
        results.extend(solver.submit(b))
    results.extend(solver.drain())
    return results


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_production_solver_over_n_devices_matches_astar(n):
    """__graft_entry__.dryrun_multichip's check on the port: the batched
    solver over ``[cpu] * n`` (fast width 16, full width 128) equals the
    host A* oracle on every block, and the fast→full escalation runs."""
    n_blocks = 2 * max(n, 8)
    blocks = [_synthetic_block_data(1000 + i, i) for i in range(n_blocks)]
    solver = _CountingSolver([CPU] * n, beam_width=16, batch_size=2 * n,
                             min_queue_size=128)
    assert solver._batch_size_for(128) == 2 * n
    results = _solve_all(solver, blocks)
    assert len(results) == n_blocks
    for pr, _hr in results:
        data = blocks[pr.phase_block.block_index]
        oracle = astar_solver(data.phase_block.block_index, data.variants,
                              data.read_segments, 128, 3)
        assert pr.haplotype_1 == oracle.haplotype_1
        assert pr.haplotype_2 == oracle.haplotype_2
    assert any(esc for _n, _w, esc in solver.dispatches)
    assert all(w == 128 for _n, w, esc in solver.dispatches if esc)
    assert solver.device_transfers == 2 * n * solver.device_batches


@pytest.mark.parametrize("n,batch_size", [(8, 16), (3, 4), (8, 3)])
def test_batching_matches_the_jax_solver_on_8_devices(n, batch_size):
    """The batch rounds up to a multiple of the device count as the JAX
    solver's does; at 8 devices (the JAX mesh here) the two dispatch the
    same number of batches on the same blocks."""
    for rb in torch_orch.READ_BUCKETS:
        b = min(torch_orch.BUCKET_BATCH[rb], batch_size)
        assert torch_orch.BatchedDeviceSolver(
            [CPU] * n, batch_size=batch_size)._batch_size_for(rb) == \
            max(-(-b // n) * n, n)
    if n != 8:
        return
    blocks = [_synthetic_block_data(2000 + i, i) for i in range(19)]
    kw = dict(beam_width=16, batch_size=batch_size, min_queue_size=128)
    port = torch_orch.BatchedDeviceSolver([CPU] * 8, **kw)
    jax_solver = jorch.BatchedDeviceSolver(**kw)
    assert jax_solver._n_dev == 8
    for rb in torch_orch.READ_BUCKETS:
        assert port._batch_size_for(rb) == jax_solver._batch_size_for(rb)
    got, want = _solve_all(port, blocks), _solve_all(jax_solver, blocks)
    assert port.device_batches == jax_solver.device_batches > 0
    assert port.device_transfers == 2 * 8 * port.device_batches
    assert jax_solver.device_transfers == 2 * jax_solver.device_batches
    key = lambda r: r[0].phase_block.block_index  # noqa: E731
    for (pr, _), (jr, _) in zip(sorted(got, key=key), sorted(want, key=key)):
        assert pr.haplotype_1 == jr.haplotype_1
        assert pr.haplotype_2 == jr.haplotype_2


def _run(tmp_path, fasta, vcf, bam, name, device):
    out = {k: str(tmp_path / f"{name}.{k}") for k in
           ("vcf.gz", "bam", "stats.csv", "tags.tsv", "blocks.tsv",
            "summary.tsv")}
    assert cli.main(["--bam", bam, "--output-bam", out["bam"], "--vcf", vcf,
                     "--output-vcf", out["vcf.gz"], "--reference", fasta,
                     "--stats-file", out["stats.csv"],
                     "--haplotag-file", out["tags.tsv"],
                     "--blocks-file", out["blocks.tsv"],
                     "--summary-file", out["summary.tsv"],
                     "--disable-global-realignment", "--engine", "cuda",
                     "--batch-size", "4", "--beam-width", "64",
                     "--threads", "2"], device=device) == 0
    return out, dict(cli.LAST_RUN_STATS)


def bam_records(path):
    with BamReader(path) as rd:
        return [(r.read_name, r.refid, r.pos, r.flag, r.get_tag("HP"),
                 r.get_tag("PS")) for r in rd]


def assert_same_outputs(a, b, keys=("stats.csv", "tags.tsv", "blocks.tsv",
                                    "summary.tsv")):
    """VCF and BAM record for record; the per-result rows of the stats and
    haplotag files sorted (they are written in arrival order, as
    tests/test_multihost.py compares them)."""
    va = [r.serialize() for r in VcfReader(a["vcf.gz"])]
    assert va == [r.serialize() for r in VcfReader(b["vcf.gz"])]
    assert len(va) > 50
    assert bam_records(a["bam"]) == bam_records(b["bam"])
    for k in keys:
        la = open(a[k]).read().splitlines()
        lb = open(b[k]).read().splitlines()
        if k in ("stats.csv", "tags.tsv"):
            la, lb = [la[0]] + sorted(la[1:]), [lb[0]] + sorted(lb[1:])
        assert la == lb, k
        assert len(la) > 1, k


def test_cli_over_three_devices_matches_one(tmp_path):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=31, n_contigs=4, contig_len=6000, coverage=15)
    one, one_stats = _run(tmp_path, fasta, vcf, bam, "one", CPU)
    three, stats = _run(tmp_path, fasta, vcf, bam, "three", [CPU] * 3)
    assert_same_outputs(one, three)
    assert one_stats["devices"] == ["cpu"] and one_stats["device"] == "cpu"
    assert stats["devices"] == ["cpu"] * 3 and stats["device"] == "cpu"
    assert one_stats["transfers_per_batch"] == 2.0
    assert stats["transfers_per_batch"] == 6.0
    assert stats["device_batches"] >= 1


def test_resolve_devices(monkeypatch):
    with pytest.raises(DeviceUnavailableError, match="CUDA device"):
        resolve_devices(None)
    with pytest.raises(DeviceUnavailableError):
        shard.make_mesh()
    assert resolve_devices(CPU) == (CPU,)
    assert resolve_devices("cpu") == (CPU,)
    assert resolve_devices([CPU] * 3) == (CPU,) * 3
    with pytest.raises(DeviceUnavailableError):
        resolve_devices([CPU, torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="empty"):
        resolve_devices([])
    # with CUDA present: None is every CUDA device, and a list may repeat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert resolve_devices(None) == (cuda0, cuda1)
    assert shard.make_mesh(1) == (cuda0,)
    assert resolve_devices([cuda0, cuda0]) == (cuda0, cuda0)
    with pytest.raises(ValueError, match="more than one type"):
        resolve_devices([CPU, cuda1])
