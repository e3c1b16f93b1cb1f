"""The comparison that decides ``correct``, driven on the CPU through a whole
run (``run.run_cell`` past the look for a card): sound runs of the program
come out correct in both modes; the control, and each fault that the cells
can have planted in the timed path, come out not correct.

The program runs its kernels' plain versions here
(``cli.main(argv, device=torch.device("cpu"))``) on datasets of the cells'
shapes cut to a few blocks (the dual cell's reads shorter too: the plain
graph WFA is slow on the CPU), at a beam width of 64.
"""

import copy
import json
import os

import pytest
import torch

import compare
import run
from hiphase_tpu_torch.parallel import orchestrator
from hiphase_tpu_torch.phasing import beam, phaser
from reference.oracle import Dataset, expect

CPU = torch.device("cpu")
LOCAL = "local-2mb"
DUAL = "dual-1mb-wfa-device"
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device",
               "checks"}


def local_cell() -> run.Cell:
    """The local cell from its files: it is out of BENCHMARK.json until the
    program's duplicated records are mended (PERF.md §7), and its path is
    still driven here."""
    bench = run.load_benchmark()
    with open(os.path.join(run.HERE, "configs", "hg001_local.json")) as fh:
        config = json.load(fh)
    with open(os.path.join(run.HERE, "traffic", "wgs_2mb.json")) as fh:
        traffic = json.load(fh)
    return run.Cell(LOCAL, {"name": LOCAL, "config": "hg001_local",
                            "traffic": "wgs_2mb", "chips": 1},
                    config, traffic, bench["end_to_end"], [])


def small(name: str) -> run.Cell:
    cell = (local_cell() if name == LOCAL
            else run.find_cell(run.load_benchmark(), name))
    cell.config = copy.deepcopy(cell.config)
    cell.config["flags"].update({"--phase-min-queue-size": 64,
                                 "--threads": 2})
    if name == LOCAL:
        cell.traffic = dict(cell.traffic, job_mb=0.3, contigs=1)
    else:
        cell.traffic = dict(cell.traffic, job_mb=0.012, contigs=1)
        cell.config["shapes"].update(coverage=8, read_length=3000)
    return cell


def one_run(cell: run.Cell, seed: int = 2**31 + 11) -> dict:
    return run.run_cell(cell, seed, 0.1, False, CPU, workers=2)


def failing(result: dict) -> set[str]:
    return {n for n, c in result["checks"].items() if not compare.passed(c)}


@pytest.mark.parametrize("name", [LOCAL, DUAL])
def test_sound_run_is_correct(name):
    result = one_run(small(name))
    assert set(result) == RESULT_KEYS
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["checks"]["sampled_blocks"]["value"] >= 1
    assert set(result["metrics"]) == {"hets_per_s", "setup_s"}


@pytest.mark.parametrize("name", [LOCAL, DUAL])
def test_control_is_not_correct(name, tmp_path):
    """The reference with the configuration's ``control`` settings in the
    program's place fails the sampled comparison."""
    cell = small(name)
    data = run.make_dataset(cell, 5, str(tmp_path / "data"))
    ds = Dataset(data["fasta"], data["vcf"], data["bam"])
    st = run.settings_of(cell)
    ref = expect(ds, st, "SAMPLE", 8, 5, 2)
    ctl = expect(ds, st, "SAMPLE", 8, 5, 2,
                 control=cell.config["control"]["settings"])
    numbers = compare.sampled_unlike(ctl.sampled, ref.sampled)
    assert ref.sampled and any(numbers.values()), numbers


@pytest.mark.parametrize("name", [LOCAL, DUAL])
def test_state_left_unchanged_is_not_correct(name, monkeypatch):
    """A beam step that returns its state unchanged (the δ update a
    no-op)."""
    def unchanged(delta, idx, sgn, e0, rn, out):
        out.copy_(delta)
        return out
    monkeypatch.setattr(beam, "permute_update_plain", unchanged)
    result = one_run(small(name))
    assert not result["correct"]
    assert failing(result) & {"sampled_stats_cells_unlike_ref",
                              "sampled_records_unlike_ref"}


@pytest.mark.parametrize("name", [LOCAL, DUAL])
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    """Half of a device batch (its even rows, the first when it holds one
    block) left unsolved."""
    materialize = orchestrator.BatchedDeviceSolver._materialize

    def half(self, job):
        out = materialize(self, job)
        return [r if i % 2 else
                phaser.create_unphased_result(r[0].phase_block)
                for i, r in enumerate(out)]
    monkeypatch.setattr(orchestrator.BatchedDeviceSolver, "_materialize",
                        half)
    result = one_run(small(name))
    assert not result["correct"]
    assert "blocks_unlike_ref" in failing(result)


@pytest.mark.parametrize("name", [LOCAL, DUAL])
def test_answer_altered_is_not_correct(name, monkeypatch):
    """One allele pair of every block swapped where the solver's answer is
    produced."""
    finalize = orchestrator.finalize_block

    def altered(data, h1, h2, stats):
        h1, h2 = list(h1), list(h2)
        m = len(h1) // 2
        h1[m], h2[m] = h2[m], h1[m]
        return finalize(data, h1, h2, stats)
    monkeypatch.setattr(orchestrator, "finalize_block", altered)
    result = one_run(small(name))
    assert not result["correct"]
    assert "sampled_records_unlike_ref" in failing(result)


def test_refuses_without_a_cuda_device(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", DUAL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
