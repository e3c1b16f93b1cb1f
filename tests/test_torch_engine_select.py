"""``--engine auto`` chosen by measured rates, on the CPU.

The tests pass ``devices=[torch.device("cpu")]``, so the device engine
runs its kernels' plain PyTorch versions; a rating workload cut to a few
small blocks keeps them quick. The device must beat the host rung by
RATE_MARGIN; an explicit engine, or no device at all, is never rated.
"""

import functools

import numpy as np
import pytest
import torch

from hiphase_tpu_torch import cli
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.parallel import engine_select as es
from hiphase_tpu_torch.phasing.beam import assign_slots

from tests.sim import build_dataset

torch.set_num_threads(2)
CPU = [torch.device("cpu")]
# the run's widths at a small size: W = 64, two-row batches
SOLVER_KW = dict(beam_width=None, batch_size=2, min_queue_size=64,
                 queue_increment=3)
SMALL = dict(blocks=2, block_bp=20_000)


@pytest.fixture
def small_workload(monkeypatch):
    monkeypatch.setattr(es, "rating_workload",
                        functools.partial(es.rating_workload, **SMALL))


def _fixed_rates(monkeypatch, rates):
    calls = []

    def measured(devices, threads, solver_kw, workload):
        calls.append((devices, threads, solver_kw, len(workload)))
        return dict(rates)
    monkeypatch.setattr(es, "measure_rates", measured)
    return calls


def _never_rated(monkeypatch):
    def measured(*_a, **_kw):
        raise AssertionError("rated")
    monkeypatch.setattr(es, "measure_rates", measured)


@pytest.mark.parametrize("device_rate,engine", [
    (100.0, "native"),      # slower than native
    (120.0, "native"),      # exactly the margin is not enough
    (120.5, "cuda"),        # past the margin
    (5000.0, "cuda")])
def test_device_wins_only_past_the_margin(monkeypatch, small_workload,
                                          device_rate, engine):
    monkeypatch.setattr(native, "available", lambda: True)
    calls = _fixed_rates(monkeypatch, {"cuda": device_rate, "native": 100.0})
    choice = es.choose_engine("auto", CPU, 3, **SOLVER_KW)
    assert choice.engine == engine
    assert choice.rates == {"cuda": device_rate, "native": 100.0}
    assert calls == [(CPU, 3, SOLVER_KW, SMALL["blocks"])]


@pytest.mark.parametrize("has_native", [True, False])
def test_measured_rates_on_the_cpu(monkeypatch, small_workload, has_native):
    """The real measurement: the device engine's plain versions against
    the native beam, or against the host A* oracle when the native
    library does not load."""
    monkeypatch.setattr(native, "available", lambda: has_native)
    host = "native" if has_native else "astar"
    choice = es.choose_engine("auto", CPU, 1, **SOLVER_KW)
    assert set(choice.rates) == {"cuda", host}
    assert all(r > 0 for r in choice.rates.values())
    margin = choice.rates["cuda"] > es.RATE_MARGIN * choice.rates[host]
    assert choice.engine == ("cuda" if margin else host)
    assert choice.seconds > 0 and choice.build_seconds == 0.0


def test_a_slow_device_loses(monkeypatch, small_workload):
    """A device made slow: every device pass waits 0.5 s, so its rate
    falls far below the native beam's."""
    from hiphase_tpu_torch.parallel import orchestrator
    drain = orchestrator.BatchedDeviceSolver.drain

    def slow_drain(self):
        import time
        time.sleep(0.5)
        return drain(self)
    monkeypatch.setattr(orchestrator.BatchedDeviceSolver, "drain", slow_drain)
    choice = es.choose_engine("auto", CPU, 1, **SOLVER_KW)
    assert choice.engine == "native"
    hets = SMALL["blocks"] * (SMALL["block_bp"] // es.HET_SPACING)
    assert choice.rates["cuda"] < hets / 0.5


@pytest.mark.parametrize("engine", ["cuda", "native", "astar"])
def test_an_explicit_engine_is_never_rated(monkeypatch, engine):
    _never_rated(monkeypatch)
    choice = es.choose_engine(engine, CPU, 1, **SOLVER_KW)
    assert choice == es.EngineChoice(engine)


@pytest.mark.parametrize("has_native,engine", [(True, "native"),
                                               (False, "astar")])
def test_no_device_nothing_rated(monkeypatch, has_native, engine):
    _never_rated(monkeypatch)
    monkeypatch.setattr(native, "available", lambda: has_native)
    assert es.choose_engine("auto", None, 4, **SOLVER_KW) == \
        es.EngineChoice(engine)


def test_rating_workload_is_seeded():
    a, b = es.rating_workload(**SMALL), es.rating_workload(**SMALL)
    other = es.rating_workload(seed=1, **SMALL)

    def view(blocks):
        return [[(r.start, r.end, r.alleles.tobytes(), r.quals.tobytes())
                 for r in d.read_segments] for d in blocks]
    assert view(a) == view(b)
    assert view(a) != view(other)
    assert [[v.position for v in d.variants] for d in a] == \
        [[v.position for v in d.variants] for d in b]


def test_rating_workload_has_the_bench_shape():
    """64 blocks of 312 hets, 500 reads of about 19 hets each, 1 % of
    alleles against the read's haplotype, in the (64, 128) bucket."""
    blocks = es.rating_workload()
    assert len(blocks) == 64
    assert {len(d.variants) for d in blocks} == {312}
    assert {len(d.read_segments) for d in blocks} == {500}
    lens = [len(r.alleles) for d in blocks for r in d.read_segments]
    assert max(lens) == 18 and 16 < np.mean(lens) < 18
    assert max(assign_slots(d.read_segments)[1] for d in blocks) <= 128
    # each read carries one haplotype, flipped at about 1 % of its alleles:
    # two reads over the same columns then differ, past their haplotypes,
    # at about 2 %
    differ = overlap = 0
    for d in blocks[:8]:
        reads = sorted(d.read_segments, key=lambda r: r.start)
        for a, b in zip(reads, reads[1:]):
            lo, hi = b.start, min(a.end, b.end)
            if hi - lo < 10:
                continue
            x = a.alleles[lo - a.start:hi - a.start] ^ \
                b.alleles[lo - b.start:hi - b.start]
            differ += min(int(x.sum()), int((1 - x).sum()))
            overlap += hi - lo
    assert 0.01 < differ / overlap < 0.03


@pytest.mark.parametrize("device_rate,engine", [(1.0, "native"),
                                                (1e9, "cuda")])
def test_last_run_stats_name_the_engine_that_ran(tmp_path, monkeypatch,
                                                 device_rate, engine):
    monkeypatch.setattr(native, "available", lambda: True)
    _fixed_rates(monkeypatch, {"cuda": device_rate, "native": 1000.0})
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=27, n_contigs=1,
                                           contig_len=3000)
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(tmp_path / "out.vcf.gz"),
                     "--disable-global-realignment", "--batch-size", "4"],
                    device=CPU[0]) == 0
    stats = cli.LAST_RUN_STATS
    assert stats["engine"] == engine
    assert stats["engine_rates"] == {"cuda": device_rate, "native": 1000.0}
    assert stats["engine_rating"]["seconds"] >= 0
    # the solver that ran is the chosen engine's
    assert ("device_batches" in stats) == (engine == "cuda")
    assert ("node_expansions" in stats) == (engine == "native")
