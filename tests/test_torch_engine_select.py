"""``--engine auto`` chosen by measured rates, on the CPU.

The tests pass ``devices=[torch.device("cpu")]``, so the device engine
runs its kernels' plain PyTorch versions; a rating workload cut to a few
small blocks keeps them quick. The device must beat the host rung by
RATE_MARGIN; an explicit engine, or no device at all, is never rated.
The rate cache: a hit skips the rating, a change of any field of its key,
an entry past its TTL and a corrupt file re-rate, a rating that raises or
is stopped stores nothing. Every test passes a cache file under its
``tmp_path``, or None. The deferred choice (`BackgroundChoice`,
`DeferredUpgradeSolver`): a switch after k blocks loses and repeats none,
an unresolved choice never builds the device solver, an error of the
choice is raised at the next submit or at drain, and drain stops and
joins a rating still going.
"""

import json
import os
import threading
import time

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

    def measured(devices, threads, solver_kw, workload, stop=None):
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


class _ResolvedFirst(es.BackgroundChoice):
    """A background choice that has ended when its constructor returns."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._thread.join()


@pytest.mark.parametrize("device_rate,engine", [(1.0, "native"),
                                                (1e9, "cuda")])
def test_last_run_stats_name_the_engine_that_ran(tmp_path, monkeypatch,
                                                 device_rate, engine):
    monkeypatch.setattr(native, "available", lambda: True)
    _fixed_rates(monkeypatch, {"cuda": device_rate, "native": 1000.0})
    # the choice ends before the run starts: the first block goes to the
    # chosen engine
    monkeypatch.setattr(es, "BackgroundChoice", _ResolvedFirst)
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=27, n_contigs=1,
                                           contig_len=3000)
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(tmp_path / "out.vcf.gz"),
                     "--disable-global-realignment", "--batch-size", "4"],
                    device=CPU[0], rate_cache=tmp_path / "rates.json") == 0
    stats = cli.LAST_RUN_STATS
    assert stats["engine"] == engine
    assert stats["engine_rates"] == {"cuda": device_rate, "native": 1000.0}
    assert stats["engine_rating"]["seconds"] >= 0
    assert stats["engine_rating"]["cached"] is False
    assert stats["engine_rating"]["resolved"] is True
    solved = stats["engine_blocks"][engine]
    assert solved > 0 and sum(stats["engine_blocks"].values()) == solved
    assert (stats["engine_upgrade"] is None) == (engine == "native")
    # the solver that ran is the chosen engine's
    assert ("device_batches" in stats) == (engine == "cuda")
    assert ("node_expansions" in stats) == (engine == "native")


# --- the rate cache -------------------------------------------------------

RATES = {"cuda": 5000.0, "native": 1000.0}


def _choose(cache, devices=CPU, threads=1, **kw):
    return es.choose_engine("auto", devices, threads, rate_cache=cache,
                            **{**SOLVER_KW, **kw})


def test_a_cache_hit_skips_the_rating(monkeypatch, tmp_path):
    cache = tmp_path / "rates.json"
    monkeypatch.setattr(native, "available", lambda: True)
    calls = _fixed_rates(monkeypatch, RATES)
    first = _choose(cache)
    assert (first.engine, first.rates, first.cached) == ("cuda", RATES, False)
    assert len(calls) == 1
    _never_rated(monkeypatch)
    hit = _choose(cache)
    assert (hit.engine, hit.rates, hit.cached) == ("cuda", RATES, True)
    assert hit.build_seconds == 0.0
    entries = json.loads(cache.read_text())["entries"]
    assert len(entries) == 1 and entries[0]["rates"] == RATES
    assert entries[0]["key"] == json.loads(json.dumps(
        es.rate_cache_key(CPU, 1, SOLVER_KW)))


def test_the_cache_path_expands_the_home_directory(monkeypatch, tmp_path):
    """``~`` in the path is the home directory (the CLI's default is
    under it); the test's home is its own directory."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(native, "available", lambda: True)
    _fixed_rates(monkeypatch, RATES)
    _choose("~/rates/engine.json")
    assert (tmp_path / "rates" / "engine.json").exists()


# each field of the key, and a change of it between two runs
KEY_CHANGES = {
    "devices": lambda mp: {"devices": CPU * 2},
    "torch": lambda mp: mp.setattr(torch, "__version__", "0.0.0+other"),
    "torch_cuda": lambda mp: mp.setattr(torch.version, "cuda", "0.0"),
    "kernels": lambda mp: mp.setattr(
        es_kernels().build, "library_path",
        lambda name, real=es_kernels().build.library_path:
        real(name).with_name("libother.so")),
    "host_library": lambda mp: mp.setitem(native.LOADED, "codec", "other"),
    "cpu_count": lambda mp: mp.setattr(os, "cpu_count", lambda: 1023),
    "threads": lambda mp: {"threads": 7},
    "beam_width": lambda mp: {"beam_width": 64},
    "batch_size": lambda mp: {"batch_size": 3},
    "min_queue_size": lambda mp: {"min_queue_size": 128},
    "queue_increment": lambda mp: {"queue_increment": 4},
    "workload": lambda mp: mp.setattr(es, "RATING_SEED", 1),
}


def es_kernels():
    from hiphase_tpu_torch import kernels
    return kernels


def test_the_key_changes_cover_every_field():
    key = es.rate_cache_key(CPU, 1, SOLVER_KW)
    fields = set(key) - {"solver"} | set(key["solver"])
    assert fields == set(KEY_CHANGES)


@pytest.mark.parametrize("field", sorted(KEY_CHANGES))
def test_a_change_of_any_key_field_rates_again(monkeypatch, tmp_path, field):
    cache = tmp_path / "rates.json"
    monkeypatch.setattr(native, "available", lambda: True)
    calls = _fixed_rates(monkeypatch, RATES)
    _choose(cache)
    kw = KEY_CHANGES[field](monkeypatch) or {}
    choice = _choose(cache, **kw)
    assert len(calls) == 2 and not choice.cached
    # both entries are kept, and each is a hit for its own key
    assert len(json.loads(cache.read_text())["entries"]) == 2
    assert _choose(cache, **kw).cached and len(calls) == 2


@pytest.mark.parametrize("age", [es.RATE_CACHE_TTL + 1, -60.0])
def test_a_stale_entry_rates_again(monkeypatch, tmp_path, age):
    """An entry older than the TTL, or dated in the future, is a miss."""
    cache = tmp_path / "rates.json"
    monkeypatch.setattr(native, "available", lambda: True)
    calls = _fixed_rates(monkeypatch, RATES)
    _choose(cache)
    data = json.loads(cache.read_text())
    data["entries"][0]["time"] = time.time() - age
    cache.write_text(json.dumps(data))
    assert not _choose(cache).cached and len(calls) == 2
    entries = json.loads(cache.read_text())["entries"]
    assert len(entries) == 1 and abs(entries[0]["time"] - time.time()) < 60


@pytest.mark.parametrize("content", [
    "{not json", "", '{"entries": 3}', "[]", '{"entries": [{"key": 1}]}',
    '{"entries": [7, {"rates": {}}]}'])
def test_a_corrupt_cache_file_rates_again_and_is_rewritten(
        monkeypatch, tmp_path, content):
    cache = tmp_path / "rates.json"
    cache.write_text(content)
    monkeypatch.setattr(native, "available", lambda: True)
    calls = _fixed_rates(monkeypatch, RATES)
    assert not _choose(cache).cached and len(calls) == 1
    entries = json.loads(cache.read_text())["entries"]
    assert [e["rates"] for e in entries] == [RATES]
    assert _choose(cache).cached


def test_an_entry_without_both_rates_rates_again(monkeypatch, tmp_path):
    cache = tmp_path / "rates.json"
    monkeypatch.setattr(native, "available", lambda: True)
    calls = _fixed_rates(monkeypatch, RATES)
    _choose(cache)
    data = json.loads(cache.read_text())
    data["entries"][0]["rates"] = {"cuda": 5000.0, "astar": 100.0}
    cache.write_text(json.dumps(data))
    choice = _choose(cache)
    assert not choice.cached and choice.rates == RATES and len(calls) == 2


def test_a_rating_that_raises_stores_nothing(monkeypatch, tmp_path):
    cache = tmp_path / "rates.json"
    monkeypatch.setattr(native, "available", lambda: True)

    def failing(*_a, **_kw):
        raise RuntimeError("the rating failed")
    monkeypatch.setattr(es, "measure_rates", failing)
    with pytest.raises(RuntimeError, match="the rating failed"):
        _choose(cache)
    assert not cache.exists()
    # an existing file keeps its bytes
    _fixed_rates(monkeypatch, RATES)
    _choose(cache, threads=2)
    before = cache.read_bytes()
    monkeypatch.setattr(es, "measure_rates", failing)
    with pytest.raises(RuntimeError):
        _choose(cache)
    assert cache.read_bytes() == before


def test_a_stopped_rating_stores_nothing(monkeypatch, small_workload,
                                         tmp_path):
    """The real rating on the CPU, asked to stop before its first pass."""
    cache = tmp_path / "rates.json"
    stop = threading.Event()
    stop.set()
    with pytest.raises(es.RatingStopped):
        es.choose_engine("auto", CPU, 1, rate_cache=cache, stop=stop,
                         **SOLVER_KW)
    assert not cache.exists()


def test_no_rating_touches_no_cache(monkeypatch, tmp_path):
    """An explicit engine, or no device, neither reads nor writes it."""
    cache = tmp_path / "rates.json"
    _never_rated(monkeypatch)
    for engine, devices in (("cuda", CPU), ("native", CPU), ("auto", None)):
        es.choose_engine(engine, devices, 1, rate_cache=cache, **SOLVER_KW)
    assert not cache.exists()


# --- the deferred choice --------------------------------------------------

def _blocks(n):
    return es.rating_workload(blocks=n, block_bp=20_000)


def _native_solver(batch_size=3):
    from hiphase_tpu_torch.phasing.native_beam import NativeBeamSolver
    return NativeBeamSolver(batch_size=batch_size, min_queue_size=64)


def _device_solver():
    from hiphase_tpu_torch.parallel.orchestrator import BatchedDeviceSolver
    return BatchedDeviceSolver(CPU, batch_size=2, min_queue_size=64)


class _ChoiceAfter:
    """A background choice that ends, with ``choice``, after ``k`` calls
    of done() (the deferred solver asks once a submit), or never."""

    def __init__(self, k, choice=None, error=None):
        self.k, self.calls = k, 0
        self.choice, self.error = choice, error
        self.ended_at = None
        self.stopped = False

    def done(self):
        self.calls += 1
        if self.k is not None and self.calls > self.k:
            self.ended_at = self.ended_at or time.perf_counter()
            return True
        return False

    def result(self):
        if self.error is not None:
            raise self.error
        return None if self.stopped and not self.ended_at else self.choice

    def stop(self):
        self.stopped = True


def _solve_all(solver, blocks):
    results = []
    for d in blocks:
        results.extend(solver.submit(d))
    results.extend(solver.drain())
    return {pr.phase_block.block_index: (pr.haplotype_1, pr.haplotype_2)
            for pr, _hr in results}, len(results)


@pytest.mark.parametrize("k", [0, 2, 5, 7])
def test_a_switch_after_k_blocks_loses_and_repeats_none(k):
    blocks = _blocks(8)
    want, _ = _solve_all(_native_solver(), blocks)
    made = []

    def make():
        made.append(_device_solver())
        return made[-1]
    choice = _ChoiceAfter(k, es.EngineChoice("cuda", dict(RATES)))
    solver = es.DeferredUpgradeSolver(_native_solver(), choice, make)
    got, n = _solve_all(solver, blocks)
    assert n == len(blocks) and got == want
    assert len(made) == 1 and solver.engine == "cuda"
    assert solver.blocks == {"native": k, "cuda": len(blocks) - k}
    assert solver.upgrade[:2] == (k, k) and solver.upgrade[2] >= 0
    assert made[0].device_batches >= 1
    assert solver.choice.rates == RATES and solver.late_blocks == 0


def test_a_native_verdict_stays_on_native():
    blocks = _blocks(5)
    solver = es.DeferredUpgradeSolver(
        _native_solver(), _ChoiceAfter(1, es.EngineChoice("native")),
        lambda: pytest.fail("the device solver was built"))
    got, n = _solve_all(solver, blocks)
    assert n == 5 and sorted(got) == list(range(5))
    assert solver.engine == "native" and solver.upgrade is None
    assert solver.blocks == {"native": 5, "cuda": 0}


def test_an_unresolved_choice_never_builds_the_device_solver():
    blocks = _blocks(4)
    choice = _ChoiceAfter(None)
    solver = es.DeferredUpgradeSolver(
        _native_solver(batch_size=2), choice,
        lambda: pytest.fail("the device solver was built"))
    got, n = _solve_all(solver, blocks)
    assert n == 4 and sorted(got) == list(range(4))
    assert choice.stopped and solver.choice is None
    assert solver.blocks == {"native": 4, "cuda": 0}


def _background(monkeypatch, choose):
    monkeypatch.setattr(es, "choose_engine", choose)
    return es.BackgroundChoice(CPU, 1, None, **SOLVER_KW)


@pytest.mark.parametrize("at", ["submit", "drain"])
def test_an_error_of_the_choice_is_raised(monkeypatch, at):
    """A kernel build or rating that raises ends the run: at the next
    submit, or at drain when it ends after the last one."""
    from hiphase_tpu_torch.kernels.build import KernelBuildError
    release = threading.Event()

    def choose(*_a, **_kw):
        release.wait(30)
        raise KernelBuildError("nvcc exited 1")
    background = _background(monkeypatch, choose)
    solver = es.DeferredUpgradeSolver(
        _native_solver(), background,
        lambda: pytest.fail("the device solver was built"))
    blocks = _blocks(3)
    solver.submit(blocks[0])
    release.set()
    if at == "submit":
        background._thread.join(30)
        with pytest.raises(KernelBuildError, match="nvcc exited 1"):
            solver.submit(blocks[1])
    else:
        with pytest.raises(KernelBuildError, match="nvcc exited 1"):
            solver.drain()
    assert not background._thread.is_alive()


def test_drain_stops_and_joins_a_rating_still_going(monkeypatch):
    passes = []

    def choose(*_a, stop=None, **_kw):
        while True:       # one pass after another, until asked to stop
            if stop.is_set():
                raise es.RatingStopped
            passes.append(1)
            time.sleep(0.01)
    background = _background(monkeypatch, choose)
    solver = es.DeferredUpgradeSolver(
        _native_solver(), background,
        lambda: pytest.fail("the device solver was built"))
    got, n = _solve_all(solver, _blocks(4))
    assert n == 4 and passes
    assert not background._thread.is_alive()
    assert solver.choice is None and solver.engine == "native"
    assert [t for t in threading.enumerate() if t.name == "engine-rating"] \
        == []


def test_a_real_background_rating_on_the_cpu(monkeypatch, small_workload,
                                             tmp_path):
    """choose_engine itself on the thread: the rates reach the deferred
    solver and the cache."""
    background = es.BackgroundChoice(CPU, 1, tmp_path / "r.json",
                                     **SOLVER_KW)
    choice = background.result()
    assert set(choice.rates) == {"cuda", "native"} and not choice.cached
    assert background.done() and background.ended_at >= background.started
    assert es.BackgroundChoice(CPU, 1, tmp_path / "r.json",
                               **SOLVER_KW).result().cached


def test_build_all_and_a_lazy_launch_build_each_source_once(monkeypatch):
    """The background build (build_all) and a prepare thread's first WFA
    launch share one lock: each source is compiled once, and neither
    waits for the other forever."""
    from hiphase_tpu_torch import kernels
    built = []

    def fake_build(names):
        out = {}
        for name in names:
            if name not in built:
                built.append(name)
                time.sleep(0.05)      # the compiler's time
            out[name] = kernels.build.BuiltKernel(f"lib{name}.so", "")
        return out

    def fake_bind(self, _path):
        self._lib, self._fn = None, lambda *args: 0
    monkeypatch.setattr(kernels.build, "build", fake_build)
    monkeypatch.setattr(kernels.Kernel, "bind", fake_bind)
    for k in kernels.KERNELS.values():
        monkeypatch.setattr(k, "_fn", None)
        monkeypatch.setattr(k, "launches", 0)
    wfa = kernels.WFA_FORWARD_BACKWARD
    threads = [threading.Thread(target=kernels.build_all),
               threading.Thread(target=wfa.launch)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert sorted(built) == sorted(kernels.KERNELS)
    assert wfa.launches == 1
