"""The port's spans (`hiphase_tpu_torch.tracing`) over whole runs on the
CPU, and the recorder alone.

A small dual-mode job runs through ``cli.main(argv, device=cpu)`` with
``--engine cuda --wfa-engine device`` (the kernels' plain versions), once
as a user runs it and once under ``torch.profiler``: the stage totals are
the stage spans, every child span lies inside its parent on its thread,
and the interval log, kept only under the profiler, holds every thread's
spans on the profiler's own clock and adds no profiler event.
"""

import copy
import logging
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hiphase_tpu_torch import cli, tracing
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.phasing.native_beam import NativeBeamSolver

from tests.sim import build_dataset

torch.set_num_threads(2)
CPU = torch.device("cpu")
STAGES = ("block_gen", "prepare", "solve", "writer")
# each span of a dual-mode job on the device WFA and the span that
# encloses it on its thread (the scratch lock is taken on a card only)
PARENT = {"block_gen": None, "prepared_wait": None, "solve": None,
          "solve.estimate": "solve", "solve.beam_wait": "solve",
          "prepare": None, "prepare.variants": "prepare",
          "prepare.windows": "prepare", "wfa.ladder": "prepare",
          "wfa.device_wait": "wfa.ladder", "prepare.assign": "prepare",
          "writer": None}


def _argv(data, out, extra):
    fasta, vcf, bam = data
    return ["--bam", bam, "--vcf", vcf, "--reference", fasta,
            "--output-vcf", str(out / "out.vcf.gz"),
            "--stats-file", str(out / "stats.tsv"),
            "--phase-min-queue-size", "64"] + extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two contigs of three blocks on two prepare threads, run plainly,
    then under the profiler (its events kept as (name, start_ns))."""
    d = tmp_path_factory.mktemp("tracing")
    fasta, vcf, bam, _c, _t = build_dataset(d, seed=11, n_contigs=2,
                                            contig_len=2000, coverage=4)
    argv = _argv((fasta, vcf, bam), d, [
        "--engine", "cuda", "--wfa-engine", "device", "--threads", "2"])
    assert cli.main(argv, device=CPU) == 0
    plain = copy.deepcopy(cli.LAST_RUN_STATS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main(argv, device=CPU) == 0
    traced = copy.deepcopy(cli.LAST_RUN_STATS)
    events = [(e.name(), e.start_ns())
              for e in prof.profiler.kineto_results.events()]
    return {"plain": plain, "traced": traced, "events": events,
            "data": (fasta, vcf, bam), "dir": d}


@pytest.mark.parametrize("run", ["plain", "traced"])
def test_stage_seconds_are_the_stage_spans(runs, run):
    stats = runs[run]
    spans = stats["spans"]
    assert set(spans) == set(PARENT)
    assert stats["stage_seconds"] == {
        k: round(spans[k]["wall"], 3) for k in STAGES}
    for name, t in spans.items():
        assert t["n"] >= 1 and t["wall"] >= 0 and t["cpu"] >= 0, name
    # one prepare span a solved block; one ladder and its parts a block
    assert spans["prepare"]["n"] == stats["blocks"] >= 2
    for name in ("prepare.variants", "prepare.windows", "wfa.ladder",
                 "prepare.assign", "solve.estimate"):
        assert spans[name]["n"] == stats["blocks"], name
    assert spans["wfa.device_wait"]["n"] == stats["wfa"]["band_calls"]
    assert spans["solve.beam_wait"]["n"] == stats["device_batches"]


def test_no_interval_log_without_a_profiler(runs):
    assert "trace" not in runs["plain"]
    assert "trace" in runs["traced"]


def test_child_spans_lie_inside_their_parents(runs):
    log = runs["traced"]["trace"]["spans"]
    assert {s[0] for s in log} == set(PARENT)
    for name, thread, start, end, parent in log:
        assert start <= end and parent == PARENT[name], (name, parent)
        if parent is None:
            continue
        assert any(n == parent and t == thread and s <= start and end <= e
                   for n, t, s, e, _p in log), (name, thread)


def test_the_log_holds_the_pools_spans(runs):
    """Every thread's spans, those of the prepare pool too, which the
    profiler does not record."""
    log = runs["traced"]["trace"]["spans"]
    threads = {s[1] for s in log}
    assert len(threads) > 1
    assert {s[1] for s in log if s[0] == "solve"} == {"MainThread"}
    pool = {s[1] for s in log if s[0] == "prepare"}
    assert pool and "MainThread" not in pool
    assert {s[1] for s in log if s[0].startswith(("prepare.", "wfa."))} \
        <= pool
    assert len([s for s in log if s[0] == "prepare"]) \
        == runs["traced"]["spans"]["prepare"]["n"]


def test_the_log_is_on_the_profilers_clock(runs):
    """An op the profiler recorded inside the beam wait falls inside that
    span's interval, with no offset."""
    trace = runs["traced"]["trace"]
    assert trace["clock"] == tracing.CLOCK == "CLOCK_REALTIME"
    waits = [(s, e) for n, _t, s, e, _p in trace["spans"]
             if n == "solve.beam_wait"]
    assert waits
    inside = [n for n, t in runs["events"] if n.startswith("aten::")
              and any(s <= t <= e for s, e in waits)]
    assert inside


def test_no_profiler_event_bears_a_span_name(runs):
    names = {n for n, _t in runs["events"]}
    assert names and not names & set(PARENT)
    assert not any(n.startswith(tuple(PARENT)) and "::" not in n
                   for n in names)


def test_unread_timing_is_gone(runs):
    for stats in (runs["plain"], runs["traced"]):
        assert "phasing_seconds" not in stats
        assert "solve_seconds" not in stats
    assert not hasattr(NativeBeamSolver(), "solve_seconds")


def test_native_engine_records_the_sweep_and_logs_the_totals(runs):
    """The native beam shares the estimate sweep's span; at -v the run's
    last log line gives the span totals."""
    if not native.available():
        pytest.skip("the native host library does not load here")
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger("hiphase_tpu_torch")
    handler, level = Lines(), log.level
    log.addHandler(handler)
    log.setLevel(logging.DEBUG)
    try:
        out = runs["dir"] / "native"
        out.mkdir()
        assert cli.main(_argv(runs["data"], out, [
            "--engine", "native", "--threads", "2", "-v"])) == 0
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    stats = cli.LAST_RUN_STATS
    assert stats["engine"] == "native" and "solve_seconds" not in stats
    spans = stats["spans"]
    assert spans["solve.estimate"]["n"] == stats["blocks"]
    assert "solve.beam_wait" not in spans and "wfa.ladder" not in spans
    line = [m for m in lines if m.startswith("Spans")]
    assert len(line) == 1 and "\n" not in line[0]
    assert all(f"{name} " in line[0] for name in spans)


def test_recorder_nesting_totals_and_log():
    rec = tracing.Recorder(log=True)
    with rec.span("a"):
        with rec.span("b"):
            pass
        with rec.span("b"):
            pass
    totals = rec.totals()
    assert totals["b"]["n"] == 2 and totals["a"]["n"] == 1
    assert totals["a"]["wall"] >= totals["b"]["wall"] > 0
    log = rec.trace()["spans"]
    assert [(s[0], s[4]) for s in log] == [("b", "a"), ("b", "a"),
                                          ("a", None)]
    assert tracing.Recorder().trace() is None


def test_a_span_records_when_its_body_raises():
    rec = tracing.Recorder()
    with pytest.raises(ValueError):
        with rec.span("a"):
            raise ValueError
    with rec.span("b"):
        pass
    assert rec.totals()["a"]["n"] == 1
    assert rec.trace() is None
    assert tracing.Recorder(log=True).trace() == {"clock": "CLOCK_REALTIME",
                                                  "spans": []}


def test_off_records_nothing():
    with tracing.OFF.span("a"):
        with tracing.OFF.span("b"):
            pass
    assert tracing.OFF.totals() == {} and tracing.OFF.trace() is None


def test_recorder_from_many_threads():
    """No span is lost when many threads record at once, each nesting its
    own spans, with the interpreter switching threads as often as it can."""
    rec = tracing.Recorder(log=True)
    n_threads, n_spans = 16, 500
    errors = []

    def work():
        try:
            for _ in range(n_spans):
                with rec.span("outer"):
                    with rec.span("inner"):
                        pass
        except BaseException as e:
            errors.append(e)
            raise

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    totals = rec.totals()
    assert totals["outer"]["n"] == totals["inner"]["n"] == n_threads * n_spans
    log = rec.trace()["spans"]
    assert len(log) == 2 * n_threads * n_spans
    assert all(s[4] == ("outer" if s[0] == "inner" else None) for s in log)
    assert len({s[1] for s in log}) == n_threads
