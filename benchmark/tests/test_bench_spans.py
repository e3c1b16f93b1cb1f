"""The span metrics read the program's span totals
(``cli.LAST_RUN_STATS["spans"]``) as means over the window's jobs, and read
nothing from a program whose stats have no spans."""

import pytest

import run

SPAN_METRICS = ("variant_load_s", "window_build_s", "wfa_host_s",
                "wfa_wait_s", "assign_s", "prepare_cpu_s", "estimate_s",
                "beam_wait_s", "prepared_wait_s")


def _spans(scale: float) -> dict:
    wall = {"prepare": 18.0, "prepare.variants": 0.5,
            "prepare.windows": 4.0, "wfa.ladder": 9.0,
            "wfa.scratch_lock": 1.0, "wfa.device_wait": 2.0,
            "prepare.assign": 3.0, "solve": 10.0, "solve.estimate": 8.0,
            "solve.beam_wait": 1.5, "prepared_wait": 6.0}
    cpu = {"prepare": 12.0}
    return {n: {"wall": scale * w, "cpu": scale * cpu.get(n, w / 2), "n": 3}
            for n, w in wall.items()}


def _record(jobs) -> run.Record:
    cell = run.find_cell(run.load_benchmark(), "dual-1mb-wfa-device")
    return run.Record(cell, [{"stats": s, "out_dir": "", "hets": 1}
                             for s in jobs])


@pytest.mark.parametrize("name,want", [
    ("variant_load_s", 0.75), ("window_build_s", 6.0),
    ("wfa_host_s", 9.0), ("wfa_wait_s", 4.5), ("assign_s", 4.5),
    ("prepare_cpu_s", 18.0), ("estimate_s", 12.0), ("beam_wait_s", 2.25),
    ("prepared_wait_s", 9.0)])
def test_span_metric_is_the_mean_over_jobs(name, want):
    # two jobs, the second twice the first; a job from a program without
    # spans is left out of the mean
    record = _record([{"spans": _spans(1.0)}, {"spans": _spans(2.0)},
                      {"stage_seconds": {"prepare": 1.0}}])
    assert run.load_metric(name)(record) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metric_reads_nothing_without_spans(name):
    """The parent's case: stage totals but no spans."""
    read = run.load_metric(name)
    assert read(_record([{"stage_seconds": {"prepare": 1.0}}] * 2)) is None
    assert read(_record([])) is None


def test_a_span_never_opened_counts_zero():
    """On the CPU the ladder takes no scratch lock: no such span."""
    spans = _spans(1.0)
    del spans["wfa.scratch_lock"]
    record = _record([{"spans": spans}])
    assert run.load_metric("wfa_wait_s")(record) == pytest.approx(2.0)
    assert run.load_metric("wfa_host_s")(record) == pytest.approx(7.0)


def test_every_span_metric_is_in_the_benchmark():
    entries = {m["name"]: m for m in run.load_benchmark()["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert (m["source"], m["unit"], m["better"], m["moves"]) == (
            "program_span", "s/job", "lower", "hets_per_s")
        assert m["workloads"] == ["dual-1mb-wfa-device"]
