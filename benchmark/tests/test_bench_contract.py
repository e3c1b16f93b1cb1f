"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds a
cell, a configuration, a traffic mix and a per-layer metric by name."""

import json
import os
import re
import shutil

import pytest

import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return run.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_entry_has_just_its_keys(bench):
    """Each entry carries exactly the contract's keys (a metric may add
    `workloads`), and every free text fits on one line of 200 characters."""
    assert all(set(c) == {"name", "source", "file", "reduced", "why"}
               for c in bench["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"}
               for w in bench["workloads"])
    e2e = {"name", "unit", "better", "bound", "source"}
    assert all(set(m) - {"workloads"} == e2e for m in bench["end_to_end"])
    layer = {"name", "unit", "better", "source", "layer", "moves"}
    assert all(set(m) - {"workloads"} == layer for m in bench["per_layer"])
    texts = ([c["source"] for c in bench["configs"]]
             + [x["why"] for x in bench["configs"] + bench["workloads"]]
             + [m["layer"] for m in bench["per_layer"]] + bench["command"])
    assert all(_one_line(t) for t in texts), texts
    assert all(c["source"].startswith("https://") for c in bench["configs"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_per_layer_metric_moves_a_metric_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert run._reports(e2e[m["moves"]], w)
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    layers = {}
    for m in bench["per_layer"]:
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = run.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert "job_mb" in cell.traffic
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                       "hets_per_s"}
        assert cell.per_layer


def test_added_files_are_found_by_name(tmp_path, bench):
    """A later PR adds a configuration, a traffic mix, a cell and a
    per-layer metric as new files and entries, and edits no file."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    config = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    config["name"] = "deep_local"
    config["shapes"]["coverage"] = 60
    (root / "benchmark/configs/deep_local.json").write_text(json.dumps(config))
    (root / "benchmark/traffic/wgs_8mb.json").write_text(json.dumps(
        {"job_mb": 8, "contigs": 2, "flags": {}, "sampled_blocks": 4}))
    (root / "benchmark/metrics/jobs_in_window.py").write_text(
        "def read(record):\n    return float(len(record.jobs))\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append({"name": "deep_local", "source": "x",
                         "file": "benchmark/configs/deep_local.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "deep-8mb", "config": "deep_local",
                           "traffic": "wgs_8mb", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "jobs_in_window", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "x", "moves": "hets_per_s",
                           "workloads": ["deep-8mb"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = run.find_cell(b, "deep-8mb", root=str(root))
    assert cell.config["shapes"]["coverage"] == 60
    assert cell.traffic["job_mb"] == 8
    assert [m["name"] for m in cell.per_layer] == ["jobs_in_window"]
    read = run.load_metric("jobs_in_window", root=str(root))
    assert read(run.Record(cell, [{}, {}])) == 2.0
