"""The torch port's CLI end to end on the CPU: the golden dataset, the
orchestrator scenarios of test_orchestrator.py against the JAX package's
--engine tpu and the host A* oracle, and the engine/device rules (no
hidden fallback).

The cuda engine runs its kernels' plain PyTorch versions here because the
tests pass ``device=torch.device("cpu")`` explicitly.

Run as a command (``python -m hiphase_tpu_torch`` or ``-m
hiphase_tpu_torch.cli``), an error ends in one logged line and exit
status 1, with no traceback; `cli.main` raises it.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from hiphase_tpu.cli import main as jax_cli_main
from hiphase_tpu.io.bam import BamReader
from hiphase_tpu.io.vcf import VcfReader
from hiphase_tpu.utils.simulate import build_benchmark_dataset
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.device import DeviceUnavailableError

from tests.sim import build_dataset
from tests.test_e2e_golden import DATASET_KW, GOLDEN, _digest, _normalize

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _outputs(tmp_path, name):
    return {"vcf": str(tmp_path / f"{name}.vcf.gz"),
            "bam": str(tmp_path / f"{name}.bam"),
            "blocks": str(tmp_path / f"{name}.blocks.tsv")}


def _argv(fasta, vcf, bam, out, extra):
    return ["--bam", bam, "--output-bam", out["bam"], "--vcf", vcf,
            "--output-vcf", out["vcf"], "--reference", fasta,
            "--blocks-file", out["blocks"],
            "--disable-global-realignment"] + extra


def _records(out):
    vcf = [r.serialize() for r in VcfReader(out["vcf"])]
    with BamReader(out["bam"]) as rd:
        bam = [(r.read_name, r.pos, r.get_tag("HP"), r.get_tag("PS"))
               for r in rd]
    with open(out["blocks"]) as fh:
        return vcf, bam, fh.read()


def test_golden_outputs_cuda_engine_plain_on_cpu(tmp_path):
    meta = build_benchmark_dataset(str(tmp_path / "ds"), **DATASET_KW)
    out = [str(tmp_path / f"golden.{x}") for x in ("vcf.gz", "bam", "tsv")]
    assert cli.main(["--bam", meta["bam"], "--vcf", meta["vcf"],
                     "--reference", meta["fasta"], "--output-vcf", out[0],
                     "--output-bam", out[1], "--blocks-file", out[2],
                     "--engine", "cuda", "--batch-size", "8"],
                    device=CPU) == 0
    assert _digest(_normalize(*out)) == json.loads(GOLDEN.read_text())["sha256"]
    stats = cli.LAST_RUN_STATS
    assert stats["engine"] == "cuda" and stats["device"] == "cpu"
    assert stats["transfers_per_batch"] == 2.0
    # the plain versions ran: no kernel was launched
    assert stats["kernel_launches"] == {"beam_select": 0,
                                        "permute_update": 0, "backtrace": 0,
                                        "wfa_forward_backward": 0}


@pytest.mark.parametrize("scenario", ["threaded", "drain_partial"])
def test_orchestrator_scenarios_match_jax_and_astar(tmp_path, scenario):
    """test_orchestrator.py's scenarios: the port's cuda engine (plain
    versions on the CPU) is byte-identical to the JAX package's --engine
    tpu and to the host A* oracle."""
    if scenario == "threaded":
        kw = dict(seed=21, n_contigs=6, contig_len=6000, coverage=15)
        flags = ["--beam-width", "64", "--batch-size", "4", "--threads", "3"]
    else:
        kw = dict(seed=22, n_contigs=1, contig_len=6000)
        flags = ["--beam-width", "64", "--batch-size", "64"]
    fasta, vcf, bam, _contigs, _ = build_dataset(tmp_path, **kw)

    port = _outputs(tmp_path, "port")
    assert cli.main(_argv(fasta, vcf, bam, port,
                          ["--engine", "cuda"] + flags), device=CPU) == 0
    assert cli.LAST_RUN_STATS["device_batches"] >= 1
    jax_tpu = _outputs(tmp_path, "jax")
    assert jax_cli_main(_argv(fasta, vcf, bam, jax_tpu,
                              ["--engine", "tpu"] + flags)) == 0
    astar = _outputs(tmp_path, "astar")
    assert cli.main(_argv(fasta, vcf, bam, astar, ["--engine", "astar"])) == 0

    got = _records(port)
    assert got == _records(jax_tpu)
    assert got == _records(astar)


def test_engines_agree_and_report_themselves(tmp_path):
    """native (or its A* fallback) and astar through the port's CLI agree
    with the cuda engine; LAST_RUN_STATS names the engine that ran, and is
    reset between runs in one process."""
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=24, n_contigs=1, contig_len=5000)
    results = {}
    for engine in ("cuda", "native", "astar"):
        out = _outputs(tmp_path, engine)
        assert cli.main(_argv(fasta, vcf, bam, out,
                              ["--engine", engine, "--beam-width", "64"]),
                        device=CPU) == 0
        assert cli.LAST_RUN_STATS["engine"] == engine
        assert ("device_batches" in cli.LAST_RUN_STATS) == (engine == "cuda")
        results[engine] = _records(out)
    assert results["cuda"] == results["native"] == results["astar"]


def test_cuda_engine_without_a_cuda_device_raises(tmp_path, monkeypatch):
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=25, n_contigs=1, contig_len=3000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="CUDA device"):
        cli.main(_argv(fasta, vcf, bam, _outputs(tmp_path, "x"),
                       ["--engine", "cuda"]))


def test_device_error_ends_the_run(tmp_path, monkeypatch):
    """No host fallback around the device engine: a failing device solve
    is raised out of main, not re-solved on another engine."""
    from hiphase_tpu_torch.kernels import KernelLaunchError
    from hiphase_tpu_torch.parallel import sharding

    def fail(*_args, **_kw):
        raise KernelLaunchError("beam_select: CUDA error 700")

    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=28, n_contigs=1, contig_len=3000)
    monkeypatch.setattr(sharding, "tiles_forward_packed", fail)
    with pytest.raises(KernelLaunchError, match="CUDA error 700"):
        cli.main(_argv(fasta, vcf, bam, _outputs(tmp_path, "x"),
                       ["--engine", "cuda"]), device=CPU)


def test_auto_without_cuda_resolves_to_a_host_engine(tmp_path, monkeypatch):
    """No CUDA device and none given: choose_engine gets no devices and
    rates nothing."""
    from hiphase_tpu_torch.io import native
    from hiphase_tpu_torch.parallel import engine_select
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=26, n_contigs=1, contig_len=3000)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    choose = engine_select.choose_engine

    def spy(requested, devices=None, threads=1, **solver_kw):
        calls.append((requested, devices, threads, solver_kw))
        return choose(requested, devices, threads, **solver_kw)

    def rated(*_a, **_kw):
        raise AssertionError("rated without a device")
    monkeypatch.setattr(cli, "choose_engine", spy)
    monkeypatch.setattr(engine_select, "measure_rates", rated)
    cache = tmp_path / "rates.json"
    assert cli.main(_argv(fasta, vcf, bam, _outputs(tmp_path, "auto"),
                          ["--threads", "2"]), rate_cache=cache) == 0
    want = "native" if native.available() else "astar"
    assert cli.LAST_RUN_STATS["engine"] == want
    assert cli.LAST_RUN_STATS["engine_rates"] == {}
    assert cli.LAST_RUN_STATS["engine_upgrade"] is None
    assert cli.LAST_RUN_STATS["engine_blocks"][want] > 0
    assert "engine_rating" not in cli.LAST_RUN_STATS
    assert calls == [("auto", None, 2, dict(
        rate_cache=cache, beam_width=None, batch_size=64,
        min_queue_size=1000, queue_increment=3))]
    assert not cache.exists()


def test_engine_flag_surface():
    parser = cli.build_parser()
    engine = next(a for a in parser._actions if a.dest == "engine")
    assert tuple(engine.choices) == ("auto", "cuda", "native", "astar")
    with pytest.raises(SystemExit):
        parser.parse_args(["--bam", "b", "--vcf", "v", "--output-vcf", "o",
                           "-r", "r", "--engine", "tpu"])


REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("module", ["hiphase_tpu_torch",
                                    "hiphase_tpu_torch.cli"])
@pytest.mark.parametrize("fault", ["missing_reference", "corrupt_bam"])
def test_the_command_exits_1_on_error_without_a_traceback(tmp_path, module,
                                                          fault):
    from hiphase_tpu_torch.io.bgzf import BgzfError
    fasta, vcf, bam, _contigs, _ = build_dataset(
        tmp_path, seed=29, n_contigs=1, contig_len=3000)
    if fault == "missing_reference":
        fasta = str(tmp_path / "missing.fa")
    else:
        with open(bam, "wb") as fh:
            fh.write(b"\x1f\x8b" + b"x" * 300)
    argv = ["--bam", bam, "--vcf", vcf, "--reference", fasta,
            "--output-vcf", str(tmp_path / "out.vcf.gz"),
            "--engine", "native"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, env=env,
                          cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 1, proc.stderr[-3000:]
    assert "Traceback" not in proc.stderr
    if fault == "missing_reference":
        assert f"File does not exist: {fasta}" in proc.stderr
    else:
        errors = [ln for ln in proc.stderr.splitlines() if " ERROR " in ln]
        assert len(errors) == 1 and "BgzfError" in errors[0], proc.stderr
    # a library caller gets the error itself
    with pytest.raises(SystemExit if fault == "missing_reference"
                       else BgzfError):
        cli.main(argv)
