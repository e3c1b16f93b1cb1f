"""``--engine auto`` switching from the native beam to the device engine
mid-run changes no output.

On a small simulated dataset, with every output the CLI writes (phased
VCF, haplotagged BAM, the statistics, haplotag, blocks and summary files),
``cli.main([... "--engine", "auto"], device=torch.device("cpu"))`` runs
with a background choice that ends with a ``cuda`` verdict after k blocks
went to native (k = 0, 2 and all but the last block). Every output must
equal the port's ``--engine native`` and ``--engine cuda`` runs and the
JAX package's ``--engine native`` run, byte for byte: the VCF and BAM
decompressed, less the command line in their headers, which names the
engine and the output paths. The statistics and haplotag files are
written in the order results arrive, the VCF and BAM in block order.

Two gloo ranks of ``auto`` (choosing between engines before any work,
as a multi-host run must) give rank-0 outputs equal to one process.
"""

import gzip
import json
import re
import time

import pytest
import torch

from hiphase_tpu.cli import main as jax_main
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.parallel import engine_select as es

from tests.sim import build_dataset
from tests.test_torch_multihost import run_cli_ranks
from tests.test_torch_sharding import assert_same_outputs

CPU = torch.device("cpu")
FILES = ("vcf.gz", "bam", "stats.csv", "tags.tsv", "blocks.tsv",
         "summary.tsv")
RATES = {"cuda": 1e9, "native": 1.0}


def _argv(data, out_dir, engine, extra=()):
    fasta, vcf, bam = data
    out = {k: str(out_dir / f"out.{k}") for k in FILES}
    return out, ["--bam", bam, "--output-bam", out["bam"], "--vcf", vcf,
                 "--output-vcf", out["vcf.gz"], "--reference", fasta,
                 "--stats-file", out["stats.csv"],
                 "--haplotag-file", out["tags.tsv"],
                 "--blocks-file", out["blocks.tsv"],
                 "--summary-file", out["summary.tsv"],
                 "--engine", engine, "--batch-size", "4", "--threads", "2",
                 "--disable-global-realignment", *extra]


def _content(path: str) -> bytes:
    """The file's bytes; a VCF or BAM decompressed, less the command
    line."""
    if path.endswith(".vcf.gz"):
        text = gzip.open(path).read()
        return re.sub(rb'##hiphase_tpu_command="[^\n]*"\n', b"", text)
    if path.endswith(".bam"):
        raw = gzip.open(path).read()
        n = int.from_bytes(raw[4:8], "little")
        header = re.sub(rb"\tCL:[^\t\n]*", b"", raw[8:8 + n])
        return header + raw[8 + n:]
    with open(path, "rb") as fh:
        return fh.read()


def _contents(out: dict) -> dict:
    return {k: _content(out[k]) for k in FILES}


class _ChoiceAfter:
    """Stands in for `engine_select.BackgroundChoice`: ends with a
    ``cuda`` verdict after ``k`` calls of done() (one a submit)."""

    k = 0

    def __init__(self, devices, threads, rate_cache, **solver_kw):
        assert devices == (CPU,) and rate_cache is None
        self.calls = 0
        self.started = time.perf_counter()
        self.ended_at = None

    def done(self):
        self.calls += 1
        if self.calls > self.k and self.ended_at is None:
            self.ended_at = time.perf_counter()
        return self.ended_at is not None

    def result(self):
        if self.ended_at is None:
            return None
        return es.EngineChoice("cuda", dict(RATES), 0.0, 0.0, False)

    def stop(self):
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dataset, and the outputs of the port's native and cuda runs and
    of the JAX package's native run."""
    base = tmp_path_factory.mktemp("upgrade")
    fasta, vcf, bam, _c, _ = build_dataset(base, seed=31, n_contigs=8,
                                           contig_len=6000, coverage=15)
    data = (fasta, vcf, bam)
    out = {}
    for engine in ("native", "cuda"):
        (base / engine).mkdir()
        paths, argv = _argv(data, base / engine, engine)
        assert cli.main(argv, device=CPU, rate_cache=None) == 0
        out[engine] = _contents(paths)
        solved = cli.LAST_RUN_STATS["engine_blocks"][engine]
    (base / "jax").mkdir()
    paths, argv = _argv(data, base / "jax", "native")
    assert jax_main(argv) == 0
    out["jax"] = _contents(paths)
    return base, data, out, solved


def test_native_cuda_and_jax_agree(runs):
    _base, _data, out, solved = runs
    assert solved >= 6
    assert out["native"] == out["cuda"] == out["jax"]
    assert all(len(v) > 0 for v in out["native"].values())


@pytest.mark.parametrize("k", ["0", "2", "last"])
def test_a_switch_after_k_blocks_changes_no_byte(runs, monkeypatch, k):
    base, data, out, solved = runs
    k = solved - 1 if k == "last" else int(k)
    monkeypatch.setattr(_ChoiceAfter, "k", k)
    monkeypatch.setattr(es, "BackgroundChoice", _ChoiceAfter)
    (base / f"auto{k}").mkdir()
    paths, argv = _argv(data, base / f"auto{k}", "auto")
    assert cli.main(argv, device=CPU, rate_cache=None) == 0
    stats = cli.LAST_RUN_STATS
    assert stats["engine"] == "cuda"
    assert stats["engine_blocks"] == {"native": k, "cuda": solved - k}
    assert stats["engine_upgrade"]["native_blocks_before"] == k
    assert stats["engine_upgrade"]["seconds"] >= 0
    assert stats["engine_rates"] == RATES
    assert stats["engine_rating"]["resolved"] is True
    assert stats["engine_rating"]["late_blocks"] == 0
    # both solvers' counters: native's only when it solved a block
    assert ("node_expansions" in stats) == (k > 0)
    assert stats["device_batches"] >= 1
    got = _contents(paths)
    for name in FILES:
        assert got[name] == out["native"][name], name
    assert got == out["cuda"] == out["jax"]


def test_the_beam_engines_report_the_same_block_statistics(runs):
    """A switched run's statistics file equals both pure runs' only if the
    two engines report the same pruned_solutions (and every other column)
    for the same block."""
    _base, _data, out, _solved = runs
    rows = {e: [r.split(",") for r in out[e]["stats.csv"].decode()
                .splitlines()] for e in ("native", "cuda")}
    header = rows["native"][0]
    by_block = {e: {r[0]: dict(zip(header, r)) for r in rows[e][1:]}
                for e in rows}
    assert by_block["native"].keys() == by_block["cuda"].keys()
    for block, row in by_block["native"].items():
        for column, value in row.items():
            assert by_block["cuda"][block][column] == value, (block, column)
    assert any(r["pruned_solutions"] not in ("", None)
               for r in by_block["native"].values())


def test_auto_on_two_ranks_chooses_before_any_work(runs, tmp_path):
    """Multi-host: each rank waits for the choice (its cache spares the
    other rank the rating), every block of each rank goes to the chosen
    engine, and rank 0 writes what one process writes."""
    _base, data, _out, _solved = runs
    single = {k: str(tmp_path / f"single.{k}") for k in FILES}
    fasta, vcf, bam = data
    assert cli.main(["--bam", bam, "--output-bam", single["bam"],
                     "--vcf", vcf, "--output-vcf", single["vcf.gz"],
                     "--reference", fasta,
                     "--stats-file", single["stats.csv"],
                     "--haplotag-file", single["tags.tsv"],
                     "--blocks-file", single["blocks.tsv"],
                     "--summary-file", single["summary.tsv"],
                     "--engine", "native", "--threads", "2",
                     "--beam-width", "64", "--batch-size", "4",
                     "--disable-global-realignment"], device=CPU,
                    rate_cache=None) == 0
    cache = tmp_path / "rates.json"
    setup = f"""
        from hiphase_tpu_torch.parallel import engine_select
        engine_select.measure_rates = (
            lambda *a, **kw: {{"cuda": 1e9, "native": 1.0}})
        main_kw = {{"rate_cache": {str(cache)!r}}}
        """
    multi, stats, foreign = run_cli_ranks(tmp_path, data, 2, "auto",
                                          setup=setup)
    assert foreign == [[], []]
    for s in stats:
        assert s["engine"] == "cuda" and s["engine_upgrade"] is None
        assert s["engine_blocks"]["cuda"] > 0
        assert set(s["engine_blocks"]) == {"cuda"}
        assert "in_background" not in s["engine_rating"]
        assert "node_expansions" not in s
    assert json.loads(cache.read_text())["entries"][0]["rates"] == RATES
    assert_same_outputs(single, {k: multi[k] for k in FILES})
