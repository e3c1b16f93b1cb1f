"""The port's --engine cuda statistics files against the JAX package's
--engine tpu and the port's --engine astar, on the CPU: the analog of
tests/test_stats_parity.py for the four statistics files and the haplotag
file.

Rows of --stats-file and --haplotag-file are compared sorted, since they
are written in arrival order. The blocks, summary and haplotag files must
equal the host A* oracle's byte for byte, and so must every column of the
--stats-file but pruned_solutions, which counts different things on the
two solvers. Against the JAX device engine every file is equal, on the
data of tests/test_stats_parity.py, whose reads carry no unset alleles.

The second dataset has sequencing errors, so its reads carry ambiguous
alleles with quals, which the A* oracle charges against both haplotypes
and the beam does not score: the cuda engine reports the oracle's cost
(`phaser.unset_allele_cost`). The JAX package's --engine tpu reports the
beam's cost and stops at the stats writer's assertion on this data
(estimated cost above an actual cost of 0), so there the port is held to
the oracle of both packages, the JAX --engine astar and its own. A fast
width below the full width makes blocks that are not provably optimal
re-solve at the full width and report from there.

The cuda engine runs its kernels' plain PyTorch versions here because the
tests pass ``device=torch.device("cpu")``.
"""

import pytest
import torch

from hiphase_tpu.cli import main as jax_cli_main
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.utils.simulate import build_benchmark_dataset

from tests.sim import build_dataset

torch.set_num_threads(2)
CPU = torch.device("cpu")

FILES = ("stats.csv", "haplotag.tsv", "summary.tsv", "blocks.tsv")
FLAGS = {"stats.csv": "--stats-file", "haplotag.tsv": "--haplotag-file",
         "summary.tsv": "--summary-file", "blocks.tsv": "--blocks-file"}
SORTED = ("stats.csv", "haplotag.tsv")
# the --stats-file's columns, split where a cell holds a list
STATS_HEAD = 9    # block_index .. num_alleles
STATS_TAIL = 7    # pruned_solutions .. skipped_variants

CASES = {  # case: (dataset, extra flags, the JAX engine compared with)
    "default": ("sim", [], "tpu"),
    "q200": ("sim", ["--phase-min-queue-size", "200",
                     "--phase-queue-increment", "7"], "tpu"),
    "errors": ("errors", ["--disable-global-realignment"], "astar"),
    "errors-fast64": ("errors", ["--disable-global-realignment",
                                 "--beam-width", "64"], "astar"),
}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    sim = build_dataset(tmp_path_factory.mktemp("sim"), seed=41, n_contigs=3,
                        contig_len=6000, coverage=15)[:3]
    d = tmp_path_factory.mktemp("errors")
    meta = build_benchmark_dataset(str(d), total_mb=1,
                                   n_contigs=8, coverage=10,
                                   read_length=6000, seed=7, block_kb=40,
                                   io_threads=1)
    return {"sim": sim, "errors": (meta["fasta"], meta["vcf"], meta["bam"])}


def _run(main, dataset, out_dir, name, extra, **kw):
    fasta, vcf, bam = dataset
    paths = {k: out_dir / f"{name}.{k}" for k in FILES}
    argv = ["--bam", bam, "--vcf", vcf, "--reference", fasta,
            "--output-vcf", str(out_dir / f"{name}.vcf.gz")]
    for k, p in paths.items():
        argv += [FLAGS[k], str(p)]
    assert main(argv + extra, **kw) == 0
    out = {}
    for k, p in paths.items():
        lines = p.read_text().splitlines()
        assert len(lines) > 1, k
        out[k] = [lines[0]] + sorted(lines[1:]) if k in SORTED else lines
    return out


def _without_pruned(stats_lines):
    """--stats-file rows without the pruned_solutions column."""
    rows = []
    for line in stats_lines:
        cells = line.split(",")
        rows.append(cells[:-STATS_TAIL] + cells[-STATS_TAIL + 1:])
    return rows


@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_engine_statistics_match_jax_tpu_and_astar(datasets, tmp_path,
                                                        case):
    name, extra, jax_engine = CASES[case]
    data = datasets[name]
    port = _run(cli.main, data, tmp_path, "cuda",
                ["--engine", "cuda", "--batch-size", "4"] + extra,
                device=CPU)
    solved = dict(cli.LAST_RUN_STATS)
    assert solved["engine"] == "cuda"
    assert port["stats.csv"][0].split(",")[-STATS_TAIL] == "pruned_solutions"
    oracles = {"port --engine astar": _run(cli.main, data, tmp_path, "astar",
                                           ["--engine", "astar"] + extra)}
    if jax_engine == "tpu":
        jax_tpu = _run(jax_cli_main, data, tmp_path, "tpu",
                       ["--engine", "tpu", "--batch-size", "4"] + extra)
        for k in FILES:
            assert port[k] == jax_tpu[k], f"{k} differs from JAX --engine tpu"
    else:
        oracles["JAX --engine astar"] = _run(
            jax_cli_main, data, tmp_path, "jax_astar",
            ["--engine", "astar"] + extra)
    for oracle, want in oracles.items():
        for k in FILES:
            if k != "stats.csv":
                assert port[k] == want[k], f"{k} differs from {oracle}"
        assert _without_pruned(port["stats.csv"]) == _without_pruned(
            want["stats.csv"]), f"stats.csv differs from {oracle}"
    if case == "errors":
        # the data reaches the unset alleles: the JAX engine stops on it
        with pytest.raises(AssertionError):
            _run(jax_cli_main, data, tmp_path, "tpu",
                 ["--engine", "tpu", "--batch-size", "4"] + extra)
    if case == "errors-fast64":
        # the escalated blocks made batches of their own
        assert solved["device_batches"] > -(-solved["blocks"] // 4)
