"""The A* oracle's heuristic sweep in C++ (csrc/astar_sweep.cc) against
its Python body (`astar.python_astar_heuristic`), on the CPU.

The sweep gives the --stats-file's ``estimated_cost`` (H[0]) and the main
A* search's heuristic. The C++ twin must give the same H[0..nv] and bad
variants on every block, and fail exactly where one of the Python sweep's
assertions fails. Through `cli.main`, the statistics files of a job with
the sweep's library bound and of one without it must be equal byte for
byte, with ``estimate_sweeps`` counting each block on the path it took.
"""

import numpy as np
import pytest

from hiphase_tpu_torch import cli
from hiphase_tpu_torch.core.read_segments import ReadSegment
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.kernels import build
from hiphase_tpu_torch.phasing import astar

from tests.sim import build_dataset

# case: (variants, mean reads a column, min_queue_size, queue_increment,
# reads: see `_block`)
CASES = {
    **{f"nv{nv}-cov{cov}": (nv, cov, 1000, 3, "unset")
       for nv in (1, 2, 39, 40, 41) for cov in (5, 30, 60)},
    **{f"nv41-q{q}-{i}": (41, 30, q, i, "unset")
       for q, i in ((1000, 0), (100, 0), (100, 3), (10, 0), (10, 3))},
    "nv400-cov5-q100-3": (400, 5, 100, 3, "unset"),
    "nv400-cov30-q100-0": (400, 30, 100, 0, "unset"),
    "nv41-cov30-clean": (41, 30, 1000, 3, "clean"),
    "nv41-cov30-ignored-covered": (41, 30, 1000, 3, "ignored-covered"),
}


@pytest.fixture(scope="module")
def sweep_lib():
    """The port's own library, which holds the sweep, built here (skips
    without a C++ compiler)."""
    try:
        built = build.build_port_library()
    except build.KernelBuildError as e:
        if "no C++ compiler" in str(e):
            pytest.skip(str(e))
        raise
    return native.bind_port(built.library)


def _use_sweep(monkeypatch, lib):
    """Bind the sweep to ``lib`` (None: the Python sweep)."""
    native._load()
    monkeypatch.setattr(native, "_PORT", lib)


def _block(nv, cov, seed, reads):
    """Seeded random reads over ``nv`` variants: spans of 3-15 columns,
    alleles 0/1 with quals 1-59. Unless ``reads`` is "clean", a tenth of
    the variants is ignored; with "unset", every read is unset there and,
    inside the spans, has unset alleles (3) at qual 0 and ambiguous ones
    (2) with their qual; with "ignored-covered" the reads keep their
    alleles at the ignored variants, which the sweep must not charge."""
    rng = np.random.default_rng(seed)
    ignored = (rng.random(nv) < 0.1) if reads != "clean" and nv > 1 \
        else np.zeros(nv, dtype=bool)
    n_reads = max(1, round(cov * nv / min(nv, 9)))
    segments = []
    for r in range(n_reads):
        start = int(rng.integers(0, nv))
        end = min(nv, start + int(rng.integers(3, 16)))
        alleles = np.full(nv, 3, dtype=np.uint8)
        quals = np.zeros(nv, dtype=np.uint8)
        alleles[start:end] = rng.integers(0, 2, end - start)
        quals[start:end] = rng.integers(1, 60, end - start)
        if reads == "unset":
            inside = np.zeros(nv, dtype=bool)
            inside[start:end] = True
            unset = inside & (rng.random(nv) < 0.15)
            alleles[unset], quals[unset] = 3, 0
            alleles[inside & ~unset & (rng.random(nv) < 0.05)] = 2
            alleles[ignored], quals[ignored] = 3, 0
        segments.append(ReadSegment.new(f"read{r}", alleles, quals))
    return segments, [bool(x) for x in ignored]


@pytest.mark.parametrize("case", list(CASES))
def test_native_sweep_equals_the_python_sweep(sweep_lib, monkeypatch, case):
    nv, cov, min_queue, increment, kind = CASES[case]
    segments, ignored = _block(nv, cov, 1000 * nv + cov + min_queue
                               + increment, kind)
    reads = astar._BlockReads(segments, nv)
    try:
        want = astar.python_astar_heuristic(
            nv, astar.MAX_SEGMENT_SIZE, reads, min_queue, increment, ignored)
    except AssertionError:
        want = None  # the budget is too small to reach two columns
    if min_queue >= 100:
        assert want is not None
    _use_sweep(monkeypatch, sweep_lib)
    got = astar._native_astar_heuristic(
        nv, astar.MAX_SEGMENT_SIZE, segments, min_queue, increment, ignored)
    assert got == want
    # the dense view is left unbuilt by the native path
    assert "overlapping" not in vars(astar._BlockReads(segments, nv))
    astar.take_sweep_counts()
    if want is None:
        with pytest.raises(AssertionError):
            astar.calculate_astar_heuristic(
                nv, astar.MAX_SEGMENT_SIZE, reads, min_queue, increment,
                ignored)
        assert astar.take_sweep_counts() == {"native": 0, "python": 1}
    else:
        assert astar.calculate_astar_heuristic(
            nv, astar.MAX_SEGMENT_SIZE, reads, min_queue, increment,
            ignored) == want
        assert astar.take_sweep_counts() == {"native": 1, "python": 0}


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    return build_dataset(tmp_path_factory.mktemp("sweep"), seed=43,
                         n_contigs=2, contig_len=6000, coverage=15)[:3]


def _job(sim, out, extra):
    fasta, vcf, bam = sim
    out.mkdir()
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(out / "out.vcf.gz"),
                     "--engine", "native", "--threads", "2"] + extra) == 0
    return dict(cli.LAST_RUN_STATS)


@pytest.mark.parametrize("mode", ["dual", "local"])
def test_stats_file_equal_with_and_without_the_sweep_library(
        sweep_lib, sim, tmp_path, monkeypatch, mode):
    extra = [] if mode == "dual" else ["--disable-global-realignment"]
    runs = {}
    for bound in (True, False):
        _use_sweep(monkeypatch, sweep_lib if bound else None)
        out = tmp_path / f"{mode}-{bound}"
        stats = _job(sim, out, extra + ["--stats-file", str(out / "s.csv")])
        runs[bound] = (stats, (out / "s.csv").read_bytes())
    rows = len(runs[True][1].splitlines()) - 1
    assert rows > 0
    assert runs[True][1] == runs[False][1]
    assert runs[True][0]["estimate_sweeps"] == {"native": rows, "python": 0}
    assert runs[False][0]["estimate_sweeps"] == {"native": 0, "python": rows}
    # without --stats-file the sweep does not run
    _use_sweep(monkeypatch, sweep_lib)
    stats = _job(sim, tmp_path / f"{mode}-nostats", extra)
    assert stats["estimate_sweeps"] == {"native": 0, "python": 0}
