"""The frozen generator: the same seed gives the same bytes, and the same
records as the program's own generator (``hiphase_tpu_torch.utils.
simulate``; the BGZF blocks' compressed bytes may differ with the codec)."""

import gzip

from sim.simulate import build_benchmark_dataset


def _files(d):
    return {k: d[k] for k in ("fasta", "vcf", "bam")}


def test_same_seed_same_bytes(tmp_path):
    a = build_benchmark_dataset(str(tmp_path / "a"), total_mb=0.3,
                                n_contigs=1, seed=2**31 + 7, io_threads=3)
    b = build_benchmark_dataset(str(tmp_path / "b"), total_mb=0.3,
                                n_contigs=1, seed=2**31 + 7, io_threads=1)
    for k, path in _files(a).items():
        assert open(path, "rb").read() == open(_files(b)[k], "rb").read(), k
    for ext in (".tbi", ".bai"):
        src = a["vcf"] if ext == ".tbi" else a["bam"]
        dst = b["vcf"] if ext == ".tbi" else b["bam"]
        assert open(src + ext, "rb").read() == open(dst + ext, "rb").read()
    c = build_benchmark_dataset(str(tmp_path / "c"), total_mb=0.3,
                                n_contigs=1, seed=2**31 + 8)
    assert open(c["bam"], "rb").read() != open(a["bam"], "rb").read()


def test_equals_the_programs_generator_at_1mb(tmp_path):
    from hiphase_tpu_torch.utils.simulate import (
        build_benchmark_dataset as program_generator)
    ours = build_benchmark_dataset(str(tmp_path / "ours"), total_mb=1,
                                   n_contigs=1, seed=0)
    theirs = program_generator(str(tmp_path / "theirs"), total_mb=1,
                               n_contigs=1, seed=0)
    for k in ("n_het", "n_reads", "total_bp", "n_segments"):
        assert ours[k] == theirs[k]
    assert open(ours["fasta"], "rb").read() == open(theirs["fasta"],
                                                    "rb").read()
    for k in ("vcf", "bam"):
        assert gzip.open(ours[k]).read() == gzip.open(theirs[k]).read(), k


def _reads(bam):
    from reference.io.bam import BamReader
    with BamReader(bam) as r:
        return [(rec.pos, rec.flag, rec.read_name) for rec in r]


def test_stratified_keeps_the_work_and_the_bridges(tmp_path):
    """Every mix is generated stratified: two seeds give the same segment
    lengths and the same number of reads, and a 1 Mb contig of four
    segments keeps a read that bridges two of them (primary and
    supplementary), so supplemental joins are exercised."""
    runs = [build_benchmark_dataset(str(tmp_path / str(s)), total_mb=1,
                                    n_contigs=1, seed=s, stratified=True)
            for s in (2**31 + 1, 2**31 + 2)]
    assert [r["n_segments"] for r in runs] == [4, 4]
    assert runs[0]["n_reads"] == runs[1]["n_reads"]
    for r in runs:
        bridges = [n for _p, flag, n in _reads(r["bam"]) if flag & 0x800]
        assert len(bridges) == 1 and bridges[0].startswith("sa")
