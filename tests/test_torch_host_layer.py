"""The port's copy of the host layer against the JAX package's original.

hiphase_tpu_torch keeps its own copies of the JAX-free host modules (I/O,
variants and reads, block generation, allele assignment, A*, the writers,
the simulator, the CLI's flag surface), verbatim except for import paths.
Each case below feeds both copies the same inputs, made from a seed, and
requires equal results: records, bytes and integers, with no tolerance.
"""

import argparse
import dataclasses
import gzip
import importlib
import pathlib
import time

import numpy as np
import pytest

import hiphase_tpu
import hiphase_tpu_torch
from hiphase_tpu import cli as ref_cli
from hiphase_tpu.align import wfa_graph as ref_wfa
from hiphase_tpu.core import read_segments as ref_rs
from hiphase_tpu.core import reference_genome as ref_genome
from hiphase_tpu.core import variants as ref_var
from hiphase_tpu.io import bam as ref_bam
from hiphase_tpu.io import bcf as ref_bcf
from hiphase_tpu.io import cram as ref_cram
from hiphase_tpu.io import vcf as ref_vcf
from hiphase_tpu.phasing import astar as ref_astar
from hiphase_tpu.phasing import block_gen as ref_block_gen
from hiphase_tpu.utils import simulate as ref_sim
from hiphase_tpu_torch import cli as port_cli
from hiphase_tpu_torch.align import wfa_graph as port_wfa
from hiphase_tpu_torch.core import read_segments as port_rs
from hiphase_tpu_torch.core import reference_genome as port_genome
from hiphase_tpu_torch.core import variants as port_var
from hiphase_tpu_torch.io import bam as port_bam
from hiphase_tpu_torch.io import bcf as port_bcf
from hiphase_tpu_torch.io import cram as port_cram
from hiphase_tpu_torch.io import vcf as port_vcf
from hiphase_tpu_torch.phasing import astar as port_astar
from hiphase_tpu_torch.phasing import block_gen as port_block_gen
from hiphase_tpu_torch.utils import simulate as port_sim

from tests.sim import build_dataset

# the align packages re-export the function under the module's name
ref_ed = importlib.import_module("hiphase_tpu.align.edit_distance")
port_ed = importlib.import_module("hiphase_tpu_torch.align.edit_distance")

SIM_KW = dict(total_mb=1, n_contigs=2, coverage=6, read_length=6000, seed=5,
              block_kb=100, io_threads=1)
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """The benchmark simulator's dataset, built by each package."""
    d = tmp_path_factory.mktemp("host_layer")
    return {"ref": ref_sim.build_benchmark_dataset(str(d / "ref"), **SIM_KW),
            "port": port_sim.build_benchmark_dataset(str(d / "port"),
                                                     **SIM_KW)}


def check_simulator(sim, tmp_path, monkeypatch):
    ref, port = sim["ref"], sim["port"]
    assert {k: v for k, v in ref.items() if k not in ("fasta", "vcf", "bam")} \
        == {k: v for k, v in port.items() if k not in ("fasta", "vcf", "bam")}
    for key, suffixes in (("fasta", ("",)), ("vcf", ("", ".tbi")),
                          ("bam", ("", ".bai"))):
        for sfx in suffixes:
            a = pathlib.Path(ref[key] + sfx).read_bytes()
            b = pathlib.Path(port[key] + sfx).read_bytes()
            assert a == b, key + sfx


def _vcf_records(mod, path):
    rd = mod.VcfReader(path)
    return rd.samples, [tuple(r.fields) for r in rd]


def check_vcf_reader(sim, tmp_path, monkeypatch):
    path = sim["ref"]["vcf"]
    assert _vcf_records(ref_vcf, path) == _vcf_records(port_vcf, path)
    assert ref_vcf.get_vcf_samples(path) == port_vcf.get_vcf_samples(path)
    for chrom, start, end in (("chr1", 0, 200_000), ("chr2", 123_456,
                                                     400_000)):
        a = [tuple(r.fields) for r in ref_vcf.VcfReader(path).fetch(
            chrom, start, end)]
        b = [tuple(r.fields) for r in port_vcf.VcfReader(path).fetch(
            chrom, start, end)]
        assert a == b and a


def check_bcf_reader(sim, tmp_path, monkeypatch):
    raw = gzip.open(sim["ref"]["vcf"]).read()
    lines = [x for x in raw.split(b"\n") if x]
    header = [x for x in lines if x.startswith(b"#")]
    paths = {}
    for name, mod in (("ref", ref_bcf), ("port", port_bcf)):
        paths[name] = str(tmp_path / f"{name}.bcf")
        w = mod.BcfWriter(paths[name], header)
        for x in lines:
            if not x.startswith(b"#"):
                w.write_line(x)
        w.close()
        w.write_index()
    for sfx in ("", ".csi"):
        assert (pathlib.Path(paths["ref"] + sfx).read_bytes()
                == pathlib.Path(paths["port"] + sfx).read_bytes())
    a = list(ref_bcf.BcfReader(paths["ref"]))
    b = list(port_bcf.BcfReader(paths["ref"]))
    assert a == b and len(a) > 100
    assert (_vcf_records(ref_vcf, paths["ref"])
            == _vcf_records(port_vcf, paths["ref"]))


def _bam_records(mod, path, region=None):
    with mod.BamReader(path) as rd:
        recs = rd if region is None else rd.fetch(*region)
        return [r.raw for r in recs]


def check_bam_reader(sim, tmp_path, monkeypatch):
    path = sim["ref"]["bam"]
    assert _bam_records(ref_bam, path) == _bam_records(port_bam, path)
    for region in (("chr1", 0, 50_000), ("chr2", 200_000, 260_000)):
        a = _bam_records(ref_bam, path, region)
        assert a and a == _bam_records(port_bam, path, region)


def _cram_fields(rec):
    return (rec.read_name, rec.refid, rec.pos, rec.mapq, rec.flag,
            tuple(rec.cigar()), rec.query_sequence(), rec.query_qualities(),
            tuple((t, tc, v if not isinstance(v, list) else tuple(v))
                  for t, tc, _s, _e, v in rec._iter_aux()))


def check_cram(sim, tmp_path, monkeypatch):
    """Each package's CRAM writer (the three codecs) on the same records,
    read back by both CRAM readers. The gzip members of a CRAM carry the
    time they were written: the clock is held still while they are."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    fasta = sim["ref"]["fasta"]
    for codec in ("gzip", "rans", "ransNx16"):
        paths = {}
        for name, bam, cram, genome in (
                ("ref", ref_bam, ref_cram, ref_genome),
                ("port", port_bam, port_cram, port_genome)):
            ref = genome.ReferenceGenome.from_fasta(fasta)
            # the header's file id is the path's last 20 bytes: the same
            d = tmp_path / name / "cram_files_of_one_copy"
            d.mkdir(parents=True, exist_ok=True)
            paths[name] = str(d / f"{codec}.cram")
            with bam.BamReader(sim["ref"]["bam"]) as rd:
                w = cram.CramWriter(paths[name], rd.header, ref, codec=codec)
                for i, rec in enumerate(rd):
                    if i >= 400:
                        break
                    w.write(rec)
                w.close()
                w.write_index()
        for sfx in ("", ".crai"):
            assert (pathlib.Path(paths["ref"] + sfx).read_bytes()
                    == pathlib.Path(paths["port"] + sfx).read_bytes()), codec
        got = []
        for cram, genome in ((ref_cram, ref_genome), (port_cram, port_genome)):
            ref = genome.ReferenceGenome.from_fasta(fasta)
            with cram.CramReader(paths["ref"], ref) as cr:
                got.append([_cram_fields(r) for r in cr])
        assert got[0] == got[1] and len(got[0]) == 400


def _blocks(mod, meta):
    it = mod.PhaseBlockIterator([meta["vcf"]], [meta["bam"]], "SAMPLE",
                                min_quality=0, min_mapq=5,
                                min_spanning_reads=1,
                                allow_supplemental_joins=True)
    return [dataclasses.astuple(b) for b in it]


def check_block_gen(sim, tmp_path, monkeypatch):
    a = _blocks(ref_block_gen, sim["ref"])
    assert len(a) > 5 and a == _blocks(port_block_gen, sim["ref"])


def check_writers(sim, tmp_path, monkeypatch):
    """Both CLIs in dual mode on the host engines, every output file: the
    VCF, BAM, block, haplotag, stats and summary writers see the same
    records and must write the same bytes. Header lines that name the
    program and its command line differ by design and are left out."""
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=61, n_contigs=2,
                                           contig_len=5000, coverage=10)
    outs = {}
    for name, main in (("ref", ref_cli.main), ("port", port_cli.main)):
        o = {k: str(tmp_path / f"{name}.{k}") for k in (
            "vcf.gz", "bam", "blocks.tsv", "haplotag.tsv", "stats.tsv",
            "summary.tsv")}
        assert main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", o["vcf.gz"], "--output-bam", o["bam"],
                     "--blocks-file", o["blocks.tsv"],
                     "--haplotag-file", o["haplotag.tsv"],
                     "--stats-file", o["stats.tsv"],
                     "--summary-file", o["summary.tsv"],
                     "--engine", "astar"]) == 0
        outs[name] = o
    for key in ("blocks.tsv", "haplotag.tsv", "stats.tsv", "summary.tsv"):
        a = pathlib.Path(outs["ref"][key]).read_bytes()
        assert a and a == pathlib.Path(outs["port"][key]).read_bytes(), key

    def vcf_text(path):
        return [x for x in gzip.open(path).read().split(b"\n")
                if not x.startswith(b"##hiphase")]

    a = vcf_text(outs["ref"]["vcf.gz"])
    assert len(a) > 20 and a == vcf_text(outs["port"]["vcf.gz"])
    a = _bam_records(ref_bam, outs["ref"]["bam"])
    assert a and a == _bam_records(port_bam, outs["port"]["bam"])
    with ref_bam.BamReader(outs["ref"]["bam"]) as ra, \
            port_bam.BamReader(outs["port"]["bam"]) as rb:
        strip = [x for x in ra.header.text.splitlines()
                 if not x.startswith("@PG")]
        assert strip == [x for x in rb.header.text.splitlines()
                         if not x.startswith("@PG")]


def _astar_inputs(mod_var, mod_rs, seed, nv=14, nr=24):
    rng = np.random.default_rng(seed)
    h1 = rng.integers(0, 2, size=nv)
    variants = [mod_var.Variant.new_snv(0, 10 * (j + 1), b"A", b"C", 0, 1)
                for j in range(nv)]
    reads = []
    for i in range(nr):
        hap = h1 if rng.random() < 0.5 else 1 - h1
        start = int(rng.integers(0, nv - 4))
        end = min(nv, start + int(rng.integers(3, 9)))
        alleles = np.full(nv, 3, np.uint8)
        quals = np.zeros(nv, np.uint8)
        for j in range(start, end):
            if rng.random() < 0.05:
                alleles[j] = 2
            else:
                alleles[j] = int(hap[j]) ^ int(rng.random() < 0.1)
                quals[j] = int(rng.integers(10, 60))
        reads.append(mod_rs.ReadSegment.new(f"r{i}", alleles, quals))
    return variants, reads


def check_astar(sim, tmp_path, monkeypatch):
    for seed in range(6):
        results = []
        for var, rs, astar in ((ref_var, ref_rs, ref_astar),
                               (port_var, port_rs, port_astar)):
            variants, reads = _astar_inputs(var, rs, seed)
            r = astar.astar_solver(seed, variants, reads, 16 + 8 * seed, 3)
            results.append((r.haplotype_1, r.haplotype_2,
                            dataclasses.asdict(r.statistics)))
        assert results[0] == results[1], seed


def _graph(mod_wfa, mod_var, rng_seed):
    rng = np.random.default_rng(rng_seed)
    length = 160
    ref = rng.choice(ACGT, size=length).astype(np.uint8).tobytes()
    variants, pos = [], 6
    while pos < length - 12:
        kind = ("snv", "ins", "del")[int(rng.integers(0, 3))]
        if kind == "snv":
            alt = bytes([next(b for b in b"ACGT" if b != ref[pos])])
            variants.append(mod_var.Variant.new_snv(0, pos, ref[pos:pos + 1],
                                                    alt, 0, 1))
        elif kind == "ins":
            ins = rng.choice(ACGT, size=int(rng.integers(1, 4))).astype(
                np.uint8).tobytes()
            variants.append(mod_var.Variant.new_insertion(
                0, pos, ref[pos:pos + 1], ref[pos:pos + 1] + ins, 0, 1))
        else:
            d = int(rng.integers(1, 4))
            variants.append(mod_var.Variant.new_deletion(
                0, pos, 1 + d, ref[pos:pos + 1 + d], ref[pos:pos + 1], 0, 1))
        pos += int(rng.integers(8, 20))
    graph, node_to_alleles = mod_wfa.WFAGraph.from_reference_variants(
        ref, variants, 0, length, 20)
    reads = []
    for n_err in (0, 3, 12, 60):
        obs = bytearray(ref)
        for j in rng.choice(length, size=n_err, replace=False):
            obs[j] = int(rng.choice(ACGT))
        reads.append(bytes(obs))
    return graph, node_to_alleles, reads


def _align(graph, read, prune):
    try:
        r = (graph.edit_distance(read) if prune is None
             else graph.edit_distance_with_pruning(read, prune))
        return r.score, list(r.traversed_nodes)
    except Exception as exc:  # WFAGraphError of either package
        return type(exc).__name__, str(exc)


def check_wfa_graph(sim, tmp_path, monkeypatch):
    for seed in range(6):
        got = []
        for wfa, var in ((ref_wfa, ref_var), (port_wfa, port_var)):
            graph, n2a, reads = _graph(wfa, var, seed)
            got.append((graph.sequences, graph.parents, n2a,
                        [_align(graph, r, p) for r in reads
                         for p in (None, 5, 500)]))
        assert got[0] == got[1], seed
        assert any(isinstance(x[0], str) for x in got[0][3]), \
            "no case reaches the max edit distance"


def check_edit_distance(sim, tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    pairs = [(rng.choice(ACGT, size=int(rng.integers(0, 40))).tobytes(),
              rng.choice(ACGT, size=int(rng.integers(0, 40))).tobytes())
             for _ in range(40)]
    assert ([ref_ed.edit_distance(a, b) for a, b in pairs]
            == [port_ed.edit_distance(a, b) for a, b in pairs])
    q = np.zeros((len(pairs), 40), np.uint8)
    t = np.zeros((len(pairs), 40), np.uint8)
    for i, (a, b) in enumerate(pairs):
        q[i, :len(a)] = np.frombuffer(a, np.uint8)
        t[i, :len(b)] = np.frombuffer(b, np.uint8)
    ql = np.array([len(a) for a, _ in pairs])
    tl = np.array([len(b) for _, b in pairs])
    a = ref_ed.edit_distance_batch(q, ql, t, tl)
    b = port_ed.edit_distance_batch(q, ql, t, tl)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def _surface(parser):
    """Every option of a parser but the engine's choices and help."""
    rows = []
    for a in parser._actions:
        row = (a.dest, tuple(a.option_strings), a.default, a.nargs,
               a.required, type(a).__name__, getattr(a.type, "__name__", None),
               None if a.dest == "engine" else a.choices,
               None if a.dest == "engine" else a.help)
        rows.append(row)
    return rows


def check_cli_settings(sim, tmp_path, monkeypatch):
    assert _surface(ref_cli.build_parser()) == _surface(port_cli.build_parser())
    meta = sim["ref"]
    base = ["--bam", meta["bam"], "--vcf", meta["vcf"], "-r", meta["fasta"],
            "--output-vcf", str(tmp_path / "o.vcf.gz")]
    for extra in ([], ["--take", "3", "--global-pruning-distance", "0",
                       "--min-spanning-reads", "0", "--threads", "6"],
                  ["--output-bam", "x.bam", "--output-bam", "y.bam"],
                  ["--vcf", meta["vcf"]],
                  ["--bam", str(tmp_path / "missing.bam")]):
        got = []
        for cli in (ref_cli, port_cli):
            args = cli.build_parser().parse_args(base + extra)
            try:
                cli.check_settings(args)
                cfg = cli.global_realignment_config(args)
                got.append((vars(args), cfg and vars(cfg)))
            except SystemExit as exc:
                got.append(("exit", str(exc)))
        assert got[0] == got[1], extra
    assert ref_cli.U64_MAX == port_cli.U64_MAX
    assert hiphase_tpu.__version__ == hiphase_tpu_torch.__version__


def check_golden(sim, tmp_path, monkeypatch):
    """The port's copy of tests/test_e2e_golden.py's settings, golden file
    and output digest (chip_smoke.py checks the golden run with it)."""
    import json

    import tests.test_e2e_golden as ref_golden
    from hiphase_tpu_torch.utils import golden
    assert golden.DATASET_KW == ref_golden.DATASET_KW
    assert golden.GOLDEN == ref_golden.GOLDEN.resolve()
    assert golden.committed_sha256() == json.loads(
        ref_golden.GOLDEN.read_text())["sha256"]
    fasta, vcf, bam, _c, _ = build_dataset(tmp_path, seed=62, n_contigs=1,
                                           contig_len=5000, coverage=10)
    out = [str(tmp_path / x) for x in ("o.vcf.gz", "o.bam", "o.tsv")]
    assert port_cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                          "--output-vcf", out[0], "--output-bam", out[1],
                          "--blocks-file", out[2], "--engine", "astar"]) == 0
    norm = golden.normalize(*out)
    assert norm["vcf"] and norm["bam"] and norm["blocks"]
    assert norm == ref_golden._normalize(*out)
    assert golden.digest(norm) == ref_golden._digest(norm)


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_simulator, check_vcf_reader, check_bcf_reader, check_bam_reader,
    check_cram, check_block_gen, check_writers, check_astar, check_wfa_graph,
    check_edit_distance, check_cli_settings, check_golden)}


@pytest.mark.parametrize("case", list(CHECKS))
def test_copy_equals_reference(case, sim, tmp_path, monkeypatch):
    CHECKS[case](sim, tmp_path, monkeypatch)


def test_surface_ignores_only_the_engine():
    """The flag-surface comparison sees a changed default."""
    p = port_cli.build_parser()
    next(a for a in p._actions if a.dest == "threads").default = 2
    assert _surface(p) != _surface(ref_cli.build_parser())
    assert isinstance(p, argparse.ArgumentParser)
