"""The device WFA's native pass 1 (csrc/wfa_windows.cc), on the CPU.

Where a block's BAMs fetch raw, dual mode's ``--wfa-engine device`` finds
every read's window and aligned bases in one C++ call over the block's raw
records (`global_realign._native_pass1`). Read for read it must give what
the Python pass 1 gives (`_block_reads`, then `_aligned_span`): the same
reads, the same reads with a window, the same window and the same bases.
A record the Python would not answer for the same way (no aligned base)
makes the call refuse the block, and the Python pass 1 runs; and a whole
job writes the same bytes with the native pass 1 and with the port's
library withheld.
"""

import pathlib

import numpy as np
import pytest
import torch

from hiphase_tpu_torch import cli
from hiphase_tpu_torch.align.wfa_device import WfaCounters
from hiphase_tpu_torch.core.variants import Variant
from hiphase_tpu_torch.io import bgzf, native
from hiphase_tpu_torch.io.bam import BamRecord, BamWriter, SamHeader
from hiphase_tpu_torch.phasing import global_realign as gr
from hiphase_tpu_torch.phasing.block_gen import PhaseBlock
from hiphase_tpu_torch.phasing.read_parsing import GlobalRealignmentConfig
from hiphase_tpu_torch.tracing import OFF
from hiphase_tpu_torch.utils import simulate
from hiphase_tpu_torch.writers.phase_stats import ReadStats

torch.set_num_threads(2)
CPU = torch.device("cpu")
MIN_MAPQ = 5    # the CLI's --min-mapq


def _bases(rng, n):
    return simulate.BASES[rng.integers(0, 4, n)]


def _edge_records(rng, records):
    """The generator's (pos, raw) records, with what pass 1 must read as
    the Python does on every eighth read: soft clips at both ends; hard
    clips around a soft clip; an N base; = and X ops for M; a MAPQ below
    the filter's; a flag the filter drops (split reads keep their MAPQ and
    flags, and so their joins)."""
    out = []
    for i, (pos, raw) in enumerate(records):
        rec = BamRecord.parse(raw)
        cigar = rec.cigar()
        seq = np.frombuffer(rec.query_sequence(), np.uint8).copy()
        flag, mapq = rec.flag, rec.mapq
        kind = i % 8
        if kind >= 5 and rec.get_tag("SA") is not None:
            kind = 0
        if kind == 1:
            a, b = (int(x) for x in rng.integers(1, 400, 2))
            seq = np.concatenate([_bases(rng, a), seq, _bases(rng, b)])
            cigar = [("S", a)] + cigar + [("S", b)]
        elif kind == 2:
            a = int(rng.integers(1, 50))
            seq = np.concatenate([_bases(rng, a), seq])
            cigar = [("H", 30), ("S", a)] + cigar + [("H", 12)]
        elif kind == 3:
            seq[int(rng.integers(0, len(seq)))] = ord("N")
        elif kind == 4:
            cigar = [("=" if op == "M" else op, n) for op, n in cigar]
            if cigar[-1][0] == "=" and cigar[-1][1] > 1:
                cigar[-1:] = [("=", cigar[-1][1] - 1), ("X", 1)]
        elif kind == 5:
            mapq = int(rng.integers(0, MIN_MAPQ))
        elif kind == 6:
            flag |= (0x4, 0x100, 0x200, 0x400)[i // 8 % 4]
        raw = simulate.make_read_raw(rec.read_name.encode(), rec.refid,
                                     rec.pos, seq, cigar, 30, flag,
                                     raw[rec._aux_off:])
        out.append((pos, raw[:9] + bytes([mapq]) + raw[10:]))
    return out


def _dataset(tmp_path, monkeypatch, seed, length, read_length, coverage):
    """A seeded utils/simulate contig (SNVs, 1-6 bp indels, SV deletions,
    tandem repeats, hom-alt variants; split reads across its deserts) with
    the edge records of `_edge_records`, in a BAM of small BGZF blocks so
    that index chunks share blocks. Returns (fasta, vcf, bam)."""
    rng = np.random.default_rng(seed)
    seq, variants, segments = simulate.simulate_contig(
        rng, length, het_spacing=400, hom_spacing=1500, block_kb=60,
        sv_del_every=6_000, tr_every=6_000)
    records = _edge_records(rng, simulate.simulate_reads(
        rng, seq, variants, segments, 0, read_length, coverage, 0.01,
        sa_bridge_rate=1.0))
    paths = [str(tmp_path / x) for x in ("ref.fa", "calls.vcf.gz",
                                         "reads.bam")]
    simulate.write_fasta_fast(paths[0], ["chr1"], [seq])
    simulate.write_vcf_fast(paths[1], ["chr1"], [variants], [length],
                            io_threads=1)
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n"
                       "@RG\tID:rg1\tSM:SAMPLE\n", ["chr1"], [length])
    with monkeypatch.context() as mp:
        mp.setattr(bgzf, "MAX_BLOCK_PAYLOAD", 4096)
        w = BamWriter(paths[2], header, io_threads=1)
        for _pos, raw in records:
            w.write(BamRecord.parse(raw))
        w.close()
        w.write_index()
    return paths


def _assert_same_pass1(block, bam_paths, variant_calls, hom_calls, seen):
    """The native pass 1 of one block equals the Python pass 1, read for
    read; ``seen`` counts the edge cases the block's reads reached."""
    pack = gr.WfaBlockPack(variant_calls, hom_calls)
    got = gr._native_pass1(block, bam_paths, MIN_MAPQ, pack)
    assert got is not None
    reads, (has_window, ref_start, ref_end, read_blob, read_off) = got
    want = list(gr._block_reads(block, bam_paths, MIN_MAPQ))
    assert [r.raw for r in reads] == [r.raw for r in want]
    spans = [gr._aligned_span(r, variant_calls, hom_calls, pack)
             for r in want]
    assert has_window.tolist() == [a is not None for a in spans]
    spans = [a for a in spans if a is not None]
    assert ref_start.tolist() == [a[1] for a in spans]
    assert ref_end.tolist() == [a[2] + 1 for a in spans]
    assert [read_blob[lo:hi].tobytes() for lo, hi in
            zip(read_off[:-1], read_off[1:])] == [a[0] for a in spans]

    with_window = [r for r, w in zip(want, has_window) if w]
    ops = [{op for op, _n in r.cigar()} for r in with_window]
    seen["windows"] += len(spans)
    seen["soft_clip"] += sum("S" in o for o in ops)
    seen["hard_clip"] += sum("H" in o for o in ops)
    seen["eq_x"] += sum("X" in o for o in ops)
    seen["n_base"] += sum(b"N" in a[0] for a in spans)
    seen["odd_l_seq"] += sum(r.l_seq % 2 for r in with_window)
    seen["supplementary"] += sum(r.is_supplementary for r in with_window)
    seen["indel"] += sum(any(op in "ID" and n <= 6 for op, n in r.cigar())
                         for r in with_window)
    seen["sv_deletion"] += sum(any(op == "D" and n >= 80
                                   for op, n in r.cigar())
                               for r in with_window)
    seen["before_block"] += int((ref_start < block.start).sum())
    seen["after_block"] += int((ref_end > block.end + 1).sum())
    fetched = list(gr.cached_alignment(bam_paths[0]).fetch(
        block.chrom, block.start, block.end + 1))
    seen["low_mapq"] += sum(r.mapq < MIN_MAPQ for r in fetched)
    seen["flag_filtered"] += sum(bool(r.flag & 0x704) for r in fetched)


@pytest.mark.parametrize("seed", [31, 32])
def test_native_pass1_equals_the_python_pass1(tmp_path, monkeypatch, seed):
    """Every block of a dual job on seeded data: the native pass 1 gives
    the Python pass 1's reads, windows and aligned bases, read for read.
    The blocks' reads reach soft and hard clips, = and X ops, an N base,
    odd l_seq, split (supplementary) reads, 1-6 bp indels and SV
    deletions, windows past either end of the block, and records that the
    MAPQ or the flag filter drops."""
    fasta, vcf, bam = _dataset(tmp_path, monkeypatch, seed, 200_000,
                               read_length=4_000, coverage=6)
    assert native.available() and native.port_available()
    seen = dict.fromkeys((
        "blocks", "windows", "soft_clip", "hard_clip", "eq_x", "n_base",
        "odd_l_seq", "supplementary", "indel", "sv_deletion",
        "before_block", "after_block", "low_mapq", "flag_filtered"), 0)

    def checking(block, bam_paths, variant_calls, hom_calls, *_args):
        seen["blocks"] += 1
        _assert_same_pass1(block, bam_paths, variant_calls, hom_calls, seen)
        return [], [], ReadStats()

    monkeypatch.setattr(gr, "_load_full_read_segments_device", checking)
    assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                     "--output-vcf", str(tmp_path / "o.vcf.gz"),
                     "--engine", "native", "--wfa-engine", "device",
                     "--threads", "1"], device=CPU) == 0
    assert seen["blocks"] >= 2 and seen["windows"] > 100
    for kind, n in seen.items():
        assert n > 0, kind


def _block_with(raw_middle: bytes, tmp_path):
    """A BAM of three reads at 1,000-1,200 of a 3 kb contig, the middle one
    ``raw_middle``, and the block over hets at 1,020, 1,060 and 1,150."""
    rng = np.random.default_rng(5)
    ref = _bases(rng, 3_000)
    header = SamHeader("@HD\tVN:1.6\tSO:coordinate\n", ["chr1"], [3_000])
    path = str(tmp_path / "reads.bam")
    w = BamWriter(path, header, io_threads=1)
    for name, pos in ((b"a", 1_000), (None, 1_040), (b"c", 1_100)):
        raw = raw_middle if name is None else simulate.make_read_raw(
            name, 0, pos, ref[pos:pos + 100], [("M", 100)], 30, 0, b"")
        w.write(BamRecord.parse(raw))
    w.close()
    w.write_index()
    hets = [Variant.new_snv(i, p, bytes(ref[p:p + 1]),
                            b"A" if ref[p] != ord("A") else b"C", 0, 1)
            for i, p in enumerate((1_020, 1_060, 1_150))]
    block = PhaseBlock(0, "chr1", 0, 1_020, 1_150, 3, [3], 0, "SAMPLE")
    return block, [path], hets


def test_no_aligned_base_refuses_the_block(tmp_path):
    """A record with no aligned base (its CIGAR all soft clip) makes the
    native pass 1 refuse the block; the Python pass 1 then runs and stops
    at its assertion, as it does without the library."""
    raw = simulate.make_read_raw(
        b"b", 0, 1_040, np.frombuffer(b"ACGT" * 15, np.uint8), [("S", 60)],
        30, 0, b"")
    block, bams, hets = _block_with(raw, tmp_path)
    assert gr._native_pass1(block, bams, MIN_MAPQ,
                            gr.WfaBlockPack(hets, [])) is None
    counters = WfaCounters()
    with pytest.raises(AssertionError):
        gr._load_full_read_segments_device(
            block, bams, hets, [], None, 2, MIN_MAPQ,
            GlobalRealignmentConfig(wfa_engine="device"), CPU, counters,
            OFF)
    assert counters.pass1 == {"native": 0, "python": 1}


def test_bases_past_l_seq_refuse_the_block(tmp_path):
    """A record whose CIGAR aligns more bases than it holds (no sequence):
    the native pass 1 refuses the block, and the Python pass 1 gives the
    read its window with no bases, as it always has."""
    raw = simulate.make_read_raw(b"b", 0, 1_040, np.zeros(0, np.uint8),
                                 [("M", 100)], 30, 0, b"")
    block, bams, hets = _block_with(raw, tmp_path)
    pack = gr.WfaBlockPack(hets, [])
    assert gr._native_pass1(block, bams, MIN_MAPQ, pack) is None
    reads, (has_window, ref_start, ref_end, read_blob, read_off) = \
        gr._python_pass1(block, bams, MIN_MAPQ, hets, [], pack)
    assert has_window.tolist() == [True, True, True]
    assert ref_start[1] == 1_040 and ref_end[1] == 1_140
    assert read_off[2] - read_off[1] == 0 and read_off[1] == 100


def test_job_outputs_equal_with_and_without_the_native_pass1(tmp_path,
                                                             monkeypatch):
    """A dual --wfa-engine device job on the CPU writes the same VCF,
    blocks, stats and summary with the native pass 1 and with the port's
    library withheld; wfa.pass1 counts every block on the path it took."""
    fasta, vcf, bam = _dataset(tmp_path, monkeypatch, 41, 12_000,
                               read_length=1_500, coverage=3)
    native.port_available()
    blocks = {"n": 0}
    device_pass = gr._load_full_read_segments_device

    def counting(*args):
        blocks["n"] += 1
        return device_pass(*args)

    monkeypatch.setattr(gr, "_load_full_read_segments_device", counting)
    outs, pass1 = {}, {}
    # both runs write the same paths: the VCF header holds the command line
    o = {x: tmp_path / f"out.{x}" for x in
         ("vcf.gz", "blocks.tsv", "stats.csv", "summary.tsv")}
    for name in ("native", "python"):
        if name == "python":
            monkeypatch.setattr(native, "_PORT", None)
        blocks["n"] = 0
        assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                         "--output-vcf", str(o["vcf.gz"]),
                         "--blocks-file", str(o["blocks.tsv"]),
                         "--stats-file", str(o["stats.csv"]),
                         "--summary-file", str(o["summary.tsv"]),
                         "--engine", "native", "--wfa-engine", "device",
                         "--threads", "1"], device=CPU) == 0
        pass1[name] = (blocks["n"], cli.LAST_RUN_STATS["wfa"]["pass1"])
        outs[name] = {x: pathlib.Path(p).read_bytes() for x, p in o.items()}
    n = pass1["native"][0]
    assert n >= 1 and pass1["python"][0] == n
    assert pass1["native"][1] == {"native": n, "python": 0}
    assert pass1["python"][1] == {"native": 0, "python": n}
    assert cli.LAST_RUN_STATS["wfa"]["reads"] > 10
    for x in outs["native"]:
        assert outs["native"][x] == outs["python"][x], x
