"""The device WFA's native window packer (csrc/wfa_pack.cc), on the CPU.

With the packer bound, dual mode's ``--wfa-engine device`` builds every
window graph of a block in C++ straight into the kernel's batch layout
(`_PackedWindows.batch`, `PairBatch.from_windows`). Its words must equal the Python linearisation's
(`PairBatch([_linearized(read_window(...)[1]) ...])`) word for word, its
(node, variant, allele) triples must be `read_window`'s node_to_alleles
shifted to the block's variant indices, a window the builder refuses must
take the Python path, and a whole job must write the same bytes with and
without the packer. How its library (the port's own) is built and loaded
is tested in tests/test_torch_native_build.py.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

from hiphase_tpu_torch import cli
from hiphase_tpu_torch.align import wfa_device
from hiphase_tpu_torch.align.wfa_graph import WFAGraph
from hiphase_tpu_torch.core.variants import Variant
from hiphase_tpu_torch.io import native
from hiphase_tpu_torch.phasing import global_realign as gr
from hiphase_tpu_torch.utils import simulate

from tests import sim

torch.set_num_threads(2)
CPU = torch.device("cpu")
VECTORS = ("goff", "G", "gnoff", "N", "last_node", "c_end", "spread",
           "roff", "rlen", "sections", "flat")


def _assert_same_batch(got, want):
    assert (got.n, got.P) == (want.n, want.P)
    for name in VECTORS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def _triples_of(packed, k):
    """Pair k's triples as read_window's node_to_alleles: node → [(variant
    index relative to the first het overlap, allele)]."""
    tri_off, node, var, val = packed.triples
    first = packed.window(k)[3]
    out = {}
    for t in range(tri_off[k], tri_off[k + 1]):
        out.setdefault(int(node[t]), []).append(
            (int(var[t]) - first, int(val[t])))
    return out


def _checking_ladder(seen):
    """An `align_pairs_device` that holds each packed block to the Python
    linearisation and certifies nothing (pass 2 then aligns every read on
    the host, so the job stays quick on the CPU)."""
    def align(make_batch, device, counters=None, spans=None):
        packed = make_batch.__self__
        batch = make_batch()
        n = batch.n
        assert packed.native.all()
        reads = [packed.read_blob[lo:hi].tobytes() for lo, hi in
                 zip(packed.read_off[:-1], packed.read_off[1:])]
        want = wfa_device.PairBatch(
            [wfa_device._linearized(packed.window(k)[1]) for k in range(n)],
            reads, list(range(n)))
        _assert_same_batch(batch, want)
        for k in range(n):
            assert _triples_of(packed, k) == packed.window(k)[2], k
        pack = packed.wfa_pack
        for s, e in zip(packed.ref_start, packed.ref_end):
            inside = (pack.pos >= s) & (pack.pos + pack.ref_len <= e)
            seen["windows"] += 1
            seen["sv_deletion"] += int((inside & (pack.ref_len >= 80)).any())
            seen["tandem_repeat"] += int(
                (inside & (pack.ref_len >= 12) & (pack.ref_len < 80)).any())
            seen["indel"] += int((inside & (pack.ref_len > 1)
                                  & (pack.ref_len < 8)).any())
            seen["hom"] += int((inside & (pack.var_index < 0)).any())
            seen["window_past_block"] += int(
                s < pack.pos.min() or e > pack.pos.max())
        return [None] * n
    return align


@pytest.mark.parametrize("seed", [5, 6])
def test_packed_blocks_equal_the_python_linearisation(tmp_path, monkeypatch,
                                                      seed):
    """Every block of a dual job on seeded data with SNVs, indels, SV
    deletions, tandem repeats and hom-alt variants: the packer's buffer,
    sections and per-pair vectors equal the Python linearisation's word
    for word, and its triples equal read_window's node_to_alleles."""
    monkeypatch.setattr(simulate, "simulate_contig", functools.partial(
        simulate.simulate_contig, sv_del_every=8_000, tr_every=8_000))
    data = simulate.build_benchmark_dataset(
        str(tmp_path / "data"), total_mb=1, n_contigs=8, coverage=3,
        read_length=4000, seed=seed, het_spacing=400, hom_spacing=1500,
        io_threads=1)
    seen = dict.fromkeys(("windows", "sv_deletion", "tandem_repeat",
                          "indel", "hom", "window_past_block"), 0)
    monkeypatch.setattr(wfa_device, "align_pairs_device",
                        _checking_ladder(seen))
    assert native.port_available()
    out = tmp_path / "o.vcf.gz"
    assert cli.main(["--bam", data["bam"], "--vcf", data["vcf"],
                     "--reference", data["fasta"], "--output-vcf", str(out),
                     "--engine", "native", "--wfa-engine", "device",
                     "--threads", "1"], device=CPU) == 0
    assert seen["windows"] > 100
    for kind in ("sv_deletion", "tandem_repeat", "indel", "hom",
                 "window_past_block"):
        assert seen[kind] > 0, kind


def _over_capacity_block():
    """Five multi-allelic SNVs (two ALT branches each) and a hom-alt SNV in
    300 bp: a window over all six needs 24 nodes, over hn_wfa_build's
    capacity of 3n + 4 = 22, and one over two of them fits."""
    rng = np.random.default_rng(3)
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 300))
    hets = [Variant.new_snv(i, p, b"G" if ref[p] != ord("G") else b"T",
                            b"C" if ref[p] != ord("C") else b"A", 1, 2)
            for i, p in enumerate((40, 90, 140, 190, 240))]
    homs = [Variant.new_snv(9, 260, ref[260:261],
                            b"A" if ref[260] != ord("A") else b"T", 0, 1)]
    return ref, hets, homs


def _packed_windows(pack, ref, hets, homs, windows, reads):
    """`_PackedWindows` of reads[k] in window (ref_start, ref_end, first
    het, last het, first hom, last hom) windows[k], and its Python windows
    (`read_window`'s tuple)."""
    def python_window(k):
        s, e, h0, h1, m0, m1 = windows[k]
        g, n2a = WFAGraph.from_reference_variants_with_hom(
            ref, hets[h0:h1], homs[m0:m1], s, e, 1000)
        return reads[k], g, n2a, h0

    spans = [(reads[k], s, e - 1, h0, h1, m0, m1)
             for k, (s, e, h0, h1, m0, m1) in enumerate(windows)]
    return (gr._PackedWindows(pack, ref, *gr._window_arrays(spans),
                              python_window), python_window)


def test_window_over_capacity_takes_the_python_path():
    """A window the builder refuses comes back marked and is built and
    linearised in Python, in the same batch as the packed ones; the
    ladder's results equal those of the Python batch."""
    ref, hets, homs = _over_capacity_block()
    pack = gr.WfaBlockPack(hets, homs)
    # (ref_start, ref_end, first het, last het, first hom, last hom)
    windows = [(0, 300, 0, 5, 0, 1), (60, 180, 1, 3, 0, 0),
               (30, 290, 0, 5, 0, 1), (60, 180, 1, 3, 0, 0)]
    # the last read is unplaceable: no rung certifies it
    unplaceable = bytes(np.random.default_rng(4).choice(
        np.frombuffer(b"ACGT", np.uint8), 700))
    reads = [ref, ref[60:100] + b"A" + ref[101:180], ref[30:290],
             unplaceable]

    packed, python_window = _packed_windows(pack, ref, hets, homs, windows,
                                            reads)
    counters = wfa_device.WfaCounters()
    got = wfa_device.align_pairs_device(packed.batch, CPU,
                                        counters=counters)
    assert packed.native.tolist() == [False, True, False, True]
    assert counters.windows == {"native": 2, "python": 2}
    # six variants in windows 0 and 2 (the hom too): 24 nodes, over 22
    assert [len(python_window(k)[1].sequences) for k in range(4)] == [
        24, 9, 24, 9]

    batch = packed.batch()
    want = wfa_device.PairBatch(
        [wfa_device._linearized(python_window(k)[1]) for k in range(4)],
        reads, list(range(4)))
    _assert_same_batch(batch, want)
    assert _triples_of(packed, 1) == python_window(1)[2]
    assert got == wfa_device.align_pairs_device(
        lambda: wfa_device.PairBatch.of_pairs(
            [(python_window(k)[1], reads[k]) for k in range(4)]), CPU)
    assert got[1] is not None and got[3] is None
    # pass 2: a certified packed pair assigns from the triples, and the
    # others from their Python windows, as the Python path does
    for k in range(4):
        a, q, st = packed.assign(k, got[k], hets, 500, 1000)
        b, r, su, _ = gr._device_assign(python_window(k), got[k], hets, 500,
                                        1000)
        assert np.array_equal(a, b) and np.array_equal(q, r)
        assert st.inexact_matches.tolist() == su.inexact_matches.tolist()


@pytest.mark.parametrize("withheld", ["library", "block_pack"])
def test_without_the_packer_every_window_takes_the_python_path(monkeypatch,
                                                               withheld):
    """With the packer's library not bound, or no variant pack for the
    block, every window is built and linearised in Python: the batch is
    the Python linearisation's, the counter says so, and pass 2 assigns
    from the Python windows."""
    ref, hets, homs = _over_capacity_block()
    pack = gr.WfaBlockPack(hets, homs)
    native.port_available()
    if withheld == "library":
        monkeypatch.setattr(native, "_PORT", None)
    else:
        pack = None
    windows = [(60, 180, 1, 3, 0, 0), (0, 300, 0, 5, 0, 1)]
    reads = [ref[60:100] + b"A" + ref[101:180], ref]
    packed, python_window = _packed_windows(pack, ref, hets, homs, windows,
                                            reads)
    counters = wfa_device.WfaCounters()
    got = wfa_device.align_pairs_device(packed.batch, CPU,
                                        counters=counters)
    assert packed.native.tolist() == [False, False]
    assert counters.windows == {"native": 0, "python": 2}
    _assert_same_batch(packed.batch(), wfa_device.PairBatch.of_pairs(
        [(python_window(k)[1], reads[k]) for k in range(2)]))
    assert got[0] is not None
    for k in range(2):
        a, q, _ = packed.assign(k, got[k], hets, 500, 1000)
        b, r, _, _ = gr._device_assign(python_window(k), got[k], hets, 500,
                                       1000)
        assert np.array_equal(a, b) and np.array_equal(q, r)


def _mixed_dataset(tmp_path, seed):
    rng = np.random.default_rng(seed)
    contig = sim.simulate_contig_mixed(rng, "chr1", 4000, sv_del=True,
                                       tandem_repeat=True)
    paths = [str(tmp_path / x) for x in ("ref.fa", "calls.vcf.gz",
                                         "reads.bam")]
    sim.write_fasta(paths[0], [contig])
    sim.write_vcf(paths[1], [contig])
    reads = sim.simulate_reads_mixed(rng, contig, 0, read_length=1200,
                                     coverage=6, rg_tag=sim.RG_TAG)
    sim.write_bam(paths[2], [contig], [reads])
    return paths


def test_job_outputs_equal_with_and_without_the_packer(tmp_path,
                                                       monkeypatch):
    """A dual --wfa-engine device job on the CPU writes the same bytes with
    the packer and with its library withheld; the window counter says
    which linearised each window."""
    fasta, vcf, bam = _mixed_dataset(tmp_path, seed=17)
    native.port_available()
    outs, windows = {}, {}
    # both runs write the same paths: the VCF header holds the command line
    o = {x: tmp_path / f"out.{x}" for x in
         ("vcf.gz", "blocks.tsv", "stats.csv", "summary.tsv")}
    for name in ("packer", "python"):
        if name == "python":
            monkeypatch.setattr(native, "_PORT", None)
        assert cli.main(["--bam", bam, "--vcf", vcf, "--reference", fasta,
                         "--output-vcf", str(o["vcf.gz"]),
                         "--blocks-file", str(o["blocks.tsv"]),
                         "--stats-file", str(o["stats.csv"]),
                         "--summary-file", str(o["summary.tsv"]),
                         "--engine", "native", "--wfa-engine", "device",
                         "--threads", "1"], device=CPU) == 0
        wfa = cli.LAST_RUN_STATS["wfa"]
        windows[name] = (wfa["reads"], wfa["windows"])
        outs[name] = {x: pathlib.Path(p).read_bytes() for x, p in o.items()}
    reads = windows["packer"][0]
    assert reads > 10 and windows["python"][0] == reads
    assert windows["packer"][1] == {"native": reads, "python": 0}
    assert windows["python"][1] == {"native": 0, "python": reads}
    for x in outs["packer"]:
        assert outs["packer"][x] == outs["python"][x], x
