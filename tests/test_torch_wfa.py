"""The port's device graph-WFA against the JAX package's, on the CPU.

The same seeded inputs go through ``hiphase_tpu.align.wfa_device`` (JAX on
the CPU, as tests/test_wfa_device.py runs it) and through
``hiphase_tpu_torch.align.wfa_device`` (the kernel's plain version, which
the wrapper runs for CPU tensors). Every result is an integer or a boolean
and must be equal: tolerance 0.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_wfa_graph as twg
from hiphase_tpu.align import wfa_device as jax_wfa
from hiphase_tpu.align.wfa_graph import WFAGraph, WFAGraphError, WFAResult
from hiphase_tpu.core.variants import Variant
from hiphase_tpu_torch import kernels
from hiphase_tpu_torch.align import wfa_device as port

CPU = torch.device("cpu")
ACGT = np.frombuffer(b"ACGT", np.uint8)


def _random_case(rng):
    """tests/test_wfa_device.py's randomized graph: SNVs, insertions and
    deletions on a random reference, and a mutated read."""
    n = int(rng.integers(2, 8))
    length = 40 + n * 12
    ref = rng.choice(ACGT, size=length).astype(np.uint8).tobytes()
    variants = []
    pos = 5
    while pos < length - 12 and len(variants) < n:
        kind = rng.choice(["snv", "ins", "del"])
        if kind == "snv":
            alt = bytes([rng.choice([b for b in b"ACGT" if b != ref[pos]])])
            variants.append(Variant.new_snv(0, pos, ref[pos:pos + 1], alt,
                                            0, 1))
        elif kind == "ins":
            ins = rng.choice(ACGT, size=int(rng.integers(1, 4))
                             ).astype(np.uint8).tobytes()
            variants.append(Variant.new_insertion(
                0, pos, ref[pos:pos + 1], ref[pos:pos + 1] + ins, 0, 1))
        else:
            d = int(rng.integers(1, 4))
            variants.append(Variant.new_deletion(
                0, pos, 1 + d, ref[pos:pos + 1 + d], ref[pos:pos + 1], 0, 1))
        pos += int(rng.integers(6, 14))
    g, _ = WFAGraph.from_reference_variants(ref, variants, 0, length, 1000)
    obs = bytearray(ref)
    for j in rng.choice(length, size=int(rng.integers(0, 4)), replace=False):
        obs[j] = rng.choice(ACGT)
    return g, bytes(obs)


def _both(graph, reads, H):
    """(JAX, port) results of the forward/backward pass on the same
    padded arrays."""
    ga = jax_wfa.linearize_graph(graph)
    *arrays, n_nodes = jax_wfa._padded_arrays(ga)
    Lr = jax_wfa._pad_up(max((len(r) for r in reads), default=1), 256)
    arr = np.zeros((len(reads), Lr), np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = np.frombuffer(r, np.uint8)
    rl = np.array([len(r) for r in reads], np.int32)
    want = jax_wfa.wfa_forward_backward(
        *arrays, arr, rl, H=H, n_nodes=n_nodes,
        last_node=np.int32(ga.last_node), c_end=np.int32(ga.c_end))
    got = port.wfa_forward_backward(
        *(torch.from_numpy(a) for a in (*arrays, arr, rl)), H=H,
        n_nodes=n_nodes, last_node=ga.last_node, c_end=ga.c_end)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_equal(want, got):
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert np.array_equal(w, g)


def _graphs():
    rng = np.random.default_rng(7)
    graphs = [_random_case(rng)[0] for _ in range(5)]
    graphs.append(chip_smoke.wfa_graph_case(3)[0])
    g = WFAGraph()
    g.add_node(b"", [])   # an empty root node
    g.add_node(b"ACGT", [0])
    graphs.append(g)
    return graphs


@pytest.mark.parametrize("case", range(7))
def test_linearize_and_padding_equal_jax(case):
    graph = _graphs()[case]
    want, got = jax_wfa.linearize_graph(graph), port.linearize_graph(graph)
    for name in ("n_nodes", "spread", "total_pos", "last_node", "c_end"):
        assert getattr(got, name) == getattr(want, name)
    w_pad, g_pad = jax_wfa._padded_arrays(want), port._padded_arrays(got)
    assert w_pad[-1] == g_pad[-1]
    for w, g in zip(w_pad[:-1], g_pad[:-1]):
        assert w.dtype == g.dtype and np.array_equal(w, g)


@pytest.mark.parametrize("H", port.H_LADDER)
def test_plain_equals_jax_randomized(H):
    """The 25 randomized graphs of tests/test_wfa_device.py, each with its
    mutated read, a trimmed read and an empty read."""
    rng = np.random.default_rng(7)
    for _trial in range(25):
        g, obs = _random_case(rng)
        _assert_equal(*_both(g, [obs, obs[3:-4], b""], H))


@pytest.mark.parametrize("H", port.H_LADDER)
def test_plain_equals_jax_mixed_batch(H):
    """tests/test_wfa_device.py's mixed batch in one call."""
    ref = b"ACGTACGTACGTACGTACGTACGTACGTACGT"
    variants = [Variant.new_snv(0, 7, b"G", b"C", 0, 1),
                Variant.new_snv(0, 19, b"T", b"A", 0, 1)]
    g, _ = WFAGraph.from_reference_variants(ref, variants, 0, len(ref), 1000)
    reads = [ref, ref[:7] + b"C" + ref[8:], ref[2:30], b"",
             ref[:19] + b"A" + ref[20:]]
    _assert_equal(*_both(g, reads, H))


@pytest.mark.parametrize("H", port.H_LADDER)
def test_plain_equals_jax_joins_empty_and_out_of_band(H):
    """chip_smoke.py's seeded graph: two-parent joins and empty (eps)
    branches, with the reference path, a mutated read, an empty read, and
    a read whose kstar falls outside the band."""
    g, reads = chip_smoke.wfa_graph_case(5)
    ga = port.linearize_graph(g)
    assert ((ga.par_idx >= 0).sum(1) >= 2).any() and (ga.pchar < 0).any()
    want, got = _both(g, reads, H)
    _assert_equal(want, got)
    assert not got[2][3], "the out-of-band read must be out of band"


def test_align_reads_device_equals_jax_across_the_ladder():
    """Reads certified at H = 32, one certified only at H = 128, and one
    that no rung certifies (None); the counters follow the ladder."""
    rng = np.random.default_rng(11)
    ref = rng.choice(ACGT, size=300).astype(np.uint8).tobytes()
    variants = [Variant.new_snv(0, p, ref[p:p + 1],
                                bytes([next(b for b in b"ACGT"
                                            if b != ref[p])]), 0, 1)
                for p in (40, 120, 200)]
    g, _ = WFAGraph.from_reference_variants(ref, variants, 0, len(ref), 1000)
    noisy = bytearray(ref)
    for j in range(5, 300, 7):          # ~43 substitutions: score > 32
        noisy[j] = ord("A") if noisy[j] != ord("A") else ord("C")
    alt_path = ref[:120] + variants[1].allele1 + ref[121:]
    unplaceable = rng.choice(ACGT, size=900).astype(np.uint8).tobytes()
    reads = [ref, bytes(noisy), alt_path, unplaceable]
    counters = port.WfaCounters()
    got = port.align_reads_device(g, reads, CPU, counters=counters)
    assert got == jax_wfa.align_reads_device(g, reads)
    assert got[1] is not None and got[1][0] > 32
    assert got[3] is None
    # one launch per rung: 4, then 2, then 1 pairs
    assert counters.as_dict() == {
        "reads": 4, "certified": {"32": 2, "128": 1}, "uncertified": 1,
        "band_calls": 3, "pairs_per_launch": 7 / 3,
        "max_pairs_per_launch": 4, "h2d_copies": 0,
        "windows": {"native": 0, "python": 1},
        "pass1": {"native": 0, "python": 0}}


def _ragged_pairs():
    """Seeded graphs of different lengths and parent counts (two- and
    three-parent joins, eps branches, the randomized SNV/indel graphs),
    each read against its own graph, with reads of mixed lengths: the
    reference path, a mutated one, a trimmed one, an empty one and one
    that is out of band."""
    rng = np.random.default_rng(13)
    pairs = []
    for seed in (0, 1):
        g, reads = chip_smoke.wfa_graph_case(seed, branches=2 + seed)
        pairs += [(g, reads[0]), (g, reads[1][5:-9]), (g, reads[3]),
                  (g, b"")]
    for _ in range(3):
        g, obs = _random_case(rng)
        pairs += [(g, obs), (g, obs[2:-3])]
    return pairs


@pytest.mark.parametrize("H", port.H_LADDER)
def test_batched_plain_equals_jax_pair_by_pair(H):
    """One ragged batch through the batched plain version equals the JAX
    wfa_forward_backward of each pair alone."""
    pairs = _ragged_pairs()
    batch = port.PairBatch([port._linearized(g) for g, _r in pairs],
                           [r for _g, r in pairs], list(range(len(pairs))))
    assert len(set(batch.G.tolist())) >= 3 and batch.P == 4
    meta = batch.meta(np.arange(batch.n), [(0, batch.n)])
    score, in_band, trav = port.wfa_forward_backward_batched(
        *batch.upload(CPU), torch.from_numpy(meta), H, n_out=batch.n,
        trav_len=int(batch.N.sum()), scratch_pos=int(batch.G.sum()),
        scratch_nodes=int(batch.N.sum()), max_read_len=int(batch.rlen.max()))
    for i, (g, r) in enumerate(pairs):
        w_score, w_trav, w_in_band = (
            np.asarray(x) for x in _both(g, [r], H)[0])
        off = meta[i, 11]
        assert score[i].item() == w_score[0], i
        assert in_band[i].item() == w_in_band[0], i
        assert np.array_equal(trav[off:off + batch.N[i]].numpy(), w_trav[0])
    assert not in_band[2].item() and not in_band[6].item()


def test_batched_ladder_equals_the_per_read_ladder():
    """align_pairs_device over the ragged batch gives exactly the results
    and the certified-at-H counts of align_reads_device read by read, in
    one launch a rung."""
    pairs = _ragged_pairs()
    batched = port.WfaCounters()
    got = port.align_pairs_device(lambda: port.PairBatch.of_pairs(pairs),
                                  CPU, counters=batched)
    single = port.WfaCounters()
    want = [port.align_reads_device(g, [r], CPU, counters=single)[0]
            for g, r in pairs]
    assert got == want
    assert got == [jax_wfa.align_reads_device(g, [r])[0] for g, r in pairs]
    a, b = batched.as_dict(), single.as_dict()
    for key in ("reads", "certified", "uncertified"):
        assert a[key] == b[key], key
    assert a["uncertified"] >= 2       # the out-of-band reads
    assert a["band_calls"] == 3 and a["max_pairs_per_launch"] == len(pairs)
    assert b["band_calls"] > len(pairs)


def test_launch_groups_fit_the_budget():
    """Consecutive groups whose scratch fits the budget, each holding at
    least one pair; no budget is one group."""
    need = np.array([5, 3, 9, 2, 2, 2, 7, 1])
    assert port._launch_groups(need, None) == [(0, 8)]
    groups = port._launch_groups(need, 8)
    assert groups == [(0, 2), (2, 3), (3, 6), (6, 8)]
    assert port._launch_groups(need, 1) == [(i, i + 1) for i in range(8)]


def test_batched_ladder_in_launch_groups_equals_one_launch(monkeypatch):
    """A ladder whose rungs are split into launch groups of three pairs
    gives the one-launch results: every group writes its pairs' outputs at
    the batch's indices, one band call a group."""
    pairs = _ragged_pairs()
    want = port.align_pairs_device(lambda: port.PairBatch.of_pairs(pairs),
                                   CPU)
    seen = []

    def threes(need, budget):
        groups = [(lo, min(lo + 3, len(need)))
                  for lo in range(0, len(need), 3)]
        seen.append(groups)
        return groups

    monkeypatch.setattr(port, "_launch_groups", threes)
    counters = port.WfaCounters()
    assert port.align_pairs_device(lambda: port.PairBatch.of_pairs(pairs),
                                   CPU, counters=counters) == want
    assert len(seen[0]) >= 3
    assert counters.band_calls == sum(len(g) for g in seen)
    assert counters.max_pairs_per_launch == 3


def _noisy_dataset(tmp_path, seed, contig_len, coverage):
    """tests/sim.py's SNV dataset with every other read carrying 6 to 12
    substitutions, so that some reads score above a low
    --global-realignment-max-ed."""
    from tests import sim as tsim
    rng = np.random.default_rng(seed)
    contig = tsim.simulate_contig(rng, "chr1", contig_len)
    fasta, vcf, bam = (str(tmp_path / x)
                       for x in ("ref.fa", "calls.vcf.gz", "reads.bam"))
    tsim.write_fasta(fasta, [contig])
    tsim.write_vcf(vcf, [contig])
    reads = []
    for i, (pos, rec, hap) in enumerate(tsim.simulate_reads(
            rng, contig, 0, coverage=coverage, rg_tag=tsim.RG_TAG)):
        seq = bytearray(rec.query_sequence())
        if i % 2:
            for j in rng.choice(len(seq), size=int(rng.integers(6, 13)),
                                replace=False):
                seq[j] = b"ACGT"[(b"ACGT".index(seq[j]) + 1) % 4]
        reads.append((pos, tsim.make_bam_record(
            rec.read_name, 0, pos, bytes(seq), [("M", len(seq))],
            tags=tsim.RG_TAG), hap))
    tsim.write_bam(bam, [contig], [reads])
    return fasta, vcf, bam


@pytest.mark.parametrize("caller", ["device", "host_per_read"])
def test_dual_mode_trip_mid_block_matches_jax_host_wfa(tmp_path, caplog,
                                                       monkeypatch, caller):
    """A low --global-realignment-max-ed with a low --global-failure-count
    and ratio trips the failure ladder inside a block: the reads after the
    trip go to local realignment, and the port's VCF, blocks and stats
    files are byte-identical to the JAX package's host WFA, on the device
    WFA and on the per-read host path (the host WFA with the native
    libraries withheld)."""
    import gzip
    import logging

    from hiphase_tpu.cli import main as jax_cli_main
    from hiphase_tpu_torch import cli
    from hiphase_tpu_torch.io import native
    from hiphase_tpu_torch.phasing import global_realign as gr

    fasta, vcf, bam = _noisy_dataset(tmp_path, seed=31, contig_len=5000,
                                     coverage=12)
    flags = ["--global-realignment-max-ed", "4", "--global-failure-count",
             "3", "--max-global-failure-ratio", "0.3", "--threads", "1"]
    # each walk of a block: (its reads, of them assigned globally)
    walks = []
    walk = gr._assign_in_order

    def watched(reads, assign_global, *args):
        reads, calls = list(reads), [0]

        def counted(i, read):
            calls[0] += 1
            return assign_global(i, read)
        walk(reads, counted, *args)
        walks.append((len(reads), calls[0]))
    monkeypatch.setattr(gr, "_assign_in_order", watched)
    if caller == "host_per_read":
        native._load()
        for name, value in (("_LIB", None), ("_PORT", None),
                            ("_TRIED", True)):
            monkeypatch.setattr(native, name, value)
    outs = {}
    for name in ("port", "jax"):
        o = (str(tmp_path / f"{name}.vcf.gz"), str(tmp_path / f"{name}.tsv"),
             str(tmp_path / f"{name}.csv"))
        argv = ["--bam", bam, "--vcf", vcf, "--reference", fasta,
                "--output-vcf", o[0], "--blocks-file", o[1],
                "--stats-file", o[2]] + flags
        if name == "port":
            with caplog.at_level(logging.INFO):
                assert cli.main(argv + ["--engine", "cuda", "--wfa-engine",
                                        "device" if caller == "device"
                                        else "host"], device=CPU) == 0
            if caller == "device":
                wfa = cli.LAST_RUN_STATS["wfa"]
        else:
            assert jax_cli_main(argv + ["--engine", "native",
                                        "--wfa-engine", "host"]) == 0
        outs[name] = o
    trips = [r for r in caplog.records
             if "reverting to local for the rest" in r.getMessage()]
    assert trips, "the failure ladder did not trip"
    # the trip comes after a few reads of a block, not at its end
    if caller == "device":
        assert wfa["reads"] > 10 * len(trips)
    tripped = [(n, g) for n, g in walks if g < n]
    assert tripped and all(g >= 3 for _n, g in tripped)

    def body(path):
        return [x for x in gzip.open(path).read().split(b"\n")
                if not x.startswith(b"##hiphase")]

    assert len(body(outs["port"][0])) > 20
    assert body(outs["port"][0]) == body(outs["jax"][0])
    # the stats file's global_aligned / local_aligned say where it tripped
    for k in (1, 2):
        with open(outs["port"][k], "rb") as a, \
                open(outs["jax"][k], "rb") as b:
            assert a.read() == b.read()


def _port_result(graph, seq):
    res = port.align_reads_device(graph, [bytes(seq)], CPU)
    assert res[0] is not None, "band ladder failed to certify a tiny case"
    score, trav = res[0]
    if score > graph.max_edit_distance:
        raise WFAGraphError(graph.max_edit_distance)
    return WFAResult(score, trav)


SCENARIOS = [n for n in dir(twg)
             if n.startswith("test_") and "native" not in n]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_on_port(name, monkeypatch):
    """Every pinned scenario of tests/test_wfa_graph.py, replayed through
    the port's align_reads_device as tests/test_wfa_device.py replays it
    through the JAX package's."""
    monkeypatch.setattr(WFAGraph, "edit_distance", _port_result)
    monkeypatch.setattr(WFAGraph, "edit_distance_with_pruning",
                        lambda self, seq, prune: _port_result(self, seq))
    getattr(twg, name)()


def test_kernel_builds_and_binds_once_across_threads(monkeypatch, tmp_path):
    """Eight threads reaching a fresh kernel at once: one build, one bind,
    every launch counted."""
    kernel = kernels.Kernel("wfa_forward_backward", "test", [])
    builds = []
    gate = threading.Barrier(8)

    def fake_build(names):
        time.sleep(0.05)   # a window for a second thread to build as well
        builds.append(list(names))
        return {n: kernels.build.BuiltKernel(tmp_path / f"{n}.so", "")
                for n in names}

    def fake_bind(library_path):
        kernel._lib = object()
        kernel._fn = lambda *args: 0

    monkeypatch.setattr(kernels.build, "build", fake_build)
    monkeypatch.setattr(kernel, "bind", fake_bind)

    def worker():
        gate.wait()
        for _ in range(50):
            kernel.launch()

    threads = [threading.Thread(target=worker) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["wfa_forward_backward"]]
    assert kernel.launches == 400
