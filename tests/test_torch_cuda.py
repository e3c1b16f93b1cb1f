"""The CUDA kernels against the plain versions run on the CPU, on a CUDA
card. These tests need the card and nvcc, and skip elsewhere:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(from the repository's root, which must be on sys.path: the WFA test
takes its graphs from chip_smoke.py)
"""

import dataclasses

import numpy as np
import pytest
import torch

from hiphase_tpu_torch import kernels
from hiphase_tpu_torch.phasing import beam

CPU = torch.device("cpu")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(B, R, V, seed):
    rng = np.random.default_rng(seed)
    alleles = rng.choice(4, size=(B, R, V), p=[0.4, 0.4, 0.1, 0.1])
    quals = rng.integers(5, 60, size=(B, R, V)).astype(np.int32)
    quals[alleles >= 2] = 0
    packed = np.pad(beam.pack_inputs(alleles, quals,
                                     rng.random((B, R, V)) < 0.05),
                    ((0, 0), (0, 0), (0, 1)), constant_values=beam.PACK_PAD)
    return torch.from_numpy(packed), torch.from_numpy(rng.random((B, V))
                                                      < 0.1)


@pytest.mark.parametrize("B,R,V,W", [(4, 32, 40, 64), (3, 130, 20, 256),
                                     (2, 128, 16, 2560), (2, 128, 16, 5056),
                                     (1, 64, 12, 32768), (8, 1024, 8, 1024)])
def test_tile_chain_and_backtrace_on_card_match_cpu(cuda, B, R, V, W):
    """One beam_select launch a column, whatever the cluster size
    (kernels.beam_select_plan: the largest, 8 CTAs a row, for the last
    three)."""
    packed, skip = _inputs(B, R, V, seed=B + W)
    before = kernels.launch_counts()
    results = []
    for dev in (CPU, cuda):
        state, traces = beam.tiles_forward_packed(
            beam.beam_init_device(B, R, W, dev), packed.to(dev),
            skip.to(dev), W, tile=16)
        slot = torch.zeros(B, dtype=torch.int32, device=dev)
        bt = beam.backtrace_tile(slot, traces[0], traces[1], skip.to(dev))
        results.append([t.cpu() for t in state + traces + bt])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    after = kernels.launch_counts()
    assert after["beam_select"] - before["beam_select"] == V
    assert after["permute_update"] - before["permute_update"] == V
    assert after["backtrace"] - before["backtrace"] == 1


def _random_trace(B, V, W, seed):
    """A seeded trace as beam_select leaves it (parents in [0, W), choices
    in [0, 4)), ~10 % skipped columns and a carried slot in [0, W)."""
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, W, B).astype(np.int32)),
            torch.from_numpy(rng.integers(0, W, (V, B, W)).astype(np.int16)),
            torch.from_numpy(rng.integers(0, 4, (V, B, W)).astype(np.int8)),
            torch.from_numpy(rng.random((B, V)) < 0.1))


@pytest.mark.parametrize("branch", ["stream", "direct"])
@pytest.mark.parametrize("B,V,W", [
    (8, 1, 1000), (64, 3, 200), (64, 1280, 1000), (8, 1280, 200),
    (64, 384, 1024), (8, 385, 8192), (4, 40, 32768),
    # slices at odd offsets, and tensors whose last slices end past their
    # last 16-byte boundary
    (3, 70, 999), (5, 37, 13)])
def test_backtrace_on_card_matches_plain(cuda, B, V, W, branch):
    """Both branches of the kernel against backtrace_plain on the CPU: a
    single column, fewer columns than the ring holds, rings that wrap many
    times (80 stages of 16 columns through a ring of 7 at V = 1280 and
    W = 1000, 40 columns through 3 stages at W = 32768), and widths whose
    slices are not 16-byte aligned."""
    slot, parents, choices, skip = _random_trace(B, V, W, seed=B * V + W)
    want = beam.backtrace_plain(slot, parents, choices, skip)
    args = [t.to(cuda) for t in (slot, parents, choices, skip)]
    before = kernels.launch_counts()["backtrace"]
    plan = kernels.backtrace_plan(B, W, V)
    got = beam._backtrace_launch(dataclasses.replace(plan, branch=branch),
                                 *args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["backtrace"] - before == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    if branch == plan.branch:
        got = beam.backtrace_tile(*args)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert kernels.launch_counts()["backtrace"] - before == 2


def test_backtrace_of_unaligned_trace_views_takes_the_direct_chain(cuda):
    """Trace views whose base is not 16-byte aligned cannot feed the bulk
    copies: backtrace_tile walks them through the direct chain."""
    B, V, W = 3, 9, 100
    slot, parents, choices, skip = _random_trace(B, V + 1, W, seed=5)
    parents, choices = parents.to(cuda)[1:], choices.to(cuda)[1:]
    assert parents.data_ptr() % 16
    skip = skip[:, 1:].contiguous()
    plan = kernels.backtrace_plan(B, W, V)
    assert plan.branch == "stream"
    assert kernels.backtrace_plan(B, W, V, aligned=False) == \
        dataclasses.replace(plan, branch="direct")
    with pytest.raises(kernels.KernelLaunchError):
        beam._backtrace_launch(plan, slot.to(cuda), parents, choices,
                               skip.to(cuda))
    got = beam.backtrace_tile(slot.to(cuda), parents, choices, skip.to(cuda))
    want = beam.backtrace_plain(slot, parents.cpu(), choices.cpu(), skip)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_beam_select_past_the_int16_trace_raises(cuda):
    B, R, V, W = 1, 32, 2, kernels.MAX_BEAM_WIDTH + 64
    packed, skip = _inputs(B, R, V, seed=0)
    state = beam.beam_init_device(B, R, W, cuda)
    traces = (torch.empty((V, B, W), dtype=torch.int16, device=cuda),
              torch.empty((V, B, W), dtype=torch.int8, device=cuda),
              torch.empty((V, B), dtype=torch.int32, device=cuda),
              torch.empty((V, B), dtype=torch.int32, device=cuda))
    scratch = (torch.empty((B, W), dtype=torch.int32, device=cuda),
               torch.empty((B, R), dtype=torch.int32, device=cuda),
               torch.empty((B, R), dtype=torch.int32, device=cuda))
    before = kernels.launch_counts()["beam_select"]
    with pytest.raises(ValueError, match="int16"):
        beam.beam_select(*state, packed.to(cuda), skip.to(cuda), 0, traces,
                         scratch)
    assert kernels.launch_counts()["beam_select"] == before


@pytest.mark.parametrize("H", [32, 128, 512])
def test_wfa_kernel_on_card_matches_cpu(cuda, H):
    """chip_smoke.py's seeded graph (SNV, empty reference and empty
    alternate branches, two-parent joins; a mutated, an empty and an
    out-of-band read) through the kernel and through its plain version."""
    import chip_smoke
    from hiphase_tpu_torch.align import wfa_device as wd
    graph, reads = chip_smoke.wfa_graph_case(H)
    _ga, host, kw = chip_smoke.wfa_inputs(graph, reads, CPU)
    before = kernels.launch_counts()["wfa_forward_backward"]
    got = wd.wfa_forward_backward(*(t.to(cuda) for t in host), H=H, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wfa_forward_backward"] - before == 1
    want = wd.wfa_forward_backward(*host, H=H, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def _seeded_pairs():
    import chip_smoke
    pairs = []
    for seed in (0, 1, 2, 3):
        graph, reads = chip_smoke.wfa_graph_case(seed, branches=2 + seed % 2)
        pairs += [(graph, r) for r in reads]
    return pairs


@pytest.mark.parametrize("H", [32, 128, 512])
def test_wfa_kernel_ragged_batch_on_card_matches_cpu(cuda, H):
    """chip_smoke.py's seeded graphs of two- and three-parent joins, each
    with its four reads, in one launch against the plain version on the
    CPU."""
    import chip_smoke
    pairs = _seeded_pairs()
    want = chip_smoke.WfaBatch(pairs, CPU).plain(H)
    batch = chip_smoke.WfaBatch(pairs, cuda)
    before = kernels.launch_counts()["wfa_forward_backward"]
    got = batch.kernel(H)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["wfa_forward_backward"] - before == 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b), H


@pytest.mark.parametrize("H", [32, 128, 512])
def test_wfa_ladder_in_memory_sized_groups_matches_one_launch(
        cuda, H, monkeypatch):
    """A rung whose scratch does not fit the free-memory budget is split
    into launch groups, each with its own scratch offsets (PairBatch.meta)
    and the batch's output indices: with a budget of two pairs' scratch the
    ragged batch takes one launch a group and gives the results of one
    launch, and of the plain version on the CPU."""
    from hiphase_tpu_torch.align import wfa_device as wd
    pairs = _seeded_pairs()

    def batch():
        return wd.PairBatch.of_pairs(pairs)
    want = wd.align_pairs_device(batch, CPU, h_ladder=(H,))
    one = wd.WfaCounters()
    assert wd.align_pairs_device(batch, cuda, h_ladder=(H,),
                                 counters=one) == want
    assert one.band_calls == 1
    need = batch().need_bytes(H)
    budget = 2 * int(need.max())
    groups = wd._launch_groups(need, budget)
    assert len(groups) >= 3
    # the ladder budgets half the free memory
    monkeypatch.setattr(wd, "_free_bytes", lambda dev: 2 * budget)
    split = wd.WfaCounters()
    before = kernels.launch_counts()["wfa_forward_backward"]
    got = wd.align_pairs_device(batch, cuda, h_ladder=(H,), counters=split)
    launches = kernels.launch_counts()["wfa_forward_backward"] - before
    assert got == want and any(r is not None for r in got)
    assert launches == split.band_calls == len(groups)
    assert split.pair_launches == len(pairs)
    assert split.max_pairs_per_launch == max(hi - lo for lo, hi in groups)


def _every_device(cuda):
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_entry_points_restore_the_callers_device(cuda):
    """beam_select, permute_update (one tile chain), backtrace and the WFA
    launch on each device and leave the calling thread's current device
    as they found it: the last device, so that a launch on any other one
    would have to give it back (on a one-card machine, a launch on the
    current device)."""
    import chip_smoke
    from hiphase_tpu_torch.align import wfa_device as wd
    devices = _every_device(cuda)
    last = devices[-1].index
    packed, skip = _inputs(2, 32, 6, seed=7)
    graph, reads = chip_smoke.wfa_graph_case(0)
    _ga, host, kw = chip_smoke.wfa_inputs(graph, reads, CPU)
    prev = torch.cuda.current_device()
    try:
        for dev in devices:
            torch.cuda.set_device(last)
            _state, traces = beam.tiles_forward_packed(
                beam.beam_init_device(2, 32, 64, dev), packed.to(dev),
                skip.to(dev), 64, tile=6)
            assert torch.cuda.current_device() == last, ("beam", dev)
            slot = torch.zeros(2, dtype=torch.int32, device=dev)
            beam.backtrace_tile(slot, traces[0], traces[1], skip.to(dev))
            assert torch.cuda.current_device() == last, ("backtrace", dev)
            wd.wfa_forward_backward(*(t.to(dev) for t in host), H=32, **kw)
            assert torch.cuda.current_device() == last, ("wfa", dev)
            torch.cuda.synchronize(dev)
    finally:
        torch.cuda.set_device(prev)


@pytest.fixture
def two_cuda(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return _every_device(cuda)


def test_beam_select_on_a_second_device_opts_in_there(two_cuda):
    """A plan above the 48 KB of shared memory that needs no opt-in, on
    cuda:0 and then on cuda:1: the opt-in is recorded per device, so the
    second device's launch opts in too and runs; both equal the plain
    version."""
    B, R, V, W = 2, 128, 4, 16384
    assert kernels.beam_select_plan(B, W, R).smem > 48 * 1024
    packed, skip = _inputs(B, R, V, seed=11)
    results = []
    for dev in (CPU, *two_cuda[:2]):
        state, traces = beam.tiles_forward_packed(
            beam.beam_init_device(B, R, W, dev), packed.to(dev),
            skip.to(dev), W, tile=V)
        results.append([t.cpu() for t in state + traces])
    for got in results[1:]:
        for a, b in zip(got, results[0]):
            assert torch.equal(a, b)


def test_sharded_solve_over_every_device_matches_one(two_cuda):
    from hiphase_tpu_torch.parallel import sharding
    rng = np.random.default_rng(5)
    n = len(two_cuda)
    B, R, V = 4 * n, 128, 40
    alleles = rng.choice(4, size=(B, R, V), p=[0.4, 0.4, 0.1, 0.1])
    quals = rng.integers(5, 60, size=(B, R, V)).astype(np.int32)
    quals[alleles >= 2] = 0
    skip = rng.random((B, V)) < 0.1
    got = sharding.solve_blocks_sharded(two_cuda, alleles, quals, skip,
                                        beam_width=1024, tile=16)
    want = sharding.solve_blocks_sharded(two_cuda[:1], alleles, quals, skip,
                                         beam_width=1024, tile=16)
    for a, b in zip(got[:5], want[:5]):
        assert np.array_equal(a, b)
    assert got[5] == want[5]
