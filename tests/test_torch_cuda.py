"""The CUDA kernels against the plain versions run on the CPU, on a CUDA
card. These tests need the card and nvcc, and skip elsewhere:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

(from the repository's root, which must be on sys.path: the WFA test
takes its graphs from chip_smoke.py)
"""

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
    want = wd.align_pairs_device(pairs, CPU, h_ladder=(H,))
    one = wd.WfaCounters()
    assert wd.align_pairs_device(pairs, cuda, h_ladder=(H,),
                                 counters=one) == want
    assert one.band_calls == 1
    need = wd.PairBatch([wd._linearized(g) for g, _r in pairs],
                        [r for _g, r in pairs],
                        list(range(len(pairs)))).need_bytes(H)
    budget = 2 * int(need.max())
    groups = wd._launch_groups(need, budget)
    assert len(groups) >= 3
    # the ladder budgets half the free memory
    monkeypatch.setattr(wd, "_free_bytes", lambda dev: 2 * budget)
    split = wd.WfaCounters()
    before = kernels.launch_counts()["wfa_forward_backward"]
    got = wd.align_pairs_device(pairs, cuda, h_ladder=(H,), counters=split)
    launches = kernels.launch_counts()["wfa_forward_backward"] - before
    assert got == want and any(r is not None for r in got)
    assert launches == split.band_calls == len(groups)
    assert split.pair_launches == len(pairs)
    assert split.max_pairs_per_launch == max(hi - lo for lo, hi in groups)
