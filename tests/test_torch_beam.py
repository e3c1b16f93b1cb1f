"""The torch port's beam (hiphase_tpu_torch.phasing.beam) against the JAX
package on the CPU: re-homed helpers, the tile step, the backtrace, a
mid-run hand-over of the beam state, the solver cases of test_solver.py,
and the permute_update semantics of scripts/pallas_permute.py.

Every comparison is of integers, so the tolerance is 0 (exact equality).
The port runs its plain PyTorch versions here because its tensors lie on
the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hiphase_tpu.phasing.beam as jbeam
from hiphase_tpu.phasing.astar import astar_solver
from hiphase_tpu_torch import kernels
from hiphase_tpu_torch.kernels import build
from hiphase_tpu_torch.phasing import beam as tbeam

from tests.test_solver import make_block

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _random_packed(rng, B, R, T):
    alleles = rng.choice(4, size=(B, R, T), p=[0.4, 0.4, 0.1, 0.1])
    quals = rng.integers(5, 60, size=(B, R, T)).astype(np.int32)
    quals[alleles >= 2] = 0
    resets = rng.random((B, R, T)) < 0.08
    skip = rng.random((B, T)) < 0.15
    packed = np.pad(jbeam.pack_inputs(alleles, quals, resets),
                    ((0, 0), (0, 0), (0, 1)), constant_values=jbeam.PACK_PAD)
    return packed, skip


# ---------------------------------------------------------------------------
# re-homed numpy helpers

@pytest.mark.parametrize("width", [64, 128, 1000, 1024, 2048, 2560, 4096,
                                   5056, 8192, 32768])
def test_width_helpers_match(width):
    assert tbeam.order_bits_for(width) == jbeam.order_bits_for(width)
    assert tbeam.max_hets_for(width) == jbeam.max_hets_for(width)


def test_constants_match():
    for name in ("BIG", "MAX_HETS", "QUAL_BITS", "QUAL_MASK", "PACK_PAD"):
        assert getattr(tbeam, name) == getattr(jbeam, name), name


def test_pack_and_unpack_helpers_match():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 4, size=(3, 8, 10)).astype(np.uint8)
    q = rng.integers(0, 161, size=(3, 8, 10)).astype(np.int32)
    r = rng.random((3, 8, 10)) < 0.2
    np.testing.assert_array_equal(tbeam.pack_inputs(a, q, r),
                                  jbeam.pack_inputs(a, q, r))
    stats = rng.integers(0, 50, size=(2 + 2 * 7, 5)).astype(np.int32)
    for got, want in zip(tbeam.unpack_job_stats(stats),
                         jbeam.unpack_job_stats(stats)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slotted", [False, True])
def test_tensorize_and_slots_match(slotted):
    rng = np.random.default_rng(7)
    variants, reads, _, _ = make_block(rng, 24, 30, window=8)
    variants[5].set_ignored()
    assert tbeam.assign_slots(reads) == jbeam.assign_slots(reads)
    rows = 32 if not slotted else jbeam.assign_slots(reads)[1]
    got = tbeam.tensorize_block(reads, variants, rows, 32, slotted=slotted)
    want = jbeam.tensorize_block(reads, variants, rows, 32, slotted=slotted)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# one tile and its backtrace

TILE_CASES = [  # (B, R, T, W, seed)
    (2, 8, 6, 64, 0),
    (3, 16, 12, 64, 1),
    (2, 24, 9, 128, 2),
    # wider than one CTA's shared memory held before; by column 8 the
    # frontier passes W, so pruning and discard_min are exercised
    (2, 8, 10, 5056, 4),
]


@pytest.mark.parametrize("B,R,T,W,seed", TILE_CASES)
def test_tile_and_backtrace_match_jax(B, R, T, W, seed):
    packed, skip = _random_packed(np.random.default_rng(seed), B, R, T)
    state = jbeam.beam_init_state(B, R, W)
    j_state, j_ys = jbeam.beam_tile_packed(state, packed, skip, beam_width=W)
    t_state, t_packed, t_skip = tbeam.carry_state_from_jax(state, packed,
                                                           skip, CPU)
    t_state, t_ys = tbeam.beam_tile_packed(t_state, t_packed, t_skip, W)
    for name, j, t in zip(("parents", "choices", "pruned", "discard_min"),
                          j_ys, t_ys):
        assert t.numpy().dtype == np.asarray(j).dtype, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    for name, j, t in zip(("delta", "cost", "hets", "valid"), j_state,
                          t_state):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)

    slot = np.zeros(B, dtype=np.int32)
    j_bt = jbeam.backtrace_tile(slot, j_ys[0], j_ys[1], skip)
    t_bt = tbeam.backtrace_tile(torch.from_numpy(slot), t_ys[0], t_ys[1],
                                t_skip)
    for name, j, t in zip(("slot", "h1", "h2"), j_bt, t_bt):
        assert t.numpy().dtype == np.asarray(j).dtype, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


@pytest.mark.parametrize("B,R,T,W,seed", TILE_CASES[:2])
def test_state_carried_from_jax_continues_identically(B, R, T, W, seed):
    """JAX runs the first tile; the torch port continues from its state and
    must match JAX continuing."""
    packed, skip = _random_packed(np.random.default_rng(10 + seed), B, R,
                                  2 * T)
    first_pk, second_pk = packed[:, :, :T + 1], packed[:, :, T:]
    first_sk, second_sk = skip[:, :T], skip[:, T:]
    mid, _ = jbeam.beam_tile_packed(jbeam.beam_init_state(B, R, W), first_pk,
                                    first_sk, beam_width=W)
    mid = tuple(np.asarray(x) for x in mid)
    j_state, j_ys = jbeam.beam_tile_packed(mid, second_pk, second_sk,
                                           beam_width=W)
    t_state, t_pk, t_sk = tbeam.carry_state_from_jax(mid, second_pk,
                                                     second_sk, CPU)
    t_state, t_ys = tbeam.beam_tile_packed(t_state, t_pk, t_sk, W)
    for j, t in zip(tuple(j_state) + tuple(j_ys), t_state + t_ys):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_wide_tile_prunes():
    """The W = 5056 tile case discards candidates (its discard_min is a
    real cost), so the comparison above covers the selection's cut."""
    B, R, T, W, seed = TILE_CASES[-1]
    packed, skip = _random_packed(np.random.default_rng(seed), B, R, T)
    _state, (_p, _c, pruned, dmin) = tbeam.beam_tile_packed(
        tbeam.beam_init_device(B, R, W, CPU), torch.from_numpy(packed),
        torch.from_numpy(skip), W)
    assert int(pruned.sum()) > 0
    assert bool((dmin < tbeam.BIG).any())


def test_tile_chain_equals_one_long_tile():
    """Chaining 4-column tiles over device-resident inputs equals one tile
    over every column (the lookahead column rides along)."""
    B, R, V, W = 2, 8, 12, 64
    packed, skip = _random_packed(np.random.default_rng(3), B, R, V)
    pk, sk = torch.from_numpy(packed), torch.from_numpy(skip)
    a_state, a_tr = tbeam.tiles_forward_packed(
        tbeam.beam_init_device(B, R, W, CPU), pk, sk, W, tile=4)
    b_state, b_tr = tbeam.beam_tile_packed(
        tbeam.beam_init_device(B, R, W, CPU), pk, sk, W)
    for a, b in zip(a_state + a_tr, b_state + b_tr):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the solver cases of tests/test_solver.py

def _bucket(n, q):
    return ((n + q - 1) // q) * q


def _solve_both(A, Q, S, W, resets=None):
    t = tbeam.solve_blocks(A, Q, S, beam_width=W, resets=resets, device=CPU)
    j = jbeam.solve_blocks(A, Q, S, beam_width=W, resets=resets)
    for name in ("h1", "h2", "cost", "num_hets", "pruned"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    return t


def _single(variants, reads, W, r_pad=None, v_pad=None):
    r_pad = r_pad or _bucket(len(reads), 16)
    v_pad = v_pad or _bucket(len(variants), 8)
    a, q, s = tbeam.tensorize_block(reads, variants, r_pad, v_pad)
    return _solve_both(a[None], q[None], s[None], W)


def _assert_astar(res, variants, reads):
    ref = astar_solver(0, variants, reads, 1000, 3)
    nv = len(variants)
    assert int(res.cost[0]) == ref.statistics.actual_cost
    assert [int(x) for x in res.h1[0][:nv]] == list(ref.haplotype_1)
    assert [int(x) for x in res.h2[0][:nv]] == list(ref.haplotype_2)


SOLVER_CASES = (
    [("perfect", 0, 8, 12, dict(flip_prob=0.0, amb_prob=0.0), 64)]
    + [("small", s, None, None, dict(flip_prob=0.15, amb_prob=0.1), 128)
       for s in range(8)]
    + [("windowed", 100 + s, 20, 24,
        dict(flip_prob=0.1, amb_prob=0.05, window=12), 256)
       for s in range(4)]
    + [("wide", 7, 10, 12, dict(flip_prob=0.15), 2560)])


@pytest.mark.parametrize("kind,seed,nv,nr,kw,width", SOLVER_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in SOLVER_CASES])
def test_solver_cases_match_jax_and_astar(kind, seed, nv, nr, kw, width):
    rng = np.random.default_rng(seed)
    if nv is None:
        nv, nr = int(rng.integers(3, 6)), int(rng.integers(4, 12))
    variants, reads, _, _ = make_block(rng, nv, nr, **kw)
    _assert_astar(_single(variants, reads, width), variants, reads)


def test_ignored_variants_and_hom_conversion():
    from hiphase_tpu.core.read_segments import ReadSegment
    from hiphase_tpu.core.variants import Variant
    rng = np.random.default_rng(3)
    variants, reads, _, _ = make_block(rng, 6, 8, flip_prob=0.0, amb_prob=0.0)
    variants[2].set_ignored()
    cleared = []
    for rs in reads:
        a, q = rs.to_padded(6)
        a[2], q[2] = 3, 0
        cleared.append(ReadSegment.new(rs.read_name, a, q))
    _assert_astar(_single(variants, cleared, 64), variants, cleared)

    hom_vars = [Variant.new_snv(0, 10 * (j + 1), b"A", b"C", 0, 1)
                for j in range(3)]
    hom_reads = [ReadSegment.new(f"r{i}", [0, i % 2, (i + 1) % 2],
                                 [40, 40, 40]) for i in range(6)]
    _assert_astar(_single(hom_vars, hom_reads, 64), hom_vars, hom_reads)


def test_padding_invariance_and_batched_blocks():
    rng = np.random.default_rng(5)
    variants, reads, _, _ = make_block(rng, 7, 9, flip_prob=0.1)
    base = _single(variants, reads, 64)
    padded = _single(variants, reads, 64, r_pad=16, v_pad=12)
    assert int(base.cost[0]) == int(padded.cost[0])
    assert list(base.h1[0][:7]) == list(padded.h1[0][:7])

    rng = np.random.default_rng(9)
    blocks = [make_block(rng, 6, 8, flip_prob=0.1)[:2] for _ in range(3)]
    arrs = [tbeam.tensorize_block(r, v, 8, 6) for v, r in blocks]
    batch = _solve_both(np.stack([a for a, _, _ in arrs]),
                        np.stack([q for _, q, _ in arrs]),
                        np.stack([s for _, _, s in arrs]), 64)
    for i, (v, r) in enumerate(blocks):
        single = _single(v, r, 64, r_pad=8, v_pad=6)
        assert list(batch.h1[i]) == list(single.h1[0])
        assert int(batch.cost[i]) == int(single.cost[0])


@pytest.mark.parametrize("seed", [200, 201])
def test_slotted_matches_dense(seed):
    rng = np.random.default_rng(seed)
    variants, reads, _, _ = make_block(rng, 24, 30, flip_prob=0.12,
                                       amb_prob=0.05, window=8)
    dense = tbeam.tensorize_block(reads, variants, 32, 24)
    r_dense = _solve_both(dense[0][None], dense[1][None], dense[2][None], 64)
    _slots, n_slots = tbeam.assign_slots(reads)
    assert n_slots < len(reads)
    al, qu, sk, rs = tbeam.tensorize_block(reads, variants,
                                           16 if n_slots <= 16 else 32, 24,
                                           slotted=True)
    r_slot = _solve_both(al[None], qu[None], sk[None], 64, resets=rs[None])
    assert int(r_slot.cost[0]) == int(r_dense.cost[0])
    assert list(r_slot.h1[0]) == list(r_dense.h1[0])
    assert list(r_slot.h2[0]) == list(r_dense.h2[0])


def test_slotted_with_ignored_and_reset_collision():
    from hiphase_tpu.core.read_segments import ReadSegment
    rng = np.random.default_rng(300)
    variants, reads, _, _ = make_block(rng, 16, 20, flip_prob=0.1, window=5)
    variants[8].set_ignored()
    cleared = []
    for r in reads:
        a, q = r.to_padded(16)
        a[8], q[8] = 3, 0
        cleared.append(ReadSegment.new(r.read_name, a, q))
    cleared = [r for r in cleared if r.get_num_set() > 0]
    dense = tbeam.tensorize_block(cleared, variants, 32, 16)
    r_dense = _solve_both(dense[0][None], dense[1][None], dense[2][None], 64)
    al, qu, sk, rs = tbeam.tensorize_block(cleared, variants, 16, 16,
                                           slotted=True)
    r_slot = _solve_both(al[None], qu[None], sk[None], 64, resets=rs[None])
    assert int(r_slot.cost[0]) == int(r_dense.cost[0])
    assert list(r_slot.h1[0]) == list(r_dense.h1[0])


# ---------------------------------------------------------------------------
# permute_update: scripts/pallas_permute.py's reference, restated (the
# script parses its command line when imported)

def _pallas_reference(delta, idx, sgn, e0, rn):
    bidx = np.arange(delta.shape[0])[:, None]
    out = delta[bidx, idx] + sgn[:, :, None] * e0[:, None, :]
    return np.where(rn[:, None, :] != 0, 0, out)


@pytest.mark.parametrize("B,W,R,bound", [(2, 64, 16, 3000),
                                         (3, 128, 8, 1 << 20)])
def test_permute_update_matches_pallas_reference(B, W, R, bound):
    """Beyond the TPU kernel's |δ| < 2^15 limit too (the second case)."""
    rng = np.random.default_rng(B)
    delta = rng.integers(-bound, bound, (B, W, R)).astype(np.int32)
    idx = rng.integers(0, W, (B, W)).astype(np.int16)
    sgn = rng.integers(-1, 2, (B, W)).astype(np.int32)
    e0 = rng.integers(-160, 161, (B, R)).astype(np.int32)
    rn = (rng.random((B, R)) < 0.05).astype(np.int32)
    out = torch.empty((B, W, R), dtype=torch.int32)
    got = tbeam.permute_update(*(torch.from_numpy(x) for x in
                                 (delta, idx, sgn, e0, rn)), out=out)
    np.testing.assert_array_equal(got.numpy(),
                                  _pallas_reference(delta, idx, sgn, e0, rn))


# ---------------------------------------------------------------------------
# no hidden fallback in the kernel layer

def test_kernel_build_without_nvcc_raises(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(build.KernelBuildError):
        build.nvcc()


def test_failed_launch_raises_and_is_not_counted():
    k = kernels.Kernel("backtrace", "test", [])

    class FakeLib:
        @staticmethod
        def hp_error_string(code):
            return b"invalid configuration argument"

    k._lib, k._fn = FakeLib(), lambda *args: 9
    with pytest.raises(kernels.KernelLaunchError, match="invalid config"):
        k.launch()
    assert k.launches == 0
    k._fn = lambda *args: 0
    k.launch()
    assert k.launches == 1


@pytest.mark.parametrize("B,R", [(64, 128), (16, 512), (8, 1024)])
def test_beam_select_plan_takes_every_padded_width(B, R):
    """Every width the orchestrator pads to (multiples of 64 up to the int16
    trace's 32768) gets a cluster that splits the row evenly and fits in
    shared memory; batch·C reaches the CTAs a launch aims for unless C is
    the largest size."""
    for W in range(64, kernels.MAX_BEAM_WIDTH + 1, 64):
        plan = kernels.beam_select_plan(B, W, R)
        C = plan.cluster
        assert C in (1, 2, 4, 8, 16), (W, plan)
        assert W % C == 0 and C * (W // C) == W, (W, plan)
        assert plan.smem <= kernels.MAX_DYNAMIC_SMEM, (W, plan)
        assert 8 * 4 * (W // C) + 4 * R <= plan.smem, (W, plan)
        assert plan.sample >= 1 and plan.sample & (plan.sample - 1) == 0
        assert plan.threads % 32 == 0 and plan.threads <= 1024, (W, plan)
        assert (B * C >= kernels.BEAM_SELECT_CTAS
                or C == max(kernels.BEAM_CLUSTER_SIZES)), (W, plan)


def test_beam_select_plan_refuses_widths_past_the_int16_trace():
    with pytest.raises(ValueError, match="int16"):
        kernels.beam_select_plan(8, kernels.MAX_BEAM_WIDTH + 64, 1024)


def _up16(n):
    return (n + 15) // 16 * 16


@pytest.mark.parametrize("B,V", [(64, 1280), (16, 384), (8, 1), (4, 3)])
def test_backtrace_plan_fits_a_ring_at_every_width(B, V):
    """Every width beam_select takes (the padded multiples of 64 up to the
    int16 trace's 32768, and solve_block's unpadded 200, 256 and 1000) gets
    a ring that fits in shared memory: at least one stage, no more than
    the V columns need, as many as fit, and at least
    BACKTRACE_MIN_STAGES where a stage holds more than one column; a
    column holds the 16-byte-aligned span around a row's parents slice at
    any offset. The direct chain takes the widths past the crossover: above
    8192 at B = 64, above 16384 at the smaller buckets."""
    cap = kernels.MAX_DYNAMIC_SMEM
    for W in [200, 256, 1000] + list(range(64, kernels.MAX_BEAM_WIDTH + 1,
                                           64)):
        plan = kernels.backtrace_plan(B, W, V)
        col = kernels.backtrace_column_bytes(W)
        per = plan.cols * col + 16
        need = -(-V // plan.cols)
        assert plan.cols in kernels.BACKTRACE_STAGE_COLUMNS, (W, plan)
        assert 1 <= plan.stages <= need, (W, plan)
        assert plan.smem == plan.stages * per <= cap, (W, plan)
        assert plan.stages == need or (plan.stages + 1) * per > cap
        assert (plan.cols == 1
                or cap // per >= kernels.BACKTRACE_MIN_STAGES), (W, plan)
        assert max(_up16(r + 2 * W) for r in range(0, 16, 2)) <= col, W
        stream = (W <= kernels.BACKTRACE_STREAM_MAX_WIDTH
                  and B * W <= kernels.BACKTRACE_STREAM_MAX_ROW_SUM)
        assert plan.branch == ("stream" if stream else "direct"), (W, plan)
    assert kernels.backtrace_plan(B, kernels.MAX_BEAM_WIDTH, V).stages >= \
        min(2, V)
    assert kernels.backtrace_plan(B, 8192, V).branch == "stream"
    assert kernels.backtrace_plan(B, 32768, V).branch == "direct"


def test_backtrace_plan_refuses_widths_past_the_int16_trace():
    with pytest.raises(ValueError, match="int16"):
        kernels.backtrace_plan(8, kernels.MAX_BEAM_WIDTH + 1, 384)


@pytest.mark.parametrize("W", [200, 1000, 8192, 32768])
def test_backtrace_plan_of_an_unaligned_trace_takes_the_direct_chain(W):
    """A parents trace whose base is not 16-byte aligned cannot feed the
    walk's bulk copies: the plan gives the direct chain, the ring as it
    would be otherwise."""
    plan = kernels.backtrace_plan(8, W, 384)
    unaligned = kernels.backtrace_plan(8, W, 384, aligned=False)
    assert unaligned == dataclasses.replace(plan, branch="direct")


def test_backtrace_branch_needs_a_cuda_device():
    """The launcher that a forced branch goes through refuses CPU tensors:
    on the CPU only backtrace_tile runs, through the plain version."""
    T, B, W = 3, 2, 64
    plan = kernels.backtrace_plan(B, W, T)
    with pytest.raises(ValueError, match="launches the kernel"):
        tbeam._backtrace_launch(plan, torch.zeros(B, dtype=torch.int32),
                                torch.zeros((T, B, W), dtype=torch.int16),
                                torch.zeros((T, B, W), dtype=torch.int8),
                                torch.zeros((B, T), dtype=torch.bool))
