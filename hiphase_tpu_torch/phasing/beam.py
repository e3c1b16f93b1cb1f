"""Lockstep beam diplotype solver — PyTorch counterpart of
``hiphase_tpu/phasing/beam.py``.

The search is the JAX package's: a fixed-width beam over variant columns,
ranked by (exact integer MEC cost, most hets, insertion order), with the
delta-cost state (δ = c1 − c2 per slot, plus the scalar total) documented
at ``hiphase_tpu.phasing.beam._step``. Results are bit-identical to it.

One beam column is two kernels on the card:

  beam_select     per batch row: unpack the column, the three min-sums over
                  δ, the 4W candidate keys, the exact selection of the W
                  smallest, and the trace column (parents, choices, pruned,
                  discard_min). Updates cost / hets / valid in place.
  permute_update  δ'[b,w,:] = δ[b, parent[b,w], :] + sgn[b,w]·e0[b,:],
                  zeroed on the slots whose read ends before the next
                  column. Writes the other of two δ buffers (ping-pong).

and the haplotype backtrace is a third, ``backtrace_tile``. Each of the
three has its plain PyTorch version in this module; the dispatching
function runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device (raising if it cannot).

Trace layout: where the JAX package keeps a list of per-tile
``[T, B, W]`` arrays, this module keeps one ``[V, B, W]`` array per trace
(the same bytes, tile after tile), so the backtrace walks a whole batch in
one launch.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from hiphase_tpu_torch import kernels

# Invalid-candidate sentinel for ranking keys; must exceed any legitimate
# block cost (see hiphase_tpu.phasing.beam.BIG).
BIG = 2_147_000_000


def order_bits_for(width: int) -> int:
    """Low bits reserved for the flat candidate index (slot·4 + choice)."""
    return max(2, (4 * width - 1).bit_length())


def max_hets_for(width: int) -> int:
    """Largest per-block het count the packed sort key can carry."""
    return (1 << (31 - order_bits_for(width))) - 1


MAX_HETS = max_hets_for(2048)

# Packed input layout, one int32 per (slot, column):
#   bits 0-15 qual, bits 16-17 allele (0/1 set, 2 ambiguous, 3 no overlap),
#   bit 18 reset (slot handoff before this column).
QUAL_BITS = 16
QUAL_MASK = (1 << QUAL_BITS) - 1
# packed value of a padding cell: allele 3 (no overlap), qual 0, no reset
PACK_PAD = 3 << QUAL_BITS


@dataclass
class BeamResult:
    h1: np.ndarray        # [B, V] uint8 alleles (0/1; 2 where skipped)
    h2: np.ndarray        # [B, V]
    cost: np.ndarray      # [B] int32 final MEC cost
    num_hets: np.ndarray  # [B] int32
    pruned: np.ndarray    # [B] int32; 0 ⇒ provably optimal


def pack_inputs(alleles: np.ndarray, quals: np.ndarray,
                resets: np.ndarray) -> np.ndarray:
    """Pack (alleles, quals, resets) into one int32 array (see layout)."""
    quals = np.asarray(quals)
    assert quals.size == 0 or int(quals.max()) <= QUAL_MASK
    return (quals.astype(np.int32)
            | (np.asarray(alleles).astype(np.int32) << QUAL_BITS)
            | (np.asarray(resets).astype(np.int32) << (QUAL_BITS + 2)))


# ---------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers.

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# beam_select: everything of one column up to the survivor selection.

def beam_select(delta, cost, hets, valid, packed, skip, col: int,
                traces, scratch) -> None:
    """Score and select one beam column.

    Args:
      delta: [B, W, R] int32 δ state (read only).
      cost, hets: [B, W] int32, valid: [B, W] bool — updated in place to
        the survivors' values.
      packed: [B, R, C] int32 packed inputs (`pack_inputs`); column ``col``
        is scored and column ``col + 1`` supplies the lookahead reset.
      skip: [B, V] bool; column ``col`` is read.
      traces: (parents [V', B, W] int16, choices [V', B, W] int8,
        pruned [V', B] int32, discard_min [V', B] int32); row ``col`` is
        written.
      scratch: (sgn [B, W] int32, e0 [B, R] int32, rn [B, R] int32),
        written for `permute_update`.
    """
    if delta.device.type == "cpu":
        beam_select_plain(delta, cost, hets, valid, packed, skip, col,
                          traces, scratch)
        return
    C, V, Vt = packed.shape[2], skip.shape[1], traces[0].shape[0]
    if not 0 <= col < min(V, Vt) or col + 1 >= C:
        raise ValueError(f"column {col} outside skip [.., {V}] / packed "
                         f"[.., {C}] (packed needs col + 1) / traces "
                         f"[{Vt}, ..]")
    _select_launcher(delta, cost, hets, valid, packed, skip, traces,
                     scratch)(delta.data_ptr(), col)


def _select_launcher(delta, cost, hets, valid, packed, skip, traces,
                     scratch):
    """Check beam_select's tensors on a CUDA device and plan its launch;
    returns ``launch(delta_ptr, col)``, which launches the kernel on a δ
    buffer of ``delta``'s shape with no further checks (the caller keeps
    ``col`` inside the tensors)."""
    B, W, R = delta.shape
    C, V = packed.shape[2], skip.shape[1]
    dev = delta.device
    parents, choices, pruned, dmin = traces
    sgn, e0, rn = scratch
    Vt = parents.shape[0]
    for name, t, dt, shape in (
            ("delta", delta, torch.int32, (B, W, R)),
            ("cost", cost, torch.int32, (B, W)),
            ("hets", hets, torch.int32, (B, W)),
            ("valid", valid, torch.bool, (B, W)),
            ("packed", packed, torch.int32, (B, R, C)),
            ("skip", skip, torch.bool, (B, V)),
            ("parents", parents, torch.int16, (Vt, B, W)),
            ("choices", choices, torch.int8, (Vt, B, W)),
            ("pruned", pruned, torch.int32, (Vt, B)),
            ("discard_min", dmin, torch.int32, (Vt, B)),
            ("sgn", sgn, torch.int32, (B, W)),
            ("e0", e0, torch.int32, (B, R)),
            ("rn", rn, torch.int32, (B, R))):
        _check(name, t, dt, shape, dev)
    plan = kernels.beam_select_plan(B, W, R)
    head = (cost.data_ptr(), hets.data_ptr(), valid.data_ptr(),
            packed.data_ptr(), skip.data_ptr(), B, W, R, C, V)
    tail = (order_bits_for(W), max_hets_for(W), BIG, plan.cluster,
            plan.threads, plan.sample, plan.smem, parents.data_ptr(),
            choices.data_ptr(), pruned.data_ptr(), dmin.data_ptr(),
            sgn.data_ptr(), e0.data_ptr(), rn.data_ptr(), dev.index,
            _stream(dev))
    launch = kernels.BEAM_SELECT.launch

    def select(delta_ptr: int, col: int) -> None:
        launch(delta_ptr, *head, col, *tail)
    return select


def beam_select_plain(delta, cost, hets, valid, packed, skip, col: int,
                      traces, scratch) -> None:
    """Plain PyTorch `beam_select` (hiphase_tpu.phasing.beam._step up to
    the selection, line for line)."""
    B, W, R = delta.shape
    i32 = torch.int32
    dev = delta.device
    column = packed[:, :, col]
    a_j = (column >> QUAL_BITS) & 3
    q_j = column & QUAL_MASK
    reset_next = (packed[:, :, col + 1] >> (QUAL_BITS + 2)) & 1
    sk = skip[:, col]

    qe = torch.where(sk[:, None], 0, q_j)
    q_if0 = torch.where(a_j == 0, qe, 0)
    q_if1 = torch.where(a_j == 1, qe, 0)
    e0 = q_if1 - q_if0
    sum_q0 = q_if0.sum(-1, dtype=i32)
    sum_q1 = q_if1.sum(-1, dtype=i32)
    D2 = torch.stack([sum_q0, sum_q1, sum_q1, sum_q0], dim=-1)    # [B, 4]

    m0 = delta.clamp(max=0).sum(-1, dtype=i32)
    mp = (delta + e0[:, None, :]).clamp(max=0).sum(-1, dtype=i32)
    mm = (delta - e0[:, None, :]).clamp(max=0).sum(-1, dtype=i32)
    base = cost - m0
    cand_cost = torch.stack([base + D2[:, 0:1] + mp, base + D2[:, 1:2] + mm,
                             base + D2[:, 2:3] + m0, base + D2[:, 3:4] + m0],
                            dim=-1)                                  # [B, W, 4]

    choice_ids = torch.arange(4, dtype=i32, device=dev)
    slot_ids = torch.arange(W, dtype=i32, device=dev)[:, None]
    het_inc = torch.where(sk[:, None, None], 0, 1 - (choice_ids >> 1))
    cand_hets = hets[:, :, None] + het_inc
    identical = hets == 0
    cand_valid = (valid[:, :, None]
                  & ~(identical[:, :, None] & (choice_ids == 1))
                  & (~sk[:, None, None] | (choice_ids == 0)))

    order_bits = order_bits_for(W)
    hets_cap = max_hets_for(W)
    order = slot_ids * 4 + choice_ids
    k_cost = torch.where(cand_valid, cand_cost, BIG).reshape(B, 4 * W)
    k_sec = ((hets_cap - cand_hets) << order_bits | order).reshape(B, 4 * W)
    # one exact sort on the int64 key (cost, sec); every sec is unique
    key = k_cost.to(torch.int64) * (1 << 32) + (k_sec.to(torch.int64)
                                                + (1 << 31))
    skey = torch.sort(key, dim=-1).values[:, :W + 1]
    sorted_cost = (skey >> 32).to(i32)
    sorted_sec = ((skey & 0xFFFFFFFF) - (1 << 31)).to(i32)

    sec = sorted_sec[:, :W]
    sel_flat = sec & ((1 << order_bits) - 1)
    sel_choice = sel_flat & 3
    parents, choices, pruned, dmin = traces
    sgn, e0_out, rn_out = scratch
    parents[col] = (sel_flat >> 2).to(torch.int16)
    choices[col] = sel_choice.to(torch.int8)
    n_valid = cand_valid.reshape(B, 4 * W).sum(-1, dtype=i32)
    pruned[col] = (n_valid - W).clamp(min=0)
    dmin[col] = sorted_cost[:, W]
    cost.copy_(sorted_cost[:, :W])
    hets.copy_(hets_cap - (sec >> order_bits))
    valid.copy_(sorted_cost[:, :W] < BIG)
    sgn.copy_(torch.where(sel_choice == 0, 1,
                          torch.where(sel_choice == 1, -1, 0)))
    e0_out.copy_(e0)
    rn_out.copy_(reset_next)


# ---------------------------------------------------------------------------
# permute_update: the survivor gather of δ (scripts/pallas_permute.py).

def permute_update(delta, idx, sgn, e0, rn, out) -> torch.Tensor:
    """out[b, w, :] = 0 where rn[b, :] else δ[b, idx[b, w], :] +
    sgn[b, w]·e0[b, :].

    delta / out [B, W, R] int32 (distinct buffers), idx [B, W] int16
    (the parents trace column), sgn [B, W] int32, e0 / rn [B, R] int32.
    """
    if delta.device.type == "cpu":
        return permute_update_plain(delta, idx, sgn, e0, rn, out)
    B, W, R = delta.shape
    for name, t, dt, shape in (
            ("idx", idx, torch.int16, (B, W)),
            ("out", out, torch.int32, (B, W, R))):
        _check(name, t, dt, shape, delta.device)
    if out.data_ptr() == delta.data_ptr():
        raise ValueError("permute_update cannot write δ in place")
    _permute_launcher(delta, sgn, e0, rn)(delta.data_ptr(), idx.data_ptr(),
                                          out.data_ptr())
    return out


def _permute_launcher(delta, sgn, e0, rn):
    """Check permute_update's tensors on a CUDA device; returns
    ``launch(delta_ptr, idx_ptr, out_ptr)``, which launches the kernel on
    buffers of ``delta``'s shape (idx [B, W] int16) with no further
    checks."""
    B, W, R = delta.shape
    dev = delta.device
    for name, t, dt, shape in (
            ("delta", delta, torch.int32, (B, W, R)),
            ("sgn", sgn, torch.int32, (B, W)),
            ("e0", e0, torch.int32, (B, R)),
            ("rn", rn, torch.int32, (B, R))):
        _check(name, t, dt, shape, dev)
    tail = (sgn.data_ptr(), e0.data_ptr(), rn.data_ptr())
    shape = (B, W, R, dev.index, _stream(dev))
    launch = kernels.PERMUTE_UPDATE.launch

    def permute(delta_ptr: int, idx_ptr: int, out_ptr: int) -> None:
        launch(delta_ptr, idx_ptr, *tail, out_ptr, *shape)
    return permute


def permute_update_plain(delta, idx, sgn, e0, rn, out) -> torch.Tensor:
    bidx = torch.arange(delta.shape[0], device=delta.device)[:, None]
    new = delta[bidx, idx.long()] + sgn[:, :, None] * e0[:, None, :]
    out.copy_(new.masked_fill_(rn[:, None, :] != 0, 0))
    return out


# ---------------------------------------------------------------------------
# backtrace_tile: the reverse scan over the trace.

def backtrace_tile(slot, parents, choices, skip):
    """Backtrace over T columns, newest to oldest.

    Args: slot [B] int32 (carried; zeros to start from the final argmin),
    parents [T, B, W] int16, choices [T, B, W] int8, skip [B, T] bool.
    Returns (slot [B] int32, h1 [T, B] uint8, h2 [T, B] uint8).
    """
    if slot.device.type == "cpu":
        return backtrace_plain(slot, parents, choices, skip)
    T, B, W = parents.shape
    plan = kernels.backtrace_plan(B, W, T,
                                  aligned=parents.data_ptr() % 16 == 0)
    return _backtrace_launch(plan, slot, parents, choices, skip)


def _backtrace_launch(plan, slot, parents, choices, skip):
    """`backtrace_tile` on a CUDA device through ``plan``'s branch, as
    given: a caller that compares the branches replaces it
    (``dataclasses.replace(plan, branch=...)``)."""
    T, B, W = parents.shape
    dev = slot.device
    if dev.type != "cuda":
        raise ValueError(f"_backtrace_launch launches the kernel; the "
                         f"tensors are on {dev}")
    for name, t, dt, shape in (
            ("slot", slot, torch.int32, (B,)),
            ("parents", parents, torch.int16, (T, B, W)),
            ("choices", choices, torch.int8, (T, B, W)),
            ("skip", skip, torch.bool, (B, T))):
        _check(name, t, dt, shape, dev)
    slot_out = torch.empty_like(slot)
    h1 = torch.empty((T, B), dtype=torch.uint8, device=dev)
    h2 = torch.empty((T, B), dtype=torch.uint8, device=dev)
    if T == 0 or B == 0:
        return slot_out.copy_(slot), h1, h2
    kernels.BACKTRACE.launch(
        slot.data_ptr(), parents.data_ptr(), choices.data_ptr(),
        skip.data_ptr(), T, B, W, kernels.BACKTRACE_BRANCHES[plan.branch],
        plan.stages, plan.cols, plan.smem, slot_out.data_ptr(),
        h1.data_ptr(), h2.data_ptr(), dev.index, _stream(dev))
    return slot_out, h1, h2


def backtrace_plain(slot, parents, choices, skip):
    T, B, _W = parents.shape
    bidx = torch.arange(B, device=slot.device)
    h1 = torch.empty((T, B), dtype=torch.uint8, device=slot.device)
    h2 = torch.empty_like(h1)
    s = slot.long()
    for j in range(T - 1, -1, -1):
        ch = choices[j, bidx, s].to(torch.int32)
        sk = skip[:, j]
        h1[j] = torch.where(sk, 2, ch & 1)
        h2[j] = torch.where(sk, 2, 1 - ((ch & 1) ^ (ch >> 1)))
        s = parents[j, bidx, s].long()
    return s.to(torch.int32), h1, h2


# ---------------------------------------------------------------------------
# Tile chain, state and stats.

def beam_init_device(batch: int, num_slots: int, beam_width: int,
                     device: torch.device):
    """Fresh beam state created on ``device``: (δ [B,W,R] int32,
    cost [B,W] int32, hets [B,W] int32, valid [B,W] bool; slot 0 valid)."""
    B, R, W = batch, num_slots, beam_width
    valid = torch.zeros((B, W), dtype=torch.bool, device=device)
    valid[:, 0] = True
    return (torch.zeros((B, W, R), dtype=torch.int32, device=device),
            torch.zeros((B, W), dtype=torch.int32, device=device),
            torch.zeros((B, W), dtype=torch.int32, device=device),
            valid)


def carry_state_from_jax(state, packed, skip, device: torch.device):
    """The JAX engine's beam state (δ, cost, hets, valid) and its packed
    inputs and skip array, given as numpy arrays, as this module's tensors
    on ``device``: ``(state, packed, skip)``. A run started in one engine
    continues in the other from here."""
    def put(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
    delta, cost, hets, valid = state
    return ((put(delta, np.int32), put(cost, np.int32), put(hets, np.int32),
             put(valid, np.bool_)),
            put(packed, np.int32), put(skip, np.bool_))


def tiles_forward_packed(state, packed_d, skip_d, beam_width: int,
                         tile: int):
    """Advance the beam over every column of ``skip_d`` ([B, V]), one
    ``tile``-column tile after another, on device-resident inputs. The
    tiles run back to back, one column at a time, so ``tile`` does not
    change the work.

    ``packed_d`` must carry V+1 columns (a trailing PACK_PAD column feeds
    the last column's lookahead reset). ``state`` is consumed: cost, hets
    and valid are updated in place and its δ buffer is reused.

    Returns (state, traces) with traces = (parents [V,B,W] int16,
    choices [V,B,W] int8, pruned [V,B] int32, discard_min [V,B] int32).
    """
    delta, cost, hets, valid = state
    B, W, R = delta.shape
    V = skip_d.shape[1]
    if W != beam_width:
        raise ValueError(f"state width {W} != beam_width {beam_width}")
    if packed_d.shape[2] != V + 1:
        raise ValueError(f"packed has {packed_d.shape[2]} columns, "
                         f"expected {V + 1}")
    dev = delta.device
    traces = (torch.empty((V, B, W), dtype=torch.int16, device=dev),
              torch.empty((V, B, W), dtype=torch.int8, device=dev),
              torch.empty((V, B), dtype=torch.int32, device=dev),
              torch.empty((V, B), dtype=torch.int32, device=dev))
    scratch = (torch.empty((B, W), dtype=torch.int32, device=dev),
               torch.empty((B, R), dtype=torch.int32, device=dev),
               torch.empty((B, R), dtype=torch.int32, device=dev))
    state, spare = (delta, cost, hets, valid), torch.empty_like(delta)
    if dev.type == "cpu":
        for col in range(V):
            state, spare = _step(state, spare, packed_d, skip_d, col, traces,
                                 scratch)
        return state, traces
    # on the card: the arguments are checked and the launches planned once
    # a chain, then two unchecked launches a column
    select = _select_launcher(delta, cost, hets, valid, packed_d, skip_d,
                              traces, scratch)
    permute = _permute_launcher(delta, *scratch)
    bufs = (delta.data_ptr(), spare.data_ptr())
    idx_ptr, idx_stride = traces[0].data_ptr(), 2 * B * W
    for col in range(V):
        src, dst = bufs[col & 1], bufs[1 - (col & 1)]
        select(src, col)
        permute(src, idx_ptr + col * idx_stride, dst)
    if V & 1:
        delta, spare = spare, delta
    return (delta, cost, hets, valid), traces


def _step(state, spare, packed, skip, col: int, traces, scratch):
    """One lockstep beam extension over column ``col``
    (hiphase_tpu.phasing.beam._step): select the survivors, then gather
    their δ rows into ``spare``. Returns (new state, the δ buffer that is
    free for the next column)."""
    delta, cost, hets, valid = state
    beam_select(delta, cost, hets, valid, packed, skip, col, traces, scratch)
    permute_update(delta, traces[0][col], *scratch, out=spare)
    return (spare, cost, hets, valid), delta


def beam_tile_packed(state, packed, skip, beam_width: int):
    """Advance the beam over one tile: packed [B, R, T+1], skip [B, T].
    Returns (state, (parents [T,B,W] i16, choices [T,B,W] i8,
    pruned [T,B] i32, discard_min [T,B] i32)); ``state`` is consumed."""
    return tiles_forward_packed(state, packed, skip, beam_width,
                                tile=skip.shape[1])


def tiles_backtrace_packed(traces, skip_d) -> torch.Tensor:
    """Device-side backtrace of a batch, packed as [2V, B] uint8 (h1 rows,
    then h2 rows) so it crosses to the host in one transfer."""
    slot = torch.zeros(skip_d.shape[0], dtype=torch.int32,
                       device=skip_d.device)
    _slot, h1, h2 = backtrace_tile(slot, traces[0], traces[1], skip_d)
    return torch.cat([h1, h2], dim=0)


def fetch_haplotypes(haps: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    packed = haps.cpu().numpy()
    V = packed.shape[0] // 2
    return packed[:V].T, packed[V:].T


def pack_job_stats(state, traces) -> torch.Tensor:
    """(cost, hets, pruned, discard_min) packed as one [2 + 2V, B] int32
    tensor, so materialization is a single transfer."""
    return torch.cat([state[1][:, 0][None], state[2][:, 0][None],
                      traces[2], traces[3]], dim=0)


def unpack_job_stats(packed: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side of `pack_job_stats`: returns (cost, hets, pruned).

    A discard at cost > the final cost can never have beaten or tied the
    result, so it doesn't spoil provable optimality."""
    cost = packed[0]
    hets = packed[1]
    Vp = (packed.shape[0] - 2) // 2
    cnt = packed[2:2 + Vp]
    dmin = packed[2 + Vp:]
    pruned = np.sum(cnt * (dmin <= cost[None, :]), axis=0).astype(np.int32)
    return cost, hets, pruned


def beam_solve_batch(alleles, quals, skip, beam_width: int = 256,
                     resets=None, tile: int | None = None, *,
                     device: torch.device):
    """Solve a padded batch of phase blocks on ``device``.

    Arguments as in ``hiphase_tpu.phasing.beam.beam_solve_batch``:
    alleles [B, R, V] uint8, quals [B, R, V] int32, skip [B, V] bool,
    resets [B, R, V] bool or None, tile columns per tile (None: one tile).
    Returns (h1, h2, cost, num_hets, pruned): the sharded solve
    (`parallel.sharding.solve_blocks_sharded`) over one device.
    """
    from hiphase_tpu_torch.parallel.sharding import solve_blocks_sharded
    return solve_blocks_sharded((device,), np.asarray(alleles),
                                np.asarray(quals), np.asarray(skip),
                                beam_width, resets, tile)[:5]


def solve_blocks(alleles: np.ndarray, quals: np.ndarray, skip: np.ndarray,
                 beam_width: int = 256, resets: np.ndarray | None = None,
                 tile: int | None = None, *,
                 device: torch.device) -> BeamResult:
    """Host wrapper: run the batch solver and materialize results."""
    return BeamResult(*beam_solve_batch(alleles, quals, skip,
                                        beam_width=beam_width, resets=resets,
                                        tile=tile, device=device))


def assign_slots(read_segments) -> tuple[list[int], int]:
    """Interval-allocate reads to reusable slots. Returns (slot per read,
    slot count). Reads ordered by start reuse the slot whose previous
    occupant ended earliest."""
    order = sorted(range(len(read_segments)),
                   key=lambda i: (read_segments[i].start, read_segments[i].end))
    slots = [0] * len(read_segments)
    free: list[tuple[int, int]] = []  # (end, slot)
    next_slot = 0
    for i in order:
        rs = read_segments[i]
        if free and free[0][0] <= rs.start:
            _, s = heapq.heappop(free)
        else:
            s = next_slot
            next_slot += 1
        slots[i] = s
        heapq.heappush(free, (rs.end, s))
    return slots, max(next_slot, 1)


def tensorize_block(read_segments, variants, num_reads_pad: int,
                    num_variants_pad: int, slotted: bool = False):
    """Pack one block's ReadSegments + Variants into padded arrays for
    `beam_solve_batch`.

    Dense mode (default): one row per read; returns (alleles [R,V] u8,
    quals [R,V] i32, skip [V] bool). Slotted mode: rows are reusable slots
    (``num_reads_pad`` ≥ the max concurrent reads) and resets [R,V] bool
    is returned as well.
    """
    R, V = num_reads_pad, num_variants_pad
    nv = len(variants)
    assert nv <= V
    alleles = np.full((R, V), 3, dtype=np.uint8)
    quals = np.zeros((R, V), dtype=np.int32)
    resets = np.zeros((R, V), dtype=bool)
    if slotted:
        slots, n_slots = assign_slots(read_segments)
        assert n_slots <= R, (n_slots, R)
        last_end = {}
        # slot-allocation order (by start), so the reset marks the handoff
        # between the slot's consecutive occupants
        order = sorted(range(len(read_segments)),
                       key=lambda i: (read_segments[i].start,
                                      read_segments[i].end))
        for i in order:
            rs = read_segments[i]
            s = slots[i]
            span = slice(rs.start, rs.end)
            alleles[s, span] = rs.alleles
            quals[s, span] = rs.quals
            prev = last_end.get(s)
            if prev is not None:
                assert prev <= rs.start
                resets[s, rs.start] = True  # fold before the new read enters
            last_end[s] = rs.end
    else:
        assert len(read_segments) <= R
        for i, rs in enumerate(read_segments):
            a, q = rs.to_padded(nv)
            alleles[i, :nv] = a
            quals[i, :nv] = q
    skip = np.ones(V, dtype=bool)
    for j, v in enumerate(variants):
        skip[j] = v.is_ignored
    # unset alleles must carry zero qual so they never contribute cost
    quals[(alleles >= 2)] = 0
    return (alleles, quals, skip, resets) if slotted else (alleles, quals, skip)
