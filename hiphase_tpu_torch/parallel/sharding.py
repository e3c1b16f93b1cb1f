"""Data parallelism over the devices of one host — the counterpart of
``hiphase_tpu/parallel/sharding.py``.

The JAX package shards a padded block batch over a 1-D mesh ("data" axis)
with ``NamedSharding(mesh, P("data"))``, and XLA splits the tile program
over the batch axis. Here the split is written out: a padded batch of B
rows over N devices is N contiguous row chunks ``[k·B/N, (k+1)·B/N)`` (how
``P("data")`` splits the batch axis), and each chunk is two host→device
copies, the tile chain, the backtrace and the stats packing on its own
device's current stream. Blocks are independent, so no chunk waits for
another and there are no collectives; the host joins the chunks' results
in row order. A device may appear more than once: each entry is one chunk.

`dispatch_chunks` / `gather_chunks` are the one place the split is made;
`solve_blocks_sharded` (a library call, and over one device
`phasing.beam.beam_solve_batch`) and the production `BatchedDeviceSolver`
both use them. Multi-host: see
`hiphase_tpu_torch.parallel.multihost`.
"""

from __future__ import annotations

from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from hiphase_tpu_torch.device import resolve_devices
from hiphase_tpu_torch.phasing.beam import (
    PACK_PAD, beam_init_device, fetch_haplotypes, pack_inputs,
    pack_job_stats, tiles_backtrace_packed, tiles_forward_packed,
    unpack_job_stats,
)


def make_mesh(num_devices: int | None = None) -> tuple[torch.device, ...]:
    """The local CUDA devices, in order (all, or the first
    ``num_devices``): a 1-D "data" axis in one process, with no process
    group."""
    devices = resolve_devices(None)
    return devices if num_devices is None else devices[:num_devices]


def row_chunks(batch: int, n: int) -> list[slice]:
    """The contiguous row chunk of each of ``n`` devices."""
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by {n} devices")
    size = batch // n
    return [slice(k * size, (k + 1) * size) for k in range(n)]


@dataclass
class Chunk:
    """One device's rows of a dispatched batch; its tensors are still being
    computed on that device."""

    stats: torch.Tensor         # [2 + 2Vp, b] int32 (pack_job_stats)
    haps: torch.Tensor          # [2Vp, b] uint8 (h1 rows, then h2 rows)


def dispatch_chunks(devices: Sequence[torch.device], packed: np.ndarray,
                    skip: np.ndarray, width: int, tile: int) -> list[Chunk]:
    """Enqueue a padded batch (packed [B, R, Vp+1] int32, skip [B, Vp]
    bool) on ``devices``, one row chunk each, without waiting for any of
    them. The host arrays are pinned once when the devices are CUDA
    devices; each chunk's rows then cross in two asynchronous copies."""
    pk, sk = torch.from_numpy(packed), torch.from_numpy(skip)
    cuda = devices[0].type == "cuda"
    if cuda:
        pk, sk = pk.pin_memory(), sk.pin_memory()
    chunks = []
    for dev, rows in zip(devices, row_chunks(packed.shape[0], len(devices))):
        # the caching host allocator keeps a pinned block from being reused
        # until the copies that read it have completed
        packed_d = pk[rows].to(dev, non_blocking=cuda)
        skip_d = sk[rows].to(dev, non_blocking=cuda)
        state = beam_init_device(rows.stop - rows.start, packed.shape[1],
                                 width, dev)
        state, traces = tiles_forward_packed(state, packed_d, skip_d, width,
                                             tile)
        chunks.append(Chunk(pack_job_stats(state, traces),
                            tiles_backtrace_packed(traces, skip_d)))
    return chunks


def gather_chunks(chunks: list[Chunk]):
    """Wait for every chunk and join them in row order: (cost, hets,
    pruned) [B] and (h1, h2) [B, Vp] as host arrays; one stats and one
    haplotype copy a chunk."""
    stats = np.concatenate([c.stats.cpu().numpy() for c in chunks], axis=1)
    haps = torch.cat([c.haps.cpu() for c in chunks], dim=1)
    return unpack_job_stats(stats), fetch_haplotypes(haps)


def solve_blocks_sharded(devices: Sequence[torch.device], alleles: np.ndarray,
                         quals: np.ndarray, skip: np.ndarray,
                         beam_width: int = 256,
                         resets: np.ndarray | None = None,
                         tile: int | None = None):
    """Solve a padded batch of blocks data-parallel over ``devices``.

    The batch dimension must be divisible by the number of devices (pad
    with inert blocks: all-NoOverlap reads, skip all-true; see
    `pad_batch`). Returns (h1, h2, cost, hets, pruned, summary-dict) as
    host arrays.
    """
    n = len(devices)
    B, R, V = alleles.shape
    assert B % n == 0, f"batch {B} not divisible by mesh size {n}"
    resets = (np.zeros((B, R, V), dtype=bool) if resets is None
              else np.asarray(resets))

    T = V if tile is None else int(tile)
    Vp = ((V + T - 1) // T) * T if T > 0 else V
    if Vp > V:
        pad = ((0, 0), (0, 0), (0, Vp - V))
        alleles = np.pad(alleles, pad, constant_values=3)
        quals = np.pad(quals, pad)
        resets = np.pad(resets, pad)
        skip = np.pad(skip, ((0, 0), (0, Vp - V)), constant_values=True)

    packed = np.pad(pack_inputs(alleles, quals, resets),
                    ((0, 0), (0, 0), (0, 1)), constant_values=PACK_PAD)
    (cost, hets, pruned), (h1, h2) = gather_chunks(dispatch_chunks(
        devices, packed, np.ascontiguousarray(skip, dtype=bool), beam_width,
        max(T, 1)))
    h1, h2 = h1[:, :V], h2[:, :V]
    summary = {
        "total_cost": int(cost.sum()),
        "total_hets": int(hets.sum()),
        "total_pruned": int(pruned.sum()),
        "blocks": B,
    }
    return h1, h2, cost, hets, pruned, summary


def pad_batch(blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
              multiple: int):
    """Stack per-block (alleles, quals, skip) tuples and pad the batch
    dimension up to a multiple of the mesh size with inert blocks."""
    assert blocks
    R, V = blocks[0][0].shape
    B = len(blocks)
    pad = (-B) % multiple
    A = np.full((B + pad, R, V), 3, dtype=np.uint8)
    Q = np.zeros((B + pad, R, V), dtype=np.int32)
    S = np.ones((B + pad, V), dtype=bool)
    for i, (a, q, s) in enumerate(blocks):
        A[i], Q[i], S[i] = a, q, s
    return A, Q, S, B
