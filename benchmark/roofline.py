"""The least time the card could take for the beam kernels' work, from the
work the inputs need.

``bound`` and ``beam_bounds`` are frozen copies of ``chip_smoke.py``'s: the
larger of the bytes (each input read once, each output written once) over
the HBM bandwidth and the int32 operations over the int32 rate of the
published H100 SXM part. `block_bound_ms` applies them to one phase block:
its het columns, its (read, column) cells and the configured beam width,
so that padding, buckets or fusion in the program cannot move the count.
"""

from __future__ import annotations

# NVIDIA H100 SXM, published: 3.35 TB/s of HBM3; int32 on the CUDA cores,
# 132 SMs x 64 lanes x 1.98 GHz (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by of work that moves ``nbytes`` (each input read
    once, each output written once) and does ``ops`` int32 operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def beam_bounds(B: int, R: float, W: int, T: int) -> dict:
    """Bounds of one launch of each beam kernel at (B, R, W), T columns:
    beam_select reads δ [B, W, R] and two packed columns, rewrites cost,
    hets and valid, writes one trace row and the gather's scratch; it
    scores 4W candidates a row from three clamped sums over δ (8 operations
    an element) and selects W of them (8 a candidate). permute_update
    reads δ and writes the new δ, 3 operations an element. backtrace
    follows one path a row: T parent and choice entries and skip flags
    read, two haplotype bytes written a column, 8 operations a step."""
    return {
        "beam_select": bound(
            4 * B * W * R + 2 * 9 * B * W + 8 * B * R + B
            + 3 * B * W + 8 * B + 4 * B * W + 8 * B * R,
            8 * B * W * R + 8 * 4 * B * W),
        "permute_update": bound(8 * B * W * R + 6 * B * W + 8 * B * R,
                                3 * B * W * R),
        "backtrace": bound(3 * B * T + B * T + 8 * B + 2 * B * T, 8 * B * T),
    }


def block_bound_ms(kernel: str, num_variants: int, num_alleles: int,
                   width: int) -> float:
    """Least time of ``kernel`` over one block: one launch a het column,
    each over the block's mean number of reads a column (its (read,
    column) cells over its columns) at the configured width."""
    if num_variants <= 0:
        return 0.0
    per_column = beam_bounds(1, num_alleles / num_variants, width, 1)
    return num_variants * per_column[kernel]["bound_ms"]
