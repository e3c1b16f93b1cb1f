"""Pairwise Levenshtein edit distance.

Host reference implementation of the reference's rolling-row DP
(ref: src/sequence_alignment.rs:7-38). The TPU build batches many short
allele-vs-observation comparisons at once through the vectorized
``edit_distance_batch``; `hiphase_tpu.ops.edit_distance_tpu` provides the
device kernel for large batches.
"""

from __future__ import annotations

import numpy as np


def edit_distance(v1: bytes, v2: bytes) -> int:
    """Full O(n·m) Levenshtein DP with two rolling rows."""
    if len(v1) == 0:
        return len(v2)
    if len(v2) == 0:
        return len(v1)
    a = np.frombuffer(bytes(v1), dtype=np.uint8)
    b = np.frombuffer(bytes(v2), dtype=np.uint8)
    # vectorized over the inner dimension; scan over the outer
    prev = np.arange(len(b) + 1, dtype=np.int32)
    curr = np.empty_like(prev)
    for i in range(1, len(a) + 1):
        curr[0] = i
        sub = prev[:-1] + (b != a[i - 1])
        dele = prev[1:] + 1
        m = np.minimum(sub, dele)
        # insertion needs a sequential min-scan: curr[j] = min(m[j], curr[j-1]+1),
        # which solves to curr[j] = min_{k<=j}(m[k] + j - k)
        ar = np.arange(len(b), dtype=np.int32)
        np.minimum.accumulate(m - ar, out=curr[1:])
        curr[1:] += ar
        prev, curr = curr, prev
    return int(prev[-1])


def edit_distance_batch(queries: np.ndarray, query_lens: np.ndarray,
                        targets: np.ndarray, target_lens: np.ndarray) -> np.ndarray:
    """Batched Levenshtein over padded uint8 arrays.

    queries: [B, Lq], targets: [B, Lt], lens give true lengths per row.
    Returns [B] int32 distances. Uses the native C++ kernel when built;
    otherwise a vectorized rolling-row formulation (the i-loop is over max
    query len, masked past each row's true length).
    """
    from reference.io import native
    out = native.edit_distance_batch_native(
        queries, np.asarray(query_lens, np.int32),
        targets, np.asarray(target_lens, np.int32))
    if out is not None:
        return out
    B, Lq = queries.shape
    _, Lt = targets.shape
    prev = np.broadcast_to(np.arange(Lt + 1, dtype=np.int32), (B, Lt + 1)).copy()
    tmask = np.arange(Lt, dtype=np.int32)[None, :] < target_lens[:, None]
    for i in range(1, Lq + 1):
        active = i <= query_lens  # [B]
        qc = queries[:, i - 1][:, None]  # [B,1]
        sub = prev[:, :-1] + ((targets != qc) | ~tmask)
        dele = prev[:, 1:] + 1
        m = np.minimum(sub, dele)
        curr = np.empty_like(prev)
        curr[:, 0] = i
        ar = np.arange(Lt, dtype=np.int32)
        run = np.minimum.accumulate(m - ar[None, :], axis=1)
        curr[:, 1:] = run + ar[None, :]
        prev = np.where(active[:, None], curr, prev)
    return prev[np.arange(B), target_lens]
