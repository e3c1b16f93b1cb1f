"""Per-block tensorization of variant metadata for the native window
matcher: the window coordinates, allele blobs, and baseline quals are
constant across all reads of a block, so they are packed once and reused
for every read's native `hn_window_alleles` call."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from reference.core.variants import Variant, VariantType

_BASELINES = {
    VariantType.SNV: 80,
    VariantType.DELETION: 10,
    VariantType.INSERTION: 10,
    VariantType.INDEL: 10,
    VariantType.SV_DELETION: 20,
    VariantType.SV_INSERTION: 20,
    VariantType.TANDEM_REPEAT: 40,
}


@dataclass
class VariantPack:
    n: int
    pos: np.ndarray          # int64
    ref_len: np.ndarray      # int64
    prefix: np.ndarray       # int64
    postfix: np.ndarray      # int64
    python_only: np.ndarray  # bool — ignored or SV-deletion (host-handled)
    ignored: np.ndarray      # uint8 — is_ignored only (block realigner)
    blob: np.ndarray         # uint8 concatenated alleles
    a0_off: np.ndarray
    a0_len: np.ndarray
    a1_off: np.ndarray
    a1_len: np.ndarray
    baseline: np.ndarray     # int32
    vt_index: np.ndarray     # int32


def build_variant_pack(variant_calls: list[Variant]) -> VariantPack:
    n = len(variant_calls)
    pos = np.zeros(n, np.int64)
    ref_len = np.zeros(n, np.int64)
    prefix = np.zeros(n, np.int64)
    postfix = np.zeros(n, np.int64)
    python_only = np.zeros(n, bool)
    ignored = np.zeros(n, np.uint8)
    a0_off = np.zeros(n, np.int64)
    a0_len = np.zeros(n, np.int64)
    a1_off = np.zeros(n, np.int64)
    a1_len = np.zeros(n, np.int64)
    baseline = np.zeros(n, np.int32)
    vt_index = np.zeros(n, np.int32)
    chunks = []
    off = 0
    for i, v in enumerate(variant_calls):
        pos[i] = v.position
        ref_len[i] = v.ref_len
        prefix[i] = v.prefix_len
        postfix[i] = v.postfix_len
        python_only[i] = (v.is_ignored
                          or v.variant_type == VariantType.SV_DELETION)
        ignored[i] = v.is_ignored
        a0_off[i] = off
        a0_len[i] = len(v.allele0)
        chunks.append(v.allele0)
        off += len(v.allele0)
        a1_off[i] = off
        a1_len[i] = len(v.allele1)
        chunks.append(v.allele1)
        off += len(v.allele1)
        baseline[i] = _BASELINES.get(v.variant_type, 0)
        vt_index[i] = int(v.variant_type)
    blob = np.frombuffer(b"".join(chunks), dtype=np.uint8).copy() \
        if chunks else np.zeros(1, np.uint8)
    return VariantPack(n, pos, ref_len, prefix, postfix, python_only, ignored,
                       blob, a0_off, a0_len, a1_off, a1_len, baseline,
                       vt_index)
