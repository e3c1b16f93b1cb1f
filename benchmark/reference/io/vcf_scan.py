"""Per-chromosome one-pass VCF scan cache.

Decompresses a chromosome's record region once (threaded native inflate)
and parses every data line into dense arrays via ``hn_vcf_scan``. Three
consumers share the result instead of re-parsing records in Python:

  * the block generator's merge stream (positions / phasability / type /
    zygosity — ref: src/block_gen.rs:823-974),
  * the per-block variant loader (line slices -> Variant construction —
    ref: src/phaser.rs:27-323),
  * the ordered VCF writer's copy-transform (raw line bytes + per-sample
    genotype facts — ref: src/writers/ordered_vcf_writer.rs:291-434).

Records the native parser cannot classify carry ``vtype == -1`` (or
``zyg == -1`` per sample) and are re-parsed in Python on touch so error
messages and behavior stay identical to the pure-Python path.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from reference.core.variants import VariantType
from reference.io import native
from reference.io.vcf import VcfRecord

U64_MAX = 2**63 - 1

_PHASABLE_CODES = (
    int(VariantType.SNV), int(VariantType.INSERTION),
    int(VariantType.DELETION), int(VariantType.INDEL),
    int(VariantType.SV_INSERTION), int(VariantType.SV_DELETION),
    int(VariantType.TANDEM_REPEAT),
)


@dataclass
class ChromScan:
    """Scanned arrays for one (vcf, chromosome)."""

    chrom: str
    text: np.ndarray        # uint8 decompressed region containing the chrom
    line_off: np.ndarray    # int64 [n]
    line_len: np.ndarray    # int64 [n]
    pos: np.ndarray         # int64 [n] 0-based
    ref_len: np.ndarray     # int32 [n]
    ref_off: np.ndarray     # int64 [n] absolute offset of REF in text
    alt_off: np.ndarray     # int64 [n] absolute offset of the ALT string
    alt_len: np.ndarray     # int32 [n] length of the whole ALT string
    vtype: np.ndarray       # int8 [n]; -1 => Python re-parse
    zyg: np.ndarray         # int8 [n, S]; -1 => Python re-parse
    gt0: np.ndarray         # int16 [n, S]
    gt1: np.ndarray         # int16 [n, S]
    gt_phased: np.ndarray   # uint8 [n, S]
    ploidy: np.ndarray      # uint8 [n, S]
    gq: np.ndarray          # float32 [n, S]
    has_gq: np.ndarray      # uint8 [n, S]

    def ref_bytes(self, i: int) -> bytes:
        o = int(self.ref_off[i])
        return self.text[o:o + int(self.ref_len[i])].tobytes()

    def alleles(self, i: int) -> list[bytes]:
        """[REF] + ALTs, as VcfRecord.alleles() (ALT '.' -> no alts)."""
        o = int(self.alt_off[i])
        alt = self.text[o:o + int(self.alt_len[i])].tobytes()
        if alt == b".":
            return [self.ref_bytes(i)]
        return [self.ref_bytes(i)] + alt.split(b",")

    def line_bytes(self, i: int) -> bytes:
        o = int(self.line_off[i])
        return self.text[o:o + int(self.line_len[i])].tobytes()

    def record(self, i: int) -> VcfRecord:
        return VcfRecord.parse(self.line_bytes(i))

    def needs_python(self, i: int, sample_index: int) -> bool:
        return (self.vtype[i] == -1
                or self.zyg[i, sample_index] == -1)

    def phasable_mask(self, sample_index: int, min_quality: float,
                      hom_allowed: bool) -> np.ndarray:
        """Vectorized is_phasable_variant (ref: block_gen.rs:115-158).
        Rows needing Python re-parse are True so the consumer touches them
        (and raises exactly like the record path)."""
        z = self.zyg[:, sample_index]
        ok = (z == 1)
        if hom_allowed:
            ok |= (z == 2)
        gq_bad = (self.has_gq[:, sample_index] == 1) & \
            (self.gq[:, sample_index] < min_quality)
        ok &= ~gq_bad
        ok &= np.isin(self.vtype, _PHASABLE_CODES)
        ok |= (self.vtype == -1) | (z == -1)
        return ok


_cache_lock = threading.Lock()
_cache: dict[tuple[str, float, str], ChromScan] = {}
_CACHE_MAX = 4


def scan_chrom(path: str, chrom: str, n_samples: int) -> ChromScan | None:
    """Scan (and cache) one chromosome of a tabix-indexed bgzip VCF.
    Returns None when the native library is unavailable (callers use the
    streaming-record path instead)."""
    if not native.available():
        return None
    key = (os.path.abspath(path), os.path.getmtime(path), chrom)
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None and hit.zyg.shape[1] >= n_samples:
            return hit
    scan = _scan(path, chrom, n_samples)
    if scan is None:
        return None
    with _cache_lock:
        if len(_cache) >= _CACHE_MAX:
            _cache.pop(next(iter(_cache)))
        _cache[key] = scan
    return scan


def _scan(path: str, chrom: str, n_samples: int) -> ChromScan | None:
    from reference.io.vcf import VcfReader

    reader = VcfReader(path)
    if reader._bcf is not None:
        # binary BCF: synthesize the chromosome's text once and scan it
        lines = list(reader._bcf.fetch_lines(chrom, 0, U64_MAX))
        text = b"\n".join(lines) + (b"\n" if lines else b"")
        return _scan_text(np.frombuffer(text, dtype=np.uint8), chrom,
                          n_samples)
    if reader._index is None or not reader._is_bgzf:
        return None
    chunks = reader._index.query(chrom, 0, U64_MAX)
    empty = np.empty(0, dtype=np.int64)
    if not chunks:
        z = np.empty((0, n_samples), dtype=np.int8)
        return ChromScan(chrom, np.empty(0, dtype=np.uint8), empty, empty,
                         empty, np.empty(0, np.int32), empty, empty,
                         np.empty(0, np.int32), np.empty(0, np.int8),
                         z, z.astype(np.int16), z.astype(np.int16),
                         z.astype(np.uint8), z.astype(np.uint8),
                         z.astype(np.float32), z.astype(np.uint8))
    c0 = min(c for c, _ in chunks) >> 16
    u0 = min(c for c, _ in chunks) & 0xFFFF
    clast = max(e for _, e in chunks) >> 16
    import struct
    with open(path, "rb") as fh:
        fh.seek(clast + 16)
        head = fh.read(2)
        if len(head) < 2:
            return None
        bsize = struct.unpack("<H", head)[0] + 1
        fh.seek(c0)
        comp = fh.read(clast + bsize - c0)
    raw = native.bgzf_decompress_all_arr(comp, threads=2)
    if raw is None:
        return None
    return _scan_text(raw[u0:], chrom, n_samples)


def _scan_text(raw: np.ndarray, chrom: str, n_samples: int
               ) -> ChromScan | None:
    n_nl = int(np.count_nonzero(raw == 10)) + 1
    lib = native._load()
    import ctypes
    if not hasattr(lib.hn_vcf_scan, "_hn_ready"):
        lib.hn_vcf_scan.restype = ctypes.c_int64
        lib.hn_vcf_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32] + [ctypes.c_void_p] * 15 + \
            [ctypes.c_int64]
        lib.hn_vcf_scan._hn_ready = True
    S = max(n_samples, 1)
    cb = np.frombuffer(chrom.encode(), dtype=np.uint8)
    line_off = np.empty(n_nl, dtype=np.int64)
    line_len = np.empty(n_nl, dtype=np.int64)
    pos = np.empty(n_nl, dtype=np.int64)
    ref_len = np.empty(n_nl, dtype=np.int32)
    ref_off = np.empty(n_nl, dtype=np.int64)
    alt_off = np.empty(n_nl, dtype=np.int64)
    alt_len = np.empty(n_nl, dtype=np.int32)
    vtype = np.empty(n_nl, dtype=np.int8)
    zyg = np.empty((n_nl, S), dtype=np.int8)
    gt0 = np.empty((n_nl, S), dtype=np.int16)
    gt1 = np.empty((n_nl, S), dtype=np.int16)
    gt_phased = np.empty((n_nl, S), dtype=np.uint8)
    ploidy = np.empty((n_nl, S), dtype=np.uint8)
    gq = np.empty((n_nl, S), dtype=np.float32)
    has_gq = np.empty((n_nl, S), dtype=np.uint8)
    raw = np.ascontiguousarray(raw)
    n = lib.hn_vcf_scan(
        native._ptr(raw), len(raw), native._ptr(cb), len(cb), S,
        native._ptr(line_off), native._ptr(line_len), native._ptr(pos),
        native._ptr(ref_len), native._ptr(ref_off), native._ptr(alt_off),
        native._ptr(alt_len), native._ptr(vtype), native._ptr(zyg),
        native._ptr(gt0), native._ptr(gt1), native._ptr(gt_phased),
        native._ptr(ploidy), native._ptr(gq), native._ptr(has_gq), n_nl)
    if n < 0:
        return None
    n = int(n)
    return ChromScan(chrom, raw, line_off[:n], line_len[:n], pos[:n],
                     ref_len[:n], ref_off[:n], alt_off[:n], alt_len[:n],
                     vtype[:n], zyg[:n], gt0[:n], gt1[:n],
                     gt_phased[:n], ploidy[:n], gq[:n], has_gq[:n])
