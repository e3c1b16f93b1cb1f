"""ctypes bindings for the native host library.

Two libraries, in this order: the committed ``native/libhiphase_native.so``
(built from ``native/hiphase_native.cc``; it links libdeflate), then the
port's own build of ``hiphase_tpu_torch/csrc/hiphase_native.cc``, which
`kernels.build.build_host_library` compiles with the system C++ compiler
at first use into ``hiphase_tpu_torch/build/`` (libdeflate, else zlib, else
no BGZF codec). When neither loads (no compiler, or it refused the source),
the compiler's error is logged once as a warning and every caller falls
back to its pure-Python implementation. ``HIPHASE_TPU_NO_NATIVE`` disables
both libraries.

Beside it, and at the same time, the port's own library: its C++ twins of
host loops, built from ``hiphase_tpu_torch/csrc/`` into one shared object
(`kernels.build.build_port_library`, `bind_port`), also when the committed
host library loads. It holds the A* oracle's heuristic sweep
(`astar_heuristic`), the device WFA's pass 1 (`wfa_windows`) and its window
packer (`wfa_pack_sizes`, `wfa_pack_write`). Where it does not build, one
warning, and the callers' Python paths: `phasing.astar` sweeps in Python,
dual mode's device WFA finds each read's window and builds and linearises
it in Python. ``HIPHASE_TPU_NO_NATIVE`` disables it too.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_PORT = None
_TRIED = False
_LOAD_LOCK = threading.Lock()
# what `_load` found: origin ("committed" or "built"), path, codec, the
# build's seconds, or the error that left the host layer in pure Python
LOADED: dict = {}
# and for the port's own library: path and the build's seconds, or the
# error
PORT_LOADED: dict = {}


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(arr.ctypes.data)


COMMITTED_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "native", "libhiphase_native.so"))


def bind(path) -> ctypes.CDLL:
    """Load the library at ``path`` and declare the signatures that every
    caller shares; raises OSError when it does not load."""
    lib = ctypes.CDLL(str(path))
    lib.hn_bgzf_compress_many.restype = ctypes.c_int64
    lib.hn_bgzf_compress_many.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int]
    lib.hn_bgzf_decompress_many.restype = ctypes.c_int32
    lib.hn_bgzf_decompress_many.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.hn_bgzf_scan.restype = ctypes.c_int64
    lib.hn_bgzf_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64]
    lib.hn_edit_distance_batch.restype = None
    lib.hn_edit_distance_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int]
    return lib


def codec_of(lib) -> str:
    """The BGZF codec a bound library was built with. The committed
    library predates ``hn_codec`` and links libdeflate."""
    from hiphase_tpu_torch.kernels.build import CODEC_NAMES
    if not hasattr(lib, "hn_codec"):
        return "libdeflate"
    lib.hn_codec.restype = ctypes.c_int32
    lib.hn_codec.argtypes = []
    return CODEC_NAMES[lib.hn_codec()]


def _load():
    global _LIB, _PORT, _TRIED
    if _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if not _TRIED:
            _LIB = _find_library()
            _PORT = _find_own()
            _TRIED = True
    return _LIB


def _find_library():
    if os.environ.get("HIPHASE_TPU_NO_NATIVE"):
        LOADED.update(origin=None, error="HIPHASE_TPU_NO_NATIVE is set")
        return None
    if os.path.exists(COMMITTED_PATH):
        try:
            lib = bind(COMMITTED_PATH)
        except OSError as e:
            logger.debug("%s does not load (%s); building the port's own "
                         "native host library", COMMITTED_PATH, e)
        else:
            LOADED.update(origin="committed", path=COMMITTED_PATH,
                          codec=codec_of(lib), build_seconds=0.0)
            return lib
    from hiphase_tpu_torch.kernels.build import (
        KernelBuildError, build_host_library)
    try:
        built = build_host_library()
        lib = bind(built.library)
    except (KernelBuildError, OSError) as e:
        logger.warning("The native host library is not available; the host "
                       "layer runs in pure Python. %s", e)
        LOADED.update(origin=None, error=str(e))
        return None
    LOADED.update(origin="built", path=str(built.library),
                  codec=codec_of(lib), build_seconds=built.seconds)
    return lib


def bind_port(path) -> ctypes.CDLL:
    """Load the port's own library at ``path`` and declare its entry
    points' signatures; raises OSError when it does not load."""
    lib = ctypes.CDLL(str(path))
    lib.hn_astar_heuristic.restype = ctypes.c_int32
    lib.hn_astar_heuristic.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.hn_wfa_windows.restype = ctypes.c_int64
    lib.hn_wfa_windows.argtypes = (
        [ctypes.c_int64] + [ctypes.c_void_p] * 5 + [ctypes.c_int64]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p])
    lib.hn_wfa_pack_windows.restype = ctypes.c_int64
    lib.hn_wfa_pack_windows.argtypes = (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        + [ctypes.c_void_p] * 9
        + [ctypes.c_int64] + [ctypes.c_void_p] * 5
        + [ctypes.c_int64] + [ctypes.c_void_p] * 9)
    return lib


def _find_own():
    """The port's own library (no committed copy): built, or found in the
    cache, and bound; None, with one warning, when it is not."""
    from hiphase_tpu_torch.kernels.build import (
        KernelBuildError, build_port_library)
    if os.environ.get("HIPHASE_TPU_NO_NATIVE"):
        PORT_LOADED.update(path=None, error="HIPHASE_TPU_NO_NATIVE is set")
        return None
    try:
        built = build_port_library()
        lib = bind_port(built.library)
    except (KernelBuildError, OSError) as e:
        logger.warning("The port's own native library is not available; the "
                       "estimated-cost sweep runs in Python, the device "
                       "WFA's pass 1 finds each read's window in Python, "
                       "and the windows are built and linearised in Python. "
                       "%s", e)
        PORT_LOADED.update(path=None, error=str(e))
        return None
    PORT_LOADED.update(path=str(built.library), build_seconds=built.seconds)
    return lib


def available() -> bool:
    return _load() is not None


def port_available() -> bool:
    _load()
    return _PORT is not None


_INT64 = range(-2 ** 63, 2 ** 63)


def astar_heuristic(nv: int, max_segment_size: int, seg_start, seg_end,
                    seg_off, alleles, quals, ignored, min_queue_size: int,
                    queue_increment: int):
    """The A* oracle's heuristic sweep over one block in C++ (see
    hn_astar_heuristic in csrc/astar_sweep.cc; the call releases the
    interpreter lock). Read r covers columns [seg_start[r], seg_end[r]) and
    its alleles and quals there start at seg_off[r]. Returns (H[0..nv]
    int64, bad_variants bool), or None when the library is not bound, an
    input is out of range or one of the Python sweep's assertions would
    fail."""
    _load()
    lib = _PORT
    if (lib is None or min_queue_size not in _INT64
            or queue_increment not in _INT64 or max_segment_size >= 2 ** 31):
        return None
    seg_start = np.ascontiguousarray(seg_start, dtype=np.int32)
    seg_end = np.ascontiguousarray(seg_end, dtype=np.int32)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    alleles = np.ascontiguousarray(alleles, dtype=np.uint8)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    ignored = np.ascontiguousarray(ignored, dtype=np.uint8)
    n = len(seg_start)
    if (len(seg_end) != n or len(seg_off) != n + 1 or len(ignored) != nv
            or (n and (seg_off[0] < 0 or seg_off[-1] > min(len(alleles),
                                                          len(quals))))):
        return None
    heuristics = np.empty(nv + 1, dtype=np.int64)
    bad = np.empty(nv, dtype=np.uint8)
    rc = lib.hn_astar_heuristic(
        nv, max_segment_size, n, _ptr(seg_start), _ptr(seg_end),
        _ptr(seg_off), _ptr(alleles), _ptr(quals), _ptr(ignored),
        min_queue_size, queue_increment, _ptr(heuristics), _ptr(bad))
    if rc != 0:
        return None
    return heuristics, bad.astype(bool)


def wfa_windows(chunks, het_pos):
    """Pass 1 of the device WFA over a block's reads in C++ (hn_wfa_windows
    in csrc/wfa_windows.cc; the call releases the interpreter lock):
    ``chunks`` are `io.bam.BamReader.fetch_raw`'s (buf, rec_off, rec_size)
    of the block's BAMs in order, ``het_pos`` the block's het positions.
    Returns (has_window [n] bool, ref_start, ref_end, read_blob, read_off)
    for the n records in order, read k's window [ref_start[k], ref_end[k])
    and its aligned bases read_blob[read_off[k]:read_off[k + 1]] (empty
    where it has no window); or None when the library is not bound or the
    call refuses the block (global_realign's Python pass 1 then runs)."""
    _load()
    lib = _PORT
    if lib is None:
        return None
    bufs = [np.ascontiguousarray(b, dtype=np.uint8) for b, _o, _s in chunks]
    rec_off = np.concatenate(
        [np.zeros(0, np.int64)] + [o for _b, o, _s in chunks]).astype(np.int64)
    rec_size = np.concatenate(
        [np.zeros(0, np.int64)] + [s for _b, _o, s in chunks]).astype(np.int64)
    chunk_ptr = np.array([b.ctypes.data for b in bufs], np.uint64)
    chunk_len = np.array([len(b) for b in bufs], np.int64)
    chunk_first = np.cumsum([0] + [len(o) for _b, o, _s in chunks],
                            dtype=np.int64)
    n = len(rec_off)
    het_pos = np.ascontiguousarray(het_pos, dtype=np.int64)
    has_window = np.zeros(n, np.uint8)
    ref_start = np.zeros(n, np.int64)
    ref_end = np.zeros(n, np.int64)
    read_off = np.zeros(n + 1, np.int64)
    # the aligned bases of a read are fewer than its record's bytes
    read_blob = np.empty(int(rec_size.sum()), np.uint8)
    rc = lib.hn_wfa_windows(
        len(bufs), _ptr(chunk_ptr), _ptr(chunk_len), _ptr(chunk_first),
        _ptr(rec_off), _ptr(rec_size), len(het_pos), _ptr(het_pos),
        _ptr(has_window), _ptr(ref_start), _ptr(ref_end), _ptr(read_blob),
        len(read_blob), _ptr(read_off))
    if rc < 0:
        return None
    return (has_window.astype(bool), ref_start, ref_end,
            read_blob[:read_off[-1]], read_off)


# columns of a window's row in `wfa_pack_sizes`: built (1) or refused (0),
# G, N, P (padded), last node, band center at the end, spread, triples
PACK_INFO = 8


def _pack_args(pack, chrom_seq: bytes, ref_start, ref_end, read_blob,
               read_off):
    """The arguments both passes of hn_wfa_pack_windows share, checked;
    the arrays are returned too, so the caller keeps them alive."""
    ref_start = np.ascontiguousarray(ref_start, dtype=np.int64)
    ref_end = np.ascontiguousarray(ref_end, dtype=np.int64)
    read_off = np.ascontiguousarray(read_off, dtype=np.int64)
    read_blob = np.ascontiguousarray(read_blob, dtype=np.uint8)
    n = len(ref_start)
    if (len(ref_end) != n or len(read_off) != n + 1 or read_off[0] != 0
            or (np.diff(read_off) < 0).any()
            or read_off[-1] > len(read_blob)):
        raise ValueError("wfa_pack: need n windows and n + 1 ascending "
                         "read offsets into the read bytes")
    for name, a, dt in (("pos", pack.pos, np.int64),
                        ("ref_len", pack.ref_len, np.int64),
                        ("var_index", pack.var_index, np.int32),
                        ("a0_is_alt", pack.a0_is_alt, np.uint8),
                        ("a0_off", pack.a0_off, np.int64),
                        ("a0_len", pack.a0_len, np.int64),
                        ("a1_off", pack.a1_off, np.int64),
                        ("a1_len", pack.a1_len, np.int64)):
        if a.dtype != dt or not a.flags.c_contiguous or len(a) != pack.n:
            raise ValueError(f"wfa_pack: the block's {name} must be "
                             f"{pack.n} contiguous {np.dtype(dt).name}")
    seq = np.frombuffer(chrom_seq, dtype=np.uint8)
    keep = (seq, ref_start, ref_end, read_blob, read_off)
    args = [_ptr(seq), len(seq), pack.n, _ptr(pack.pos), _ptr(pack.ref_len),
            _ptr(pack.var_index), _ptr(pack.a0_is_alt), _ptr(pack.blob),
            _ptr(pack.a0_off), _ptr(pack.a0_len), _ptr(pack.a1_off),
            _ptr(pack.a1_len), n, _ptr(ref_start), _ptr(ref_end),
            _ptr(read_blob), _ptr(read_off)]
    return args, keep


def wfa_pack_sizes(pack, chrom_seq: bytes, ref_start, ref_end, read_blob,
                   read_off):
    """The sizing pass of the window packer (hn_wfa_pack_windows in
    csrc/wfa_pack.cc; the call releases the interpreter lock): read k's
    window [ref_start[k], ref_end[k]) over the block's variants ``pack``
    (a `phasing.global_realign.WfaBlockPack`) of chromosome ``chrom_seq``,
    its aligned bases read_blob[read_off[k]:read_off[k + 1]]. Returns the
    rows [n, PACK_INFO] int64, or None when the library is not bound."""
    _load()
    lib = _PORT
    if lib is None:
        return None
    args, _keep = _pack_args(pack, chrom_seq, ref_start, ref_end, read_blob,
                             read_off)
    info = np.zeros((len(ref_start), PACK_INFO), dtype=np.int64)
    rc = lib.hn_wfa_pack_windows(*args, _ptr(info), 0, None, None, None,
                                 None, None, None, None, None, None)
    if rc != 0:
        raise RuntimeError(f"hn_wfa_pack_windows refused its input ({rc})")
    return info


def wfa_pack_write(pack, chrom_seq: bytes, ref_start, ref_end, read_blob,
                   read_off, info, P: int, goff, gnoff, roff, sections,
                   flat, tri_off):
    """The writing pass of the window packer, for the rows ``info`` of
    `wfa_pack_sizes`: every built window's graph and every read's bases
    into the int32 buffer ``flat`` (zeroed; the layout of
    `align.wfa_device.PairBatch`: P, each pair's position, node and
    read-byte offsets, the section starts in words), and each built
    window's (node, block variant index, allele) triples from tri_off[k].
    Returns (tri_node, tri_var, tri_val)."""
    _load()
    lib = _PORT
    if lib is None:
        raise RuntimeError("the port's own library is not bound")
    args, _keep = _pack_args(pack, chrom_seq, ref_start, ref_end, read_blob,
                             read_off)
    n = len(ref_start)
    info = np.ascontiguousarray(info, dtype=np.int64)
    goff, gnoff, roff, sections, tri_off = (
        np.ascontiguousarray(a, dtype=np.int64)
        for a in (goff, gnoff, roff, sections, tri_off))
    if (info.shape != (n, PACK_INFO) or len(goff) != n or len(gnoff) != n
            or len(roff) != n or len(tri_off) != n + 1 or len(sections) != 5
            or flat.dtype != np.int32 or not flat.flags.c_contiguous
            or len(flat) != sections[4]
            or (np.diff(sections) < 0).any() or sections[0] != 0):
        raise ValueError("wfa_pack_write: the layout does not match the "
                         "windows")
    n_tri = int(tri_off[-1])
    tri_node = np.zeros(n_tri, dtype=np.int32)
    tri_var = np.zeros(n_tri, dtype=np.int32)
    tri_val = np.zeros(n_tri, dtype=np.uint8)
    if (tri_off[:-1] + np.where(info[:, 0] == 1, info[:, 7], 0)
            > tri_off[1:]).any():
        raise ValueError("wfa_pack_write: the triples do not fit")
    rc = lib.hn_wfa_pack_windows(
        *args, _ptr(info), int(P), _ptr(goff), _ptr(gnoff), _ptr(roff),
        _ptr(sections), _ptr(flat), _ptr(tri_off), _ptr(tri_node),
        _ptr(tri_var), _ptr(tri_val))
    if rc != 0:
        raise RuntimeError(f"hn_wfa_pack_windows refused the layout ({rc})")
    return tri_node, tri_var, tri_val


def bam_scan_records(raw: np.ndarray, name_blob: np.ndarray,
                     name_off: np.ndarray):
    """Walk a decompressed BAM record stream (starting at a record boundary).

    Returns (tid, pos, end, mapq, flag, rec_off, rec_size, sa_rec, sa_start,
    sa_end, sa_mapq, consumed_bytes) or None when the native library is
    unavailable or the stream is malformed (callers fall back to the Python
    reader). rec_off points at each record body (after its size prefix).
    """
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_hn_bam_scan_sig", False):
        lib.hn_bam_scan_records.restype = ctypes.c_int64
        lib._hn_bam_scan_sig = True
    n_ref = len(name_off) - 1
    cap = max(len(raw) // 36, 16)  # min record size ≈ 36 bytes on disk
    sa_cap = max(cap // 4, 1024)
    tid = np.empty(cap, dtype=np.int32)
    pos = np.empty(cap, dtype=np.int32)
    end = np.empty(cap, dtype=np.int32)
    mapq = np.empty(cap, dtype=np.uint8)
    flag = np.empty(cap, dtype=np.uint16)
    rec_off = np.empty(cap, dtype=np.int64)
    rec_size = np.empty(cap, dtype=np.int64)
    sa_rec = np.empty(sa_cap, dtype=np.int64)
    sa_start = np.empty(sa_cap, dtype=np.int32)
    sa_end = np.empty(sa_cap, dtype=np.int32)
    sa_mapq = np.empty(sa_cap, dtype=np.int32)
    sa_count = np.zeros(1, dtype=np.int64)
    consumed = np.zeros(1, dtype=np.int64)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    name_blob = np.ascontiguousarray(name_blob, dtype=np.uint8)
    name_off = np.ascontiguousarray(name_off, dtype=np.int64)
    while True:
        n = lib.hn_bam_scan_records(
            ctypes.c_void_p(raw.ctypes.data), ctypes.c_int64(len(raw)),
            ctypes.c_void_p(name_blob.ctypes.data),
            ctypes.c_void_p(name_off.ctypes.data), ctypes.c_int32(n_ref),
            ctypes.c_void_p(tid.ctypes.data), ctypes.c_void_p(pos.ctypes.data),
            ctypes.c_void_p(end.ctypes.data),
            ctypes.c_void_p(mapq.ctypes.data),
            ctypes.c_void_p(flag.ctypes.data),
            ctypes.c_void_p(rec_off.ctypes.data),
            ctypes.c_void_p(rec_size.ctypes.data), ctypes.c_int64(cap),
            ctypes.c_void_p(sa_rec.ctypes.data),
            ctypes.c_void_p(sa_start.ctypes.data),
            ctypes.c_void_p(sa_end.ctypes.data),
            ctypes.c_void_p(sa_mapq.ctypes.data),
            ctypes.c_int64(sa_cap), ctypes.c_void_p(sa_count.ctypes.data),
            ctypes.c_void_p(consumed.ctypes.data))
        if n == -3:
            return None
        if n == -1:
            cap *= 2
            tid = np.empty(cap, dtype=np.int32)
            pos = np.empty(cap, dtype=np.int32)
            end = np.empty(cap, dtype=np.int32)
            mapq = np.empty(cap, dtype=np.uint8)
            flag = np.empty(cap, dtype=np.uint16)
            rec_off = np.empty(cap, dtype=np.int64)
            rec_size = np.empty(cap, dtype=np.int64)
            continue
        if n == -2:
            sa_cap *= 2
            sa_rec = np.empty(sa_cap, dtype=np.int64)
            sa_start = np.empty(sa_cap, dtype=np.int32)
            sa_end = np.empty(sa_cap, dtype=np.int32)
            sa_mapq = np.empty(sa_cap, dtype=np.int32)
            continue
        break
    n = int(n)
    ns = int(sa_count[0])
    return (tid[:n].copy(), pos[:n].copy(), end[:n].copy(), mapq[:n].copy(),
            flag[:n].copy(), rec_off[:n].copy(), rec_size[:n].copy(),
            sa_rec[:ns].copy(), sa_start[:ns].copy(),
            sa_end[:ns].copy(), sa_mapq[:ns].copy(), int(consumed[0]))


def realign_block(raw: np.ndarray, rec_off: np.ndarray, rec_size: np.ndarray,
                  pack, sv_indel_qual: int, threads: int = 2):
    """Native whole-block local realignment: every record against the
    block's VariantPack. Returns (alleles [n_recs, n_vars] u8, quals u8,
    noverlap i32, stats int64[5*11+3]) or None when unavailable/malformed."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_hn_realign_sig", False):
        lib.hn_realign_block.restype = ctypes.c_int64
        lib._hn_realign_sig = True
    n_recs = len(rec_off)
    n_vars = pack.n
    alleles = np.empty((n_recs, n_vars), dtype=np.uint8)
    quals = np.empty((n_recs, n_vars), dtype=np.uint8)
    noverlap = np.zeros(n_recs, dtype=np.int32)
    stats = np.zeros(5 * 11 + 3, dtype=np.int64)
    ignored = np.ascontiguousarray(pack.ignored, dtype=np.uint8)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    rec_size = np.ascontiguousarray(rec_size, dtype=np.int64)
    rc = lib.hn_realign_block(
        ctypes.c_void_p(raw.ctypes.data),
        ctypes.c_void_p(rec_off.ctypes.data),
        ctypes.c_void_p(rec_size.ctypes.data), ctypes.c_int64(n_recs),
        ctypes.c_int32(n_vars),
        ctypes.c_void_p(pack.pos.ctypes.data),
        ctypes.c_void_p(pack.ref_len.ctypes.data),
        ctypes.c_void_p(pack.prefix.ctypes.data),
        ctypes.c_void_p(pack.postfix.ctypes.data),
        ctypes.c_void_p(ignored.ctypes.data),
        ctypes.c_void_p(pack.vt_index.ctypes.data),
        ctypes.c_void_p(pack.blob.ctypes.data),
        ctypes.c_void_p(pack.a0_off.ctypes.data),
        ctypes.c_void_p(pack.a0_len.ctypes.data),
        ctypes.c_void_p(pack.a1_off.ctypes.data),
        ctypes.c_void_p(pack.a1_len.ctypes.data),
        ctypes.c_void_p(pack.baseline.ctypes.data),
        ctypes.c_int32(sv_indel_qual), ctypes.c_int32(threads),
        ctypes.c_void_p(alleles.ctypes.data),
        ctypes.c_void_p(quals.ctypes.data),
        ctypes.c_void_p(noverlap.ctypes.data),
        ctypes.c_void_p(stats.ctypes.data))
    if rc != 0:
        return None
    return alleles, quals, noverlap, stats


def bgzf_compress_blocks(payloads: list[bytes], level: int = 6,
                         threads: int = 4) -> bytes | None:
    """Compress payloads (each ≤64KiB) into concatenated BGZF blocks.
    Returns None when the native library is unavailable."""
    lib = _load()
    if lib is None or not payloads:
        return None
    offsets = np.zeros(len(payloads) + 1, dtype=np.int64)
    for i, p in enumerate(payloads):
        offsets[i + 1] = offsets[i] + len(p)
    blob = b"".join(payloads)
    src = np.frombuffer(blob, dtype=np.uint8)
    cap = int(offsets[-1]) + len(payloads) * (1024 + 26) + 65536
    out = np.empty(cap, dtype=np.uint8)
    out_offsets = np.zeros(len(payloads) + 1, dtype=np.int64)
    total = lib.hn_bgzf_compress_many(
        src.ctypes.data, offsets.ctypes.data, len(payloads), level,
        out.ctypes.data, cap, out_offsets.ctypes.data, threads)
    if total < 0:
        return None
    return out[:total].tobytes()


def bgzf_decompress_all_arr(data, threads: int = 4) -> np.ndarray | None:
    """Scan + decompress an entire BGZF byte stream in parallel, returning a
    uint8 array (no copy-out). None when unavailable or malformed."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8) \
        if not isinstance(data, np.ndarray) else np.ascontiguousarray(data)
    max_blocks = max(len(src) // 26 + 2, 16)
    offsets = np.zeros(max_blocks + 1, dtype=np.int64)
    isizes = np.zeros(max_blocks, dtype=np.int64)
    n = lib.hn_bgzf_scan(src.ctypes.data, len(src), offsets.ctypes.data,
                         isizes.ctypes.data, max_blocks)
    if n < 0:
        return None
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(isizes[:n], out=out_offsets[1:])
    out = np.empty(int(out_offsets[n]), dtype=np.uint8)
    rc = lib.hn_bgzf_decompress_many(
        src.ctypes.data, offsets[:n + 1].ctypes.data, int(n),
        out.ctypes.data, out_offsets.ctypes.data, threads)
    if rc != 0:
        return None
    return out


def bgzf_decompress_all(data: bytes, threads: int = 4) -> bytes | None:
    """Bytes-returning wrapper over `bgzf_decompress_all_arr`."""
    out = bgzf_decompress_all_arr(data, threads)
    return None if out is None else out.tobytes()


def edit_distance_batch_native(queries: np.ndarray, query_lens: np.ndarray,
                               targets: np.ndarray, target_lens: np.ndarray,
                               threads: int = 1) -> np.ndarray | None:
    """Batched Levenshtein on the native library; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, dtype=np.uint8)
    targets = np.ascontiguousarray(targets, dtype=np.uint8)
    qlens = np.ascontiguousarray(query_lens, dtype=np.int32)
    tlens = np.ascontiguousarray(target_lens, dtype=np.int32)
    n = queries.shape[0]
    out = np.zeros(n, dtype=np.int32)
    lib.hn_edit_distance_batch(
        queries.ctypes.data, qlens.ctypes.data, queries.shape[1],
        targets.ctypes.data, tlens.ctypes.data, targets.shape[1],
        n, out.ctypes.data, threads)
    return out


def wfa_batch(raw: np.ndarray, rec_off: np.ndarray, rec_size: np.ndarray,
              chrom_seq: bytes, het_pos: np.ndarray, wfa_pack,
              prune_distance: int, max_edit_distance: int,
              threads: int = 2):
    """Batched graph-WFA global realignment over a block's records.

    Returns (scores, alleles [n_recs, n_hets]) or None when unavailable.
    Per-record score: >=0 edit distance, -1 max-ED (local fallback),
    -2 no het overlap (skipped), -3 scratch overflow (per-read host path).
    """
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_hn_wfa_batch_sig", False):
        lib.hn_wfa_batch.restype = ctypes.c_int64
        lib._hn_wfa_batch_sig = True
    n_recs = len(rec_off)
    n_hets = len(het_pos)
    scores = np.zeros(n_recs, dtype=np.int64)
    alleles = np.full((max(n_recs, 1), max(n_hets, 1)), 3, dtype=np.uint8)
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    rec_size = np.ascontiguousarray(rec_size, dtype=np.int64)
    het_pos = np.ascontiguousarray(het_pos, dtype=np.int64)
    seq = np.frombuffer(chrom_seq, dtype=np.uint8)
    rc = lib.hn_wfa_batch(
        ctypes.c_void_p(raw.ctypes.data),
        ctypes.c_void_p(rec_off.ctypes.data),
        ctypes.c_void_p(rec_size.ctypes.data), ctypes.c_int64(n_recs),
        ctypes.c_void_p(seq.ctypes.data), ctypes.c_int64(len(seq)),
        ctypes.c_void_p(het_pos.ctypes.data), ctypes.c_int64(n_hets),
        ctypes.c_int32(wfa_pack.n),
        ctypes.c_void_p(wfa_pack.pos.ctypes.data),
        ctypes.c_void_p(wfa_pack.ref_len.ctypes.data),
        ctypes.c_void_p(wfa_pack.var_index.ctypes.data),
        ctypes.c_void_p(wfa_pack.a0_is_alt.ctypes.data),
        ctypes.c_void_p(wfa_pack.blob.ctypes.data),
        ctypes.c_void_p(wfa_pack.a0_off.ctypes.data),
        ctypes.c_void_p(wfa_pack.a0_len.ctypes.data),
        ctypes.c_void_p(wfa_pack.a1_off.ctypes.data),
        ctypes.c_void_p(wfa_pack.a1_len.ctypes.data),
        ctypes.c_int64(prune_distance), ctypes.c_int64(max_edit_distance),
        ctypes.c_int32(threads),
        ctypes.c_void_p(scores.ctypes.data),
        ctypes.c_void_p(alleles.ctypes.data))
    if rc != 0:
        return None
    return scores, alleles[:n_recs, :n_hets]


def window_alleles(r2q, ref_base, read_seq, read_quals,
                   aligned_start, aligned_end, pack, skip_flags):
    """Native anchor-window allele matching for one read.
    Returns (allele, qual, exact, overlap) uint8 arrays, or None."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_hn_window_sig", False):
        lib.hn_window_alleles.restype = None
        lib._hn_window_sig = True
    n = pack.n
    out_allele = np.full(n, 3, dtype=np.uint8)
    out_qual = np.zeros(n, dtype=np.uint8)
    out_exact = np.zeros(n, dtype=np.uint8)
    out_overlap = np.zeros(n, dtype=np.uint8)
    r2q = np.ascontiguousarray(r2q, dtype=np.int64)
    seq = np.frombuffer(read_seq, dtype=np.uint8)
    quals = np.frombuffer(read_quals, dtype=np.uint8)
    skip = np.ascontiguousarray(skip_flags, dtype=np.uint8)
    lib.hn_window_alleles(
        ctypes.c_void_p(r2q.ctypes.data), ctypes.c_int64(ref_base),
        ctypes.c_int64(len(r2q)),
        ctypes.c_void_p(seq.ctypes.data), ctypes.c_void_p(quals.ctypes.data),
        ctypes.c_int64(len(seq)),
        ctypes.c_int64(aligned_start), ctypes.c_int64(aligned_end),
        ctypes.c_int32(n),
        ctypes.c_void_p(pack.pos.ctypes.data),
        ctypes.c_void_p(pack.ref_len.ctypes.data),
        ctypes.c_void_p(pack.prefix.ctypes.data),
        ctypes.c_void_p(pack.postfix.ctypes.data),
        ctypes.c_void_p(skip.ctypes.data),
        ctypes.c_void_p(pack.blob.ctypes.data),
        ctypes.c_void_p(pack.a0_off.ctypes.data),
        ctypes.c_void_p(pack.a0_len.ctypes.data),
        ctypes.c_void_p(pack.a1_off.ctypes.data),
        ctypes.c_void_p(pack.a1_len.ctypes.data),
        ctypes.c_void_p(pack.baseline.ctypes.data),
        ctypes.c_void_p(out_allele.ctypes.data),
        ctypes.c_void_p(out_qual.ctypes.data),
        ctypes.c_void_p(out_exact.ctypes.data),
        ctypes.c_void_p(out_overlap.ctypes.data))
    return out_allele, out_qual, out_exact, out_overlap


def wfa_align(node_blob, node_off, edge_dst, edge_off, read,
              prune_distance, max_edit_distance):
    """Native graph-WFA alignment. Returns (score, traversed mask) or None
    when the library is unavailable. score == -1 means max-ED exceeded."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_hn_wfa_sig", False):
        lib.hn_wfa_align.restype = ctypes.c_int64
        lib._hn_wfa_sig = True
    n_nodes = len(node_off) - 1
    if not (node_blob.flags.c_contiguous and node_off.flags.c_contiguous
            and edge_dst.flags.c_contiguous and edge_off.flags.c_contiguous):
        node_blob = np.ascontiguousarray(node_blob, dtype=np.uint8)
        node_off = np.ascontiguousarray(node_off, dtype=np.int64)
        edge_dst = np.ascontiguousarray(edge_dst, dtype=np.int32)
        edge_off = np.ascontiguousarray(edge_off, dtype=np.int64)
    read_arr = np.frombuffer(bytes(read), dtype=np.uint8)
    traversed = np.zeros(n_nodes, dtype=np.uint8)
    score = lib.hn_wfa_align(
        ctypes.c_void_p(node_blob.ctypes.data),
        ctypes.c_void_p(node_off.ctypes.data),
        ctypes.c_int32(n_nodes),
        ctypes.c_void_p(edge_dst.ctypes.data),
        ctypes.c_void_p(edge_off.ctypes.data),
        ctypes.c_void_p(read_arr.ctypes.data),
        ctypes.c_int64(len(read_arr)),
        ctypes.c_int64(prune_distance),
        ctypes.c_int64(max_edit_distance),
        ctypes.c_void_p(traversed.ctypes.data))
    if int(score) == -2:
        return None  # graph too large for the native pool: host fallback
    return int(score), traversed


def wfa_build(reference, ref_start, ref_end, var_pos, var_ref_len,
              var_index, a0_is_alt, a_blob, a0_off, a0_len, a1_off, a1_len):
    """Native WFA graph construction. Returns (node_off, node_blob,
    edge_off, edge_dst, alleles) or None (unavailable / capacity fallback)."""
    lib = _load()
    if lib is None:
        return None
    if not getattr(lib, "_hn_build_sig", False):
        lib.hn_wfa_build.restype = ctypes.c_int64
        lib._hn_build_sig = True
    n = len(var_pos)
    window = ref_end - ref_start
    node_cap = 3 * n + 4
    blob_cap = window + int(a0_len.sum() + a1_len.sum()) + 16
    edge_cap = 8 * n + 16
    alle_cap = 2 * n + 2
    node_off = np.zeros(node_cap + 1, dtype=np.int64)
    node_blob = np.zeros(blob_cap, dtype=np.uint8)
    edge_off = np.zeros(max(node_cap + 1, edge_cap), dtype=np.int64)
    edge_dst = np.zeros(edge_cap, dtype=np.int32)
    alle_node = np.zeros(alle_cap, dtype=np.int32)
    alle_var = np.zeros(alle_cap, dtype=np.int32)
    alle_val = np.zeros(alle_cap, dtype=np.uint8)
    n_alleles = np.zeros(1, dtype=np.int64)
    # inputs are produced contiguous with the right dtypes by the callers
    # (WfaBlockPack / from_reference_variants); avoid per-read conversions
    ref_arr = np.frombuffer(reference, dtype=np.uint8)
    n_nodes = lib.hn_wfa_build(
        ctypes.c_void_p(ref_arr.ctypes.data), ctypes.c_int64(ref_start),
        ctypes.c_int64(ref_end), ctypes.c_int32(n),
        ctypes.c_void_p(var_pos.ctypes.data),
        ctypes.c_void_p(var_ref_len.ctypes.data),
        ctypes.c_void_p(var_index.ctypes.data),
        ctypes.c_void_p(a0_is_alt.ctypes.data),
        ctypes.c_void_p(a_blob.ctypes.data),
        ctypes.c_void_p(a0_off.ctypes.data),
        ctypes.c_void_p(a0_len.ctypes.data),
        ctypes.c_void_p(a1_off.ctypes.data),
        ctypes.c_void_p(a1_len.ctypes.data),
        ctypes.c_void_p(node_off.ctypes.data),
        ctypes.c_void_p(node_blob.ctypes.data),
        ctypes.c_int64(node_cap), ctypes.c_int64(blob_cap),
        ctypes.c_void_p(edge_off.ctypes.data),
        ctypes.c_void_p(edge_dst.ctypes.data), ctypes.c_int64(edge_cap),
        ctypes.c_void_p(alle_node.ctypes.data),
        ctypes.c_void_p(alle_var.ctypes.data),
        ctypes.c_void_p(alle_val.ctypes.data),
        ctypes.c_int64(alle_cap), ctypes.c_void_p(n_alleles.ctypes.data))
    if n_nodes < 0:
        return None
    na = int(n_alleles[0])
    return (node_off[:n_nodes + 1], node_blob, edge_off[:n_nodes + 1].copy(),
            edge_dst, (alle_node[:na], alle_var[:na], alle_val[:na]))


def beam_solve_batch_native(nv, skip_off, skip, read_off, seg_start, seg_off,
                            alleles, quals, fast_width: int, full_width: int,
                            threads: int = 1):
    """Native lockstep-beam solve over a batch of blocks (see
    hn_beam_solve_batch in native/hiphase_native.cc). Returns
    (h1, h2, cost, hets, pruned, expansions) or None when the native library
    is unavailable or a block exceeds the ranking-key capacity."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib.hn_beam_solve_batch, "_hn_ready"):
        lib.hn_beam_solve_batch.restype = ctypes.c_int32
        lib.hn_beam_solve_batch.argtypes = [
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.hn_beam_solve_batch._hn_ready = True
    nv = np.ascontiguousarray(nv, dtype=np.int32)
    skip_off = np.ascontiguousarray(skip_off, dtype=np.int64)
    skip = np.ascontiguousarray(skip, dtype=np.uint8)
    read_off = np.ascontiguousarray(read_off, dtype=np.int64)
    seg_start = np.ascontiguousarray(seg_start, dtype=np.int32)
    seg_off = np.ascontiguousarray(seg_off, dtype=np.int64)
    alleles = np.ascontiguousarray(alleles, dtype=np.uint8)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    n_blocks = len(nv)
    total_v = int(skip_off[-1])
    h1 = np.empty(total_v, dtype=np.uint8)
    h2 = np.empty(total_v, dtype=np.uint8)
    cost = np.empty(n_blocks, dtype=np.int32)
    hets = np.empty(n_blocks, dtype=np.int32)
    pruned = np.empty(n_blocks, dtype=np.int32)
    expansions = np.empty(n_blocks, dtype=np.int64)
    rc = lib.hn_beam_solve_batch(
        n_blocks, _ptr(nv), _ptr(skip_off), _ptr(skip), _ptr(read_off),
        _ptr(seg_start), _ptr(seg_off), _ptr(alleles), _ptr(quals),
        int(fast_width), int(full_width), int(threads), _ptr(h1), _ptr(h2),
        _ptr(cost), _ptr(hets), _ptr(pruned), _ptr(expansions))
    if rc != 0:
        return None
    return h1, h2, cost, hets, pruned, expansions


def bam_span_scan_file(path: str, body_voffset: int, name_blob: np.ndarray,
                       name_off: np.ndarray, min_mapq: int, filter_mask: int,
                       threads: int = 2):
    """Streaming whole-file BAM span scan (hn_span_scan_file): threaded
    inflate + record walk + flag/MAPQ filter in one native pass. Returns
    (tid i32, pos i64, end i64, sa_row i64, sa_start i64, sa_end i64,
    sa_mapq i64) over filtered records, or None when unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib.hn_span_scan_file, "_hn_ready"):
        lib.hn_span_scan_file.restype = ctypes.c_void_p
        lib.hn_span_scan_file.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.hn_span_scan_counts.restype = None
        lib.hn_span_scan_counts.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.hn_span_scan_export.restype = None
        lib.hn_span_scan_export.argtypes = [ctypes.c_void_p] + \
            [ctypes.c_void_p] * 7
        lib.hn_span_scan_free.restype = None
        lib.hn_span_scan_free.argtypes = [ctypes.c_void_p]
        lib.hn_span_scan_file._hn_ready = True
    name_blob = np.ascontiguousarray(name_blob, dtype=np.uint8)
    name_off = np.ascontiguousarray(name_off, dtype=np.int64)
    h = lib.hn_span_scan_file(
        path.encode(), body_voffset >> 16, body_voffset & 0xFFFF,
        _ptr(name_blob), _ptr(name_off), len(name_off) - 1,
        int(min_mapq), int(filter_mask), int(threads))
    if not h:
        return None
    try:
        counts = np.zeros(2, dtype=np.int64)
        lib.hn_span_scan_counts(h, _ptr(counts[0:1]), _ptr(counts[1:2]))
        n, n_sa = int(counts[0]), int(counts[1])
        tid = np.empty(n, dtype=np.int32)
        pos = np.empty(n, dtype=np.int64)
        end = np.empty(n, dtype=np.int64)
        sa_row = np.empty(n_sa, dtype=np.int64)
        sa_start = np.empty(n_sa, dtype=np.int64)
        sa_end = np.empty(n_sa, dtype=np.int64)
        sa_mapq = np.empty(n_sa, dtype=np.int64)
        lib.hn_span_scan_export(h, _ptr(tid), _ptr(pos), _ptr(end),
                                _ptr(sa_row), _ptr(sa_start), _ptr(sa_end),
                                _ptr(sa_mapq))
        return tid, pos, end, sa_row, sa_start, sa_end, sa_mapq
    finally:
        lib.hn_span_scan_free(h)


def vcf_transform_batch(text: np.ndarray, line_off, line_len, n_samples: int,
                        mode, h1, h2, ps):
    """Bulk strip+rewrite of VCF lines (hn_vcf_transform). Returns
    (out_bytes, out_off [k+1], line_err u8 [k]) or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib.hn_vcf_transform, "_hn_ready"):
        lib.hn_vcf_transform.restype = ctypes.c_int64
        lib.hn_vcf_transform.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.hn_vcf_transform._hn_ready = True
    text = np.ascontiguousarray(text, dtype=np.uint8)
    line_off = np.ascontiguousarray(line_off, dtype=np.int64)
    line_len = np.ascontiguousarray(line_len, dtype=np.int64)
    mode = np.ascontiguousarray(mode, dtype=np.uint8)
    h1 = np.ascontiguousarray(h1, dtype=np.uint8)
    h2 = np.ascontiguousarray(h2, dtype=np.uint8)
    ps = np.ascontiguousarray(ps, dtype=np.int64)
    k = len(line_off)
    cap = int(line_len.sum()) + k * (16 + 48 * max(n_samples, 1)) + 64
    out = np.empty(cap, dtype=np.uint8)
    out_off = np.empty(k + 1, dtype=np.int64)
    line_err = np.empty(k, dtype=np.uint8)
    total = lib.hn_vcf_transform(
        _ptr(text), _ptr(line_off), _ptr(line_len), k, int(n_samples),
        _ptr(mode), _ptr(h1), _ptr(h2), _ptr(ps), _ptr(out), cap,
        _ptr(out_off), _ptr(line_err))
    if total < 0:
        return None
    return out[:int(total)], out_off, line_err


def rans_uncompress(stream: bytes, out_size: int):
    """Fast rans4x8 decode (hn_rans_uncompress); None when the native
    library is unavailable or the stream is malformed (callers fall back
    to the pure-Python oracle, which raises precise errors)."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib.hn_rans_uncompress, "_hn_ready"):
        lib.hn_rans_uncompress.restype = ctypes.c_int64
        lib.hn_rans_uncompress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.hn_rans_uncompress._hn_ready = True
    src = np.frombuffer(stream, dtype=np.uint8)
    out = np.empty(max(out_size, 1), dtype=np.uint8)
    n = lib.hn_rans_uncompress(_ptr(src), len(src), _ptr(out), out_size)
    if n < 0:
        return None
    return out[:int(n)].tobytes()


def bam_retag(raw: np.ndarray, rec_off: np.ndarray, rec_size: np.ndarray,
              tag_names: list[bytes], tag_ps: np.ndarray, tag_hp: np.ndarray):
    """Bulk strip HP/PS + retag (hn_bam_retag). Returns (data_bytes,
    out_off [n+1]) of serialized records, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not hasattr(lib.hn_bam_retag, "_hn_ready"):
        lib.hn_bam_retag.restype = ctypes.c_int64
        lib.hn_bam_retag.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.hn_bam_retag._hn_ready = True
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    rec_off = np.ascontiguousarray(rec_off, dtype=np.int64)
    rec_size = np.ascontiguousarray(rec_size, dtype=np.int64)
    n = len(rec_off)
    name_off = np.zeros(len(tag_names) + 1, dtype=np.int64)
    for i, nm in enumerate(tag_names):
        name_off[i + 1] = name_off[i] + len(nm)
    name_blob = np.frombuffer(b"".join(tag_names) or b"\x00", dtype=np.uint8)
    tag_ps = np.ascontiguousarray(tag_ps, dtype=np.int32)
    tag_hp = np.ascontiguousarray(tag_hp, dtype=np.uint8)
    cap = int(rec_size.sum()) + n * 20 + 64
    out = np.empty(cap, dtype=np.uint8)
    out_off = np.empty(n + 1, dtype=np.int64)
    total = lib.hn_bam_retag(
        _ptr(raw), _ptr(rec_off), _ptr(rec_size), n, _ptr(name_blob),
        _ptr(name_off), len(tag_names), _ptr(tag_ps), _ptr(tag_hp),
        _ptr(out), cap, _ptr(out_off))
    if total < 0:
        return None
    return out[:int(total)], out_off
