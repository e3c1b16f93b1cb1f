"""BAM reader/writer with BAI indexing — native implementation (no htslib).

Covers what the reference uses from rust-htslib (SURVEY.md §2 L0): indexed
region fetch, CIGAR access/aligned-pairs walk, aux tags (RG, SA, HP, PS),
record rewrite with tag strip/add, header SM/RG parsing, and index build.

Spec: SAM/BAM v1.6 (samtools/hts-specs). Binary layout §4.2, BAI §5.2.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from hiphase_tpu_torch.io.bgzf import BgzfReader

BAM_MAGIC = b"BAM\x01"
BAI_MAGIC = b"BAI\x01"

CIGAR_OPS = "MIDNSHP=X"
_CONSUMES_QUERY = frozenset("MIS=X")
_CONSUMES_REF = frozenset("MDN=X")
SEQ_NT16 = "=ACMGRSVTWYHKDBN"

# FLAG bits
FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800

_PSEUDO_BIN = 37450
_LINEAR_SHIFT = 14


class BamError(IOError):
    pass


@dataclass
class BamRecord:
    """One alignment record. Keeps the raw on-disk bytes for cheap rewrite;
    parsed fields are materialized on construction (cheap for our access
    patterns: every consumer touches name/flag/pos/cigar)."""

    raw: bytes  # record body WITHOUT the leading block_size int32
    refid: int
    pos: int
    mapq: int
    flag: int
    read_name: str
    n_cigar_op: int
    l_seq: int
    _cigar_off: int
    _seq_off: int
    _qual_off: int
    _aux_off: int

    @classmethod
    def parse(cls, raw: bytes) -> "BamRecord":
        (refid, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
         _next_refid, _next_pos, _tlen) = struct.unpack_from("<iiBBHHHIiii", raw, 0)
        name_off = 32
        cigar_off = name_off + l_read_name
        seq_off = cigar_off + 4 * n_cigar_op
        qual_off = seq_off + (l_seq + 1) // 2
        aux_off = qual_off + l_seq
        read_name = raw[name_off:cigar_off - 1].decode()
        return cls(raw, refid, pos, mapq, flag, read_name, n_cigar_op, l_seq,
                   cigar_off, seq_off, qual_off, aux_off)

    # ---- flags ----
    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_qcfail(self) -> bool:
        return bool(self.flag & FLAG_QCFAIL)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & FLAG_DUPLICATE)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    # ---- cigar / coordinates ----
    def cigar(self) -> list[tuple[str, int]]:
        out = []
        for i in range(self.n_cigar_op):
            v = struct.unpack_from("<I", self.raw, self._cigar_off + 4 * i)[0]
            out.append((CIGAR_OPS[v & 0xF], v >> 4))
        return out

    def reference_end(self) -> int:
        """pos + reference-consumed length (exclusive end)."""
        end = self.pos
        for i in range(self.n_cigar_op):
            v = struct.unpack_from("<I", self.raw, self._cigar_off + 4 * i)[0]
            if CIGAR_OPS[v & 0xF] in _CONSUMES_REF:
                end += v >> 4
        return end

    def reference_range(self) -> tuple[int, int]:
        return self.pos, self.reference_end()

    def aligned_pairs(self):
        """Yield (query_pos, ref_pos) for each aligned (M/=/X) base — the
        CIGAR walk used to build ref→read coordinate maps
        (ref: read_parsing.rs:136-148)."""
        qpos = 0
        rpos = self.pos
        for op, length in self.cigar():
            if op in "M=X":
                for k in range(length):
                    yield (qpos + k, rpos + k)
                qpos += length
                rpos += length
            elif op in "IS":
                qpos += length
            elif op in "DN":
                rpos += length
            # H and P consume nothing

    def query_sequence(self) -> bytes:
        import numpy as np
        packed = np.frombuffer(
            self.raw[self._seq_off:self._seq_off + (self.l_seq + 1) // 2],
            dtype=np.uint8)
        nib = np.empty(packed.size * 2, dtype=np.uint8)
        nib[0::2] = packed >> 4
        nib[1::2] = packed & 0xF
        table = np.frombuffer(SEQ_NT16.encode(), dtype=np.uint8)
        return table[nib[:self.l_seq]].tobytes()

    def query_qualities(self) -> bytes:
        return self.raw[self._qual_off:self._qual_off + self.l_seq]

    # ---- aux tags ----
    def _iter_aux(self):
        """Yield (tag, type_char, value_start, value_end, value)."""
        raw = self.raw
        off = self._aux_off
        n = len(raw)
        while off + 3 <= n:
            tag = raw[off:off + 2].decode()
            tc = chr(raw[off + 2])
            vs = off + 3
            if tc == "A":
                ve, val = vs + 1, chr(raw[vs])
            elif tc == "c":
                ve, val = vs + 1, struct.unpack_from("<b", raw, vs)[0]
            elif tc == "C":
                ve, val = vs + 1, raw[vs]
            elif tc == "s":
                ve, val = vs + 2, struct.unpack_from("<h", raw, vs)[0]
            elif tc == "S":
                ve, val = vs + 2, struct.unpack_from("<H", raw, vs)[0]
            elif tc == "i":
                ve, val = vs + 4, struct.unpack_from("<i", raw, vs)[0]
            elif tc == "I":
                ve, val = vs + 4, struct.unpack_from("<I", raw, vs)[0]
            elif tc == "f":
                ve, val = vs + 4, struct.unpack_from("<f", raw, vs)[0]
            elif tc in "ZH":
                ve = raw.index(b"\x00", vs)
                val = raw[vs:ve].decode()
                ve += 1
            elif tc == "B":
                sub = chr(raw[vs])
                count = struct.unpack_from("<I", raw, vs + 1)[0]
                width = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
                ve = vs + 5 + width * count
                fmt = "<" + str(count) + {"c": "b", "C": "B", "s": "h", "S": "H",
                                          "i": "i", "I": "I", "f": "f"}[sub]
                val = list(struct.unpack_from(fmt, raw, vs + 5))
            else:
                raise BamError(f"unknown aux type {tc!r} in {self.read_name}")
            yield tag, tc, off, ve, val
            off = ve

    def get_tag(self, tag: str):
        for t, _tc, _s, _e, val in self._iter_aux():
            if t == tag:
                return val
        return None

    def strip_tags(self, tags: set[str]) -> "BamRecord":
        """Return a copy with the given aux tags removed
        (ref: ordered_bam_writer.rs:360-378 strips HP/PS)."""
        spans = [(s, e) for t, _tc, s, e, _v in self._iter_aux() if t in tags]
        if not spans:
            return self
        raw = bytearray(self.raw)
        for s, e in reversed(spans):
            del raw[s:e]
        return BamRecord.parse(bytes(raw))

    def with_int_tags(self, tags: list[tuple[str, int]]) -> "BamRecord":
        """Return a copy with integer aux tags appended. Width chosen like
        htslib (u8 / i32) so HP is 'C' (u8-sized values) and PS is 'i'."""
        extra = bytearray()
        for tag, value in tags:
            if 0 <= value <= 0xFF:
                extra += tag.encode() + b"C" + struct.pack("<B", value)
            else:
                extra += tag.encode() + b"i" + struct.pack("<i", value)
        return BamRecord.parse(self.raw + bytes(extra))


@dataclass
class SamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]

    def read_groups(self) -> list[dict[str, str]]:
        """Parse @RG lines into dicts (for RG→SM sample matching,
        ref: block_gen.rs:44-89)."""
        out = []
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                d = {}
                for fieldstr in line.split("\t")[1:]:
                    if ":" in fieldstr:
                        k, v = fieldstr.split(":", 1)
                        d[k] = v
                out.append(d)
        return out

    def samples(self) -> set[str]:
        return {rg["SM"] for rg in self.read_groups() if "SM" in rg}

    def with_pg_line(self, pg_id: str, pn: str, version: str, cl: str) -> "SamHeader":
        """Append a @PG record (ref: ordered_bam_writer.rs:63-72)."""
        text = self.text
        if text and not text.endswith("\n"):
            text += "\n"
        text += f"@PG\tID:{pg_id}\tPN:{pn}\tVN:{version}\tCL:{cl}\n"
        return SamHeader(text, self.ref_names, self.ref_lengths)


_CRAM_REFERENCE = None


def set_cram_reference(reference_genome) -> None:
    """Register the reference genome used to decode/encode CRAM containers
    (the analog of htslib's CRAM reference requirement). The CLI calls this
    once after loading the FASTA; forked workers inherit it."""
    global _CRAM_REFERENCE
    _CRAM_REFERENCE = reference_genome


def open_alignment(path: str):
    """Open a BAM or CRAM by extension (ref: ordered_bam_writer.rs:76-80).
    CRAM requires `set_cram_reference` to have been called."""
    if path.endswith(".cram"):
        from hiphase_tpu_torch.io.cram import CramError, CramReader
        if _CRAM_REFERENCE is None:
            raise CramError(
                "CRAM input requires the reference genome (--reference)")
        return CramReader(path, _CRAM_REFERENCE)
    return BamReader(path)


_READER_TLS = None


def cached_alignment(path: str):
    """Thread-local reader cache for the per-block prepare path: reader
    construction re-parses the whole index (the reference's workers reuse
    per-thread htslib readers the same way, ref: phaser.rs:43-45). Readers
    are not thread-safe, hence thread-local; never close the returned
    reader."""
    global _READER_TLS
    if _READER_TLS is None:
        import threading
        _READER_TLS = threading.local()
    import os
    pid = os.getpid()
    if getattr(_READER_TLS, "pid", None) != pid:
        # forked child inherited the parent's cache: the readers' file
        # descriptors share one open file description (shared offset)
        # across processes — never reuse them
        _READER_TLS.readers = {}
        _READER_TLS.pid = pid
    cache = _READER_TLS.readers
    key = (path, os.path.getmtime(path))
    rd = cache.get(key)
    if rd is None:
        if len(cache) > 64:  # stale entries from replaced files
            for old_rd in cache.values():
                try:
                    old_rd.close()
                except Exception:
                    pass
            cache.clear()
        rd = cache[key] = open_alignment(path)
    return rd


class BamReader:
    """Indexed BAM reader. ``fetch(chrom, start, end)`` uses the BAI index
    when present; falls back to a full scan for index-less small files."""

    def __init__(self, path: str):
        self.path = path
        self._bgzf = BgzfReader(path)
        magic = self._bgzf.read(4)
        if magic != BAM_MAGIC:
            raise BamError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._bgzf.read(4))[0]
        text = self._bgzf.read(l_text).split(b"\x00")[0].decode()
        n_ref = struct.unpack("<i", self._bgzf.read(4))[0]
        names, lengths = [], []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._bgzf.read(4))[0]
            names.append(self._bgzf.read(l_name)[:-1].decode())
            lengths.append(struct.unpack("<i", self._bgzf.read(4))[0])
        self.header = SamHeader(text, names, lengths)
        self._body_voffset = self._bgzf.virtual_offset
        self._index: BaiIndex | None = None
        try:
            self._index = BaiIndex.load(path + ".bai")
        except OSError:
            # htslib auto-loads .csi for long-contig BAMs; mirror that
            try:
                from hiphase_tpu_torch.io.tabix import TabixIndex
                self._index = _CsiBamIndex(TabixIndex.load_csi(path + ".csi"))
            except OSError:
                pass

    def close(self):
        self._bgzf.close()
        cur = getattr(self, "_win_cursor", None)
        if cur is not None:
            cur.close()
            self._win_cursor = None
        fh = getattr(self, "_rawfh", None)
        if fh is not None:
            try:
                fh.close()
            except Exception:
                pass
            self._rawfh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tid(self, chrom: str) -> int:
        try:
            return self.header.ref_names.index(chrom)
        except ValueError:
            return -1

    def _read_record(self) -> BamRecord | None:
        szb = self._bgzf.read(4)
        if len(szb) < 4:
            return None
        size = struct.unpack("<i", szb)[0]
        raw = self._bgzf.read(size)
        if len(raw) < size:
            raise BamError("truncated BAM record")
        return BamRecord.parse(raw)

    def __iter__(self):
        self._bgzf.seek_virtual(self._body_voffset)
        while True:
            rec = self._read_record()
            if rec is None:
                return
            yield rec

    @staticmethod
    def _rec_end(rec: "BamRecord") -> int:
        """Effective exclusive end for region overlap: htslib treats
        placed-unmapped records (and zero-ref-span CIGARs) as length 1 at
        pos, and region fetches DO return them."""
        if rec.is_unmapped:
            return rec.pos + 1
        return max(rec.reference_end(), rec.pos + 1)

    def fetch(self, chrom: str, start: int, end: int):
        """Yield records overlapping [start, end) on chrom, in file order
        (placed-unmapped records included, as htslib's fetch does)."""
        tid = self.tid(chrom)
        if tid < 0:
            return
        if self._index is not None:
            chunks = self._index.query(tid, start, end)
            for cbeg, cend in chunks:
                self._bgzf.seek_virtual(cbeg)
                while self._bgzf.virtual_offset < cend:
                    rec = self._read_record()
                    if rec is None:
                        break
                    if rec.refid != tid or rec.pos >= end:
                        break
                    if self._rec_end(rec) > start:
                        yield rec
        else:
            for rec in self:
                if rec.refid == tid and rec.pos < end \
                        and self._rec_end(rec) > start:
                    yield rec

    def fetch_raw(self, chrom: str, start: int, end: int, min_mapq: int):
        """Bulk region fetch for the native block realigner: one parallel
        inflate + one native record walk per index chunk instead of
        per-record Python decode.

        Returns a list of (buf, rec_off, rec_size) for records that overlap
        [start, end), pass the flag mask, and meet ``min_mapq`` — the same
        records, in the same order, as `fetch` + `filter_out_alignment_record`
        yields — or None when the native library (or the index) is
        unavailable.
        """
        from hiphase_tpu_torch.io import native
        import numpy as np
        if self._index is None or not native.available():
            return None
        tid = self.tid(chrom)
        if tid < 0:
            return []
        names = [n.encode() for n in self.header.ref_names]
        name_off = np.zeros(len(names) + 1, dtype=np.int64)
        for i, nb in enumerate(names):
            name_off[i + 1] = name_off[i] + len(nb)
        name_blob = np.frombuffer(b"".join(names) or b"\x00", dtype=np.uint8)
        if not hasattr(self, "_rawfh") or self._rawfh is None:
            self._rawfh = open(self.path, "rb")
        out = []
        # unmapped|secondary|qcfail|duplicate (ref: block_gen.rs:96-101)
        bad_flags = 0x4 | 0x100 | 0x200 | 0x400
        for cbeg, cend in self._index.query(tid, start, end):
            c0 = cbeg >> 16
            c1 = cend >> 16
            self._rawfh.seek(c1)
            head = self._rawfh.read(18)
            span_end = c1
            last_isize = 0   # the uncompressed bytes of cend's block
            if (cend & 0xFFFF) and len(head) >= 18:
                span_end = c1 + (struct.unpack_from("<H", head, 16)[0] + 1)
                self._rawfh.seek(span_end - 4)
                last_isize = struct.unpack("<I", self._rawfh.read(4))[0]
            raw = self._read_span_cached(c0, span_end)
            if raw is None:
                return None
            # cend in raw: `fetch` reads the records that begin before it;
            # those after it in cend's block belong to later chunks
            stop = len(raw) - last_isize + (cend & 0xFFFF) - (cbeg & 0xFFFF)
            raw = raw[cbeg & 0xFFFF:]
            scan = native.bam_scan_records(raw, name_blob, name_off)
            if scan is None:
                return None
            (rtid, pos, rend, mapq, flag, rec_off, rec_size,
             *_sa, _consumed) = scan
            keep = ((rtid == tid) & (pos < end)
                    & (np.maximum(rend, pos + 1) > start)
                    & ((flag & bad_flags) == 0) & (mapq >= min_mapq)
                    & (rec_off - 4 < stop))   # past the size prefix
            if keep.any():
                out.append((raw, rec_off[keep], rec_size[keep]))
        return out

    def _read_span_cached(self, c0: int, span_end: int):
        """Decompress the compressed byte span [c0, span_end) — both BGZF
        block boundaries — reusing the previously decoded span when the
        request is contained in it (or extends past its end, in which case
        only the new tail is inflated). Adjacent phase-block fetch windows
        overlap by roughly a read length, so without this every block
        boundary re-inflates the shared blocks (SURVEY §3.5 hot spot 4).

        Returns the decompressed bytes (np.uint8) or None (native layer
        unavailable / decode error — caller falls back)."""
        from hiphase_tpu_torch.io import native
        import numpy as np
        if span_end <= c0:
            return np.empty(0, dtype=np.uint8)

        def _block_offsets(comp: bytes, base: int):
            """(compressed absolute offsets, cumulative uncompressed
            offsets) of the blocks in ``comp`` — read from each block's
            BSIZE header field and ISIZE trailer, no inflation."""
            boffs = [base]
            uoffs = [0]
            pos = 0
            n = len(comp)
            while pos + 18 <= n:
                bsize = struct.unpack_from("<H", comp, pos + 16)[0] + 1
                if pos + bsize > n:
                    break
                isize = struct.unpack_from("<I", comp, pos + bsize - 4)[0]
                pos += bsize
                boffs.append(base + pos)
                uoffs.append(uoffs[-1] + isize)
            return boffs, uoffs

        cache = getattr(self, "_span_cache", None)
        if cache is not None:
            cc0, cc1, raw, boffs, uoffs = cache
            if cc0 <= c0 and span_end <= cc1:
                import bisect
                i = bisect.bisect_left(boffs, c0)
                j = bisect.bisect_left(boffs, span_end)
                if i < len(boffs) and boffs[i] == c0 \
                        and j < len(boffs) and boffs[j] == span_end:
                    return raw[uoffs[i]:uoffs[j]]
            elif cc0 <= c0 < cc1 and span_end > cc1:
                # extend: inflate only the new tail and keep one span
                import bisect
                i = bisect.bisect_left(boffs, c0)
                if i < len(boffs) and boffs[i] == c0:
                    self._rawfh.seek(cc1)
                    comp = self._rawfh.read(span_end - cc1)
                    tail = native.bgzf_decompress_all_arr(comp)
                    if tail is None:
                        return None
                    tb, tu = _block_offsets(comp, cc1)
                    boffs = boffs[:-1] + tb
                    uoffs = uoffs[:-1] + [uoffs[-1] + u for u in tu]
                    # keep whole decoded blocks only (drop any torn tail)
                    raw = np.concatenate([raw, tail])[:uoffs[-1]]
                    j = bisect.bisect_left(boffs, span_end)
                    ok = j < len(boffs) and boffs[j] == span_end
                    result = raw[uoffs[i]:uoffs[j]] if ok else None
                    # bound the cache: windows move forward, so everything
                    # before the current request start is dead weight
                    if i > 0:
                        u0 = uoffs[i]
                        raw = raw[u0:]
                        boffs = boffs[i:]
                        uoffs = [u - u0 for u in uoffs[i:]]
                    self._span_cache = (boffs[0], boffs[-1], raw, boffs,
                                        uoffs)
                    if ok:
                        return result

        self._rawfh.seek(c0)
        comp = self._rawfh.read(span_end - c0)
        raw = native.bgzf_decompress_all_arr(comp)
        if raw is None:
            return None
        boffs, uoffs = _block_offsets(comp, c0)
        # cache covers only whole decoded blocks (a torn trailing block
        # can't be reused)
        self._span_cache = (c0, boffs[-1], raw[:uoffs[-1]], boffs, uoffs)
        return raw

    def stream_raw_window(self, chrom: str, start: int, end_incl: int):
        """Monotone streaming bulk fetch for the ordered writer:
        successive calls with non-decreasing windows decode each BGZF
        block exactly ONCE. Returns chunk tuples of (raw, rec_off,
        rec_size, pos, rend, flag), or None when the native path is
        unavailable or the stream hit a decode error (callers MUST fall
        back to the record path — a None here means records may remain
        unread, never that the stream is simply done)."""
        from hiphase_tpu_torch.io import native
        if self._index is None or not native.available():
            return None
        tid = self.tid(chrom)
        if tid < 0:
            return []
        cur = getattr(self, "_win_cursor", None)
        if cur is None or cur.tid != tid or start < cur.watermark:
            if cur is not None:
                cur.close()
            cur = _BamStreamCursor(self, tid, start)
            self._win_cursor = cur
        if cur.error:
            return None
        out = cur.take(start, end_incl)
        if cur.error:
            return None
        return out

    def fetch_unmapped(self):
        """Yield fully unplaced records (refid < 0) at the file tail."""
        for rec in self:
            if rec.refid < 0:
                yield rec

    def fetch_unmapped_raw(self):
        """Native bulk form of fetch_unmapped: decode from the end of the
        last indexed chunk (unplaced records follow all mapped ones in a
        coordinate-sorted BAM) and return (raw, rec_off, rec_size, pos,
        rend, flag) chunks for refid<0 records — or None (fallback)."""
        from hiphase_tpu_torch.io import native
        import numpy as np
        if self._index is None or not native.available():
            return None
        bins = getattr(self._index, "bins", None)
        if bins is None:
            return None
        vmax = self._body_voffset
        for ref_bins in bins:
            for chunks in ref_bins.values():
                for _cb, ce in chunks:
                    vmax = max(vmax, ce)
        import struct as _struct
        names = [n.encode() for n in self.header.ref_names]
        name_off = np.zeros(len(names) + 1, dtype=np.int64)
        for i, nb in enumerate(names):
            name_off[i + 1] = name_off[i] + len(nb)
        name_blob = np.frombuffer(b"".join(names) or b"\x00", dtype=np.uint8)
        out = []
        slab_bytes = 8 << 20
        skip_u = vmax & 0xFFFF
        carry = np.empty(0, dtype=np.uint8)
        comp_carry = b""
        with open(self.path, "rb") as fh:
            fh.seek(vmax >> 16)
            while True:
                slab = fh.read(slab_bytes)
                data = comp_carry + slab
                end = 0
                while end + 18 <= len(data):
                    bsize = _struct.unpack_from("<H", data, end + 16)[0] + 1
                    if end + bsize > len(data):
                        break
                    end += bsize
                comp_carry = data[end:]
                if end == 0:
                    if slab and len(data) >= 18:
                        return None  # mid-file fragment: fall back
                    break
                raw = native.bgzf_decompress_all_arr(data[:end])
                if raw is None:
                    return None
                if skip_u:
                    raw = raw[skip_u:]
                    skip_u = 0
                buf = np.concatenate([carry, raw]) if len(carry) else raw
                scan = native.bam_scan_records(buf, name_blob, name_off)
                if scan is None:
                    return None
                (rtid, pos, rend, _mapq, flag, rec_off, rec_size,
                 *_sa, consumed) = scan
                carry = buf[consumed:]
                keep = rtid < 0
                if keep.any():
                    out.append((buf, rec_off[keep], rec_size[keep],
                                pos[keep], rend[keep], flag[keep]))
                if not slab:
                    break
        if len(carry):
            return None  # truncated record stream
        return out


class _BamStreamCursor:
    """Sequential decoder for stream_raw_window: decompresses forward in
    slabs, scans records natively, and hands out position-windows without
    ever decoding a compressed block twice."""

    SLAB = 4 << 20  # compressed bytes per read

    def __init__(self, reader: "BamReader", tid: int, start: int):
        import numpy as np
        self.reader = reader
        self.tid = tid
        self.watermark = start
        self.eof = False
        self.error = False  # decode failure: callers must use the fallback
        self._fh = None
        self._pend = None   # (raw, rec_off, rec_size, pos, rend, flag)
        self._idx = 0
        self._carry = np.empty(0, dtype=np.uint8)
        chunks = reader._index.query(tid, start, 2**40)
        if not chunks:
            self.eof = True
            self._coffset = 0
            self._skip_u = 0
            return
        vbeg = min(c for c, _ in chunks)
        self._coffset = vbeg >> 16
        self._skip_u = vbeg & 0xFFFF
        self._fh = open(reader.path, "rb")
        self._fh.seek(self._coffset)
        names = [n.encode() for n in reader.header.ref_names]
        self._name_off = np.zeros(len(names) + 1, dtype=np.int64)
        for i, nb in enumerate(names):
            self._name_off[i + 1] = self._name_off[i] + len(nb)
        self._name_blob = np.frombuffer(b"".join(names) or b"\x00",
                                        dtype=np.uint8)
        self._comp_carry = b""

    def _decode_more(self) -> bool:
        """Decode one more slab into the pending arrays; False at EOF."""
        import struct as _struct

        import numpy as np

        from hiphase_tpu_torch.io import native
        if self.eof or self.error:
            return False
        slab = self._fh.read(self.SLAB)
        data = self._comp_carry + slab
        end = 0
        while end + 18 <= len(data):
            bsize = _struct.unpack_from("<H", data, end + 16)[0] + 1
            if end + bsize > len(data):
                break
            end += bsize
        self._comp_carry = data[end:]
        if end == 0:
            if data and len(data) >= 18:
                self.error = True  # mid-file fragment that is not a block
            self.eof = True
            return False
        raw = native.bgzf_decompress_all_arr(data[:end])
        if raw is None:
            self.error = True  # corrupt block: NOT end-of-data
            self.eof = True
            return False
        if self._skip_u:
            raw = raw[self._skip_u:]
            self._skip_u = 0
        buf = np.concatenate([self._carry, raw]) if len(self._carry) else raw
        scan = native.bam_scan_records(buf, self._name_blob, self._name_off)
        if scan is None:
            self.error = True  # unsupported/malformed record: use fallback
            self.eof = True
            return False
        (rtid, pos, rend, _mapq, flag, rec_off, rec_size,
         *_sa, consumed) = scan
        self._carry = buf[consumed:]
        if not slab:
            self.eof = True
        keep = rtid == self.tid
        # records past this tid end the stream for this cursor
        if (rtid > self.tid).any() or (rtid < 0).any():
            self.eof = True
        self._pend = (buf, rec_off[keep], rec_size[keep], pos[keep],
                      rend[keep], flag[keep])
        self._idx = 0
        return True

    def take(self, start: int, end_incl: int):
        """Chunk tuples for records with start <= pos <= end_incl."""
        import numpy as np
        out = []
        self.watermark = max(self.watermark, start)
        while True:
            if self._pend is None or self._idx >= len(self._pend[1]):
                if not self._decode_more():
                    break
                continue
            buf, rec_off, rec_size, pos, rend, flag = self._pend
            lo = self._idx
            # skip records before the window (consumed by prior windows or
            # overlapping from an earlier start)
            while lo < len(pos) and pos[lo] < start:
                lo += 1
            hi = lo
            while hi < len(pos) and pos[hi] <= end_incl:
                hi += 1
            if hi > lo:
                out.append((buf, rec_off[lo:hi], rec_size[lo:hi],
                            pos[lo:hi], rend[lo:hi], flag[lo:hi]))
            self._idx = hi
            if hi < len(pos):
                break  # next record is beyond the window: stop decoding
        self.watermark = end_incl + 1
        return out

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except Exception:
                pass
            self._fh = None


def reg2bin(beg: int, end: int) -> int:
    """BAI bin for a [beg, end) interval (spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins overlapping [beg, end) (spec §5.3)."""
    bins = [0]
    end = min(end, 1 << 29)
    beg = min(beg, (1 << 29) - 1)
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class _CsiBamIndex:
    """Adapter: answer BaiIndex-style ``query(tid, start, end)`` from a
    .csi index (no name table; larger min_shift for >2^29 contigs)."""

    def __init__(self, csi):
        self._csi = csi

    def query(self, tid: int, start: int, end: int):
        return self._csi.query_tid(tid, start, end)


class BaiIndex:
    """BAI index: bins→chunks plus a 16kb linear index per reference."""

    def __init__(self, bins: list[dict[int, list[tuple[int, int]]]],
                 linear: list[list[int]],
                 n_no_coor: int = 0):
        self.bins = bins
        self.linear = linear
        self.n_no_coor = n_no_coor

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != BAI_MAGIC:
            raise BamError(f"{path}: not a BAI index")
        off = 4
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins_per_ref = []
        linear_per_ref = []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[bin_id] = chunks
            n_intv = struct.unpack_from("<i", data, off)[0]
            off += 4
            linear = list(struct.unpack_from(f"<{n_intv}Q", data, off))
            off += 8 * n_intv
            bins_per_ref.append(bins)
            linear_per_ref.append(linear)
        n_no_coor = struct.unpack_from("<Q", data, off)[0] if off + 8 <= len(data) else 0
        return cls(bins_per_ref, linear_per_ref, n_no_coor)

    def query(self, tid: int, start: int, end: int) -> list[tuple[int, int]]:
        """Merged chunk list for records possibly overlapping [start, end)."""
        if tid >= len(self.bins):
            return []
        bins = self.bins[tid]
        linear = self.linear[tid]
        min_off = 0
        if linear:
            w = min(start >> _LINEAR_SHIFT, len(linear) - 1)
            min_off = linear[w]
        chunks = []
        for b in reg2bins(start, end):
            if b == _PSEUDO_BIN:
                continue
            for cb, ce in bins.get(b, ()):
                if ce > min_off:
                    chunks.append((max(cb, min_off), ce))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for cb, ce in chunks:
            if merged and cb <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], ce))
            else:
                merged.append((cb, ce))
        return merged

    def save(self, path: str) -> None:
        out = bytearray(BAI_MAGIC)
        out += struct.pack("<i", len(self.bins))
        for bins, linear in zip(self.bins, self.linear):
            out += struct.pack("<i", len(bins))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                out += struct.pack("<Ii", bin_id, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            out += struct.pack("<i", len(linear))
            out += struct.pack(f"<{len(linear)}Q", *linear)
        out += struct.pack("<Q", self.n_no_coor)
        with open(path, "wb") as fh:
            fh.write(out)


class BaiBuilder:
    """Accumulates (tid, beg, end, voffset_start, voffset_end) per written
    record and emits a BAI (the analog of hts_idx_push + sam_idx_save)."""

    def __init__(self, n_ref: int):
        self.bins: list[dict[int, list[tuple[int, int]]]] = [dict() for _ in range(n_ref)]
        self.linear: list[list[int]] = [[] for _ in range(n_ref)]
        self.stats = [[0, 0, (1 << 64) - 1, 0] for _ in range(n_ref)]  # mapped, unmapped, off_beg, off_end
        self.n_no_coor = 0

    def add(self, tid: int, beg: int, end: int, vbeg: int, vend: int,
            mapped: bool = True) -> None:
        if tid < 0:
            self.n_no_coor += 1
            return
        b = reg2bin(beg, max(end, beg + 1))
        chunks = self.bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        lin = self.linear[tid]
        wbeg = beg >> _LINEAR_SHIFT
        wend = (max(end, beg + 1) - 1) >> _LINEAR_SHIFT
        while len(lin) <= wend:
            lin.append(0)
        for w in range(wbeg, wend + 1):
            if lin[w] == 0 or vbeg < lin[w]:
                lin[w] = vbeg
        st = self.stats[tid]
        st[0 if mapped else 1] += 1
        st[2] = min(st[2], vbeg)
        st[3] = max(st[3], vend)

    def build(self) -> BaiIndex:
        # backfill linear-index zeros with the next nonzero offset (htslib style)
        bins = []
        for tid, b in enumerate(self.bins):
            b = dict(b)
            st = self.stats[tid]
            if st[0] + st[1] > 0:
                b[_PSEUDO_BIN] = [(st[2], st[3]), (st[0], st[1])]
            bins.append(b)
            lin = self.linear[tid]
            last = 0
            for i in range(len(lin)):
                if lin[i] == 0:
                    lin[i] = last
                else:
                    last = lin[i]
        return BaiIndex(bins, self.linear, self.n_no_coor)


class BamWriter:
    """BAM writer over the batched BGZF codec (parallel deflate when the
    native library is built), building the BAI index from deferred
    uncompressed offsets."""

    def __init__(self, path: str, header: SamHeader, level: int = 6,
                 io_threads: int = 4):
        from hiphase_tpu_torch.io.bgzf import BgzfBatchWriter
        self.path = path
        self.header = header
        self._bgzf = BgzfBatchWriter(path, level=level, threads=io_threads)
        text = header.text.encode()
        buf = bytearray(BAM_MAGIC)
        buf += struct.pack("<i", len(text)) + text
        buf += struct.pack("<i", len(header.ref_names))
        for name, length in zip(header.ref_names, header.ref_lengths):
            nb = name.encode() + b"\x00"
            buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(bytes(buf))
        self._entries: list[tuple[int, int, int, int, int, bool]] = []
        self._closed = False

    def write(self, rec: BamRecord) -> None:
        ubeg = self._bgzf.upos
        self._bgzf.write(struct.pack("<i", len(rec.raw)) + rec.raw)
        uend = self._bgzf.upos
        end = rec.reference_end() if not rec.is_unmapped else rec.pos + 1
        self._entries.append((rec.refid, rec.pos, end, ubeg, uend,
                              not rec.is_unmapped))

    def write_raw_records(self, data, out_off, refid: int, pos, rend,
                          flag) -> None:
        """Append pre-serialized records (size-prefixed) in one write;
        index entries from the parallel pos/rend/flag arrays."""
        base = self._bgzf.upos
        self._bgzf.write(data.tobytes() if hasattr(data, "tobytes") else data)
        entries = self._entries
        for i in range(len(pos)):
            mapped = not (int(flag[i]) & FLAG_UNMAPPED)
            end = int(rend[i]) if mapped else int(pos[i]) + 1
            entries.append((refid, int(pos[i]), end,
                            base + int(out_off[i]), base + int(out_off[i + 1]),
                            mapped))

    def close(self) -> None:
        if self._closed:
            return
        self._bgzf.close()
        self._closed = True

    def write_index(self) -> None:
        assert self._closed, "close the BAM before writing its index"
        if max(self.header.ref_lengths, default=0) >= (1 << 29) - 1:
            # BAI cannot address contigs >= 2^29-1; emit .csi instead
            # (htslib makes the same switch)
            from hiphase_tpu_torch.io.tabix import TabixBuilder, depth_for
            ml = max(self.header.ref_lengths, default=0)
            tb = TabixBuilder(min_shift=14, depth=depth_for(ml))
            for refid, beg, end, ubeg, uend, _mapped in self._entries:
                if refid < 0:
                    continue  # unplaced: not binnable (BAI counts them too)
                # placed-unmapped records are indexed like the BAI path
                tb.add(str(refid), beg, end, self._bgzf.voffset(ubeg),
                       self._bgzf.voffset(uend))
            idx = tb.build()
            n_ref = len(self.header.ref_names)
            bins = [dict() for _ in range(n_ref)]
            linear = [[] for _ in range(n_ref)]
            for i, nm in enumerate(idx.names):
                bins[int(nm)] = idx.bins[i]
                linear[int(nm)] = idx.linear[i]
            idx.names, idx.bins, idx.linear = [], bins, linear
            idx.save_csi(self.path + ".csi")
            return
        bai = BaiBuilder(len(self.header.ref_names))
        for refid, beg, end, ubeg, uend, mapped in self._entries:
            bai.add(refid, beg, end, self._bgzf.voffset(ubeg),
                    self._bgzf.voffset(uend), mapped=mapped)
        bai.build().save(self.path + ".bai")
