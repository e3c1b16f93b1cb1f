"""BCF 2.2 reader/writer (the binary VCF container htslib's
`bcf::IndexedReader`/`Writer` handle transparently; ref: src/phaser.rs:43-45,
src/writers/ordered_vcf_writer.rs:100-118).

Design: the framework's record pipeline is text-line based (the native
`hn_vcf_scan` parses text), so `BcfReader` decodes binary records into VCF
text lines and `BcfWriter` encodes text lines back to binary. Indexing uses
.csi with the same virtual-offset semantics as tabix.

Implements the BCF2.2 typed-value encoding per the VCFv4.3/BCF spec
(section 6): descriptor byte = (count<<4)|type, count 15 -> following typed
int; types int8/16/32, float32, char; missing and END_OF_VECTOR sentinels;
GT stored as (allele+1)<<1|phased.
"""

from __future__ import annotations

import struct

from hiphase_tpu_torch.io.bgzf import BgzfBatchWriter, BgzfReader

BCF_MAGIC = b"BCF"

_MISSING = {1: -128, 2: -32768, 3: -2147483648}
_EOV = {1: -127, 2: -32767, 3: -2147483647}
_FLOAT_MISSING = 0x7F800001
_FLOAT_EOV = 0x7F800002


class BcfError(IOError):
    pass


def is_bcf(path: str) -> bool:
    """True when `path` is a BGZF stream whose payload starts with BCF\\2."""
    try:
        with BgzfReader(path) as bz:
            head = bz.read(5)
    except Exception:
        return False
    return head[:3] == BCF_MAGIC and len(head) >= 4 and head[3] == 2


# ---------------------------------------------------------------------------
# typed values


def _read_typed(buf: bytes, pos: int):
    """Returns (type, values list, pos). type 0 => MISSING (values [])."""
    d = buf[pos]
    pos += 1
    t = d & 0x0F
    n = d >> 4
    if n == 15:
        _t2, vals2, pos = _read_typed(buf, pos)
        n = vals2[0]
    if t == 0:
        return 0, [], pos
    if t == 1:
        vals = list(struct.unpack_from(f"<{n}b", buf, pos))
        pos += n
    elif t == 2:
        vals = list(struct.unpack_from(f"<{n}h", buf, pos))
        pos += 2 * n
    elif t == 3:
        vals = list(struct.unpack_from(f"<{n}i", buf, pos))
        pos += 4 * n
    elif t == 5:
        # floats carried as raw bits: missing/EOV are NaN payloads that
        # would not survive a float round-trip
        vals = list(struct.unpack_from(f"<{n}I", buf, pos))
        pos += 4 * n
    elif t == 7:
        vals = [buf[pos:pos + n]]
        pos += n
    else:
        raise BcfError(f"unsupported BCF type {t}")
    return t, vals, pos


def _write_typed_int(out: bytearray, vals: list[int]) -> None:
    lo = min(vals, default=0)
    hi = max(vals, default=0)
    if -120 <= lo and hi <= 127:
        t, fmt = 1, "b"
    elif -32000 <= lo and hi <= 32767:
        t, fmt = 2, "h"
    else:
        t, fmt = 3, "i"
    _write_descriptor(out, t, len(vals))
    out += struct.pack(f"<{len(vals)}{fmt}", *vals)


def _write_descriptor(out: bytearray, t: int, n: int) -> None:
    if n < 15:
        out.append((n << 4) | t)
    else:
        out.append((15 << 4) | t)
        _write_typed_int(out, [n])


def _write_typed_str(out: bytearray, s: bytes) -> None:
    _write_descriptor(out, 7, len(s))
    out += s


def _int_for_width(v: int, t: int) -> int:
    return v


# ---------------------------------------------------------------------------
# header dictionaries


def _parse_idx(line: bytes) -> int | None:
    k = line.find(b"IDX=")
    if k < 0:
        return None
    e = k + 4
    while e < len(line) and line[e:e + 1].isdigit():
        e += 1
    return int(line[k + 4:e])


def _header_dicts(lines: list[bytes]):
    """(contigs, strings): dictionary order per BCF spec — explicit IDX=
    wins; else order of appearance; FILTER/INFO/FORMAT share one string
    table with PASS at index 0."""
    contigs: dict[int, str] = {}
    strings: dict[int, str] = {}
    rev_str: dict[str, int] = {}
    next_c = 0

    def put_str(name: str, idx: int | None):
        nonlocal strings
        if name in rev_str:
            return
        if idx is None:
            idx = (max(strings.keys()) + 1) if strings else 0
        strings[idx] = name
        rev_str[name] = idx

    put_str("PASS", 0)
    for line in lines:
        if line.startswith(b"##contig=<"):
            body = line[len(b"##contig=<"):-1]
            name = None
            for kv in body.split(b","):
                if kv.startswith(b"ID="):
                    name = kv[3:].decode()
            idx = _parse_idx(line)
            if idx is None:
                idx = next_c
            contigs[idx] = name
            next_c = max(next_c, idx) + 1
        elif (line.startswith(b"##FILTER=<") or line.startswith(b"##INFO=<")
              or line.startswith(b"##FORMAT=<")):
            body = line.split(b"<", 1)[1][:-1]
            name = None
            for kv in body.split(b","):
                if kv.startswith(b"ID="):
                    name = kv[3:].decode()
            if name is not None:
                put_str(name, _parse_idx(line))
    contig_list = [contigs[i] for i in sorted(contigs)]
    n = (max(strings.keys()) + 1) if strings else 0
    string_list = [strings.get(i, "") for i in range(n)]
    return contig_list, string_list


# ---------------------------------------------------------------------------
# record -> text


def _fmt_int_vec(vals: list[int], width: int) -> bytes:
    parts = []
    for v in vals:
        if v == _EOV[width]:
            break
        parts.append(b"." if v == _MISSING[width] else b"%d" % v)
    return b",".join(parts)


def _fmt_float_bits(bits: int) -> bytes:
    if bits == _FLOAT_MISSING:
        return b"."
    v = struct.unpack("<f", struct.pack("<I", bits))[0]
    if v == int(v) and abs(v) < 1e15:
        return b"%d" % int(v)
    return repr(round(v, 6)).encode()


def _fmt_float_vec_bits(bits_list: list[int]) -> bytes:
    parts = []
    for bits in bits_list:
        if bits == _FLOAT_EOV:
            break
        parts.append(_fmt_float_bits(bits))
    return b",".join(parts)


def _typed_to_text(t: int, vals) -> bytes:
    if t == 0:
        return b""
    if t == 7:
        s = vals[0]
        return s.rstrip(b"\x00")
    if t == 5:
        return _fmt_float_vec_bits(vals)
    return _fmt_int_vec(vals, t)


def _gt_to_text(vals: list[int], width: int) -> bytes:
    parts = []
    for k, v in enumerate(vals):
        if v == _EOV[width]:
            break
        if v == _MISSING[width]:
            a = b"."
        else:
            # allele index is (v>>1)-1; index 0 in the high bits means
            # missing ('.'), independent of the phase bit (so '0|.' ->
            # [2, 1] round-trips)
            a = b"." if (v >> 1) == 0 else b"%d" % ((v >> 1) - 1)
        if k > 0:
            parts.append(b"|" if (v & 1) else b"/")
        parts.append(a)
    return b"".join(parts)


def decode_record(buf: bytes, pos: int, contigs: list[str],
                  strings: list[str], n_samples_hdr: int
                  ) -> tuple[bytes, int, int, int]:
    """Decode one BCF record at `pos` into a VCF text line.
    Returns (line, rid, pos0, end_pos_after_record)."""
    l_shared, l_indiv = struct.unpack_from("<II", buf, pos)
    body = pos + 8
    end = body + l_shared + l_indiv
    rid, p0, rlen = struct.unpack_from("<iii", buf, body)
    qual_bits = struct.unpack_from("<I", buf, body + 12)[0]
    n_allele_info = struct.unpack_from("<I", buf, body + 16)[0]
    n_fmt_sample = struct.unpack_from("<I", buf, body + 20)[0]
    n_info = n_allele_info & 0xFFFF
    n_allele = n_allele_info >> 16
    n_sample = n_fmt_sample & 0xFFFFFF
    n_fmt = n_fmt_sample >> 24
    cur = body + 24

    _t, idv, cur = _read_typed(buf, cur)
    rec_id = idv[0].rstrip(b"\x00") if idv else b""
    if not rec_id:
        rec_id = b"."
    alleles = []
    for _ in range(n_allele):
        _t, av, cur = _read_typed(buf, cur)
        alleles.append(av[0] if av else b"")
    _ft, fv, cur = _read_typed(buf, cur)
    if not fv or (len(fv) == 1 and isinstance(fv[0], bytes)):
        filt = b"."
    else:
        filt = b";".join(strings[i].encode() for i in fv) or b"."
    info_parts = []
    for _ in range(n_info):
        _kt, kv, cur = _read_typed(buf, cur)
        key = strings[kv[0]].encode()
        vt, vv, cur = _read_typed(buf, cur)
        if vt == 0:
            info_parts.append(key)  # flag
        else:
            info_parts.append(key + b"=" + _typed_to_text(vt, vv))

    qual = _fmt_float_bits(qual_bits)

    fields = [contigs[rid].encode(), b"%d" % (p0 + 1), rec_id,
              alleles[0] if alleles else b".",
              b",".join(alleles[1:]) if len(alleles) > 1 else b".",
              qual, filt,
              b";".join(info_parts) if info_parts else b"."]

    if n_fmt:
        keys = []
        cols: list[list[bytes]] = [[] for _ in range(n_sample)]
        cur2 = body + l_shared
        for _ in range(n_fmt):
            _kt, kv, cur2 = _read_typed(buf, cur2)
            key = strings[kv[0]]
            keys.append(key.encode())
            d = buf[cur2]
            t = d & 0x0F
            n = d >> 4
            cur2 += 1
            if n == 15:
                _t2, nn, cur2 = _read_typed(buf, cur2)
                n = nn[0]
            per = n
            for s in range(n_sample):
                if t == 0:
                    cols[s].append(b".")
                    continue
                if t == 7:
                    v = buf[cur2:cur2 + per]
                    cur2 += per
                    v = v.rstrip(b"\x00")
                    cols[s].append(v if v else b".")
                    continue
                if t == 5:
                    vals = list(struct.unpack_from(f"<{per}I", buf, cur2))
                    cur2 += 4 * per
                    cols[s].append(_fmt_float_vec_bits(vals) or b".")
                    continue
                w = {1: "b", 2: "h", 3: "i"}[t]
                vals = list(struct.unpack_from(f"<{per}{w}", buf, cur2))
                cur2 += per * struct.calcsize(w)
                if key == "GT":
                    cols[s].append(_gt_to_text(vals, t) or b".")
                else:
                    cols[s].append(_fmt_int_vec(vals, t) or b".")
        fields.append(b":".join(keys))
        for s in range(n_sample):
            fields.append(b":".join(cols[s]))
    return b"\t".join(fields), rid, p0, end


# ---------------------------------------------------------------------------
# text -> record


class _HeaderTypes:
    """INFO/FORMAT Type/Number declarations for encoding."""

    def __init__(self, lines: list[bytes]):
        self.info: dict[bytes, tuple[str, str]] = {}
        self.fmt: dict[bytes, tuple[str, str]] = {}
        for line in lines:
            for prefix, d in ((b"##INFO=<", self.info),
                              (b"##FORMAT=<", self.fmt)):
                if not line.startswith(prefix):
                    continue
                body = line.split(b"<", 1)[1][:-1]
                name, typ, num = None, "String", "."
                for kv in body.split(b","):
                    if kv.startswith(b"ID="):
                        name = kv[3:]
                    elif kv.startswith(b"Type="):
                        typ = kv[5:].decode()
                    elif kv.startswith(b"Number="):
                        num = kv[7:].decode()
                if name is not None:
                    d[name] = (typ, num)


def _encode_value(out: bytearray, typ: str, text: bytes) -> None:
    if typ == "Flag":
        _write_descriptor(out, 0, 0)
        return
    parts = text.split(b",")
    if typ == "Integer":
        vals = [_MISSING[3] if p == b"." else int(p) for p in parts]
        _write_typed_int(out, vals)
    elif typ == "Float":
        _write_descriptor(out, 5, len(parts))
        for p in parts:
            if p == b".":
                out += struct.pack("<I", _FLOAT_MISSING)
            else:
                out += struct.pack("<f", float(p))
    else:  # String / Character
        _write_typed_str(out, text)


def encode_record(line: bytes, contig_ids: dict[str, int],
                  string_ids: dict[str, int], types: _HeaderTypes,
                  n_samples: int) -> bytes:
    f = line.split(b"\t")
    if len(f) < 8:
        raise BcfError(f"short VCF line: {line[:60]!r}")
    rid = contig_ids[f[0].decode()]
    p0 = int(f[1]) - 1
    alleles = [f[3]] + ([] if f[4] == b"." else f[4].split(b","))

    shared = bytearray()
    shared += struct.pack("<iii", rid, p0, len(f[3]))
    if f[5] == b".":
        shared += struct.pack("<I", _FLOAT_MISSING)
    else:
        shared += struct.pack("<f", float(f[5]))
    info_items = [] if f[7] == b"." else f[7].split(b";")
    fmt_keys = f[8].split(b":") if len(f) > 8 and f[8] != b"." else []
    shared += struct.pack("<I", (len(alleles) << 16) | len(info_items))
    shared += struct.pack("<I", (len(fmt_keys) << 24) | n_samples)

    def sid(key: bytes) -> int:
        try:
            return string_ids[key.decode()]
        except KeyError:
            raise BcfError(
                f"key {key.decode()!r} is not declared in the header "
                "(##INFO/##FORMAT/##FILTER definitions are required for "
                "BCF output)")

    _write_typed_str(shared, b"" if f[2] == b"." else f[2])
    for a in alleles:
        _write_typed_str(shared, a)
    if f[6] == b".":
        _write_descriptor(shared, 1, 0)
    else:
        _write_typed_int(shared, [sid(x) for x in f[6].split(b";")])
    for item in info_items:
        if b"=" in item:
            k, v = item.split(b"=", 1)
        else:
            k, v = item, None
        _write_typed_int(shared, [sid(k)])
        typ, _num = types.info.get(k, ("String", "."))
        if v is None:
            _write_descriptor(shared, 0, 0)
        else:
            _encode_value(shared, typ, v)

    indiv = bytearray()
    if fmt_keys:
        sample_vals = [f[9 + s].split(b":") for s in range(n_samples)]
        for ki, key in enumerate(fmt_keys):
            _write_typed_int(indiv, [sid(key)])
            col = [sv[ki] if ki < len(sv) else b"." for sv in sample_vals]
            if key == b"GT":
                encoded = []
                width = 1
                for gt in col:
                    es = []
                    if gt in (b".", b""):
                        es = [0]
                    else:
                        sep_phased = False
                        token = b""
                        for ch in gt + b"/":
                            if ch in (ord("/"), ord("|")):
                                a = 0 if token == b"." else int(token) + 1
                                es.append((a << 1) | (1 if sep_phased else 0))
                                sep_phased = ch == ord("|")
                                token = b""
                            else:
                                token += bytes([ch])
                    encoded.append(es)
                per = max(len(e) for e in encoded)
                hi = max((max(e) for e in encoded if e), default=0)
                t = 1 if hi <= 120 else (2 if hi <= 32000 else 3)
                fmt_c = {1: "b", 2: "h", 3: "i"}[t]
                _write_descriptor(indiv, t, per)
                for es in encoded:
                    es = es + [_EOV[t]] * (per - len(es))
                    indiv += struct.pack(f"<{per}{fmt_c}", *es)
            else:
                typ, _num = types.fmt.get(key, ("String", "."))
                if typ == "Integer":
                    vals = [[_MISSING[3]] if c == b"." else
                            [_MISSING[3] if p == b"." else int(p)
                             for p in c.split(b",")] for c in col]
                    per = max(len(v) for v in vals)
                    flat = []
                    for v in vals:
                        flat.extend(v + [_EOV[3]] * (per - len(v)))
                    lo, hi = min(flat), max(flat)
                    if -120 <= lo and hi <= 127:
                        t, fmt_c = 1, "b"
                        flat = [(_MISSING[1] if x == _MISSING[3] else
                                 _EOV[1] if x == _EOV[3] else x)
                                for x in flat]
                    elif -32000 <= lo and hi <= 32767:
                        t, fmt_c = 2, "h"
                        flat = [(_MISSING[2] if x == _MISSING[3] else
                                 _EOV[2] if x == _EOV[3] else x)
                                for x in flat]
                    else:
                        t, fmt_c = 3, "i"
                    _write_descriptor(indiv, t, per)
                    indiv += struct.pack(f"<{len(flat)}{fmt_c}", *flat)
                elif typ == "Float":
                    vals = [[] if c == b"." else c.split(b",") for c in col]
                    per = max(max((len(v) for v in vals), default=1), 1)
                    _write_descriptor(indiv, 5, per)
                    for v in vals:
                        row = []
                        for p in v:
                            row.append(_FLOAT_MISSING if p == b"."
                                       else struct.unpack(
                                           "<I", struct.pack("<f", float(p))
                                       )[0])
                        row += [_FLOAT_MISSING] * (1 - len(row)) if not row \
                            else []
                        row += [_FLOAT_EOV] * (per - len(row))
                        for bits in row:
                            indiv += struct.pack("<I", bits)
                else:
                    per = max(max((len(c) for c in col), default=1), 1)
                    _write_descriptor(indiv, 7, per)
                    for c in col:
                        s = b"" if c == b"." else c
                        indiv += s.ljust(per, b"\x00")

    return struct.pack("<II", len(shared), len(indiv)) + bytes(shared) + \
        bytes(indiv)


# ---------------------------------------------------------------------------
# reader / writer


class BcfReader:
    """Indexed BCF reader yielding VCF text lines (bytes)."""

    def __init__(self, path: str):
        self.path = path
        bz = BgzfReader(path)
        magic = bz.read(5)
        if magic[:3] != BCF_MAGIC or magic[3] != 2:
            bz.close()
            raise BcfError(f"{path}: not a BCF2 file")
        l_text = struct.unpack("<I", bz.read(4))[0]
        text = bz.read(l_text).rstrip(b"\x00")
        self.header_lines = [l for l in text.split(b"\n") if l]
        self._body_voffset = bz.virtual_offset
        bz.close()
        self.contigs, self.strings = _header_dicts(self.header_lines)
        col = self.header_lines[-1]
        assert col.startswith(b"#CHROM"), "BCF header missing #CHROM line"
        cols = col.split(b"\t")
        self.samples = [c.decode() for c in cols[9:]]
        self._index = None
        try:
            from hiphase_tpu_torch.io.tabix import TabixIndex
            idx = TabixIndex.load_csi(path + ".csi")
            if not idx.names:
                idx.names = list(self.contigs)
            self._index = idx
        except OSError:
            pass

    def header_text(self) -> bytes:
        return b"\n".join(self.header_lines) + b"\n"

    def _iter_from(self, bz: BgzfReader):
        while True:
            head = bz.read(8)
            if len(head) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", head)
            body = bz.read(l_shared + l_indiv)
            if len(body) < l_shared + l_indiv:
                return
            line, rid, p0, _end = decode_record(
                head + body, 0, self.contigs, self.strings,
                len(self.samples))
            yield line, rid, p0

    def __iter__(self):
        """Yield all records as text lines."""
        with BgzfReader(self.path) as bz:
            bz.seek_virtual(self._body_voffset)
            for line, _rid, _p0 in self._iter_from(bz):
                yield line

    def fetch_lines(self, chrom: str, start: int, end: int):
        """Text lines of records overlapping [start, end) on chrom."""
        try:
            rid = self.contigs.index(chrom)
        except ValueError:
            return
        if self._index is not None:
            chunks = self._index.query_tid(rid, start, end)
            with BgzfReader(self.path) as bz:
                for cbeg, cend in chunks:
                    bz.seek_virtual(cbeg)
                    it = self._iter_from(bz)
                    while bz.virtual_offset < cend:
                        got = next(it, None)
                        if got is None:
                            break
                        line, r, p0 = got
                        if r != rid or p0 >= end:
                            break
                        ref_len = len(line.split(b"\t", 4)[3])
                        if p0 + ref_len > start:
                            yield line
        else:
            for line in self:
                f = line.split(b"\t", 4)
                if f[0].decode() != chrom:
                    continue
                p0 = int(f[1]) - 1
                if p0 < end and p0 + len(f[3]) > start:
                    yield line


class BcfWriter:
    """BCF writer fed with VCF text lines; builds a .csi index."""

    def __init__(self, path: str, header_lines: list[bytes],
                 io_threads: int = 4):
        self.path = path
        self.header_lines = list(header_lines)
        self.contigs, self.strings = _header_dicts(self.header_lines)
        self._contig_ids = {c: i for i, c in enumerate(self.contigs)}
        self._string_ids = {s: i for i, s in enumerate(self.strings)}
        self._types = _HeaderTypes(self.header_lines)
        col = self.header_lines[-1]
        assert col.startswith(b"#CHROM")
        self.n_samples = max(len(col.split(b"\t")) - 9, 0)
        self._bgzf = BgzfBatchWriter(path, threads=io_threads)
        text = b"\n".join(self.header_lines) + b"\n\x00"
        self._bgzf.write(b"BCF\x02\x02" + struct.pack("<I", len(text)) + text)
        self._entries: list[tuple[int, int, int, int, int]] = []
        self._closed = False

    def write_line(self, line: bytes) -> None:
        f = line.split(b"\t", 4)
        rid = self._contig_ids[f[0].decode()]
        p0 = int(f[1]) - 1
        ubeg = self._bgzf.upos
        self._bgzf.write(encode_record(line, self._contig_ids,
                                       self._string_ids, self._types,
                                       self.n_samples))
        self._entries.append((rid, p0, p0 + max(len(f[3]), 1), ubeg,
                              self._bgzf.upos))

    def close(self) -> None:
        if self._closed:
            return
        self._bgzf.close()
        self._closed = True

    def write_index(self) -> None:
        from hiphase_tpu_torch.io.tabix import TabixBuilder, depth_for
        assert self._closed
        max_end = max((e for _r, _b, e, _u, _v in self._entries), default=0)
        tb = TabixBuilder(min_shift=14, depth=depth_for(max_end))
        # upos -> virtual offsets via the writer's block table
        for rid, beg, end, ubeg, uend in self._entries:
            tb.add(str(rid), beg, end, self._bgzf.voffset(ubeg),
                   self._bgzf.voffset(uend))
        idx = tb.build()
        # by-tid order: TabixBuilder keyed names "0","1",...; remap dense
        order = sorted(range(len(idx.names)), key=lambda i: int(idx.names[i]))
        n_ref = (max(int(n) for n in idx.names) + 1) if idx.names else 0
        bins = [dict() for _ in range(n_ref)]
        linear = [[] for _ in range(n_ref)]
        for i in order:
            tid = int(idx.names[i])
            bins[tid] = idx.bins[i]
            linear[tid] = idx.linear[i]
        idx.names, idx.bins, idx.linear = [], bins, linear
        idx.save_csi(self.path + ".csi")
