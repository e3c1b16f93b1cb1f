"""CRAM 3.0 reader/writer (restricted profile) + .crai index.

The reference supports CRAM input/output by extension via htslib
(ref: src/writers/ordered_bam_writer.rs:76-80). This environment has no
htslib, so the container format is implemented natively against the CRAM
3.0 specification, covering the profile this framework emits and consumes:

  * file definition, containers (ITF8/LTF8 varints, CRC32), gzip/raw block
    compression methods
  * one compression header per container: preservation map (RN/AP/RR/SM/TD),
    data-series encoding map, tag encoding map — all series EXTERNAL,
    byte arrays via BYTE_ARRAY_STOP, tags via BYTE_ARRAY_LEN
  * single-reference mapped slices with reference-based sequence encoding:
    substitution (X) features against the reference using the SM
    substitution matrix, insertion (I), soft-clip (S), deletion (D),
    ref-skip (N), hard-clip (H), padding (P) features; verbatim qualities
  * unmapped records with verbatim bases
  * the spec EOF container, and the .crai index (gzip text of
    seqid/start/span/container-offset/slice-offset/slice-size)

Decoded records materialize as `BamRecord`s (the BAM byte layout), so every
downstream consumer — realignment, haplotagging, writers — is agnostic to
the container format. Round-trip (BAM → CRAM → BAM) equality is pinned in
tests/test_cram.py; phasing from CRAM input to haplotagged CRAM output is
covered end-to-end there too.
"""

from __future__ import annotations

import gzip
import struct
import zlib

import numpy as np

CRAM_MAGIC = b"CRAM"
EOF_START = 4_542_278  # 0x454F46 "EOF" — marks the spec EOF container

BLOCK_RAW = 0
BLOCK_GZIP = 1
BLOCK_RANS4X8 = 4  # htslib's default for many external series
BLOCK_RANSNX16 = 5  # CRAM 3.1 rANS Nx16

CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_MAPPED_SLICE = 2
CT_EXTERNAL = 4

# external block content ids (writer's fixed layout)
BID_BF, BID_CF, BID_RL, BID_AP, BID_RG, BID_RN, BID_MF, BID_NS, BID_NP, \
    BID_TS, BID_TL, BID_FN, BID_FC, BID_FP, BID_DL, BID_BS, BID_IN, \
    BID_SC, BID_MQ, BID_QS, BID_BA, BID_TAGL, BID_TAGV, BID_HC, BID_PD, \
    BID_RS = range(1, 27)

_SUB_BASES = {  # substitution candidates per reference base, fixed order
    ord("A"): b"CGTN", ord("C"): b"AGTN", ord("G"): b"ACTN",
    ord("T"): b"ACGN", ord("N"): b"ACGT",
}

CIGAR_OPS = "MIDNSHP=X"
SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_OF = {ch: i for i, ch in enumerate(SEQ_NT16)}


class CramError(IOError):
    pass


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def write_itf8(out: bytearray, value: int) -> None:
    v = value & 0xFFFFFFFF
    if v < 0x80:
        out.append(v)
    elif v < 0x4000:
        out += bytes([0x80 | (v >> 8), v & 0xFF])
    elif v < 0x200000:
        out += bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    elif v < 0x10000000:
        out += bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    else:
        out += bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                      (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        v, n = b0, 1
    elif b0 < 0xC0:
        v = ((b0 & 0x3F) << 8) | buf[pos + 1]
        n = 2
    elif b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2]
        n = 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (buf[pos + 1] << 16) | \
            (buf[pos + 2] << 8) | buf[pos + 3]
        n = 4
    else:
        v = ((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | \
            (buf[pos + 2] << 12) | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F)
        n = 5
    if v >= 0x80000000:
        v -= 0x100000000
    return v, pos + n


def write_ltf8(out: bytearray, value: int) -> None:
    v = value & 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        out.append(v)
        return
    # pick the smallest n extra bytes in 1..8 such that the value fits in
    # (7 - n) prefix bits + 8·n payload bits
    for n in range(1, 8):
        if v < (1 << (8 * n + (7 - n))):
            prefix = (0xFF << (8 - n)) & 0xFF
            out.append(prefix | (v >> (8 * n)))
            for k in range(n - 1, -1, -1):
                out.append((v >> (8 * k)) & 0xFF)
            return
    out.append(0xFF)
    for k in range(7, -1, -1):
        out.append((v >> (8 * k)) & 0xFF)


def read_ltf8(buf, pos: int) -> tuple[int, int]:
    b0 = buf[pos]
    n = 0
    probe = b0
    while probe & 0x80:
        n += 1
        probe = (probe << 1) & 0xFF
    if n == 0:
        return b0, pos + 1
    if n >= 8:
        v = 0
        for k in range(8):
            v = (v << 8) | buf[pos + 1 + k]
        n_read = 9
    else:
        v = b0 & (0xFF >> (n + 1))
        for k in range(n):
            v = (v << 8) | buf[pos + 1 + k]
        n_read = n + 1
    if v >= 0x8000000000000000:
        v -= 0x10000000000000000
    return v, pos + n_read


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _write_block(out: bytearray, method: int, ctype: int, content_id: int,
                 data: bytes) -> None:
    if method == BLOCK_GZIP:
        comp = gzip.compress(data, compresslevel=4)
        if len(comp) >= len(data):
            method, comp = BLOCK_RAW, data
    elif method == BLOCK_RANS4X8:
        from hiphase_tpu_torch.io import rans
        comp = rans.compress(data, order=0)
        if len(comp) >= len(data) or not data:
            method, comp = BLOCK_RAW, data
    elif method == BLOCK_RANSNX16:
        from hiphase_tpu_torch.io import rans_nx16
        comp = rans_nx16.compress(data, order=0)
        if len(comp) >= len(data) or not data:
            method, comp = BLOCK_RAW, data
    else:
        comp = data
    blk = bytearray()
    blk.append(method)
    blk.append(ctype)
    write_itf8(blk, content_id)
    write_itf8(blk, len(comp))
    write_itf8(blk, len(data))
    blk += comp
    blk += struct.pack("<I", zlib.crc32(bytes(blk)))  # CRC over the block
    out += blk


def _read_block(buf, pos: int):
    method = buf[pos]
    ctype = buf[pos + 1]
    content_id, pos2 = read_itf8(buf, pos + 2)
    csize, pos2 = read_itf8(buf, pos2)
    usize, pos2 = read_itf8(buf, pos2)
    comp = bytes(buf[pos2:pos2 + csize])
    pos2 += csize
    pos2 += 4  # CRC32
    if method == BLOCK_RAW:
        data = comp
    elif method == BLOCK_GZIP:
        data = gzip.decompress(comp)
    elif method == BLOCK_RANS4X8:
        from hiphase_tpu_torch.io import native, rans
        data = native.rans_uncompress(comp, usize)
        if data is None:  # no native lib / malformed: the oracle decides
            data = rans.uncompress(comp)
    elif method == BLOCK_RANSNX16:
        from hiphase_tpu_torch.io import rans_nx16
        data = rans_nx16.uncompress(comp)
    else:
        raise CramError(f"unsupported CRAM block compression method {method}")
    if len(data) != usize:
        raise CramError("CRAM block size mismatch")
    return method, ctype, content_id, data, pos2


class _Reader:
    """Byte cursor over one external block."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def itf8(self) -> int:
        v, self.pos = read_itf8(self.buf, self.pos)
        return v

    def ltf8(self) -> int:
        v, self.pos = read_ltf8(self.buf, self.pos)
        return v

    def bytes_until(self, stop: int) -> bytes:
        end = self.buf.index(stop, self.pos)
        out = self.buf[self.pos:end]
        self.pos = end + 1
        return out

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

_DATA_SERIES = [  # (key, external content id)
    (b"BF", BID_BF), (b"CF", BID_CF), (b"RL", BID_RL), (b"AP", BID_AP),
    (b"RG", BID_RG), (b"RN", BID_RN), (b"MF", BID_MF), (b"NS", BID_NS),
    (b"NP", BID_NP), (b"TS", BID_TS), (b"TL", BID_TL), (b"FN", BID_FN),
    (b"FC", BID_FC), (b"FP", BID_FP), (b"DL", BID_DL), (b"BS", BID_BS),
    (b"IN", BID_IN), (b"SC", BID_SC), (b"MQ", BID_MQ), (b"QS", BID_QS),
    (b"BA", BID_BA), (b"HC", BID_HC), (b"PD", BID_PD), (b"RS", BID_RS),
]

_SM_BYTES = bytes([0b00011011] * 5)  # alphabetical substitution ranks


def _encode_external(content_id: int) -> bytes:
    enc = bytearray()
    write_itf8(enc, 1)  # codec EXTERNAL
    params = bytearray()
    write_itf8(params, content_id)
    write_itf8(enc, len(params))
    enc += params
    return bytes(enc)


def _encode_byte_array_stop(stop: int, content_id: int) -> bytes:
    enc = bytearray()
    write_itf8(enc, 5)  # codec BYTE_ARRAY_STOP
    params = bytearray()
    params.append(stop)
    write_itf8(params, content_id)
    write_itf8(enc, len(params))
    enc += params
    return bytes(enc)


def _encode_byte_array_len(len_cid: int, val_cid: int) -> bytes:
    enc = bytearray()
    write_itf8(enc, 4)  # codec BYTE_ARRAY_LEN
    params = bytearray()
    params += _encode_external(len_cid)
    params += _encode_external(val_cid)
    write_itf8(enc, len(params))
    enc += params
    return bytes(enc)


def _build_compression_header(tag_ids: list[bytes],
                              td_lines: list[list[bytes]]) -> bytes:
    # preservation map
    pm = bytearray()
    entries = bytearray()
    n = 0
    for key, val in ((b"RN", b"\x01"), (b"AP", b"\x00"), (b"RR", b"\x01")):
        entries += key + val
        n += 1
    entries += b"SM" + _SM_BYTES
    n += 1
    td_blob = bytearray()
    for line in td_lines:
        for tid in line:
            td_blob += tid
        td_blob.append(0)
    entries += b"TD"
    write_itf8(entries, len(td_blob))
    entries += td_blob
    n += 1
    body = bytearray()
    write_itf8(body, n)
    body += entries
    write_itf8(pm, len(body))
    pm += body

    # data series encoding map
    dsm_entries = bytearray()
    for key, cid in _DATA_SERIES:
        dsm_entries += key
        if key in (b"IN", b"SC"):
            dsm_entries += _encode_byte_array_stop(0, cid)
        elif key == b"RN":
            dsm_entries += _encode_byte_array_stop(0, cid)
        elif key in (b"QS", b"BA", b"BS", b"FC"):
            dsm_entries += _encode_external(cid)
        else:
            dsm_entries += _encode_external(cid)
    body = bytearray()
    write_itf8(body, len(_DATA_SERIES))
    body += dsm_entries
    dsm = bytearray()
    write_itf8(dsm, len(body))
    dsm += body

    # tag encoding map: every tag value as BYTE_ARRAY_LEN over two externals
    tem_entries = bytearray()
    for tid in tag_ids:
        key = (tid[0] << 16) | (tid[1] << 8) | tid[2]
        write_itf8(tem_entries, key)
        tem_entries += _encode_byte_array_len(BID_TAGL, BID_TAGV)
    body = bytearray()
    write_itf8(body, len(tag_ids))
    body += tem_entries
    tem = bytearray()
    write_itf8(tem, len(body))
    tem += body

    return bytes(pm + dsm + tem)


def _parse_encoding(rd: _Reader):
    codec = rd.itf8()
    plen = rd.itf8()
    params = _Reader(rd.take(plen))
    if codec == 1:  # EXTERNAL
        return ("external", params.itf8())
    if codec == 5:  # BYTE_ARRAY_STOP
        stop = params.buf[0]
        params.pos = 1
        return ("bas", stop, params.itf8())
    if codec == 4:  # BYTE_ARRAY_LEN
        len_enc = _parse_encoding(params)
        val_enc = _parse_encoding(params)
        return ("bal", len_enc, val_enc)
    raise CramError(f"unsupported CRAM codec {codec}")


def _parse_compression_header(data: bytes):
    rd = _Reader(data)
    # preservation map
    pm_len = rd.itf8()
    pm = _Reader(rd.take(pm_len))
    n = pm.itf8()
    preservation = {"RN": True, "AP": False, "RR": True,
                    "SM": _SM_BYTES, "TD": [[]]}
    for _ in range(n):
        key = pm.take(2)
        if key in (b"RN", b"AP", b"RR"):
            preservation[key.decode()] = bool(pm.take(1)[0])
        elif key == b"SM":
            preservation["SM"] = pm.take(5)
        elif key == b"TD":
            blob = pm.take(pm.itf8())
            lines = []
            for part in blob.split(b"\x00")[:-1]:
                lines.append([part[i:i + 3] for i in range(0, len(part), 3)])
            preservation["TD"] = lines or [[]]
        else:
            raise CramError(f"unknown preservation key {key!r}")
    # data series map
    dsm_len = rd.itf8()
    dsm = _Reader(rd.take(dsm_len))
    n = dsm.itf8()
    series = {}
    for _ in range(n):
        key = dsm.take(2)
        series[key] = _parse_encoding(dsm)
    # tag encoding map
    tem_len = rd.itf8()
    tem = _Reader(rd.take(tem_len))
    n = tem.itf8()
    tags = {}
    for _ in range(n):
        key = tem.itf8()
        tid = bytes([(key >> 16) & 0xFF, (key >> 8) & 0xFF, key & 0xFF])
        tags[tid] = _parse_encoding(tem)
    return preservation, series, tags


# ---------------------------------------------------------------------------
# substitution matrix
# ---------------------------------------------------------------------------

def _sub_code(sm: bytes, ref_base: int, read_base: int) -> int | None:
    order = "ACGTN"
    try:
        ri = order.index(chr(ref_base))
    except ValueError:
        ri = 4
    subs = _SUB_BASES.get(ord(order[ri]), b"ACGT")
    try:
        si = subs.index(read_base)
    except ValueError:
        return None
    byte = sm[ri]
    return (byte >> (6 - 2 * si)) & 0x3


def _sub_base(sm: bytes, ref_base: int, code: int) -> int:
    order = "ACGTN"
    try:
        ri = order.index(chr(ref_base))
    except ValueError:
        ri = 4
    subs = _SUB_BASES.get(ord(order[ri]), b"ACGT")
    byte = sm[ri]
    for si in range(4):
        if ((byte >> (6 - 2 * si)) & 0x3) == code:
            return subs[si]
    raise CramError("invalid substitution code")


# ---------------------------------------------------------------------------
# record codec
# ---------------------------------------------------------------------------

class _SeriesOut:
    """Per-container output streams, keyed by external content id."""

    def __init__(self):
        self.streams: dict[int, bytearray] = {cid: bytearray()
                                              for _k, cid in _DATA_SERIES}
        self.streams[BID_TAGL] = bytearray()
        self.streams[BID_TAGV] = bytearray()

    def itf8(self, cid: int, v: int) -> None:
        write_itf8(self.streams[cid], v)

    def ltf8(self, cid: int, v: int) -> None:
        write_ltf8(self.streams[cid], v)

    def raw(self, cid: int, b: bytes) -> None:
        self.streams[cid] += b


def _encode_record(rec, ref_seq: bytes | None, out: _SeriesOut,
                   td_index: dict[tuple, int], td_lines: list[list[bytes]],
                   tag_ids: dict[bytes, None]) -> None:
    """Encode one BamRecord into the series streams. ``ref_seq`` is the
    record's chromosome sequence (None for unmapped records)."""
    flag = rec.flag
    unmapped = rec.is_unmapped or rec.refid < 0 or ref_seq is None
    out.itf8(BID_BF, flag)
    out.itf8(BID_CF, 0x3 | (0x8 if unmapped else 0))
    out.itf8(BID_RL, rec.l_seq)
    out.itf8(BID_AP, rec.pos + 1)
    out.itf8(BID_RG, -1)
    out.raw(BID_RN, rec.read_name.encode() + b"\x00")
    next_refid, next_pos, tlen = struct.unpack_from("<iii", rec.raw, 20)
    out.itf8(BID_MF, 0)
    out.itf8(BID_NS, next_refid)
    out.itf8(BID_NP, next_pos + 1)
    out.itf8(BID_TS, tlen)

    # tags
    line = []
    vals = []
    for tag, tc, s, e, _val in rec._iter_aux():
        tid = tag.encode() + tc.encode()
        line.append(tid)
        vals.append(rec.raw[s + 3:e])
        tag_ids[tid] = None
    key = tuple(line)
    tl = td_index.get(key)
    if tl is None:
        tl = len(td_lines)
        td_lines.append(line)
        td_index[key] = tl
    out.itf8(BID_TL, tl)
    for vb in vals:
        out.itf8(BID_TAGL, len(vb))
        out.raw(BID_TAGV, vb)

    seq = rec.query_sequence()
    quals = rec.query_qualities()
    if unmapped:
        out.raw(BID_BA, seq)
        out.raw(BID_QS, quals)
        return

    # features from the CIGAR + reference diff
    feats = []  # (read_pos_1based, code, payload)
    q = 0
    r = rec.pos
    for op, length in rec.cigar():
        if op in "M=X":
            ref_chunk = ref_seq[r:r + length]
            read_chunk = seq[q:q + length]
            if ref_chunk != read_chunk:
                a = np.frombuffer(read_chunk, np.uint8)
                b = np.frombuffer(ref_chunk.ljust(length, b"N"), np.uint8)
                for k in np.flatnonzero(a != b):
                    k = int(k)
                    code = _sub_code(_SM_BYTES, b[k], a[k])
                    if code is None:
                        feats.append((q + k + 1, ord("B"), bytes([a[k]])))
                    else:
                        feats.append((q + k + 1, ord("X"), code))
            q += length
            r += length
        elif op == "I":
            feats.append((q + 1, ord("I"), seq[q:q + length]))
            q += length
        elif op == "S":
            feats.append((q + 1, ord("S"), seq[q:q + length]))
            q += length
        elif op == "D":
            feats.append((q + 1, ord("D"), length))
            r += length
        elif op == "N":
            feats.append((q + 1, ord("N"), length))
            r += length
        elif op == "H":
            feats.append((q + 1, ord("H"), length))
        elif op == "P":
            feats.append((q + 1, ord("P"), length))
        else:
            raise CramError(f"unsupported CIGAR op {op!r} for CRAM")

    out.itf8(BID_FN, len(feats))
    prev = 0
    for p, code, payload in feats:
        out.raw(BID_FC, bytes([code]))
        out.itf8(BID_FP, p - prev)
        prev = p
        if code == ord("X"):
            out.raw(BID_BS, bytes([payload]))
        elif code == ord("B"):
            # spec §10.5: ReadBase is a (base, quality) pair; the quality
            # byte keeps htslib's QS stream in sync even though this
            # profile also stores the full quality array (CF bit 0x1)
            out.raw(BID_BA, payload)
            out.raw(BID_QS, bytes([quals[p - 1]]))
        elif code in (ord("I"), ord("S")):
            out.raw(BID_IN if code == ord("I") else BID_SC,
                    payload + b"\x00")
        elif code == ord("D"):
            out.itf8(BID_DL, payload)
        elif code == ord("N"):
            out.itf8(BID_RS, payload)
        elif code == ord("H"):
            out.itf8(BID_HC, payload)
        elif code == ord("P"):
            out.itf8(BID_PD, payload)
    out.itf8(BID_MQ, rec.mapq)
    out.raw(BID_QS, quals)


def _pack_bam_record(refid, pos, mapq, flag, name, cigar, seq, quals,
                     next_refid, next_pos, tlen, aux: bytes):
    from hiphase_tpu_torch.io.bam import BamRecord, reg2bin
    name_b = name + b"\x00"
    n_cigar = len(cigar)
    l_seq = len(seq)
    end = pos
    for op, length in cigar:
        if op in "MDN=X":
            end += length
    body = bytearray()
    body += struct.pack("<iiBBHHHIiii", refid, pos, len(name_b), mapq,
                        reg2bin(pos, max(end, pos + 1)), n_cigar, flag,
                        l_seq, next_refid, next_pos, tlen)
    body += name_b
    for op, length in cigar:
        body += struct.pack("<I", (length << 4) | CIGAR_OPS.index(op))
    packed = bytearray((l_seq + 1) // 2)
    for i, b in enumerate(seq):
        nib = _NT16_OF.get(chr(b), 15)
        if i % 2 == 0:
            packed[i // 2] |= nib << 4
        else:
            packed[i // 2] |= nib
    body += packed
    body += quals
    body += aux
    return BamRecord.parse(bytes(body))


class _SeriesIn:
    """Per-container input cursors over the decoded external blocks."""

    def __init__(self, blocks: dict[int, bytes]):
        self.rd = {cid: _Reader(data) for cid, data in blocks.items()}

    def itf8(self, cid: int) -> int:
        return self.rd[cid].itf8()

    def until0(self, cid: int) -> bytes:
        return self.rd[cid].bytes_until(0)

    def take(self, cid: int, n: int) -> bytes:
        return self.rd[cid].take(n)


def _decode_record(sin: _SeriesIn, preservation, td_lines, slice_refid,
                   ref_names, reference_genome):
    sm = preservation["SM"]
    flag = sin.itf8(BID_BF)
    cf = sin.itf8(BID_CF)
    rl = sin.itf8(BID_RL)
    ap = sin.itf8(BID_AP)
    _rg = sin.itf8(BID_RG)
    name = sin.until0(BID_RN)
    _mf = sin.itf8(BID_MF)
    ns = sin.itf8(BID_NS)
    np_ = sin.itf8(BID_NP)
    ts = sin.itf8(BID_TS)
    tl = sin.itf8(BID_TL)
    aux = bytearray()
    for tid in td_lines[tl]:
        vlen = sin.itf8(BID_TAGL)
        vb = sin.take(BID_TAGV, vlen)
        aux += tid + vb

    pos = ap - 1
    unmapped = bool(cf & 0x8)
    if unmapped:
        seq = bytearray(sin.take(BID_BA, rl))
        quals = sin.take(BID_QS, rl)
        return _pack_bam_record(slice_refid, pos, 0 if flag & 0x4 else 255,
                                flag, name, [], bytes(seq), quals,
                                ns, np_ - 1, ts, bytes(aux))

    fn = sin.itf8(BID_FN)
    feats = []
    prev = 0
    for _ in range(fn):
        code = sin.take(BID_FC, 1)[0]
        prev += sin.itf8(BID_FP)
        if code == ord("X"):
            payload = sin.take(BID_BS, 1)[0]
        elif code == ord("B"):
            payload = sin.take(BID_BA, 1)
            sin.take(BID_QS, 1)  # paired quality byte; the stored full
            # array (CF bit 0x1) supersedes it, as in htslib
        elif code == ord("I"):
            payload = sin.until0(BID_IN)
        elif code == ord("S"):
            payload = sin.until0(BID_SC)
        elif code == ord("D"):
            payload = sin.itf8(BID_DL)
        elif code == ord("N"):
            payload = sin.itf8(BID_RS)
        elif code == ord("H"):
            payload = sin.itf8(BID_HC)
        elif code == ord("P"):
            payload = sin.itf8(BID_PD)
        else:
            raise CramError(f"unsupported CRAM feature code {chr(code)!r}")
        feats.append((prev, code, payload))
    mq = sin.itf8(BID_MQ)
    quals = sin.take(BID_QS, rl)

    # rebuild CIGAR + sequence against the reference
    chrom = ref_names[slice_refid]
    cigar: list[tuple[str, int]] = []

    def push(op, length):
        if length <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))

    q = 0
    r = pos
    seq = bytearray(rl)
    subs = []  # (read_pos0, code-or-base)
    ins_spans = []  # (read_pos0, bytes)
    for p1, code, payload in feats:
        p0 = p1 - 1
        if code in (ord("X"), ord("B")):
            subs.append((p0, code, payload))
            continue
        fill = p0 - q
        if fill > 0:
            push("M", fill)
            seq[q:q + fill] = reference_genome.get_slice(chrom, r, r + fill)
            q += fill
            r += fill
        if code in (ord("I"), ord("S")):
            push("I" if code == ord("I") else "S", len(payload))
            seq[q:q + len(payload)] = payload
            q += len(payload)
        elif code == ord("D"):
            push("D", payload)
            r += payload
        elif code == ord("N"):
            push("N", payload)
            r += payload
        elif code == ord("H"):
            push("H", payload)
        elif code == ord("P"):
            push("P", payload)
    if q < rl:
        fill = rl - q
        push("M", fill)
        seq[q:q + fill] = reference_genome.get_slice(chrom, r, r + fill)
        q += fill
        r += fill
    for p0, code, payload in subs:
        if code == ord("B"):
            seq[p0] = payload[0]
        else:
            seq[p0] = _sub_base(sm, seq[p0], payload)
    return _pack_bam_record(slice_refid, pos, mq, flag, name, cigar,
                            bytes(seq), quals, ns, np_ - 1, ts, bytes(aux))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

CT_CORE = 5
MAX_SLICE_RECORDS = 10_000


def _write_container_header(fh, data: bytes, refid: int, start: int,
                            span: int, n_records: int, counter: int,
                            bases: int, n_blocks: int,
                            landmarks: list[int]) -> int:
    hdr = bytearray()
    hdr += struct.pack("<i", len(data))
    write_itf8(hdr, refid)
    write_itf8(hdr, start)
    write_itf8(hdr, span)
    write_itf8(hdr, n_records)
    write_ltf8(hdr, counter)
    write_ltf8(hdr, bases)
    write_itf8(hdr, n_blocks)
    write_itf8(hdr, len(landmarks))
    for lm in landmarks:
        write_itf8(hdr, lm)
    hdr += struct.pack("<I", zlib.crc32(bytes(hdr)))
    offset = fh.tell()
    fh.write(hdr)
    fh.write(data)
    return offset


def _read_container_header(fh):
    raw = fh.read(4)
    if len(raw) < 4:
        return None
    (length,) = struct.unpack("<i", raw)
    buf = fh.read(64)  # varint fields are tiny; over-read then rewind
    pos = 0
    refid, pos = read_itf8(buf, pos)
    start, pos = read_itf8(buf, pos)
    span, pos = read_itf8(buf, pos)
    n_records, pos = read_itf8(buf, pos)
    counter, pos = read_ltf8(buf, pos)
    bases, pos = read_ltf8(buf, pos)
    n_blocks, pos = read_itf8(buf, pos)
    n_lm, pos = read_itf8(buf, pos)
    landmarks = []
    need_more = pos + 5 * n_lm + 4 - len(buf)
    if need_more > 0:
        buf += fh.read(need_more)
    for _ in range(n_lm):
        lm, pos = read_itf8(buf, pos)
        landmarks.append(lm)
    pos += 4  # CRC
    fh.seek(fh.tell() - (len(buf) - pos))
    return dict(length=length, refid=refid, start=start, span=span,
                n_records=n_records, counter=counter, bases=bases,
                n_blocks=n_blocks, landmarks=landmarks)


class CramWriter:
    """CRAM 3.0 writer (restricted profile; see module docstring). API
    mirrors `BamWriter`: write(BamRecord), close(), write_index() (.crai)."""

    def __init__(self, path: str, header, reference_genome, level: int = 6,
                 io_threads: int = 0, codec: str = "gzip"):
        if codec not in ("gzip", "rans", "ransNx16"):
            raise CramError(f"unsupported CRAM codec {codec!r}")
        self._ext_method = {"gzip": BLOCK_GZIP, "rans": BLOCK_RANS4X8,
                            "ransNx16": BLOCK_RANSNX16}[codec]
        self.path = path
        self.header = header
        self._ref = reference_genome
        self._fh = open(path, "wb")
        file_id = (path.encode()[-20:]).ljust(20, b"\x00")
        self._fh.write(CRAM_MAGIC + bytes([3, 0]) + file_id)
        # CRAM carries reference names only in the SAM text header, so @SQ
        # lines must be present (BAM keeps them in its binary section)
        text_str = header.text
        have_sq = {line.split("\t")[1][3:]
                   for line in text_str.splitlines()
                   if line.startswith("@SQ") and "\tSN:" in line}
        sq_lines = "".join(
            f"@SQ\tSN:{name}\tLN:{length}\n"
            for name, length in zip(header.ref_names, header.ref_lengths)
            if name not in have_sq)
        if sq_lines:
            if text_str and not text_str.endswith("\n"):
                text_str += "\n"
            text_str += sq_lines
        text = text_str.encode()
        data = bytearray()
        _write_block(data, BLOCK_GZIP, CT_FILE_HEADER, 0,
                     struct.pack("<i", len(text)) + text)
        _write_container_header(self._fh, bytes(data), 0, 0, 0, 0, 0, 0, 1, [0])
        self._buffer: list = []
        self._cur_tid: int | None = None
        self._counter = 0
        self._entries: list[tuple] = []
        self._closed = False

    def write(self, rec) -> None:
        tid = rec.refid if not rec.is_unmapped else rec.refid
        if (self._cur_tid is not None
                and (tid != self._cur_tid
                     or len(self._buffer) >= MAX_SLICE_RECORDS)):
            self._flush()
        self._cur_tid = tid
        self._buffer.append(rec)

    def _flush(self) -> None:
        if not self._buffer:
            return
        recs = self._buffer
        self._buffer = []
        tid = self._cur_tid
        ref_seq = None
        if tid is not None and tid >= 0:
            chrom = self.header.ref_names[tid]
            ref_seq = self._ref.get_full_chromosome(chrom)

        out = _SeriesOut()
        td_lines: list[list[bytes]] = []
        td_index: dict[tuple, int] = {}
        tag_ids: dict[bytes, None] = {}
        bases = 0
        for rec in recs:
            _encode_record(rec, ref_seq, out, td_index, td_lines, tag_ids)
            bases += rec.l_seq
        if not td_lines:
            td_lines = [[]]

        comp = _build_compression_header(list(tag_ids), td_lines)
        ext = [(cid, bytes(data)) for cid, data in out.streams.items()
               if len(data)]

        start = min((r.pos for r in recs), default=-1) + 1 \
            if tid is not None and tid >= 0 else 0
        end = max((r.reference_end() for r in recs), default=0) \
            if tid is not None and tid >= 0 else 0
        span = max(end - (start - 1), 0) if start > 0 else 0
        refid = tid if tid is not None else -1

        sh = bytearray()
        write_itf8(sh, refid)
        write_itf8(sh, start)
        write_itf8(sh, span)
        write_itf8(sh, len(recs))
        write_ltf8(sh, self._counter)
        write_itf8(sh, 1 + len(ext))  # core + externals
        write_itf8(sh, len(ext))
        for cid, _d in ext:
            write_itf8(sh, cid)
        write_itf8(sh, -1)  # embedded reference content id
        sh += b"\x00" * 16  # reference MD5 (unchecked in this profile)

        data = bytearray()
        _write_block(data, BLOCK_RAW, CT_COMPRESSION_HEADER, 0, comp)
        landmark = len(data)
        _write_block(data, BLOCK_RAW, CT_MAPPED_SLICE, 0, bytes(sh))
        _write_block(data, BLOCK_RAW, CT_CORE, 0, b"")
        for cid, d in ext:
            _write_block(data, self._ext_method, CT_EXTERNAL, cid, d)

        offset = _write_container_header(
            self._fh, bytes(data), refid, start, span, len(recs),
            self._counter, bases, 2 + len(ext) + 1, [landmark])
        self._entries.append((refid, start, span, offset, landmark,
                              len(data)))
        self._counter += len(recs)

    # The CRAM 3.0 specification's canonical EOF container — these exact 38
    # bytes (including the fixed CRC32s) are what htslib writes and what
    # `samtools quickcheck` looks for at the file tail (spec §9).
    EOF_BYTES = bytes([
        0x0f, 0x00, 0x00, 0x00, 0xff, 0xff, 0xff, 0xff, 0x0f, 0xe0,
        0x45, 0x4f, 0x46, 0x00, 0x00, 0x00, 0x00, 0x01, 0x00, 0x05,
        0xbd, 0xd9, 0x4f, 0x00, 0x01, 0x00, 0x06, 0x06, 0x01, 0x00,
        0x01, 0x00, 0x01, 0x00, 0xee, 0x63, 0x01, 0x4b,
    ])

    def close(self) -> None:
        if self._closed:
            return
        self._flush()
        self._fh.write(self.EOF_BYTES)
        self._fh.close()
        self._closed = True

    def write_index(self) -> None:
        assert self._closed
        lines = []
        for refid, start, span, offset, lm, size in self._entries:
            lines.append(f"{refid}\t{start}\t{span}\t{offset}\t{lm}\t{size}")
        with open(self.path + ".crai", "wb") as fh:
            fh.write(gzip.compress(("\n".join(lines) + "\n").encode()))


class CramReader:
    """CRAM 3.0 reader for the profile `CramWriter` emits (plus raw/gzip
    blocks and EXTERNAL/BYTE_ARRAY_* codecs generally). Yields `BamRecord`s,
    so downstream code is container-agnostic. Requires the reference genome
    (RR=true profile), mirroring htslib's CRAM reference requirement."""

    def __init__(self, path: str, reference_genome):
        from hiphase_tpu_torch.io.bam import SamHeader
        self.path = path
        self._ref = reference_genome
        self._fh = open(path, "rb")
        magic = self._fh.read(6)
        if magic[:4] != CRAM_MAGIC:
            raise CramError(f"{path}: not a CRAM file")
        if magic[4] != 3:
            raise CramError(f"{path}: unsupported CRAM major version {magic[4]}")
        self._fh.read(20)  # file id
        hdr = _read_container_header(self._fh)
        data = self._fh.read(hdr["length"])
        _m, ctype, _cid, blob, _p = _read_block(data, 0)
        if ctype != CT_FILE_HEADER:
            raise CramError("first CRAM container must hold the SAM header")
        (text_len,) = struct.unpack_from("<i", blob, 0)
        text = blob[4:4 + text_len].decode()
        ref_names, ref_lengths = [], []
        for line in text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                              if ":" in f)
                ref_names.append(fields["SN"])
                ref_lengths.append(int(fields.get("LN", 0)))
        self.header = SamHeader(text, ref_names, ref_lengths)
        self._body_offset = self._fh.tell()
        self._index: list[tuple] | None = None
        try:
            with open(path + ".crai", "rb") as fh:
                self._index = []
                for line in gzip.decompress(fh.read()).decode().splitlines():
                    parts = line.split("\t")
                    self._index.append(tuple(int(x) for x in parts))
        except OSError:
            pass

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tid(self, chrom: str) -> int:
        try:
            return self.header.ref_names.index(chrom)
        except ValueError:
            return -1

    def _decode_container(self, hdr) -> list:
        data = self._fh.read(hdr["length"])
        pos = 0
        _m, ctype, _cid, comp_blob, pos = _read_block(data, pos)
        if ctype != CT_COMPRESSION_HEADER:
            raise CramError("container must start with a compression header")
        preservation, _series, _tags = _parse_compression_header(comp_blob)
        records = []
        while pos < len(data):
            _m, ctype, _cid, blob, pos = _read_block(data, pos)
            if ctype != CT_MAPPED_SLICE:
                continue
            sh = _Reader(blob)
            refid = sh.itf8()
            _start = sh.itf8()
            _span = sh.itf8()
            n_records = sh.itf8()
            _counter = sh.ltf8()
            n_blocks = sh.itf8()
            n_ids = sh.itf8()
            for _ in range(n_ids):
                sh.itf8()
            blocks: dict[int, bytes] = {}
            for _ in range(n_blocks):
                _m2, ct2, cid2, blob2, pos = _read_block(data, pos)
                if ct2 == CT_EXTERNAL:
                    blocks[cid2] = blob2
            sin = _SeriesIn(blocks)
            for _ in range(n_records):
                records.append(_decode_record(
                    sin, preservation, preservation["TD"], refid,
                    self.header.ref_names, self._ref))
        return records

    def _iter_containers(self):
        self._fh.seek(self._body_offset)
        while True:
            hdr = _read_container_header(self._fh)
            if hdr is None or hdr["start"] == EOF_START:
                return
            yield hdr

    def __iter__(self):
        for hdr in self._iter_containers():
            yield from self._decode_container(hdr)

    def fetch(self, chrom: str, start: int, end: int):
        """Yield records overlapping [start, end), using the .crai when
        present."""
        tid = self.tid(chrom)
        if tid < 0:
            return
        if self._index is not None:
            for refid, c_start, c_span, offset, _lm, _sz in self._index:
                if refid != tid:
                    continue
                c0 = c_start - 1
                if c0 >= end or c0 + c_span <= start:
                    continue
                self._fh.seek(offset)
                hdr = _read_container_header(self._fh)
                for rec in self._decode_container(hdr):
                    # placed-unmapped records count as length 1 at pos
                    # (htslib semantics, matching BamReader.fetch)
                    if rec.refid != tid or rec.pos >= end:
                        continue
                    rec_end = rec.pos + 1 if rec.is_unmapped else \
                        max(rec.reference_end(), rec.pos + 1)
                    if rec_end > start:
                        yield rec
            return
        for rec in self:
            if rec.refid != tid or rec.pos >= end:
                continue
            rec_end = rec.pos + 1 if rec.is_unmapped else \
                max(rec.reference_end(), rec.pos + 1)
            if rec_end > start:
                yield rec

    def fetch_unmapped(self):
        for rec in self:
            if rec.refid < 0:
                yield rec

    def fetch_raw(self, chrom, start, end, min_mapq):
        return None  # CRAM input uses the record-level paths
