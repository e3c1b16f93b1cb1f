"""rANS Nx16 codec (CRAM 3.1 block compression method, spec §3 of
CRAMcodecs: "rANS Nx16").

16-bit-renormalization rANS with 4- or 32-way interleaved states plus the
3.1 pre-transforms: PACK (bit packing), RLE (run-length with out-of-band
run lengths), STRIPE (byte-interleaved sub-streams) and CAT (stored).
Order-0 and order-1 contexts are supported for decode and encode.

Written against the public CRAM 3.1 codec specification; no htslib bytes.
This environment has no htslib or network access, so cross-validation
against samtools-produced streams is recorded as pending in docs/PARITY.md
— the test suite pins encoder↔decoder round-trips over every flag
combination instead.

Stream layout:
  flags u8: 0x01 ORDER1, 0x04 N32, 0x08 STRIPE, 0x10 NOSZ, 0x20 CAT,
            0x40 RLE, 0x80 PACK
  [uint7 ulen]            unless NOSZ
  CAT    -> ulen raw bytes
  STRIPE -> u8 N, N× uint7 clen, N nested streams; output interleaved
  PACK   -> u8 nsym, nsym symbol bytes, uint7 packed-len   (meta)
  RLE    -> uint7 (meta_len<<1 | uncompressed?), uint7 rle-coded len,
            meta = [u8 nrunsyms (0=256), symbols, run lengths as uint7]
            (meta itself order-0 rANS-coded unless the low bit is set)
  payload: N interleaved 32-bit rANS states over 12-bit frequencies,
           16-bit renormalization at L = 1<<15.
Decode applies: rANS → RLE-expand → bit-unpack.
"""

from __future__ import annotations

import struct

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT
RANS_L = 1 << 15

F_ORDER1 = 0x01
F_N32 = 0x04
F_STRIPE = 0x08
F_NOSZ = 0x10
F_CAT = 0x20
F_RLE = 0x40
F_PACK = 0x80


class RansNx16Error(ValueError):
    pass


# ---------------------------------------------------------------------------
# varint (uint7: big-endian 7-bit groups, high bit = continuation)


def _put_uint7(out: bytearray, v: int) -> None:
    chunks = []
    while True:
        chunks.append(v & 0x7F)
        v >>= 7
        if v == 0:
            break
    for c in reversed(chunks[1:]):
        out.append(0x80 | c)
    out.append(chunks[0])


def _get_uint7(buf: bytes, pos: int) -> tuple[int, int]:
    v = 0
    while True:
        c = buf[pos]
        pos += 1
        v = (v << 7) | (c & 0x7F)
        if not (c & 0x80):
            return v, pos


# ---------------------------------------------------------------------------
# frequency tables


def _normalize(hist: list[int], total: int) -> list[int]:
    n = sum(hist)
    if n == 0:
        return hist
    freqs = [0] * len(hist)
    t = 0
    for s, h in enumerate(hist):
        if h:
            freqs[s] = max(1, h * total // n)
            t += freqs[s]
    while t != total:
        m = max(range(len(hist)), key=lambda s: freqs[s])
        step = total - t
        if freqs[m] + step < 1:
            step = 1 - freqs[m]
        freqs[m] += step
        t += step
    return freqs


def _write_alphabet(out: bytearray, present: list[bool]) -> None:
    """Symbols ascending; a run of consecutive symbols after an explicit
    pair is RLE'd; terminated by 0."""
    syms = [s for s in range(256) if present[s]]
    i = 0
    last = -2
    while i < len(syms):
        out.append(syms[i])
        if syms[i] == last + 1:
            # count further consecutive symbols
            run = 0
            while i + 1 + run < len(syms) and \
                    syms[i + 1 + run] == syms[i] + 1 + run:
                run += 1
            out.append(run)
            last = syms[i + run]
            i += run + 1
        else:
            last = syms[i]
            i += 1
    out.append(0)


def _read_alphabet(buf: bytes, pos: int) -> tuple[list[int], int]:
    """Inverse of _write_alphabet. The run byte counts ADDITIONAL
    consecutive symbols after the explicitly-written one; symbols ascend,
    so a 0 after the first symbol is always the terminator."""
    syms = []
    rle = 0
    sym = buf[pos]
    pos += 1
    while True:
        syms.append(sym)
        last = sym
        if rle > 0:
            rle -= 1
            sym = last + 1
        else:
            sym = buf[pos]
            pos += 1
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
            if sym == 0:
                return syms, pos


def _write_freqs_o0(out: bytearray, freqs: list[int]) -> None:
    present = [f > 0 for f in freqs]
    _write_alphabet(out, present)
    for s in range(256):
        if freqs[s]:
            _put_uint7(out, freqs[s])


def _read_freqs_o0(buf: bytes, pos: int) -> tuple[list[int], int]:
    """Returns (freqs, pos). The table total must be a power of two (the
    spec normalizes order-0 tables to 4096 and order-1 rows to 4096 or
    1024); the decoder derives the shift from the actual total rather
    than guessing — a non-power-of-two total is a corrupt stream and
    raises instead of silently mis-decoding."""
    syms, pos = _read_alphabet(buf, pos)
    freqs = [0] * 256
    for s in syms:
        freqs[s], pos = _get_uint7(buf, pos)
    total = sum(freqs)
    if total == 0:
        raise RansNx16Error("empty frequency table")
    if total & (total - 1):
        raise RansNx16Error(
            f"frequency table total {total} is not a power of two")
    return freqs, pos


# ---------------------------------------------------------------------------
# core order-0


def _cum(freqs: list[int]) -> list[int]:
    c = [0] * 257
    for s in range(256):
        c[s + 1] = c[s] + freqs[s]
    return c


def _enc_core(data: bytes, freqs: list[int], nstates: int) -> bytes:
    """Interleaved-state rANS body: symbol i uses state i % N; states are
    flushed as N little-endian u32 at the stream head."""
    cum = _cum(freqs)
    xmax_mul = (RANS_L >> TF_SHIFT) << 16
    states = [RANS_L] * nstates
    words = []  # emitted 16-bit renorm words (decode reads them reversed)
    for i in range(len(data) - 1, -1, -1):
        s = data[i]
        j = i % nstates
        x = states[j]
        f = freqs[s]
        while x >= xmax_mul * f:
            words.append(struct.pack("<H", x & 0xFFFF))
            x >>= 16
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + cum[s]
    head = bytearray()
    for j in range(nstates):
        head += struct.pack("<I", states[j])
    return bytes(head) + b"".join(reversed(words))


def _dec_core(buf: bytes, pos: int, freqs: list[int], nstates: int,
              n_out: int) -> tuple[bytearray, int]:
    cum = _cum(freqs)
    total = cum[256]                  # power of two (checked on read)
    shift = total.bit_length() - 1
    lut = bytearray(total)
    for s in range(256):
        if freqs[s]:
            for k in range(cum[s], cum[s + 1]):
                lut[k] = s
    states = list(struct.unpack_from(f"<{nstates}I", buf, pos))
    pos += 4 * nstates
    out = bytearray(n_out)
    n = len(buf)
    for i in range(n_out):
        j = i % nstates
        x = states[j]
        m = x & (total - 1)
        s = lut[m]
        out[i] = s
        x = freqs[s] * (x >> shift) + m - cum[s]
        if x < RANS_L:
            if pos + 2 <= n:
                x = (x << 16) | struct.unpack_from("<H", buf, pos)[0]
                pos += 2
            else:
                x <<= 16
        states[j] = x
    return out, pos


# ---------------------------------------------------------------------------
# order-1


def _enc_o1(data: bytes, nstates: int) -> bytes:
    """Order-1: context = previous byte; stream is split into N slices and
    each slice's FIRST byte uses context 0."""
    n = len(data)
    hist = [[0] * 256 for _ in range(256)]
    slice_len = (n + nstates - 1) // nstates
    for j in range(nstates):
        b = j * slice_len
        if b < n:
            hist[0][data[b]] += 1
    for i in range(1, n):
        if i % slice_len == 0:
            continue  # slice head counted under ctx 0
        hist[data[i - 1]][data[i]] += 1

    freqs = [None] * 256
    cums = [None] * 256
    table = bytearray()
    used = [s for s in range(256) if any(hist[s])]
    present_ctx = [bool(any(hist[s])) for s in range(256)]
    _write_alphabet(table, present_ctx)
    for s in used:
        f = _normalize(hist[s], TOTFREQ)
        freqs[s] = f
        cums[s] = _cum(f)
        _write_freqs_o0(table, f)

    xmax_mul = (RANS_L >> TF_SHIFT) << 16
    states = [RANS_L] * nstates
    words = []
    for i in range(n - 1, -1, -1):
        j, off = divmod(i, slice_len)
        ctx = 0 if off == 0 else data[i - 1]
        s = data[i]
        x = states[j]
        f = freqs[ctx][s]
        while x >= xmax_mul * f:
            words.append(struct.pack("<H", x & 0xFFFF))
            x >>= 16
        states[j] = ((x // f) << TF_SHIFT) + (x % f) + cums[ctx][s]
    head = bytearray()
    # uncompressed table marker (bit 0 clear = stored table)
    body = bytearray([0]) + table
    for j in range(nstates):
        head += struct.pack("<I", states[j])
    return bytes(body) + bytes(head) + b"".join(reversed(words))


def _dec_o1(buf: bytes, pos: int, nstates: int, n_out: int
            ) -> tuple[bytearray, int]:
    comp = buf[pos]
    pos += 1
    if comp & 1:
        # table itself order-0 rANS-compressed
        clen, pos = _get_uint7(buf, pos)
        ulen, pos = _get_uint7(buf, pos)
        freqs0, p2 = _read_freqs_o0(buf, pos)
        tbl, _ = _dec_core(buf, p2, freqs0, 4, ulen)
        table = bytes(tbl)
        tpos = 0
        pos += clen
    else:
        table = buf
        tpos = pos
    ctxs, tpos = _read_alphabet(table, tpos)
    freqs = [None] * 256
    cums = [None] * 256
    luts = [None] * 256
    shifts = [0] * 256
    for c in ctxs:
        f, tpos = _read_freqs_o0(table, tpos)
        freqs[c] = f
        cums[c] = _cum(f)
        row_total = cums[c][256]
        shifts[c] = row_total.bit_length() - 1
        lut = bytearray(row_total)
        for s in range(256):
            if f[s]:
                for k in range(cums[c][s], cums[c][s + 1]):
                    lut[k] = s
        luts[c] = lut
    if comp & 1:
        pass  # pos already advanced past the compressed table
    else:
        pos = tpos

    states = list(struct.unpack_from(f"<{nstates}I", buf, pos))
    pos += 4 * nstates
    out = bytearray(n_out)
    slice_len = (n_out + nstates - 1) // nstates
    n = len(buf)
    for i in range(n_out):
        j, off = divmod(i, slice_len)
        ctx = 0 if off == 0 else out[i - 1]
        if freqs[ctx] is None:
            raise RansNx16Error(f"order-1 context {ctx} missing")
        x = states[j]
        m = x & (len(luts[ctx]) - 1)
        s = luts[ctx][m]
        out[i] = s
        x = freqs[ctx][s] * (x >> shifts[ctx]) + m - cums[ctx][s]
        if x < RANS_L:
            if pos + 2 <= n:
                x = (x << 16) | struct.unpack_from("<H", buf, pos)[0]
                pos += 2
            else:
                x <<= 16
        states[j] = x
    return out, pos


# ---------------------------------------------------------------------------
# transforms


def _pack_encode(data: bytes):
    syms = sorted(set(data))
    if len(syms) > 16 or not data:
        return None
    smap = {s: i for i, s in enumerate(syms)}
    if len(syms) <= 1:
        packed = b""
    elif len(syms) <= 2:
        packed = bytearray((len(data) + 7) // 8)
        for i, b in enumerate(data):
            packed[i >> 3] |= smap[b] << (i & 7)
    elif len(syms) <= 4:
        packed = bytearray((len(data) + 3) // 4)
        for i, b in enumerate(data):
            packed[i >> 2] |= smap[b] << ((i & 3) * 2)
    else:
        packed = bytearray((len(data) + 1) // 2)
        for i, b in enumerate(data):
            packed[i >> 1] |= smap[b] << ((i & 1) * 4)
    return bytes(syms), bytes(packed)


def _pack_decode(packed: bytes, syms: bytes, n_out: int) -> bytes:
    ns = len(syms)
    out = bytearray(n_out)
    if ns <= 1:
        if ns == 1:
            for i in range(n_out):
                out[i] = syms[0]
        return bytes(out)
    if ns <= 2:
        for i in range(n_out):
            out[i] = syms[(packed[i >> 3] >> (i & 7)) & 1]
    elif ns <= 4:
        for i in range(n_out):
            out[i] = syms[(packed[i >> 2] >> ((i & 3) * 2)) & 3]
    else:
        for i in range(n_out):
            out[i] = syms[(packed[i >> 1] >> ((i & 1) * 4)) & 15]
    return bytes(out)


def _rle_encode(data: bytes):
    """Literals keep one copy of each run head; run lengths go to meta."""
    # choose symbols whose RLE saves space: any symbol with runs
    counts = [0] * 256
    saved = [0] * 256
    i = 0
    n = len(data)
    while i < n:
        j = i
        while j < n and data[j] == data[i]:
            j += 1
        saved[data[i]] += (j - i) - 2  # approx: run byte costs ~1
        counts[data[i]] += 1
        i = j
    run_syms = [s for s in range(256) if saved[s] > 0]
    if not run_syms:
        return None
    rs = set(run_syms)
    lits = bytearray()
    runs = bytearray()
    i = 0
    while i < n:
        j = i
        while j < n and data[j] == data[i]:
            j += 1
        if data[i] in rs:
            lits.append(data[i])
            _put_uint7(runs, j - i - 1)
        else:
            lits += data[i:j]
        i = j
    meta = bytearray()
    meta.append(len(run_syms) & 0xFF)  # 256 -> 0
    meta += bytes(run_syms)
    meta += runs
    return bytes(meta), bytes(lits)


def _rle_decode(meta: bytes, lits: bytes, n_out: int) -> bytes:
    nrs = meta[0] or 256
    rs = set(meta[1:1 + nrs])
    mpos = 1 + nrs
    out = bytearray()
    for b in lits:
        if b in rs:
            run, mpos = _get_uint7(meta, mpos)
            out += bytes([b]) * (run + 1)
        else:
            out.append(b)
    if len(out) != n_out:
        raise RansNx16Error(f"RLE expanded to {len(out)}, want {n_out}")
    return bytes(out)


# ---------------------------------------------------------------------------
# public API


def compress(data: bytes, order: int = 0, nway32: bool = False,
             use_pack: bool = False, use_rle: bool = False,
             use_cat: bool = False) -> bytes:
    """Encode one ransNx16 stream. Transforms compose: pack → rle → rANS
    on encode (decode inverts)."""
    flags = 0
    out = bytearray()
    nstates = 32 if nway32 else 4
    if nway32:
        flags |= F_N32
    if order:
        flags |= F_ORDER1
    payload = bytes(data)
    pack_meta = b""
    pack_len = 0
    rle_meta = b""
    if use_cat or len(data) < 4:
        flags |= F_CAT
        out.append(flags & ~(F_ORDER1 | F_N32))
        _put_uint7(out, len(data))
        out += data
        return bytes(out)
    if use_pack:
        pk = _pack_encode(payload)
        if pk is not None:
            syms, packed = pk
            flags |= F_PACK
            pack_meta = bytes([len(syms)]) + syms
            payload = packed
            pack_len = len(packed)  # what unpack receives after RLE-expand
    if use_rle:
        rl = _rle_encode(payload)
        if rl is not None:
            meta, lits = rl
            flags |= F_RLE
            rm = bytearray()
            _put_uint7(rm, (len(meta) << 1) | 1)  # store meta raw
            _put_uint7(rm, len(lits))             # rANS-coded length
            rm += meta
            rle_meta = bytes(rm)
            payload = lits

    out.append(flags)
    _put_uint7(out, len(data))
    if flags & F_PACK:
        out += pack_meta
        _put_uint7(out, pack_len)
    if flags & F_RLE:
        out += rle_meta
    if not payload:
        return bytes(out)  # e.g. PACK of a constant buffer: nothing coded
    if order:
        out += _enc_o1(payload, nstates)
    else:
        hist = [0] * 256
        for b in payload:
            hist[b] += 1
        freqs = _normalize(hist, TOTFREQ)
        body = bytearray()
        _write_freqs_o0(body, freqs)
        out += bytes(body) + _enc_core(payload, freqs, nstates)
    return bytes(out)


def uncompress(buf: bytes) -> bytes:
    """Decode one ransNx16 stream (ulen from the header)."""
    flags = buf[0]
    pos = 1
    if flags & F_STRIPE:
        ulen, pos = _get_uint7(buf, pos)
        nst = buf[pos]
        pos += 1
        clens = []
        for _ in range(nst):
            c, pos = _get_uint7(buf, pos)
            clens.append(c)
        subs = []
        for j in range(nst):
            subs.append(uncompress(buf[pos:pos + clens[j]]))
            pos += clens[j]
        out = bytearray(ulen)
        for j in range(nst):
            out[j::nst] = subs[j]
        return bytes(out)
    nstates = 32 if flags & F_N32 else 4
    if not (flags & F_NOSZ):
        ulen, pos = _get_uint7(buf, pos)
    else:
        raise RansNx16Error("NOSZ stream needs an external length")
    return _uncompress_body(buf, pos, flags, ulen, nstates)


def _uncompress_body(buf: bytes, pos: int, flags: int, ulen: int,
                     nstates: int) -> bytes:
    if flags & F_CAT:
        return bytes(buf[pos:pos + ulen])
    pack_syms = b""
    packed_len = None
    rle_meta = b""
    rle_len = None
    if flags & F_PACK:
        nsym = buf[pos]
        pos += 1
        pack_syms = bytes(buf[pos:pos + nsym])
        pos += nsym
        packed_len, pos = _get_uint7(buf, pos)
    if flags & F_RLE:
        m, pos = _get_uint7(buf, pos)
        rle_len, pos = _get_uint7(buf, pos)
        if m & 1:
            rle_meta = bytes(buf[pos:pos + (m >> 1)])
            pos += m >> 1
        else:
            clen = m >> 1
            mulen, p2 = _get_uint7(buf, pos)
            freqs0, p3 = _read_freqs_o0(buf, p2)
            meta, _ = _dec_core(buf, p3, freqs0, 4, mulen)
            rle_meta = bytes(meta)
            pos += clen

    # length of the rANS-coded stream before inverse transforms
    n_rans = ulen
    if flags & F_PACK:
        n_rans = packed_len
    if flags & F_RLE:
        n_rans = rle_len

    if n_rans == 0:
        data = b""
        if flags & F_RLE:
            data = _rle_decode(rle_meta, data,
                               packed_len if flags & F_PACK else ulen)
        if flags & F_PACK:
            data = _pack_decode(data, pack_syms, ulen)
        if len(data) != ulen:
            raise RansNx16Error(f"decoded {len(data)} bytes, want {ulen}")
        return data

    if flags & F_ORDER1:
        data, pos = _dec_o1(buf, pos, nstates, n_rans)
    else:
        freqs, pos = _read_freqs_o0(buf, pos)
        data, pos = _dec_core(buf, pos, freqs, nstates, n_rans)
    data = bytes(data)

    if flags & F_RLE:
        want = packed_len if flags & F_PACK else ulen
        data = _rle_decode(rle_meta, data, want)
    if flags & F_PACK:
        data = _pack_decode(data, pack_syms, ulen)
    if len(data) != ulen:
        raise RansNx16Error(f"decoded {len(data)} bytes, want {ulen}")
    return data
