"""rANS 4x8 codec (CRAM 3.0 spec §13; the `rans4x8` block compression
method real-world CRAMs from samtools/pbmm2 use for external data series).

Implements order-0 and order-1 encode + decode in pure Python, matching
the byte format of htslib's rANS_static (4 interleaved 32-bit states,
12-bit normalized frequencies, RLE'd frequency tables, little-endian state
flush, order-1 quartered output with the remainder on state 3). The native
library provides a fast decode (`hn_rans_uncompress`) used by the CRAM
reader; this module is the specification oracle the native path is tested
against, and the encoder (used by CramWriter's optional rans codec and the
test fixtures).

No bytes in this file are derived from htslib source — written against the
public CRAM format specification.
"""

from __future__ import annotations

import struct

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT          # 4096
RANS_BYTE_L = 1 << 23            # renormalization threshold


class RansError(ValueError):
    pass


# ---------------------------------------------------------------------------
# frequency tables


def _normalize_freqs(hist: list[int], total: int) -> list[int]:
    """Scale a histogram to sum exactly `total`, keeping every nonzero
    symbol at frequency >= 1 (largest-remainder style)."""
    n = sum(hist)
    if n == 0:
        return hist
    freqs = [0] * 256
    # initial floor scale, nonzero kept >= 1
    t = 0
    for s, h in enumerate(hist):
        if h == 0:
            continue
        f = max(1, (h * total) // n)
        freqs[s] = f
        t += f
    # adjust to exact total by nudging the largest bucket
    while t != total:
        m = max(range(256), key=lambda s: freqs[s])
        if t < total:
            freqs[m] += total - t
            t = total
        else:
            give = min(freqs[m] - 1, t - total)
            if give == 0:
                # all at 1; steal from any freq > 1 or fail
                raise RansError("cannot normalize frequency table")
            freqs[m] -= give
            t -= give
    return freqs


def _write_freqs_0(out: bytearray, freqs: list[int]) -> None:
    """Order-0 table: [sym][freq]... with runs of consecutive symbols
    RLE'd; freq >= 128 is two bytes (0x80|hi, lo); 0x00 terminator."""
    syms = [s for s in range(256) if freqs[s] > 0]
    rle = 0
    for k, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(s)
            if k > 0 and s == syms[k - 1] + 1:
                # count the run of consecutive symbols following s
                run = 0
                while (k + run + 1 < len(syms)
                       and syms[k + run + 1] == s + run + 1):
                    run += 1
                out.append(run)
                rle = run
        f = freqs[s]
        if f >= 128:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
        else:
            out.append(f)
    out.append(0)


def _read_freqs_0(buf: bytes, pos: int) -> tuple[list[int], int]:
    freqs = [0] * 256
    sym = buf[pos]
    pos += 1
    last = -2
    rle = 0
    while True:
        f = buf[pos]
        pos += 1
        if f >= 128:
            f = ((f & 0x7F) << 8) | buf[pos]
            pos += 1
        freqs[sym] = f
        last = sym
        if rle > 0:
            rle -= 1
            sym = last + 1
        else:
            sym = buf[pos]
            pos += 1
            if sym == 0:
                break
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
    return freqs, pos


# ---------------------------------------------------------------------------
# order-0


def _enc_renorm(x: int, freq: int, out: bytearray) -> int:
    x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * freq
    while x >= x_max:
        out.append(x & 0xFF)
        x >>= 8
    return x


def _enc_put(x: int, freq: int, cumfreq: int, out: bytearray) -> int:
    x = _enc_renorm(x, freq, out)
    return ((x // freq) << TF_SHIFT) + (x % freq) + cumfreq


def compress_o0(data: bytes) -> bytes:
    hist = [0] * 256
    for b in data:
        hist[b] += 1
    freqs = _normalize_freqs(hist, TOTFREQ)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]

    table = bytearray()
    _write_freqs_0(table, freqs)

    rev = bytearray()  # encoded bytes, reversed at the end
    R = [RANS_BYTE_L] * 4
    n = len(data)
    base = n & ~3
    for j in range(n - base - 1, -1, -1):  # remainder, states rem-1..0
        b = data[base + j]
        R[j] = _enc_put(R[j], freqs[b], cum[b], rev)
    for i in range(base - 4, -1, -4):
        for j in (3, 2, 1, 0):
            b = data[i + j]
            R[j] = _enc_put(R[j], freqs[b], cum[b], rev)
    for j in (3, 2, 1, 0):  # flush; state 0 ends up first in the stream
        rev.extend(struct.pack("<I", R[j])[::-1])
    payload = bytes(table) + bytes(rev[::-1])
    return struct.pack("<BII", 0, len(payload), n) + payload


def uncompress_o0(buf: bytes, pos: int, out_size: int) -> bytes:
    freqs, pos = _read_freqs_0(buf, pos)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freqs[s]
    if cum[256] > TOTFREQ:
        raise RansError("frequency table exceeds 4096")
    lookup = bytearray(TOTFREQ)
    for s in range(256):
        if freqs[s]:
            lookup[cum[s]:cum[s + 1]] = bytes([s]) * freqs[s]

    R = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(out_size)
    mask = TOTFREQ - 1
    blen = len(buf)
    for i in range(out_size):
        j = i & 3
        x = R[j]
        m = x & mask
        s = lookup[m]
        out[i] = s
        x = freqs[s] * (x >> TF_SHIFT) + m - cum[s]
        while x < RANS_BYTE_L and pos < blen:
            x = (x << 8) | buf[pos]
            pos += 1
        R[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1


def compress_o1(data: bytes) -> bytes:
    n = len(data)
    if n < 4:
        raise RansError("order-1 needs at least 4 bytes")
    hist = [[0] * 256 for _ in range(256)]
    # contexts: each quarter starts from context 0 (the initial l values)
    isz4 = n >> 2
    for k in range(4):
        last = 0
        lo = k * isz4
        hi = lo + isz4 if k < 3 else n
        for i in range(lo, hi):
            hist[last][data[i]] += 1
            last = data[i]

    freqs = [None] * 256
    cums = [None] * 256
    for c in range(256):
        if sum(hist[c]) == 0:
            continue
        f = _normalize_freqs(hist[c], TOTFREQ)
        cu = [0] * 257
        for s in range(256):
            cu[s + 1] = cu[s] + f[s]
        freqs[c] = f
        cums[c] = cu

    table = bytearray()
    ctxs = [c for c in range(256) if freqs[c] is not None]
    rle_i = 0
    for k, c in enumerate(ctxs):
        if rle_i > 0:
            rle_i -= 1
        else:
            table.append(c)
            if k > 0 and c == ctxs[k - 1] + 1:
                run = 0
                while (k + run + 1 < len(ctxs)
                       and ctxs[k + run + 1] == c + run + 1):
                    run += 1
                table.append(run)
                rle_i = run
        _write_freqs_0(table, freqs[c])
    table.append(0)

    rev = bytearray()
    R = [RANS_BYTE_L] * 4
    # encode in the exact reverse of the decoder's operation order (the
    # renormalization bytes interleave in stream order): the state-3 tail
    # first (decoded last), then rounds of (k3, k2, k1, k0) for
    # i = isz4-1 .. 0; the first byte of each quarter uses context 0
    for i in range(n - 1, 4 * isz4 - 1, -1):  # tail, state 3
        ctx = data[i - 1]
        b = data[i]
        R[3] = _enc_put(R[3], freqs[ctx][b], cums[ctx][b], rev)
    for i in range(isz4 - 1, -1, -1):
        for k in (3, 2, 1, 0):
            p = k * isz4 + i
            ctx = data[p - 1] if i > 0 else 0
            b = data[p]
            R[k] = _enc_put(R[k], freqs[ctx][b], cums[ctx][b], rev)
    for k in (3, 2, 1, 0):
        rev.extend(struct.pack("<I", R[k])[::-1])
    payload = bytes(table) + bytes(rev[::-1])
    return struct.pack("<BII", 1, len(payload), n) + payload


def uncompress_o1(buf: bytes, pos: int, out_size: int) -> bytes:
    freqs = [None] * 256
    cums = [None] * 256
    lookups = [None] * 256
    ctx = buf[pos]
    pos += 1
    last = -2
    rle_i = 0
    while True:
        f, pos = _read_freqs_0(buf, pos)
        cu = [0] * 257
        for s in range(256):
            cu[s + 1] = cu[s] + f[s]
        if cu[256] > TOTFREQ:
            raise RansError("frequency table exceeds 4096")
        lk = bytearray(TOTFREQ)
        for s in range(256):
            if f[s]:
                lk[cu[s]:cu[s + 1]] = bytes([s]) * f[s]
        freqs[ctx] = f
        cums[ctx] = cu
        lookups[ctx] = lk
        last = ctx
        if rle_i > 0:
            rle_i -= 1
            ctx = last + 1
        else:
            ctx = buf[pos]
            pos += 1
            if ctx == 0:
                break
            if ctx == last + 1:
                rle_i = buf[pos]
                pos += 1

    R = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = bytearray(out_size)
    mask = TOTFREQ - 1
    blen = len(buf)
    isz4 = out_size >> 2
    L = [0, 0, 0, 0]
    for i in range(isz4):
        for k in range(4):
            x = R[k]
            m = x & mask
            c = L[k]
            if lookups[c] is None:
                raise RansError("missing order-1 context table")
            s = lookups[c][m]
            out[k * isz4 + i] = s
            x = freqs[c][s] * (x >> TF_SHIFT) + m - cums[c][s]
            while x < RANS_BYTE_L and pos < blen:
                x = (x << 8) | buf[pos]
                pos += 1
            R[k] = x
            L[k] = s
    for i in range(4 * isz4, out_size):  # tail on state 3
        x = R[3]
        m = x & mask
        c = L[3]
        if lookups[c] is None:
            raise RansError("missing order-1 context table")
        s = lookups[c][m]
        out[i] = s
        x = freqs[c][s] * (x >> TF_SHIFT) + m - cums[c][s]
        while x < RANS_BYTE_L and pos < blen:
            x = (x << 8) | buf[pos]
            pos += 1
        R[3] = x
        L[3] = s
    return bytes(out)


# ---------------------------------------------------------------------------
# public API


def compress(data: bytes, order: int = 0) -> bytes:
    """rans4x8-compress `data`; returns the full stream including the
    9-byte (order, comp_size, uncomp_size) header."""
    if len(data) == 0:
        return struct.pack("<BII", 0, 0, 0)
    if order == 1 and len(data) >= 4:
        return compress_o1(data)
    return compress_o0(data)


def uncompress(stream: bytes) -> bytes:
    """Decode a rans4x8 stream (header + payload). Pure-Python oracle;
    use hiphase_tpu.io.native.rans_uncompress for the fast path."""
    if len(stream) < 9:
        raise RansError("truncated rANS stream")
    order, comp_size, out_size = struct.unpack_from("<BII", stream, 0)
    if out_size == 0:
        return b""
    if len(stream) < 9 + comp_size:
        raise RansError("rANS stream shorter than its header claims")
    if order == 0:
        return uncompress_o0(stream, 9, out_size)
    if order == 1:
        return uncompress_o1(stream, 9, out_size)
    raise RansError(f"unknown rANS order {order}")
