"""BGZF (blocked gzip) codec — the container format under BAM/BCF/tabix.

The environment has no htslib, so the format is implemented natively
(spec: SAM/BAM v1.6 §4.1). This pure-Python layer is the portable
implementation; `hiphase_tpu.io.native` swaps in the C++ multithreaded codec
for bulk (de)compression when the shared library is built.

Virtual file offsets are ``coffset << 16 | uoffset`` as in htslib; the
reference relies on them for BAM/tabix region fetch (ref: rust-htslib's
bgzf usage, SURVEY.md §2 L0).
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import BinaryIO, Iterator

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

# Max uncompressed payload per block (spec: 65536; htslib uses 0xff00)
MAX_BLOCK_PAYLOAD = 0xFF00

_HEADER = struct.Struct("<4BI2BH")  # magic1/2, CM, FLG, MTIME, XFL, OS, XLEN


class BgzfError(IOError):
    pass


def _read_block_size(fh: BinaryIO) -> tuple[int, bytes] | None:
    """Read one BGZF block header; return (total block size, header+extra bytes)
    or None at EOF."""
    hdr = fh.read(12)
    if len(hdr) == 0:
        return None
    if len(hdr) < 12:
        raise BgzfError("truncated BGZF block header")
    magic1, magic2, cm, flg, _mtime, _xfl, _os, xlen = _HEADER.unpack(hdr)
    if magic1 != 0x1F or magic2 != 0x8B or cm != 8 or not (flg & 4):
        raise BgzfError("not a BGZF block (bad gzip magic/flags)")
    extra = fh.read(xlen)
    if len(extra) < xlen:
        raise BgzfError("truncated BGZF extra field")
    bsize = None
    pos = 0
    while pos + 4 <= xlen:
        si1, si2, slen = extra[pos], extra[pos + 1], struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", extra, pos + 4)[0] + 1
        pos += 4 + slen
    if bsize is None:
        raise BgzfError("BGZF block missing BC subfield")
    return bsize, hdr + extra


def decompress_block(fh: BinaryIO) -> bytes | None:
    """Decompress the BGZF block at the current file position, or None at EOF."""
    start = fh.tell()
    got = _read_block_size(fh)
    if got is None:
        return None
    bsize, consumed = got
    body = fh.read(bsize - len(consumed))
    if len(body) < 8:
        raise BgzfError(f"truncated BGZF block at offset {start}")
    cdata = body[:-8]
    crc, isize = struct.unpack_from("<II", body, len(body) - 8)
    try:
        data = zlib.decompress(cdata, wbits=-15)
    except zlib.error as e:
        raise BgzfError(f"corrupt BGZF block at offset {start}: {e}") from e
    if len(data) != isize:
        raise BgzfError(f"BGZF ISIZE mismatch at offset {start}")
    if zlib.crc32(data) != crc:
        raise BgzfError(f"BGZF CRC mismatch at offset {start}")
    return data


def compress_block(data: bytes, level: int = 6) -> bytes:
    """Compress ≤64KiB of data into one BGZF block."""
    assert len(data) <= 0x10000
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = co.compress(data) + co.flush()
    total = len(cdata) + 26  # header(12) + extra(6) + crc/isize(8)
    header = _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
    extra = struct.pack("<2BH H", 66, 67, 2, total - 1)  # BSIZE = total - 1
    tail = struct.pack("<II", zlib.crc32(data), len(data))
    return header + extra + cdata + tail


def is_bgzf(path: str) -> bool:
    """Sniff the BGZF magic (the reference checks bgzip-ness of input VCFs,
    ref: cli.rs:245-298)."""
    try:
        with open(path, "rb") as fh:
            head = fh.read(18)
    except OSError:
        return False
    return (len(head) >= 18 and head[0] == 0x1F and head[1] == 0x8B
            and head[3] & 4 and head[12] == 66 and head[13] == 67)


class BgzfReader:
    """Random-access BGZF reader with virtual-offset seek.

    Caches the current decompressed block; sequential reads stream
    block-to-block.
    """

    def __init__(self, path_or_fh):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh: BinaryIO = open(path_or_fh, "rb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._block_start = 0  # coffset of cached block
        self._block: bytes = b""
        self._within = 0       # uoffset within cached block
        self._next_coffset = 0
        self._load_block(0)

    def close(self):
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _load_block(self, coffset: int) -> bool:
        self._fh.seek(coffset)
        data = decompress_block(self._fh)
        self._block_start = coffset
        self._within = 0
        if data is None:
            self._block = b""
            self._next_coffset = coffset
            return False
        self._block = data
        self._next_coffset = self._fh.tell()
        return True

    @property
    def virtual_offset(self) -> int:
        return (self._block_start << 16) | self._within

    def seek_virtual(self, voffset: int) -> None:
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        if coffset != self._block_start or not self._block:
            self._load_block(coffset)
        self._within = uoffset

    def read(self, n: int) -> bytes:
        out = []
        need = n
        while need > 0:
            avail = len(self._block) - self._within
            if avail == 0:
                if not self._load_block(self._next_coffset):
                    break
                continue
            take = min(avail, need)
            out.append(self._block[self._within:self._within + take])
            self._within += take
            need -= take
        return b"".join(out)

    def readline(self) -> bytes:
        """Read one newline-terminated line (for VCF text over BGZF)."""
        out = []
        while True:
            if self._within >= len(self._block):
                if not self._load_block(self._next_coffset):
                    break
            nl = self._block.find(b"\n", self._within)
            if nl == -1:
                out.append(self._block[self._within:])
                self._within = len(self._block)
            else:
                out.append(self._block[self._within:nl + 1])
                self._within = nl + 1
                break
        return b"".join(out)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            line = self.readline()
            if not line:
                return
            yield line

    def read_all(self) -> bytes:
        """Decompress the remainder of the stream (parallel native path when
        reading from the start of the file)."""
        if self._block_start == 0 and self._within == 0:
            from reference.io import native
            self._fh.seek(0)
            raw = self._fh.read()
            out = native.bgzf_decompress_all(raw)
            if out is not None:
                self._load_block(len(raw))  # park the cursor at EOF
                return out
            self._load_block(0)
        chunks = [self._block[self._within:]]
        self._within = len(self._block)
        while self._load_block(self._next_coffset):
            chunks.append(self._block)
            self._within = len(self._block)
        return b"".join(chunks)


class BgzfBatchWriter:
    """BGZF writer with deterministic block partitioning and batched
    (optionally native-multithreaded) compression.

    Payload blocks are always exactly MAX_BLOCK_PAYLOAD bytes (except the
    final one), so the block index of any uncompressed position is
    ``upos // MAX_BLOCK_PAYLOAD`` — callers record uncompressed positions
    during writing and convert them to virtual offsets after ``close()``
    via ``voffset()``. This is what lets compression run as a parallel
    batch (the analog of htslib's bgzf thread pool) while index builders
    still get exact chunk offsets.
    """

    BATCH_BLOCKS = 256  # ~16 MiB of payload per compression batch

    def __init__(self, path_or_fh, level: int = 6, threads: int = 4):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh: BinaryIO = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._buf = bytearray()
        self._level = level
        self._threads = threads
        self._upos = 0
        self._coffsets = [0]  # compressed offset of each payload block
        self._closed = False

    @property
    def upos(self) -> int:
        """Total uncompressed bytes written so far."""
        return self._upos

    def write(self, data: bytes) -> int:
        self._buf += data
        self._upos += len(data)
        if len(self._buf) >= self.BATCH_BLOCKS * MAX_BLOCK_PAYLOAD:
            self._compress_batch(final=False)
        return len(data)

    def _compress_batch(self, final: bool) -> None:
        limit = len(self._buf) if final else \
            (len(self._buf) // MAX_BLOCK_PAYLOAD) * MAX_BLOCK_PAYLOAD
        if limit == 0:
            return
        chunk = bytes(self._buf[:limit])
        del self._buf[:limit]
        payloads = [chunk[i:i + MAX_BLOCK_PAYLOAD]
                    for i in range(0, len(chunk), MAX_BLOCK_PAYLOAD)]
        from reference.io import native
        blob = native.bgzf_compress_blocks(payloads, self._level,
                                           self._threads)
        if blob is None:
            if self._threads > 1:
                # zlib releases the GIL: the same blocks, compressed on threads
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(self._threads) as pool:
                    parts = list(pool.map(
                        lambda p: compress_block(p, self._level), payloads))
            else:
                parts = [compress_block(p, self._level) for p in payloads]
            blob = b"".join(parts)
            for part in parts:
                self._coffsets.append(self._coffsets[-1] + len(part))
        else:
            # native path: re-scan block sizes from the emitted stream
            pos = 0
            base = self._coffsets[-1]
            while pos < len(blob):
                bsize = (blob[pos + 16] | (blob[pos + 17] << 8)) + 1
                pos += bsize
                self._coffsets.append(base + pos)
        self._fh.write(blob)

    def close(self) -> None:
        if self._closed:
            return
        self._compress_batch(final=True)
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        else:
            self._fh.flush()
        self._closed = True

    def voffset(self, upos: int) -> int:
        """Convert an uncompressed position to a BGZF virtual offset.
        Only valid after close()."""
        assert self._closed
        block = upos // MAX_BLOCK_PAYLOAD
        within = upos % MAX_BLOCK_PAYLOAD
        if block >= len(self._coffsets):
            block = len(self._coffsets) - 1
            within = 0
        return (self._coffsets[block] << 16) | within


class BgzfWriter:
    """Streaming BGZF writer; tracks virtual offsets for index construction."""

    def __init__(self, path_or_fh, level: int = 6):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh: BinaryIO = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._buf = bytearray()
        self._level = level
        self._coffset = 0
        self._closed = False

    @property
    def virtual_offset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> int:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_PAYLOAD:
            self._flush_block(MAX_BLOCK_PAYLOAD)
        return len(data)

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        block = compress_block(chunk, self._level)
        self._fh.write(block)
        self._coffset += len(block)

    def flush(self) -> None:
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_BLOCK_PAYLOAD))
        self._fh.flush()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.write(BGZF_EOF)
        if self._owns:
            self._fh.close()
        else:
            self._fh.flush()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
