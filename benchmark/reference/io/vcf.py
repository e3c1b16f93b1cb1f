"""VCF reader/writer over BGZF with tabix region fetch — native implementation.

Covers the reference's bcf usage (SURVEY.md §2 L0): indexed region fetch,
sample/GT/GQ access, INFO SVTYPE/TRID typing inputs, FORMAT tag strip and
GT/PS/PF rewrite, header editing, and tbi/csi index build.

Records keep their raw tab-split columns so untouched fields round-trip
byte-exactly through the copy-transform writer (the reference's writer is a
streaming record rewrite, ref: ordered_vcf_writer.rs:291-434).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from reference.io.bgzf import BgzfReader, is_bgzf
from reference.io.tabix import TabixBuilder, TabixIndex

MISSING = b"."


class VcfError(IOError):
    pass


@dataclass
class VcfHeader:
    lines: list[bytes]          # all ## meta lines, without trailing newline
    samples: list[str]

    @classmethod
    def parse(cls, header_lines: list[bytes]) -> "VcfHeader":
        meta = []
        samples: list[str] = []
        for line in header_lines:
            line = line.rstrip(b"\r\n")
            if line.startswith(b"##"):
                meta.append(line)
            elif line.startswith(b"#CHROM"):
                cols = line.split(b"\t")
                if len(cols) > 9:
                    samples = [c.decode() for c in cols[9:]]
                elif len(cols) == 10:
                    samples = [cols[9].decode()]
        return cls(meta, samples)

    def column_line(self) -> bytes:
        cols = [b"#CHROM", b"POS", b"ID", b"REF", b"ALT", b"QUAL", b"FILTER", b"INFO"]
        if self.samples:
            cols.append(b"FORMAT")
            cols.extend(s.encode() for s in self.samples)
        return b"\t".join(cols)

    def remove_format(self, tag: str) -> None:
        """Drop a ##FORMAT=<ID=tag,...> definition
        (ref: ordered_vcf_writer.rs:100-107 removes pre-existing PS/PF)."""
        needle = b"##FORMAT=<ID=" + tag.encode() + b","
        self.lines = [l for l in self.lines if not l.startswith(needle)]

    def add_line(self, line: str | bytes) -> None:
        self.lines.append(line.encode() if isinstance(line, str) else line)

    def contigs(self) -> list[str]:
        out = []
        for l in self.lines:
            if l.startswith(b"##contig=<"):
                body = l[len(b"##contig=<"):-1]
                for kv in body.split(b","):
                    if kv.startswith(b"ID="):
                        out.append(kv[3:].decode())
        return out

    def serialize(self) -> bytes:
        return b"\n".join(self.lines + [self.column_line()]) + b"\n"


@dataclass
class VcfRecord:
    """One VCF data line as raw columns; field parsers are lazy."""

    fields: list[bytes]
    _fmt_cache: list[bytes] | None = field(default=None, repr=False)

    @classmethod
    def parse(cls, line: bytes) -> "VcfRecord":
        return cls(line.rstrip(b"\r\n").split(b"\t"))

    @property
    def chrom(self) -> str:
        return self.fields[0].decode()

    @property
    def pos0(self) -> int:
        """0-based position."""
        return int(self.fields[1]) - 1

    @property
    def id(self) -> bytes:
        return self.fields[2]

    @property
    def ref(self) -> bytes:
        return self.fields[3]

    @property
    def alts(self) -> list[bytes]:
        a = self.fields[4]
        return [] if a == MISSING else a.split(b",")

    def alleles(self) -> list[bytes]:
        return [self.ref] + self.alts

    @property
    def qual(self) -> float | None:
        q = self.fields[5]
        return None if q == MISSING else float(q)

    # ---- INFO ----

    def info_get(self, key: str) -> bytes | None:
        """Value of an INFO key, b"" for flags, None if absent."""
        kb = key.encode()
        info = self.fields[7]
        if info == MISSING:
            return None
        for item in info.split(b";"):
            if b"=" in item:
                k, v = item.split(b"=", 1)
                if k == kb:
                    return v
            elif item == kb:
                return b""
        return None

    # ---- FORMAT / samples ----

    @property
    def format_keys(self) -> list[bytes]:
        if self._fmt_cache is None:
            if len(self.fields) > 8:
                self._fmt_cache = self.fields[8].split(b":")
            else:
                self._fmt_cache = []
        return self._fmt_cache

    def sample_values(self, sample_index: int) -> list[bytes]:
        return self.fields[9 + sample_index].split(b":")

    def format_index(self, tag: str) -> int:
        tb = tag.encode()
        for i, k in enumerate(self.format_keys):
            if k == tb:
                return i
        return -1

    def sample_field(self, sample_index: int, tag: str) -> bytes | None:
        fi = self.format_index(tag)
        if fi < 0:
            return None
        vals = self.sample_values(sample_index)
        if fi >= len(vals):
            return None  # trailing fields may be dropped per spec
        return vals[fi]

    def genotype(self, sample_index: int) -> tuple[list[int | None], bool]:
        """Return (allele indices, phased). Missing alleles are None.
        Haploid GTs return a single-element list
        (ref: phaser.rs:141-152 treats single-entry GT as hom)."""
        gt = self.sample_field(sample_index, "GT")
        if gt is None:
            return ([], False)
        phased = b"|" in gt
        parts = gt.replace(b"|", b"/").split(b"/")
        alleles: list[int | None] = []
        for p in parts:
            alleles.append(None if p in (b".", b"") else int(p))
        return alleles, phased

    def gq(self, sample_index: int) -> float | None:
        v = self.sample_field(sample_index, "GQ")
        if v is None or v == MISSING:
            return None
        return float(v)

    # ---- mutation (for the phased-VCF rewrite) ----

    def strip_format_tag(self, tag: str) -> None:
        """Remove a FORMAT tag and its per-sample values
        (ref: ordered_vcf_writer.rs:490-506)."""
        fi = self.format_index(tag)
        if fi < 0:
            return
        keys = self.format_keys
        del keys[fi]
        self.fields[8] = b":".join(keys) if keys else MISSING
        for si in range(9, len(self.fields)):
            vals = self.fields[si].split(b":")
            if fi < len(vals):
                del vals[fi]
            self.fields[si] = b":".join(vals) if vals else MISSING
        self._fmt_cache = None

    def set_sample_field(self, sample_index: int, tag: str, value: bytes) -> None:
        """Set a FORMAT field for one sample, appending the tag to FORMAT if
        new (other samples get '.')."""
        fi = self.format_index(tag)
        if fi < 0:
            keys = self.format_keys
            keys.append(tag.encode())
            self.fields[8] = b":".join(keys)
            fi = len(keys) - 1
            self._fmt_cache = None
        for si in range(9, len(self.fields)):
            vals = self.fields[si].split(b":")
            while len(vals) <= fi:
                vals.append(MISSING)
            if si - 9 == sample_index:
                vals[fi] = value
            self.fields[si] = b":".join(vals)

    def set_genotype(self, sample_index: int, alleles: list[int | None],
                     phased: bool) -> None:
        sep = b"|" if phased else b"/"
        gt = sep.join(MISSING if a is None else str(a).encode() for a in alleles)
        self.set_sample_field(sample_index, "GT", gt)

    def serialize(self) -> bytes:
        return b"\t".join(self.fields) + b"\n"


class VcfReader:
    """Indexed VCF reader (vcf.gz + .tbi/.csi, or plain text for tests)."""

    def __init__(self, path: str):
        self.path = path
        self._is_bgzf = is_bgzf(path)
        self._bcf = None
        self.header = self._read_header()
        self._index: TabixIndex | None = None
        if os.path.exists(path + ".tbi"):
            self._index = TabixIndex.load_tbi(path + ".tbi")
        elif os.path.exists(path + ".csi"):
            self._index = TabixIndex.load_csi(path + ".csi")

    def _open(self):
        if self._is_bgzf:
            return BgzfReader(self.path)
        return open(self.path, "rb")

    def _read_header(self) -> VcfHeader:
        lines = []
        with self._open() as fh:
            for line in fh:
                if line.startswith(b"#"):
                    lines.append(line)
                    if line.startswith(b"#CHROM"):
                        break
                else:
                    break
        return VcfHeader.parse(lines)

    @property
    def samples(self) -> list[str]:
        return self.header.samples

    def __iter__(self):
        if self._bcf is not None:
            for line in self._bcf:
                yield VcfRecord.parse(line)
            return
        with self._open() as fh:
            for line in fh:
                if line.startswith(b"#") or not line.strip():
                    continue
                yield VcfRecord.parse(line)

    def fetch(self, chrom: str, start: int, end: int):
        """Yield records overlapping [start, end) 0-based on chrom."""
        if self._bcf is not None:
            for line in self._bcf.fetch_lines(chrom, start, end):
                yield VcfRecord.parse(line)
            return
        if self._index is not None and self._is_bgzf:
            with BgzfReader(self.path) as bz:
                for cbeg, cend in self._index.query(chrom, start, end):
                    bz.seek_virtual(cbeg)
                    while bz.virtual_offset < cend:
                        line = bz.readline()
                        if not line:
                            break
                        if line.startswith(b"#"):
                            continue
                        rec = VcfRecord.parse(line)
                        if rec.chrom != chrom:
                            continue
                        p = rec.pos0
                        if p >= end:
                            break
                        rec_end = p + len(rec.ref)
                        if rec_end > start:
                            yield rec
        else:
            for rec in self:
                if rec.chrom != chrom:
                    continue
                p = rec.pos0
                if p < end and p + len(rec.ref) > start:
                    yield rec


class VcfWriter:
    """bgzip VCF writer that simultaneously builds a tabix/CSI index.

    Uses the batched BGZF writer (parallel deflate when the native library
    is built); record offsets are tracked as uncompressed positions and
    converted to virtual offsets at index time."""

    def __init__(self, path: str, header: VcfHeader, csi: bool = False,
                 io_threads: int = 4):
        from reference.io.bgzf import BgzfBatchWriter
        self.path = path
        self.header = header
        self.csi = csi
        self._bcf = None
        self._bgzf = BgzfBatchWriter(path, threads=io_threads)
        self._bgzf.write(header.serialize())
        self._entries: list[tuple[str, int, int, int, int]] = []
        self._closed = False

    def write(self, rec: VcfRecord) -> None:
        if self._bcf is not None:
            self._bcf.write_line(b"\t".join(rec.fields))
            return
        ubeg = self._bgzf.upos
        self._bgzf.write(rec.serialize())
        uend = self._bgzf.upos
        pos = rec.pos0
        self._entries.append(
            (rec.chrom, pos, pos + max(len(rec.ref), 1), ubeg, uend))

    def write_raw_lines(self, data: bytes, out_off, poss, ends,
                        chrom: str) -> None:
        """Append pre-serialized newline-terminated records in one write;
        out_off[i]..out_off[i+1] delimits record i for the index entries."""
        if self._bcf is not None:
            for i in range(len(poss)):
                line = data[int(out_off[i]):int(out_off[i + 1])]
                self._bcf.write_line(line.rstrip(b"\n"))
            return
        base = self._bgzf.upos
        self._bgzf.write(data)
        entries = self._entries
        for i in range(len(poss)):
            entries.append((chrom, int(poss[i]), int(ends[i]),
                            base + int(out_off[i]), base + int(out_off[i + 1])))

    def close(self) -> None:
        if self._closed:
            return
        if self._bcf is not None:
            self._bcf.close()
            self._closed = True
            return
        self._bgzf.close()
        self._closed = True

    def write_index(self) -> None:
        """(ref: vcf_util.rs:32-54 — tbi, or CSI min_shift 14)"""
        assert self._closed
        if self._bcf is not None:
            self._bcf.write_index()
            return
        from reference.io.tabix import depth_for
        max_end = max((e for _c, _b, e, _u, _v in self._entries), default=0)
        tabix = TabixBuilder(depth=depth_for(max_end))
        for chrom, beg, end, ubeg, uend in self._entries:
            tabix.add(chrom, beg, end, self._bgzf.voffset(ubeg),
                      self._bgzf.voffset(uend))
        idx = tabix.build()
        if self.csi:
            idx.save_csi(self.path + ".csi")
        else:
            idx.save_tbi(self.path + ".tbi")


def get_vcf_samples(path: str) -> list[str]:
    """Sample names from a VCF header (ref: block_gen.rs:23-33)."""
    return VcfReader(path).samples
