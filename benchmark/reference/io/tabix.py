"""Tabix (.tbi) and CSI (.csi) indexes for bgzipped VCF — native implementation.

The reference builds these via htslib's ``bcf_index_build3``
(ref: src/writers/vcf_util.rs:32-54; tbi default, CSI with min_shift 14 under
``--csi-index``). Readers + writers for both formats (tabix spec + CSIv1).
"""

from __future__ import annotations

import struct

from reference.io.bgzf import BgzfReader, BgzfWriter

TBI_MAGIC = b"TBI\x01"
CSI_MAGIC = b"CSI\x01"



def _reg2bin(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> int:
    end -= 1
    for level in range(depth, -1, -1):
        s = min_shift + 3 * (depth - level)
        if beg >> s == end >> s:
            offset = ((1 << level * 3) - 1) // 7
            return offset + (beg >> s)
    return 0


def _reg2bins(beg: int, end: int, min_shift: int = 14, depth: int = 5) -> list[int]:
    bins = []
    max_span = 1 << (min_shift + 3 * depth)
    end = min(end, max_span)
    beg = min(beg, max_span - 1)
    end -= 1
    for level in range(depth + 1):
        s = min_shift + 3 * (depth - level)
        offset = ((1 << level * 3) - 1) // 7
        bins.extend(range(offset + (beg >> s), offset + (end >> s) + 1))
    return bins


class TabixIndex:
    """Binning + linear index over a coordinate-sorted bgzipped text file.

    ``bins[i]`` maps bin→chunk list for the i-th indexed sequence name;
    ``loffsets[i]`` is either the 16kb linear index (tbi) or per-bin loffset
    map (csi, stored alongside chunks).
    """

    def __init__(self, names: list[str],
                 bins: list[dict[int, list[tuple[int, int]]]],
                 linear: list[list[int]],
                 min_shift: int = 14, depth: int = 5,
                 n_no_coor: int = 0):
        self.names = names
        self.bins = bins
        self.linear = linear
        self.min_shift = min_shift
        self.depth = depth
        self.n_no_coor = n_no_coor

    # ---- query ----

    def query(self, name: str, start: int, end: int) -> list[tuple[int, int]]:
        try:
            tid = self.names.index(name)
        except ValueError:
            return []
        return self.query_tid(tid, start, end)

    def query_tid(self, tid: int, start: int, end: int
                  ) -> list[tuple[int, int]]:
        """By-tid query (BAM/BCF CSI indexes carry no name table)."""
        if not 0 <= tid < len(self.bins):
            return []
        bins = self.bins[tid]
        linear = self.linear[tid]
        min_off = 0
        if linear:
            w = min(start >> self.min_shift, len(linear) - 1)
            min_off = linear[w]
        chunks = []
        for b in _reg2bins(start, end, self.min_shift, self.depth):
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

    # ---- tbi serialization ----

    @classmethod
    def load_tbi(cls, path: str) -> "TabixIndex":
        with BgzfReader(path) as bz:
            data = bz.read_all()
        if data[:4] != TBI_MAGIC:
            raise IOError(f"{path}: not a tabix index")
        (n_ref, _fmt, _col_seq, _col_beg, _col_end, _meta, _skip,
         l_nm) = struct.unpack_from("<8i", data, 4)
        off = 36
        names = data[off:off + l_nm].rstrip(b"\x00").split(b"\x00")
        names = [n.decode() for n in names]
        off += l_nm
        bins_per_ref, linear_per_ref = [], []
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
        return cls(names, bins_per_ref, linear_per_ref, n_no_coor=n_no_coor)

    def save_tbi(self, path: str) -> None:
        out = bytearray(TBI_MAGIC)
        nm = b"\x00".join(n.encode() for n in self.names) + b"\x00" if self.names else b""
        # format=2 (VCF), col_seq=1, col_beg=2, col_end=0, meta='#', skip=0
        out += struct.pack("<8i", len(self.names), 2, 1, 2, 0, ord("#"), 0, len(nm))
        out += nm
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
        with BgzfWriter(path) as bz:
            bz.write(bytes(out))

    # ---- csi serialization ----

    @classmethod
    def load_csi(cls, path: str) -> "TabixIndex":
        with BgzfReader(path) as bz:
            data = bz.read_all()
        if data[:4] != CSI_MAGIC:
            raise IOError(f"{path}: not a CSI index")
        min_shift, depth, l_aux = struct.unpack_from("<3i", data, 4)
        off = 16
        aux = data[off:off + l_aux]
        off += l_aux
        names: list[str] = []
        if l_aux >= 28:
            # tabix aux payload: format..l_nm then names
            l_nm = struct.unpack_from("<i", aux, 24)[0]
            names = [n.decode() for n in aux[28:28 + l_nm].rstrip(b"\x00").split(b"\x00") if n]
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins_per_ref, linear_per_ref = [], []
        for _ in range(n_ref):
            n_bin = struct.unpack_from("<i", data, off)[0]
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            loffs: dict[int, int] = {}
            for _ in range(n_bin):
                bin_id, loffset, n_chunk = struct.unpack_from("<IQi", data, off)
                off += 16
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((cb, ce))
                bins[bin_id] = chunks
                loffs[bin_id] = loffset
            bins_per_ref.append(bins)
            # synthesize a coarse linear index from per-bin loffsets
            linear_per_ref.append([])
        idx = cls(names, bins_per_ref, linear_per_ref,
                  min_shift=min_shift, depth=depth)
        return idx

    def save_csi(self, path: str) -> None:
        out = bytearray(CSI_MAGIC)
        nm = b"\x00".join(n.encode() for n in self.names) + b"\x00" if self.names else b""
        aux = struct.pack("<7i", 2, 1, 2, 0, ord("#"), 0, len(nm)) + nm
        out += struct.pack("<3i", self.min_shift, self.depth, len(aux))
        out += aux
        out += struct.pack("<i", len(self.bins))
        for bins, linear in zip(self.bins, self.linear):
            out += struct.pack("<i", len(bins))
            for bin_id in sorted(bins):
                chunks = bins[bin_id]
                # loffset: minimum chunk start in this bin
                loffset = min((cb for cb, _ in chunks), default=0)
                out += struct.pack("<IQi", bin_id, loffset, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
        out += struct.pack("<Q", self.n_no_coor)
        with BgzfWriter(path) as bz:
            bz.write(bytes(out))


def depth_for(max_end: int, min_shift: int = 14) -> int:
    """Smallest bin-tree depth addressing positions up to ``max_end``
    (depth 5 covers 2^29; long contigs need 6+ — htslib's CSI switch)."""
    depth = 5
    while max_end > (1 << (min_shift + 3 * depth)) and depth < 10:
        depth += 1
    return depth


class TabixBuilder:
    """Accumulates (name, beg, end, vbeg, vend) per record to build an index."""

    def __init__(self, min_shift: int = 14, depth: int = 5):
        self.names: list[str] = []
        self._tid: dict[str, int] = {}
        self.bins: list[dict[int, list[tuple[int, int]]]] = []
        self.linear: list[list[int]] = []
        self.min_shift = min_shift
        self.depth = depth

    def add(self, name: str, beg: int, end: int, vbeg: int, vend: int) -> None:
        tid = self._tid.get(name)
        if tid is None:
            tid = len(self.names)
            self._tid[name] = tid
            self.names.append(name)
            self.bins.append({})
            self.linear.append([])
        end = max(end, beg + 1)
        b = _reg2bin(beg, end, self.min_shift, self.depth)
        chunks = self.bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        lin = self.linear[tid]
        wbeg = beg >> self.min_shift
        wend = (end - 1) >> self.min_shift
        while len(lin) <= wend:
            lin.append(0)
        for w in range(wbeg, wend + 1):
            if lin[w] == 0 or vbeg < lin[w]:
                lin[w] = vbeg

    def build(self) -> TabixIndex:
        for lin in self.linear:
            last = 0
            for i in range(len(lin)):
                if lin[i] == 0:
                    lin[i] = last
                else:
                    last = lin[i]
        return TabixIndex(self.names, self.bins, self.linear,
                          self.min_shift, self.depth)
