"""Device graph-WFA — PyTorch counterpart of ``hiphase_tpu/align/wfa_device.py``.

The algorithm is the JAX package's (its module docstring has the design
and the exactness argument): a banded edit-distance DP over the
topologically linearized variant graph, run as a forward min-plus scan over
the G positions of the graph, then a backward pass that marks every cell on
any optimal path. Results are bit-identical to
``hiphase_tpu.align.wfa_device.wfa_forward_backward``, pair by pair.

The device function takes a ragged batch of (graph, read) pairs, each read
against its own graph (`wfa_forward_backward_batched`). It runs the plain
PyTorch version (`wfa_forward_backward_batched_plain`, a loop over the pairs
of `wfa_forward_backward_plain`) for tensors on the CPU and launches the
hand-written kernel ``csrc/wfa_forward_backward.cu`` (one CTA per pair) for
tensors on a CUDA device, raising if it cannot. `wfa_forward_backward` is the
JAX package's single-graph signature, a thin call of the batched one.

`align_pairs_device` is the band ladder over a batch: H = 32 on every pair,
then H = 128 on the pairs not certified exact (``score + spread <= H``),
then H = 512; one launch per rung (and memory-sized sub-batch), one
host→device copy of the batch and one of each rung's offsets, one
device→host copy of each rung's results. `align_reads_device` is the same
ladder for many reads against one graph.

The host side (`GraphArrays`, `linearize_graph`, `_padded_arrays`,
`H_LADDER`) is the JAX package's numpy code, re-homed because importing its
module loads JAX. It returns arrays equal to the JAX package's for the same
graph, so both packages can be fed the same bytes. Dual mode's blocks are
packed by the native window packer instead (``csrc/wfa_pack.cc``, through
`PairBatch.from_windows`), which writes the same words; the Python
linearisation stays as its oracle and for the windows it refuses.
"""

from __future__ import annotations

import contextlib
import threading
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from hiphase_tpu_torch import kernels
from hiphase_tpu_torch.phasing.beam import _check
from hiphase_tpu_torch.tracing import OFF, Recorder

INF = 1 << 20

# CTA shapes the kernel is built for, (warps, cells per thread): a band row
# of 2H + 1 cells is held as 32·warps·cells cells in registers. A band gets
# the first of these that holds it (one warp up to H = 47, four warps of 3
# cells up to H = 191, four warps of 9 cells up to H = 575): the fastest on
# a batch of a few hundred windows at each rung of H_LADDER on an H100
# (PERF.md).
KERNEL_SHAPES = ((1, 3), (4, 3), (4, 9))
KERNEL_MAX_H = (max(32 * w * c for w, c in KERNEL_SHAPES) - 1) // 2
# a pair's read sits in shared memory when the batch's longest read is at
# most this many bytes; longer reads are read from device memory
READ_SMEM_MAX = 48 * 1024
# a pair's row of the launch offsets (see hp_wfa_forward_backward)
META_FIELDS = 12


def kernel_shape(H: int) -> tuple[int, int]:
    """(warps, cells per thread) of the CTA for band half-width H."""
    wb = 2 * H + 1
    for w, c in KERNEL_SHAPES:
        if 32 * w * c >= wb:
            return w, c
    raise ValueError(f"no built CTA shape holds a band of {wb} cells "
                     f"(H={H}); shapes: {KERNEL_SHAPES}")


@dataclass
class GraphArrays:
    """Host-side linearization of a WFAGraph (see linearize_graph)."""

    n_nodes: int
    spread: int                 # max over nodes of (maxpath − minpath)
    total_pos: int
    pchar: np.ndarray           # [G] int32; −1 for eps pass-through
    pnode: np.ndarray           # [G] int32
    pstart: np.ndarray          # [G] bool: join before this position
    pend: np.ndarray            # [G] bool: write end column after
    c_out: np.ndarray           # [G] int32 band center AFTER the position
    par_idx: np.ndarray         # [G, P] int32 (−1 pad; only at starts)
    par_shift: np.ndarray       # [G, P] int32 endcol rebase per parent
    last_node: int
    c_end: int                  # band center at the final end column


def linearize_graph(graph) -> GraphArrays:
    """Flatten a WFAGraph into the position stream the kernel scans."""
    n = graph.num_nodes
    minpath = [0] * n
    maxpath = [0] * n
    nchars = [len(s) for s in graph.sequences]
    for i in range(1, n):
        ps = graph.parents[i]
        minpath[i] = min(minpath[p] + nchars[p] for p in ps)
        maxpath[i] = max(maxpath[p] + nchars[p] for p in ps)
    spread = max(maxpath[i] - minpath[i] for i in range(n))

    # the JAX package appends per position; here each node is one slice of
    # the stream (a read's window is ~10^4 positions but ~10^2 nodes).
    # eps nodes get one pass-through position.
    P = max(1, max((len(p) for p in graph.parents), default=1))
    npos = np.maximum(np.asarray(nchars, np.int64), 1)
    first = np.concatenate([[0], np.cumsum(npos)[:-1]])
    total = int(npos.sum())
    pchar = np.full(total, -1, np.int32)
    c_out = np.empty(total, np.int32)
    for i in range(n):
        lo = int(first[i])
        if nchars[i]:
            pchar[lo:lo + nchars[i]] = np.frombuffer(graph.sequences[i],
                                                     np.uint8)
            c_out[lo:lo + nchars[i]] = minpath[i] + np.arange(
                1, nchars[i] + 1)
        else:
            c_out[lo] = minpath[i]
    pnode = np.repeat(np.arange(n, dtype=np.int32), npos)
    pstart = np.zeros(total, bool)
    pstart[first[1:]] = True
    pend = np.zeros(total, bool)
    pend[first + npos - 1] = True
    par_idx = np.full((total, P), -1, np.int32)
    par_shift = np.zeros((total, P), np.int32)
    for i in range(1, n):
        ps = graph.parents[i]
        par_idx[first[i], :len(ps)] = ps
        par_shift[first[i], :len(ps)] = [
            minpath[p] + nchars[p] - minpath[i] for p in ps]
    return GraphArrays(
        n_nodes=n, spread=spread, total_pos=total, pchar=pchar, pnode=pnode,
        pstart=pstart, pend=pend, c_out=c_out, par_idx=par_idx,
        par_shift=par_shift, last_node=n - 1,
        c_end=minpath[n - 1] + nchars[n - 1])


def _pad_up(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _padded_arrays(ga: GraphArrays):
    """Pad the position stream / parent table to bucketed shapes (G to 64,
    P to 2, N to 16, as the JAX package does). Pad positions are eps
    pass-throughs of the final column that never write end columns."""
    G = _pad_up(ga.total_pos, 64)
    P = _pad_up(ga.par_idx.shape[1], 2)
    N = _pad_up(ga.n_nodes, 16)
    pchar = np.full(G, -1, np.int32)
    pchar[:ga.total_pos] = ga.pchar
    pnode = np.full(G, ga.last_node, np.int32)
    pnode[:ga.total_pos] = ga.pnode
    pstart = np.zeros(G, bool)
    pstart[:ga.total_pos] = ga.pstart
    pend = np.zeros(G, bool)
    pend[:ga.total_pos] = ga.pend
    c_out = np.full(G, ga.c_end, np.int32)
    c_out[:ga.total_pos] = ga.c_out
    par_idx = np.full((G, P), -1, np.int32)
    par_idx[:ga.total_pos, :ga.par_idx.shape[1]] = ga.par_idx
    par_shift = np.zeros((G, P), np.int32)
    par_shift[:ga.total_pos, :ga.par_idx.shape[1]] = ga.par_shift
    return pchar, pnode, pstart, pend, c_out, par_idx, par_shift, N


H_LADDER = (32, 128, 512)


# ---------------------------------------------------------------------------
# A batch of (graph, read) pairs, packed on the host for one upload.
#
# A graph is its position stream, 8 bytes a position: (band center, code)
# with code = char | eps << 8 | start << 9 | end << 10 | node << 11, and its
# parent tables by node, [N, P] (a position's parents are those of its node
# at the node's first position, and none elsewhere). The batch is one int32
# buffer: every graph's stream, then the parent tables, then the reads as
# bytes, each in a slot padded to 16 bytes.

@dataclass
class _Graph:
    pos: np.ndarray             # [G, 2] int32
    par_idx: np.ndarray         # [N, P] int32
    par_shift: np.ndarray       # [N, P] int32
    last_node: int
    c_end: int
    spread: int


def _graph_record(pchar, pnode, pstart, pend, c_out, par_idx, par_shift,
                  n_nodes: int, last_node: int, c_end: int,
                  spread: int = 0) -> _Graph:
    """A graph's padded arrays (`_padded_arrays`) in the batch layout."""
    G = len(pchar)
    if G < 2 or G % 2 or not 0 <= last_node < n_nodes or n_nodes >= 1 << 20:
        raise ValueError(f"need an even G >= 2, 0 <= last_node < n_nodes "
                         f"< 2^20 (G={G}, last_node={last_node}, "
                         f"n_nodes={n_nodes})")
    if (np.asarray(par_shift) < 0).any():
        raise ValueError("par_shift must be >= 0 (parents end at or after "
                         "their child's band center)")
    pchar = np.asarray(pchar, np.int32)
    pnode = np.asarray(pnode, np.int32)
    pstart = np.asarray(pstart, bool)
    code = ((pchar & 0xFF) | ((pchar < 0).astype(np.int32) << 8)
            | (pstart.astype(np.int32) << 9)
            | (np.asarray(pend, bool).astype(np.int32) << 10)
            | (pnode << 11))
    pos = np.stack([np.asarray(c_out, np.int32), code], 1).astype(np.int32)
    P = par_idx.shape[1]
    pidx = np.full((n_nodes, P), -1, np.int32)
    psh = np.zeros((n_nodes, P), np.int32)
    first = np.flatnonzero(pstart)
    pidx[pnode[first]] = par_idx[first]
    psh[pnode[first]] = par_shift[first]
    return _Graph(pos, pidx, psh, int(last_node), int(c_end), int(spread))


class PairBatch:
    """Pairs (graph ``graph_of[b]``, ``reads[b]``) packed for one upload;
    per-pair offsets into the packed arrays as numpy vectors.
    ``n_native`` counts the pairs whose graph the native window packer
    wrote (`from_windows`)."""

    def __init__(self, graphs: list[_Graph], reads: list[bytes],
                 graph_of: list[int]):
        sg = np.asarray(graph_of, np.int64)
        g_off, n_off = self._lay_out(
            [len(g.pos) for g in graphs], [len(g.par_idx) for g in graphs],
            max(g.par_idx.shape[1] for g in graphs), sg,
            [len(r) for r in reads])
        self.last_node = np.array([graphs[i].last_node for i in sg], np.int64)
        self.c_end = np.array([graphs[i].c_end for i in sg], np.int64)
        self.spread = np.array([graphs[i].spread for i in sg], np.int64)
        for g, go, no in zip(graphs, g_off, n_off):
            self._put(g, go, no)
        self._put_reads(np.frombuffer(b"".join(reads), np.uint8),
                        np.cumsum([0] + [len(r) for r in reads]))

    @classmethod
    def of_pairs(cls, pairs: list[tuple]) -> PairBatch:
        """(graph, read) pairs, each graph linearised in Python
        (`linearize_graph`)."""
        return cls([_linearized(g) for g, _r in pairs],
                   [r for _g, r in pairs], list(range(len(pairs))))

    @classmethod
    def from_windows(cls, pack, chrom_seq: bytes, ref_start, ref_end,
                     read_blob, read_off, python_graph):
        """Read k, read_blob[read_off[k]:read_off[k + 1]], against the graph
        of its window [ref_start[k], ref_end[k]) of ``chrom_seq`` over the
        block's variants ``pack`` (a
        `phasing.global_realign.WfaBlockPack`), one graph a pair. The native
        window packer (csrc/wfa_pack.cc: `io.native.wfa_pack_sizes`, then
        `wfa_pack_write`) builds and writes each window's graph; a window it
        refuses, and every window where its library is not bound or
        ``pack`` is None, is linearised here from the `WFAGraph`
        ``python_graph(k)``. Returns (batch, built [n] bool, triples): the
        packer's (node, block variant index, allele) triples of built
        window k are [tri_off[k], tri_off[k + 1]) of (tri_off, node, var,
        val)."""
        from hiphase_tpu_torch.io import native

        n = len(ref_start)
        rlen = np.diff(read_off)
        args = (pack, chrom_seq, ref_start, ref_end, read_blob, read_off)
        info = native.wfa_pack_sizes(*args) if pack is not None else None
        if info is None:
            info = np.zeros((n, native.PACK_INFO), np.int64)
        built = info[:, 0] == 1
        graphs = {int(k): _linearized(python_graph(int(k)))
                  for k in np.flatnonzero(~built)}
        # G, N, P, last node, c_end, spread
        sizes = info[:, 1:7].copy()
        for k, g in graphs.items():
            sizes[k] = (len(g.pos), len(g.par_idx), g.par_idx.shape[1],
                        g.last_node, g.c_end, g.spread)
        self = cls.__new__(cls)
        self._lay_out(sizes[:, 0], sizes[:, 1], sizes[:, 2].max(),
                      np.arange(n), rlen)
        self.n_native = int(built.sum())
        self.last_node, self.c_end, self.spread = sizes[:, 3:6].T.copy()
        tri_off = np.concatenate(
            [[0], np.cumsum(np.where(built, info[:, 7], 0))]).astype(np.int64)
        if self.n_native:
            # writes every read's bases too
            triples = native.wfa_pack_write(
                *args, info, self.P, self.goff, self.gnoff, self.roff,
                self.sections, self.flat, tri_off)
        else:
            triples = (np.zeros(0, np.int32),) * 3
            self._put_reads(read_blob, read_off)
        for k, g in graphs.items():
            self._put(g, self.goff[k], self.gnoff[k])
        return self, built, (tri_off, *triples)

    def _lay_out(self, g_len, n_len, P: int, graph_of: np.ndarray, rlen):
        """Place graphs of ``g_len`` positions and ``n_len`` nodes (parent
        tables P wide), pair b's graph graph_of[b] and its read of rlen[b]
        bytes: the per-pair vectors, the sections and a zeroed buffer.
        Returns each graph's position and node offsets."""
        g_len = np.asarray(g_len, np.int64)
        n_len = np.asarray(n_len, np.int64)
        g_off, n_off = _exclusive(g_len), _exclusive(n_len)
        self.n, self.n_native, self.P = len(rlen), 0, int(P)
        self.goff, self.G = g_off[graph_of], g_len[graph_of]
        self.gnoff, self.N = n_off[graph_of], n_len[graph_of]
        self.rlen = np.asarray(rlen, np.int64)
        slot = (np.maximum(self.rlen, 1) + 15) // 16 * 16
        self.roff = _exclusive(slot)
        words = [2 * int(g_len.sum()), int(n_len.sum()) * self.P,
                 int(n_len.sum()) * self.P, int(slot.sum()) // 4]
        # every section starts on a 16-byte boundary
        self.sections = np.cumsum([0] + [w + -w % 4 for w in words])
        if int(self.sections[-1]) >= 1 << 31:
            raise ValueError("a WFA pair batch must hold < 2^31 words")
        self.flat = np.zeros(int(self.sections[-1]), np.int32)
        return g_off, n_off

    def _put(self, g: _Graph, goff: int, gnoff: int) -> None:
        """Graph g's positions at position offset goff, its parent tables
        at node offset gnoff, padded to P with -1 and 0."""
        lo = 2 * int(goff)
        self.flat[lo:lo + g.pos.size] = g.pos.ravel()
        N = len(g.par_idx)
        for sec, table, fill in ((1, g.par_idx, -1), (2, g.par_shift, 0)):
            lo = int(self.sections[sec]) + int(gnoff) * self.P
            rows = self.flat[lo:lo + N * self.P].reshape(N, self.P)
            rows[:] = fill
            rows[:, :table.shape[1]] = table

    def _put_reads(self, read_blob, read_off) -> None:
        """Pair b's read, read_blob[read_off[b]:read_off[b + 1]], at its
        read-byte offset."""
        s = self.sections
        read_bytes = self.flat[s[3]:s[4]].view(np.uint8)
        for off, lo, hi in zip(self.roff, read_off[:-1], read_off[1:]):
            read_bytes[off:off + hi - lo] = read_blob[lo:hi]

    def upload(self, device: torch.device):
        """(pos [ΣG, 2] int32, par_idx, par_shift [ΣN, P] int32, reads [R]
        uint8) on ``device``, in one host→device copy."""
        flat = torch.from_numpy(self.flat).to(device)
        s = [int(x) for x in self.sections]
        return (flat[s[0]:s[1]].view(-1, 2), flat[s[1]:s[2]].view(-1, self.P),
                flat[s[2]:s[3]].view(-1, self.P),
                flat[s[3]:s[4]].view(torch.uint8))

    def need_bytes(self, H: int) -> np.ndarray:
        """Device scratch of each pair at band H (`scratch_bytes`)."""
        return scratch_bytes(self.G, self.N, H)

    def meta(self, idx: np.ndarray, groups: list[tuple[int, int]]
             ) -> np.ndarray:
        """Launch offsets [len(idx), META_FIELDS] of pairs ``idx``: output
        index and traversed offset over all of them, scratch offsets within
        each launch group ``idx[lo:hi]``."""
        m = np.zeros((len(idx), META_FIELDS), np.int64)
        m[:, 0], m[:, 1] = self.goff[idx], self.G[idx]
        m[:, 2], m[:, 3] = self.gnoff[idx], self.N[idx]
        m[:, 4], m[:, 5] = self.roff[idx], self.rlen[idx]
        m[:, 6], m[:, 7] = self.last_node[idx], self.c_end[idx]
        for lo, hi in groups:
            m[lo:hi, 8] = _exclusive(self.G[idx[lo:hi]])
            m[lo:hi, 9] = _exclusive(self.N[idx[lo:hi]])
        m[:, 10] = np.arange(len(idx))
        m[:, 11] = _exclusive(self.N[idx])
        if m.max(initial=0) >= 1 << 31:
            raise ValueError("WFA launch offsets exceed int32")
        return m.astype(np.int32)


def scratch_bytes(positions, nodes, H: int):
    """Device scratch of the DP for ``positions`` graph positions and
    ``nodes`` nodes at band H: out-columns at every position, in-columns
    at every node (rows of 32·warps·cells int32 cells), end columns (int32)
    and their marks (uint8) at every node, 2H + 1 cells each."""
    warps, cells = kernel_shape(H)
    rw = 32 * warps * cells
    return 4 * rw * (positions + nodes) + 5 * nodes * (2 * H + 1)


def _exclusive(x: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(x)[:-1]])


def _free_bytes(dev: torch.device) -> int:
    free, _total = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)


# ---------------------------------------------------------------------------
# The banded forward/backward DP: wrappers, then the plain versions.

def wfa_forward_backward_batched(pos, par_idx, par_shift, reads, meta, H: int,
                                 *, n_out: int, trav_len: int,
                                 scratch_pos: int, scratch_nodes: int,
                                 max_read_len: int, out=None):
    """Banded forward DP + backward optimal-path marking over a ragged batch
    of (graph, read) pairs.

    Args, all on one device (the layout of `PairBatch`): pos [ΣG, 2] int32,
    par_idx / par_shift [ΣN, P] int32, reads [R] uint8, meta [B, 12] int32
    (`PairBatch.meta`); H = band half-width. The host-known sizes: n_out and
    trav_len size the outputs (max output index + 1, max traversed offset +
    N), scratch_pos / scratch_nodes the scratch (ΣG and ΣN over the pairs
    of this call), max_read_len the longest read. ``out`` = (score,
    in_band, trav) to write into instead of new tensors. The CTA shape
    follows from H (`kernel_shape`).

    Returns (score [n_out] int32, in_band [n_out] bool, trav [trav_len]
    bool): pair b's results at meta[b, 10] and its nodes' traversed flags
    at meta[b, 11]. A score of >= INF means no in-band alignment.

    CPU tensors run `wfa_forward_backward_batched_plain`; CUDA tensors
    launch the kernel (one CTA per pair) or raise.
    """
    if meta.device.type == "cpu":
        return wfa_forward_backward_batched_plain(
            pos, par_idx, par_shift, reads, meta, H, n_out=n_out,
            trav_len=trav_len, out=out)
    dev = meta.device
    B = meta.shape[0]
    P = par_idx.shape[1] if par_idx.dim() == 2 else -1
    for name, t, dt, shape in (
            ("pos", pos, torch.int32, (pos.shape[0], 2)),
            ("par_idx", par_idx, torch.int32, (par_idx.shape[0], P)),
            ("par_shift", par_shift, torch.int32, par_idx.shape),
            ("reads", reads, torch.uint8, (reads.shape[0],)),
            ("meta", meta, torch.int32, (B, META_FIELDS))):
        _check(name, t, dt, shape, dev)
    if not 0 <= H <= KERNEL_MAX_H:
        raise ValueError(f"wfa_forward_backward: H={H} is outside "
                         f"[0, {KERNEL_MAX_H}]")
    if P < 1 or pos.data_ptr() % 16 or reads.data_ptr() % 16:
        raise ValueError("need P >= 1 and 16-byte aligned pos and reads")
    warps, cells = kernel_shape(H)
    wb = 2 * H + 1
    rw = 32 * warps * cells
    if out is None:
        out = (torch.empty(n_out, dtype=torch.int32, device=dev),
               torch.empty(n_out, dtype=torch.bool, device=dev),
               torch.empty(trav_len, dtype=torch.bool, device=dev))
    score, in_band, trav = out
    _check("score", score, torch.int32, (n_out,), dev)
    _check("in_band", in_band, torch.bool, (n_out,), dev)
    _check("trav", trav, torch.bool, (trav_len,), dev)
    if B == 0:
        return out
    need = scratch_bytes(scratch_pos, scratch_nodes, H)
    free = _free_bytes(dev)
    if need > free:
        raise MemoryError(f"wfa_forward_backward needs {need} bytes of "
                          f"scratch for {B} pairs (ΣG, ΣN, Wb) = "
                          f"({scratch_pos}, {scratch_nodes}, {wb}); "
                          f"{free} are free on {dev}")
    cols_out = torch.empty((scratch_pos, rw), dtype=torch.int32, device=dev)
    cols_in = torch.empty((scratch_nodes, rw), dtype=torch.int32, device=dev)
    endcols = torch.empty((scratch_nodes, wb), dtype=torch.int32, device=dev)
    mark_end = torch.empty((scratch_nodes, wb), dtype=torch.uint8, device=dev)
    read_smem = min(_pad_up(max(max_read_len, 1), 16), READ_SMEM_MAX)
    kernels.WFA_FORWARD_BACKWARD.launch(
        pos.data_ptr(), par_idx.data_ptr(), par_shift.data_ptr(),
        reads.data_ptr(), meta.data_ptr(), B, P, H, warps, cells, read_smem,
        cols_in.data_ptr(), cols_out.data_ptr(), endcols.data_ptr(),
        mark_end.data_ptr(), score.data_ptr(), in_band.data_ptr(),
        trav.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    return out


def wfa_forward_backward_batched_plain(pos, par_idx, par_shift, reads, meta,
                                       H: int, *, n_out: int, trav_len: int,
                                       out=None):
    """Plain PyTorch `wfa_forward_backward_batched`: each pair's slice of
    the batch, unpacked to the JAX package's single-graph arrays, through
    `wfa_forward_backward_plain`."""
    dev = meta.device
    if out is None:
        out = (torch.full((n_out,), INF, dtype=torch.int32, device=dev),
               torch.zeros(n_out, dtype=torch.bool, device=dev),
               torch.zeros(trav_len, dtype=torch.bool, device=dev))
    score, in_band, trav = out
    P = par_idx.shape[1]
    for row in meta.tolist():
        goff, G, gnoff, N, roff, rlen, last, cend, _s, _n, oi, toff = row
        c_out = pos[goff:goff + G, 0]
        code = pos[goff:goff + G, 1]
        pchar = torch.where((code >> 8) & 1 == 1, -1, code & 0xFF)
        pstart = (code >> 9) & 1 == 1
        pend = (code >> 10) & 1 == 1
        pnode = code >> 11
        first = pnode[pstart].long()
        pidx = torch.full((G, P), -1, dtype=torch.int32, device=dev)
        psh = torch.zeros((G, P), dtype=torch.int32, device=dev)
        pidx[pstart] = par_idx[gnoff:gnoff + N][first]
        psh[pstart] = par_shift[gnoff:gnoff + N][first]
        read = torch.zeros((1, max(rlen, 1)), dtype=torch.int32, device=dev)
        read[0, :rlen] = reads[roff:roff + rlen].to(torch.int32)
        s, t, ib = wfa_forward_backward_plain(
            pchar.to(torch.int32), pnode, pstart, pend, c_out, pidx, psh,
            read, torch.tensor([rlen], dtype=torch.int32, device=dev), H, N,
            last, cend)
        score[oi], in_band[oi] = s[0], ib[0]
        trav[toff:toff + N] = t[0]
    return out


def wfa_forward_backward(pchar, pnode, pstart, pend, c_out, par_idx,
                         par_shift, reads, read_len, H: int, n_nodes: int,
                         last_node: int, c_end: int):
    """Banded forward DP + backward optimal-path marking of B reads against
    one graph — the JAX package's signature, as one batch of B pairs.

    Args: the graph position arrays of `_padded_arrays` (pchar, pnode,
    c_out [G] int32, pstart, pend [G] bool, par_idx, par_shift [G, P]
    int32, with every shift >= 0 as `linearize_graph` makes them, G even),
    reads [B, Lr] int32 (padded, Lr >= 1), read_len [B] int32, all on one
    device; H = band half-width; n_nodes = rows of the end-column buffer.

    Returns (score [B] int32, traversed [B, n_nodes] bool, in_band [B]
    bool). A score of >= INF means no in-band alignment.
    """
    dev = reads.device
    B, Lr = reads.shape
    G = pchar.shape[0]
    P = par_idx.shape[1] if par_idx.dim() == 2 else -1
    for name, t, dt, shape in (
            ("pchar", pchar, torch.int32, (G,)),
            ("pnode", pnode, torch.int32, (G,)),
            ("pstart", pstart, torch.bool, (G,)),
            ("pend", pend, torch.bool, (G,)),
            ("c_out", c_out, torch.int32, (G,)),
            ("par_idx", par_idx, torch.int32, (G, P)),
            ("par_shift", par_shift, torch.int32, (G, P)),
            ("reads", reads, torch.int32, (B, Lr)),
            ("read_len", read_len, torch.int32, (B,))):
        _check(name, t, dt, shape, dev)
    if Lr < 1 or P < 1:
        raise ValueError(f"need Lr, P >= 1 (Lr={Lr}, P={P})")
    host = [t.cpu().numpy() for t in (pchar, pnode, pstart, pend, c_out,
                                       par_idx, par_shift)]
    graph = _graph_record(*host, n_nodes, last_node, c_end)
    rl = read_len.cpu().numpy()
    rd = reads.cpu().numpy()
    batch = PairBatch([graph], [rd[b, :rl[b]].astype(np.uint8).tobytes()
                                for b in range(B)], [0] * B)
    idx = np.arange(B)
    meta = torch.from_numpy(batch.meta(idx, [(0, B)])).to(dev)
    score, in_band, trav = wfa_forward_backward_batched(
        *batch.upload(dev), meta, H, n_out=B, trav_len=B * n_nodes,
        scratch_pos=B * G, scratch_nodes=B * n_nodes,
        max_read_len=int(rl.max(initial=0)))
    return score, trav.view(B, n_nodes), in_band


def wfa_forward_backward_plain(pchar, pnode, pstart, pend, c_out, par_idx,
                               par_shift, reads, read_len, H: int,
                               n_nodes: int, last_node: int, c_end: int):
    """Plain PyTorch single-graph DP (the JAX scan, step for step): a
    Python loop over the G positions, forward and then backward, with
    [B, Wb] tensor ops inside, on the tensors' device."""
    dev = reads.device
    B, Lr = reads.shape
    Wb = 2 * H + 1
    i32 = torch.int32
    k = torch.arange(Wb, dtype=i32, device=dev)
    # the loop's control flow is read on the host
    ch_l, node_l = pchar.tolist(), pnode.tolist()
    st_l, en_l = pstart.tolist(), pend.tolist()
    pidx_l, psh_l = par_idx.tolist(), par_shift.tolist()
    if any(s < 0 for row in psh_l for s in row):
        raise ValueError("par_shift must be >= 0 (parents end at or after "
                         "their child's band center)")
    G = len(ch_l)
    last_node, c_end = int(last_node), int(c_end)

    # the read character and the substitution cost depend only on (g, k):
    # gathered once for all positions
    j = c_out[:, None] + k[None, :] - H                          # [G, Wb]
    rchar = reads[:, (j - 1).clamp(0, Lr - 1).long()]            # [B, G, Wb]
    sub = (rchar != pchar[None, :, None]).to(i32).transpose(0, 1)  # [G, B, Wb]
    j_ge1 = j >= 1                                               # [G, Wb]
    jv = (j[:, None, :] >= 0) & (j[:, None, :]
                                  <= read_len[None, :, None])    # [G, B, Wb]
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)
    no_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)

    def closure(base):
        t = torch.cummin(base - k, dim=1).values
        return (t + k).clamp_(max=INF)

    def join_col(endcols, pids, shifts):
        # parents' end columns rebased by their shift (the same read
        # position j sits at k_parent = k_child − shift), min over parents
        acc = torch.full((B, Wb), INF, dtype=i32, device=dev)
        for pid, sh in zip(pids, shifts):
            if pid >= 0 and sh < Wb:
                acc[:, sh:] = torch.minimum(acc[:, sh:],
                                            endcols[:, pid, :Wb - sh])
        return acc

    def rev_cummin(x):
        return torch.cummin(x.flip(1), dim=1).values.flip(1)

    def chain_left(mark, col):
        """Undo an insertion closure: P[k] = mark[k] | (link[k] & P[k+1])
        with link[k] = (col[k+1] == col[k] + 1), link[Wb−1] = False. P[k]
        holds iff the first marked cell at or right of k comes no later
        than the first broken link at or right of k."""
        brk = torch.ones_like(mark)
        brk[:, :-1] = col[:, 1:] != col[:, :-1] + 1
        first_brk = rev_cummin(torch.where(brk, k, Wb))
        first_mark = rev_cummin(torch.where(mark, k, Wb))
        return first_mark <= first_brk

    # initial column at the root (center 0): D[j] = j
    col = torch.where(k >= H, k - H, INF).to(i32).expand(B, Wb)
    col = torch.where(k[None, :] - H > read_len[:, None], INF, col)
    endcols = torch.full((B, n_nodes, Wb), INF, dtype=i32, device=dev)

    cols_in, cols_out = [], []
    for g in range(G):
        if st_l[g]:
            col = closure(join_col(endcols, pidx_l[g], psh_l[g]))
        cols_in.append(col)
        if ch_l[g] < 0:
            base = col
        else:
            diag = torch.where(j_ge1[g], col + sub[g], INF)
            dele = torch.cat([col[:, 1:], inf_col], dim=1) + 1
            base = torch.minimum(diag, dele)
        out = torch.where(jv[g], closure(base.clamp(max=INF)), INF)
        cols_out.append(out)
        if en_l[g]:
            endcols[:, node_l[g]] = out
        col = out

    kstar = read_len - c_end + H
    in_band = (kstar >= 0) & (kstar < Wb)
    last = endcols[:, last_node]
    score = last.gather(1, kstar.clamp(0, Wb - 1)[:, None].long())[:, 0]
    score = torch.where(in_band, score, INF)

    # ---- backward: mark every cell on any optimal path ----
    mark_end = torch.zeros((B, n_nodes, Wb), dtype=torch.bool, device=dev)
    mark_end[:, last_node] = ((k[None, :] == kstar[:, None])
                              & in_band[:, None] & (score[:, None] < INF))
    trav = torch.zeros((B, n_nodes), dtype=torch.bool, device=dev)
    mark = torch.zeros((B, Wb), dtype=torch.bool, device=dev)
    for g in reversed(range(G)):
        out, col_in, node = cols_out[g], cols_in[g], node_l[g]
        # marks routed from children arrive at this node's end column
        if en_l[g]:
            mark = mark | mark_end[:, node]
        mark = mark & (out < INF)
        trav[:, node] |= mark.any(dim=1)
        # undo the out-closure, then the char transition back to col_in
        mark = chain_left(mark, out)
        if ch_l[g] < 0:
            mark_in = mark & (col_in == out)
        else:
            base_diag = torch.where(j_ge1[g], col_in + sub[g], INF)
            diag_ok = mark & (base_diag == out)
            # out[k] came from col_in[k+1] (deletion): the mark lands one
            # cell to the RIGHT in the input column
            dele_ok = mark & (torch.cat([col_in[:, 1:], inf_col], dim=1) + 1
                              == out)
            mark_in = diag_ok | torch.cat([no_col, dele_ok[:, :-1]], dim=1)
        if st_l[g]:
            # undo the join-closure and route to the parents whose rebased
            # end cell equals the joined cell (ties mark several parents)
            mark_in = chain_left(mark_in, col_in)
            for pid, sh in zip(pidx_l[g], psh_l[g]):
                if pid >= 0 and sh < Wb:
                    mark_end[:, pid, :Wb - sh] |= mark_in[:, sh:] & (
                        endcols[:, pid, :Wb - sh] == col_in[:, sh:])
            # across a start the previous position's column is not the
            # input column (the join replaced it): marks flow via mark_end
            mark = torch.zeros_like(mark_in)
        else:
            mark = mark_in
    return score, trav, in_band


# ---------------------------------------------------------------------------
# The band ladder.

@dataclass
class WfaCounters:
    """Work of the device WFA over one run; shared by the prepare threads.

    ``band_calls`` counts launches of the batched DP (kernel launches when
    the device is a CUDA device), ``pair_launches`` the pairs they carried
    (``pairs_per_launch`` = their mean, with ``max_pairs_per_launch``);
    ``h2d_copies`` counts host→device copies (none on the CPU). All are
    kept apart from the beam solver's counters."""

    reads: int = 0                  # reads submitted to the ladder
    certified: dict = field(default_factory=dict)   # H → reads certified
    uncertified: int = 0            # left to the host aligner
    band_calls: int = 0
    pair_launches: int = 0
    max_pairs_per_launch: int = 0
    h2d_copies: int = 0
    # windows linearised for the ladder: by the native window packer, or
    # in Python (`linearize_graph`)
    windows: dict = field(default_factory=lambda: {"native": 0,
                                                   "python": 0})
    # blocks whose pass 1 (each read's window and aligned bases) ran in C++
    # (csrc/wfa_windows.cc) or in Python
    pass1: dict = field(default_factory=lambda: {"native": 0, "python": 0})
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, reads: int, certified: dict, uncertified: int,
            band_calls: int, pair_launches: int, max_pairs: int,
            h2d_copies: int) -> None:
        with self._lock:
            self.reads += reads
            for h, n in certified.items():
                self.certified[h] = self.certified.get(h, 0) + n
            self.uncertified += uncertified
            self.band_calls += band_calls
            self.pair_launches += pair_launches
            self.max_pairs_per_launch = max(self.max_pairs_per_launch,
                                            max_pairs)
            self.h2d_copies += h2d_copies

    def add_windows(self, native: int, python: int) -> None:
        with self._lock:
            self.windows["native"] += native
            self.windows["python"] += python

    def add_pass1(self, native: bool) -> None:
        with self._lock:
            self.pass1["native" if native else "python"] += 1

    def as_dict(self) -> dict:
        with self._lock:
            return {"reads": self.reads,
                    "certified": {str(h): n for h, n in
                                  sorted(self.certified.items())},
                    "uncertified": self.uncertified,
                    "band_calls": self.band_calls,
                    "pairs_per_launch": (
                        self.pair_launches / self.band_calls
                        if self.band_calls else 0.0),
                    "max_pairs_per_launch": self.max_pairs_per_launch,
                    "h2d_copies": self.h2d_copies,
                    "windows": dict(self.windows),
                    "pass1": dict(self.pass1)}


def _own_stream(device: torch.device):
    """A stream from torch's pool for one ladder on a CUDA device, so that
    prepare threads aligning at the same time do not serialise on one
    stream; the CPU needs none."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


_SCRATCH_LOCK = threading.Lock()


def _launch_groups(need: np.ndarray, budget: int | None
                   ) -> list[tuple[int, int]]:
    """Consecutive groups of pairs whose scratch fits ``budget`` bytes
    (each group at least one pair; None: one group)."""
    if budget is None:
        return [(0, len(need))]
    groups, lo, acc = [], 0, 0
    for i, n in enumerate(need.tolist()):
        if i > lo and acc + n > budget:
            groups.append((lo, i))
            lo, acc = i, 0
        acc += n
    groups.append((lo, len(need)))
    return groups


def align_pairs_device(make_batch: Callable[[], PairBatch],
                       device: torch.device, h_ladder=H_LADDER,
                       counters: WfaCounters | None = None,
                       spans: Recorder = OFF):
    """Align a batch of (graph, read) pairs on ``device``, each read
    against its own graph, climbing the band ladder together. The pairs
    are those of the `PairBatch` that ``make_batch()`` packs, inside the
    span: `PairBatch.of_pairs` for (graph, read) pairs,
    `PairBatch.from_windows` for a block's read windows.

    Returns a list parallel to the batch's pairs: (score, traversed_nodes)
    for pairs whose banded result is certified exact (score + spread <= H),
    or None for pairs the ladder could not certify — the caller falls back
    to the host aligner for those. Scores above the graph's max edit
    distance are returned as-is; the caller applies the reference's max-ED
    failure semantics. The results are those of aligning each pair alone.

    The whole call is a span ``wfa.ladder`` of ``spans``: linearising and
    packing the graphs, then each rung's sizing, launches and unpacking; a
    rung's wait for the scratch lock is a span ``wfa.scratch_lock`` and its
    wait for the results a span ``wfa.device_wait``. ``counters`` count
    the windows by who linearised them.
    """
    with spans.span("wfa.ladder"):
        batch = make_batch()
        if counters is not None:
            counters.add_windows(batch.n_native, batch.n - batch.n_native)
        return _ladder(batch, device, h_ladder, counters, spans)


def align_reads_device(graph, reads: list[bytes], device: torch.device,
                       h_ladder=H_LADDER,
                       counters: WfaCounters | None = None):
    """`align_pairs_device` for many reads against ONE graph."""
    batch = PairBatch([_linearized(graph)], list(reads), [0] * len(reads))
    if counters is not None:
        counters.add_windows(0, 1)
    return _ladder(batch, device, h_ladder, counters)


def _linearized(graph) -> _Graph:
    ga = linearize_graph(graph)
    *arrays, n_nodes = _padded_arrays(ga)
    return _graph_record(*arrays, n_nodes, ga.last_node, ga.c_end, ga.spread)


@contextlib.contextmanager
def _scratch_lock(on_card: bool, spans: Recorder):
    """Hold `_SCRATCH_LOCK` on a CUDA device; the wait for it is a span."""
    if not on_card:
        yield
        return
    with spans.span("wfa.scratch_lock"):
        _SCRATCH_LOCK.acquire()
    try:
        yield
    finally:
        _SCRATCH_LOCK.release()


def _ladder(batch: PairBatch, device: torch.device, h_ladder,
            counters: WfaCounters | None, spans: Recorder = OFF):
    on_card = device.type != "cpu"
    results: list = [None] * batch.n
    pending = np.arange(batch.n)
    certified: dict[int, int] = {}
    calls = copies = pair_launches = max_pairs = 0
    with _own_stream(device):
        arrays = batch.upload(device)
        copies += on_card
        for H in h_ladder:
            if not len(pending):
                break
            n = len(pending)
            n_trav = int(batch.N[pending].sum())
            # one buffer for the rung's results: score, in_band, trav
            out = torch.empty(5 * n + n_trav, dtype=torch.uint8,
                              device=device)
            views = (out[:4 * n].view(torch.int32),
                     out[4 * n:5 * n].view(torch.bool),
                     out[5 * n:].view(torch.bool))
            # ladders of other threads size their scratch from the same free
            # memory: one sizes and allocates at a time
            with _scratch_lock(on_card, spans):
                need = batch.need_bytes(H)[pending]
                groups = _launch_groups(
                    need, _free_bytes(device) // 2 if on_card else None)
                meta = torch.from_numpy(batch.meta(pending, groups)).to(
                    device)
                copies += on_card
                for lo, hi in groups:
                    idx = pending[lo:hi]
                    wfa_forward_backward_batched(
                        *arrays, meta[lo:hi], H, n_out=n, trav_len=n_trav,
                        scratch_pos=int(batch.G[idx].sum()),
                        scratch_nodes=int(batch.N[idx].sum()),
                        max_read_len=int(batch.rlen[idx].max()), out=views)
                    calls += 1
                    pair_launches += hi - lo
                    max_pairs = max(max_pairs, hi - lo)
            with spans.span("wfa.device_wait"):
                host = out.cpu().numpy()
            score = host[:4 * n].view(np.int32)
            trav = host[5 * n:]
            toff = _exclusive(batch.N[pending])
            nxt = []
            for bi, pi in enumerate(pending.tolist()):
                s = int(score[bi])
                if s < INF and s + int(batch.spread[pi]) <= H:
                    t = trav[toff[bi]:toff[bi] + batch.N[pi]]
                    results[pi] = (s, [int(x) for x in np.flatnonzero(t)])
                    certified[H] = certified.get(H, 0) + 1
                else:
                    nxt.append(pi)
            pending = np.asarray(nxt, np.int64)
    if counters is not None:
        counters.add(reads=batch.n, certified=certified,
                     uncertified=len(pending), band_calls=calls,
                     pair_launches=pair_launches, max_pairs=max_pairs,
                     h2d_copies=copies)
    return results
