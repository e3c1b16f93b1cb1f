"""Device graph-WFA — PyTorch counterpart of ``hiphase_tpu/align/wfa_device.py``.

The algorithm is the JAX package's (its module docstring has the design
and the exactness argument): a banded edit-distance DP over the
topologically linearized variant graph, run as a forward min-plus scan over
the G positions of the graph, then a backward pass that marks every cell on
any optimal path. Results are bit-identical to
``hiphase_tpu.align.wfa_device.wfa_forward_backward``.

`wfa_forward_backward` runs the plain PyTorch version
(`wfa_forward_backward_plain`) for tensors on the CPU and launches the
hand-written kernel ``csrc/wfa_forward_backward.cu`` for tensors on a CUDA
device, raising if it cannot. `align_reads_device` is the band ladder
around it: H = 32, 128, 512, a read's result certified exact when
``score + spread <= H``.

The host side (`GraphArrays`, `linearize_graph`, `_padded_arrays`,
`H_LADDER`) is the JAX package's numpy code, re-homed because importing its
module loads JAX. It returns arrays equal to the JAX package's for the same
graph, so both packages can be fed the same bytes.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from hiphase_tpu_torch import kernels
from hiphase_tpu_torch.phasing.beam import _check

INF = 1 << 20

# The kernel keeps a band row in one warp, C cells per lane, C one of these
# (the smallest with 32·C >= 2H + 1).
KERNEL_CELLS_PER_LANE = (3, 9, 17, 33)
KERNEL_MAX_H = (32 * KERNEL_CELLS_PER_LANE[-1] - 1) // 2


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
# The banded forward/backward DP: wrapper, then its plain version.

def wfa_forward_backward(pchar, pnode, pstart, pend, c_out, par_idx,
                         par_shift, reads, read_len, H: int, n_nodes: int,
                         last_node: int, c_end: int):
    """Banded forward DP + backward optimal-path marking.

    Args: the graph position arrays of `_padded_arrays` (pchar, pnode,
    c_out [G] int32, pstart, pend [G] bool, par_idx, par_shift [G, P]
    int32, with every shift >= 0 as `linearize_graph` makes them), reads
    [B, Lr] int32 (padded, Lr >= 1), read_len [B] int32, all on one device;
    H = band half-width; n_nodes = rows of the end-column buffer.

    Returns (score [B] int32, traversed [B, n_nodes] bool, in_band [B]
    bool). A score of >= INF means no in-band alignment.

    CPU tensors run `wfa_forward_backward_plain`; CUDA tensors launch the
    kernel (one warp per read row) or raise.
    """
    if reads.device.type == "cpu":
        return wfa_forward_backward_plain(
            pchar, pnode, pstart, pend, c_out, par_idx, par_shift, reads,
            read_len, H, n_nodes, last_node, c_end)
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
    if not 0 <= H <= KERNEL_MAX_H:
        raise ValueError(f"wfa_forward_backward keeps a band row in one "
                         f"warp ({32 * KERNEL_CELLS_PER_LANE[-1]} cells at "
                         f"most): H={H} is outside [0, {KERNEL_MAX_H}]")
    if G < 1 or Lr < 1 or P < 1 or not 0 <= last_node < n_nodes:
        raise ValueError(f"need G, Lr, P >= 1 and 0 <= last_node < n_nodes "
                         f"(G={G}, Lr={Lr}, P={P}, last_node={last_node}, "
                         f"n_nodes={n_nodes})")
    Wb = 2 * H + 1
    cells = next(c for c in KERNEL_CELLS_PER_LANE if 32 * c >= Wb)
    score = torch.empty(B, dtype=torch.int32, device=dev)
    trav = torch.empty((B, n_nodes), dtype=torch.bool, device=dev)
    in_band = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return score, trav, in_band
    # the forward columns the backward pass reads (lane-major, 32·C cells
    # each), and the per-node end columns and their marks
    need = 8 * G * B * 32 * cells + 5 * B * n_nodes * Wb
    free, _total = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    if need > free:
        raise MemoryError(f"wfa_forward_backward needs {need} bytes of "
                          f"scratch for (G, B, Wb) = ({G}, {B}, {Wb}); "
                          f"{free} are free on {dev}")
    cols_in = torch.empty((G, B, 32 * cells), dtype=torch.int32, device=dev)
    cols_out = torch.empty((G, B, 32 * cells), dtype=torch.int32, device=dev)
    endcols = torch.empty((B, n_nodes, Wb), dtype=torch.int32, device=dev)
    mark_end = torch.empty((B, n_nodes, Wb), dtype=torch.bool, device=dev)
    kernels.WFA_FORWARD_BACKWARD.launch(
        pchar.data_ptr(), pnode.data_ptr(), pstart.data_ptr(),
        pend.data_ptr(), c_out.data_ptr(), par_idx.data_ptr(),
        par_shift.data_ptr(), reads.data_ptr(), read_len.data_ptr(),
        G, P, B, Lr, H, n_nodes, int(last_node), int(c_end), cells,
        cols_in.data_ptr(), cols_out.data_ptr(), endcols.data_ptr(),
        mark_end.data_ptr(), score.data_ptr(), trav.data_ptr(),
        in_band.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    return score, trav, in_band


def wfa_forward_backward_plain(pchar, pnode, pstart, pend, c_out, par_idx,
                               par_shift, reads, read_len, H: int,
                               n_nodes: int, last_node: int, c_end: int):
    """Plain PyTorch `wfa_forward_backward` (the JAX scan, step for step):
    a Python loop over the G positions, forward and then backward, with
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

    ``band_calls`` counts calls of `wfa_forward_backward` (kernel launches
    when the device is a CUDA device); ``h2d_copies`` counts host→device
    copies (none on the CPU). Both are kept apart from the beam solver's
    counters."""

    reads: int = 0                  # reads submitted to the ladder
    certified: dict = field(default_factory=dict)   # H → reads certified
    uncertified: int = 0            # left to the host aligner
    band_calls: int = 0
    h2d_copies: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def add(self, reads: int, certified: dict, uncertified: int,
            band_calls: int, h2d_copies: int) -> None:
        with self._lock:
            self.reads += reads
            for h, n in certified.items():
                self.certified[h] = self.certified.get(h, 0) + n
            self.uncertified += uncertified
            self.band_calls += band_calls
            self.h2d_copies += h2d_copies

    def as_dict(self) -> dict:
        with self._lock:
            return {"reads": self.reads,
                    "certified": {str(h): n for h, n in
                                  sorted(self.certified.items())},
                    "uncertified": self.uncertified,
                    "band_calls": self.band_calls,
                    "h2d_copies": self.h2d_copies}


def _own_stream(device: torch.device):
    """A stream from torch's pool for one ladder on a CUDA device, so that
    prepare threads aligning at the same time do not serialise on one
    stream; the CPU needs none."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


def _to_device(graph_arrays, device: torch.device) -> list[torch.Tensor]:
    """The seven padded graph arrays on ``device`` in one host→device copy
    of one int32 buffer; the two flag arrays become bool there."""
    flat = np.concatenate([a.astype(np.int32).ravel() for a in graph_arrays])
    flat_d = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for a in graph_arrays:
        t = flat_d[at:at + a.size].view(a.shape)
        out.append(t.bool() if a.dtype == bool else t)
        at += a.size
    return out


def align_reads_device(graph, reads: list[bytes], device: torch.device,
                       h_ladder=H_LADDER,
                       counters: WfaCounters | None = None):
    """Align a batch of reads against ONE graph on ``device``.

    Returns a list parallel to ``reads``: (score, traversed_nodes) for
    reads whose banded result is certified exact (score + spread <= H), or
    None for reads the ladder could not certify — the caller falls back to
    the host aligner for those. Scores above graph.max_edit_distance are
    returned as-is; the caller applies the reference's max-ED failure
    semantics.
    """
    ga = linearize_graph(graph)
    *graph_arrays, N = _padded_arrays(ga)
    on_card = device.type != "cpu"
    results: list = [None] * len(reads)
    pending = list(range(len(reads)))
    certified: dict[int, int] = {}
    calls = copies = 0
    with _own_stream(device):
        dev_graph = _to_device(graph_arrays, device)
        copies += on_card
        for H in h_ladder:
            if not pending:
                break
            Lr = _pad_up(max(len(reads[i]) for i in pending), 256)
            # one copy: read lengths [B], then the padded reads [B, Lr]
            flat = np.zeros(len(pending) * (Lr + 1), np.int32)
            rl = flat[:len(pending)]
            arr = flat[len(pending):].reshape(len(pending), Lr)
            for bi, ri in enumerate(pending):
                r = reads[ri]
                arr[bi, :len(r)] = np.frombuffer(bytes(r), np.uint8)
                rl[bi] = len(r)
            flat_d = torch.from_numpy(flat).to(device)
            copies += on_card
            score, trav, _in_band = wfa_forward_backward(
                *dev_graph, flat_d[len(pending):].view(len(pending), Lr),
                flat_d[:len(pending)], H=H, n_nodes=N,
                last_node=ga.last_node, c_end=ga.c_end)
            calls += 1
            score = score.cpu().numpy()
            trav = trav.cpu().numpy()
            nxt = []
            for bi, ri in enumerate(pending):
                s = int(score[bi])
                if s < INF and s + ga.spread <= H:
                    results[ri] = (s, [int(x)
                                       for x in np.flatnonzero(trav[bi])])
                    certified[H] = certified.get(H, 0) + 1
                else:
                    nxt.append(ri)
            pending = nxt
    if counters is not None:
        counters.add(reads=len(reads), certified=certified,
                     uncertified=len(pending), band_calls=calls,
                     h2d_copies=copies)
    return results
