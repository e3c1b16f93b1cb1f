"""Smoke test of the torch port on one CUDA card: python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
In order, any failure ending the run with a non-zero exit and no ``ok``
line:

  1. the card (nvidia-smi name and power limit), torch / CUDA versions, and
     the native host library, which must load: the committed
     native/libhiphase_native.so, or else the port's own build of
     hiphase_tpu_torch/csrc/hiphase_native.cc (built here at first use),
     with its BGZF codec and its build seconds; the compiler's output when
     it does not;
  2. build every kernel from hiphase_tpu_torch/csrc with nvcc (sm_90a);
  3. hold each beam kernel against its plain PyTorch version on the card,
     with exact integer equality, on seeded inputs: one full tile at
     (B, R, W) = (64, 128, 1024), W = 64 and W = 2560, the (16, 512)
     and (8, 1024) slot buckets, and the wide beams (16, 512, 5056)
     (--phase-min-queue-size 5000, padded), (8, 1024, 8192) and
     (4, 128, 32768), the int16 trace's cap; median device times of both
     (CUDA events), beside `torch.topk` of the W + 1 smallest of the 4W
     candidate keys (`selection_library_ms`, a yardstick for the selection
     alone). At the first shape, the host's time to enqueue one tile
     through the checked public wrappers and through the chain;
  3b. hold the graph-WFA kernel against its plain version, exactly, at
     H = 32, 128 and 512, on one ragged batch in one launch: seeded graphs of different lengths
     and parent counts (SNV, insertion and deletion (eps) nodes, two- and
     three-parent joins), each with a reference, a mutated, an empty and
     an out-of-band read, and one realistic window (an 8 kb read of the
     golden dataset over its window graph), timed. Then time the window
     alone (a batch of one, as one read per launch was timed before) and a
     batch of WFA_BATCH copies of it; every time beside its bound;
  3c. hold both branches of the backtrace kernel (the streamed walk and the
     direct chain) against the plain version, exactly, on seeded synthetic
     traces at the main path's launch shapes (BACKTRACE_SHAPES) and along
     BACKTRACE_SWEEP, which places the plan's crossover; cold times of
     both branches beside the bound (one path's bytes), the stream floor
     (the whole trace's bytes over the memory rate), the floor of what the
     streamed walk reads (the parents) and the plain version's time;
  4. the golden end-to-end dataset (tests/test_e2e_golden.py's settings,
     dual mode) through ``hiphase_tpu_torch.cli.main(... --engine cuda)``:
     its sha256 must be the committed one;
  5. the local-mode benchmark configuration (BENCH_MB Mb, 30x, 15 kb
     reads, --disable-global-realignment, default widths) with --engine
     cuda, record-identical to --engine native, two host→device copies per
     batch, every beam kernel launched; the walls and stage seconds of
     both;
  5b. the golden dataset in local mode at --phase-min-queue-size 5000
     (beam width 5056) with --engine cuda, record-identical to --engine
     native, every beam kernel launched;
  5c. phaser.solve_block(solver="beam" and "beam-full") over the first
     SOLVE_BLOCKS multi-variant blocks of the golden dataset on the card
     (widths 256 and 1000, unpadded, one block a batch), each result equal
     to the same call on the CPU, every beam kernel launched (each block's
     host half, prepare_block, runs once for its four calls);
  6. the golden dataset again with --engine cuda --wfa-engine device: the
     same committed sha256, every kernel launched, reads certified on the
     device at H = 512;
  7. bench_e2e.py --global's dual-mode configuration (30x, 15 kb reads,
     1 % errors, seed 0) with --wfa-engine device, record-identical to
     --wfa-engine host on the same data, every kernel launched, a few WFA
     launches per block (far fewer than reads). The genome is cut to
     DUAL_MB so that the whole script stays well inside its time limit,
     and the cut is printed;
  8. step 6's configuration over several devices,
     ``cli.main(argv, device=devs)``: every CUDA device when there are
     several, else [cuda:0, cuda:0] (two row chunks of each batch on the one
     card). The committed sha256, two host→device copies a chunk
     (``transfers_per_batch`` 2·N), and N times step 6's beam_select and
     backtrace launches (when N divides every bucket's batch);
  9. step 6's configuration as a two-rank multi-host run: two processes
     of a small script (MULTIHOST_RANK_SCRIPT) join a gloo group through a
     ``file://`` store in the work directory and run ``cli.main`` on
     cuda:0, each under a timeout. Rank 0's outputs must give the committed
     sha256, rank 1 must write no output file, both ranks must launch
     beam_select (each solves its share of the blocks), and neither may
     load a module of JAX or of the JAX package;
  10. --engine auto on cuda:0, which starts on the native beam and rates
     the device engine on a thread, each run with a rate cache of its own
     in the work directory (never the user's). Every run prints its
     rates (the device engine's and the native beam's, hets/s), verdict,
     blocks on each engine, upgrade (the first block on the device and its
     second) and whether the rates came from the cache; no block may go
     to the device after a native verdict, nor to native once a cuda
     verdict was in. A run that ends before its rating is printed as
     such. 10a: the golden dataset with an empty cache, the committed
     sha256; then the same rating alone, its rates beside the run's.
     10b: the golden dataset against 10a's cache (the quiet rating's when
     10a ended first): a hit, the same rates, and with a cuda verdict the
     device from the first block; the committed sha256. 10c: step 5's
     dataset with an empty cache, record-identical to step 5, its wall
     beside step 5's. 10d: the golden dataset in a new process whose
     build directory is empty, as on a fresh checkout (the host library
     and the kernels build in the run); the committed sha256.
Steps 1-7 and 10 run on cuda:0 alone. Steps 6 and 7 print the device-WFA run's
wall time, its WFA launches and the pairs each launch carried. Step 7 then
runs the device-WFA configuration once more under torch.profiler and
prints its device time by kernel and the device's busy share (the profiler
slows the host, so the walls are those of the run before).

The line before the last lists every kernel with its launches on the main
path, its error against its plain version, its time, its plain version's
time and its bound (`bound`); the last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# (B, R, W) of step 3; the first is the main path's production shape
KERNEL_SHAPES = ((64, 128, 1024), (64, 128, 64), (64, 128, 2560),
                 (16, 512, 1024), (8, 1024, 1024), (16, 512, 5056),
                 (8, 1024, 8192), (4, 128, 32768))
TILE = 128
TIMING_REPS = 20
# step 5b's queue size: a beam width of 5056, past the 4096 that one CTA's
# shared memory held before beam_select ran as a cluster
WIDE_QUEUE = 5000
# step 5's genome size: bench.py's 30 Mb
BENCH_MB = 30
# step 7's genome size (bench.py's dual-mode runs use the same 30 Mb)
DUAL_MB = 1
# step 3b: the band ladder, the seeded graph cases (odd seeds close their
# SNV bubbles with three parents) and the size of the timed batch
WFA_H = (32, 128, 512)
WFA_GRAPH_SEEDS = (0, 1, 2, 3)
WFA_BATCH = 256
BEAM_KERNELS = ("beam_select", "permute_update", "backtrace")
# step 3c's backtrace launches (B, W, V): one 128-column tile, the dual 1 Mb
# and the local bench's widest batches (blocks are cut at 1 Mb, 1250 hets)
# at every slot bucket, the wide beams; then the sweep that places the
# crossover in kernels.backtrace_plan. BACKTRACE_MAIN is the kernel line's
# shape (the local bench's widest batch).
BACKTRACE_SHAPES = ((64, 1024, 128), (64, 1024, 384), (64, 1024, 1280),
                    (16, 1024, 1280), (8, 1024, 1280), (16, 5056, 384),
                    (8, 8192, 384), (4, 32768, 384))
BACKTRACE_SWEEP = tuple((B, W, 384) for B in (64, 8)
                        for W in (2048, 4096, 8192, 16384, 32768))
BACKTRACE_MAIN = (64, 1024, 1280)
# rewritten before each timed backtrace launch: 2.5x the H100's 50 MB L2
L2_FLUSH_BYTES = 128 << 20
# step 5c: multi-variant blocks of the golden dataset through
# phaser.solve_block on the card and on the CPU
SOLVE_BLOCKS = 20
# step 9: ranks of the multi-host run, and the seconds each may take
MULTIHOST_RANKS = 2
MULTIHOST_TIMEOUT_S = 600
# step 9's rank script, run as ``python -c MULTIHOST_RANK_SCRIPT repo rank
# store argv-json``: one rank of a multi-host run of the CLI on cuda:0;
# prints its LAST_RUN_STATS and the modules of JAX or the JAX package it
# loaded
MULTIHOST_RANK_SCRIPT = r"""
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
import torch
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.parallel import multihost
rank, store = int(sys.argv[2]), sys.argv[3]
multihost.initialize("file://" + store, %d, rank,
                     timeout=datetime.timedelta(seconds=%d))
argv = [a.format(rank=rank) for a in json.loads(sys.argv[4])]
cli.main(argv, device=torch.device("cuda", 0))
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "hiphase_tpu"))
print("RANK " + json.dumps({"rank": rank, "stats": cli.LAST_RUN_STATS,
                            "foreign": foreign}), flush=True)
torch.distributed.destroy_process_group()
""" % (MULTIHOST_RANKS, MULTIHOST_TIMEOUT_S)

# step 10d: --engine auto as a fresh checkout runs it, in a new process
# whose build directory (host library and kernels) is empty: run as
# ``python -c FRESH_AUTO_SCRIPT repo build-dir argv-json rate-cache``;
# prints the wall of cli.main, its LAST_RUN_STATS and what the host
# library's load did
FRESH_AUTO_TIMEOUT_S = 300
FRESH_AUTO_SCRIPT = r"""
import json, pathlib, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from hiphase_tpu_torch.kernels import build
build.BUILD_DIR = pathlib.Path(sys.argv[2])
from hiphase_tpu_torch import cli
from hiphase_tpu_torch.io import native
t0 = time.perf_counter()
cli.main(json.loads(sys.argv[3]), device=torch.device("cuda", 0),
         rate_cache=sys.argv[4])
print("FRESH " + json.dumps({"wall": time.perf_counter() - t0,
                             "stats": cli.LAST_RUN_STATS,
                             "host_library": native.LOADED}), flush=True)
"""

# The least time the card could take for a kernel's work (`bound`): the
# larger of its bytes over the memory rate and its int32 operations over
# the int32 rate. H100 SXM: 3.35 TB/s (NVIDIA's data sheet); 132 SMs of 64
# int32 lanes (the Hopper white paper) at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per band cell of the WFA, counted from
# wfa_forward_backward_plain: forward 14 (diagonal 3, deletion 1, min 2,
# closure 4, read-range mask 4), backward 16 (mark and mask 3, chain_left
# 6, diagonal test 4, deletion test 3)
WFA_OPS_PER_CELL = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_summary(build_log: str) -> str:
    """Registers, spills and barriers of each compiled kernel in nvcc's
    ``-Xptxas -v`` output, a template's arguments beside its name."""
    import re
    out, entry = [], ""
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?(\w+)", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            entry = f"<{','.join(args)}>" if args else ""
        elif "registers" in line or "spill" in line:
            out.append(f"{entry} {line.split(':', 1)[-1].strip()}".strip())
    return " | ".join(out)


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms and bound_by of work that moves ``nbytes`` (each input read
    once, each output written once) and does ``ops`` int32 operations."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def beam_bounds(B: int, R: int, W: int, T: int) -> dict:
    """Bounds of one launch of each beam kernel at (B, R, W), T columns:
    beam_select reads δ [B, W, R] and two packed columns, rewrites cost,
    hets and valid, writes one trace row and the gather's scratch; it
    scores 4W candidates a row from three clamped sums over δ (8 operations
    an element) and selects W of them (8 a candidate). permute_update
    reads δ and writes the new δ, 3 operations an element. backtrace
    follows one path a row: T parent and choice entries and skip flags
    read, two haplotype bytes written a column, 8 operations a step."""
    return {
        "beam_select": bound(
            4 * B * W * R + 2 * 9 * B * W + 8 * B * R + B
            + 3 * B * W + 8 * B + 4 * B * W + 8 * B * R,
            8 * B * W * R + 8 * 4 * B * W),
        "permute_update": bound(8 * B * W * R + 6 * B * W + 8 * B * R,
                                3 * B * W * R),
        "backtrace": bound(3 * B * T + B * T + 8 * B + 2 * B * T, 8 * B * T),
    }


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# step 3: kernels against their plain versions

def make_inputs(B, R, T, seed, device):
    """Seeded packed inputs [B, R, T+1] and skip [B, T] on ``device``."""
    import numpy as np
    import torch

    from hiphase_tpu_torch.phasing.beam import PACK_PAD, pack_inputs
    rng = np.random.default_rng(seed)
    alleles = rng.choice(4, size=(B, R, T), p=[0.45, 0.45, 0.04, 0.06])
    quals = rng.integers(10, 80, size=(B, R, T)).astype(np.int32)
    quals[alleles >= 2] = 0
    resets = rng.random((B, R, T)) < 0.03
    skip = rng.random((B, T)) < 0.05
    packed = np.pad(pack_inputs(alleles, quals, resets),
                    ((0, 0), (0, 0), (0, 1)), constant_values=PACK_PAD)
    return (torch.from_numpy(packed).to(device),
            torch.from_numpy(skip).to(device))


def median_ms(fn, reps=TIMING_REPS, flush=None) -> float:
    """Median device time of one call of ``fn``, in ms. Every timed call
    and its events are queued behind a GPU sleep longer than the host
    needs to enqueue them, so the events measure the device's work and not
    the host's launch overhead (which the end-to-end run sees separately).
    With ``flush``, flush() runs before each call, outside its events."""
    import torch

    def rep():
        if flush is not None:
            flush()
        fn()
    for _ in range(3):
        rep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    torch.cuda._sleep(int(4e9 * host_s * reps) + 10_000_000)  # ≥ 2x at 2 GHz
    for start, end in zip(starts, ends):
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
    ends[-1].synchronize()
    times = sorted(a.elapsed_time(b) for a, b in zip(starts, ends))
    return times[reps // 2]


def max_abs_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} != "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.long() - w.long()).abs().max().item()))
    return err


def selection_keys(state, packed, skip, col):
    """The [B, 4W] int64 candidate keys that beam_select_plain sorts at
    column ``col`` of ``state`` (left unchanged)."""
    from unittest import mock

    import torch

    from hiphase_tpu_torch.phasing import beam
    st = tuple(t.clone() for t in state)
    B, W, R = st[0].shape
    V = skip.shape[1]
    dev = st[0].device
    traces = (torch.empty((V, B, W), dtype=torch.int16, device=dev),
              torch.empty((V, B, W), dtype=torch.int8, device=dev),
              torch.empty((V, B), dtype=torch.int32, device=dev),
              torch.empty((V, B), dtype=torch.int32, device=dev))
    scratch = (torch.empty((B, W), dtype=torch.int32, device=dev),
               torch.empty((B, R), dtype=torch.int32, device=dev),
               torch.empty((B, R), dtype=torch.int32, device=dev))
    with mock.patch.object(torch, "sort", wraps=torch.sort) as sort:
        beam.beam_select_plain(*st, packed, skip, col, traces, scratch)
    return sort.call_args.args[0]


def enqueue_us(fn) -> float:
    """Host µs to enqueue ``fn``'s launches, queued behind a GPU sleep so
    that no launch waits for the device."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)   # about 0.1 s at 2 GHz
    t0 = time.perf_counter()
    fn()
    us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    return us


def check_kernels(device) -> dict:
    """Every kernel against its plain version at every shape; returns, per
    kernel, the largest error and the times at the production shape."""
    import torch

    from hiphase_tpu_torch import kernels
    from hiphase_tpu_torch.phasing import beam

    def clone(ts):
        return tuple(t.clone() for t in ts)

    def plain_chain(state, packed, skip, W):
        delta, cost, hets, valid = clone(state)
        B, _, R = delta.shape
        V = skip.shape[1]
        traces = (torch.empty((V, B, W), dtype=torch.int16, device=device),
                  torch.empty((V, B, W), dtype=torch.int8, device=device),
                  torch.empty((V, B), dtype=torch.int32, device=device),
                  torch.empty((V, B), dtype=torch.int32, device=device))
        scratch = (torch.empty((B, W), dtype=torch.int32, device=device),
                   torch.empty((B, R), dtype=torch.int32, device=device),
                   torch.empty((B, R), dtype=torch.int32, device=device))
        for col in range(V):
            beam.beam_select_plain(delta, cost, hets, valid, packed, skip,
                                   col, traces, scratch)
            delta = beam.permute_update_plain(
                delta, traces[0][col], *scratch, out=torch.empty_like(delta))
        return (delta, cost, hets, valid), traces

    results = {name: {"max_abs_err": 0} for name in kernels.KERNELS}
    for i, (B, R, W) in enumerate(KERNEL_SHAPES):
        T = TILE
        packed, skip = make_inputs(B, R, T, seed=100 + i, device=device)
        fresh = beam.beam_init_device(B, R, W, device)
        # whole tile: kernels vs plain, from the same fresh state
        k_state, k_tr = beam.tiles_forward_packed(clone(fresh), packed, skip,
                                                  W, T)
        p_state, p_tr = plain_chain(fresh, packed, skip, W)
        chain_err = max_abs_err(k_state + k_tr, p_state + p_tr)

        # beam_select alone at the state before the tile's last column
        pre, _ = plain_chain(fresh, packed[:, :, :T], skip[:, :T - 1], W)
        col = T - 1
        traces = tuple(t.clone() for t in p_tr)
        scratch = (torch.empty((B, W), dtype=torch.int32, device=device),
                   torch.empty((B, R), dtype=torch.int32, device=device),
                   torch.empty((B, R), dtype=torch.int32, device=device))
        k_in, p_in = clone(pre), clone(pre)
        k_out, p_out = clone(traces), clone(traces)
        k_scr, p_scr = clone(scratch), clone(scratch)
        beam.beam_select(*k_in, packed, skip, col, k_out, k_scr)
        beam.beam_select_plain(*p_in, packed, skip, col, p_out, p_scr)
        sel_err = max_abs_err(k_in[1:] + k_out + k_scr,
                              p_in[1:] + p_out + p_scr)

        # permute_update alone on beam_select's outputs
        idx = p_out[0][col]
        k_perm = beam.permute_update(pre[0], idx, *p_scr,
                                     out=torch.empty_like(pre[0]))
        p_perm = beam.permute_update_plain(pre[0], idx, *p_scr,
                                           out=torch.empty_like(pre[0]))
        perm_err = max_abs_err((k_perm,), (p_perm,))

        # backtrace over the tile's trace
        slot = torch.zeros(B, dtype=torch.int32, device=device)
        bt_err = max_abs_err(
            beam.backtrace_tile(slot, p_tr[0], p_tr[1], skip),
            beam.backtrace_plain(slot, p_tr[0], p_tr[1], skip))
        torch.cuda.synchronize()

        errs = {"beam_select": max(sel_err, chain_err),
                "permute_update": max(perm_err, chain_err),
                "backtrace": bt_err}
        line = {"B": B, "R": R, "W": W, "T": T, "chain_err": chain_err,
                **{f"{k}_err": v for k, v in errs.items()}}
        for name, err in errs.items():
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                               err)

        def sel(fn):
            s_in, s_out, s_scr = clone(pre), clone(traces), clone(scratch)
            return lambda: fn(*s_in, packed, skip, col, s_out, s_scr)

        out = torch.empty_like(pre[0])
        timings = {
            "beam_select": (sel(beam.beam_select),
                            sel(beam.beam_select_plain)),
            "permute_update": (
                lambda: beam.permute_update(pre[0], idx, *p_scr, out=out),
                lambda: beam.permute_update_plain(pre[0], idx, *p_scr,
                                                  out=out)),
        }
        counts = kernels.launch_counts()
        bounds = beam_bounds(B, R, W, T)
        for name, (kfn, pfn) in timings.items():
            ms, plain_ms = median_ms(kfn), median_ms(pfn)
            line[f"{name}_ms"] = ms
            line[f"{name}_plain_ms"] = plain_ms
            line[f"{name}_bound_ms"] = bounds[name]["bound_ms"]
            if i == 0:
                # no single PyTorch call computes any of these functions
                results[name].update(ms=ms, plain_ms=plain_ms,
                                     **bounds[name], library_ms=None)
        if kernels.launch_counts() == counts:
            raise AssertionError("timing launched no kernel")
        keys = selection_keys(pre, packed, skip, col)
        line["selection_library_ms"] = median_ms(
            lambda: torch.topk(keys, W + 1, dim=-1, largest=False,
                               sorted=True))
        plan = kernels.beam_select_plan(B, W, R)
        line["beam_select_cluster"] = plan.cluster
        line["beam_select_threads"] = plan.threads
        if i == 0:
            line["tile_enqueue_us"] = tile_enqueue_us(fresh, packed, skip, W)
        log("kernel check " + json.dumps(line))
        if any(errs.values()) or chain_err:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at (B, R, W) = ({B}, {R}, {W}): {errs}")
    return results


def random_trace(B: int, V: int, W: int, seed: int, device):
    """A seeded synthetic trace on ``device``, as beam_select leaves one:
    parents uniform in [0, W), choices in [0, 4), ~10 % skipped columns;
    the walk starts from slot 0."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return (torch.zeros(B, dtype=torch.int32, device=device),
            torch.randint(0, W, (V, B, W), generator=g, device=device,
                          dtype=torch.int16),
            torch.randint(0, 4, (V, B, W), generator=g, device=device,
                          dtype=torch.int8),
            torch.rand((B, V), generator=g, device=device) < 0.1)


def check_backtrace(device) -> dict:
    """Both branches of the backtrace kernel (the streamed walk and the
    direct chain, the kernel's first design) against the plain version,
    exactly, on seeded synthetic traces at the main path's launch shapes
    and along the crossover sweep; median times of both branches beside
    the bound (the bytes of one path a row), the stream floor (the whole
    trace's bytes over the memory rate), the floor of what the streamed
    walk reads and, at the main path's shapes, the plain version's time.
    The kernel's times are cold, as on the main path, where the column
    chain's δ traffic has evicted the trace from L2 by the time the
    backtrace runs: L2_FLUSH_BYTES are rewritten before each launch.
    Returns the kernel line's entry, at BACKTRACE_MAIN."""
    import dataclasses

    import torch

    from hiphase_tpu_torch import kernels
    from hiphase_tpu_torch.phasing import beam
    l2 = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)

    def flush():
        l2.add_(1)
    entry = {}
    shapes = [(s, True) for s in BACKTRACE_SHAPES] + [
        (s, False) for s in BACKTRACE_SWEEP if s not in BACKTRACE_SHAPES]
    err = 0
    for i, ((B, W, V), main_path) in enumerate(shapes):
        trace = random_trace(B, V, W, seed=200 + i, device=device)
        want = beam.backtrace_plain(*trace)
        plan = kernels.backtrace_plan(B, W, V)
        line = {"B": B, "W": W, "V": V, "plan_branch": plan.branch,
                "stages": plan.stages, "cols": plan.cols, "smem": plan.smem}
        for branch in ("stream", "direct"):
            forced = dataclasses.replace(plan, branch=branch)
            got = beam._backtrace_launch(forced, *trace)
            torch.cuda.synchronize()
            e = max_abs_err(got, want)
            err = max(err, e)
            line[f"{branch}_err"] = e
            line[f"{branch}_ms"] = median_ms(
                lambda: beam._backtrace_launch(forced, *trace), flush=flush)
        bd = beam_bounds(B, 0, W, V)["backtrace"]
        # the whole trace, and what the streamed walk reads of it (the
        # parents, one choice a column and the skip flags; h1 / h2 written)
        line.update(bd, stream_floor_ms=3 * B * V * W / HBM_BYTES_PER_S * 1e3,
                    parents_floor_ms=(2 * B * V * W + 4 * B * V)
                    / HBM_BYTES_PER_S * 1e3)
        if main_path:
            line["plain_ms"] = median_ms(lambda: beam.backtrace_plain(*trace),
                                         reps=3)
        if (B, W, V) == BACKTRACE_MAIN:
            entry = {"ms": line[f"{plan.branch}_ms"],
                     "plain_ms": line["plain_ms"], **bd, "library_ms": None}
        log("backtrace " + json.dumps(line))
        del trace, want
    del l2
    torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"backtrace disagrees with its plain version: "
                             f"max error {err}")
    return {"max_abs_err": err, **entry}


def tile_enqueue_us(fresh, packed, skip, W) -> dict:
    """Host µs to enqueue one tile: through the public wrappers, which
    check their arguments every column (as the chain did before it checked
    once), and through tiles_forward_packed; in turns, the median of each."""
    import torch

    from hiphase_tpu_torch.phasing import beam
    B, _, R = fresh[0].shape
    T = skip.shape[1]
    dev = fresh[0].device

    def checked():
        delta, cost, hets, valid = (t.clone() for t in fresh)
        spare = torch.empty_like(delta)
        traces = (torch.empty((T, B, W), dtype=torch.int16, device=dev),
                  torch.empty((T, B, W), dtype=torch.int8, device=dev),
                  torch.empty((T, B), dtype=torch.int32, device=dev),
                  torch.empty((T, B), dtype=torch.int32, device=dev))
        scratch = (torch.empty((B, W), dtype=torch.int32, device=dev),
                   torch.empty((B, R), dtype=torch.int32, device=dev),
                   torch.empty((B, R), dtype=torch.int32, device=dev))

        def run():
            for col in range(T):
                beam.beam_select(delta, cost, hets, valid, packed, skip, col,
                                 traces, scratch)
                beam.permute_update(delta, traces[0][col], *scratch,
                                    out=spare)
        return run

    def chain():
        state = tuple(t.clone() for t in fresh)
        return lambda: beam.tiles_forward_packed(state, packed, skip, W, T)

    times = {"checked": [], "chain": []}
    for name in ("checked", "chain", "chain", "checked") * 2:
        fn = checked() if name == "checked" else chain()
        times[name].append(enqueue_us(fn))
    return {"columns": T,
            **{k: sorted(v)[len(v) // 2] for k, v in times.items()}}


# ---------------------------------------------------------------------------
# step 3b: the graph-WFA kernel against its plain version

def wfa_graph_case(seed: int, branches: int = 2):
    """A seeded graph of twelve bubbles (SNV, insertion with an empty
    reference branch, deletion with an empty alternate branch), each
    closing in a node with two parents (SNV bubbles with ``branches``
    parents), and four reads: the reference path, a mutated copy, an empty
    read and one whose kstar lies outside the band at every rung."""
    import numpy as np

    from hiphase_tpu_torch.align.wfa_graph import WFAGraph
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def seq(n):
        return rng.choice(acgt, size=n).astype(np.uint8).tobytes()

    graph = WFAGraph(1000)
    prev = [graph.add_node(seq(20), [])]
    ref = bytearray(graph.sequences[0])
    for i in range(12):
        if i % 3 == 0:
            a = seq(1)
            alts = [bytes([x]) for x in b"ACGT" if x != a[0]][:branches - 1]
        elif i % 3 == 1:
            a, alts = b"", [seq(int(rng.integers(1, 6)))]
        else:
            a, alts = seq(int(rng.integers(1, 6))), [b""]
        nodes = [graph.add_node(x, prev) for x in [a, *alts]]
        tail = seq(int(rng.integers(8, 30)))
        prev = [graph.add_node(tail, nodes)]
        ref += a + tail
    mutated = bytearray(ref)
    for j in rng.choice(len(ref), size=8, replace=False):
        mutated[j] = int(rng.choice(acgt))
    return graph, [bytes(ref), bytes(mutated), b"", seq(len(ref) + 700)]


def wfa_inputs(graph, reads, device):
    import numpy as np
    import torch

    from hiphase_tpu_torch.align import wfa_device as wd
    ga = wd.linearize_graph(graph)
    *arrays, n_nodes = wd._padded_arrays(ga)
    Lr = wd._pad_up(max(len(r) for r in reads), 256)
    arr = np.zeros((len(reads), Lr), np.int32)
    for i, r in enumerate(reads):
        arr[i, :len(r)] = np.frombuffer(r, np.uint8)
    rl = np.array([len(r) for r in reads], np.int32)
    tensors = [torch.from_numpy(a).to(device) for a in (*arrays, arr, rl)]
    return ga, tensors, dict(n_nodes=n_nodes, last_node=ga.last_node,
                             c_end=ga.c_end)


def golden_window(meta):
    """The longest read among the first 200 of the golden dataset's first
    phase block, with its window graph as allele assignment builds it."""
    from hiphase_tpu_torch.core.reference_genome import ReferenceGenome
    from hiphase_tpu_torch.io.bam import cached_alignment
    from hiphase_tpu_torch.io.vcf import get_vcf_samples
    from hiphase_tpu_torch.phasing.block_gen import (
        PhaseBlockIterator, filter_out_alignment_record)
    from hiphase_tpu_torch.phasing.phaser import _mark_tr_overlaps, load_variant_calls
    from hiphase_tpu_torch.phasing.global_realign import read_window
    reference = ReferenceGenome.from_fasta(meta["fasta"])
    sample = get_vcf_samples(meta["vcf"])[0]
    blocks = PhaseBlockIterator([meta["vcf"]], [meta["bam"]], sample,
                                min_quality=0, min_mapq=5,
                                min_spanning_reads=1,
                                allow_supplemental_joins=True)
    block = next(b for b in blocks if b.num_variants > 1)
    hets, homs = load_variant_calls(block, [meta["vcf"]], reference, 15,
                                    True)
    _mark_tr_overlaps(hets, homs)
    best = None
    reads = cached_alignment(meta["bam"]).fetch(block.chrom, block.start,
                                                block.end + 1)
    for n, read in enumerate(reads):
        if n >= 200:
            break
        if filter_out_alignment_record(read, 5):
            continue
        window = read_window(block, read, hets, homs, reference, 500)
        if window is not None and (best is None
                                   or len(window[0]) > len(best[0])):
            best = window
    read_align, graph, _node_to_alleles, _first = best
    return graph, read_align


class WfaBatch:
    """(graph, read) pairs packed and uploaded for one launch of the
    batched WFA: one graph stream per pair, as allele assignment builds
    them."""

    def __init__(self, pairs, device):
        import numpy as np
        import torch

        from hiphase_tpu_torch.align import wfa_device as wd
        self.wd = wd
        linear = {}
        for g, _r in pairs:
            if id(g) not in linear:
                linear[id(g)] = wd._linearized(g)
        b = wd.PairBatch([linear[id(g)] for g, _r in pairs],
                         [bytes(r) for _g, r in pairs], list(range(len(pairs))))
        self.batch = b
        self.arrays = b.upload(device)
        self.meta_np = b.meta(np.arange(b.n), [(0, b.n)])
        self.meta = torch.from_numpy(self.meta_np).to(device)
        self.out = dict(n_out=b.n, trav_len=int(b.N.sum()))
        self.scratch = dict(scratch_pos=int(b.G.sum()),
                            scratch_nodes=int(b.N.sum()),
                            max_read_len=int(b.rlen.max()))

    def kernel(self, H):
        return self.wd.wfa_forward_backward_batched(
            *self.arrays, self.meta, H, **self.out, **self.scratch)

    def plain(self, H):
        return self.wd.wfa_forward_backward_batched_plain(
            *self.arrays, self.meta, H, **self.out)

    def bound(self, H) -> dict:
        """Bytes: the position streams (8 a position), parent tables, reads
        and launch offsets in, score, in_band and traversed flags out;
        operations: WFA_OPS_PER_CELL a band cell, G·(2H + 1) cells a pair."""
        b = self.batch
        nbytes = (8 * b.G.sum() + 8 * b.N.sum() * b.P + b.rlen.sum()
                  + 4 * self.meta.numel() + 5 * b.n + b.N.sum())
        return bound(float(nbytes),
                     float(WFA_OPS_PER_CELL * b.G.sum() * (2 * H + 1)))

    def pair(self, result, i):
        """Pair i's (score, in_band, traversed) of a batch result."""
        score, in_band, trav = result
        off, n = int(self.meta_np[i, 11]), int(self.batch.N[i])
        return score[i:i + 1], in_band[i:i + 1], trav[off:off + n]


def check_wfa_kernel(device, window) -> dict:
    """The WFA kernel against its plain version at every rung, on one
    ragged batch, and the batch's time; then times: the
    window alone (a batch of one) and WFA_BATCH copies of it in one launch,
    each beside its bound."""
    import torch

    from hiphase_tpu_torch.align import wfa_device as wd

    pairs, out_of_band = [], []
    for seed in WFA_GRAPH_SEEDS:
        graph, reads = wfa_graph_case(seed, branches=2 + seed % 2)
        out_of_band.append(len(pairs) + 3)
        pairs += [(graph, r) for r in reads]
    pairs.append(window)
    ragged = WfaBatch(pairs, device)
    b = ragged.batch
    log("wfa ragged batch " + json.dumps(
        {"pairs": b.n, "G": b.G.tolist(), "N": b.N.tolist(), "P": b.P,
         "read_len": b.rlen.tolist()}))
    err = 0
    reference = {}
    for H in WFA_H:
        want = ragged.plain(H)
        reference[H] = want
        if any(bool(want[1][i]) for i in out_of_band):
            raise AssertionError("an out-of-band read is in band")
        got = ragged.kernel(H)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        err = max(err, e)
        log("wfa check " + json.dumps(
            {"H": H, "shape": wd.kernel_shape(H), "err": e,
             "score": want[0].tolist(), "in_band": want[1].tolist()}))
        ms = median_ms(lambda: ragged.kernel(H), reps=3)
        bd = ragged.bound(H)
        log("wfa ragged launch " + json.dumps(
            {"H": H, "shape": wd.kernel_shape(H), "ms": ms, **bd,
             "bound_share": bd["bound_ms"] / ms}))

    # the window alone, as one read per launch ran before
    one = WfaBatch([window], device)
    last = b.n - 1
    result = {}
    for H in WFA_H:
        got = one.kernel(H)
        e = max_abs_err(got, ragged.pair(reference[H], last))
        err = max(err, e)
        ms = median_ms(lambda: one.kernel(H), reps=5)
        line = {"H": H, "shape": wd.kernel_shape(H), "G": int(one.batch.G[0]),
                "read_len": int(one.batch.rlen[0]),
                "nodes": int(one.batch.N[0]), "err": e,
                "score": int(got[0][0]), "ms": ms, **one.bound(H)}
        if H == WFA_H[-1]:
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            start.record()
            one.plain(H)
            stop.record()
            stop.synchronize()
            line["plain_ms"] = start.elapsed_time(stop)
            result = {"ms": ms, "plain_ms": line["plain_ms"],
                      **one.bound(H), "library_ms": None}
        log("wfa window " + json.dumps(line))

    # WFA_BATCH copies of the window in one launch
    many = WfaBatch([window] * WFA_BATCH, device)
    for H in WFA_H:
        got = many.kernel(H)
        want = one.kernel(H)
        torch.cuda.synchronize()
        for i in range(WFA_BATCH):
            e = max_abs_err(many.pair(got, i), want)
            err = max(err, e)
        ms = median_ms(lambda: many.kernel(H), reps=3)
        bd = many.bound(H)
        log("wfa batch " + json.dumps(
            {"H": H, "pairs": WFA_BATCH, "shape": wd.kernel_shape(H),
             "ms": ms, "reads_per_s": WFA_BATCH / ms * 1e3, **bd,
             "bound_share": bd["bound_ms"] / ms}))
    del many
    torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"wfa_forward_backward disagrees with its "
                             f"plain version: max error {err}")
    return {"max_abs_err": err, **result}


# ---------------------------------------------------------------------------
# steps 4 to 7: the main paths through the CLI

def run_cli(argv, device=None, rate_cache=None):
    """cli.main on ``device`` (cuda:0 unless given) with ``rate_cache``
    (none unless given: never the user's); returns the wall seconds and
    the run's LAST_RUN_STATS."""
    import torch
    from hiphase_tpu_torch import cli
    t0 = time.perf_counter()
    if device is None:
        device = torch.device("cuda", 0)
    if cli.main(argv, device=device, rate_cache=rate_cache) != 0:
        raise AssertionError(f"cli exited non-zero: {argv}")
    return time.perf_counter() - t0, dict(cli.LAST_RUN_STATS)


def build_golden(workdir: str) -> dict:
    from hiphase_tpu_torch.utils import golden
    from hiphase_tpu_torch.utils.simulate import build_benchmark_dataset
    return build_benchmark_dataset(os.path.join(workdir, "golden"),
                                   **golden.DATASET_KW)


def wfa_summary(secs: float, stats: dict) -> str:
    """The device-WFA run's wall time, WFA launches and pairs a launch."""
    wfa = stats["wfa"]
    return (f"device-WFA run {secs:.2f} s wall; {wfa['reads']} reads in "
            f"{wfa['band_calls']} WFA launches, "
            f"{wfa['pairs_per_launch']:.1f} pairs a launch (max "
            f"{wfa['max_pairs_per_launch']}); certified {wfa['certified']}, "
            f"uncertified {wfa['uncertified']}")


def golden_argv(meta: dict, out: list, wfa_engine: str,
                threads: int, engine: str = "cuda") -> list:
    """The golden dataset's CLI flags with ``engine``, writing the VCF,
    BAM and blocks file ``out``."""
    return ["--bam", meta["bam"], "--vcf", meta["vcf"],
            "--reference", meta["fasta"], "--output-vcf", out[0],
            "--output-bam", out[1], "--blocks-file", out[2],
            "--engine", engine, "--wfa-engine", wfa_engine,
            "--threads", str(threads)]


def golden_outputs(workdir: str, name: str) -> list:
    return [os.path.join(workdir, f"golden.{name}.{x}")
            for x in ("vcf.gz", "bam", "blocks.tsv")]


def check_golden_digest(out: list, what: str) -> None:
    from hiphase_tpu_torch.utils import golden
    digest = golden.digest(golden.normalize(*out))
    want = golden.committed_sha256()
    log(f"golden {what}: sha256 {digest} (committed {want})")
    if digest != want:
        raise AssertionError(f"golden sha256 of {what} differs from the "
                             f"committed one")


def check_golden(workdir: str, meta: dict, wfa_engine: str,
                 threads: int = 1) -> dict:
    """The golden dataset with --engine cuda and the given --wfa-engine;
    with the device WFA, every kernel must launch in the run and some
    reads must certify on the device at H = 512."""
    from hiphase_tpu_torch import kernels
    out = golden_outputs(workdir, wfa_engine)
    kernels.reset_launch_counts()
    secs, stats = run_cli(golden_argv(meta, out, wfa_engine, threads))
    launches = kernels.launch_counts()
    log(f"golden (--wfa-engine {wfa_engine}): {secs:.2f} s, "
        f"{json.dumps(stats)}")
    check_golden_digest(out, f"--wfa-engine {wfa_engine}")
    if wfa_engine == "device":
        log("golden " + wfa_summary(secs, stats))
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the dual-mode "
                                 f"path: {missing}")
        if stats["wfa"]["certified"].get("512", 0) <= 0:
            raise AssertionError("no read certified on the device at "
                                 "H = 512")
    return launches


def check_multi_device(workdir: str, meta: dict, step6: dict) -> dict:
    """Step 8: step 6's configuration over every CUDA device, or over
    [cuda:0, cuda:0] on a one-card machine; the committed sha256, 2·N
    host→device copies a batch, and N times step 6's beam_select and
    backtrace launches where N divides every bucket's batch (the batches
    are then step 6's)."""
    import torch

    from hiphase_tpu_torch import kernels
    from hiphase_tpu_torch.parallel.orchestrator import BUCKET_BATCH
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if n > 1
            else [torch.device("cuda", 0)] * 2)
    out = golden_outputs(workdir, "devices")
    kernels.reset_launch_counts()
    secs, stats = run_cli(golden_argv(meta, out, "device", 4), device=devs)
    launches = kernels.launch_counts()
    log(f"multi-device golden over {len(devs)} row chunks "
        f"({[str(d) for d in devs]}): {secs:.2f} s, {json.dumps(stats)}")
    check_golden_digest(out, f"{len(devs)} row chunks")
    if stats["transfers_per_batch"] != 2 * len(devs):
        raise AssertionError(f"expected {2 * len(devs)} host→device copies "
                             f"a batch, got {stats['transfers_per_batch']}")
    if all(b % len(devs) == 0 for b in BUCKET_BATCH.values()):
        for k in ("beam_select", "backtrace"):
            if launches[k] != len(devs) * step6[k]:
                raise AssertionError(
                    f"{k}: {launches[k]} launches over {len(devs)} chunks, "
                    f"expected {len(devs)} x step 6's {step6[k]}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the multi-device "
                             f"path: {missing}")
    return launches


def check_multihost(workdir: str, meta: dict) -> None:
    """Step 9: step 6's configuration as MULTIHOST_RANKS processes of one
    gloo group on cuda:0. Rank 0's outputs give the committed sha256, the
    other ranks write none, every rank launches beam_select and loads
    nothing of JAX or of the JAX package."""
    store = os.path.join(workdir, "multihost.store")
    out = golden_outputs(workdir, "rank{rank}")
    argv = json.dumps(golden_argv(meta, out, "device", 4))
    # each rank writes to files, never to a pipe that nobody reads while
    # another rank is waited on
    logs = [os.path.join(workdir, f"multihost.rank{r}.{x}")
            for r in range(MULTIHOST_RANKS) for x in ("out", "err")]
    t0 = time.perf_counter()
    procs = []
    try:
        for r in range(MULTIHOST_RANKS):
            with open(logs[2 * r], "w") as so, \
                    open(logs[2 * r + 1], "w") as se:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", MULTIHOST_RANK_SCRIPT, HERE, str(r),
                     store, argv], stdout=so, stderr=se, cwd=workdir))
        deadline = time.monotonic() + MULTIHOST_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = time.perf_counter() - t0
    ranks = []
    for r, p in enumerate(procs):
        with open(logs[2 * r]) as so, open(logs[2 * r + 1]) as se:
            text, err = so.read(), se.read()
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}: "
                                 f"{err[-3000:]}")
        line = next(ln for ln in text.splitlines() if ln.startswith("RANK "))
        ranks.append(json.loads(line[5:]))
    for r in ranks:
        log(f"multi-host rank {r['rank']} of {MULTIHOST_RANKS}: "
            f"{json.dumps(r['stats'])}")
    log(f"multi-host golden, {MULTIHOST_RANKS} ranks on cuda:0: {secs:.2f} s "
        f"wall (process start to last exit)")
    check_golden_digest([p.format(rank=0) for p in out], "multi-host rank 0")
    for r in range(1, MULTIHOST_RANKS):
        wrote = [p for p in out if os.path.exists(p.format(rank=r))]
        if wrote:
            raise AssertionError(f"rank {r} wrote output files: {wrote}")
    for r in ranks:
        if r["foreign"]:
            raise AssertionError(f"rank {r['rank']} loaded {r['foreign']}")
        if r["stats"]["kernel_launches"]["beam_select"] <= 0:
            raise AssertionError(f"rank {r['rank']} launched no beam_select")


def auto_summary(stats: dict) -> dict:
    """What an --engine auto run reports of its choice."""
    return {k: stats.get(k) for k in (
        "engine", "engine_rates", "engine_rating", "engine_blocks",
        "engine_upgrade")}


def auto_verdict(rates: dict) -> str:
    from hiphase_tpu_torch.parallel.engine_select import RATE_MARGIN
    return ("cuda" if rates["cuda"] > RATE_MARGIN * rates["native"]
            else "native")


def check_auto_run(what: str, stats: dict) -> str | None:
    """The checks of every --engine auto run: both rates when the rating
    ended in the run, no block on the device after a native verdict, and
    after a cuda verdict no block on native once the choice had ended.
    Returns the verdict, None when the run ended before the rating."""
    rating = stats.get("engine_rating", {})
    blocks = stats["engine_blocks"]
    log(f"auto {what}: {json.dumps(auto_summary(stats))}")
    if not rating.get("resolved"):
        log(f"auto {what}: the run ended before the rating did; the rating "
            f"was stopped at its end, and the run stayed on native")
        if blocks.get("cuda") or stats["engine"] != "native":
            raise AssertionError(f"auto {what}: blocks on the device "
                                 f"without a verdict: {blocks}")
        return None
    rates = stats["engine_rates"]
    if set(rates) != {"cuda", "native"}:
        raise AssertionError(f"--engine auto rated {sorted(rates)}, "
                             f"expected cuda and native")
    verdict = auto_verdict(rates)
    log(f"auto {what}: rates (hets/s) {json.dumps(rates)}, device / native "
        f"{rates['cuda'] / rates['native']:.3f}; verdict {verdict}, ran "
        f"{stats['engine']}, cached {rating['cached']}")
    if verdict == "native" and blocks.get("cuda"):
        raise AssertionError(f"auto {what}: {blocks['cuda']} block(s) on "
                             f"the device after a native verdict")
    if verdict == "cuda":
        if rating["late_blocks"]:
            raise AssertionError(f"auto {what}: {rating['late_blocks']} "
                                 f"block(s) on native after the choice")
        if stats["engine"] != "cuda":
            log(f"auto {what}: the verdict came after the last block")
    return verdict


def check_auto(workdir: str, meta: dict, step5: dict) -> None:
    """Step 10: --engine auto on cuda:0, each run with its own rate cache
    in the work directory. 10a: the golden dataset, empty cache, then the
    same rating run alone (quiet) beside the run's (overlapped); 10b: the
    golden dataset against 10a's cache (or the quiet rating's, when 10a
    ended before its rating): a hit, the same rates, and with a cuda
    verdict the device from the first block; 10c: step 5's dataset with an
    empty cache, record-identical to step 5; 10d: the golden dataset as a
    fresh checkout would run it, in a new process whose build directory
    is empty."""
    import torch

    from hiphase_tpu_torch.parallel.engine_select import choose_engine
    cuda0 = (torch.device("cuda", 0),)
    caches = {x: os.path.join(workdir, f"rates.{x}.json")
              for x in ("10a", "quiet", "10c", "10d")}
    # 10a
    out = golden_outputs(workdir, "auto")
    secs, stats = run_cli(golden_argv(meta, out, "host", 2, engine="auto"),
                          rate_cache=caches["10a"])
    log(f"auto 10a (golden, empty cache): {secs:.2f} s")
    check_golden_digest(out, "--engine auto (10a)")
    verdict_a = check_auto_run("10a", stats)
    t0 = time.perf_counter()
    quiet = choose_engine("auto", cuda0, 2, rate_cache=caches["quiet"],
                          beam_width=None, batch_size=64,
                          min_queue_size=1000, queue_increment=3)
    log(f"auto quiet rating: {time.perf_counter() - t0:.2f} s, rates "
        f"(hets/s) {json.dumps(quiet.rates)}, verdict {quiet.engine}; "
        f"overlapped (10a) {json.dumps(stats['engine_rates'])}, verdict "
        f"{verdict_a}")
    # 10b
    cache_b = caches["10a"] if verdict_a else caches["quiet"]
    want = stats["engine_rates"] if verdict_a else quiet.rates
    out = golden_outputs(workdir, "auto.cached")
    secs, stats = run_cli(golden_argv(meta, out, "host", 2, engine="auto"),
                          rate_cache=cache_b)
    log(f"auto 10b (golden, the cache of "
        f"{'10a' if verdict_a else 'the quiet rating'}): {secs:.2f} s")
    check_golden_digest(out, "--engine auto (10b)")
    verdict_b = check_auto_run("10b", stats)
    if not verdict_b or not stats["engine_rating"]["cached"]:
        raise AssertionError("auto 10b: no cache hit")
    if stats["engine_rates"] != want:
        raise AssertionError(f"auto 10b: rates {stats['engine_rates']} "
                             f"from the cache, {want} stored")
    if verdict_b == "cuda" and (
            stats["engine_upgrade"] is None
            or stats["engine_upgrade"]["native_blocks_before"] != 0):
        raise AssertionError(f"auto 10b: a cached cuda verdict, upgrade "
                             f"{stats['engine_upgrade']}")
    # 10c
    bench = step5["meta"]
    vcf = os.path.join(workdir, "bench.auto.vcf.gz")
    secs, stats = run_cli(
        ["--bam", bench["bam"], "--vcf", bench["vcf"],
         "--reference", bench["fasta"], "--output-vcf", vcf,
         "--engine", "auto", "--threads", "2",
         "--disable-global-realignment"], rate_cache=caches["10c"])
    check_auto_run("10c", stats)
    up = stats["engine_upgrade"] or {}
    log(f"auto 10c (local {step5['total_mb']} Mb, empty cache): "
        f"{secs:.2f} s wall, step 5's cuda {step5['cuda_seconds']:.2f} s "
        f"and native {step5['native_seconds']:.2f} s; blocks "
        f"{json.dumps(stats['engine_blocks'])}, upgrade at block "
        f"{up.get('block')} after {up.get('seconds')} s")
    if vcf_records(vcf) != vcf_records(
            os.path.join(workdir, "bench.cuda.vcf.gz")):
        raise AssertionError("auto 10c: the VCF differs from step 5's")
    # 10d
    out = golden_outputs(workdir, "auto.fresh")
    build_dir = os.path.join(workdir, "fresh_build")
    proc = subprocess.run(
        [sys.executable, "-c", FRESH_AUTO_SCRIPT, HERE, build_dir,
         json.dumps(golden_argv(meta, out, "host", 2, engine="auto")),
         caches["10d"]], capture_output=True, text=True, cwd=workdir,
        timeout=FRESH_AUTO_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"auto 10d exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("FRESH "))
    fresh = json.loads(line[6:])
    log(f"auto 10d (golden, fresh build directory, empty cache): "
        f"{fresh['wall']:.2f} s wall in cli.main; host library "
        f"{json.dumps(fresh['host_library'])}")
    check_golden_digest(out, "--engine auto (10d)")
    check_auto_run("10d", fresh["stats"])


def vcf_records(path):
    from hiphase_tpu_torch.io.vcf import VcfReader
    return [r.serialize() for r in VcfReader(path)]


def check_local_bench(workdir: str, total_mb: int) -> dict:
    """Step 5: the local bench configuration with --engine cuda against
    --engine native; returns the summary (walls, stage seconds, launches)."""
    from hiphase_tpu_torch.utils.simulate import build_benchmark_dataset
    from hiphase_tpu_torch import kernels
    t0 = time.perf_counter()
    meta = build_benchmark_dataset(
        os.path.join(workdir, "bench"), total_mb=total_mb, coverage=30,
        read_length=15_000, seed=0, het_spacing=800, error_rate=0.01,
        block_kb=250, io_threads=2)
    log(f"local bench dataset: {total_mb} Mb, {meta['n_het']} hets, "
        f"{meta['n_reads']} reads, built in {time.perf_counter() - t0:.1f} s")

    def argv(engine, threads):
        return ["--bam", meta["bam"], "--vcf", meta["vcf"],
                "--reference", meta["fasta"], "--output-vcf",
                os.path.join(workdir, f"bench.{engine}.vcf.gz"),
                "--blocks-file", os.path.join(workdir,
                                              f"bench.{engine}.tsv"),
                "--engine", engine, "--threads", str(threads),
                "--disable-global-realignment"]

    kernels.reset_launch_counts()
    cuda_s, stats = run_cli(argv("cuda", 2))   # bench_e2e.py's --threads 2
    launches = kernels.launch_counts()
    # the reference engine's thread count does not change its output
    host_s, host_stats = run_cli(argv("native", min(os.cpu_count() or 2, 8)))
    same_vcf = (vcf_records(os.path.join(workdir, "bench.cuda.vcf.gz"))
                == vcf_records(os.path.join(workdir, "bench.native.vcf.gz")))
    with open(os.path.join(workdir, "bench.cuda.tsv")) as a, \
            open(os.path.join(workdir, "bench.native.tsv")) as b:
        same_blocks = a.read() == b.read()
    summary = {
        "total_mb": total_mb, "n_het": meta["n_het"],
        "cuda_seconds": cuda_s, "hets_per_sec": meta["n_het"] / cuda_s,
        "native_seconds": host_s,
        "native_hets_per_sec": meta["n_het"] / host_s,
        "device_batches": stats.get("device_batches"),
        "transfers_per_batch": stats.get("transfers_per_batch"),
        "kernel_launches": launches,
        "stage_seconds": stats.get("stage_seconds"),
        "host_stage_seconds": host_stats.get("stage_seconds"),
        "record_identical": same_vcf and same_blocks}
    log("local bench " + json.dumps(summary))
    summary["meta"] = meta
    if not same_vcf or not same_blocks:
        raise AssertionError("--engine cuda output differs from "
                             "--engine native")
    if stats.get("transfers_per_batch") != 2.0:
        raise AssertionError("expected two host→device copies per batch")
    missing = [k for k in BEAM_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return summary


def check_wide_golden(workdir: str, meta: dict) -> dict:
    """Step 5b: the golden dataset in local mode at --phase-min-queue-size
    WIDE_QUEUE with --engine cuda, record-identical to --engine native at
    the same flags; every beam kernel launched."""
    from hiphase_tpu_torch import kernels

    def argv(engine, threads):
        return ["--bam", meta["bam"], "--vcf", meta["vcf"],
                "--reference", meta["fasta"], "--output-vcf",
                os.path.join(workdir, f"wide.{engine}.vcf.gz"),
                "--blocks-file", os.path.join(workdir, f"wide.{engine}.tsv"),
                "--engine", engine, "--threads", str(threads),
                "--disable-global-realignment",
                "--phase-min-queue-size", str(WIDE_QUEUE)]

    kernels.reset_launch_counts()
    cuda_s, stats = run_cli(argv("cuda", 2))
    launches = kernels.launch_counts()
    host_s, _ = run_cli(argv("native", min(os.cpu_count() or 2, 8)))
    same_vcf = (vcf_records(os.path.join(workdir, "wide.cuda.vcf.gz"))
                == vcf_records(os.path.join(workdir, "wide.native.vcf.gz")))
    with open(os.path.join(workdir, "wide.cuda.tsv")) as a, \
            open(os.path.join(workdir, "wide.native.tsv")) as b:
        same_blocks = a.read() == b.read()
    log("wide golden " + json.dumps({
        "phase_min_queue_size": WIDE_QUEUE, "cuda_seconds": cuda_s,
        "native_seconds": host_s,
        "device_batches": stats.get("device_batches"),
        "kernel_launches": launches,
        "record_identical": same_vcf and same_blocks}))
    if not same_vcf or not same_blocks:
        raise AssertionError(f"--engine cuda output differs from --engine "
                             f"native at --phase-min-queue-size "
                             f"{WIDE_QUEUE}")
    missing = [k for k in BEAM_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the wide-beam "
                             f"path: {missing}")
    return launches


def check_solve_block(meta: dict, device) -> dict:
    """Step 5c: phaser.solve_block on the beam at width 256 ("beam") and
    at the default queue size unpadded ("beam-full", W = 1000), on the
    card, over the first SOLVE_BLOCKS multi-variant blocks of the golden
    dataset; each result must equal the same call on the CPU. Every beam
    kernel must launch. A block's prepare_block (its host half, which
    reads and does not depend on the solver or the device) runs
    once and serves the block's four calls."""
    from unittest import mock

    import torch

    from hiphase_tpu_torch import kernels
    from hiphase_tpu_torch.core.reference_genome import ReferenceGenome
    from hiphase_tpu_torch.io.vcf import get_vcf_samples
    from hiphase_tpu_torch.phasing import phaser
    from hiphase_tpu_torch.phasing.block_gen import PhaseBlockIterator
    from hiphase_tpu_torch.utils.compare import plain_values
    reference = ReferenceGenome.from_fasta(meta["fasta"])
    sample = get_vcf_samples(meta["vcf"])[0]
    blocks = []
    for block in PhaseBlockIterator([meta["vcf"]], [meta["bam"]], sample,
                                    min_quality=0, min_mapq=5,
                                    min_spanning_reads=1,
                                    allow_supplemental_joins=True):
        if not block.unphased_block and block.num_variants > 1:
            blocks.append(block)
            if len(blocks) == SOLVE_BLOCKS:
                break
    summary = {"blocks": len(blocks),
               "variants": [b.num_variants for b in blocks]}
    prepared = {}

    def prepare_once(block, *args):
        if block.block_index not in prepared:
            prepared[block.block_index] = prepare(block, *args)
        return prepared[block.block_index]
    prepare = phaser.prepare_block
    cpu = torch.device("cpu")
    launches = {k: 0 for k in kernels.KERNELS}
    with mock.patch.object(phaser, "prepare_block", prepare_once):
        for solver in ("beam", "beam-full"):
            card_s = cpu_s = 0.0
            for block in blocks:
                def solve(dev):
                    return phaser.solve_block(
                        block, [meta["vcf"]], [meta["bam"]], reference,
                        solver=solver, device=dev)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                got = solve(device)
                card_s += time.perf_counter() - t0
                for k, n in kernels.launch_counts().items():
                    launches[k] += n
                t0 = time.perf_counter()
                want = solve(cpu)
                cpu_s += time.perf_counter() - t0
                if plain_values(got) != plain_values(want):
                    raise AssertionError(
                        f"solve_block(solver={solver!r}) on the card differs "
                        f"from the CPU at block {block.block_index}")
            summary[solver] = {"card_seconds": card_s, "cpu_seconds": cpu_s,
                               "identical": True}
    summary["kernel_launches"] = launches
    log("solve_block " + json.dumps(summary))
    missing = [k for k in BEAM_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched by solve_block: "
                             f"{missing}")
    return launches


def check_dual_bench(workdir: str, total_mb: int) -> dict:
    """bench_e2e.py --global's configuration with --wfa-engine device,
    record-identical to --wfa-engine host; every kernel launched, and a few
    WFA launches per block; then the device-WFA run again, traced."""
    from hiphase_tpu_torch.utils.simulate import build_benchmark_dataset
    from hiphase_tpu_torch import kernels
    t0 = time.perf_counter()
    meta = build_benchmark_dataset(
        os.path.join(workdir, "dual"), total_mb=total_mb, coverage=30,
        read_length=15_000, seed=0, het_spacing=800, error_rate=0.01,
        block_kb=250, io_threads=2)
    log(f"dual bench dataset: {total_mb} Mb, {meta['n_het']} hets, "
        f"{meta['n_reads']} reads, built in {time.perf_counter() - t0:.1f} s")

    def argv(wfa, name=None):
        name = name or wfa
        return ["--bam", meta["bam"], "--vcf", meta["vcf"],
                "--reference", meta["fasta"], "--output-vcf",
                os.path.join(workdir, f"dual.{name}.vcf.gz"),
                "--blocks-file", os.path.join(workdir, f"dual.{name}.tsv"),
                "--engine", "cuda", "--threads", "2", "--wfa-engine", wfa]

    kernels.reset_launch_counts()
    dev_s, stats = run_cli(argv("device"))
    launches = kernels.launch_counts()
    log("dual bench " + wfa_summary(dev_s, stats))
    profiled(lambda: run_cli(argv("device", "traced")))
    host_s, host_stats = run_cli(argv("host"))
    same_vcf = (vcf_records(os.path.join(workdir, "dual.device.vcf.gz"))
                == vcf_records(os.path.join(workdir, "dual.host.vcf.gz")))
    with open(os.path.join(workdir, "dual.device.tsv")) as a, \
            open(os.path.join(workdir, "dual.host.tsv")) as b:
        same_blocks = a.read() == b.read()
    summary = {
        "total_mb": total_mb, "n_het": meta["n_het"],
        "n_reads": meta["n_reads"],
        "device_wfa_seconds": dev_s,
        "device_wfa_hets_per_sec": meta["n_het"] / dev_s,
        "host_wfa_seconds": host_s,
        "host_wfa_hets_per_sec": meta["n_het"] / host_s,
        "wfa": stats.get("wfa"), "kernel_launches": launches,
        "stage_seconds": stats.get("stage_seconds"),
        "host_stage_seconds": host_stats.get("stage_seconds"),
        "record_identical": same_vcf and same_blocks}
    log("dual bench " + json.dumps(summary))
    if not same_vcf or not same_blocks:
        raise AssertionError("--wfa-engine device output differs from "
                             "--wfa-engine host")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dual-mode "
                             f"path: {missing}")
    wfa = stats["wfa"]
    if 4 * wfa["band_calls"] > wfa["reads"]:
        raise AssertionError(f"{wfa['band_calls']} WFA launches for "
                             f"{wfa['reads']} reads: expected a few a block")
    return launches


def profiled(fn):
    """fn() under torch.profiler (CPU and CUDA activity); prints the device
    time by kernel name and the union of device intervals against the
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name: dict[str, list] = {}
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    log("profile " + json.dumps({
        "wall_s": wall, "device_busy_s": busy / 1e6,
        "device_busy_share": busy / 1e6 / wall,
        "device_ms_by_name": {n: {"calls": c, "ms": ms}
                              for n, (c, ms) in top}}))
    return result


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "hiphase_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = nvidia_smi()

    # 1. environment; the native host library must load
    from hiphase_tpu_torch.io import native
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if not native.available():
        raise AssertionError(f"the native host library did not load: "
                             f"{native.LOADED.get('error')}")
    lib = native.LOADED
    log(f"native host library: {lib['origin']} "
        f"{os.path.relpath(lib['path'], HERE)}, codec {lib['codec']}, "
        f"built in {lib['build_seconds']:.2f} s (0 when it was not built "
        f"in this run)")

    # 2. build
    from hiphase_tpu_torch import kernels
    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"built {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        log(f"  {name}: {b.library.name}; " + ptxas_summary(b.log))

    # 3. beam kernels against their plain versions; 3c. both branches of
    # the backtrace at the main path's launch shapes
    checks = check_kernels(device)
    bt = check_backtrace(device)
    bt["max_abs_err"] = max(bt["max_abs_err"],
                            checks["backtrace"]["max_abs_err"])
    checks["backtrace"] = bt

    with tempfile.TemporaryDirectory(prefix="hiphase_smoke_") as workdir:
        golden_meta = build_golden(workdir)
        # 3b. the graph-WFA kernel against its plain version
        checks["wfa_forward_backward"] = check_wfa_kernel(
            device, golden_window(golden_meta))
        # 4. golden dataset
        check_golden(workdir, golden_meta, "host")
        # 5. the local-mode benchmark configuration
        step5 = check_local_bench(workdir, BENCH_MB)
        launches = dict(step5["kernel_launches"])
        # 5b. the widths that one CTA's shared memory did not hold
        check_wide_golden(workdir, golden_meta)
        # 5c. the single-block path at unpadded widths
        check_solve_block(golden_meta, device)
        # 6. golden dataset, dual mode on the device WFA; four prepare
        # threads keep several WFA launches in flight (the output does
        # not depend on the thread count)
        step6 = check_golden(workdir, golden_meta, "device", threads=4)
        # 7. the dual-mode benchmark configuration
        log(f"dual bench cut: total_mb 30 -> {DUAL_MB}, to keep the script "
            f"inside its time limit")
        launches["wfa_forward_backward"] = check_dual_bench(
            workdir, DUAL_MB)["wfa_forward_backward"]
        # 8. step 6 over several devices (row chunks); 9. as two ranks
        check_multi_device(workdir, golden_meta, step6)
        check_multihost(workdir, golden_meta)
        # 10. --engine auto: native at once, the device after its rating
        check_auto(workdir, golden_meta, step5)

    table = [{"name": name, "route": "cuda",
              "source": os.path.relpath(k.source, HERE),
              "replaces": k.replaces, "launches": launches[name],
              **checks[name]} for name, k in kernels.KERNELS.items()]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": table}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
