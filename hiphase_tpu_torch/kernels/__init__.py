"""The port's hand-written CUDA kernels: ctypes bindings and launch counts.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point
``hp_<name>(..., int device, void* stream)`` that launches on the given
stream and returns ``cudaGetLastError()``. The source is compiled with
nvcc for sm_90a at first use (see `build`) and loaded with ctypes. A
kernel that does not build, does not load or does not launch raises;
nothing here falls back to another implementation.

``Kernel.launches`` counts the launches made through ``Kernel.launch``,
so a run can show which kernels its main path went through. Launches may
come from several threads (allele assignment launches the WFA kernel from
the prepare threads): the first one builds and binds under a lock, and the
count is kept under a lock.
"""

from __future__ import annotations

import ctypes
import threading
from ctypes import c_int, c_void_p
from dataclasses import dataclass

from hiphase_tpu_torch.kernels import build

# Shared memory one block may use on an H100 (dynamic, after opting in).
MAX_DYNAMIC_SMEM = 232_448 - 1_024   # less the kernels' static shared use


# One build or bind at a time in this process: nvcc writes each library
# through a temporary path named after the process.
_BUILD_LOCK = threading.Lock()


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused or failed."""


class Kernel:
    """One CUDA kernel: its source, its C entry point and its launch count."""

    def __init__(self, name: str, replaces: str, argtypes: list):
        self.name = name
        self.replaces = replaces
        self.source = build.source_path(name)
        self.launches = 0
        self._argtypes = argtypes
        self._fn = None
        self._lib = None
        self._count_lock = threading.Lock()

    def bind(self, library_path) -> None:
        lib = ctypes.CDLL(str(library_path))
        fn = getattr(lib, f"hp_{self.name}")
        fn.argtypes = self._argtypes
        fn.restype = c_int
        lib.hp_error_string.argtypes = [c_int]
        lib.hp_error_string.restype = ctypes.c_char_p
        self._lib, self._fn = lib, fn

    def launch(self, *args) -> None:
        if self._fn is None:
            with _BUILD_LOCK:
                if self._fn is None:
                    self.bind(build.build([self.name])[self.name].library)
        rc = self._fn(*args)
        if rc != 0:
            msg = self._lib.hp_error_string(rc).decode()
            raise KernelLaunchError(f"{self.name}: CUDA error {rc} ({msg})")
        with self._count_lock:
            self.launches += 1


P, I = c_void_p, c_int

BEAM_SELECT = Kernel(
    "beam_select", "hiphase_tpu/phasing/beam.py:105 (_step)",
    [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, I, P, P, P, P, P, P,
     P, I, P])
PERMUTE_UPDATE = Kernel(
    "permute_update", "scripts/pallas_permute.py:61 (permute_update_pallas)",
    [P, P, P, P, P, P, I, I, I, I, P])
BACKTRACE = Kernel(
    "backtrace", "hiphase_tpu/phasing/beam.py:363 (backtrace_tile)",
    [P, P, P, P, I, I, I, I, I, I, I, P, P, P, I, P])
WFA_FORWARD_BACKWARD = Kernel(
    "wfa_forward_backward",
    "hiphase_tpu/align/wfa_device.py:111 (wfa_forward_backward)",
    [P, P, P, P, P, I, I, I, I, I, I, P, P, P, P, P, P, P, I, P])

KERNELS = {k.name: k for k in (BEAM_SELECT, PERMUTE_UPDATE, BACKTRACE,
                               WFA_FORWARD_BACKWARD)}


# beam_select: the cluster sizes a launch may take (up to the portable
# maximum; 16 CTAs a row measured slower than 8 on the H100), the threads a
# CTA, and the widest beam: parents are traced as int16, in the JAX package
# too.
BEAM_CLUSTER_SIZES = (1, 2, 4, 8)
BEAM_SELECT_THREADS = 512
MAX_BEAM_WIDTH = 32768
# CTAs a beam_select launch aims for: one on each of 128 of the H100's 132
# SMs, the most that power-of-two cluster sizes reach at the power-of-two
# batch sizes of the slot buckets.
BEAM_SELECT_CTAS = 128


@dataclass(frozen=True)
class BeamSelectPlan:
    cluster: int   # CTAs a batch row, one thread-block cluster
    threads: int   # threads a CTA
    sample: int    # stride at which a CTA copies the other CTAs' sorted keys
    smem: int      # dynamic shared bytes a CTA


def beam_select_plan(batch: int, width: int, slots: int) -> BeamSelectPlan:
    """The launch shape of beam_select for δ [batch, width, slots].

    A CTA holds the 4·W/C candidate keys of its share of the row (8 bytes
    each, padded to a power of two, at least 64), a copy of every
    sample-th key of each CTA's sorted share (none when C is 1), its slice
    of W/C survivors (rounded up to even) and the column's e0 row. The
    cluster size C is the smallest that divides W, fits, and gives
    batch·C ≥ BEAM_SELECT_CTAS; failing that, the largest that fits.
    ``sample`` is the smallest power of two that fits the CTA in shared
    memory.
    """
    if width > MAX_BEAM_WIDTH:
        raise ValueError(
            f"beam width {width} > {MAX_BEAM_WIDTH}: the parents trace is "
            f"int16, so a survivor's parent index would overflow it")
    fits = []
    for c in BEAM_CLUSTER_SIZES:
        if width % c:
            continue
        keys = 64
        while keys < 4 * width // c:
            keys <<= 1
        sample = 1
        while sample <= keys:
            copies = c * (keys // sample) if c > 1 else 0
            slice_ = (width // c + 1) // 2 * 2
            smem = 8 * (keys + copies + slice_) + 4 * slots
            if smem <= MAX_DYNAMIC_SMEM:
                fits.append(BeamSelectPlan(c, BEAM_SELECT_THREADS, sample,
                                           smem))
                break
            sample <<= 1
    if not fits:
        raise ValueError(f"beam_select cannot hold a row of width {width} "
                         f"over {slots} slots in one cluster's shared memory")
    return next((f for f in fits if batch * f.cluster >= BEAM_SELECT_CTAS),
                fits[-1])


# backtrace: where the streamed walk gives way to the direct chain. A
# streamed column is 2W bytes into one SM, at about 84 GB/s a SM, or at a
# B-th of about 2.5 TB/s when B rows share the memory; a step of the direct
# chain takes 0.5-0.6 µs. Measured on an H100 80GB HBM3 at 700 W
# (chip_smoke.py step 3c, V = 384, cold trace, streamed / direct ms):
# B = 8: 0.1505 / 0.1937 at W = 16384, 0.3064 / 0.1956 at 32768; B = 64:
# 0.1688 / 0.2341 at W = 8192, 0.3266 / 0.2344 at 16384. The walk streams
# while W ≤ BACKTRACE_STREAM_MAX_WIDTH and B·W ≤ BACKTRACE_STREAM_MAX_ROW_SUM.
BACKTRACE_STREAM_MAX_WIDTH = 16384
BACKTRACE_STREAM_MAX_ROW_SUM = 64 * 8192
# the branch argument of the C entry point
BACKTRACE_BRANCHES = {"direct": 0, "stream": 1}


# columns a stage of the streamed walk may hold (its waits and hand-backs
# are once a stage), and the stages its ring keeps at least where it can
BACKTRACE_STAGE_COLUMNS = (16, 8, 4, 2, 1)
BACKTRACE_MIN_STAGES = 4


@dataclass(frozen=True)
class BacktracePlan:
    branch: str    # "stream" (the walk through a shared ring) or "direct"
    stages: int    # the streamed walk's ring: stages in shared memory
    cols: int      # columns a stage
    smem: int      # its dynamic shared bytes a CTA


def backtrace_column_bytes(width: int) -> int:
    """Shared bytes of one column of a ring stage: the 16-byte-aligned span
    around a row's parents slice (2W bytes), wherever the slice starts."""
    return (2 * width + 15) // 16 * 16 + 16


def backtrace_plan(batch: int, width: int, columns: int,
                   aligned: bool = True) -> BacktracePlan:
    """The launch of backtrace over a [columns, batch, width] trace: the
    streamed walk's ring and the branch to take, the direct chain past the
    measured crossover (BACKTRACE_STREAM_MAX_WIDTH, and
    BACKTRACE_STREAM_MAX_ROW_SUM for batch·width) and for a parents trace
    whose base is not ``aligned`` to 16 bytes, which the walk's bulk copies
    cannot read. A stage holds the most
    columns (of BACKTRACE_STAGE_COLUMNS) that leave BACKTRACE_MIN_STAGES
    stages in shared memory, one column where none does; the ring has as
    many stages as fit (each with two 8-byte mbarriers), at most enough for
    ``columns`` (three of one column at W = 32768)."""
    if width > MAX_BEAM_WIDTH:
        raise ValueError(
            f"beam width {width} > {MAX_BEAM_WIDTH}: the parents trace is "
            f"int16, so a slot's parent index would overflow it")
    col = backtrace_column_bytes(width)
    cols = next((g for g in BACKTRACE_STAGE_COLUMNS
                 if MAX_DYNAMIC_SMEM // (g * col + 16)
                 >= BACKTRACE_MIN_STAGES), 1)
    per = cols * col + 16
    stages = min(MAX_DYNAMIC_SMEM // per, max(-(-columns // cols), 1))
    stream = (aligned and width <= BACKTRACE_STREAM_MAX_WIDTH
              and batch * width <= BACKTRACE_STREAM_MAX_ROW_SUM)
    branch = "stream" if stream else "direct"
    return BacktracePlan(branch, stages, cols, stages * per)


def build_all() -> dict[str, build.BuiltKernel]:
    """Build (one nvcc per source, all at once) and bind every kernel not
    bound yet. It holds the lock of a kernel's lazy build at first launch,
    so that the two never build one source twice."""
    with _BUILD_LOCK:
        built = build.build(list(KERNELS))
        for name, b in built.items():
            if KERNELS[name]._fn is None:
                KERNELS[name].bind(b.library)
    return built


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0
