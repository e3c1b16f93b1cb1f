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
    [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P, P, P, P, P, P, P, I, P])
PERMUTE_UPDATE = Kernel(
    "permute_update", "scripts/pallas_permute.py:61 (permute_update_pallas)",
    [P, P, P, P, P, P, I, I, I, I, P])
BACKTRACE = Kernel(
    "backtrace", "hiphase_tpu/phasing/beam.py:363 (backtrace_tile)",
    [P, P, P, P, I, I, I, P, P, P, I, P])
WFA_FORWARD_BACKWARD = Kernel(
    "wfa_forward_backward",
    "hiphase_tpu/align/wfa_device.py:111 (wfa_forward_backward)",
    [P, P, P, P, P, I, I, I, I, I, I, P, P, P, P, P, P, P, I, P])

KERNELS = {k.name: k for k in (BEAM_SELECT, PERMUTE_UPDATE, BACKTRACE,
                               WFA_FORWARD_BACKWARD)}


def beam_select_smem_bytes(width: int, slots: int) -> int:
    """Dynamic shared memory of one beam_select block: the 4·W candidate
    keys (8 bytes each, padded to a power of two for the sort) and the
    column's e0 row."""
    n = 1
    while n < 4 * width:
        n <<= 1
    return 8 * n + 4 * slots


def build_all() -> dict[str, build.BuiltKernel]:
    """Build (one nvcc per source, all at once) and bind every kernel."""
    with _BUILD_LOCK:
        built = build.build(list(KERNELS))
        for name, b in built.items():
            KERNELS[name].bind(b.library)
    return built


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        with k._count_lock:
            k.launches = 0
