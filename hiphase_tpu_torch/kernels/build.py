"""Build the CUDA sources with nvcc, and the native host library with the
system C++ compiler, into shared libraries with a C ABI.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>_<hash>.so`` under the
package (the directory is git-ignored); the hash covers the source, the
shared header and the flags, so an edited source rebuilds and an unchanged
one is reused. Builds of several sources run as concurrent nvcc processes.
``csrc/hiphase_native.cc`` (the host library: BGZF, BAM and VCF scans,
allele assignment, the C++ beam) becomes
``build/libhiphase_native_<hash>.so`` the same way (`build_host_library`).
The port's own C++ twins of host loops, `PORT_SOURCES` (the A* oracle's
heuristic sweep ``csrc/astar_sweep.cc``, the device WFA's pass 1
``csrc/wfa_windows.cc`` and its window packer ``csrc/wfa_pack.cc``), build
with the host library's compiler and flags, no codec, into one library
``build/libhiphase_port_<hash>.so`` (`build_port_library`). A new twin is
one more source in `PORT_SOURCES` and its signature in
`io.native.bind_port`. The host library and the packer include the one
WFA graph builder, ``csrc/wfa_build.h``, and both hashes cover it.
Every library is written under a temporary name and renamed into place, so
concurrent processes never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "build"
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_SOURCE = CSRC / "hiphase_native.cc"
# the port's own C++, compiled together into one library
PORT_SOURCES = (CSRC / "astar_sweep.cc", CSRC / "wfa_windows.cc",
                CSRC / "wfa_pack.cc")
# the WFA graph builder, included by HOST_SOURCE and wfa_pack.cc
WFA_BUILD_HEADER = CSRC / "wfa_build.h"
# no -march=native: the hash does not cover the host CPU, so a library
# cached on one CPU may be loaded on another
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
# the host library's BGZF codecs: HN_CODEC's value (hn_codec() returns it)
# and the link flags each needs, best first
CODECS = {"libdeflate": (2, ("-ldeflate",)), "zlib": (1, ("-lz",)),
          "none": (0, ())}
CODEC_NAMES = {v: k for k, (v, _) in CODECS.items()}


class KernelBuildError(RuntimeError):
    """A compiler is missing or refused a source."""


@dataclass
class BuiltKernel:
    library: Path
    log: str  # nvcc / ptxas output (registers, shared memory, spills)


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in CUDA_HOME); the CUDA "
        "kernels are compiled from csrc/ at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in (source_path(name), *(CSRC / x for x in HEADERS)):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, BuiltKernel]:
    """Build every named kernel that is not built yet, concurrently."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, BuiltKernel] = {}
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = BuiltKernel(lib, "")
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failures = []
    for name, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = BuiltKernel(lib, log)
    if failures:
        raise KernelBuildError("\n".join(failures))
    return out


@dataclass
class BuiltHostLibrary:
    library: Path
    codec: str       # a key of CODECS
    seconds: float   # the compiler's wall time; 0.0 when the cache held it


def cxx() -> str:
    """The system C++ compiler: g++ on PATH, else c++."""
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise KernelBuildError("no C++ compiler (g++ or c++) on PATH; the native "
                           "host library is compiled from csrc/ at first use")


def host_flags(codec: str) -> tuple[str, ...]:
    value, libs = CODECS[codec]
    return (*HOST_FLAGS, f"-DHN_CODEC={value}", *libs)


def _hashed_path(stem: str, sources, flags) -> Path:
    """``build/lib<stem>_<hash>.so``, the hash over the sources' bytes and
    the flags."""
    h = hashlib.sha256()
    for source in sources:
        h.update(source.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def host_library_path(codec: str) -> Path:
    return _hashed_path("hiphase_native", (HOST_SOURCE, WFA_BUILD_HEADER),
                        host_flags(codec))


def header_codec(compiler: str) -> str:
    """The codec the source picks by itself (``__has_include``) with this
    compiler: the value it gives HN_CODEC when none is passed."""
    proc = subprocess.run([compiler, "-std=c++17", "-E", "-dM",
                           str(HOST_SOURCE)], capture_output=True, text=True)
    m = re.search(r"^#define HN_CODEC (\d+)$", proc.stdout, re.M)
    if proc.returncode != 0 or m is None:
        raise KernelBuildError(f"{compiler} could not preprocess "
                               f"{HOST_SOURCE.name}:\n{proc.stderr}")
    return CODEC_NAMES[int(m.group(1))]


def build_host_library(codec: str = "auto") -> BuiltHostLibrary:
    """Build (or find in the cache) the native host library with ``codec``
    (a key of CODECS). ``auto`` takes the codec whose header the compiler
    finds, and the next one down when it does not link (a header without
    its library); ``none`` always builds."""
    compiler = cxx()
    if codec == "auto":
        order = list(CODECS)
        codecs = order[order.index(header_codec(compiler)):]
    else:
        codecs = [codec]
    failures = []
    for c in codecs:
        lib = host_library_path(c)
        if lib.exists():
            return BuiltHostLibrary(lib, c, 0.0)
        value, libs = CODECS[c]
        out = _compile(compiler, (HOST_SOURCE,), lib,
                       (*HOST_FLAGS, f"-DHN_CODEC={value}"), libs)
        if isinstance(out, float):
            return BuiltHostLibrary(lib, c, out)
        failures.append(f"codec {c}: {out}")
    raise KernelBuildError("the native host library did not build:\n"
                           + "\n".join(failures))


def port_library_path() -> Path:
    return _hashed_path("hiphase_port", (*PORT_SOURCES, WFA_BUILD_HEADER),
                        HOST_FLAGS)


def build_port_library() -> BuiltHostLibrary:
    """Build (or find in the cache) the port's own library, every source of
    `PORT_SOURCES` in one: the host library's compiler and flags, no
    codec."""
    lib = port_library_path()
    if lib.exists():
        return BuiltHostLibrary(lib, "none", 0.0)
    out = _compile(cxx(), PORT_SOURCES, lib, HOST_FLAGS, ())
    if isinstance(out, float):
        return BuiltHostLibrary(lib, "none", out)
    raise KernelBuildError(f"the port's own library did not build:\n{out}")


def _compile(compiler: str, sources, lib: Path, flags, libs
             ) -> float | str:
    """Compile and link ``sources`` into ``lib`` through a temporary name;
    the compiler's seconds, or its command and output when it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(
        f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources), *libs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode == 0:
        os.replace(tmp, lib)
        return seconds
    tmp.unlink(missing_ok=True)
    return f"{' '.join(cmd)}\nexited {proc.returncode}\n{proc.stdout}"
