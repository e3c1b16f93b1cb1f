"""Build the CUDA sources with nvcc into shared libraries with a C ABI.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>_<hash>.so`` under the
package (the directory is git-ignored); the hash covers the source, the
shared header and the flags, so an edited source rebuilds and an unchanged
one is reused. Builds of several sources run as concurrent nvcc processes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent / "build"
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


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
