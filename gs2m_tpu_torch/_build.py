"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with nvcc for sm_90a into its own shared library with a
plain C interface, loaded with ctypes. Libraries are cached under
build/kernels/ beside the package, named by a hash of the source, the
shared headers (csrc/*.cuh) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.
`build()` starts one nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
# -fmad=false: no multiply-add contraction, so kernels round like the plain
# PyTorch versions they are held against. No fast math.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    # The shared headers are part of every source's hash: editing one
    # rebuilds every kernel that may include it.
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: list[str] | None = None) -> dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, started together. Returns name -> library path."""
    names = sources() if names is None else names
    targets = {n: _target(n) for n in names}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}:\n{out}")
        else:
            os.replace(tmp, targets[n])  # atomic: never a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
