"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with nvcc for sm_90a into its own shared library with a
plain C interface, loaded with ctypes. Libraries are cached under
build/kernels/ beside the package, named by a hash of the source, the
shared headers (csrc/*.cuh) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. A kernel may also be built with
preprocessor defines into a library of its own (chip_smoke.py's timing
probes of K2); the paths load only the plain builds.
`build()` starts one nvcc per library, all at once.
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


def _target(name: str, defines: tuple[str, ...] = ()) -> Path:
    # The shared headers are part of every source's hash: editing one
    # rebuilds every kernel that may include it.
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join([*NVCC_FLAGS, *defines])
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(kernels: list | None = None) -> dict:
    """Compile the given kernels (default: every source) that are not built
    yet, one nvcc process each, started together. A kernel is a source name,
    or (name, defines) for a build of that source with preprocessor defines
    such as "-DNAME=1". Returns kernel -> library path."""
    kernels = sources() if kernels is None else kernels
    targets = {k: _target(*((k,) if isinstance(k, str) else k))
               for k in kernels}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k, so in targets.items():
        if so.exists():
            continue
        name, defines = (k, ()) if isinstance(k, str) else k
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for k, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k}:\n{out}")
        else:
            os.replace(tmp, targets[k])  # atomic: never a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (built with `defines`), built
    first if needed."""
    kernel = (name, defines) if defines else name
    return ctypes.CDLL(str(build([kernel])[kernel]))
