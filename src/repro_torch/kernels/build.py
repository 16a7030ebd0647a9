"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``).  A
library's file name carries a hash of its source and of the shared
headers (``csrc/*.cuh``), so an edited source or header is rebuilt and an
unchanged one is loaded as it is.  Nothing is built when a
module is imported: the first launch builds, or ``build_all()`` compiles
every kernel at once with one ``nvcc`` process per source, all started
together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("moe_gmm", "paged_attention", "flash_attention", "schedule")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources whose device-code optimisation nvcc splits over every core
# (``--split-compile=0``): paged_attention's 27 instantiations build in
# 29 s instead of 61 on an H100 machine's 8 cores, with the same register
# counts; it alone decided the build's wall time
SPLIT_COMPILE = ("paged_attention",)

_libs: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build, by kernel name
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + (["--split-compile=0"] if name in SPLIT_COMPILE
                         else [])


def _lib_path(name: str) -> Path:
    """The library's path, tagged with a hash of its source, of every
    shared header in ``csrc/`` and of the compiler flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def build_all(names: Iterable[str] = KERNELS) -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all in parallel.  Returns the wall seconds it took."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for name in names:
        if not _lib_path(name).exists():
            jobs.append((name, *_start(name)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)           # atomic: a half-written .so is never loaded
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def forward_only(what: str, *tensors) -> None:
    """Raise when autograd would record a call on ``tensors``: the kernels
    have no backward, and a kernel's output would carry no gradient back
    to its inputs (training runs the plain branches, ``kernels=False``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward, and an "
                           f"input requires grad; run the plain branch "
                           f"(kernels=False) to train")
