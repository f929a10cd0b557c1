"""Builds the package's CUDA kernels with nvcc and loads them through ctypes.

Each kernel lives in ``csrc/<name>.cu`` with a plain C interface; device code
that several of them share is in ``csrc/*.cuh``. The first
call of :func:`load_library` compiles it for Hopper (``sm_90a``) into
``build/strajnet_tpu_torch/`` at the repository root, under a file name keyed
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed compile raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "strajnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # compile time; 0.0 when an up-to-date build was found
    log: str         # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels of strajnet_tpu_torch "
                       "are compiled on first use and need the CUDA toolkit")


def build(name: str) -> Build:
    """Compiles ``csrc/<name>.cu`` unless a build of the same sources exists."""
    sources = [CSRC / f"{name}.cu"]
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, seconds, proc.stdout + proc.stderr)


def build_all(names: Sequence[str]) -> Dict[str, Build]:
    """Builds several kernels at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` as a loaded shared library (built once)."""
    return ctypes.CDLL(str(build(name).path))
