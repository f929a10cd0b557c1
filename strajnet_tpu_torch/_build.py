"""The one seam between the port's Python and its CUDA libraries: builds the
kernels with nvcc, loads them through ctypes, binds their entry points and
launches them.

Each kernel lives in ``csrc/<name>.cu`` with a plain C interface; device code
that several of them share is in ``csrc/*.cuh``. The first
call of :func:`load_library` compiles it for Hopper (``sm_90a``) into
``build/strajnet_tpu_torch/`` at the repository root, under a file name keyed
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A failed compile raises with nvcc's output.

An entry point is declared once, by its prototype in the source's
``extern "C"`` block: :func:`entry_points` reads the argument and result
types from there and :func:`load_library` binds every entry as it loads the
library. Adding one is a prototype in the ``.cu`` and a call of
:func:`launch` (or, for a size query, of the bound function itself).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "strajnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float   # compile time; 0.0 when an up-to-date build was found
    log: str         # nvcc's output (ptxas register/shared-memory report),
                     # kept beside the library for later loads


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
    log_path = out.with_suffix(".log")
    if out.exists():
        return Build(out, 0.0,
                     log_path.read_text() if log_path.exists() else "")
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
    log_path.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return Build(out, seconds, proc.stdout + proc.stderr)


def build_all(names: Sequence[str]) -> Dict[str, Build]:
    """Builds several kernels at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


# C types of the prototypes' arguments and results (``const`` dropped)
CTYPES = {
    "void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
    "long long*": ctypes.c_void_p, "int*": ctypes.POINTER(ctypes.c_int),
    "int": ctypes.c_int, "long long": ctypes.c_longlong,
    "float": ctypes.c_float, "size_t": ctypes.c_size_t,
}
_EXTERN_C = re.compile(r'^extern "C" \{', re.M)
_COMMENTS = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_PROTOTYPE = re.compile(r"(?P<ret>[\w\s*]+?)\s*\b(?P<name>[A-Za-z_]\w*)\s*"
                        r"\((?P<params>[^()]*)\)")


@dataclasses.dataclass(frozen=True)
class EntryPoint:
    restype: type
    argtypes: Tuple[type, ...]
    conditional: bool   # under an #if: bound only where the library exports it


def _ctype(decl: str, named: bool):
    words = decl.replace("*", " * ").split()
    if named:
        if not words or not re.fullmatch(r"[A-Za-z_]\w*", words[-1]):
            raise KeyError(decl)
        words = words[:-1]
    return CTYPES[" ".join(w for w in words if w != "const")
                  .replace(" *", "*")]


def _entry_point(decl: str, where: str, conditional: bool):
    decl = " ".join(decl.split())
    m = _PROTOTYPE.fullmatch(decl)
    if m is None:
        name = re.search(r"(\w+)\s*\(", decl)
        raise ValueError(f"{where}: cannot read the prototype of "
                         f"{name[1] if name else decl!r}: {decl!r}")
    params = [p.strip() for p in m["params"].split(",")]
    if params in ([""], ["void"]):
        params = []
    try:
        return m["name"], EntryPoint(
            _ctype(m["ret"], named=False),
            tuple(_ctype(p, named=True) for p in params), conditional)
    except KeyError as e:
        raise ValueError(f"{where}: cannot read the prototype of "
                         f"{m['name']}: no C type for {e.args[0]!r} (known: "
                         f"{', '.join(CTYPES)})") from None


def parse_entry_points(source: str, where: str) -> Dict[str, EntryPoint]:
    """Every function of ``source``'s ``extern "C"`` block, by name, with
    the ctypes of its arguments and result (:data:`CTYPES`); ``where``
    names the source in errors. Raises ValueError on a prototype it cannot
    read, naming the source and the function."""
    m = _EXTERN_C.search(source)
    if m is None:
        raise ValueError(f'{where}: no extern "C" block')
    entries: Dict[str, EntryPoint] = {}
    depth, conditionals, decl = 0, 0, ""
    for line in _COMMENTS.sub("", source[m.end():]).splitlines():
        if depth == 0 and line.lstrip().startswith("#"):
            word = (line.lstrip()[1:].split() or [""])[0]
            conditionals += word.startswith("if") - (word == "endif")
            continue
        for ch in line + "\n":
            if depth == 0 and ch == "}":
                return entries
            if depth == 0 and ch in "{;":
                name, entry = _entry_point(decl, where, conditionals > 0)
                entries[name] = entry
                decl = ""
            elif depth == 0:
                decl += ch
            depth += (ch == "{") - (ch == "}")
    raise ValueError(f'{where}: the extern "C" block does not end')


def entry_points(name: str) -> Dict[str, EntryPoint]:
    """:func:`parse_entry_points` of ``csrc/<name>.cu``."""
    path = CSRC / f"{name}.cu"
    return parse_entry_points(path.read_text(), path.name)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` as a loaded shared library (built once),
    every entry point of :func:`entry_points` bound; one under an ``#if``
    only where the build exports it."""
    lib = ctypes.CDLL(str(build(name).path))
    for fn, entry in entry_points(name).items():
        if entry.conditional and not hasattr(lib, fn):
            continue
        bound = getattr(lib, fn)
        bound.argtypes, bound.restype = entry.argtypes, entry.restype
    return lib


def launch(lib, entry: str, *args) -> None:
    """Calls ``entry`` of ``lib`` (bound by :func:`load_library`) with
    ``args`` and the current CUDA stream of the first tensor's device:
    tensors go as their data pointers, None as a null pointer, the rest as
    they are. Raises RuntimeError naming the entry when it returns a CUDA
    error."""
    device, values = None, []
    for a in args:
        if isinstance(a, torch.Tensor):
            if device is None:
                device = a.device
            a = a.data_ptr()
        values.append(a)
    err = getattr(lib, entry)(*values,
                              torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed with CUDA error {err}")


def check_tensors(expect, device) -> None:
    """Raises ValueError unless every ``name: (tensor, dtype, shape)`` of
    ``expect`` is a contiguous, 32-byte aligned tensor of that dtype and
    shape on ``device``: what the CUDA kernels read through raw pointers."""
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes "
                             f"{dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
