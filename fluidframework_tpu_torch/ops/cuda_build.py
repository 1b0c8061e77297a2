"""The port's hand-written CUDA kernels as one shared library.

Every ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into one
library under ``fluidframework_tpu_torch/_build/`` at first use: one
``nvcc -c`` per source, all started together, then one link.  The library
exposes a plain C entry point per kernel (no PyTorch headers, so a build
takes seconds) and is loaded with ctypes; ``load`` sets each entry point's
argument types.  The library's name carries a hash of every source, so an
edited source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: argument types (every one returns cudaGetLastError()).
ENTRY_POINTS = {
    # lens, positions, out, tile_sum, D, S, Q, tile, stream
    "resolve_positions_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # c, xs, elig, final_c, steps, W, C, stream
    "rebase_window_launch": (_P, _P, _P, _P, _P, _I, _I, _P),
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Build output keyed by the content hash of every source."""
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfftpu_kernels-{h.hexdigest()[:12]}.so"


def _run(procs: list) -> None:
    for cmd, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        if err and "-v" in cmd:
            print(err, end="", file=sys.stderr, flush=True)


def build(verbose: bool = False) -> Path:
    """Compile the kernels if their library is missing; returns its path.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills per
    kernel), printed to standard error."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *COMPILE_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        _run(procs)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load():
    """The loaded library (built first if needed), entry points typed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
