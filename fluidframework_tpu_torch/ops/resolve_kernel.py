"""K1: position resolution over perspective-visible segment lengths.

Counterpart of ``fluidframework_tpu/ops/pallas_kernels.py``.  For each
query position q (perspective-visible coordinates) it finds the segment
that contains q and the offset inside it: with ``prefix`` the exclusive
prefix sum of ``lens``, the segment i with ``0 <= q - prefix[i] <
lens[i]``, reported as ``(index, offset, hit)``; a miss reports
``(0, 0, 0)``.

``resolve_positions`` is the wrapper every caller uses.  A CPU tensor takes
the plain PyTorch version (``resolve_positions_plain``, the [Q, S]
membership form of ``resolve_positions_reference``); a CUDA tensor launches
the hand-written kernel ``csrc/resolve_positions.cu`` or raises — there is
no fallback.  The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``fluidframework_tpu_torch/_build/`` at first use and loaded with ctypes.
``resolve_positions.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

I32 = torch.int32
BIG = 2**31 - 1

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "resolve_positions.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Build output keyed by the source's content hash, so an edited
    source never loads a stale library."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libresolve_positions-{digest}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel if its library is missing; returns its path.
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills),
    printed to standard error."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    if verbose and proc.stderr:
        print(proc.stderr, end="", file=sys.stderr, flush=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.resolve_positions_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(lens: torch.Tensor, positions: torch.Tensor) -> None:
    if lens.dtype != I32 or positions.dtype != I32:
        raise TypeError(
            f"lens/positions must be int32, got {lens.dtype}/{positions.dtype}"
        )
    if lens.device != positions.device:
        raise ValueError(f"lens on {lens.device}, positions on {positions.device}")
    if lens.dim() not in (1, 2) or positions.dim() != lens.dim() or (
        lens.dim() == 2 and lens.shape[0] != positions.shape[0]
    ):
        raise ValueError(
            "expected lens[S] with positions[Q], or lens[D, S] with "
            f"positions[D, Q]; got {tuple(lens.shape)} and "
            f"{tuple(positions.shape)}"
        )


def resolve_positions_plain(
    lens: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch [Q, S] membership form (the JAX package's
    ``resolve_positions_reference``); batched over a leading doc axis when
    ``lens`` is [D, S] and ``positions`` [D, Q]."""
    _check(lens, positions)
    S = lens.shape[-1]
    if S == 0:
        z = torch.zeros_like(positions)
        return z, z.clone(), z.clone()
    prefix = torch.cumsum(lens, -1, dtype=I32) - lens
    q = positions.unsqueeze(-1)
    p = prefix.unsqueeze(-2)
    inside = (q >= p) & (q < p + lens.unsqueeze(-2))
    iota = torch.arange(S, dtype=I32, device=lens.device)
    first = torch.where(inside, iota, BIG).amin(-1)
    hit = first != BIG
    local = torch.where(hit, first, 0)
    off = torch.where(hit, positions - prefix.gather(-1, local.long()), 0)
    return local, off, hit.to(I32)


def resolve_positions(
    lens: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(segment index, offset, hit) per query, all int32; ``lens[S]`` with
    ``positions[Q]``, or the batched ``lens[D, S]`` with ``positions[D, Q]``.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(lens, positions)
    if lens.device.type == "cpu":
        return resolve_positions_plain(lens, positions)
    if lens.device.type != "cuda":
        raise ValueError(f"unsupported device {lens.device}")
    squeeze = lens.dim() == 1
    lens2 = (lens[None] if squeeze else lens).contiguous()
    q2 = (positions[None] if squeeze else positions).contiguous()
    D, S = lens2.shape
    Q = q2.shape[1]
    idx, off, hit = torch.zeros((3, D, Q), dtype=I32, device=lens.device)
    if D and S and Q:
        prefix = (torch.cumsum(lens2, -1, dtype=I32) - lens2).contiguous()
        rc = _load().resolve_positions_launch(
            prefix.data_ptr(), lens2.data_ptr(), q2.data_ptr(),
            idx.data_ptr(), off.data_ptr(), hit.data_ptr(), D, S, Q,
            torch.cuda.current_stream(lens.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"resolve_positions kernel launch failed: CUDA error {rc}")
        resolve_positions.launches += 1
    if squeeze:
        return idx[0], off[0], hit[0]
    return idx, off, hit


resolve_positions.launches = 0
