"""K9: the EditManager rebase window as one hand-written CUDA kernel.

Counterpart of ``fluidframework_tpu/ops/tree_kernel.py``
``rebase_window_kernel`` (the reference's ``device_rebase=True`` fold).
Its plain PyTorch form is ``ops/tree_kernel.py`` ``rebase_window_kernel``;
this module is the packed-row interface both forms share:

- an encoding (``RebaseEnc``) is one int32 row of ``ENC_WORDS`` = 76 words:
  dep 1 | fld 5 | pos 4 | val 5 | kind 12 | cnt 12 | det 12 | slo 12 |
  shi 12 | n 1;
- a window step is one row of ``STEP_WORDS`` = 160 words: valid | id_c |
  id_x | x (76) | stage (76) | x_drop (5).

``rebase_window(c[W, 76], xs[W, C, 76], elig[W, C] uint8)`` returns
``(final c [W, 76], steps [W, C, 160])``.  A CPU tensor takes the plain
version (``rebase_window_plain``); a CUDA tensor launches
``csrc/rebase_window.cu`` (one block of 384 threads per window, both legs
of a step at once, one thread per atom) or raises — on a failed
build, a launch error, or a shape or type the kernel does not take.
``rebase_window.launches`` counts the launches on the card, and nothing
else.

No single PyTorch call computes this function: the window is a serial chain
of C steps, each two legs of dependent scans and searches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build
from . import tree_kernel as tk

I32 = torch.int32
M = tk.REBASE_MAX_MARKS
PD = tk.REBASE_MAX_DEPTH

# Field widths in packed order (``RebaseEnc`` order with ``n`` moved last).
_LAYOUT = (("dep", 1), ("fld", PD + 1), ("pos", PD), ("val", PD + 1),
           ("kind", M), ("cnt", M), ("det", M), ("slo", M), ("shi", M), ("n", 1))


def _offsets(layout) -> dict[str, tuple[int, int]]:
    out, lo = {}, 0
    for name, width in layout:
        out[name] = (lo, lo + width)
        lo += width
    return out


_OFF = _offsets(_LAYOUT)
ENC_WORDS = _OFF["n"][1]
STEP_WORDS = 3 + 2 * ENC_WORDS + PD + 1
S_X = 3
S_STAGE = 3 + ENC_WORDS
S_DROP = 3 + 2 * ENC_WORDS


def pack_enc(e: tk.RebaseEnc) -> torch.Tensor:
    """``RebaseEnc`` (any leading axes) -> int32 rows [..., 76]."""
    parts = []
    for name, width in _LAYOUT:
        f = getattr(e, name)
        parts.append(f[..., None] if width == 1 else f)
    return torch.cat([p.to(I32) for p in parts], -1)


def unpack_enc(rows):
    """Packed rows [..., 76] (tensor or numpy) -> ``RebaseEnc`` of views."""
    return tk.RebaseEnc(**{
        name: rows[..., lo] if hi - lo == 1 else rows[..., lo:hi]
        for name, (lo, hi) in _OFF.items()
    })


def unpack_steps(steps):
    """Step rows [..., 160] (tensor or numpy) -> ``RebaseStepOut`` of views
    (the flags as int32 0/1)."""
    return tk.RebaseStepOut(
        steps[..., 0], steps[..., 1], steps[..., 2],
        unpack_enc(steps[..., S_X:S_STAGE]), unpack_enc(steps[..., S_STAGE:S_DROP]),
        steps[..., S_DROP:],
    )


def _check(c: torch.Tensor, xs: torch.Tensor, elig: torch.Tensor) -> None:
    if c.dtype != I32 or xs.dtype != I32 or elig.dtype != torch.uint8:
        raise TypeError(
            f"c/xs must be int32 and elig uint8, got {c.dtype}/{xs.dtype}/{elig.dtype}"
        )
    if not c.device == xs.device == elig.device:
        raise ValueError(f"c on {c.device}, xs on {xs.device}, elig on {elig.device}")
    if (c.dim() != 2 or c.shape[1] != ENC_WORDS or xs.dim() != 3
            or xs.shape[0] != c.shape[0] or xs.shape[1] == 0 or xs.shape[2] != ENC_WORDS
            or tuple(elig.shape) != tuple(xs.shape[:2])):
        raise ValueError(
            f"expected c[W, {ENC_WORDS}], xs[W, C, {ENC_WORDS}] (C >= 1) and elig[W, C]; got "
            f"{tuple(c.shape)}, {tuple(xs.shape)} and {tuple(elig.shape)}"
        )


def rebase_window_plain(c: torch.Tensor, xs: torch.Tensor, elig: torch.Tensor):
    """The kernel's function through the plain form
    (``tree_kernel.rebase_window_kernel``) on packed rows."""
    _check(c, xs, elig)
    final, outs = tk.rebase_window_kernel(unpack_enc(c), unpack_enc(xs), elig != 0)
    steps = torch.cat([
        outs.valid[..., None].to(I32), outs.id_c[..., None].to(I32),
        outs.id_x[..., None].to(I32), pack_enc(outs.x), pack_enc(outs.stage),
        outs.x_drop.to(I32),
    ], -1)
    return pack_enc(final), steps


def rebase_window(c: torch.Tensor, xs: torch.Tensor, elig: torch.Tensor):
    """(final c [W, 76], steps [W, C, 160]) for packed encodings ``c``
    [W, 76] and windows ``xs`` [W, C, 76] gated by ``elig`` [W, C] (uint8).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(c, xs, elig)
    if c.device.type == "cpu":
        return rebase_window_plain(c, xs, elig)
    if c.device.type != "cuda":
        raise ValueError(f"unsupported device {c.device}")
    c, xs, elig = c.contiguous(), xs.contiguous(), elig.contiguous()
    if xs.data_ptr() % 16:  # the kernel stages entry rows in 16-byte copies
        xs = xs.clone()
    W, C = elig.shape
    final = torch.empty((W, ENC_WORDS), dtype=I32, device=c.device)
    steps = torch.empty((W, C, STEP_WORDS), dtype=I32, device=c.device)
    if W:
        # The C entry point launches on the current device: the tensors'.
        with torch.cuda.device(c.device):
            rc = cuda_build.load().rebase_window_launch(
                c.data_ptr(), xs.data_ptr(), elig.data_ptr(), final.data_ptr(),
                steps.data_ptr(), W, C, torch._C._cuda_getCurrentRawStream(c.device.index),
            )
        if rc != 0:
            raise RuntimeError(f"rebase_window kernel launch failed: CUDA error {rc}")
        rebase_window.launches += 1
    return final, steps


rebase_window.launches = 0


def pad_row() -> np.ndarray:
    """The packed row of a window pad: fld -1, source handles the identity,
    everything else 0 (gated off by ``elig``)."""
    row = np.empty((ENC_WORDS,), np.int32)
    z = np.zeros((M,), np.int32)
    pack_fields(row, 0, np.full((PD + 1,), -1, np.int32), 0, 0, z, z, z, 0)
    return row


def pack_fields(row: np.ndarray, dep, fld, pos, val, kind, cnt, det, n) -> None:
    """Write one host encoding into a packed numpy row (source handles the
    identity, as every encoding enters a window)."""
    row[_OFF["dep"][0]] = dep
    for name, f in (("fld", fld), ("pos", pos), ("val", val), ("kind", kind),
                    ("cnt", cnt), ("det", det)):
        lo, hi = _OFF[name]
        row[lo:hi] = f
    row[_OFF["n"][0]] = n
    for name in ("slo", "shi"):
        lo, hi = _OFF[name]
        row[lo:hi] = np.arange(M, dtype=np.int32)
