"""K1: position resolution over perspective-visible segment lengths.

Counterpart of ``fluidframework_tpu/ops/pallas_kernels.py``.  For each
query position q (perspective-visible coordinates) it finds the segment
that contains q and the offset inside it: with ``prefix`` the exclusive
prefix sum of ``lens``, the segment i with ``0 <= q - prefix[i] <
lens[i]``, reported as ``(index, offset, hit)``; a miss reports
``(0, 0, 0)``.

Both forms search in two levels over tiles of ``TILE`` segments: per-tile
sums, the tile whose inclusive prefix first passes q, then the segment
inside that tile whose inclusive prefix first passes q.

``resolve_positions`` is the wrapper every caller uses.  A CPU tensor takes
the plain PyTorch version (``resolve_positions_plain``); a CUDA tensor
launches the hand-written kernels of ``csrc/resolve_positions.cu`` or
raises — there is no fallback.  The kernels are compiled with ``nvcc`` for
``sm_90a`` into the port's one kernel library at first use and loaded
with ctypes (``ops/cuda_build.py``).  ``resolve_positions.launches`` counts
the wrapper calls that launched on the card (two kernels each), and nothing
else.
"""

from __future__ import annotations

import torch

from . import cuda_build

I32 = torch.int32
# Segments per tile of the two-level search, for the kernels and the plain
# version alike (the kernels take it as an argument).  At the long-document
# size, 262,144 segments, it makes 128 tile-sum blocks for the H100's 132 SMs.
TILE = 2048


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
    """The kernels' two-level search written with torch ops (the same
    ``TILE``), batched over a leading doc axis when ``lens`` is [D, S] and
    ``positions`` [D, Q].  Under the precondition of ``resolve_positions``
    it equals the JAX package's [Q, S] membership form
    (``resolve_positions_reference``) exactly."""
    _check(lens, positions)
    squeeze = lens.dim() == 1
    lens2 = lens[None] if squeeze else lens
    q = positions[None] if squeeze else positions
    D, S = lens2.shape
    Q = q.shape[1]
    n_tiles = -(-S // TILE)
    if n_tiles == 0:
        z = torch.zeros_like(positions)
        return z, z.clone(), z.clone()
    tiles = torch.nn.functional.pad(lens2, (0, n_tiles * TILE - S)).view(D, n_tiles, TILE)
    tile_sum = tiles.sum(-1, dtype=I32)
    tile_incl = torch.cumsum(tile_sum, -1, dtype=I32)
    hit = (q >= 0) & (q < tile_incl[:, -1:])
    qh = torch.where(hit, q, 0)
    # The first tile whose inclusive prefix passes q (every hit has one).
    t = torch.searchsorted(tile_incl, qh, right=True).clamp_(max=n_tiles - 1)
    rows = tiles.gather(1, t[..., None].expand(D, Q, TILE))
    tile_excl = (tile_incl - tile_sum).gather(1, t)
    incl = torch.cumsum(rows, -1, dtype=I32) + tile_excl[..., None]
    # The first segment of that tile whose inclusive prefix passes q.
    j = (incl <= qh[..., None]).sum(-1).clamp_(max=TILE - 1)
    excl = (incl - rows).gather(-1, j[..., None])[..., 0]
    idx = torch.where(hit, t * TILE + j, 0).to(I32)
    off = torch.where(hit, qh - excl, 0)
    out = (idx, off, hit.to(I32))
    return tuple(o[0] for o in out) if squeeze else out


def resolve_positions(
    lens: torch.Tensor, positions: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(segment index, offset, hit) per query, all int32; ``lens[S]`` with
    ``positions[Q]``, or the batched ``lens[D, S]`` with ``positions[D, Q]``.
    CPU tensors take the plain version; CUDA tensors launch the kernels.

    Precondition: every entry of ``lens`` is >= 0 and each row sums to less
    than 2**31.  Every caller passes visible lengths (``seg_len`` where the
    segment is alive and visible, else 0; a live ``seg_len`` is an insert's
    text length or a split's remainder), so this holds: the prefix is then
    non-decreasing, and the two-level search finds what the [Q, S]
    membership form finds."""
    _check(lens, positions)
    if lens.device.type == "cpu":
        return resolve_positions_plain(lens, positions)
    if lens.device.type != "cuda":
        raise ValueError(f"unsupported device {lens.device}")
    # Host issue outweighs the kernels at the segment lane's size, so this
    # path makes no views and no torch ops beyond the two allocations and
    # the final unbind.
    lens = lens.contiguous()
    positions = positions.contiguous()
    S, Q = lens.shape[-1], positions.shape[-1]
    D = lens.shape[0] if lens.dim() == 2 else 1
    # The search kernel writes every output element, hit or miss.
    out = torch.empty((3, *positions.shape), dtype=I32, device=lens.device)
    if D and Q:
        tile_sum = torch.empty(D * -(-S // TILE), dtype=I32, device=lens.device)
        # The C entry point launches on the calling thread's current device:
        # make it the tensors' card for the launch (its stream is that
        # card's).
        with torch.cuda.device(lens.device):
            rc = cuda_build.load().resolve_positions_launch(
                lens.data_ptr(), positions.data_ptr(), out.data_ptr(),
                tile_sum.data_ptr(), D, S, Q, TILE,
                # The raw current stream, as torch's own kernel launchers
                # read it (torch.cuda.current_stream builds a Stream object
                # per call).
                torch._C._cuda_getCurrentRawStream(lens.device.index),
            )
        if rc != 0:
            raise RuntimeError(f"resolve_positions kernel launch failed: CUDA error {rc}")
        resolve_positions.launches += 1
    idx, off, hit = out
    return idx, off, hit


resolve_positions.launches = 0
