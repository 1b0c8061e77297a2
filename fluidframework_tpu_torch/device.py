"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``.  Asking for CUDA on a machine
    without a usable card raises: the port never carries on silently on
    the CPU — a caller that wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def count_launch(x: torch.Tensor, fn) -> None:
    """Count one run of the device program ``fn`` on ``fn.launches`` when
    ``x`` (one of its inputs) lives on a CUDA device: the launch counts
    that ``chip_smoke.py`` reads per path."""
    if x.is_cuda:
        fn.launches += 1
