"""PyTorch/CUDA port of the fluidframework_tpu merge-tree fleet path.

This package mirrors the JAX package's module layout (``ops/``,
``models/``, ``parallel/``, ``protocol/``) so each module's counterpart is
easy to find, but it imports ``torch`` and numpy only: nothing of JAX and
nothing of ``fluidframework_tpu``.  What it needs from JAX-free reference
modules it keeps as its own copy.

Every entry point takes ``device=``; the default is ``"cuda"`` and a call
that asks for the card on a machine without one raises (see
:func:`fluidframework_tpu_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
