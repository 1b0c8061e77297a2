"""The port's own copy of ``fluidframework_tpu/runtime/errors.py`` (no JAX in it).

Runtime error taxonomy (ref container-runtime DataProcessingError family)."""

from __future__ import annotations


class DataProcessingError(RuntimeError):
    """Inbound op processing hit a corrupt/inconsistent state; the container
    closes itself rather than continue diverged (ref DataProcessingError)."""


class ContainerForkError(DataProcessingError):
    """A remote batch carried one of OUR pending batch ids under a different
    identity: two containers are submitting the same local state (ref
    'Forked Container Error', pendingStateManager.ts:626)."""
