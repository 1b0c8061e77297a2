"""Test infrastructure of the port.

The counterpart of ``fluidframework_tpu/testing/``, whose exports it keeps
(the DDS fuzz harness of ``fuzz``), with ``network_env`` (the real network
plane in-process, for loader tests), ``chaos`` (the seeded fault
schedule and soak over the whole serving stack), ``snapshot_corpus`` (the
golden corpus scripts), ``reference_snapshots`` and ``reference_traces``
(loaders of the reference checkout's artifacts, read only through
``FFTPU_REFERENCE_DIR``).
"""

from .fuzz import (
    DDSFuzzModel,
    FuzzClient,
    FuzzFailure,
    run_fuzz_seed,
    run_fuzz_suite,
)
from .network_env import NetworkTestService

__all__ = [
    "DDSFuzzModel",
    "FuzzClient",
    "FuzzFailure",
    "NetworkTestService",
    "run_fuzz_seed",
    "run_fuzz_suite",
]
