"""Test infrastructure of the port.

The counterpart of ``fluidframework_tpu/testing/``, whose exports it keeps
(the DDS fuzz harness of ``fuzz``), with ``network_env`` (the real network
plane in-process, for loader tests) and ``chaos`` (the seeded fault
schedule and soak over the whole serving stack).  The reference's snapshot
helpers are not ported.
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
