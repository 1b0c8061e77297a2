"""Test infrastructure of the port.

The counterpart of ``fluidframework_tpu/testing/``: ``network_env`` (the
real network plane in-process, for loader tests).  The reference's DDS fuzz
harness, chaos drive and snapshot helpers are not ported (ROADMAP queue 1).
"""

from .network_env import NetworkTestService

__all__ = ["NetworkTestService"]
