"""Ordering service and serving tier: the sequencer and in-memory local
service, the network fronts (``netserver``, with tenant ``auth`` and
``admission`` control) and their ``launcher``, ordered log and checkpoint
store, git summary store, scribe, fleet consumer and its entry point,
failover.

The ``Sequencer``/``LocalService`` exports are those of
``fluidframework_tpu/server/__init__.py``.
"""

from .sequencer import Sequencer, ClientEntry
from .local_service import LocalService, LocalDocument

__all__ = ["Sequencer", "ClientEntry", "LocalService", "LocalDocument"]
