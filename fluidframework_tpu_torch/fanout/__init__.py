"""Read fan-out plane: encode-once delta broadcast, snapshot-boot tier,

A port of ``fluidframework_tpu/fanout/__init__.py`` (no JAX in it).

sequencer-free presence.

Three planes over one peer set:

- **Delta fan-out** (``plane``/``frames``/``writer``): each document's
  sequenced pump batch is encoded ONCE into a ``DeltaFrame`` (built from
  the cached per-message wire encodes) and published to a bounded
  per-doc frame ring; subscribers hold cursors, the selector-driven writer
  tier drains sockets with vectored ``sendmsg`` sends, and slow
  subscribers drop-to-catch-up via a byte-identical resync from the
  ordered log — never stalling the other N−1.
- **Snapshot boot** (``historian``): summary commits served straight out
  of ``GitSnapshotStore`` behind ETag/304/immutable HTTP caching and
  ``read_path`` partial subtree reads — booting readers never touch the
  sequencer or the fleet.
- **Presence** (``plane.publish_signal``): signals encoded once and
  scattered through the same writer tier as bounded droppable directs —
  unsequenced, at-most-once, off the ordering path and off the service
  lock.
"""

from .frames import (
    FLAVOR_ENVELOPE,
    FLAVOR_WIRE,
    KIND_DELTA,
    KIND_RESYNC,
    DeltaFrame,
    build_frame,
)
from .historian import HistorianTier, service_snapshot_source
from .plane import RESYNC_BOOT_MARKER, FanoutPeer, FanoutPlane
from .writer import FanoutWriter

__all__ = [
    "DeltaFrame",
    "FLAVOR_ENVELOPE",
    "FLAVOR_WIRE",
    "FanoutPeer",
    "FanoutPlane",
    "FanoutWriter",
    "HistorianTier",
    "KIND_DELTA",
    "KIND_RESYNC",
    "RESYNC_BOOT_MARKER",
    "build_frame",
    "service_snapshot_source",
]
