"""Operation-stamp encoding: a single int32 key that linearizes all ops.

The reference represents an operation stamp as ``{seq, clientId, localSeq?}``
(merge-tree/src/stamps.ts:29) with the total order (stamps.ts lessThan/
greaterThan):

- acked ops (seq != UnassignedSequenceNumber) order by ``seq``;
- unacked/local ops order by ``localSeq``;
- every acked op orders BEFORE every unacked op.

On TPU we need that order as plain integer comparison so that visibility
masks and tie-breaks are vector ops.  The encoding:

    key(stamp) = seq                       if acked   (0 <= seq < LOCAL_BASE)
               = LOCAL_BASE + localSeq     if unacked

With this encoding ``key(a) > key(b)`` is exactly the reference's
``greaterThan(a, b)``, and ``key < LOCAL_BASE`` is exactly ``isAcked``.

Constants mirror merge-tree/src/constants.ts: UniversalSequenceNumber=0,
UnassignedSequenceNumber=-1, NonCollabClient=-2.
"""

from __future__ import annotations

# Sequence numbers are < 2**30; local keys live in [2**30, 2**31).
LOCAL_BASE: int = 1 << 30
# Sentinel for "segment not removed": larger than every valid stamp key.
NO_REMOVE: int = (1 << 31) - 1
# A perspective refSeq meaning "has seen every acked op" (local perspective).
UNIVERSAL_SEQ: int = 0
NON_COLLAB_CLIENT: int = -2
# refSeq value that makes every acked stamp visible (local view).
ALL_ACKED: int = LOCAL_BASE - 1


def encode_stamp(seq: int, local_seq: int | None = None) -> int:
    """Encode an operation stamp as a single comparable int32 key."""
    if local_seq is not None:
        assert seq < 0, "unacked stamp must not carry a seq"
        return LOCAL_BASE + local_seq
    assert 0 <= seq < LOCAL_BASE
    return seq


def acked(key: int) -> bool:
    """Whether the encoded stamp is acked (reference stamps.ts isAcked)."""
    return key < LOCAL_BASE


def stamp_gt(a: int, b: int) -> bool:
    """Reference stamps.ts greaterThan, on encoded keys (plain >)."""
    return a > b


def has_occurred(key: int, client: int, ref_seq: int, view_client: int) -> bool:
    """Reference perspective.ts PriorPerspective.hasOccurred.

    True iff the stamped op is visible from the perspective of
    ``(ref_seq, view_client)``: it was acked at or before ``ref_seq``, or it
    was issued by ``view_client`` itself (covers both that client's earlier
    acked ops above refSeq and, for the local client, unacked ops).
    """
    return (key < LOCAL_BASE and key <= ref_seq) or client == view_client
