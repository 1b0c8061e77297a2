"""The obliterate-place check of ``fluidframework_tpu/dds/shared_string.py``
(``validate_obliterate_places``): the quarantine gate of the fleet engine
runs it before an obliterate reaches a host oracle."""

from __future__ import annotations

from .mergetree_ref import SIDE_AFTER


def validate_obliterate_places(
    pos1: int, side1: int, pos2: int, side2: int, vis_len: int
) -> None:
    """Reject invalid sided places: a backend that only latches error
    flags (the kernel) must not accept an op that would make every
    oracle-backed replica raise."""
    start = pos1 + (1 if side1 == SIDE_AFTER else 0)
    end = pos2 + (1 if side2 == SIDE_AFTER else 0)
    if not (0 <= pos1 <= pos2 < vis_len and start <= end):
        raise ValueError(
            f"obliterate places ({pos1},{side1})..({pos2},{side2}) invalid "
            f"for visible length {vis_len}"
        )
