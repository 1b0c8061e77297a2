"""The port's summary manager against the JAX package's, exact.

Every case of the reference's ``tests/test_summary.py`` runs in both
packages through ``torch_twins`` over the local driver: the summary-tree
format (``materialize`` with blobs, trees and handles), the summary flow
with its scribe ack and baseline, incremental handles for clean channels,
a loader booting from the scribe's snapshot, the election moving on a
disconnect, the scribe's nack of an unknown handle, a dropped connection
unsticking the manager, the op-count and time triggers, the ack-wait
timeout and the nack ladder, the stalled summarizer's re-election, the
tree channel's incremental chunks, and the hidden summarizer client.

``SummaryManager.tick()`` reads no wall clock here: a call without ``now``
takes the twins' counter clock, the same in both packages.  Each case's
assertions must hold in both packages, and the two runs must agree message
by message on every sequenced log and on every container runtime's
summary.  Tolerance: exact.
"""

from __future__ import annotations

import pytest

import torch_twins as twins

CASES = twins.cases("test_summary.py", fixtures={"env": twins.ENV_LOCAL})


def test_every_reference_case_is_twinned():
    ids = [c[0] for c in CASES]
    assert len(ids) == len(set(ids)) == 24, len(ids)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_summary_case_matches_reference(case, monkeypatch):
    twins.run_pair(case, monkeypatch)
