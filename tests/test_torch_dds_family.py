"""The port's other DDSes and the legacy v1 sequence snapshots against the
JAX package's, exact.

The reference's ``tests/test_small_dds.py`` (cell, counter, consensus
queue, register collection, task manager, pact map),
``tests/test_extra_dds.py`` (directory, ink, summary block, the matrix
channel and their fuzz suites), ``tests/test_ot.py`` (the JSON OT
channel), ``tests/test_ot_json1_property.py`` (json1 and the property
tree) and the ``snapshot_v1`` cases of ``tests/test_markers.py`` (on both
string backends, as that module runs them) run in both packages through
``torch_twins``: each case's assertions hold in both, and the two runs'
sequenced message streams and container summaries are equal.

Tolerance: exact.
"""

from __future__ import annotations

import pytest

import torch_twins as twins

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
MARKER_V1 = ("test_remote_and_stashed_text_rejects_marker_plane",
             "test_snapshot_v1_marker_wire_shape")


def _markers_v1_cases() -> list:
    out = twins.cases("test_markers.py", setup=twins.BACKENDS)
    return [c for c in out if c[0].split("::")[1].split("[")[0] in MARKER_V1]


CASES = (twins.cases("test_small_dds.py",
                     fixtures={"pair": {"pair": twins.module_fixture("test_small_dds.py", "pair")}})
         + twins.cases("test_extra_dds.py")
         + twins.cases("test_ot.py")
         + twins.cases("test_ot_json1_property.py")
         + _markers_v1_cases())


def test_every_reference_case_is_twinned():
    assert len(CASES) == 14 + 12 + 14 + 10 + 2 * 2, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)
