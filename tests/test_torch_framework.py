"""The port's framework layer against the JAX package's, exact.

The reference's ``tests/test_framework.py`` (FluidContainer and schema
bootstrap, DataObject, presence, undo-redo, the attributor over
``LocalServiceClient``), ``tests/test_framework_utils.py`` (the dependency
synthesizer, request routing, the agent scheduler over ``TaskManager``,
the oldest-client observer, DataObject handles),
``tests/test_service_clients.py`` (the local, virtualized and network
service clients, container versions, the copier, moira and the launcher)
and ``tests/test_bindings.py`` (view bindings) run in both packages through
``torch_twins``.  Each case's assertions hold in both, and the two runs'
sequenced message streams and container summaries are equal.

Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import pathlib
import tempfile

import pytest

import torch_twins as twins


@contextlib.contextmanager
def tmp_dir(root: str):
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


CASES = (twins.cases("test_framework.py",
                     fixtures={"client": {"client": twins.module_fixture("test_framework.py",
                                                                         "client")}})
         + twins.cases("test_framework_utils.py")
         + twins.cases("test_service_clients.py",
                       fixtures={"tmp_path": {"tmp": tmp_dir},
                                 "plane": {"plane": twins.module_fixture(
                                     "test_service_clients.py", "plane")}})
         + twins.cases("test_bindings.py"))


def test_every_reference_case_is_twinned():
    assert len(CASES) == 17 + 16 + 7 + 4, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)
