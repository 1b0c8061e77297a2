"""The port's loader and drivers against the JAX package's, exact.

Every case of the reference's ``tests/test_loader.py`` (load and attach,
snapshots with trailing ops, read mode and escalation, quorum proposals,
reconnect epochs, nacks, gap repair, pause and resume, signals, proposal
rejection, stashes) runs in both packages through ``torch_twins``, over the
local driver and over the network driver against the service plane on
ephemeral local ports, each with the ``RefMergeTree`` oracle and with
``KernelMergeTree`` behind the string channels (the port's on the CPU).
The cases of ``tests/test_audience.py`` (the audience unit cases, the
read/write membership split, presence from the audience) run over the
local driver, as the reference runs them.

Each case's assertions must hold in both packages, and the two runs must
agree message by message on every document's sequenced log (wire JSON;
network submits are serialized, see ``torch_twins``) and on every container
runtime's summary.  Tolerance: exact.
"""

from __future__ import annotations

import pytest

import torch_twins as twins

CASES = (twins.cases("test_loader.py", fixtures={"env": twins.ENV_NETWORK},
                     setup=twins.BACKENDS)
         + twins.cases("test_audience.py", fixtures={"env": twins.ENV_LOCAL}))


def test_every_reference_case_is_twinned():
    # 12 loader cases x 2 drivers x 2 string backends, 10 audience cases.
    ids = [c[0] for c in CASES]
    assert len(ids) == len(set(ids)) == 12 * 4 + 10, len(ids)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_loader_case_matches_reference(case, monkeypatch):
    trace = twins.run_pair(case, monkeypatch)
    if "AudienceUnit" not in case[0]:  # the unit cases make no document
        assert trace["logs"] and all(trace["logs"]), "no document was sequenced"
