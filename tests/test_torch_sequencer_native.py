"""The port's native deli sequencer against the JAX package's, exact.

- Every case of the reference's ``tests/test_native_sequencer.py`` runs in
  both packages through ``torch_twins`` (each holds its native sequencer
  against its Python ``Sequencer``).
- One random join, op, leave and service-mint stream (the reference test's
  ``random_actions``) goes through the port's ``NativeSequencer`` and the
  reference's, with a checkpoint and restore half way: every stamped
  field, every nack reason, ``seq``, ``min_seq``, ``clients()`` and the
  checkpoint bytes must be equal.  Tolerance: exact.
- The port builds its own copy of ``sequencer.cpp`` into its ``_build/``
  directory, and ``server.lambdas._make_sequencer`` falls back to the
  Python ``Sequencer`` when the library is unavailable, as the
  reference's does.
"""

from __future__ import annotations

import random

import pytest

import torch_twins as twins
from fluidframework_tpu.native import NativeSequencer as RefNative
from fluidframework_tpu.protocol.messages import Nack as RefNack
from fluidframework_tpu.protocol.messages import UnsequencedMessage as RefUnseq
from fluidframework_tpu_torch import native as port_native
from fluidframework_tpu_torch.native import NativeSequencer as PortNative
from fluidframework_tpu_torch.native import gxx, sequencer_native
from fluidframework_tpu_torch.protocol.messages import MessageType, Nack as PortNack
from fluidframework_tpu_torch.protocol.messages import UnsequencedMessage as PortUnseq
from fluidframework_tpu_torch.server import lambdas
from fluidframework_tpu_torch.server.sequencer import Sequencer as PortPySequencer
from test_native_sequencer import random_actions

CASES = twins.cases("test_native_sequencer.py")


def test_every_reference_case_is_twinned():
    assert len(CASES) == 5, [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


def _stamp(m):
    if isinstance(m, (RefNack, PortNack)):
        return ["nack", m.client_id, m.client_seq, m.reason]
    return [m.client_id, m.client_seq, m.ref_seq, m.seq, m.min_seq, m.type,
            m.contents, m.metadata, m.short_client]


def _drive(seqr, unseq, actions) -> list:
    """``actions`` through one sequencer; what each returned or raised."""
    out = []
    for act in actions:
        kind = act[0]
        try:
            if kind == "join":
                res = seqr.join(act[1])
            elif kind == "leave":
                res = seqr.leave(act[1])
            elif kind == "ticket":
                _, cid, cseq, rseq = act
                res = seqr.ticket(unseq(client_id=cid, client_seq=cseq, ref_seq=rseq,
                                        type=MessageType.OP, contents={"n": cseq}))
            else:
                res = seqr.mint_service(MessageType.SUMMARY_ACK, {"handle": "h", "refSeq": 1})
            out.append(_stamp(res))
        except ValueError as e:
            out.append(["raised", str(e)])
        out.append([seqr.seq, seqr.min_seq, sorted(seqr.clients().items())])
    return out


@pytest.mark.parametrize("seed", range(6))
def test_native_sequencers_agree_across_a_restore(seed):
    rng = random.Random(seed)
    first, second = random_actions(rng, 150), random_actions(rng, 150)
    ref, port = RefNative(), PortNative()
    assert _drive(port, PortUnseq, first) == _drive(ref, RefUnseq, first)
    data = port.checkpoint_bytes()
    assert data == ref.checkpoint_bytes()
    ref2, port2 = RefNative.restore_bytes(data), PortNative.restore_bytes(data)
    assert port2.clients() == ref2.clients() == port.clients()
    assert _drive(port2, PortUnseq, second) == _drive(ref2, RefUnseq, second)
    assert port2.checkpoint_bytes() == ref2.checkpoint_bytes()


def test_library_builds_into_the_ports_build_dir():
    assert port_native.native_available()
    path = sequencer_native.library_path()
    assert path.parent == gxx.BUILD_DIR and path.exists()
    assert path.name.startswith("libtpusequencer-")
    assert sequencer_native.SRC.parent.name == "native"
    assert sequencer_native.SRC.parent.parent.name == "fluidframework_tpu_torch"


def test_make_sequencer_falls_back_without_the_library(monkeypatch):
    assert type(lambdas._make_sequencer(True)).__name__ == "NativeSequencer"
    assert type(lambdas._make_sequencer(False)) is PortPySequencer
    monkeypatch.setattr(port_native, "native_available", lambda: False)
    assert type(lambdas._make_sequencer(True)) is PortPySequencer
