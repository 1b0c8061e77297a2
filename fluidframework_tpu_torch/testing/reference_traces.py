"""The port's own copy of ``fluidframework_tpu/testing/reference_traces.py`` (no JAX in it).

Replay of the reference's OWN recorded conflict-farm traces.

The reference repo ships 60 replay files under
``packages/dds/merge-tree/src/test/results/`` — ReplayGroup arrays
(``mergeTreeOperationRunner.ts:276``) recorded from its conflict-farm runs,
each carrying the sequenced message stream (ISequencedDocumentMessage JSON)
plus the reference-computed ``initialText``/``resultText`` per group.  Its
``client.replay.spec.ts`` replays them through TestClient and asserts
convergence to ``resultText``.

This module is our side of that contract: the same
files drive our stack — issuer-faithfully (each trace client re-issues its
op locally at its recorded refSeq, then the sequenced message acks it) and
as a pure remote observer — and every group must converge to the
reference-recorded text.  Nothing here is self-written oracle output; the
expected strings come from the reference implementation.

Annotate props in the traces are string key/value (``{"client": "B"}``);
device kernels need integer prop ids, so ``intern_trace`` rewrites them to
interned ints by first appearance in sequenced order — deterministic from
the trace alone, hence identical on every replica.  Text, positions, op
types, seq/refSeq/MSN are untouched.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

from ..dds.mergetree_ref import RefMergeTree, Segment
from ..dds.shared_string import SharedString
from ..protocol.messages import DeltaType, MessageType, SequencedMessage
from ..protocol.stamps import ALL_ACKED, NON_COLLAB_CLIENT, UNIVERSAL_SEQ

# The reference checkout is named by FFTPU_REFERENCE_DIR; without it there
# is no results directory and ``reference_trace_files`` lists nothing.
_REFERENCE_DIR = os.environ.get("FFTPU_REFERENCE_DIR")
REFERENCE_RESULTS_DIR = (
    os.path.join(_REFERENCE_DIR, "packages/dds/merge-tree/src/test/results")
    if _REFERENCE_DIR
    else None
)


def reference_trace_files() -> list[str]:
    """Sorted paths of the reference's replay result files (empty when the
    reference checkout is absent — callers should skip)."""
    if REFERENCE_RESULTS_DIR is None or not os.path.isdir(REFERENCE_RESULTS_DIR):
        return []
    return sorted(
        os.path.join(REFERENCE_RESULTS_DIR, f)
        for f in os.listdir(REFERENCE_RESULTS_DIR)
        if f.endswith(".json")
    )


def load_trace(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        return json.load(f)


def intern_trace(groups: list[dict[str, Any]]) -> dict[str, dict[str, int]]:
    """Rewrite annotate props to interned int ids/values, in place.

    Returns the interning tables {"props": {...}, "values": {...}} so a test
    can decode results if it needs to.
    """
    props: dict[str, int] = {}
    values: dict[str, int] = {}
    for group in groups:
        for msg in group["msgs"]:
            c = msg["contents"]
            if c["type"] == int(DeltaType.ANNOTATE):
                c["props"] = {
                    str(props.setdefault(k, len(props))): (
                        v if isinstance(v, int) and not isinstance(v, bool)
                        else values.setdefault(str(v), len(values))
                    )
                    for k, v in c["props"].items()
                }
    return {"props": props, "values": values}


def trace_clients(groups: list[dict[str, Any]]) -> list[str]:
    """Authoring client ids in order of first appearance across the file
    (the replay spec pre-creates them the same way, client.replay.spec.ts)."""
    seen: list[str] = []
    for group in groups:
        for msg in group["msgs"]:
            if msg["clientId"] not in seen:
                seen.append(msg["clientId"])
    return seen


def bootstrap_text(backend: Any, text: str) -> None:
    """Pre-collaboration initial text: one NonCollab universal segment, the
    state TestClient.createFromClientSnapshot hands every joining client
    (snapshotLoader.ts specToSegment: UniversalSequenceNumber +
    NonCollabClient for merge-info-free specs).  Works on any backend with
    ``import_summary`` (oracle and kernel)."""
    if text:
        backend.import_summary({
            "segments": [{
                "text": text,
                "ins": [UNIVERSAL_SEQ, NON_COLLAB_CLIENT],
                "removes": [], "props": {},
            }],
            "obliterates": [],
            "minSeq": 0,
        })


def _join_msgs(names: list[str]) -> list[SequencedMessage]:
    return [
        SequencedMessage(
            client_id=name, client_seq=0, ref_seq=0, seq=0, min_seq=0,
            type=MessageType.JOIN,
            contents={"clientId": name, "short": i},
        )
        for i, name in enumerate(names)
    ]


def _issue(client: SharedString, contents: dict[str, Any]) -> None:
    """Re-issue a trace op locally (reference localTransaction)."""
    kind = contents["type"]
    if kind == int(DeltaType.INSERT):
        client.insert_text(contents["pos1"], contents["seg"])
    elif kind == int(DeltaType.REMOVE):
        client.remove_range(contents["pos1"], contents["pos2"])
    elif kind == int(DeltaType.ANNOTATE):
        for prop, value in contents["props"].items():
            client.annotate_range(
                contents["pos1"], contents["pos2"], int(prop), value
            )
    elif kind == int(DeltaType.OBLITERATE):
        client.obliterate_range(contents["pos1"], contents["pos2"])
    else:
        raise ValueError(f"unsupported trace op type {kind}")
    client.take_outbox()  # the trace already carries the sequenced form


def replay_trace(
    groups: list[dict[str, Any]],
    max_groups: int | None = None,
    observer_backend: Callable[[], Any] | None = None,
    on_group: Callable[[int, list[SharedString], SharedString], None] | None = None,
) -> tuple[list[SharedString], SharedString]:
    """Issuer-faithful replay of a reference trace file.

    Mirrors client.replay.spec.ts: every authoring client catches up to the
    op's recorded refSeq, re-issues the op locally (minting a pending local
    stamp), and the sequenced trace message later acks it; all other
    replicas apply it remotely.  A pure-observer replica (optionally on a
    different backend, e.g. ``KernelMergeTree`` on the card) applies everything remotely.
    After each group drains, every replica must equal the
    reference-recorded ``resultText``.

    Returns (clients, observer) after the final replayed group.
    """
    intern_trace(groups)
    names = trace_clients(groups)
    clients = {n: SharedString(client_id=n) for n in names}
    observer = SharedString(
        client_id="__observer__",
        backend=observer_backend() if observer_backend else None,
    )
    replicas: list[SharedString] = [*clients.values(), observer]

    initial = groups[0]["initialText"]
    for rep in replicas:
        bootstrap_text(rep.backend, initial)
    for join in _join_msgs(names):
        for rep in replicas:
            rep.process(join)

    queues: dict[str, list[SequencedMessage]] = {n: [] for n in names}
    observer_queue: list[SequencedMessage] = []

    for gi, group in enumerate(groups):
        if max_groups is not None and gi >= max_groups:
            break
        for rep in replicas:
            assert rep.text == group["initialText"], (
                f"group {gi} initial text mismatch on {rep.client_id!r}"
            )
        for raw in group["msgs"]:
            msg = SequencedMessage.from_json(json.dumps(raw))
            issuer = clients[msg.client_id]
            # Catch up until the issuer's applied seq reaches the op's
            # recorded refSeq (client.replay.spec.ts catch-up loop).
            q = queues[msg.client_id]
            while q and msg.ref_seq > issuer.current_seq:
                issuer.process(q.pop(0))
            _issue(issuer, msg.contents)
            for name in names:
                queues[name].append(msg)
            observer_queue.append(msg)
        for name in names:
            while queues[name]:
                clients[name].process(queues[name].pop(0))
        while observer_queue:
            observer.process(observer_queue.pop(0))
        expect = group["resultText"]
        for rep in replicas:
            got = rep.text
            assert got == expect, (
                f"group {gi}: {rep.client_id!r} diverged from reference "
                f"result ({got!r:.60} != {expect!r:.60})"
            )
        if on_group is not None:
            on_group(gi, list(clients.values()), observer)
    return list(clients.values()), observer


def replay_observer_only(
    groups: list[dict[str, Any]],
    backend_factory: Callable[[], Any] | None = None,
    max_groups: int | None = None,
) -> SharedString:
    """Cheap variant: a single remote-only replica applies the sequenced
    stream and must converge to every group's reference resultText."""
    intern_trace(groups)
    names = trace_clients(groups)
    observer = SharedString(
        client_id="__observer__",
        backend=backend_factory() if backend_factory else None,
    )
    bootstrap_text(observer.backend, groups[0]["initialText"])
    for join in _join_msgs(names):
        observer.process(join)
    for gi, group in enumerate(groups):
        if max_groups is not None and gi >= max_groups:
            break
        for raw in group["msgs"]:
            observer.process(SequencedMessage.from_json(json.dumps(raw)))
        got = observer.backend.visible_text(ALL_ACKED, observer.short_client)
        assert got == group["resultText"], (
            f"group {gi}: observer diverged "
            f"({got!r:.60} != {group['resultText']!r:.60})"
        )
    return observer
