"""The port's own copy of ``fluidframework_tpu/dds/small.py`` (no JAX in it).

The small DDS family: cell, counter, and the consensus DDSes.

Reference parity (SURVEY.md §2.1 "small DDSes" row):

- SharedCell      packages/dds/cell/src/cell.ts — single-value LWW with
                  optimistic pending overlay (a one-key SharedMap).
- SharedCounter   packages/dds/counter/src/counter.ts — commutative
                  increments; value = sequenced sum + pending sum.
- ConsensusQueue  packages/dds/ordered-collection/src/consensusOrderedCollection.ts
                  — ack-gated distributed queue: state changes ONLY on
                  sequenced ops; acquired items are tracked per client and
                  re-queued when that client leaves.
- ConsensusRegisterCollection
                  packages/dds/register-collection/src/consensusRegisterCollection.ts
                  — per-key register keeping all concurrent versions; a
                  write "wins" (atomic update) iff its refSeq saw the
                  previous atomic write.
- TaskManager     packages/dds/task-manager/src/taskManager.ts — per-task
                  volunteer queues; queue head holds the task; leaves
                  evict; complete clears the queue.
- PactMap         packages/dds/pact-map/src/pactMap.ts — consensus KV: a
                  set proposal becomes accepted only after explicit accept
                  ops from every client connected at proposal time (leaves
                  count as implicit signoff).

These are host-side control-plane DDSes: low op volume, consensus-gated —
the device payoff lives in the bulk DDSes (string/map/matrix/tree kernels).
All are channels (runtime/channel.py) and resubmit verbatim on reconnect:
every op here is position-free (their conflict rules are seq/refSeq based,
which the sequencer re-stamps on resubmission).
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field
from typing import Any, Callable

from ..protocol.channel import Channel, MessageCollection
from .channels import ChannelTypeFactory, PendingOverlayChannel


class _VerbatimResubmitChannel(Channel):
    """Base for position-free DDSes: resubmit re-sends contents unchanged.

    Stashed ops apply no optimistic state (consensus semantics — nothing
    changes until sequencing); rehydrate just re-enters them into the pending
    queue for verbatim resubmission, with any local completion handles
    resolving as unavailable (ref consensusOrderedCollection.ts:438 — stashed
    ops are resubmitted with a no-op resolve)."""

    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        self.submit_local_message(contents, local_metadata)

    def apply_stashed(self, contents: Any) -> Any:
        return None


# ---------------------------------------------------------------------------
# SharedCell
# ---------------------------------------------------------------------------

class SharedCell(PendingOverlayChannel):
    """Single collaborative value, LWW, with optimistic local overlay —
    a one-key SharedMap, sharing its pending-overlay machinery."""

    channel_type = "sharedCell"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.sequenced_value: Any = None
        self.sequenced_empty = True

    def set(self, value: Any) -> None:
        self._submit({"type": "setCell", "value": value})

    def delete(self) -> None:
        self._submit({"type": "deleteCell"})

    def _apply(self, op: dict) -> None:
        if op["type"] == "setCell":
            self.sequenced_value, self.sequenced_empty = op["value"], False
        elif op["type"] == "deleteCell":
            self.sequenced_value, self.sequenced_empty = None, True
        else:
            raise ValueError(f"unknown cell op {op['type']}")

    def get(self) -> Any:
        if self._pending:
            op = self._pending[-1][1]
            return op["value"] if op["type"] == "setCell" else None
        return self.sequenced_value

    @property
    def empty(self) -> bool:
        if self._pending:
            return self._pending[-1][1]["type"] == "deleteCell"
        return self.sequenced_empty

    def summarize(self) -> dict[str, Any]:
        return {"value": self.sequenced_value, "empty": self.sequenced_empty}

    def load(self, summary: dict[str, Any]) -> None:
        self.sequenced_value = summary["value"]
        self.sequenced_empty = summary["empty"]


# ---------------------------------------------------------------------------
# SharedCounter
# ---------------------------------------------------------------------------

class SharedCounter(_VerbatimResubmitChannel):
    """Commutative integer counter (counter.ts): all increments apply; the
    local view adds unacked pending increments to the sequenced sum."""

    channel_type = "sharedCounter"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.sequenced_value = 0
        self._pending_sum = 0

    def increment(self, delta: int) -> None:
        if not isinstance(delta, int):
            raise TypeError("SharedCounter increments must be integers")
        self._pending_sum += delta
        self.submit_local_message({"type": "increment", "incrementAmount": delta})

    def process_messages(self, collection: MessageCollection) -> None:
        for m in collection.messages:
            delta = m.contents["incrementAmount"]
            self.sequenced_value += delta
            if m.local:
                self._pending_sum -= delta

    def apply_stashed(self, contents: Any) -> Any:
        self._pending_sum += contents["incrementAmount"]
        return None

    def rollback(self, contents: Any, local_metadata: Any) -> None:
        self._pending_sum -= contents["incrementAmount"]

    @property
    def value(self) -> int:
        return self.sequenced_value + self._pending_sum

    def summarize(self) -> dict[str, Any]:
        return {"value": self.sequenced_value}

    def load(self, summary: dict[str, Any]) -> None:
        self.sequenced_value = summary["value"]


# ---------------------------------------------------------------------------
# ConsensusQueue (ordered collection)
# ---------------------------------------------------------------------------

@dataclass
class AcquireHandle:
    """Resolves when the acquire op is sequenced (ref acquire() promise)."""

    acquire_id: str
    value: Any = None
    acquired: bool = False  # sequenced AND an item was available
    settled: bool = False   # sequenced (either way)


class ConsensusQueue(_VerbatimResubmitChannel):
    """Ack-gated FIFO: nothing changes until ops sequence (no optimistic
    apply — consensus semantics, consensusOrderedCollection.ts)."""

    channel_type = "consensusQueue"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.data: list[Any] = []
        # acquireId -> (value, clientId) for in-flight acquired items.
        self.job_tracking: dict[str, tuple[Any, str]] = {}
        self._handles: dict[str, AcquireHandle] = {}

    # ------------------------------------------------------------------- api
    def add(self, value: Any) -> None:
        self.submit_local_message({"opName": "add", "value": value})

    def acquire(self) -> AcquireHandle:
        """Request the head item; resolves at sequencing (consensus).

        The acquire id is a fresh UUID (ref consensusOrderedCollection.ts:411)
        — NOT derived from the client id, which is None for detached
        containers and would collide across clients acquiring pre-connect."""
        acquire_id = _uuid.uuid4().hex
        handle = AcquireHandle(acquire_id)
        self._handles[acquire_id] = handle
        self.submit_local_message({"opName": "acquire", "acquireId": acquire_id})
        return handle

    def complete(self, handle: AcquireHandle) -> None:
        assert handle.acquired
        self.submit_local_message({"opName": "complete", "acquireId": handle.acquire_id})

    def release(self, handle: AcquireHandle) -> None:
        assert handle.acquired
        self.submit_local_message({"opName": "release", "acquireId": handle.acquire_id})

    # --------------------------------------------------------------- inbound
    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        for m in collection.messages:
            op = m.contents
            name = op["opName"]
            if name == "add":
                self.data.append(op["value"])
            elif name == "acquire":
                self._acquire_core(op["acquireId"], env.client_id, m.local)
            elif name == "complete":
                self.job_tracking.pop(op["acquireId"], None)
            elif name == "release":
                entry = self.job_tracking.pop(op["acquireId"], None)
                if entry is not None:
                    self.data.append(entry[0])
            else:
                raise ValueError(f"unknown ordered-collection op {name}")

    def _acquire_core(self, acquire_id: str, client_id: str, local: bool) -> None:
        value_available = bool(self.data)
        if value_available:
            value = self.data.pop(0)
            self.job_tracking[acquire_id] = (value, client_id)
        if local:
            handle = self._handles.pop(acquire_id, None)
            if handle is not None:
                handle.settled = True
                if value_available:
                    handle.acquired = True
                    handle.value = value

    def on_client_leave(self, client_id: str, seq: int) -> None:
        # Re-queue everything the departed client had acquired (removeClient).
        for aid, (value, holder) in list(self.job_tracking.items()):
            if holder == client_id:
                del self.job_tracking[aid]
                self.data.append(value)

    def summarize(self) -> dict[str, Any]:
        return {"data": list(self.data), "jobs": {k: list(v) for k, v in self.job_tracking.items()}}

    def load(self, summary: dict[str, Any]) -> None:
        self.data = list(summary["data"])
        self.job_tracking = {k: (v[0], v[1]) for k, v in summary["jobs"].items()}


# ---------------------------------------------------------------------------
# ConsensusRegisterCollection
# ---------------------------------------------------------------------------

ATOMIC = "atomic"
LWW = "lww"


@dataclass
class _Register:
    atomic_value: Any
    atomic_seq: int
    versions: list[tuple[int, Any]] = field(default_factory=list)  # (seq, value)


class ConsensusRegisterCollection(_VerbatimResubmitChannel):
    """Per-key register keeping concurrent versions
    (consensusRegisterCollection.ts processInboundWrite:352):

    - a write carries the refSeq AT CREATION; it wins (updates the atomic
      value) iff refSeq >= the current atomic write's seq (the writer knew
      the latest state);
    - versions the writer had seen (seq <= refSeq) are superseded/dropped;
      the new write is appended — so `versions` holds exactly the writes
      still mutually concurrent.
    """

    channel_type = "consensusRegisterCollection"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.data: dict[str, _Register] = {}
        self._write_results: dict[int, bool] = {}
        self._next_write = 0

    def write(self, key: str, value: Any) -> int:
        """Submit a write; returns a write id whose outcome (did it become
        the atomic value?) is readable after sequencing via write_result."""
        self._next_write += 1
        # refSeq at creation rides IN the op: on resubmit the envelope refSeq
        # advances but the conflict rule must use the original knowledge
        # point (consensusRegisterCollection.ts:70-73,302).
        ref_seq = self._connection.ref_seq() if self._connection else 0
        self.submit_local_message(
            {"type": "write", "key": key, "value": value, "refSeq": ref_seq},
            {"writeId": self._next_write},
        )
        return self._next_write

    def write_result(self, write_id: int) -> bool | None:
        return self._write_results.get(write_id)

    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        for m in collection.messages:
            op = m.contents
            assert op["type"] == "write"
            is_winner = self._process_write(op["key"], op["value"], op["refSeq"], env.seq)
            if m.local:
                self._write_results[m.local_metadata["writeId"]] = is_winner

    def _process_write(self, key: str, value: Any, ref_seq: int, seq: int) -> bool:
        reg = self.data.get(key)
        is_winner = reg is None or ref_seq >= reg.atomic_seq
        if reg is None:
            reg = _Register(atomic_value=value, atomic_seq=seq)
            self.data[key] = reg
        elif is_winner:
            reg.atomic_value, reg.atomic_seq = value, seq
        # Drop versions the writer had seen; append the new one.
        reg.versions = [(s, v) for s, v in reg.versions if s > ref_seq]
        reg.versions.append((seq, value))
        return is_winner

    def read(self, key: str, policy: str = ATOMIC) -> Any:
        reg = self.data.get(key)
        if reg is None:
            return None
        if policy == ATOMIC:
            return reg.atomic_value
        return reg.versions[-1][1]  # LWW: latest concurrent version

    def read_versions(self, key: str) -> list[Any]:
        reg = self.data.get(key)
        return [v for _s, v in reg.versions] if reg else []

    def keys(self) -> list[str]:
        return list(self.data)

    def apply_stashed(self, contents: Any) -> Any:
        # Mint a fresh writeId so the ack path can record the outcome; the
        # original promise is gone with the stashed session (ref
        # consensusRegisterCollection.ts:434).
        self._next_write += 1
        return {"writeId": self._next_write}

    def summarize(self) -> dict[str, Any]:
        return {
            k: {"atomic": [r.atomic_seq, r.atomic_value], "versions": [list(t) for t in r.versions]}
            for k, r in self.data.items()
        }

    def load(self, summary: dict[str, Any]) -> None:
        for k, e in summary.items():
            self.data[k] = _Register(
                atomic_value=e["atomic"][1],
                atomic_seq=e["atomic"][0],
                versions=[(s, v) for s, v in e["versions"]],
            )


# ---------------------------------------------------------------------------
# TaskManager
# ---------------------------------------------------------------------------

class TaskManager(_VerbatimResubmitChannel):
    """Distributed task election (taskManager.ts): per-task FIFO queue of
    volunteering clients; the queue head is the assignee. Consensus-gated —
    assignment changes only on sequenced ops or sequenced leaves."""

    channel_type = "taskManager"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.queues: dict[str, list[str]] = {}
        # task -> (seq, completer client id) of its latest COMPLETE: a
        # volunteer authored before seeing the completion (ref_seq < that
        # seq) is dropped on every replica — an in-flight volunteer racing
        # a complete must not resurrect the finished task as a zombie
        # assignee. Two exemptions keep deliberate restarts working: the
        # COMPLETER's own volunteers (it has seen its completion by
        # definition, even before the ack), and any volunteer sent after
        # seeing the completion.
        self.completed_at: dict[str, tuple[int, str]] = {}
        # Tasks THIS instance has completed (local knowledge: flags its own
        # post-completion volunteers as deliberate restarts).
        self._locally_completed: set[str] = set()
        # (task_id, current_assignee | None, reason) after every sequenced
        # queue mutation — the hook the agent-scheduler layer drives
        # workers from. Fires on ANY membership change (not just head
        # changes), so a scheduler can notice its own eviction (reconnect
        # under a new id) even while another client holds the task. The
        # reason distinguishes a COMPLETED task (queue cleared for good)
        # from ordinary churn.
        self.assignment_listeners: list = []

    def _notify(self, task_id: str, reason: str = "change") -> None:
        after = self.assignee(task_id)
        for fn in list(self.assignment_listeners):
            fn(task_id, after, reason)

    def volunteer(self, task_id: str) -> None:
        # The authored refSeq rides the local metadata: resubmission stamps
        # a fresh wire ref_seq, and the tombstone check needs the ORIGINAL
        # perspective to tell a stale replay from a deliberate restart. A
        # volunteer following THIS client's own complete() is a deliberate
        # restart even before the complete acks ("restart" flag — the
        # completer exemption must survive reconnect resubmission, where
        # the client id changes and tomb[1] can no longer match).
        ref = self._connection.ref_seq() if self._connection is not None else 0
        self.submit_local_message(
            {"type": "volunteer", "taskId": task_id},
            {"ref": ref, "restart": task_id in self._locally_completed},
        )

    def abandon(self, task_id: str) -> None:
        self.submit_local_message({"type": "abandon", "taskId": task_id})

    def complete(self, task_id: str) -> None:
        """Only the current assignee may complete (clears the whole queue —
        other volunteers must not pick up a finished task)."""
        if not self.assigned(task_id):
            raise RuntimeError("complete() requires holding the task")
        self._locally_completed.add(task_id)
        self.submit_local_message({"type": "complete", "taskId": task_id})

    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        for m in collection.messages:
            op = m.contents
            queue = self.queues.setdefault(op["taskId"], [])
            if op["type"] == "volunteer":
                tomb = self.completed_at.get(op["taskId"])
                if (
                    tomb is not None
                    and env.ref_seq < tomb[0]
                    and env.client_id != tomb[1]
                ):
                    continue  # authored before seeing the completion
                if env.client_id not in queue:
                    queue.append(env.client_id)
            elif op["type"] == "abandon":
                if env.client_id in queue:
                    queue.remove(env.client_id)
            elif op["type"] == "complete":
                queue.clear()
                self.completed_at[op["taskId"]] = (env.seq, env.client_id)
            else:
                raise ValueError(f"unknown task op {op['type']}")
            self._notify(
                op["taskId"],
                "complete" if op["type"] == "complete" else "change",
            )

    def on_client_leave(self, client_id: str, seq: int) -> None:
        for task_id, queue in self.queues.items():
            if client_id in queue:
                queue.remove(client_id)
                self._notify(task_id)

    def assignee(self, task_id: str) -> str | None:
        queue = self.queues.get(task_id)
        return queue[0] if queue else None

    def assigned(self, task_id: str) -> bool:
        return (
            self._connection is not None
            and self.assignee(task_id) == self._connection.client_id()
        )

    def queued(self, task_id: str) -> bool:
        return (
            self._connection is not None
            and self._connection.client_id() in self.queues.get(task_id, [])
        )

    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        # A replayed volunteer is resubmitted with a FRESH wire ref_seq,
        # which would blind the tombstone's authored-before-completion
        # check: compare the ORIGINAL authored refSeq (ridden in local
        # metadata) instead, and drop the volunteer when the task completed
        # after it was authored — a deliberate post-completion restart has
        # an authored ref at/after the completion and goes through.
        if contents.get("type") == "volunteer":
            tomb = self.completed_at.get(contents.get("taskId"))
            meta = local_metadata or {}
            # No metadata (stashed-op rehydrate drops it) reads as authored
            # ref 0: conservatively stale — a stashed volunteer surviving
            # into a completed task is a replay, never a restart.
            authored = meta.get("ref", 0)
            if tomb is not None and authored < tomb[0] and not meta.get("restart"):
                return
        super().resubmit(contents, local_metadata, squash)

    def on_min_seq(self, min_seq: int) -> None:
        # A completion below the collab-window floor can never race a live
        # volunteer (its ref_seq would be >= min_seq): drop the tombstone.
        self.completed_at = {
            t: e for t, e in self.completed_at.items() if e[0] > min_seq
        }

    def summarize(self) -> dict[str, Any]:
        return {
            "queues": {k: list(v) for k, v in self.queues.items()},
            "completedAt": {t: list(e) for t, e in self.completed_at.items()},
        }

    def load(self, summary: dict[str, Any]) -> None:
        self.queues = {k: list(v) for k, v in summary["queues"].items()}
        self.completed_at = {
            # Pre-(seq, clientId) summaries stored a bare int seq.
            t: (e, "") if isinstance(e, int) else (e[0], e[1])
            for t, e in summary.get("completedAt", {}).items()
        }


# ---------------------------------------------------------------------------
# PactMap
# ---------------------------------------------------------------------------

@dataclass
class _Pact:
    accepted_value: Any = None
    accepted_seq: int = -1
    has_accepted: bool = False
    pending_value: Any = None
    expected_signoffs: list[str] | None = None  # None = nothing pending


class PactMap(_VerbatimResubmitChannel):
    """Consensus key-value (pactMap.ts): a set proposal goes "pending" and
    becomes "accepted" only once every client connected at proposal time
    has signed off via an accept op (or left). Invalid proposals — made
    without knowledge of the latest accepted value, or while another is
    pending — are dropped on the floor."""

    channel_type = "pactMap"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.values: dict[str, _Pact] = {}

    # ------------------------------------------------------------------- api
    def set(self, key: str, value: Any) -> None:
        pact = self.values.get(key)
        if pact is not None and pact.expected_signoffs is not None:
            return  # a proposal is already pending; ours would be invalid
        ref_seq = self._connection.ref_seq() if self._connection else 0
        self.submit_local_message(
            {"type": "set", "key": key, "value": value, "refSeq": ref_seq}
        )

    def get(self, key: str) -> Any:
        pact = self.values.get(key)
        return pact.accepted_value if pact and pact.has_accepted else None

    def get_pending(self, key: str) -> Any:
        pact = self.values.get(key)
        return pact.pending_value if pact and pact.expected_signoffs is not None else None

    def is_pending(self, key: str) -> bool:
        pact = self.values.get(key)
        return pact is not None and pact.expected_signoffs is not None

    # --------------------------------------------------------------- inbound
    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        for m in collection.messages:
            op = m.contents
            if op["type"] == "set":
                self._handle_set(op["key"], op["value"], op["refSeq"], env.seq)
            elif op["type"] == "accept":
                self._handle_accept(op["key"], env.client_id, env.seq)
            else:
                raise ValueError(f"unknown pact op {op['type']}")

    def _handle_set(self, key: str, value: Any, ref_seq: int, seq: int) -> None:
        pact = self.values.get(key)
        proposal_valid = pact is None or (
            pact.expected_signoffs is None and pact.accepted_seq <= ref_seq
        )
        if not proposal_valid:
            return
        if pact is None:
            pact = _Pact()
            self.values[key] = pact
        # Signoff set = clients connected when the set sequenced, including
        # the proposer (pactMap.ts getSignoffClients).
        pact.pending_value = value
        pact.expected_signoffs = list(self._connection.quorum_members())
        if not pact.expected_signoffs:
            self._settle(pact, seq)
        elif self._connection.client_id() in pact.expected_signoffs:
            # Minted while processing inbound ops: protocol-internal.
            self.submit_local_message({"type": "accept", "key": key}, internal=True)

    def _handle_accept(self, key: str, client_id: str, seq: int) -> None:
        pact = self.values.get(key)
        if pact is None or pact.expected_signoffs is None:
            return  # already settled
        if client_id in pact.expected_signoffs:
            pact.expected_signoffs.remove(client_id)
        if not pact.expected_signoffs:
            self._settle(pact, seq)

    def _settle(self, pact: _Pact, seq: int) -> None:
        pact.accepted_value = pact.pending_value
        pact.accepted_seq = seq
        pact.has_accepted = True
        pact.pending_value = None
        pact.expected_signoffs = None

    def on_client_leave(self, client_id: str, seq: int) -> None:
        for pact in self.values.values():
            if pact.expected_signoffs is not None and client_id in pact.expected_signoffs:
                pact.expected_signoffs.remove(client_id)
                if not pact.expected_signoffs:
                    self._settle(pact, seq)  # accepted at the leave's seq

    def summarize(self) -> dict[str, Any]:
        out = {}
        for k, p in self.values.items():
            out[k] = {
                "accepted": [p.accepted_seq, p.accepted_value] if p.has_accepted else None,
                "pending": (
                    {"value": p.pending_value, "signoffs": p.expected_signoffs}
                    if p.expected_signoffs is not None
                    else None
                ),
            }
        return out

    def load(self, summary: dict[str, Any]) -> None:
        for k, e in summary.items():
            pact = _Pact()
            if e["accepted"] is not None:
                pact.accepted_seq, pact.accepted_value = e["accepted"]
                pact.has_accepted = True
            if e["pending"] is not None:
                pact.pending_value = e["pending"]["value"]
                pact.expected_signoffs = list(e["pending"]["signoffs"])
            self.values[k] = pact


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

SMALL_DDS_FACTORIES: dict[str, ChannelTypeFactory] = {
    cls.channel_type: ChannelTypeFactory(cls)
    for cls in (
        SharedCell,
        SharedCounter,
        ConsensusQueue,
        ConsensusRegisterCollection,
        TaskManager,
        PactMap,
    )
}
