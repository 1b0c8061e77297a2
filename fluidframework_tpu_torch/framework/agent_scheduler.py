"""The port's own copy of ``fluidframework_tpu/framework/agent_scheduler.py`` (no JAX in it).

Agent scheduler: exclusive distributed task assignment with handoff.

Reference parity: packages/framework/agent-scheduler —
``AgentScheduler`` (scheduler.ts): clients ``pick`` tasks with a worker
callback; consensus guarantees at most one assignee per task across the
session; when the assignee leaves or releases, the next volunteer's worker
starts (task handoff); ``pickedTasks`` lists what this client currently
runs. The "leader" convention (a well-known task id every client picks)
gives leader election, as the reference's LeaderElection built on it.

Built over the consensus-gated TaskManager DDS (dds/small.py, the
task-queue semantics the reference's scheduler gets from
ConsensusRegisterCollection): this layer adds worker lifecycle — start on
assignment, stop on loss — which is exactly what scheduler.ts adds over
its consensus primitives.
"""

from __future__ import annotations

from typing import Callable

LEADER_TASK = "__leader__"


class AgentScheduler:
    def __init__(self, task_manager) -> None:
        self._tm = task_manager
        # task -> (worker, stop) registered by THIS client.
        self._workers: dict[str, tuple[Callable[[], None], Callable[[], None] | None]] = {}
        self._running: set[str] = set()
        # Tasks with a volunteer op in flight (submitted, not yet observed
        # in the sequenced queue) — prevents duplicate re-volunteers while
        # waiting for our own ack.
        self._pending_volunteer: set[str] = set()
        self._tm.assignment_listeners.append(self._on_assignment)

    # ---------------------------------------------------------------- picking
    def pick(
        self,
        task_id: str,
        worker: Callable[[], None],
        on_lost: Callable[[], None] | None = None,
    ) -> None:
        """Volunteer for ``task_id``; ``worker`` runs when (and each time)
        this client becomes the assignee, ``on_lost`` when assignment is
        taken away (connection loss handoff)."""
        if task_id in self._workers:
            raise ValueError(f"already picked {task_id!r}")
        self._workers[task_id] = (worker, on_lost)
        self._pending_volunteer.add(task_id)
        try:
            self._tm.volunteer(task_id)
        except BaseException:
            # Submission failed (e.g. detached channel): leave no residue —
            # the caller may retry pick() after attaching.
            del self._workers[task_id]
            self._pending_volunteer.discard(task_id)
            raise

    def release(self, task_id: str) -> None:
        """Stop volunteering (ref release): the next volunteer takes over."""
        if task_id not in self._workers:
            raise ValueError(f"never picked {task_id!r}")
        del self._workers[task_id]
        self._running.discard(task_id)
        self._pending_volunteer.discard(task_id)
        self._tm.abandon(task_id)

    def picked_tasks(self) -> list[str]:
        """Tasks this client is CURRENTLY assigned (ref pickedTasks)."""
        return sorted(self._running)

    # ------------------------------------------------------------- leadership
    def volunteer_for_leadership(
        self,
        on_elected: Callable[[], None],
        on_lost: Callable[[], None] | None = None,
    ) -> None:
        self.pick(LEADER_TASK, on_elected, on_lost)

    @property
    def leader(self) -> str | None:
        return self._tm.assignee(LEADER_TASK)

    @property
    def is_leader(self) -> bool:
        return self._tm.assigned(LEADER_TASK)

    # ---------------------------------------------------------------- internal
    def _my_id(self) -> str | None:
        conn = getattr(self._tm, "_connection", None)
        return conn.client_id() if conn is not None else None

    def _on_assignment(
        self, task_id: str, assignee: str | None, reason: str = "change"
    ) -> None:
        if task_id not in self._workers:
            return
        if reason == "complete":
            # The task is FINISHED (complete() clears the queue so nobody
            # picks it up again) — drop it entirely instead of treating the
            # eviction as a reconnect and resurrecting it. No on_lost:
            # normal completion is not a lost assignment. An in-flight
            # volunteer of ours is harmless: the DDS drops volunteers
            # authored before the completion (completed_at tombstone).
            self._running.discard(task_id)
            self._pending_volunteer.discard(task_id)
            del self._workers[task_id]
            return
        queued = self._tm.queued(task_id)
        if queued:
            self._pending_volunteer.discard(task_id)
        mine = assignee is not None and assignee == self._my_id()
        if mine and task_id not in self._running:
            self._running.add(task_id)
            worker, _lost = self._workers[task_id]
            worker()
        elif not mine and task_id in self._running:
            self._running.discard(task_id)
            _worker, lost = self._workers[task_id]
            if lost is not None:
                lost()
        if not mine and not queued and task_id not in self._pending_volunteer:
            # Evicted from the queue entirely — a reconnect sequenced our
            # old identity's leave. Re-volunteer under the current identity
            # (ref scheduler.ts re-pick on reconnect) so picked tasks are
            # never silently lost.
            try:
                self._pending_volunteer.add(task_id)
                self._tm.volunteer(task_id)
            except RuntimeError:
                self._pending_volunteer.discard(task_id)
                # disconnected right now: resume() re-enters later

    def resume(self) -> None:
        """Re-volunteer every picked-but-unqueued task (call after a
        reconnect if no queue event has fired yet)."""
        for task_id in self._workers:
            if (
                not self._tm.queued(task_id)
                and task_id not in self._pending_volunteer
            ):
                try:
                    self._pending_volunteer.add(task_id)
                    self._tm.volunteer(task_id)
                except RuntimeError:
                    self._pending_volunteer.discard(task_id)
