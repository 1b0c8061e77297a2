"""Summarization subsystem: incremental summary trees, election, heuristics.

A port of ``fluidframework_tpu/runtime/summary.py`` (no JAX in it): the
scribe's ack records (``make_scribe_ack``, ``parse_scribe_ack``),
``count_nodes`` and ``materialize``, the ISummaryTree node builders
(``blob``, ``tree``, ``handle``) re-exported from
``protocol/snapshot_formats.py``, and the client side: ``SummaryConfig``,
the deterministic ``elected_summarizer`` rule, ``SummaryManager`` and
``HiddenSummaryManager`` (which loads its summarizer client through
``loader.container``).

Reference parity: container-runtime/src/summary/ — ``SummaryManager``
(summaryManager.ts:95) + ``OrderedClientElection`` (orderedClientElection.ts)
pick one client to summarize; ``RunningSummarizer`` (runningSummarizer.ts)
applies op-count/size heuristics; the ``SummarizerNode`` tree walk
(summarizerNode.ts:61) emits HANDLES for subtrees unchanged since the last
acked summary so uploads are incremental; the server side (scribe,
scribe/lambda.ts:65) validates, stores, and acks.
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import MessageType, SequencedMessage
from ..protocol.snapshot_formats import blob, handle, tree  # noqa: F401 (re-export)

# Client id the scribe service stamps on the acks it feeds back through the
# ordered log (ref scribe/lambda.ts emitting summaryAck as a service
# message; never a quorum member, so consumers treat it as protocol-only).
SCRIBE_CLIENT_ID = "__scribe__"


def make_scribe_ack(doc_id: str, seq: int, commit_sha: str) -> SequencedMessage:
    """The summaryAck record the scribe produces back into the ordered log
    once a summary commit is durably stored: every consumer sees, in the
    total order, that state up to ``seq`` is recoverable from
    ``commit_sha`` (boot-from-summary + log compaction both key off it)."""
    return SequencedMessage(
        client_id=SCRIBE_CLIENT_ID, client_seq=0, ref_seq=seq, seq=seq,
        min_seq=0, type=MessageType.SUMMARY_ACK,
        contents={"doc": doc_id, "seq": int(seq), "commit": commit_sha},
    )


def parse_scribe_ack(msg: Any) -> tuple[str, int, str] | None:
    """(doc, seq, commit_sha) when ``msg`` is a scribe summaryAck record;
    None for every other payload (tolerant: the op topic interleaves)."""
    if getattr(msg, "type", None) != MessageType.SUMMARY_ACK:
        return None
    c = getattr(msg, "contents", None)
    if not isinstance(c, dict) or "commit" not in c or "doc" not in c:
        return None
    return str(c["doc"]), int(c["seq"]), str(c["commit"])


def count_nodes(node: dict) -> dict[str, int]:
    """Diagnostic: how many blobs vs handles a summary tree carries (the
    incrementality measure the reference's summary telemetry reports)."""
    out = {"blob": 0, "handle": 0, "tree": 0}
    stack = [node]
    while stack:
        n = stack.pop()
        out[n["type"]] += 1
        if n["type"] == "tree":
            stack.extend(n["entries"].values())
    return out


def materialize(node: dict, prev: dict | None, path: str = "") -> Any:
    """Resolve a summary tree into plain nested content, replacing handle
    nodes with the content at the same path of the previous materialized
    summary (what gitrest does when a summary references parent trees)."""
    kind = node["type"]
    if kind == "blob":
        return node["content"]
    if kind == "tree":
        return {
            name: materialize(child, prev, f"{path}/{name}" if path else name)
            for name, child in node["entries"].items()
        }
    if kind == "handle":
        if node["path"] != path:
            raise ValueError(f"handle path {node['path']!r} at {path!r}")
        if prev is None:
            raise ValueError(f"handle at {path!r} with no previous summary")
        cur = prev
        for part in path.split("/"):
            if not isinstance(cur, dict) or part not in cur:
                raise ValueError(f"previous summary lacks {path!r}")
            cur = cur[part]
        return cur
    raise ValueError(f"unknown summary node type {kind!r}")


# ---------------------------------------------------------------------------
# Client-side manager (election + heuristics + submit)
# ---------------------------------------------------------------------------


class SummaryConfig:
    """RunningSummarizer heuristics knobs (ref ISummaryConfiguration,
    runningSummarizer.ts):

    - ``max_ops``: summarize once this many ops accumulate since the last
      acked summary (ref maxOps);
    - ``max_time_s``: also summarize after this much wall time, provided at
      least ``min_ops`` ops accumulated (ref maxTime/minOpsForLastSummary);
    - ``max_ack_wait_s``: an in-flight summary with no ack/nack after this
      long counts as failed (ref maxAckWaitTime);
    - ``retry_delays``: back-off ladder between failed attempts (ref the
      regular/last-try retry schedule); the ladder caps at its final entry;
    - ``reelection_ops``: with no summary ack for this many ops, election
      rotates to the next client in join order
      (ref summarizerClientElection.ts maxOpsSinceLastSummary).
    """

    def __init__(
        self,
        max_ops: int = 50,
        max_time_s: float | None = None,
        min_ops: int = 1,
        max_ack_wait_s: float = 120.0,
        retry_delays: tuple[float, ...] = (0.0, 5.0, 30.0),
        reelection_ops: int | None = None,
    ) -> None:
        self.max_ops = max_ops
        self.max_time_s = max_time_s
        self.min_ops = min_ops
        self.max_ack_wait_s = max_ack_wait_s
        self.retry_delays = retry_delays
        self.reelection_ops = reelection_ops


# Client-id suffix marking a non-interactive summarizer client: excluded
# from election on every replica (the reference distinguishes summarizer
# clients via IClient.details.capabilities.interactive; a wire-visible id
# suffix is this host plane's deterministic equivalent).
SUMMARIZER_SUFFIX = "/summarizer"


def elected_summarizer(runtime, config: "SummaryConfig") -> str | None:
    """The deterministic election rule every replica runs: interactive
    candidates (summarizer clients excluded) in join order, rotated once
    per reelection window without an acked summary."""
    q = runtime.quorum_table
    candidates = sorted(
        (cid for cid in q if not cid.endswith(SUMMARIZER_SUFFIX)),
        key=lambda cid: q[cid],
    )
    if not candidates:
        return None
    r = config.reelection_ops
    rounds = (runtime.ops_since_summary_ack // r) if r else 0
    return candidates[rounds % len(candidates)]


class SummaryManager:
    """Drives summarization for one container runtime.

    Election (ref OrderedClientElection + SummarizerClientElection): joined
    write clients ordered by short id (join order) are the candidate ring;
    normally the first candidate summarizes.  When no summary has been
    acked for ``reelection_ops`` sequenced ops, every replica
    deterministically advances the election to the next candidate — an
    unresponsive summarizer is walked away from without any extra protocol
    (the shared op counter IS the election clock; the reference encodes the
    same advance in its serialized election state).  The reference spawns a
    hidden summarizer client; here the elected interactive client
    summarizes directly at a moment with no local pending ops — same
    protocol, one process fewer.

    Call ``tick(now)`` from the host loop (the reference wires this to op
    events + timers; tests inject ``now``); it submits at most one summary
    and then waits for the ack/nack — or the ack-wait timeout — before
    trying again, backing off through the retry ladder across failures.
    """

    def __init__(
        self,
        runtime,
        storage,
        config: SummaryConfig | None = None,
        protocol_summarize=None,
        act_as_summarizer: bool = False,
    ) -> None:
        self._runtime = runtime
        self._storage = storage
        self.config = config or SummaryConfig()
        # A spawned hidden summarizer client acts without winning election
        # itself — its PARENT interactive client was elected and delegates
        # (ref summaryManager.ts spawn -> summarizer.ts run).
        self._act_as_summarizer = act_as_summarizer
        self._protocol_summarize = protocol_summarize or (lambda: {})
        self._inflight_handle: str | None = None
        self._inflight_since = 0.0
        self._last_summary_time: float | None = None  # set on first tick
        self._next_attempt_time = 0.0
        self._now = 0.0  # last tick clock, for clock-less ack callbacks
        self.submitted = 0
        self.acked = 0
        self.failures = 0  # consecutive failures (nack / ack timeout)
        runtime.on_summary_ack = self._on_ack
        runtime.on_summary_nack = self._on_nack

    # ------------------------------------------------------------------ state
    def elected_summarizer(self) -> str | None:
        """client id of the current summarizer.

        Deterministic on every replica: candidates in join order, rotated
        once per ``reelection_ops`` window without an acked summary."""
        return elected_summarizer(self._runtime, self.config)

    def is_elected(self) -> bool:
        if self._act_as_summarizer:
            return self._runtime.joined
        return (
            self._runtime.joined
            and self.elected_summarizer() == self._runtime.client_id
        )

    # ------------------------------------------------------------------- tick
    def tick(self, now: float | None = None) -> bool:
        """Summarize if warranted; returns True when a summary was submitted."""
        import time as _time

        now = _time.monotonic() if now is None else now
        self._now = now
        if self._last_summary_time is None:
            self._last_summary_time = now
        if self._inflight_handle is not None:
            if now - self._inflight_since >= self.config.max_ack_wait_s:
                # The ack never came (stalled scribe / dropped op): count a
                # failure and retry through the ladder (ref maxAckWaitTime).
                self._record_failure()
            return False
        if (
            not self.is_elected()
            or self._runtime.pending_op_count > 0
            or now < self._next_attempt_time
        ):
            return False
        ops = self._runtime.ops_since_summary_ack
        due_ops = ops >= self.config.max_ops
        due_time = (
            self.config.max_time_s is not None
            and ops >= self.config.min_ops
            and now - self._last_summary_time >= self.config.max_time_s
        )
        if not (due_ops or due_time):
            return False
        root = tree(
            {
                "runtime": self._runtime.build_summary_tree(),
                "protocol": blob(self._protocol_summarize()),
            }
        )
        h = self._storage.upload_summary(root)
        self._inflight_handle = h
        self._inflight_since = now
        try:
            self._runtime.submit_protocol_message(
                MessageType.SUMMARIZE, {"handle": h, "refSeq": self._runtime.ref_seq}
            )
        except RuntimeError:
            # Connection dropped during flush: the proposal never reached the
            # stream, so no ack/nack will ever clear it — treat as a failure
            # so the elected client can summarize again after reconnect.
            self._record_failure()
            return False
        self.submitted += 1
        return True

    def _record_failure(self) -> None:
        self._inflight_handle = None
        self.failures += 1
        delays = self.config.retry_delays
        delay = delays[min(self.failures - 1, len(delays) - 1)] if delays else 0.0
        self._next_attempt_time = self._now + delay
        # Retry WITHOUT handles: whatever failed to resolve against the
        # previous snapshot will upload as a full blob next time (the
        # reference's safe-retry after summary nack).
        self._runtime.last_summary_ref_seq = None

    def _on_ack(self, contents: dict) -> None:
        if contents.get("handle") == self._inflight_handle:
            self._inflight_handle = None
            self.acked += 1
            self.failures = 0
            self._next_attempt_time = 0.0
            self._last_summary_time = self._now

    def _on_nack(self, contents: dict) -> None:
        if contents.get("handle") == self._inflight_handle:
            self._record_failure()


class HiddenSummaryManager:
    """Summarization through a SPAWNED non-interactive client (ref
    summaryManager.ts:95 spawning the hidden summarizer container,
    summarizer.ts:89).

    The interactive parent watches election; while elected, it keeps a
    second container alive under ``<client>/summarizer`` that does the
    actual summarizing.  The hidden client never carries local pending ops
    — the parent can keep editing (even with unflushed changes) without
    ever blocking a summary, the property the reference spawns a separate
    client for.  Losing election closes the hidden client (its leave
    sequences, releasing its MSN hold)."""

    def __init__(self, parent, doc_id: str, service_factory, registry,
                 config: SummaryConfig | None = None) -> None:
        self._parent = parent
        self._doc_id = doc_id
        self._factory = service_factory
        self._registry = registry
        self.config = config or SummaryConfig()
        self.summarizer = None           # the hidden Container, when alive
        self._inner: SummaryManager | None = None

    # ------------------------------------------------------------------ state
    def parent_elected(self) -> bool:
        rt = self._parent.runtime
        return rt.joined and elected_summarizer(rt, self.config) == rt.client_id

    @property
    def submitted(self) -> int:
        return self._inner.submitted if self._inner else 0

    @property
    def acked(self) -> int:
        return self._inner.acked if self._inner else 0

    # ------------------------------------------------------------------- tick
    def tick(self, now: float | None = None) -> bool:
        from ..loader.container import Container

        if not self.parent_elected():
            self.stop()
            return False
        if self.summarizer is None:
            self.summarizer = Container.load(
                self._doc_id, self._factory, self._registry,
                f"{self._parent.runtime.client_id}{SUMMARIZER_SUFFIX}",
                _summarizer=True,
            )
            self._inner = SummaryManager(
                self.summarizer.runtime,
                self.summarizer._storage,
                config=self.config,
                protocol_summarize=self.summarizer.protocol.summarize,
                act_as_summarizer=True,
            )
        return self._inner.tick(now)

    def stop(self) -> None:
        if self.summarizer is not None:
            self.summarizer.close()
            self.summarizer = None
            self._inner = None
