"""Summary records: the scribe's acks and the summary-tree helpers.

``make_scribe_ack``, ``parse_scribe_ack``, ``count_nodes`` and
``materialize`` of ``fluidframework_tpu/runtime/summary.py``, with the
ISummaryTree node builders (``blob``, ``tree``, ``handle``) re-exported
from ``protocol/snapshot_formats.py``.  The rest of that module (the
summarizer election and heuristics, ``SummaryManager``,
``HiddenSummaryManager``) drives the loader and is not ported (ROADMAP
queue 1 item 7).
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
