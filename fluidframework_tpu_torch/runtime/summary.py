"""Scribe summary-ack records: the server half of the summary protocol.

``make_scribe_ack`` and ``parse_scribe_ack`` of
``fluidframework_tpu/runtime/summary.py``.  The rest of that module (summary
trees, election, heuristics) is the client runtime, not ported.
"""

from __future__ import annotations

from typing import Any

from ..protocol.messages import MessageType, SequencedMessage

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
