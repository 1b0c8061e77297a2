"""Admission control for the ordering front: load-derived submit nacks.

A port of ``fluidframework_tpu/server/admission.py`` (no JAX in it).

Reference parity: deli's throttling nack path (server/routerlicious deli
lambda submits a ``NackMessage`` with ``retryAfter`` when a tenant/document
exceeds its throughput budget; the client backs off and resubmits).  Here
the front is ``server/netserver.py``: every ``submit`` consults one
:class:`AdmissionController` BEFORE the op reaches the sequencer, and an
overloaded document answers with a nack carrying a load-derived
``retryAfter`` instead of being ticketed — the op is shed at the door, so
the ordering core and its downstream consumers (broadcast fan-out, firehose
fleets, scribes) never buffer unboundedly.

Load signals (both cheap, both observable under the service lock):

- ``pending``: the document's sequencer-side pressure
  (``NetworkServer.doc_pressure``) — the un-broadcast backlog or, on the
  synchronously-broadcasting network front where that stays ~0, the
  uncompacted collab-window depth (seq - MSN): it grows while any
  connected client lags applying and recovers as refSeqs catch up.
- ``consumer_backlog``: the deepest outbound backlog over the document's
  firehose consumers (fan-out frames behind + queued directs,
  ``FanoutPlane.backlog``).  When a device fleet pauses
  a partition at its ingest watermark (credit-based flow control,
  ``FleetConsumer.pump``), the un-drained broadcast backs up HERE — the
  fleet's backpressure propagates to the front without a side channel, and
  the front starts shedding producers for exactly the documents whose
  consumers stopped granting credit.

Hysteresis: a document that crossed the high threshold keeps shedding until
its load falls below ``low_fraction`` of the threshold, so the front does
not flap admit/shed at the boundary.  ``retry_after`` grows with the
overload ratio (capped), so deeper overload pushes clients further out.

``force_overload`` is the server-side chaos hook (testing/chaos.py nack
storms): shed the next N submits unconditionally, deterministically.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AdmissionConfig:
    """Thresholds for the submit admission check (0 disables a signal)."""

    max_pending: int = 4096
    max_consumer_backlog: int = 1024
    low_fraction: float = 0.5
    base_retry_after_s: float = 0.5
    max_retry_after_s: float = 8.0


@dataclass
class _DocAdmission:
    overloaded: bool = False
    shed_ops: int = 0
    overload_events: int = 0
    forced_sheds: int = 0  # chaos: shed the next N submits unconditionally


@dataclass
class AdmissionController:
    config: AdmissionConfig = field(default_factory=AdmissionConfig)
    _docs: dict = field(default_factory=dict)

    def _doc(self, doc_id: str) -> _DocAdmission:
        d = self._docs.get(doc_id)
        if d is None:
            d = self._docs[doc_id] = _DocAdmission()
        return d

    # ------------------------------------------------------------------ admit
    def admit(
        self, doc_id: str, pending: int, consumer_backlog: int
    ) -> float | None:
        """Admission check for one submit: ``None`` admits; a float sheds
        the op and is the ``retryAfter`` (seconds) the nack carries."""
        d = self._doc(doc_id)
        if d.forced_sheds > 0:
            # Chaos nack storm: deterministic, independent of real load.
            d.forced_sheds -= 1
            d.shed_ops += 1
            return self.config.base_retry_after_s
        cfg = self.config
        ratio = 0.0
        if cfg.max_pending > 0 and pending > 0:
            ratio = max(ratio, pending / cfg.max_pending)
        if cfg.max_consumer_backlog > 0 and consumer_backlog > 0:
            ratio = max(ratio, consumer_backlog / cfg.max_consumer_backlog)
        if d.overloaded:
            if ratio < cfg.low_fraction:
                d.overloaded = False  # drained below the low watermark
        elif ratio >= 1.0:
            d.overloaded = True
            d.overload_events += 1
        if not d.overloaded:
            return None
        d.shed_ops += 1
        return min(
            cfg.max_retry_after_s, cfg.base_retry_after_s * max(ratio, 1.0)
        )

    # ------------------------------------------------------------------ chaos
    def force_overload(self, doc_id: str, n_ops: int) -> None:
        """Server-side fault hook: shed the next ``n_ops`` submits for the
        document regardless of load (the chaos controller's nack storm)."""
        self._doc(doc_id).forced_sheds += n_ops

    # ------------------------------------------------------------------ stats
    def overloaded(self, doc_id: str) -> bool:
        d = self._docs.get(doc_id)
        return bool(d is not None and (d.overloaded or d.forced_sheds))

    def doc_stats(self, doc_id: str) -> dict:
        d = self._docs.get(doc_id)
        if d is None:
            return {"overload": 0, "shed_ops": 0}
        return {
            "overload": int(d.overloaded or d.forced_sheds > 0),
            "shed_ops": d.shed_ops,
        }

    def stats(self) -> dict:
        """Aggregate surface for /metrics + /status (graceful-degradation
        visibility: is the front shedding, and how much has it shed)."""
        return {
            "overload": int(any(
                d.overloaded or d.forced_sheds for d in self._docs.values()
            )),
            "overloaded_docs": sum(
                1 for d in self._docs.values()
                if d.overloaded or d.forced_sheds
            ),
            "shed_ops": sum(d.shed_ops for d in self._docs.values()),
            "overload_events": sum(
                d.overload_events for d in self._docs.values()
            ),
        }
