"""Host-side op staging for the megastep pipeline.

Counterpart of ``fluidframework_tpu/models/staging.py``:

- ``RowQueue``: the columnar per-document pending-op queue (numpy, a copy
  of the reference's).
- ``OverloadGate``: per-doc ingest watermark hysteresis (a copy).
- ``warmup_depths``: the megastep depths an engine's ``warmup`` dispatches.
- ``StagingRing``: a ring of preallocated [K, D, B] op/payload staging
  buffers.  Where the reference calls ``jax.device_put``, the buffers are
  pinned host memory (when the ring targets a CUDA device) and the upload
  is a ``non_blocking`` copy on the current stream; a CUDA event recorded
  after the copy is the reuse barrier, so the host never refills memory an
  in-flight copy may still read.  On the CPU the upload clones, so a
  staged buffer never aliases a dispatched tensor.  Each upload is an
  ``upload`` flight-recorder span (host issue of the copy: the copy itself
  runs on the stream).  On a rank mesh every rank packs the same whole
  [K, D, B] ring and uploads only its own rows' slice
  (``upload(..., rows=(lo, hi))``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..observability.flight_recorder import span


class RowQueue:
    """Columnar per-document pending-op queue: one [N, F] op-row array and
    one [N, L] payload array with head/tail cursors.  ``take`` returns
    views valid until the next append/extend (callers copy out)."""

    __slots__ = ("ops", "payloads", "head", "tail")

    def __init__(self, op_fields: int, payload_len: int, capacity: int = 0) -> None:
        self.ops = np.empty((capacity, op_fields), np.int32)
        self.payloads = np.empty((capacity, payload_len), np.int32)
        self.head = 0
        self.tail = 0

    def __len__(self) -> int:
        return self.tail - self.head

    def __bool__(self) -> bool:
        return self.tail > self.head

    def _room(self, n: int) -> None:
        cap = self.ops.shape[0]
        if self.tail + n <= cap:
            return
        live = self.tail - self.head
        if live + n <= cap and self.head >= live + n:
            # Shifting beats growing: reclaim the drained prefix in place.
            self.ops[:live] = self.ops[self.head : self.tail]
            self.payloads[:live] = self.payloads[self.head : self.tail]
        else:
            new_cap = max(16, cap)
            while new_cap < live + n:
                new_cap *= 2
            ops = np.empty((new_cap, self.ops.shape[1]), np.int32)
            pay = np.empty((new_cap, self.payloads.shape[1]), np.int32)
            ops[:live] = self.ops[self.head : self.tail]
            pay[:live] = self.payloads[self.head : self.tail]
            self.ops, self.payloads = ops, pay
        self.head, self.tail = 0, live

    def extend_rows(self, rows) -> None:
        """Land a small list of (op_row, payload_row) pairs."""
        n = len(rows)
        if not n:
            return
        self._room(n)
        t = self.tail
        for op, payload in rows:
            self.ops[t] = op
            self.payloads[t] = payload
            t += 1
        self.tail = t

    def extend_block(self, ops: np.ndarray, payloads: np.ndarray) -> None:
        """Land [M, F] / [M, L] row blocks as two slice copies."""
        m = ops.shape[0]
        if not m:
            return
        self._room(m)
        self.ops[self.tail : self.tail + m] = ops
        self.payloads[self.tail : self.tail + m] = payloads
        self.tail += m

    def take(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Dequeue ``n`` rows as views (copy out before the next append)."""
        h = self.head
        self.head = h + n
        return self.ops[h : h + n], self.payloads[h : h + n]

    def pending(self) -> tuple[np.ndarray, np.ndarray]:
        """Views of everything queued (watermark accounting)."""
        return self.ops[self.head : self.tail], self.payloads[self.head : self.tail]

    def clear(self) -> None:
        """Drop every pending row."""
        self.head = self.tail = 0


class OverloadGate:
    """Per-doc ingest watermark hysteresis (credit-based flow control): a
    doc whose queue depth reaches ``high`` pauses until it drains to
    ``low``."""

    __slots__ = ("high", "low", "paused", "events")

    def __init__(self, high: int, low: int) -> None:
        if not 0 < low < high:
            raise ValueError(f"watermarks must satisfy 0 < low < high, got {low}, {high}")
        self.high = high
        self.low = low
        self.paused: set[int] = set()
        self.events = 0

    def update(self, busy, depth_of) -> tuple[list[int], list[int]]:
        """-> (newly paused docs, newly resumed docs)."""
        to_pause = [
            d for d in busy
            if d not in self.paused and depth_of(d) >= self.high
        ]
        for d in to_pause:
            self.paused.add(d)
        self.events += len(to_pause)
        to_resume = [d for d in self.paused if depth_of(d) <= self.low]
        for d in to_resume:
            self.paused.discard(d)
        return to_pause, to_resume

    def watermarks(self, megastep_budget: int) -> dict:
        """The flow-control contract numbers (``ingest_watermarks``)."""
        return {"megastep_budget": megastep_budget, "high": self.high, "low": self.low}

    def emit_gauges(self, counters, megastep_budget: int, queue_depth_max: int) -> None:
        """The health() surface of the gate: is any doc over its watermark,
        how many, how deep, and how many pause transitions so far."""
        counters.gauge("megastep_budget", megastep_budget)
        counters.gauge("overload", int(bool(self.paused)))
        counters.gauge("overloaded_docs", len(self.paused))
        counters.gauge("overload_events", self.events)
        counters.gauge("queue_depth_max", queue_depth_max)


def warmup_depths(megastep_k: int) -> list[int]:
    """Every megastep depth a serving step can dispatch: 1, each power of
    two up to ``megastep_k``, and a non-power-of-two ``megastep_k`` itself
    (``_select_k`` clamps to it)."""
    depths = []
    k = 1
    while k <= megastep_k:
        depths.append(k)
        k *= 2
    if megastep_k > 1 and megastep_k not in depths:
        depths.append(megastep_k)
    return depths


class _StageBuf:
    __slots__ = ("ops_t", "payloads_t", "ops", "payloads", "dirty", "done")

    def __init__(self, shape_ops, shape_payloads, pin: bool) -> None:
        self.ops_t = torch.zeros(shape_ops, dtype=torch.int32, pin_memory=pin)
        self.payloads_t = torch.zeros(shape_payloads, dtype=torch.int32, pin_memory=pin)
        # numpy views of the same (pinned) memory: the host packs through
        # these, the upload copies from the tensors.
        self.ops = self.ops_t.numpy()
        self.payloads = self.payloads_t.numpy()
        self.dirty: list[tuple[int, np.ndarray]] = []
        self.done = None  # CUDA event recorded after this buffer's upload


class StagingRing:
    """A depth-N ring of reusable [K, D, B] op/payload staging buffers.

    Per megastep::

        ops, payloads = ring.acquire(k, rows)   # zeroed numpy views
        ...fill slices, ring.mark(k, written_rows) per slice...
        dev_ops, dev_payloads = ring.upload(ops, payloads)
    """

    def __init__(self, k_max: int, rows: int, batch: int, op_fields: int,
                 payload_len: int, device: torch.device, depth: int = 2) -> None:
        self.device = device
        self.k_max = max(1, int(k_max))
        pin = device.type == "cuda"
        shape_ops = (self.k_max, rows, batch, op_fields)
        shape_pay = (self.k_max, rows, batch, payload_len)
        self._bufs = [_StageBuf(shape_ops, shape_pay, pin) for _ in range(depth)]
        self._i = 0
        self._cur: _StageBuf | None = None
        # Packs whose buffer's previous upload had already drained (no wait).
        self.overlapped_packs = 0

    def acquire(self, k: int, rows: int) -> tuple[np.ndarray, np.ndarray]:
        """A zeroed [k, rows, B, ...] staging view, safe to fill now."""
        buf = self._bufs[self._i]
        self._i = (self._i + 1) % len(self._bufs)
        if buf.done is not None:
            if buf.done.query():
                self.overlapped_packs += 1
            else:
                buf.done.synchronize()
            buf.done = None
        for kk, rr in buf.dirty:
            buf.ops[kk, rr] = 0
            buf.payloads[kk, rr] = 0
        buf.dirty.clear()
        self._cur = buf
        return buf.ops[:k, :rows], buf.payloads[:k, :rows]

    def mark(self, k: int, written_rows) -> None:
        """Record the rows slice ``k`` wrote (cleared on the next reuse)."""
        if len(written_rows):
            self._cur.dirty.append((k, np.asarray(written_rows)))

    def upload(self, ops_view: np.ndarray, payloads_view: np.ndarray, rows=None):
        """Device copies of the filled views of the current buffer; with
        ``rows=(lo, hi)`` only those rows of them (a rank's shard)."""
        buf = self._cur
        k, n = ops_view.shape[:2]
        lo, hi = rows if rows is not None else (0, n)
        ops_t = buf.ops_t[:k, lo:hi]
        pay_t = buf.payloads_t[:k, lo:hi]
        nbytes = (ops_view.nbytes + payloads_view.nbytes) * (hi - lo) // max(n, 1)
        with span("upload", shards=1, bytes=nbytes):
            if self.device.type != "cuda":
                return ops_t.clone(), pay_t.clone()
            dev = (
                ops_t.to(self.device, non_blocking=True),
                pay_t.to(self.device, non_blocking=True),
            )
            buf.done = torch.cuda.Event()
            buf.done.record()
        return dev
