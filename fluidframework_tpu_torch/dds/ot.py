"""The port's own copy of ``fluidframework_tpu/dds/ot.py`` (no JAX in it).

Operational-transformation DDSes: SharedOT base + a JSON OT type.

Reference parity: the experimental OT family —
``SharedOT`` (experimental/dds/ot/ot/src/ot.ts) keeps a window of sequenced
ops above the MSN and integrates each arrival by TRANSFORMING it over every
sequenced op its sender hadn't seen, then transforms the local pending
queue over it; ``SharedJson1`` (experimental/dds/ot/sharejs/json1/src/
json1.ts) instantiates it with the ot-json1 type.  This is the OTHER merge
model the reference ships beside its CRDTs: state is a plain value, ops
carry intentions, and convergence comes from the transform function's TP1
property rather than from commutative stamps.

``SharedJsonOTChannel`` implements a from-scratch JSON OT type (not a port
of ot-json1): ops are path-addressed ``insert``/``remove``/``replace`` with
list-index transformation (earlier-sequenced sibling inserts/removes shift
later indices; "left" priority for same-index insert ties), subtree-drop
semantics (an op into a concurrently removed or replaced subtree becomes a
no-op), and last-writer-wins for same-path replaces.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any

from ..protocol.channel import Channel, MessageCollection


class SharedOTChannel(Channel):
    """Generic OT channel (ref ot.ts SharedOT): subclasses define
    ``apply_core(state, op) -> state`` and ``transform(input, earlier)``.

    ``None`` is the universal no-op (a transform may annihilate an op)."""

    def __init__(self, channel_id: str, initial: Any = None) -> None:
        super().__init__(channel_id)
        self._global = initial       # result of all sequenced ops
        # Sequenced ops above the MSN: (seq, client, op) — the transform
        # window (ot.ts sequencedOps).
        self._sequenced: deque[tuple[int, str, Any]] = deque()
        # Local pending ops, continuously transformed over arrivals:
        # (local id, current op form).
        self._pending: list[tuple[int, Any]] = []
        self._next_lid = 0

    # ------------------------------------------------------------- OT type
    def apply_core(self, state: Any, op: Any) -> Any:
        raise NotImplementedError

    def transform(self, input_op: Any, earlier: Any) -> Any:
        raise NotImplementedError

    # --------------------------------------------------------------- local
    @property
    def state(self) -> Any:
        """The optimistic local view: global + pending (ot.ts this.local)."""
        s = self._global
        for _lid, op in self._pending:
            if op is not None:
                s = self.apply_core(s, op)
        return s

    def apply(self, op: Any) -> None:
        lid = self._next_lid
        self._next_lid += 1
        self._pending.append((lid, op))
        self.submit_local_message({"op": op}, {"lid": lid})

    # --------------------------------------------------------------- inbound
    def process_messages(self, collection: MessageCollection) -> None:
        env = collection.envelope
        while self._sequenced and self._sequenced[0][0] < env.min_seq:
            self._sequenced.popleft()
        for m in collection.messages:
            op = m.contents["op"]
            # Adjust for sequenced ops the sender hadn't seen (ot.ts:134).
            for seq, client, prior in self._sequenced:
                if env.ref_seq < seq and client != env.client_id:
                    op = self.transform(op, prior)
            self._sequenced.append((env.seq, env.client_id, op))
            if op is not None:
                self._global = self.apply_core(self._global, op)
            if m.local:
                self._pending.pop(0)
            else:
                self._pending = [
                    (lid, self.transform(p, op) if p is not None else None)
                    for lid, p in self._pending
                ]

    # ---------------------------------------------------- reconnect / stash
    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        """Re-stage the CURRENT (continuously transformed) form of the
        pending op — the OT analog of regeneratePendingOp."""
        lid = local_metadata["lid"]
        for got_lid, op in self._pending:
            if got_lid == lid:
                self.submit_local_message({"op": op}, {"lid": lid})
                return
        raise KeyError(f"resubmit for unknown pending op lid={lid}")

    def apply_stashed(self, contents: Any) -> Any:
        lid = self._next_lid
        self._next_lid += 1
        self._pending.append((lid, contents["op"]))
        return {"lid": lid}

    def on_min_seq(self, min_seq: int) -> None:
        while self._sequenced and self._sequenced[0][0] < min_seq:
            self._sequenced.popleft()

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        if self._pending:
            raise RuntimeError("summarize with pending OT ops")
        return {
            "state": self._global,
            "window": [[s, c, op] for s, c, op in self._sequenced],
        }

    def load(self, summary: dict[str, Any]) -> None:
        self._global = summary["state"]
        self._sequenced = deque(
            (s, c, op) for s, c, op in summary.get("window", [])
        )


# ---------------------------------------------------------------------------
# JSON OT type
# ---------------------------------------------------------------------------


def _apply_json(state: Any, op: dict) -> Any:
    """Functional apply: fresh containers along the op's path only."""
    t, path = op["t"], op["p"]

    def walk(node: Any, depth: int) -> Any:
        if depth == len(path) - 1:
            key = path[depth]
            if isinstance(node, list):
                out = list(node)
                if t == "insert":
                    out.insert(key, op["v"])
                elif t == "remove":
                    del out[key]
                else:
                    out[key] = op["v"]
                return out
            out = dict(node)
            if t == "insert" or t == "replace":
                out[key] = op["v"]
            else:
                del out[key]
            return out
        key = path[depth]
        if isinstance(node, list):
            out = list(node)
        else:
            out = dict(node)
        out[key] = walk(out[key], depth + 1)
        return out

    if not path:  # whole-document replace
        return op["v"] if t != "remove" else None
    return walk(state, 0)


def _transform_json(input_op: dict | None, earlier: dict | None) -> dict | None:
    """Transform ``input_op`` to account for ``earlier`` (applied first).

    - earlier REMOVE/REPLACE of a subtree annihilates ops into it (an
      insert at exactly a removed list slot survives — it names a gap, not
      the removed element);
    - earlier list insert/remove at a shared parent shifts later sibling
      indices, with "left" priority for same-index insert ties;
    - same-path replaces: the later-sequenced op wins by applying after.
    """
    if input_op is None or earlier is None:
        return input_op
    ip = list(input_op["p"])
    ep = earlier["p"]
    et, it = earlier["t"], input_op["t"]

    # Subtree annihilation.
    if len(ep) <= len(ip) and ip[: len(ep)] == ep:
        into_subtree = len(ip) > len(ep)
        same_target = len(ip) == len(ep)
        if et == "remove":
            if into_subtree or (same_target and it != "insert"):
                return None
        elif et == "replace" and into_subtree:
            return None
        # (Object-key insert vs a same-key target needs no adjustment: the
        # later-sequenced op simply applies after — LWW by order.)

    # List-index shifts at earlier's parent level.
    if ep and isinstance(ep[-1], int):
        k = len(ep) - 1
        if len(ip) > k and ip[:k] == ep[:k] and isinstance(ip[k], int):
            if et == "insert":
                # Earlier insert at/below the index shifts input right —
                # including the insert-insert tie, where the earlier op
                # keeps "left" and input lands after it.
                if ep[k] <= ip[k]:
                    ip[k] += 1
            elif et == "remove":
                if ep[k] < ip[k]:
                    ip[k] -= 1
    out = dict(input_op)
    out["p"] = ip
    return out


class SharedJsonOTChannel(SharedOTChannel):
    """JSON document over OT (ref SharedJson1 over ot-json1)."""

    channel_type = "sharedJsonOT"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id, initial=None)

    # ------------------------------------------------------------- OT type
    def apply_core(self, state: Any, op: dict) -> Any:
        return _apply_json(state, op)

    def transform(self, input_op, earlier):
        return _transform_json(input_op, earlier)

    # ----------------------------------------------------------- public API
    def get(self) -> Any:
        return self.state

    def at(self, path: list) -> Any:
        node = self.state
        for part in path:
            node = node[part]
        return node

    def insert(self, path: list, value: Any) -> None:
        json.dumps(value)  # wire-serializable guard
        self.apply({"t": "insert", "p": list(path), "v": value})

    def remove(self, path: list) -> None:
        self.apply({"t": "remove", "p": list(path)})

    def replace(self, path: list, value: Any) -> None:
        json.dumps(value)
        self.apply({"t": "replace", "p": list(path), "v": value})


class _JsonOTFactory:
    channel_type = SharedJsonOTChannel.channel_type

    def create(self, channel_id: str) -> SharedJsonOTChannel:
        return SharedJsonOTChannel(channel_id)


SharedJsonOTFactory = _JsonOTFactory()
