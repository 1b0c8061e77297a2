"""The port's own copy of ``fluidframework_tpu/utils/id_compressor.py`` (no JAX in it).

Distributed ID compression: session-space ⇄ op-space ⇄ stable UUID.

Reference parity: packages/runtime/id-compressor/src/idCompressor.ts —
``generateCompressedId`` (:152), ``takeNextCreationRange`` (:227),
``finalizeCreationRange`` (:292), ``normalizeToOpSpace`` (:400),
``decompress`` (:479). Semantics reproduced, not structure:

- Each client session owns a random 128-bit *session UUID*. IDs it creates
  are *session-space*: small negative ints ``-genCount`` (the n-th ID the
  session generated), usable immediately while offline/unacked.
- When the client's ops are sequenced, the contained *creation range*
  (sessionId, firstGenCount..lastGenCount) is **finalized** by every replica
  in the same total order, deterministically allocating a *cluster* of
  positive **final IDs** in a shared final space. Clusters over-allocate
  (``cluster_capacity``) so subsequent IDs in the same session usually land
  in the reserved block — enabling *eager finals*: IDs generated after the
  cluster exists can be handed out already-final.
- *Op-space* is what goes on the wire: final if finalized (or eager), else
  the negative local form (interpreted via the op's originating session).
- Every compressed ID decompresses to a *stable ID*: sessionUuid + genCount-1
  (128-bit arithmetic), so identity survives re-compression across sessions.

This is a host-side integer state machine (SURVEY §7): the hot tensor path
stores only the compact final ints.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass, field


def create_session_id() -> str:
    return str(_uuid.uuid4())


def _uuid_to_int(s: str) -> int:
    return _uuid.UUID(s).int


def _int_to_uuid(n: int) -> str:
    return str(_uuid.UUID(int=n & ((1 << 128) - 1)))


@dataclass(frozen=True)
class IdCreationRange:
    """The finalization request carried in an op (ref takeNextCreationRange).

    ``first_gen_count``..``last_gen_count`` inclusive; empty ranges are
    represented by ``None`` (ref ranges with undefined ids).
    """

    session_id: str
    first_gen_count: int
    last_gen_count: int

    @property
    def count(self) -> int:
        return self.last_gen_count - self.first_gen_count + 1


@dataclass
class _Cluster:
    """A reserved block of final IDs owned by one session (ref IdCluster)."""

    session_id: str
    base_final: int  # first final ID of the block
    base_gen_count: int  # genCount aligned with base_final
    capacity: int  # reserved width
    count: int  # finalized width (<= capacity)


@dataclass
class _Session:
    """Per-session finalization state (ref sessions.ts Session)."""

    session_id: str
    uuid_int: int
    clusters: list[_Cluster] = field(default_factory=list)

    def cluster_for_gen(self, gen_count: int) -> _Cluster | None:
        # Clusters are contiguous in genCount order; binary search is
        # unnecessary at host scale (few clusters per session).
        for c in reversed(self.clusters):
            if gen_count >= c.base_gen_count:
                if gen_count < c.base_gen_count + c.capacity:
                    return c
                return None
        return None


class IdCompressor:
    """Session-space ⇄ op-space ⇄ stable-UUID compressor.

    All replicas call ``finalize_creation_range`` in the total op order, so
    final-space allocation is deterministic and identical everywhere.
    """

    DEFAULT_CLUSTER_CAPACITY = 512
    MAX_CLUSTER_SIZE = 2**20  # ref IdCompressor.maxClusterSize

    def __init__(
        self,
        session_id: str | None = None,
        cluster_capacity: int = DEFAULT_CLUSTER_CAPACITY,
    ) -> None:
        if not 0 < cluster_capacity <= self.MAX_CLUSTER_SIZE:
            raise ValueError("invalid cluster capacity")
        self.session_id = session_id or create_session_id()
        self.cluster_capacity = cluster_capacity
        self._gen_count = 0  # IDs generated by the local session
        self._next_range_base = 1  # first genCount of the next creation range
        self._sessions: dict[str, _Session] = {}
        self._next_final = 0  # final-space watermark
        self._final_index: list[_Cluster] = []  # ordered by base_final
        self._local_session = self._session(self.session_id)

    # ------------------------------------------------------------- generation
    def generate_compressed_id(self) -> int:
        """Mint a session-space ID: eager final if the local session's last
        cluster still has reserved room for this genCount, else ``-genCount``
        (ref idCompressor.ts:152)."""
        self._gen_count += 1
        cluster = self._local_session.cluster_for_gen(self._gen_count)
        if cluster is not None:
            return cluster.base_final + (self._gen_count - cluster.base_gen_count)
        return -self._gen_count

    def take_next_creation_range(self) -> IdCreationRange | None:
        """Package unfinalized locally-generated IDs for the outgoing op
        (ref :227). Returns None when nothing new was generated."""
        if self._next_range_base > self._gen_count:
            return None
        rng = IdCreationRange(
            session_id=self.session_id,
            first_gen_count=self._next_range_base,
            last_gen_count=self._gen_count,
        )
        self._next_range_base = self._gen_count + 1
        return rng

    def _last_finalized_gen(self) -> int:
        """Highest locally-generated genCount that has been finalized."""
        if self._local_session.clusters:
            c = self._local_session.clusters[-1]
            return c.base_gen_count + c.count - 1
        return 0

    def untake_creation_range(self, first_gen_count: int) -> None:
        """Return the MOST RECENT taken-but-unshipped range to the pool (a
        rolled-back op whose range would otherwise leave a permanent
        finalization gap).  Only valid LIFO: the range must extend to the
        latest generated id and sit entirely above the finalized
        watermark (a stale call here would poison every replica when the
        next range sequences)."""
        last_finalized = self._last_finalized_gen()
        if not last_finalized < first_gen_count <= self._next_range_base:
            raise ValueError(
                f"untake of range starting {first_gen_count}: next range "
                f"base is {self._next_range_base}, finalized through "
                f"{last_finalized}"
            )
        self._next_range_base = first_gen_count

    def reset_unfinalized_creation_range(self) -> None:
        """Roll the range base back over unfinalized IDs (resubmit path)."""
        self._next_range_base = self._last_finalized_gen() + 1

    # ----------------------------------------------------------- finalization
    def finalize_creation_range(self, rng: IdCreationRange) -> None:
        """Deterministically allocate final IDs for a sequenced range
        (ref :292). MUST be called in total order on every replica."""
        session = self._session(rng.session_id)
        expected = 1
        if session.clusters:
            last = session.clusters[-1]
            expected = last.base_gen_count + last.count
        if rng.first_gen_count != expected:
            raise ValueError(
                f"ranges finalized out of order: expected genCount "
                f"{expected}, got {rng.first_gen_count}"
            )
        remaining = rng.count
        # Fill reserved room in the session's last cluster first.
        if session.clusters:
            last = session.clusters[-1]
            room = last.capacity - last.count
            take = min(room, remaining)
            last.count += take
            remaining -= take
        # Overflow: a fresh cluster at the final-space watermark. If the
        # session's last cluster is ALSO the newest block in final space,
        # extend it in place instead (ref cluster expansion).
        if remaining > 0:
            if (
                session.clusters
                and self._final_index
                and session.clusters[-1] is self._final_index[-1]
            ):
                last = session.clusters[-1]
                grow = remaining + self.cluster_capacity
                last.capacity += grow
                last.count += remaining
                self._next_final += grow
            else:
                base_gen = rng.first_gen_count + (rng.count - remaining)
                cluster = _Cluster(
                    session_id=rng.session_id,
                    base_final=self._next_final,
                    base_gen_count=base_gen,
                    capacity=remaining + self.cluster_capacity,
                    count=remaining,
                )
                self._next_final += cluster.capacity
                session.clusters.append(cluster)
                self._final_index.append(cluster)

    # ---------------------------------------------------------- normalization
    def normalize_to_op_space(self, session_space_id: int) -> int:
        """Session-space → wire form (ref :400). Finalized local IDs become
        final; unfinalized ones stay negative (receiver interprets them
        against this session via the op's originating session id)."""
        if session_space_id >= 0:
            return session_space_id
        gen = -session_space_id
        cluster = self._local_session.cluster_for_gen(gen)
        if cluster is not None and gen < cluster.base_gen_count + cluster.count:
            return cluster.base_final + (gen - cluster.base_gen_count)
        return session_space_id

    def normalize_to_session_space(self, op_space_id: int, origin_session: str) -> int:
        """Wire form → this session's space. Negative IDs are genCounts of
        ``origin_session``; final IDs map back to ``-genCount`` only when the
        local session created them (ref normalizeToSessionSpace)."""
        if op_space_id < 0:
            if origin_session == self.session_id:
                return op_space_id
            gen = -op_space_id
            session = self._sessions.get(origin_session)
            cluster = session.cluster_for_gen(gen) if session else None
            if cluster is None or gen >= cluster.base_gen_count + cluster.count:
                raise ValueError(
                    f"unknown local id {op_space_id} from session {origin_session}"
                )
            return cluster.base_final + (gen - cluster.base_gen_count)
        cluster = self._cluster_of_final(op_space_id)
        if cluster is not None and cluster.session_id == self.session_id:
            return -(cluster.base_gen_count + (op_space_id - cluster.base_final))
        return op_space_id

    # ------------------------------------------------------------ stable IDs
    def decompress(self, session_space_id: int) -> str:
        """Compressed → stable UUID (ref :479): sessionUuid + genCount - 1."""
        if session_space_id < 0:
            gen = -session_space_id
            if gen > self._gen_count:
                raise ValueError(f"unknown local id {session_space_id}")
            base = self._local_session.uuid_int
        else:
            cluster = self._cluster_of_final(session_space_id)
            if cluster is None:
                raise ValueError(f"unknown final id {session_space_id}")
            offset = session_space_id - cluster.base_final
            gen = cluster.base_gen_count + offset
            if offset >= cluster.count:
                # Reserved-but-unfinalized range: valid only for own eager
                # finals that were actually generated.
                if cluster.session_id != self.session_id or gen > self._gen_count:
                    raise ValueError(f"unfinalized final id {session_space_id}")
            base = self._sessions[cluster.session_id].uuid_int
        return _int_to_uuid(base + gen - 1)

    def recompress(self, stable_id: str) -> int:
        out = self.try_recompress(stable_id)
        if out is None:
            raise ValueError(f"unknown stable id {stable_id}")
        return out

    def try_recompress(self, stable_id: str) -> int | None:
        n = _uuid_to_int(stable_id)
        for session in self._sessions.values():
            gen = n - session.uuid_int + 1
            if gen <= 0:
                continue
            if session is self._local_session and gen <= self._gen_count:
                cluster = session.cluster_for_gen(gen)
                if cluster is not None:
                    return cluster.base_final + (gen - cluster.base_gen_count)
                return -gen
            cluster = session.cluster_for_gen(gen)
            if cluster is not None and gen < cluster.base_gen_count + cluster.count:
                return cluster.base_final + (gen - cluster.base_gen_count)
        return None

    # ------------------------------------------------------------ persistence
    def serialize(self, with_session: bool = True) -> dict:
        """Summary form (ref SerializedIdCompressor). Deterministic across
        replicas when ``with_session`` is False (finalized state only)."""
        # Sort + skip cluster-less sessions so the finalized image is
        # byte-identical across replicas regardless of discovery order.
        sessions = sorted(
            (s for s in self._sessions.values() if s.clusters or
             (with_session and s is self._local_session)),
            key=lambda s: s.session_id,
        )
        state = {
            "version": 1,
            "nextFinal": self._next_final,
            "sessions": [
                {
                    "sessionId": s.session_id,
                    "clusters": [
                        {
                            "baseFinal": c.base_final,
                            "baseGenCount": c.base_gen_count,
                            "capacity": c.capacity,
                            "count": c.count,
                        }
                        for c in s.clusters
                    ],
                }
                for s in sessions
            ],
        }
        if with_session:
            state["localSessionId"] = self.session_id
            state["localGenCount"] = self._gen_count
            state["nextRangeBase"] = self._next_range_base
        return state

    @staticmethod
    def deserialize(state: dict, session_id: str | None = None) -> "IdCompressor":
        own = state.get("localSessionId") or session_id or create_session_id()
        c = IdCompressor(session_id=own)
        for s in state["sessions"]:
            session = c._session(s["sessionId"])
            for cl in s["clusters"]:
                cluster = _Cluster(
                    session_id=s["sessionId"],
                    base_final=cl["baseFinal"],
                    base_gen_count=cl["baseGenCount"],
                    capacity=cl["capacity"],
                    count=cl["count"],
                )
                session.clusters.append(cluster)
                c._final_index.append(cluster)
        c._final_index.sort(key=lambda cl: cl.base_final)
        c._next_final = state["nextFinal"]
        c._gen_count = state.get("localGenCount", 0)
        c._next_range_base = state.get("nextRangeBase", c._gen_count + 1)
        return c

    # -------------------------------------------------------------- internals
    def _session(self, session_id: str) -> _Session:
        s = self._sessions.get(session_id)
        if s is None:
            s = _Session(session_id=session_id, uuid_int=_uuid_to_int(session_id))
            self._sessions[session_id] = s
        return s

    def _cluster_of_final(self, final_id: int) -> _Cluster | None:
        # Binary search over the final-space index (ordered, disjoint).
        lo, hi = 0, len(self._final_index)
        while lo < hi:
            mid = (lo + hi) // 2
            c = self._final_index[mid]
            if final_id < c.base_final:
                hi = mid
            elif final_id >= c.base_final + c.capacity:
                lo = mid + 1
            else:
                return c
        return None
