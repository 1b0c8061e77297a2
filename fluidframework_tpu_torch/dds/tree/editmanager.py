"""EditManager: deterministic trunk construction from sequenced commits.

The port's own copy of ``fluidframework_tpu/dds/tree/editmanager.py``:
the port imports nothing of the JAX package, so it keeps the host algebra
here.

Reference parity: tree/src/shared-tree-core/editManager.ts:73 — a trunk of
sequenced commits plus per-peer branches that cache each peer's in-flight
context, with MSN-driven trunk eviction (trimHistory :847,
advanceMinimumSequenceNumber :247).

Design (derived, not ported): for every peer P we simulate P's local branch
— ``base`` is the highest trunk sequence number P has integrated (its last
refSeq) and ``inflight`` holds P's submitted-but-not-yet-base-advanced
commits in P-local coordinates. Because every replica runs this exact
deterministic procedure over the same sequenced stream, every replica
computes the identical trunk version of every commit — convergence by
construction, independent of OT transform properties.

A commit is a LIST of changesets applied atomically (a single edit is a
1-element commit; a transaction is longer — changeset.Commit), so the whole
rebase machinery folds over commit elements.

Integration of a commit c from P (refSeq r, seq s):
1. advance P's branch base to r: walk trunk commits in (base, r]; P's own
   commits must head ``inflight`` (FIFO) and pop; others bridge-transform
   the inflight list (the same sandwich rebase P performed locally).
2. translate c to trunk coordinates: walk trunk commits in (r, s) on a COPY
   of the inflight list (P hasn't seen them): own commits pop from the copy,
   others rebase both the copy and c. FIFO ordering guarantees the copy
   drains exactly when c's turn comes.
3. append the original-coordinates c to P's inflight and the trunk-coords
   version to the trunk.

Revisions are opaque, replica-local hashable tags (the channel layer mints
them through the id-compressor); summaries serialize them through the
``encode_rev``/``decode_rev`` codec so the summary is replica-independent.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .changeset import (
    Commit,
    clone_commit,
    commit_from_json,
    commit_to_json,
    rebase_commit,
)


@dataclass
class TrunkCommit:
    seq: int
    client_id: str
    revision: Any
    change: Commit  # trunk coordinates (context = previous trunk commit)
    # Pooled-mode cache: the same trunk commit extends EVERY peer's
    # translation stream; pooling it once (at integration, when the fold
    # already holds the pooled form) instead of per-peer is sound because
    # rebase outputs depend only on the b-side's STRUCTURE (mark kinds /
    # counts / positions), never on later apply-enrichment of the object
    # form (value-tuple arity, Remove.detached payloads).
    pooled: Any = None


@dataclass
class PeerBranch:
    base: int  # trunk seq this peer has integrated (its max refSeq seen)
    inflight: list[tuple[Any, Commit]] = field(default_factory=list)
    # ---- incremental translation stream (see add_sequenced) ----
    # Trunk seq the stream is current to (>= base; never rewinds).
    pos: int = 0
    # [(trunk_seq, x)]: other peers' trunk commits in (base-ish, pos],
    # each rebased through every one of THIS peer's in-flight commits that
    # was submitted before the trunk commit was integrated (maintained by
    # the fold write-back in add_sequenced).  An incoming commit from this
    # peer translates to trunk coordinates by folding over the (ref, seq]
    # slice of this list — O(window) rebases instead of re-walking the
    # trunk with a cloned in-flight scratch per commit (O(window x
    # inflight) and a full clone, the measured host-translation hotspot).
    xs: list[tuple[int, Commit]] = field(default_factory=list)
    # Post-load residue: in-flight commits integrated by a PREVIOUS
    # incarnation (their write-back state is lost), kept as local-coords
    # clones that stream extension bridges through until their trunk
    # entries are crossed.  Empty in steady state.
    scratch: list[Commit] = field(default_factory=list)
    # Parallel to ``inflight``: each element's fold intermediates
    # [(trunk_seq, commit-at-that-base)] recorded during its integration —
    # the exact values the old per-advance bridge walk recomputed, so
    # ``_advance`` materializes base moves by lookup instead of O(window x
    # inflight) rebases.  ``None`` marks a post-load element (stages lost
    # with the previous incarnation) which forces the legacy bridge walk
    # until it pops.
    stages: list = field(default_factory=list)


def bridge(inflight: list[tuple[Any, Commit]], incoming: Commit) -> tuple[
    list[tuple[Any, Commit]], Commit
]:
    """Transform an incoming commit through a branch's in-flight list: returns
    (inflight rebased over incoming, incoming rebased past the inflight) —
    the standard OT bridge both the EditManager and the local branch use.

    Sides: ``incoming`` is sequenced (earlier) and the in-flight commits are
    not (later), so the in-flight rebases with a_after=True and the incoming
    carries over them with a_after=False — the mirrored pair that makes both
    orders of application converge."""
    x = incoming
    out = []
    for rev, f in inflight:
        out.append((rev, rebase_commit(f, x, a_after=True)))
        x = rebase_commit(x, f, a_after=False)
    return out, x


def bridge_bare(commits: list[Commit], incoming: Commit) -> tuple[
    list[Commit], Commit
]:
    """``bridge`` over a bare Commit list (no revision tags) — the
    post-load scratch residue's fold.  One definition of the mirrored
    rebase pair, shared by stream extension and the compaction-floor
    advance."""
    x = incoming
    out = []
    for f in commits:
        out.append(rebase_commit(f, x, a_after=True))
        x = rebase_commit(x, f, a_after=False)
    return out, x


class EditManager:
    """Trunk + peer branches for one SharedTree instance.

    ``mark_pool`` switches the WHOLE peer-stream state (xs / stages /
    inflight / scratch) to the pooled columnar mark store
    (dds/tree/mark_pool.py): incoming commits pool once at integration,
    the window fold runs as column passes with span reuse for disjoint
    commits, and only the returned trunk commit materializes object marks
    (the caller apply-enriches that clone; pooled spans stay immutable).
    ``None``/falsy keeps the object fold — the byte-identity fuzz oracle.
    Pass a shared ``MarkPool`` so a fleet's gauges aggregate, or ``True``
    for a private pool.

    ``device_rebase`` (requires ``mark_pool``) dispatches each window
    fold's eligible prefix through the rebase window kernel K9
    (dds/tree/device_rebase.py); ineligible or invalidated steps finish
    on the pooled fold, counted in the rebaser's fallback gauges.  Pass
    a shared ``DeviceRebaser`` so a fleet shares one interning table and
    one set of counters (and picks K9's device), or ``True`` for a
    private one on the card."""

    def __init__(
        self,
        encode_rev: Callable[[Any], Any] | None = None,
        decode_rev: Callable[[Any], Any] | None = None,
        mark_pool=None,
        device_rebase=None,
    ) -> None:
        self.trunk: list[TrunkCommit] = []
        self.trunk_base = 0  # all commits with seq <= trunk_base are evicted
        self.peers: dict[str, PeerBranch] = {}
        self._encode_rev = encode_rev or (lambda r: r)
        self._decode_rev = decode_rev or (lambda r: r)
        self.pool = None
        if mark_pool:
            # One import at construction (module handle cached on the
            # instance): the fold calls these per commit per window entry,
            # and a function-local import there pays importlib machinery
            # on the hot path.
            from . import mark_pool as mp

            self._mp = mp
            self.pool = mark_pool if isinstance(mark_pool, mp.MarkPool) \
                else mp.MarkPool()
        self.rebaser = None
        if device_rebase and self.pool is not None:
            from .device_rebase import DeviceRebaser

            self.rebaser = (
                device_rebase if isinstance(device_rebase, DeviceRebaser)
                else DeviceRebaser(self.pool)
            )

    def _pool_commit(self, commit: Commit) -> Commit:
        """Pooled-mode conversion (idempotent); object mode passes through."""
        if self.pool is None:
            return commit
        return self._mp.pool_commit(self.pool, commit)

    def _pooled_trunk(self, t: TrunkCommit) -> Commit:
        """Pooled view of a trunk commit, cached on the commit (one
        conversion shared by every peer stream); object mode passes the
        change through untouched."""
        if self.pool is None:
            return t.change
        if t.pooled is None:
            t.pooled = self._mp.pool_commit(self.pool, t.change)
        return t.pooled

    # ------------------------------------------------------------------ query
    def _trunk_range(self, lo: int, hi: int) -> list[TrunkCommit]:
        """Trunk commits with lo < seq <= hi (retained window only)."""
        assert lo >= self.trunk_base, (
            f"trunk history below {self.trunk_base} was evicted (asked for {lo})"
        )
        return [t for t in self.trunk if lo < t.seq <= hi]

    # -------------------------------------------------------------- integrate
    def add_sequenced(
        self,
        client_id: str,
        revision: Any,
        change: Commit,
        ref_seq: int,
        seq: int,
    ) -> Commit:
        """Integrate one sequenced commit; returns its trunk-coordinates
        version (what a caller applies to trunk-tip state).

        Translation is INCREMENTAL: instead of re-walking the trunk range
        (ref_seq, seq] with a cloned copy of the peer's in-flight list per
        commit (the original O(window x inflight) bridge walk), each peer
        carries a cached translation stream ``xs`` of other peers' trunk
        commits already rebased through this peer's in-flight context.
        The incoming commit folds over the stream's (ref_seq, seq] slice,
        and the fold WRITES BACK the mirrored rebase (the bridge pair) so
        later commits from this peer see its effect — sound because a
        bridge transforms each list prefix independently of its suffix,
        so the cached prefix evolution is exactly what a fresh walk would
        recompute.  Entries at or below the peer's refSeq are dead (per-
        client refSeqs are monotone) and are dropped as the ref advances."""
        br = self.peers.get(client_id)
        if br is None:
            base = max(ref_seq, self.trunk_base)
            br = self.peers[client_id] = PeerBranch(base=base, pos=base)
        # 1. advance the peer's base to its refSeq (in-flight maintenance
        # for summaries and FIFO accounting; unchanged semantics).
        self._advance(client_id, br, ref_seq)
        # 2. extend the translation stream over trunk commits the stream
        # has not consumed.  Grouped batches give several commits one
        # sequence number; earlier same-seq commits from this client were
        # folded into the stream by their own write-back.
        for t in self._trunk_range(br.pos, seq):
            if t.client_id == client_id:
                # Own commit integrated by a previous incarnation (post-
                # load): its local-coords clone leaves the scratch residue
                # exactly when the walk crosses its trunk entry.
                if br.scratch:
                    br.scratch.pop(0)
                continue
            x = self._pooled_trunk(t)
            if br.scratch:
                br.scratch, x = bridge_bare(br.scratch, x)
            br.xs.append((t.seq, x))
        br.pos = max(br.pos, seq)
        assert not br.scratch, "peer had unsequenced ops ahead of this commit"
        # 3. drop stream entries the peer has integrated (ref monotone),
        # then fold the commit over the live slice with bridge write-back.
        xs = br.xs
        drop = 0
        while drop < len(xs) and xs[drop][0] <= ref_seq:
            drop += 1
        if drop:
            del xs[:drop]
        stage_list: list[tuple[int, Commit]] = []
        if self.pool is not None:
            # Pooled fold: both bridge legs come out of mark_pool's fused
            # pair (columnar rebase + identity span reuse for disjoint
            # commits); the peer stream keeps sharing unchanged spans
            # instead of re-materializing every mark per window entry.
            c = self._pool_commit(change)
            if self.rebaser is not None and xs:
                # Device window: eligible prefix in one K9 launch, pooled-
                # fold suffix (byte-identical either way; every host-
                # finished step counted in the rebaser's gauges).
                c, new_xs, stage_vals = self.rebaser.fold(
                    c, [x for _t, x in xs])
                for i in range(len(xs)):
                    xs[i] = (xs[i][0], new_xs[i])
                    stage_list.append((xs[i][0], stage_vals[i]))
            else:
                rebase_pair = self._mp.rebase_pair
                for i in range(len(xs)):
                    tseq, x = xs[i]
                    nxt, xw = rebase_pair(c, x)
                    xs[i] = (tseq, xw)
                    c = nxt
                    stage_list.append((tseq, c))
            ret = self._mp.unpool_commit(c)
            pooled_ret = c
            br.inflight.append((revision, self._pool_commit(change)))
        else:
            c = clone_commit(change)
            for i in range(len(xs)):
                tseq, x = xs[i]
                nxt = rebase_commit(c, x, a_after=True)
                xs[i] = (tseq, rebase_commit(x, c, a_after=False))
                c = nxt
                stage_list.append((tseq, c))
            # The recorded stages share Mark objects with each other AND
            # with the final fold value (rebase's per-field clones are
            # shallow), and the caller apply-ENRICHES the returned trunk
            # commit in place — so the trunk log and caller get a private
            # deep clone, keeping every recorded stage at its unapplied
            # form (what _advance materializes and summarize serializes,
            # exactly as the legacy bridge walk produced).  One clone per
            # commit, not per stage.
            pooled_ret = None
            ret = clone_commit(c) if stage_list else c
            br.inflight.append((revision, clone_commit(change)))
        br.stages.append(stage_list)
        self.trunk.append(TrunkCommit(
            seq=seq, client_id=client_id, revision=revision, change=ret,
            pooled=pooled_ret if self.pool is not None else None,
        ))
        return ret

    def _advance(self, client_id: str, br: PeerBranch, upto: int) -> None:
        """Advance the peer's base: pop own commits the base crosses and
        bring the surviving in-flight values to base coordinates.  Steady
        state materializes each value from its recorded fold stages (the
        bridge walk's exact outputs, captured when they were first
        computed); post-load elements (no stages) force the legacy
        O(window x inflight) bridge walk until they pop."""
        if upto <= br.base:
            return
        rng = self._trunk_range(br.base, upto)
        if any(s is None for s in br.stages):
            for t in rng:
                if t.client_id == client_id:
                    assert br.inflight and br.inflight[0][0] == t.revision, \
                        "peer FIFO skew"
                    br.inflight.pop(0)
                    br.stages.pop(0)
                else:
                    br.inflight, _ = bridge(
                        br.inflight, self._pooled_trunk(t)
                    )
        else:
            moved = False
            for t in rng:
                if t.client_id == client_id:
                    assert br.inflight and br.inflight[0][0] == t.revision, \
                        "peer FIFO skew"
                    br.inflight.pop(0)
                    br.stages.pop(0)
                else:
                    moved = True
            if moved:
                for i, stages in enumerate(br.stages):
                    val = None
                    for tseq, cm in stages:
                        if tseq <= upto:
                            val = cm
                        else:
                            break
                    if val is not None:
                        br.inflight[i] = (br.inflight[i][0], val)
        br.base = max(br.base, upto)

    # -------------------------------------------------------------- lifecycle
    def on_client_leave(self, client_id: str) -> None:
        self.peers.pop(client_id, None)

    def advance_min_seq(self, min_seq: int) -> None:
        """MSN floor advanced: every future refSeq is >= min_seq, so advance
        all peer branches there and evict the trunk prefix (trimHistory)."""
        if min_seq <= self.trunk_base:
            return
        for client_id, br in self.peers.items():
            if br.base < min_seq:
                self._advance(client_id, br, min_seq)
            # Translation-stream floor: every future refSeq from this peer
            # is >= min_seq, so entries at or below it can never be folded
            # again — and the stream position must stay inside retained
            # trunk history.  Skipped commits in (pos, min_seq] would only
            # have produced entries the ref GC dropped immediately.
            drop = 0
            while drop < len(br.xs) and br.xs[drop][0] <= min_seq:
                drop += 1
            if drop:
                del br.xs[:drop]
            if br.pos < min_seq:
                # Advance the stream position over the about-to-be-evicted
                # range.  The x entries it would have produced are dead
                # (all <= min_seq), but a post-load scratch residue still
                # pops/bridges through the range so its coordinates stay
                # consistent for entries beyond the floor.
                if br.scratch:
                    for t in self._trunk_range(br.pos, min_seq):
                        if not br.scratch:
                            break
                        if t.client_id == client_id:
                            br.scratch.pop(0)
                        else:
                            br.scratch, _ = bridge_bare(
                                br.scratch, self._pooled_trunk(t)
                            )
                br.pos = min_seq
        self.trunk = [t for t in self.trunk if t.seq > min_seq]
        self.trunk_base = min_seq

    # ------------------------------------------------------------ checkpoint
    def summarize(self) -> dict[str, Any]:
        """Trunk tail + peer branches (ref editManagerSummarizer.ts) — both
        are required for a loading client to integrate in-flight remote ops
        whose refSeq predates the snapshot sequence number."""
        return {
            "trunkBase": self.trunk_base,
            "trunk": [
                {
                    "seq": t.seq,
                    "client": t.client_id,
                    "rev": self._encode_rev(t.revision),
                    "change": commit_to_json(t.change),
                }
                for t in self.trunk
            ],
            "peers": {
                cid: {
                    "base": br.base,
                    "inflight": [
                        [self._encode_rev(rev), commit_to_json(ch)]
                        for rev, ch in br.inflight
                    ],
                }
                for cid, br in self.peers.items()
            },
        }

    def load(self, data: dict[str, Any]) -> None:
        self.trunk_base = data["trunkBase"]
        self.trunk = [
            TrunkCommit(
                seq=t["seq"],
                client_id=t["client"],
                revision=self._decode_rev(t["rev"]),
                change=commit_from_json(t["change"]),
            )
            for t in data["trunk"]
        ]
        self.peers = {}
        for cid, p in data["peers"].items():
            inflight = [
                (self._decode_rev(rev), self._pool_commit(
                    commit_from_json(ch)
                ))
                for rev, ch in p["inflight"]
            ]
            # The previous incarnation's fold write-back state is not part
            # of the summary; re-seed the stream from the in-flight clones
            # (extension bridges through them until their trunk entries
            # are crossed — the original walk, applied lazily).  Pooled
            # mode shares the immutable spans instead of cloning.
            self.peers[cid] = PeerBranch(
                base=p["base"],
                inflight=inflight,
                pos=p["base"],
                scratch=(
                    [ch for _rev, ch in inflight] if self.pool is not None
                    else [clone_commit(ch) for _rev, ch in inflight]
                ),
                stages=[None] * len(inflight),
            )
