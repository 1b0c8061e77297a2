"""The port's own copy of ``fluidframework_tpu/dds/tree/shared_tree.py`` (no JAX in it).

SharedTree over the channel boundary.

Reference parity: SharedTreeKernel (tree/src/shared-tree/sharedTree.ts:176)
+ SharedTreeCore (shared-tree-core/sharedTreeCore.ts:92): sequenced edits
flow into the EditManager, the forest tracks trunk-tip state overlaid with
the local branch, resubmit rebases pending edits onto the current trunk
(defaultResubmitMachine.ts), and summaries carry forest + EditManager state
(editManagerSummarizer.ts, forest-summary).

Transactions (ref shared-tree Transactor / branch.ts): edits inside
``with tree.transaction():`` apply optimistically as they are made and ship
as ONE atomic commit on exit; abort rolls the forest back with the
enriched inverses.

Revision ids are compressed (ref id-compressor/src/idCompressor.ts op-space
discipline): each replica mints session-space ids, ships the op-space form
plus its id-creation range on the wire, and every replica finalizes ranges
in total order — so revision tags cost an int on the wire instead of a
UUID, and summaries decompress them to stable UUIDs.

Wire op formats:
  {"type": "edit", "rev": op-space id, "sid": session uuid,
   "idRange": [first, last] | None, "changes": [<changeset json>...]}
  {"type": "schema", "schema": <schema json>}   (LWW by sequence order)
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable

from ...protocol.channel import Channel, MessageCollection
from ...utils.id_compressor import IdCompressor, IdCreationRange
from .changeset import (
    Commit,
    NodeChange,
    apply_commit,
    clone_commit,
    commit_from_json,
    commit_to_json,
    invert_commit,
    rollback_staged,
)
from .editmanager import EditManager, bridge
from .forest import Forest, Node, decode_field_chunked, encode_field_chunked, ROOT_FIELD
from .schema import SchemaRegistry, TreeView


class SharedTreeChannel(Channel):
    """One replica of a SharedTree document."""

    channel_type = "sharedTree"

    def __init__(self, channel_id: str) -> None:
        super().__init__(channel_id)
        self.forest = Forest()  # trunk-tip state + local pending overlay
        # The SEQUENCED state alone (no local overlay): one trunk apply per
        # sequenced commit keeps it current, and it is the exact rebuild
        # base when a constraint violation voids a pending commit (the
        # inverse-rewind shortcut can diverge when LWW suppressed a
        # concurrent value set's repair data) — ref shared-tree trunk vs
        # checkout branch split.
        self._trunk_forest = Forest()
        self.idc = IdCompressor()
        self.em = EditManager(
            encode_rev=self._rev_to_stable, decode_rev=self._rev_from_stable
        )
        self.schema = SchemaRegistry()
        # Local branch: pending commits in trunk-tip coordinates, continuously
        # rebased as remote commits land (the sandwich).
        self._local_pending: list[tuple[Any, Commit]] = []
        self._txn: list[NodeChange] | None = None
        self._txn_constraints: list = []
        self.on_change: Callable[[], None] | None = None  # view invalidation
        # Multiplexed change listeners (simple-tree node events ride these).
        self._change_listeners: list[Callable[[], None]] = []
        # Incremental forest summarization (ref feature-libraries/
        # incrementalSummarizationUtils.ts): the root field summarizes in
        # fixed-size chunks of CHUNK_ROOTS subtrees; this maps chunk index
        # -> seq of the last sequenced change touching it, so summary_tree
        # can emit handles for chunks unchanged since the covered summary.
        self._chunk_seqs: dict[int, int] = {}
        # Every change applied to the forest, in application order (local
        # edits and bridged remote commits alike) — the coordinate trail
        # undo-redo revertibles rebase their inverses over.
        self.applied_log: list[NodeChange] = []

    # ------------------------------------------------------------- revisions
    # A revision tag is the WIRE pair (session uuid, op-space id): identical
    # on every replica, hashable, and comparable without any normalization
    # ordering concerns (the op-space discipline of idCompressor.ts:400).
    # Summaries re-encode tags as stable UUIDs so they stay meaningful after
    # the minting session's clusters are the only thing a loader knows.

    def _rev_to_stable(self, rev: tuple[str, int]) -> str:
        return self.idc.decompress(
            self.idc.normalize_to_session_space(rev[1], rev[0])
        )

    def _rev_from_stable(self, stable: str) -> tuple[str, int]:
        return ("", self.idc.recompress(stable))

    # ------------------------------------------------------------ local edits
    def submit_change(
        self, change: NodeChange, constraints: list | None = None
    ) -> None:
        """Apply a local edit optimistically; ships immediately, or as part
        of the enclosing transaction's atomic commit.  The forest apply
        enriches the change (repair data), and the enriched form is what
        goes on the wire so every replica integrates the exact same
        changeset object.

        ``constraints`` (changeset.node_exists_constraint /
        no_change_constraint): the edit becomes a no-op on EVERY replica if
        a concurrent sequenced change violates one (ref runtime.constraints
        nodeInDocument)."""
        apply_commit(self.forest.root, [change])
        self.applied_log.append(change)
        if self._txn is not None:
            self._txn.append(change)
            if constraints:
                self._txn_constraints.extend(constraints)
            self._notify()
            return
        self._ship_commit(Commit([change], constraints))
        self._notify()

    def _ship_commit(self, commit: Commit) -> None:
        raw = self.idc.generate_compressed_id()
        rng = self.idc.take_next_creation_range()
        rev = (self.idc.session_id, self.idc.normalize_to_op_space(raw))
        self._local_pending.append((rev, commit))
        self.submit_local_message(
            {
                "type": "edit",
                "rev": rev[1],
                "sid": rev[0],
                "idRange": (
                    [rng.first_gen_count, rng.last_gen_count] if rng else None
                ),
                "changes": commit_to_json(commit),
            },
            {"rev": rev},
        )

    # ------------------------------------------------------------ transactions
    @contextmanager
    def transaction(self, constraints: list | None = None):
        """Atomic edit scope: everything submitted inside lands as one
        commit (one sequence number, all-or-nothing against concurrency);
        an exception rolls the forest back and ships nothing.
        ``constraints`` void the whole transaction if violated by a
        concurrent sequenced edit (ref Transactor + runtime.constraints)."""
        if self._txn is not None:
            raise RuntimeError("transactions do not nest")
        self._txn = []
        self._txn_constraints = list(constraints or [])
        try:
            yield self
        except BaseException:
            staged, self._txn = self._txn, None
            rollback_staged(self.forest.root, staged, self.applied_log)
            self._notify()
            raise
        staged, self._txn = self._txn, None
        cons, self._txn_constraints = self._txn_constraints, []
        if staged:
            self._ship_commit(Commit(staged, cons))
        self._notify()

    def set_schema(self, registry: SchemaRegistry) -> None:
        self.schema = registry
        self.submit_local_message(
            {"type": "schema", "schema": registry.to_json()}, {"rev": None}
        )

    def typed_view(self, config) -> "SimpleTreeView":
        """The declarative typed API (ref ITree.viewWith over simple-tree
        schema classes; dds/tree/simple_tree.py SchemaFactory)."""
        from .simple_tree import SimpleTreeView

        return SimpleTreeView(self, config)

    def view_with(self, view_schema: SchemaRegistry):
        """Open the document under the CLIENT's schema (ref ITree.viewWith):
        returns a SchemaView whose .compatibility reports
        {is_equivalent, can_view, can_upgrade} against the stored schema and
        whose .upgrade_schema() ships the view schema when permitted."""
        from .schema import SchemaView

        return SchemaView(self, view_schema)

    def fork(self):
        """Branch the tree at its current (optimistic) state (ref
        branch.ts / TreeBranch): edits on the fork are local-only until
        merge_into_parent ships them as one atomic commit."""
        from .branch import TreeBranch

        if self._txn is not None:
            raise RuntimeError("fork inside an open transaction")
        return TreeBranch(self)

    @property
    def view(self) -> TreeView:
        return TreeView(self.forest, self.submit_change, self.schema)

    def add_change_listener(self, fn: Callable[[], None]) -> Callable[[], None]:
        """Subscribe to every forest change (local or remote); returns the
        unsubscribe handle."""
        self._change_listeners.append(fn)

        def unsubscribe() -> None:  # idempotent (double-off is a no-op)
            if fn in self._change_listeners:
                self._change_listeners.remove(fn)

        return unsubscribe

    def _notify(self) -> None:
        if self.on_change is not None:
            self.on_change()
        for fn in list(self._change_listeners):
            fn()

    # ---------------------------------------------------------------- inbound
    def _finalize_ids(self, c: dict) -> None:
        if c.get("idRange"):
            self.idc.finalize_creation_range(
                IdCreationRange(
                    session_id=c["sid"],
                    first_gen_count=c["idRange"][0],
                    last_gen_count=c["idRange"][1],
                )
            )

    @staticmethod
    def _wire_revision(c: dict) -> tuple[str, int]:
        """Revision tags ARE the wire pair — identical on every replica and
        equal by value across submit/ack/trunk with no normalization races."""
        return (c["sid"], c["rev"])

    def process_messages(self, collection: MessageCollection) -> None:
        if self._txn is not None:
            # The reference's Transactor is synchronous within one JS turn,
            # so sequenced ops can never interleave an open transaction.
            # Enforce the same discipline: the staged edits are not part of
            # _local_pending yet, so bridging an incoming commit here would
            # apply it at coordinates that ignore them (and abort could not
            # restore converged state).
            raise RuntimeError(
                "sequenced ops arrived inside an open transaction — finish "
                "or abort the transaction before pumping the delta stream"
            )
        env = collection.envelope
        for m in collection.messages:
            c = m.contents
            if c["type"] == "schema":
                self.schema = SchemaRegistry.from_json(c["schema"])
                continue
            self._finalize_ids(c)
            rev = self._wire_revision(c)
            change = commit_from_json(c["changes"])
            trunk_change = self.em.add_sequenced(
                client_id=env.client_id,
                revision=rev,
                change=change,
                ref_seq=env.ref_seq,
                seq=env.seq,
            )
            apply_commit(self._trunk_forest.root, clone_commit(trunk_change))
            if m.local:
                # Our own edit reached the trunk: the forest already shows it.
                assert self._local_pending and self._local_pending[0][0] == rev, (
                    "local branch FIFO skew"
                )
                self._local_pending.pop(0)
            else:
                # Sandwich: rebase the local branch over the new trunk commit
                # and apply its bridged form to the optimistic forest.
                had = [
                    getattr(cm, "violated", False)
                    for _r, cm in self._local_pending
                ]
                prev_pending = self._local_pending
                self._local_pending, x = bridge(
                    self._local_pending, clone_commit(trunk_change)
                )
                newly_voided = any(
                    getattr(cm, "violated", False) and not had[i]
                    for i, (_r, cm) in enumerate(self._local_pending)
                )
                if newly_voided:
                    # A constraint of OURS was violated by this concurrent
                    # commit: the optimistic overlay still shows the voided
                    # edit.  Rebuild from the EXACT trunk state (already
                    # advanced past this commit) plus the surviving rebased
                    # pending forms — inverse-rewind shortcuts can diverge
                    # when LWW suppressed a concurrent set's repair data.
                    # The applied_log gets a best-effort inverse trail so
                    # coordinate consumers (undo, tree-agent) keep a
                    # contiguous history.
                    for _rev, cm in reversed(prev_pending):
                        self.applied_log.extend(invert_commit(cm))
                    self.applied_log.extend(clone_commit(trunk_change))
                    self.forest.load_json(self._trunk_forest.to_json())
                    for _rev, cm in self._local_pending:
                        apply_commit(self.forest.root, cm)
                        self.applied_log.extend(cm)
                else:
                    apply_commit(self.forest.root, x)
                    self.applied_log.extend(x)
            # Mark AFTER the forest apply: the dirty range must span the
            # POST-change chunk count (a remote append growing the domain
            # past a chunk boundary must dirty the new tail chunk, or the
            # next summary emits a dangling handle).
            self._mark_chunks_dirty(trunk_change, env.seq)
        self.em.advance_min_seq(env.min_seq)
        self._notify()

    def on_min_seq(self, min_seq: int) -> None:
        self.em.advance_min_seq(min_seq)

    def on_client_leave(self, client_id: str, seq: int) -> None:
        self.em.on_client_leave(client_id)

    # ----------------------------------------------------- reconnect / stash
    def resubmit(self, contents: Any, local_metadata: Any, squash: bool = False) -> None:
        """Resubmit the CURRENT (trunk-tip rebased) form of the pending
        commit — merge-tree regeneratePendingOp's analog for tree edits."""
        if contents["type"] == "schema":
            self.submit_local_message(contents, {"rev": None})
            return
        rev = local_metadata["rev"]
        for r, commit in self._local_pending:
            if r == rev:
                self.submit_local_message(
                    {
                        "type": "edit",
                        "rev": contents["rev"],
                        "sid": contents["sid"],
                        "idRange": contents.get("idRange"),
                        "changes": commit_to_json(commit),
                    },
                    {"rev": rev},
                )
                return
        raise AssertionError(f"resubmit of unknown pending edit {rev}")

    def apply_stashed(self, contents: Any) -> Any:
        if contents["type"] == "schema":
            self.schema = SchemaRegistry.from_json(contents["schema"])
            return {"rev": None}
        commit = commit_from_json(contents["changes"])
        # The stash rides the ORIGINAL session's ids; keep them as the
        # pending key (sid, op-space id) — stable without finalization.
        rev = (contents["sid"], contents["rev"])
        apply_commit(self.forest.root, commit)
        self.applied_log.extend(commit)
        self._local_pending.append((rev, commit))
        self._notify()
        return {"rev": rev}

    def rollback(self, contents: Any, local_metadata: Any) -> None:
        rev = local_metadata["rev"]
        assert self._local_pending and self._local_pending[-1][0] == rev, (
            "rollback must undo the latest local edit first"
        )
        _, commit = self._local_pending.pop()
        inverse = invert_commit(commit)
        apply_commit(self.forest.root, inverse)
        self.applied_log.extend(inverse)
        # The rolled-back op never ships, so its id range must return to the
        # unshipped pool or the NEXT op's range would leave a finalization
        # gap on every replica (LIFO: this was the newest take).
        if contents.get("idRange"):
            self.idc.untake_creation_range(contents["idRange"][0])
        self._notify()

    # ------------------------------------------------------------ checkpoint
    CHUNK_ROOTS = 8  # chunk-domain subtrees per incremental summary chunk

    def _spine(self) -> tuple[list[str], Node]:
        """The incremental chunk DOMAIN: descend from the root field while
        there is exactly one child with exactly one non-empty field — so a
        document shaped as one root array node chunks over its ITEMS, not
        over the single root (the common app shape).  Returns
        (spine field keys, holder): holder.fields[fields[-1]] is the
        chunked children list."""
        holder = self.forest.root
        fields = [ROOT_FIELD]
        while True:
            children = holder.fields.get(fields[-1], [])
            if len(children) != 1:
                return fields, holder
            node = children[0]
            nonempty = [k for k, v in node.fields.items() if v]
            if len(nonempty) != 1:
                return fields, holder
            holder = node
            fields.append(nonempty[0])

    def _mark_chunks_dirty(self, trunk_commit, seq: int) -> None:
        """Chunk-level dirtiness from a sequenced trunk commit, walked down
        the chunk-domain spine: structural marks at a spine level (they can
        reshape the domain) dirty everything; a Modify descends; at the
        final level a Modify dirties its chunk and a structural mark
        dirties its chunk and every one after it (index shifts)."""
        from .changeset import Insert, Modify, Remove, Skip

        fields, holder = self._spine()
        if fields != getattr(self, "_domain_fields", None):
            # Domain reshaped since the last marking: previous chunk
            # indices are meaningless — every chunk re-uploads once.
            self._domain_fields = list(fields)
            self._chunk_seqs = {}
            dirty_all = True  # the loop below marks every current chunk
        else:
            dirty_all = False
        K = self.CHUNK_ROOTS
        n_chunks = max(1, -(-len(holder.fields.get(fields[-1], [])) // K))

        def final_walk(marks) -> tuple[list[int], int | None]:
            pos, points, floor = 0, [], None
            for mk in marks:
                if isinstance(mk, Skip):
                    pos += mk.count
                elif isinstance(mk, Modify):
                    points.append(pos)
                    pos += 1
                elif isinstance(mk, Insert):
                    floor = pos if floor is None else min(floor, pos)
                elif isinstance(mk, Remove):
                    floor = pos if floor is None else min(floor, pos)
                    pos += mk.count
                else:  # MoveOut/MoveIn and anything irregular
                    floor = 0
            return points, floor

        changes = list(trunk_commit)
        for level, fkey in enumerate(fields):
            last = level == len(fields) - 1
            next_changes = []
            for change in changes:
                for key, marks in change.fields.items():
                    if not isinstance(marks, list):
                        # Non-sequence field kinds (optional/value sets)
                        # reshape conservatively: re-upload every chunk.
                        from .field_kinds import kind_of

                        if not kind_of(marks).is_empty(marks):
                            dirty_all = True
                        continue
                    if key != fkey:
                        if marks:
                            dirty_all = True  # off-spine edit reshapes domain
                        continue
                    if last:
                        points, floor = final_walk(marks)
                        for p in points:
                            self._chunk_seqs[p // K] = seq
                        if floor is not None:
                            for k in range(floor // K, n_chunks):
                                self._chunk_seqs[k] = seq
                    else:
                        for mk in marks:
                            if isinstance(mk, Modify):
                                next_changes.append(mk.change)
                            elif not isinstance(mk, Skip):
                                dirty_all = True  # spine structure changed
            if last or dirty_all:
                break
            changes = next_changes
        if dirty_all:
            for k in range(n_chunks):
                self._chunk_seqs[k] = seq

    def _meta_summary(self) -> dict[str, Any]:
        """Everything but the forest — shared by the flat and incremental
        summary paths so the two can never skew."""
        return {
            "editManager": self.em.summarize(),
            "schema": self.schema.to_json(),
            "idCompressor": self.idc.serialize(with_session=False),
        }

    def summarize(self) -> dict[str, Any]:
        if self._local_pending:
            raise RuntimeError("summarize with pending tree edits")
        return {
            "forest": encode_field_chunked(self.forest.root_field),
            **self._meta_summary(),
        }

    def summary_tree(self, covered_seq: int | None, path: str) -> dict[str, Any]:
        """Incremental channel summary (ref incrementalSummarizationUtils):
        the forest splits into root-subtree chunks; chunks unchanged since
        the covered summary emit HANDLES into the previous snapshot instead
        of content.  Safe because any structural root change dirties every
        chunk at/after it, so a clean chunk held identical content at the
        same chunk index in the covered summary."""
        from ...protocol.snapshot_formats import blob, current_format, handle, tree

        if self._local_pending:
            raise RuntimeError("summarize with pending tree edits")
        K = self.CHUNK_ROOTS
        fields, holder = self._spine()
        domain = holder.fields.get(fields[-1], [])
        n_chunks = max(1, -(-len(domain) // K))
        # The OUTER forest: the root field with the chunk-domain children
        # removed (spliced back on load) — tiny, rides in the meta blob.
        holder.fields[fields[-1]] = []
        try:
            outer = encode_field_chunked(self.forest.root_field)
        finally:
            holder.fields[fields[-1]] = domain
        if fields != getattr(self, "_domain_fields", None):
            # The domain differs from the one _chunk_seqs was tracked
            # against (e.g. first summary after load): no handle is safe.
            covered_seq = None
        meta = {
            "type": self.channel_type,
            "fmt": current_format(self.channel_type),
            "summary": {
                **self._meta_summary(),
                "spine": fields,
                "outer": outer,
            },
        }
        chunks: dict[str, Any] = {}
        for k in range(n_chunks):
            chunk_path = f"{path}/forest/{k}"
            if (
                covered_seq is not None
                and self._chunk_seqs.get(k, 0) <= covered_seq
            ):
                chunks[str(k)] = handle(chunk_path)
            else:
                chunks[str(k)] = blob(
                    encode_field_chunked(domain[k * K : (k + 1) * K])
                )
        return tree({"meta": blob(meta), "forest": tree(chunks)})

    def load(self, summary: dict[str, Any]) -> None:
        self.forest.root = Node(type="__root__")
        self.forest.root.fields[ROOT_FIELD] = decode_field_chunked(summary["forest"])
        self._trunk_forest.load_json(self.forest.to_json())
        if "idCompressor" in summary:
            self.idc = IdCompressor.deserialize(summary["idCompressor"])
        self.em = EditManager(
            encode_rev=self._rev_to_stable, decode_rev=self._rev_from_stable
        )
        self.em.load(summary["editManager"])
        self.schema = SchemaRegistry.from_json(summary["schema"])
        self._notify()


def assemble_incremental_summary(
    meta_summary: dict[str, Any], chunk_lists: list[list], fmt: int = 1
) -> dict[str, Any]:
    """Reassemble a flat channel summary from a MATERIALIZED incremental
    tree: splice the concatenated chunk-domain children back into the
    outer forest at the spine's end (inverse of summary_tree's split).

    ``fmt`` is the snapshot format the summary was WRITTEN at; assembly is
    format-aware (it runs before the generic upgrade step, which only sees
    flat summaries) and must return the flat summary at that same format.
    Every shipped format so far shares this layout."""
    if fmt > 1:
        raise ValueError(
            f"unknown incremental sharedTree summary format {fmt}"
        )
    from .forest import decode_field_chunked, encode_field_chunked

    out = dict(meta_summary)
    spine = out.pop("spine")
    outer = out.pop("outer")
    pieces = [piece for chunk in chunk_lists for piece in chunk]
    if len(spine) == 1:
        out["forest"] = pieces  # the domain IS the root field
        return out
    outer_nodes = decode_field_chunked(outer)
    holder = outer_nodes[0]
    for f in spine[1:-1]:
        holder = holder.fields[f][0]
    holder.fields[spine[-1]] = decode_field_chunked(pieces)
    out["forest"] = encode_field_chunked(outer_nodes)
    return out


class _Factory:
    channel_type = SharedTreeChannel.channel_type
    # Registry hook: reassembles a materialized incremental summary into
    # the flat form (datastore dispatches by type, never by shape-sniff).
    assemble_incremental = staticmethod(assemble_incremental_summary)

    def create(self, channel_id: str) -> SharedTreeChannel:
        return SharedTreeChannel(channel_id)


SharedTreeFactory = _Factory()
