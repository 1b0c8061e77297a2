"""The port's own copy of ``fluidframework_tpu/dds/tree/branch.py`` (no JAX in it).

Local branches over a SharedTree: fork / edit / rebase / merge.

Reference parity: shared-tree-core/branch.ts (SharedTreeBranch —
``branch()``, ``rebaseOnto``, ``merge``) surfaced through the public
``TreeBranch``/``branch()`` API (shared-tree/independentView.ts,
simple-tree TreeBranch). A branch is an isolated line of development:

- ``fork()`` snapshots the parent's current (optimistic) forest;
- edits on the branch apply only to the branch's forest and NEVER ship;
- ``rebase_onto_parent()`` pulls everything the parent applied since the
  fork (remote commits and the parent's own edits alike), rebasing the
  branch's pending commits over it — the same inverse/apply/re-apply
  sandwich the channel runs for in-flight local edits (editmanager.bridge);
- ``merge_into_parent()`` rebases, then replays the branch's commits onto
  the parent inside one atomic transaction (one sequenced commit on the
  wire) and disposes the branch.

Branches nest: a branch exposes the same {forest, applied_log,
submit_change, transaction} surface the channel does, so ``fork()`` of a
branch yields a grandchild with identical semantics.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any

from .changeset import (
    Commit,
    NodeChange,
    apply_commit,
    clone_commit,
    rollback_staged,
)
from .editmanager import bridge
from .forest import Forest, Node, ROOT_FIELD


class TreeBranch:
    """An isolated fork of a SharedTree (channel or another branch)."""

    def __init__(self, parent) -> None:
        self._parent = parent
        self.forest = Forest()
        self.forest.root = parent.forest.root.clone()
        # Parent coordinate trail position this branch has integrated up to.
        self._base = len(parent.applied_log)
        # Branch-local commits, each a Commit (list of NodeChange), in
        # branch-tip coordinates.
        self._commits: list[Commit] = []
        # The branch's own coordinate trail (for nested forks).
        self.applied_log: list[NodeChange] = []
        self._txn: list[NodeChange] | None = None
        self.disposed = False

    # ------------------------------------------------------------ local edits
    def submit_change(self, change: NodeChange) -> None:
        self._check_alive()
        apply_commit(self.forest.root, [change])
        self.applied_log.append(change)
        if self._txn is not None:
            self._txn.append(change)
            return
        self._commits.append([change])

    @contextmanager
    def transaction(self):
        """Atomic scope on the branch: one commit, abort rolls back."""
        self._check_alive()
        if self._txn is not None:
            raise RuntimeError("transactions do not nest")
        self._txn = []
        try:
            yield self
        except BaseException:
            staged, self._txn = self._txn, None
            rollback_staged(self.forest.root, staged, self.applied_log)
            raise
        staged, self._txn = self._txn, None
        if staged:
            self._commits.append(staged)

    @property
    def view(self):
        from .schema import TreeView

        # The document schema lives on the channel at the root of the
        # branch chain; nested branches walk up to it.
        p = self._parent
        while isinstance(p, TreeBranch):
            p = p._parent
        return TreeView(self.forest, self.submit_change, p.schema)

    def fork(self) -> "TreeBranch":
        self._check_alive()
        if self._txn is not None:
            raise RuntimeError("fork inside an open transaction")
        return TreeBranch(self)

    # ---------------------------------------------------------------- rebase
    def rebase_onto_parent(self) -> None:
        """Integrate everything the parent applied since the fork (ref
        branch.ts rebaseOnto): each parent change is bridged over the
        branch's pending commits exactly like a remote trunk commit over the
        channel's in-flight edits."""
        self._check_alive()
        if self._txn is not None:
            raise RuntimeError("rebase inside an open transaction")
        parent_log = self._parent.applied_log
        for change in parent_log[self._base:]:
            pairs = [(i, c) for i, c in enumerate(self._commits)]
            pairs, bridged = bridge(pairs, clone_commit([change]))
            self._commits = [c for _i, c in pairs]
            apply_commit(self.forest.root, bridged)
            self.applied_log.extend(bridged)
        self._base = len(parent_log)

    def merge_into_parent(self) -> None:
        """Rebase onto the parent, then replay the branch's commits on the
        parent atomically (one transaction -> one wire commit when the
        parent is the channel; ref branch.ts merge squash). Disposes the
        branch."""
        self._check_alive()
        if self._txn is not None:
            raise RuntimeError("merge inside an open transaction")
        self.rebase_onto_parent()
        if self._commits:
            # Commits are cleared only after the parent transaction lands:
            # a failure (e.g. parent inside an open transaction) leaves the
            # branch intact for a retry.
            with self._parent.transaction():
                for commit in self._commits:
                    for change in commit:
                        self._parent.submit_change(clone_commit([change])[0])
            self._commits = []
        self.dispose()

    # ------------------------------------------------------------------ misc
    @property
    def has_changes(self) -> bool:
        return bool(self._commits)

    def dispose(self) -> None:
        self.disposed = True

    def _check_alive(self) -> None:
        if self.disposed:
            raise RuntimeError("branch is disposed")
