"""Pass 8 — lock-order: static deadlock detection over the lock graph.

The serving tier grew a real concurrency plane: the engines' ``ckpt_lock`` /
``_ckpt_io_lock`` pair, ``netserver``'s service lock feeding the fanout
plane lock, the fanout writer's own lock, the launcher supervisor's
``Deployment._lock``, the failover heartbeat lock.  Every one of those has
a documented acquisition order ("service-lock → plane-lock", "ckpt before
io") that today lives only in comments — one refactor away from an
AB/BA deadlock that presents as a once-a-month wedged fleet.

This pass makes the order machine-checked:

1. **Graph** — package-wide, via the shared ``core`` walkers: an edge
   ``L1 → L2`` exists when lock ``L2`` is acquired (``with``-statement)
   while ``L1`` is held — through ``with``-nesting, self-calls, module
   functions, typed attributes, and cross-module call edges (the held set
   rides the edges, so ``step()`` holding ``ckpt_lock`` and calling into
   ``models/recovery`` which takes ``_ckpt_io_lock`` contributes
   ``ckpt_lock → _ckpt_io_lock``).
2. **Identity** — ``core.LockNamer``: attributes named in layers.json
   ``concurrency_scope.shared_locks`` unify package-wide on their bare
   name (``self.ckpt_lock`` in the engine ≡ ``engine.ckpt_lock`` in the
   recovery plane); everything else is class-qualified so unrelated
   ``_lock`` attributes never collapse into false cycles.
3. **Finding** — ``lock-order-cycle``: any strongly-connected component
   of the graph with ≥2 locks (re-entrant self-acquisition — legal for
   the RLocks this codebase uses — is exempt).  The finding names the
   cycle and one witness acquisition site per edge.

Not modeled (documented limits): ``lock.acquire()`` method calls (the
launcher heartbeat's bounded try-acquire is deliberately not a ``with``),
and the failover lease's O_EXCL *sidecar file* mutex — a cross-process
file, not a ``threading`` lock.
"""

from __future__ import annotations

from .core import (
    Finding,
    LockFlowScan,
    LockNamer,
    PackageIndex,
    PackageView,
    walk_lock_flow,
)


def build_lock_graph(index: PackageIndex, shared_locks) -> dict:
    """-> {(L1, L2): (file, line, func_label)} — one witness per edge."""
    pv = PackageView.of(index)
    namer = LockNamer(frozenset(shared_locks))

    def make_scan(key, held):
        fn = pv.function(key)
        if fn is None:
            return None
        types = pv.fn_local_types(key)
        return LockFlowScan(
            fn, held, namer, modname=key.modname,
            class_name=key.class_name, types=types,
            resolver=lambda call, t=types, k=key: pv.resolve_call(k, t, call),
        ).run()

    entries = [(k, frozenset()) for k in pv.all_functions()]
    scans = walk_lock_flow(entries, make_scan)

    edges: dict = {}
    for key, ctxs in scans.items():
        for scan in ctxs.values():
            if scan is None:
                continue
            rel = pv.views[key.modname].mod.rel
            for lock_id, line, held in scan.acquires:
                for h in held:
                    if h == lock_id:
                        continue  # re-entrant (RLock) self-acquisition
                    edges.setdefault((h, lock_id), (rel, line, key.label()))
    return edges


def _cycles(edges: dict) -> list:
    """Strongly-connected components with >= 2 nodes (Tarjan, iterative)."""
    adj: dict = {}
    for (a, b) in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set())
    index_of: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    for root in sorted(adj):
        if root in index_of:
            continue
        work = [(root, iter(sorted(adj[root])))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index_of:
                    index_of[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(adj[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index_of[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index_of[node]:
                comp = []
                while True:
                    v = stack.pop()
                    on_stack.discard(v)
                    comp.append(v)
                    if v == node:
                        break
                if len(comp) >= 2:
                    sccs.append(sorted(comp))
    return sccs


def run(index: PackageIndex, concurrency_scope: dict | None) -> list[Finding]:
    cfg = concurrency_scope or {}
    shared = cfg.get("shared_locks", [])
    edges = build_lock_graph(index, shared)
    findings: list[Finding] = []
    for comp in _cycles(edges):
        members = set(comp)
        witnesses = sorted(
            (file, line, f"{a} -> {b} in {label}")
            for (a, b), (file, line, label) in edges.items()
            if a in members and b in members
        )
        file, line, _ = witnesses[0]
        cycle = " -> ".join(comp + comp[:1])
        findings.append(Finding(
            rule="lock-order-cycle",
            file=file, line=line,
            message=(
                f"lock acquisition cycle {cycle}: "
                + "; ".join(f"{w[2]} ({w[0]}:{w[1]})" for w in witnesses[:4])
            ),
            hint=(
                "pick ONE global order for these locks and acquire them "
                "in it everywhere (or release the outer lock before "
                "taking the inner one)"
            ),
            detail=f"lock cycle: {cycle}",
        ))
    findings.sort(key=lambda f: (f.file, f.line))
    return findings
