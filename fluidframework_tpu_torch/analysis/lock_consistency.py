"""Pass 9 — lock-consistency: lockset-style guard checking.

The threads pass (pass 5) catches the *unlocked* thread-side write that
non-thread code also touches.  This pass catches the subtler siblings: a
shared attribute guarded by lock A at one write site and lock B — or
nothing — at another.  Both sites look "locked enough" in review; at
runtime they exclude nobody.  The classic way this arises here: a counter
written under ``self._lock`` by a drain thread, then reset by a
supervisor helper that forgot the lock.

Mechanics (per module, on the shared ``core`` walkers — same entry
discovery as the threads pass):

1. **Entries** — thread entries (Thread/Timer/executor/handler bodies)
   plus every function with no same-module caller (the module's public
   surface); callees inherit the exact held-lock SET along call edges.
2. **Sites** — attribute writes attributed to an owning class (``self.X``
   or a locally-typed var), ``__init__`` exempt (init-before-start).  A
   site observed under several reach contexts keeps each context's held
   set; its *guard* is their intersection (always-held locks only).
3. **Finding** — ``lock-inconsistent-guard``: an attribute with at least
   one thread-reachable write site and no ONE lock common to every write
   site, while at least one site IS guarded.  An unlocked
   thread-reachable site is excluded only when the threads pass already
   owns it (the attribute is also touched by non-thread code) — a
   locked-vs-unlocked race between two *threads* has no non-thread
   toucher and fires HERE, not nowhere.

Reads are deliberately out of scope (the lock-free stale-read of a
monotonic counter is a sanctioned idiom in this codebase — see
``Deployment._stopping``); writes are where torn state comes from.
"""

from __future__ import annotations

import ast

from .core import (
    Finding,
    LockFlowScan,
    LockNamer,
    ModuleView,
    PackageIndex,
    local_types,
    walk_lock_flow,
)
from .threads import local_resolver, thread_entries


def run(index: PackageIndex,
        concurrency_scope: dict | None) -> list[Finding]:
    cfg = concurrency_scope or {}
    shared = frozenset(cfg.get("shared_locks", []))
    findings: list[Finding] = []
    for mod in index.modules:
        view = ModuleView(mod)
        t_entries = thread_entries(view)
        if not t_entries:
            continue

        namer = LockNamer(shared)
        cache: dict = {}

        def make_scan(key, held, view=view, namer=namer, cache=cache,
                      mod=mod):
            ck = (key, held)
            if ck in cache:
                return cache[ck]
            fn = view.functions.get(key)
            if fn is None:
                cache[ck] = None
                return None
            types = local_types(fn, view)
            scan = LockFlowScan(
                fn, held, namer, modname=mod.modname,
                class_name=key.class_name, types=types,
                resolver=local_resolver(view, key, types),
            ).run()
            cache[ck] = scan
            return scan

        # One direct unlocked scan per function doubles as (a) the
        # call-graph probe for the no-caller entry set and (b) the walk's
        # cached base contexts — no separate probe walk.
        called: set = set()
        for key in view.functions:
            scan = make_scan(key, frozenset())
            if scan is not None:
                called.update(c for c, _h, _l in scan.edges)
        entries = list(t_entries) + [
            k for k in view.functions if k not in called
        ]

        scans = walk_lock_flow(
            [(k, frozenset()) for k in entries], make_scan
        )

        # Thread-reachable closure: BFS over the edges the walk already
        # collected, seeded by the thread entries (a third walk would
        # recompute the same scans).
        thread_keys: set = set(t_entries)
        stack = list(t_entries)
        while stack:
            k = stack.pop()
            for scan in scans.get(k, {}).values():
                if scan is None:
                    continue
                for callee, _h, _l in scan.edges:
                    if callee not in thread_keys:
                        thread_keys.add(callee)
                        stack.append(callee)

        # Attribute touches from NON-thread code — the threads pass's
        # precondition, mirrored so the two passes split the space
        # exactly: its finding requires an outside toucher; ours takes
        # over when there is none.
        outside: dict = {}
        for fn_key, fn in view.functions.items():
            if fn_key in thread_keys or fn_key.name == "__init__":
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute):
                    is_self = (isinstance(node.value, ast.Name)
                               and node.value.id == "self")
                    outside.setdefault(node.attr, []).append(
                        (fn_key, is_self))

        def threads_pass_owns(owner: str, attr: str) -> bool:
            return any(
                not is_self or fk.class_name == owner
                for fk, is_self in outside.get(attr, [])
            )

        # (owner_class, attr) -> {(fn_key, line): [held, ...]}
        sites: dict = {}
        for key, ctxs in scans.items():
            if key.name == "__init__":
                continue
            for scan in ctxs.values():
                if scan is None:
                    continue
                for attr, line, held, _is_self, owner in scan.writes:
                    if owner is None:
                        continue
                    sites.setdefault((owner, attr), {}).setdefault(
                        (key, line), []
                    ).append(held)

        for (owner, attr), by_site in sorted(
            sites.items(), key=lambda kv: (kv[0][0], kv[0][1])
        ):
            if len(by_site) < 2:
                continue
            if not any(k in thread_keys for (k, _l) in by_site):
                continue
            # Guard per site: locks held on EVERY reach context.
            guards = {
                site: frozenset.intersection(*map(frozenset, helds))
                for site, helds in by_site.items()
            }
            if not any(guards.values()):
                continue  # fully unlocked attr: the threads pass's beat
            # Exclude the sites the threads pass already owns
            # (thread-reachable + unlocked + touched by non-thread code);
            # what remains must agree.
            considered = {
                site: g for site, g in guards.items()
                if g or site[0] not in thread_keys
                or not threads_pass_owns(owner, attr)
            }
            if len(considered) < 2:
                continue
            if frozenset.intersection(*considered.values()):
                continue  # one common lock guards every site
            locked = [(s, g) for s, g in sorted(
                considered.items(), key=lambda kv: kv[0][1]) if g]
            odd = [(s, g) for s, g in sorted(
                considered.items(), key=lambda kv: kv[0][1]) if not g]
            (a_site, a_guard) = locked[0]
            if odd:
                (b_site, b_guard) = odd[0]
            else:
                # >= 3 sites can be pairwise-overlapping yet share no ONE
                # lock; fall back to the last site for the witness pair.
                (b_site, b_guard) = next(
                    ((s, g) for s, g in locked[1:] if not (g & a_guard)),
                    locked[-1],
                )
            a_lock = "+".join(sorted(a_guard))
            b_lock = "+".join(sorted(b_guard)) if b_guard else "no lock"
            findings.append(Finding(
                rule="lock-inconsistent-guard",
                file=mod.rel, line=b_site[1],
                message=(
                    f"`.{attr}` of {owner} is written under `{a_lock}` by "
                    f"{a_site[0].label()} (line {a_site[1]}) but under "
                    f"{b_lock} by {b_site[0].label()} (line {b_site[1]}) — "
                    "the two sites exclude nobody"
                ),
                hint=(
                    "guard every write to the attribute with the SAME "
                    "lock (or baseline with a rationale if one side is "
                    "provably quiescent)"
                ),
                detail=(
                    f"{owner}.{attr}: guarded by {a_lock} vs "
                    f"{b_lock}"
                ),
            ))
    return findings
