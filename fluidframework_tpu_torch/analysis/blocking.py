"""Pass 10 — blocking-under-lock: slow syscalls inside critical sections.

One law was "durable fsyncs never run under the serving lock"; another
was "signals never write sockets under the service lock".  Both were won
by hand and live in comments.  This pass turns them into configuration:
``analysis/layers.json`` names the *critical locks* — the ones every
serving thread convoys on — and, per lock, the categories of blocking
call that must never execute while it is held.

Categories:

- ``fsync``       — ``os.fsync``/``fdatasync`` (+ configured package IO
  like ``checkpoint_store.save``: one rotational-disk flush under the
  serving lock stalls every ingest behind ~10ms of platter)
- ``sleep``       — ``time.sleep`` and bare ``.sleep()`` methods
- ``subprocess``  — ``subprocess.*`` spawn/communicate
- ``http``        — ``urllib.request.urlopen`` and friends
- ``socket``      — ``send*/recv*/accept/connect`` on sockets (a peer
  with a full kernel buffer blocks the holder indefinitely)
- ``dispatch``    — jitted-program synchronization: ``block_until_ready``,
  ``jax.device_get``, device→host ``np.asarray``

Reach is package-wide via the shared ``core`` walkers: the held set rides
call edges, so ``step()`` taking ``ckpt_lock`` and calling into
``models/recovery`` carries the lock into every function that sweep
touches.  Config (``concurrency_scope`` in layers.json)::

    "critical_locks": [
      {"lock": "ckpt_lock", "deny": ["fsync", "sleep", ...],
       "exempt": ["Class.method"]},
    ],
    "blocking_calls": {"checkpoint_store.save": "fsync"}

``lock`` matches the ``core.LockNamer`` identity (bare name for
``shared_locks`` entries, ``Class.attr`` otherwise); ``exempt`` names
functions whose interior is sanctioned for that lock (reviewed bounded
operations — e.g. a nonblocking wake-pipe write).  ``blocking_calls``
maps dotted call suffixes to a category: the hand-knowledge of which
package APIs block, applied where static typing cannot see through an
attribute chain.  Unknown categories/locks fail loudly — a config typo
must never silently narrow the pass.
"""

from __future__ import annotations

import ast

from .core import (
    Finding,
    LockFlowScan,
    LockNamer,
    PackageIndex,
    PackageView,
    dotted_name,
    resolve,
    walk_lock_flow,
)

CATEGORIES = ("fsync", "sleep", "subprocess", "http", "socket", "dispatch")

_FQ_CALLS = {
    "time.sleep": "sleep",
    "os.fsync": "fsync",
    "os.fdatasync": "fsync",
    "urllib.request.urlopen": "http",
    "socket.create_connection": "socket",
    "numpy.asarray": "dispatch",
    "jax.device_get": "dispatch",
    "jax.block_until_ready": "dispatch",
}

_ATTR_CALLS = {
    "fsync": "fsync", "fdatasync": "fsync",
    "sleep": "sleep",
    "send": "socket", "sendall": "socket", "sendmsg": "socket",
    "sendto": "socket", "recv": "socket", "recv_into": "socket",
    "recvmsg": "socket", "recvfrom": "socket", "accept": "socket",
    "connect": "socket", "connect_ex": "socket",
    "urlopen": "http", "getresponse": "http",
    "block_until_ready": "dispatch",
}


def _load_cfg(concurrency_scope: dict | None):
    cfg = concurrency_scope or {}
    critical: dict = {}
    exempt: dict = {}
    for entry in cfg.get("critical_locks", []):
        lock = entry.get("lock")
        deny = entry.get("deny", [])
        unknown = set(deny) - set(CATEGORIES)
        if not lock or unknown:
            raise ValueError(
                f"critical_locks entry {entry!r}: "
                + ("missing 'lock'" if not lock
                   else f"unknown deny categories {sorted(unknown)} "
                        f"(know {CATEGORIES})")
            )
        critical[lock] = frozenset(deny)
        exempt[lock] = frozenset(entry.get("exempt", []))
    patterns = dict(cfg.get("blocking_calls", {}))
    bad = {p: c for p, c in patterns.items() if c not in CATEGORIES}
    if bad:
        raise ValueError(
            f"blocking_calls with unknown categories: {bad} "
            f"(know {CATEGORIES})"
        )
    return critical, exempt, patterns


def _classify(call: ast.Call, aliases: dict, patterns: dict,
              resolved_pkg: bool) -> str | None:
    dn = dotted_name(call.func)
    if dn is not None:
        for pat, cat in patterns.items():
            if dn == pat or dn.endswith("." + pat):
                return cat
    fq = resolve(call.func, aliases)
    if fq is not None:
        if fq in _FQ_CALLS:
            return _FQ_CALLS[fq]
        if fq.startswith("subprocess."):
            return "subprocess"
        if fq.startswith("http.client."):
            return "http"
    if resolved_pkg:
        return None  # package function: the call edge carries the lock in
    if isinstance(call.func, ast.Attribute):
        return _ATTR_CALLS.get(call.func.attr)
    return None


def run(index: PackageIndex,
        concurrency_scope: dict | None) -> list[Finding]:
    critical, exempt, patterns = _load_cfg(concurrency_scope)
    if not critical:
        return []
    cfg = concurrency_scope or {}
    pv = PackageView.of(index)
    namer = LockNamer(frozenset(cfg.get("shared_locks", [])))
    crit_ids = frozenset(critical)

    def make_scan(key, held):
        fn = pv.function(key)
        if fn is None:
            return None
        types = pv.fn_local_types(key)
        resolved: set = set()

        def resolver(call, t=types, k=key, rc=resolved):
            out = pv.resolve_call(k, t, call)
            if out is not None:
                rc.add(id(call))
            return out

        scan = LockFlowScan(
            fn, held, namer, modname=key.modname,
            class_name=key.class_name, types=types, resolver=resolver,
        ).run()
        scan.resolved_pkg_calls = resolved
        return scan

    # The shared worklist engine; held sets project onto the critical
    # locks at every edge, bounding the context count to subsets of the
    # configured locks.
    scans = walk_lock_flow(
        [(k, frozenset()) for k in pv.all_functions()],
        make_scan,
        canonical=lambda held: frozenset(held) & crit_ids,
    )

    findings: list[Finding] = []
    seen: set = set()
    for key, ctxs in scans.items():
        view = pv.views[key.modname]
        label = key.label()
        rel = view.mod.rel
        for scan in ctxs.values():
            if scan is None:
                continue
            for call, held in scan.calls:
                crit_held = held & crit_ids
                if not crit_held:
                    continue
                cat = _classify(
                    call, view.aliases, patterns,
                    id(call) in scan.resolved_pkg_calls,
                )
                if cat is None:
                    continue
                for lock in sorted(crit_held):
                    if cat not in critical[lock]:
                        continue
                    if label in exempt[lock] or key.name in exempt[lock]:
                        continue
                    sig = (rel, call.lineno, lock, cat)
                    if sig in seen:
                        continue
                    seen.add(sig)
                    seg = view.mod.segment(call, limit=48)
                    findings.append(Finding(
                        rule="blocking-under-lock",
                        file=rel, line=call.lineno,
                        message=(
                            f"{label}: {cat} call `{seg}` reachable while "
                            f"`{lock}` is held — every thread waiting on "
                            "the lock waits on this syscall too"
                        ),
                        hint=(
                            "move the blocking call outside the critical "
                            "section (build under the lock, flush after "
                            "release), or exempt/baseline with a rationale"
                        ),
                        detail=f"{label}: {cat} under {lock} (`{seg}`)",
                    ))
    findings.sort(key=lambda f: (f.file, f.line))
    return findings
