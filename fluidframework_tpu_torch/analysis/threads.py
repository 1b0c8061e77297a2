"""Pass 5 — thread-shared-state: unlocked cross-thread attribute mutation.

The serving tier runs real threads — socketserver per-connection handlers,
the fanout writer drain thread, the launcher's crash-restart supervisor,
metrics scrape handlers.  An attribute written from a thread body and read
from the host path without a common lock is a data race that presents as
a once-a-week flaky test (or a torn port number mid-rebalance).

Mechanics (per module, on the shared ``core`` walkers):

1. **Thread entries** — ``threading.Thread(target=X)`` where ``X`` is
   ``self.method``, a module function, or ``var.method`` with ``var``'s
   class known (constructor assignment or annotation); ``threading.Timer``
   functions; ``ThreadPoolExecutor`` submit/map callables; plus ``handle``
   / ``do_*`` methods of ``socketserver``/``http.server`` handler
   subclasses (the library spawns those per request).
2. **Reachability** — ``core.walk_lock_flow``: entry bodies plus
   transitively called same-class ``self.`` methods, module functions, and
   methods on locally-typed vars.  A callee reached ONLY from under a lock
   inherits the lock (the held set rides the call edge).
3. **Lock model** — ``with <name-or-attr>:`` counts as lock-held (covers
   ``Lock``/``RLock``/``Condition`` attributes; non-call context
   expressions are overwhelmingly locks in this codebase).
4. **Finding** — ``thread-unlocked-write``: an attribute assigned inside
   thread-reachable code outside any lock, where the same attribute name
   is also touched by non-thread code of the module (``__init__`` bodies
   are exempt on both sides: init-before-start is the safe idiom).

Thread-safe containers (``queue.Queue``, ``collections.deque`` method
calls) never trip this pass: method *calls* are not attribute writes.

The *which-lock* refinement — a write guarded by lock A here and lock B
(or nothing) there — is the ``lock-consistency`` pass, which shares this
pass's entry discovery and walker.
"""

from __future__ import annotations

import ast

from .core import (
    Finding,
    FuncKey,
    LockFlowScan,
    LockNamer,
    ModuleView,
    PackageIndex,
    local_types,
    resolve,
    walk_lock_flow,
)

_EXECUTOR_NAMES = (
    "concurrent.futures.ThreadPoolExecutor", "futures.ThreadPoolExecutor",
    "ThreadPoolExecutor",
)


def _note_entry(target, fn_key: FuncKey, types: dict, view: ModuleView,
                entries: list) -> None:
    """Resolve a callable expression handed to a thread runtime (Thread
    target, Timer function, executor submit/map fn) to a FuncKey."""
    if isinstance(target, ast.Attribute) and isinstance(target.value, ast.Name):
        base, meth = target.value.id, target.attr
        if base == "self" and fn_key.class_name:
            entries.append(FuncKey(fn_key.class_name, meth))
        elif base in types:
            entries.append(FuncKey(types[base], meth))
    elif isinstance(target, ast.Name):
        if FuncKey(None, target.id) in view.functions:
            entries.append(FuncKey(None, target.id))


def _executor_vars(fn: ast.AST, aliases) -> set:
    """Local names bound to a ThreadPoolExecutor: ``x = ThreadPoolExecutor
    (...)`` and ``with ThreadPoolExecutor(...) as x:`` — the pool's worker
    threads run whatever ``x.submit``/``x.map`` is handed (the background
    restore fan-out shape this pass must cover)."""
    out: set = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            if resolve(node.value.func, aliases) in _EXECUTOR_NAMES:
                out.add(node.targets[0].id)
        elif isinstance(node, ast.With):
            for item in node.items:
                if (
                    isinstance(item.context_expr, ast.Call)
                    and resolve(item.context_expr.func, aliases)
                    in _EXECUTOR_NAMES
                    and isinstance(item.optional_vars, ast.Name)
                ):
                    out.add(item.optional_vars.id)
    return out


def thread_entries(view: ModuleView) -> list:
    """FuncKeys the runtime invokes on their own thread: Thread targets,
    Timer functions, ThreadPoolExecutor submit/map callables, and
    socketserver/http handler methods.  Shared with lock-consistency."""
    entries: list = []
    for fn_key, fn in view.functions.items():
        types = local_types(fn, view)
        executors = _executor_vars(fn, view.aliases)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            fname = resolve(node.func, view.aliases)
            if fname in ("threading.Thread", "Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        _note_entry(kw.value, fn_key, types, view, entries)
            elif fname in ("threading.Timer", "Timer"):
                # Timer(interval, function): the function runs on the
                # timer's own thread.
                if len(node.args) >= 2:
                    _note_entry(node.args[1], fn_key, types, view, entries)
                for kw in node.keywords:
                    if kw.arg == "function":
                        _note_entry(kw.value, fn_key, types, view, entries)
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in ("submit", "map")
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in executors
                and node.args
            ):
                # pool.submit(fn, ...) / pool.map(fn, items): fn runs on
                # the pool's worker threads.
                _note_entry(node.args[0], fn_key, types, view, entries)
    for cls in view.handler_classes():
        for fn_key in view.functions:
            if fn_key.class_name == cls and (
                    fn_key.name == "handle" or fn_key.name.startswith("do_")):
                entries.append(fn_key)
    return entries


def local_resolver(view: ModuleView, key: FuncKey, types: dict):
    """Module-scoped call resolution (the per-module passes' flavor of
    ``PackageView.resolve_call``): module functions, ``self.`` methods,
    locally-typed var methods."""
    def _resolve(call: ast.Call, _types=types) -> FuncKey | None:
        func = call.func
        if isinstance(func, ast.Name):
            k = FuncKey(None, func.id)
            if k in view.functions:
                return k
        elif isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name):
            base, meth = func.value.id, func.attr
            cls = key.class_name if base == "self" else _types.get(base)
            if cls is not None:
                k = FuncKey(cls, meth)
                if k in view.functions:
                    return k
        return None
    return _resolve


def module_lock_scans(view: ModuleView, entries: list,
                      shared_locks: frozenset = frozenset()) -> dict:
    """Walk a module's thread-reachable code with lock inheritance; returns
    ``{FuncKey: {held_frozenset: LockFlowScan | None}}``.  Shared by the
    threads and lock-consistency passes."""
    namer = LockNamer(shared_locks)
    mod = view.mod

    def make_scan(key, held):
        fn = view.functions.get(key)
        if fn is None:
            return None
        types = local_types(fn, view)
        return LockFlowScan(
            fn, held, namer, modname=mod.modname,
            class_name=key.class_name, types=types,
            resolver=local_resolver(view, key, types),
        ).run()

    return walk_lock_flow([(k, frozenset()) for k in entries], make_scan)


def run(index: PackageIndex) -> list[Finding]:
    findings: list[Finding] = []
    for mod in index.modules:
        view = ModuleView(mod)
        entries = thread_entries(view)
        if not entries:
            continue

        scans = module_lock_scans(view, entries)
        thread_keys = {
            k for k, ctxs in scans.items()
            if any(s is not None for s in ctxs.values())
        }

        # Attribute touches from NON-thread code (reads or writes), minus
        # __init__ everywhere (init-before-start is the safe idiom).  Each
        # entry remembers whether it was a ``self.X`` access and from which
        # class, so a thread-side ``self.X`` write in class C never matches
        # another class's own ``self.X`` (different objects, no race).
        outside: dict = {}
        for fn_key, fn in view.functions.items():
            if fn_key in thread_keys or fn_key.name == "__init__":
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute):
                    is_self = (isinstance(node.value, ast.Name)
                               and node.value.id == "self")
                    outside.setdefault(node.attr, []).append(
                        (fn_key, node.lineno, is_self))

        for key, ctxs in scans.items():
            if key.name == "__init__":
                continue
            fn_label = key.label()
            for scan in ctxs.values():
                if scan is None:
                    continue
                for attr, line, held, write_is_self, _owner in scan.writes:
                    if held or attr not in outside:
                        continue
                    candidates = outside[attr]
                    if write_is_self:
                        candidates = [
                            c for c in candidates
                            if not c[2] or c[0].class_name == key.class_name
                        ]
                    if not candidates:
                        continue
                    other_key, other_line, _self = candidates[0]
                    findings.append(Finding(
                        rule="thread-unlocked-write",
                        file=mod.rel, line=line,
                        message=(
                            f"{fn_label} (thread body) writes `.{attr}` "
                            f"without a lock; `{other_key.label()}` (line "
                            f"{other_line}) touches it from outside the "
                            "thread"
                        ),
                        hint=(
                            "guard both sides with the owning object's "
                            "lock, or baseline with a rationale if the "
                            "race is benign"
                        ),
                        detail=f"{fn_label}: unlocked write to .{attr}",
                    ))
    # Dedup per (rule, file, line, detail): multiple reach contexts can
    # re-observe the same write site.
    seen: set = set()
    out: list = []
    for f in findings:
        k = (f.rule, f.file, f.line, f.detail)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
