"""Pass 2 — jit-safety: trace hazards reachable from jit entry points.

The RecompileWatchdog catches trace despecialization at *runtime* —
after the fleet already stalled on a recompile.  This pass is its static
complement: it finds the constructs that despecialize (or outright break) a
trace before anything runs.

Mechanics, pure AST:

1. **Entry discovery** — every function wrapped by ``jax.jit``,
   ``functools.partial(jax.jit, ...)``, ``shard_map`` or
   ``parallel.mesh.mesh_fleet_program`` (decorator or call form, through
   transparent wrappers like ``jax.vmap``).
2. **Reachability + taint** — entry parameters are tracers (minus
   ``static_argnums``/``static_argnames``); taint flows through
   assignments, arithmetic, ``jnp.*`` calls and into callees (package-wide
   worklist, keyword- and position-aware).  ``.shape``/``.dtype``/
   ``len()``/``is None`` results are static under trace and untaint.
3. **Rules** fired inside reachable code:

   - ``jit-branch-on-tracer``  — ``if``/``while``/ternary/``assert`` on a
     traced value (ConcretizationTypeError, or a silent despecialization
     when hidden behind ``int()``)
   - ``jit-np-on-tracer``      — ``np.*`` call on a traced value (host
     round-trip; breaks under jit)
   - ``jit-host-sync``         — ``int()/float()/bool()/.item()/.tolist()``
     on a traced value
   - ``jit-unhashable-static`` — list/dict/set literal passed for a static
     parameter (TypeError at dispatch, every call a cache miss before it)

4. ``jit-host-sync-loop`` — package-wide (host code included): a
   per-element ``x[i].item()`` inside a loop / comprehension; one device
   sync per element where one bulk ``.tolist()`` outside the loop does it
   in a single transfer (the dds/tree/forest.py:191 class).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import (  # noqa: F401  (FuncInfo/build_func_index/resolve_in
    # re-exported: the donation + mesh-safety passes import them from here
    # and from core interchangeably)
    Finding,
    FuncInfo,
    Module,
    PackageIndex,
    build_func_index,
    dotted_name,
    resolve,
    resolve_in,
)

JIT_NAMES = {"jax.jit"}
SHARD_MAP_NAMES = {"jax.experimental.shard_map.shard_map", "shard_map"}
PARTIAL_NAMES = {"functools.partial"}
# Wrappers that pass their first argument through to the trace.
TRANSPARENT = {"jax.vmap", "jax.named_call", "jax.checkpoint", "jax.remat"}
# Calls whose result is static at trace time even on traced inputs.
STATIC_RESULT_CALLS = {
    "len", "isinstance", "type", "hasattr", "getattr", "callable",
    "repr", "str", "format",
}
HOST_SYNC_BUILTINS = {"int", "float", "bool", "complex"}
HOST_SYNC_METHODS = {"item", "tolist", "block_until_ready"}
# Attribute reads that are static metadata on a tracer.
STATIC_ATTRS = {
    "shape", "dtype", "ndim", "size", "weak_type", "sharding", "aval",
    "itemsize", "nbytes",
}


# --------------------------------------------------------------------------
# Jit registration scanning (shared with the donation + mesh-safety passes;
# the function index itself lives in core.build_func_index)
# --------------------------------------------------------------------------

def _const_index_set(node: ast.AST | None) -> set:
    """static_argnums/donate_argnums literal -> set of ints."""
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        return {
            e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, int)
        }
    return set()


def _const_name_set(node: ast.AST | None) -> set:
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List)):
        return {
            e.value for e in node.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        }
    return set()


@dataclass
class JitWrap:
    """One ``jax.jit``-like wrapping: what it wraps + how."""

    target: ast.AST | None        # the wrapped function expression
    static_argnums: set = field(default_factory=set)
    static_argnames: set = field(default_factory=set)
    donate_argnums: set = field(default_factory=set)
    kind: str = "jit"             # "jit" | "shard_map" | "mesh_fleet_program"
    call: ast.Call | None = None


def parse_jit_value(mod: Module, aliases: dict, expr: ast.AST) -> JitWrap | None:
    """Recognize jit-wrapping expressions (None if ``expr`` isn't one):

    - ``jax.jit(f, **kw)``
    - ``functools.partial(jax.jit, **kw)(f)``  /  used bare as a decorator
    - ``shard_map(f, ...)``
    - ``mesh_fleet_program(f, ...)`` (donates arg 0 unless donate=False)
    """
    if not isinstance(expr, ast.Call):
        # Bare ``@jax.jit`` decorator.
        if resolve(expr, aliases) in JIT_NAMES:
            return JitWrap(target=None)
        return None
    fn = resolve(expr.func, aliases)
    kw = {k.arg: k.value for k in expr.keywords if k.arg}
    if fn in JIT_NAMES:
        return JitWrap(
            target=expr.args[0] if expr.args else None,
            static_argnums=_const_index_set(kw.get("static_argnums")),
            static_argnames=_const_name_set(kw.get("static_argnames")),
            donate_argnums=_const_index_set(kw.get("donate_argnums")),
            call=expr,
        )
    if fn in SHARD_MAP_NAMES or (fn or "").endswith(".shard_map"):
        return JitWrap(
            target=expr.args[0] if expr.args else kw.get("f"),
            kind="shard_map", call=expr,
        )
    if (fn or "").endswith("mesh_fleet_program"):
        donate: set = {0}
        d = kw.get("donate")
        if isinstance(d, ast.Constant) and d.value is False:
            donate = set()
        return JitWrap(
            target=expr.args[0] if expr.args else None,
            donate_argnums=donate, kind="mesh_fleet_program", call=expr,
        )
    if fn in PARTIAL_NAMES or fn == "partial":
        if expr.args and resolve(expr.args[0], aliases) in JIT_NAMES:
            return JitWrap(
                target=None,
                static_argnums=_const_index_set(kw.get("static_argnums")),
                static_argnames=_const_name_set(kw.get("static_argnames")),
                donate_argnums=_const_index_set(kw.get("donate_argnums")),
                call=expr,
            )
    # ``partial(jax.jit, ...)(f)`` — outer call whose func is the partial.
    if isinstance(expr.func, ast.Call):
        inner = parse_jit_value(mod, aliases, expr.func)
        if inner is not None and inner.target is None:
            inner.target = expr.args[0] if expr.args else None
            inner.call = expr
            return inner
    return None


def unwrap_target(mod: Module, aliases: dict, expr: ast.AST | None,
                  class_name: str | None = None):
    """Follow transparent wrappers down to the wrapped function expression.

    -> ("name", fq_string) | ("lambda", Lambda) | None
    """
    while isinstance(expr, ast.Call):
        fn = resolve(expr.func, aliases)
        if fn in TRANSPARENT or (fn or "").startswith("jax.vmap"):
            expr = expr.args[0] if expr.args else None
        else:
            inner = parse_jit_value(mod, aliases, expr)  # nested jit(...)
            if inner is not None:
                expr = inner.target
            else:
                return None
    if isinstance(expr, ast.Lambda):
        return ("lambda", expr)
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self" and class_name):
        # Bound method: jax.jit(self._step, ...) inside class C.
        return ("name", f"{mod.modname}.{class_name}.{expr.attr}")
    if expr is not None:
        fq = resolve_in(mod, aliases, expr)
        if fq:
            return ("name", fq)
    return None


@dataclass
class Registration:
    """One jitted callable: where it's bound + what it wraps."""

    wrap: JitWrap
    mod: Module
    target: tuple | None          # unwrap_target result
    bound_to: str | None = None   # "<modname>.<var>" or "self.<attr>" key
    line: int = 0


def _walk_with_class(tree: ast.Module):
    """(node, enclosing_class_name) pairs — registrations inside a class
    body (``self._prog = jax.jit(self._step, ...)``) need the class to
    resolve the bound-method target."""
    for top in tree.body:
        if isinstance(top, ast.ClassDef):
            for sub in ast.walk(top):
                yield sub, top.name
        else:
            for sub in ast.walk(top):
                yield sub, None


def scan_registrations(index: PackageIndex, func_index: dict) -> list[Registration]:
    regs: list[Registration] = []
    for mod in index.modules:
        aliases = mod.aliases()

        def handle_value(expr, bound_to=None, line=0, class_name=None,
                         mod=mod, aliases=aliases):
            w = parse_jit_value(mod, aliases, expr)
            if w is None or w.target is None:
                return
            t = unwrap_target(mod, aliases, w.target, class_name=class_name)
            regs.append(Registration(wrap=w, mod=mod, target=t,
                                     bound_to=bound_to, line=line))

        for node, class_name in _walk_with_class(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    w = parse_jit_value(mod, aliases, dec)
                    if w is not None and w.target is None:
                        qual = (f"{mod.modname}.{class_name}.{node.name}"
                                if class_name and node.name != class_name
                                and f"{mod.modname}.{class_name}.{node.name}" in func_index
                                else f"{mod.modname}.{node.name}")
                        w.target = ast.Name(id=node.name, ctx=ast.Load())
                        regs.append(Registration(
                            wrap=w, mod=mod,
                            target=("name", qual),
                            bound_to=qual,
                            line=node.lineno,
                        ))
            elif isinstance(node, ast.Assign):
                bound = None
                if len(node.targets) == 1:
                    t = node.targets[0]
                    if isinstance(t, ast.Name):
                        bound = f"{mod.modname}.{t.id}"
                    elif (isinstance(t, ast.Attribute)
                          and isinstance(t.value, ast.Name)
                          and t.value.id == "self"):
                        bound = f"self.{t.attr}"
                handle_value(node.value, bound_to=bound, line=node.lineno,
                             class_name=class_name)
            elif isinstance(node, ast.Expr):
                handle_value(node.value, line=node.lineno, class_name=class_name)
            elif isinstance(node, ast.Return) and node.value is not None:
                handle_value(node.value, line=node.lineno, class_name=class_name)
    return regs


# --------------------------------------------------------------------------
# Taint analysis
# --------------------------------------------------------------------------

class _FuncScan:
    """One pass over one function with a given tainted-parameter set."""

    def __init__(self, info: FuncInfo, tainted_params: frozenset,
                 findings: list, edges: list, display: str) -> None:
        self.info = info
        self.mod = info.mod
        self.aliases = info.mod.aliases()
        self.env: set = set(tainted_params)
        self.findings = findings
        self.edges = edges          # (callee_fq, frozenset(tainted params))
        self.display = display

    # ------------------------------------------------------------- helpers
    def _flag(self, rule: str, node: ast.AST, message: str, hint: str,
              detail: str) -> None:
        self.findings.append(Finding(
            rule=rule, file=self.mod.rel, line=getattr(node, "lineno", 0),
            message=message, hint=hint, detail=detail,
        ))

    def _callee_info(self, call: ast.Call):
        """Resolve a call to a package function -> (fq, param_offset)."""
        func = call.func
        # self.method() inside a class
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and func.value.id == "self" and self.info.class_name):
            fq = f"{self.mod.modname}.{self.info.class_name}.{func.attr}"
            return fq, 1
        fq = resolve_in(self.mod, self.aliases, func)
        return fq, 0

    # ---------------------------------------------------------------- taint
    def tainted(self, node: ast.AST | None) -> bool:  # noqa: C901
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return node.id in self.env
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                self.tainted(node.value)
                return False
            return self.tainted(node.value)
        if isinstance(node, ast.Subscript):
            self.tainted(node.slice)
            return self.tainted(node.value)
        if isinstance(node, ast.Compare):
            t = self.tainted(node.left) or any(self.tainted(c) for c in node.comparators)
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False  # identity checks are static at trace time
            return t
        if isinstance(node, (ast.BoolOp,)):
            return any(self.tainted(v) for v in node.values)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) | self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.IfExp):
            if self.tainted(node.test):
                self._flag(
                    "jit-branch-on-tracer", node,
                    f"{self.display}: ternary on traced value "
                    f"`{self.mod.segment(node.test)}`",
                    "use jnp.where / lax.select (both branches traced)",
                    f"{self.display}: ternary on traced `{self.mod.segment(node.test)}`",
                )
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self.tainted(v) for v in list(node.keys) + list(node.values) if v)
        if isinstance(node, ast.Starred):
            return self.tainted(node.value)
        if isinstance(node, ast.NamedExpr):
            t = self.tainted(node.value)
            if t:
                self.env.add(node.target.id)
            return t
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            # Tainted iff traced data flows in: a generator iterates a
            # tainted iterable (its targets become tainted for the element
            # expressions), or the element expressions touch tainted names
            # themselves.  A fully static comprehension stays branchable.
            bound: set = set()
            iter_taint = False
            for gen in node.generators:
                if self.tainted(gen.iter):
                    iter_taint = True
                    for tn in ast.walk(gen.target):
                        if isinstance(tn, ast.Name):
                            bound.add(tn.id)
            added = bound - self.env
            self.env |= added
            try:
                parts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                         else [node.elt])
                parts += [c for gen in node.generators for c in gen.ifs]
                elt_taint = any(self.tainted(p) for p in parts if p is not None)
            finally:
                self.env -= added
            return iter_taint or elt_taint
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.JoinedStr):
            return False
        # Unknown node kinds: visit children, assume untainted.
        for child in ast.iter_child_nodes(node):
            self.tainted(child) if isinstance(child, ast.expr) else None
        return False

    def _call(self, call: ast.Call) -> bool:  # noqa: C901
        arg_taints = [self.tainted(a) for a in call.args]
        kw_taints = {k.arg: self.tainted(k.value) for k in call.keywords}
        any_taint = any(arg_taints) or any(kw_taints.values())
        fn = resolve(call.func, self.aliases)

        # Host-sync builtins / methods on traced values.
        if fn in HOST_SYNC_BUILTINS and any_taint:
            self._flag(
                "jit-host-sync", call,
                f"{self.display}: {fn}() forces a traced value to a host scalar",
                "keep it on device (jnp ops) or pass it as a static arg",
                f"{self.display}: {fn}() on traced value",
            )
            return False
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in HOST_SYNC_METHODS
                and self.tainted(call.func.value)):
            self._flag(
                "jit-host-sync", call,
                f"{self.display}: .{call.func.attr}() on a traced value",
                "device values cannot concretize under trace; return them instead",
                f"{self.display}: .{call.func.attr}() on traced value",
            )
            return False

        # np.* on tracers.
        if fn and (fn == "numpy" or fn.startswith("numpy.")) and any_taint:
            self._flag(
                "jit-np-on-tracer", call,
                f"{self.display}: {self.mod.segment(call.func)}() called on a "
                "traced value (host numpy inside a traced function)",
                "use the jnp equivalent so the op stays in the trace",
                f"{self.display}: {self.mod.segment(call.func)} on traced value",
            )
            return True

        if fn in STATIC_RESULT_CALLS:
            return False

        # Propagate into package callees (position+keyword aware).
        fq, offset = self._callee_info(call)
        if fq and fq.startswith(self.mod.modname.split(".")[0] + "."):
            self.edges.append((fq, offset, call, arg_taints, kw_taints))
        # Wrapped calls like jax.vmap(f, ...)(args): route taint to f.
        if isinstance(call.func, ast.Call):
            t = unwrap_target(self.mod, self.aliases, call.func)
            if t is not None and t[0] == "name":
                self.edges.append((t[1], 0, call, arg_taints, kw_taints))
        return any_taint

    def _scan_narrowed(self, stmts: list, narrowed: set) -> None:
        removed = narrowed & self.env
        self.env -= removed
        self.scan(stmts)
        self.env |= removed

    # ------------------------------------------------------------ statements
    def bind(self, target: ast.AST, t: bool) -> None:
        if isinstance(target, ast.Name):
            (self.env.add if t else self.env.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.bind(e, t)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, t)
        # Attribute / Subscript targets: no local binding to track.

    def run(self) -> None:
        self.scan(self.info.node.body if not isinstance(self.info.node, ast.Lambda)
                  else [ast.Expr(value=self.info.node.body)])

    def scan(self, stmts: list) -> None:  # noqa: C901
        for st in stmts:
            if isinstance(st, ast.Assign):
                t = self.tainted(st.value)
                for target in st.targets:
                    self.bind(target, t)
            elif isinstance(st, ast.AugAssign):
                t = self.tainted(st.value) or self.tainted(st.target)
                self.bind(st.target, t)
            elif isinstance(st, ast.AnnAssign):
                if st.value is not None:
                    self.bind(st.target, self.tainted(st.value))
            elif isinstance(st, (ast.If, ast.While)):
                if self.tainted(st.test):
                    kind = "if" if isinstance(st, ast.If) else "while"
                    self._flag(
                        "jit-branch-on-tracer", st,
                        f"{self.display}: Python `{kind}` on traced value "
                        f"`{self.mod.segment(st.test)}`",
                        "trace-time control flow must use lax.cond/lax.while_loop "
                        "(or hoist the value to a static arg)",
                        f"{self.display}: {kind} on traced `{self.mod.segment(st.test)}`",
                    )
                if isinstance(st, ast.If):
                    # `if isinstance(x, bool):` narrows x to a static python
                    # value in that arm — the standard static/traced
                    # dual-mode kernel idiom (the other arm keeps the taint
                    # and must use lax.cond).
                    then_narrow, else_narrow = _isinstance_narrowing(st.test)
                    self._scan_narrowed(st.body, then_narrow)
                    self._scan_narrowed(st.orelse, else_narrow)
                else:
                    self.scan(st.body)
                    self.scan(st.orelse)
            elif isinstance(st, ast.Assert):
                if self.tainted(st.test):
                    self._flag(
                        "jit-branch-on-tracer", st,
                        f"{self.display}: assert on traced value "
                        f"`{self.mod.segment(st.test)}`",
                        "use checkify or debug.check for traced assertions",
                        f"{self.display}: assert on traced `{self.mod.segment(st.test)}`",
                    )
            elif isinstance(st, ast.For):
                self.bind(st.target, self.tainted(st.iter))
                self.scan(st.body)
                self.scan(st.orelse)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self.tainted(item.context_expr)
                self.scan(st.body)
            elif isinstance(st, ast.Try):
                self.scan(st.body)
                for h in st.handlers:
                    self.scan(h.body)
                self.scan(st.orelse)
                self.scan(st.finalbody)
            elif isinstance(st, (ast.Return, ast.Expr)):
                self.tainted(st.value)
            elif isinstance(st, ast.Raise):
                self.tainted(st.exc)
            # Nested defs/classes: separate scopes, skipped.


def _isinstance_narrowing(test: ast.AST) -> tuple:
    """-> (names static in the then-arm, names static in the else-arm) for
    ``isinstance(x, ...)`` / ``not isinstance(x, ...)`` tests (including
    ``isinstance(...) and ...`` conjunctions for the then-arm)."""
    def direct(node: ast.AST) -> set:
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "isinstance" and node.args
                and isinstance(node.args[0], ast.Name)):
            return {node.args[0].id}
        return set()

    then_narrow = direct(test)
    else_narrow: set = set()
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        else_narrow = direct(test.operand)
    elif isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        for v in test.values:
            then_narrow |= direct(v)
    return then_narrow, else_narrow


def _map_edge_taint(callee: FuncInfo, offset: int, call: ast.Call,
                    arg_taints: list, kw_taints: dict) -> frozenset:
    params = callee.params()
    tainted: set = set()
    for i, t in enumerate(arg_taints):
        j = i + offset
        if t and j < len(params):
            tainted.add(params[j])
        elif t:
            tainted.update(params)  # *args overflow: be conservative
    for name, t in kw_taints.items():
        if t and name and (name in params or name in callee.kwonly()):
            tainted.add(name)
    return frozenset(tainted)


def run(index: PackageIndex) -> list[Finding]:
    findings: list[Finding] = []
    func_index = build_func_index(index)
    regs = scan_registrations(index, func_index)

    # Seed the worklist: entry params taint (minus statics).
    taint_state: dict = {}   # fq -> frozenset of tainted param names
    work: list = []

    def seed(fq: str, wrap: JitWrap) -> None:
        info = func_index.get(fq)
        if info is None:
            return
        params = info.params()
        tainted = set(params)
        if info.class_name and params[:1] == ["self"]:
            tainted.discard("self")
        for i in wrap.static_argnums:
            if i < len(params):
                tainted.discard(params[i])
        tainted -= wrap.static_argnames
        merge(fq, frozenset(tainted))

    def merge(fq: str, tset: frozenset) -> None:
        cur = taint_state.get(fq, frozenset())
        new = cur | tset
        if new != cur or fq not in taint_state:
            taint_state[fq] = new
            work.append(fq)

    lambda_regs = []
    for reg in regs:
        if reg.target is None:
            continue
        kind, tgt = reg.target
        if kind == "name":
            seed(tgt, reg.wrap)
        else:
            lambda_regs.append((reg, tgt))

    # Lambdas wrapped directly in jit: scan once, all params tainted.
    for reg, lam in lambda_regs:
        params = [p.arg for p in lam.args.posonlyargs + lam.args.args]
        tainted = frozenset(
            p for i, p in enumerate(params)
            if i not in reg.wrap.static_argnums and p not in reg.wrap.static_argnames
        )
        info = FuncInfo(reg.mod, lam, f"{reg.mod.modname}.<lambda L{lam.lineno}>")
        edges: list = []
        scan = _FuncScan(info, tainted, findings, edges,
                         display=f"<lambda:{lam.lineno}>")
        scan.run()
        for fq, offset, call, a_t, k_t in edges:
            callee = func_index.get(fq)
            if callee is not None:
                merge(fq, _map_edge_taint(callee, offset, call, a_t, k_t))

    # Worklist to fixpoint.
    processed_with: dict = {}
    guard = 0
    while work and guard < 10000:
        guard += 1
        fq = work.pop()
        tset = taint_state[fq]
        if processed_with.get(fq) == tset:
            continue
        processed_with[fq] = tset
        info = func_index[fq]
        edges: list = []
        scan = _FuncScan(info, tset, findings, edges,
                         display=fq.split(".")[-1])
        scan.run()
        for callee_fq, offset, call, a_t, k_t in edges:
            callee = func_index.get(callee_fq)
            if callee is None:
                continue
            et = _map_edge_taint(callee, offset, call, a_t, k_t)
            if et:
                merge(callee_fq, et)

    # Dedup: fixpoint re-scans can fire the same site repeatedly.
    seen: set = set()
    out: list[Finding] = []
    for f in findings:
        k = (f.rule, f.file, f.line, f.detail)
        if k not in seen:
            seen.add(k)
            out.append(f)

    out.extend(_unhashable_static(index, regs))
    out.extend(_host_sync_loops(index))
    return out


# --------------------------------------------------------------------------
# jit-unhashable-static
# --------------------------------------------------------------------------

_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)


def _unhashable_static(index: PackageIndex, regs) -> list[Finding]:
    findings: list[Finding] = []
    # Bound name -> (static nums adjusted, static names) for call-site checks.
    statics: dict = {}
    for reg in regs:
        if reg.bound_to and (reg.wrap.static_argnums or reg.wrap.static_argnames):
            statics[reg.bound_to] = (reg.wrap.static_argnums, reg.wrap.static_argnames)
    if not statics:
        return findings
    for mod in index.modules:
        aliases = mod.aliases()
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fq = resolve_in(mod, aliases, node.func)
            key = fq if fq in statics else None
            if key is None and isinstance(node.func, ast.Attribute) \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                key = f"self.{node.func.attr}"
                if key not in statics:
                    key = None
            if key is None:
                continue
            nums, names = statics[key]
            for i, arg in enumerate(node.args):
                if i in nums and isinstance(arg, _UNHASHABLE):
                    findings.append(Finding(
                        rule="jit-unhashable-static", file=mod.rel,
                        line=arg.lineno,
                        message=(
                            f"unhashable literal passed for static arg {i} of "
                            f"jitted `{key.split('.')[-1]}`"
                        ),
                        hint="static args must be hashable: pass a tuple/frozenset",
                        detail=f"unhashable static arg {i} to {key.split('.')[-1]}",
                    ))
            for k in node.keywords:
                if k.arg in names and isinstance(k.value, _UNHASHABLE):
                    findings.append(Finding(
                        rule="jit-unhashable-static", file=mod.rel,
                        line=k.value.lineno,
                        message=(
                            f"unhashable literal passed for static arg "
                            f"{k.arg!r} of jitted `{key.split('.')[-1]}`"
                        ),
                        hint="static args must be hashable: pass a tuple/frozenset",
                        detail=f"unhashable static arg {k.arg} to {key.split('.')[-1]}",
                    ))
    return findings


# --------------------------------------------------------------------------
# jit-host-sync-loop (package-wide, host code included)
# --------------------------------------------------------------------------

def _host_sync_loops(index: PackageIndex) -> list[Finding]:
    findings: list[Finding] = []
    for mod in index.modules:
        loops: list = []
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.For, ast.While)):
                loops.append((node, node.body + node.orelse))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
                loops.append((node, [node.elt]))
            elif isinstance(node, ast.DictComp):
                loops.append((node, [node.key, node.value]))
        flagged: set = set()
        for loop, body in loops:
            for part in body:
                for call in ast.walk(part):
                    if (isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Attribute)
                            and call.func.attr == "item"
                            and isinstance(call.func.value, ast.Subscript)
                            and not call.args):
                        if call.lineno in flagged:
                            continue
                        flagged.add(call.lineno)
                        seg = mod.segment(call, limit=40)
                        findings.append(Finding(
                            rule="jit-host-sync-loop", file=mod.rel,
                            line=call.lineno,
                            message=(
                                f"per-element `.item()` inside a loop "
                                f"(`{seg}`): one host sync per element"
                            ),
                            hint=(
                                "convert the array once outside the loop "
                                "(np.asarray(...).tolist()) and index the list"
                            ),
                            detail=f"per-element .item() in loop: `{seg}`",
                        ))
    return findings
