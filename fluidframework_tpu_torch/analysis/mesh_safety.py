"""Pass 11 — mesh-safety: shard_map/collective hazards, statically.

The seg-parallel serving path put real collectives on the hot
path: ``psum``/``pmin``/``all_gather`` over a named mesh axis, wrapped in
``jit(shard_map(...))`` programs whose in/out specs and donation flags
are load-bearing.  Three hazard classes are statically checkable and each
has already cost a debugging session:

- ``mesh-axis-unknown`` — a collective whose axis name resolves to a
  string no ``Mesh(...)`` construction in the package ever declares.  A
  typo'd axis traces fine in tests that bind it and explodes (or silently
  no-ops) on the mesh that doesn't.  The resolver follows constants
  through parameter defaults and module/imported constants
  (``SEG_AXIS``-style), so the kernels' ``axis=SEG_AXIS`` idiom checks.
- ``mesh-in-specs-arity`` — a ``shard_map`` whose literal ``in_specs``
  tuple disagrees with the wrapped function's positional arity: today a
  confusing trace-time error, here a finding with both numbers.
- ``mesh-donate-replicated-out`` — donation enabled on a program whose
  ``out_specs`` replicate any output.  This is the live bug class the
  seg-parallel byte-identity fuzz caught: a donated shard_map executable
  with replicated outputs, RELOADED from the persistent XLA compile
  cache, returns permuted garbage (jax 0.4.37 — see
  ``parallel/mesh.py::mesh_seg_program``).  Fires on (a) a statically
  replicated ``out_specs`` (a bare ``P()`` literal in the spec tree)
  jitted with non-empty ``donate_argnums``, and (b) any program declared
  in layers.json ``mesh_scope.replicated_out_programs`` whose donation
  resolves ON (parameter defaults included) — the config carries the
  hand-knowledge that ``mesh_seg_program``'s out specs replicate, so a
  well-meaning "re-enable donation" edit trips this rule, not a fuzz
  flake.  Scope entries that no longer name a real function fail loudly.
"""

from __future__ import annotations

import ast

from .core import (
    Finding,
    Module,
    PackageIndex,
    PackageView,
    build_func_index,
    dotted_name,
    resolve,
    resolve_in,
)
from .jit_safety import JIT_NAMES, unwrap_target

COLLECTIVES = {
    "psum", "pmin", "pmax", "pmean", "all_gather", "all_to_all",
    "ppermute", "axis_index", "psum_scatter", "pshuffle",
}
_SPEC_NAMES = {"jax.sharding.PartitionSpec", "PartitionSpec", "P"}


def _is_collective(fq: str | None) -> bool:
    if not fq:
        return False
    parts = fq.split(".")
    return parts[-1] in COLLECTIVES and ("lax" in parts or parts[0] == "jax")


def _param_defaults(fn: ast.AST) -> dict:
    """param name -> default expression (positional + kw-only)."""
    out: dict = {}
    a = fn.args
    pos = a.posonlyargs + a.args
    for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        out[p.arg] = d
    for p, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            out[p.arg] = d
    return out


class _Resolver:
    """Static constant resolution: parameter defaults, module constants,
    and imported constants (``SEG_AXIS`` through the alias map)."""

    def __init__(self, pv: PackageView, mod: Module, fn: ast.AST | None):
        self.pv = pv
        self.mod = mod
        self.aliases = mod.aliases()
        self.defaults = _param_defaults(fn) if fn is not None else {}

    def const_str(self, expr: ast.AST | None, depth: int = 0) -> str | None:
        if expr is None or depth > 4:
            return None
        if isinstance(expr, ast.Constant):
            return expr.value if isinstance(expr.value, str) else None
        if isinstance(expr, ast.Name):
            if expr.id in self.defaults:
                return self.const_str(self.defaults[expr.id], depth + 1)
            local = self.pv.module_constants(self.mod.modname).get(expr.id)
            if local is not None:
                return local
        fq = resolve(expr, self.aliases)
        if fq and "." in fq:
            modname, _, name = fq.rpartition(".")
            val = self.pv.module_constants(modname).get(name)
            if isinstance(val, str):
                return val
        return None

    def const_truth(self, expr: ast.AST | None, depth: int = 0) -> bool | None:
        if expr is None or depth > 4:
            return None
        if isinstance(expr, ast.Constant):
            return bool(expr.value)
        if isinstance(expr, ast.Name) and expr.id in self.defaults:
            return self.const_truth(self.defaults[expr.id], depth + 1)
        return None

    def donates(self, expr: ast.AST | None, depth: int = 0) -> bool | None:
        """donate_argnums expression -> True (definitely non-empty),
        False (definitely empty), None (unknown)."""
        if expr is None or depth > 4:
            return None
        if isinstance(expr, (ast.Tuple, ast.List)):
            return bool(expr.elts)
        if isinstance(expr, ast.Constant):
            if isinstance(expr.value, int) and not isinstance(expr.value, bool):
                return True
            return None
        if isinstance(expr, ast.IfExp):
            t = self.const_truth(expr.test, depth + 1)
            if t is None:
                return None
            return self.donates(expr.body if t else expr.orelse, depth + 1)
        if isinstance(expr, ast.Name) and expr.id in self.defaults:
            return self.donates(self.defaults[expr.id], depth + 1)
        return None


def _axis_universe(index: PackageIndex, pv: PackageView,
                   calls: dict) -> set:
    """Every axis name any ``Mesh(...)`` construction in the package
    declares (tuple literals, through param defaults/constants)."""
    universe: set = set()
    for mod in index.modules:
        aliases = mod.aliases()
        for fn, call in calls[mod.modname]:
            fq = resolve(call.func, aliases)
            if not fq or fq.split(".")[-1] != "Mesh":
                continue
            names_expr = None
            if len(call.args) >= 2:
                names_expr = call.args[1]
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    names_expr = kw.value
            if names_expr is None:
                continue
            res = _Resolver(pv, mod, fn)
            elts = (names_expr.elts
                    if isinstance(names_expr, (ast.Tuple, ast.List))
                    else [names_expr])
            for e in elts:
                s = res.const_str(e)
                if s is not None:
                    universe.add(s)
    return universe


def _calls_with_owner(mod: Module):
    """(INNERMOST enclosing function def or None, Call) pairs for a
    module.  Innermost matters: the resolver reads parameter defaults off
    the owner, and a kernel closure nested in a factory must resolve its
    own ``axis=SEG_AXIS`` default, never the factory's."""
    out: list = []

    def visit(node, owner):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Call):
                out.append((owner, child))
            child_owner = (
                child
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                else owner
            )
            visit(child, child_owner)

    visit(mod.tree, None)
    return out


def _axis_findings(index, pv, universe, calls) -> list:
    findings: list = []
    if not universe:
        return findings
    for mod in index.modules:
        aliases = mod.aliases()
        for fn, call in calls[mod.modname]:
            fq = resolve(call.func, aliases)
            if not _is_collective(fq):
                continue
            leaf = fq.split(".")[-1]
            axis_expr = None
            if leaf == "axis_index":
                axis_expr = call.args[0] if call.args else None
            elif len(call.args) >= 2:
                axis_expr = call.args[1]
            for kw in call.keywords:
                if kw.arg in ("axis", "axis_name"):
                    axis_expr = kw.value
            axis = _Resolver(pv, mod, fn).const_str(axis_expr)
            if axis is None or axis in universe:
                continue
            findings.append(Finding(
                rule="mesh-axis-unknown",
                file=mod.rel, line=call.lineno,
                message=(
                    f"`{leaf}` over axis {axis!r}, which no Mesh in the "
                    f"package declares (known axes: "
                    f"{sorted(universe)})"
                ),
                hint=(
                    "bind the collective to a declared mesh axis (a "
                    "typo'd axis no-ops or explodes only on the mesh "
                    "that lacks it)"
                ),
                detail=f"{leaf} over unknown axis {axis!r}",
            ))
    return findings


def _spec_replicates(expr: ast.AST | None, aliases: dict,
                     local_assigns: dict, depth: int = 0) -> bool:
    """True when the out_specs expression statically contains a bare
    ``P()`` / ``PartitionSpec()`` (a replicated output)."""
    if expr is None or depth > 3:
        return False
    if isinstance(expr, ast.Name) and expr.id in local_assigns:
        return _spec_replicates(
            local_assigns[expr.id], aliases, local_assigns, depth + 1)
    for node in ast.walk(expr):
        if isinstance(node, ast.Call) and not node.args and not node.keywords:
            fq = resolve(node.func, aliases)
            dn = dotted_name(node.func)
            if (fq in _SPEC_NAMES or dn in _SPEC_NAMES
                    or (fq or "").endswith(".PartitionSpec")):
                return True
    return False


def _local_assigns(fn: ast.AST | None) -> dict:
    out: dict = {}
    if fn is None:
        return out
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = node.value
    return out


def _shard_map_of(expr: ast.AST | None, local_assigns: dict):
    """Follow ``expr`` (directly or via a local name) to a shard_map call."""
    if isinstance(expr, ast.Name):
        expr = local_assigns.get(expr.id)
    if isinstance(expr, ast.Call):
        dn = dotted_name(expr.func) or ""
        if dn.split(".")[-1] == "shard_map":
            return expr
    return None


def _jit_wrap_findings(index, pv, calls) -> list:
    findings: list = []
    for mod in index.modules:
        aliases = mod.aliases()
        for fn, call in calls[mod.modname]:
            fq = resolve(call.func, aliases)
            if fq not in JIT_NAMES and (fq or "") != "jit":
                continue
            donate_expr = next(
                (k.value for k in call.keywords if k.arg == "donate_argnums"),
                None,
            )
            res = _Resolver(pv, mod, fn)
            if res.donates(donate_expr) is not True:
                continue
            assigns = _local_assigns(fn)
            sm = _shard_map_of(call.args[0] if call.args else None, assigns)
            if sm is None:
                continue
            out_specs = next(
                (k.value for k in sm.keywords if k.arg == "out_specs"), None
            )
            if not _spec_replicates(out_specs, aliases, assigns):
                continue
            findings.append(Finding(
                rule="mesh-donate-replicated-out",
                file=mod.rel, line=call.lineno,
                message=(
                    "donated jit over a shard_map whose out_specs "
                    "replicate an output: a donated replicated-output "
                    "executable reloaded from the persistent XLA compile "
                    "cache mis-aliases its buffers (jax 0.4.37)"
                ),
                hint=(
                    "keep donate_argnums empty for replicated-output "
                    "programs (see parallel/mesh.py::mesh_seg_program)"
                ),
                detail="donated shard_map with replicated out_specs",
            ))
    return findings


def _declared_program_findings(index, pv, mesh_scope: dict,
                               func_index: dict) -> list:
    findings: list = []
    entries = (mesh_scope or {}).get("replicated_out_programs", [])
    for entry in entries:
        try:
            rel, fn_name = entry.split("::")
        except ValueError:
            raise ValueError(
                f"mesh_scope.replicated_out_programs entry {entry!r}: "
                "expected 'path/to/file.py::function'"
            ) from None
        mod = next((m for m in index.modules if m.rel == rel), None)
        if mod is None:
            # Root-name-agnostic fallback: seeded-violation tests (and
            # other repos) analyze COPIES of the tree under a different
            # directory name; the entry's path tail still pins the file.
            tail = rel.split("/", 1)[-1]
            mod = next(
                (m for m in index.modules
                 if m.rel.split("/", 1)[-1] == tail), None,
            )
        fn = None
        if mod is not None:
            info = func_index.get(f"{mod.modname}.{fn_name}")
            fn = info.node if info is not None else None
        if fn is None:
            raise ValueError(
                f"mesh_scope.replicated_out_programs entry {entry!r} "
                "matches no function — fix the entry (a stale scope "
                "silently un-guards the donation bug)"
            )
        res = _Resolver(pv, mod, fn)
        aliases = mod.aliases()
        flagged = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            fq = resolve(node.func, aliases)
            if fq not in JIT_NAMES and (fq or "") != "jit":
                continue
            donate_expr = next(
                (k.value for k in node.keywords
                 if k.arg == "donate_argnums"), None,
            )
            if res.donates(donate_expr) is True:
                findings.append(Finding(
                    rule="mesh-donate-replicated-out",
                    file=mod.rel, line=node.lineno,
                    message=(
                        f"{fn_name} is declared replicated-out "
                        "(mesh_scope) but its jit resolves to NON-EMPTY "
                        "donate_argnums: donated replicated-output "
                        "executables corrupt on persistent-cache reload "
                        "(jax 0.4.37, two-process repro)"
                    ),
                    hint=(
                        "keep donation OFF (donate defaults False) until "
                        "the upstream aliasing bug is fixed"
                    ),
                    detail=f"{fn_name}: donation enabled on replicated-out program",
                ))
                flagged = True
        if not flagged:
            donate_default = _param_defaults(fn).get("donate")
            if (isinstance(donate_default, ast.Constant)
                    and donate_default.value is True):
                findings.append(Finding(
                    rule="mesh-donate-replicated-out",
                    file=mod.rel, line=fn.lineno,
                    message=(
                        f"{fn_name} (declared replicated-out) defaults "
                        "donate=True — the cache-reload aliasing bug "
                        "class (jax 0.4.37)"
                    ),
                    hint="default donate=False; see the repro note",
                    detail=f"{fn_name}: donation enabled on replicated-out program",
                ))
    return findings


def _arity_findings(index, pv, calls, func_index: dict) -> list:
    findings: list = []
    for mod in index.modules:
        aliases = mod.aliases()
        for _fn, call in calls[mod.modname]:
            dn = dotted_name(call.func) or ""
            if dn.split(".")[-1] != "shard_map":
                continue
            in_specs = next(
                (k.value for k in call.keywords if k.arg == "in_specs"), None
            )
            if not isinstance(in_specs, (ast.Tuple, ast.List)):
                continue
            target_expr = call.args[0] if call.args else next(
                (k.value for k in call.keywords if k.arg == "f"), None
            )
            n_params = None
            label = None
            t = unwrap_target(mod, aliases, target_expr)
            if t is None and isinstance(target_expr, ast.Lambda):
                t = ("lambda", target_expr)
            if t is not None and t[0] == "name":
                info = func_index.get(t[1])
                if info is not None and not info.node.args.vararg:
                    n_params = len(info.params())
                    if info.class_name and info.params()[:1] == ["self"]:
                        n_params -= 1
                    label = t[1].split(".")[-1]
            elif t is not None and t[0] == "lambda":
                lam = t[1]
                if not lam.args.vararg:
                    n_params = len(lam.args.posonlyargs + lam.args.args)
                    label = "<lambda>"
            if n_params is None or n_params == len(in_specs.elts):
                continue
            findings.append(Finding(
                rule="mesh-in-specs-arity",
                file=mod.rel, line=call.lineno,
                message=(
                    f"shard_map in_specs has {len(in_specs.elts)} specs "
                    f"but `{label}` takes {n_params} positional args"
                ),
                hint="one spec per mapped argument, in order",
                detail=(
                    f"in_specs arity {len(in_specs.elts)} != {n_params} "
                    f"params of {label}"
                ),
            ))
    return findings


def run(index: PackageIndex, mesh_scope: dict | None) -> list[Finding]:
    pv = PackageView.of(index)
    # One AST sweep + one function index, shared by every collector: the
    # gate runs on Docker builds and pre-commit loops, so the pass pays
    # for its (enclosing-function, call) pairs exactly once per module.
    func_index = build_func_index(index)
    calls = {m.modname: list(_calls_with_owner(m)) for m in index.modules}
    universe = _axis_universe(index, pv, calls)
    findings = _axis_findings(index, pv, universe, calls)
    findings += _arity_findings(index, pv, calls, func_index)
    findings += _jit_wrap_findings(index, pv, calls)
    findings += _declared_program_findings(index, pv, mesh_scope or {},
                                           func_index)
    # Dedup (fixture trees can reach a site twice through the walkers).
    seen: set = set()
    out: list = []
    for f in findings:
        k = (f.rule, f.file, f.line, f.detail)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out
