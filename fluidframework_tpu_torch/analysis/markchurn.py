"""Pass 7 — fold-mark-churn: per-commit mark-object allocation in the
pooled tree fold.

The tree family's host fold moved to the pooled columnar mark store
(dds/tree/mark_pool.py): marks live as int32/object columns, rebase runs
as column passes, and ``Mark.__init__`` left the profile.  The idiom this
pass keeps out is the one that put it there: constructing a mark dataclass
(``Skip``/``Insert``/``Remove``/``Modify``/``MoveOut``/``MoveIn``) inside
a loop in the fold modules — one object per mark per commit per window
entry, the exact churn the pool replaced.  The object ORACLE
(changeset.py) legitimately allocates marks everywhere; it is therefore
not in scope — the scope is the pooled fold itself, where a mark
constructor in a loop means someone quietly re-introduced per-commit
materialization on the hot path.

Scope is declared in layers.json under ``fold_churn_scope``::

    "fold_churn_scope": {
        "files":   ["fluidframework_tpu/dds/tree/mark_pool.py", ...],
        "classes": ["Skip", "Insert", "Remove", ...],
        "exempt_functions": ["to_marks", ...]
    }

``exempt_functions`` names the sanctioned materialization boundaries (the
oracle handoff, e.g. ``PooledMarks.to_marks``): those exist precisely to
build object marks, and exempting them by NAME keeps the exemption
reviewable in the same committed config as the scope.  A missing
``fold_churn_scope`` key disables the pass (fixture packages), matching
how ``determinism_scope`` gates the determinism pass.

Finding: ``fold-mark-churn`` — file:line of the constructor call, with the
enclosing function and loop line in the detail fingerprint.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, PackageIndex


# Comprehensions allocate per element — the same churn shape as a loop.
_LOOPS = (ast.For, ast.AsyncFor, ast.While,
          ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _enclosing(tree: ast.Module) -> dict:
    """node-id -> (dotted function scope, innermost enclosing loop node;
    comprehensions count as loops)."""
    out: dict = {}

    def walk(node: ast.AST, scope: str, loop) -> None:
        for child in ast.iter_child_nodes(node):
            cscope, cloop = scope, loop
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                cscope = f"{scope}.{child.name}" if scope else child.name
                cloop = None  # a nested def starts its own loop context
            elif isinstance(child, _LOOPS):
                cloop = child
            out[id(child)] = (cscope, cloop)
            walk(child, cscope, cloop)

    walk(tree, "", None)
    return out


def _call_name(func: ast.AST) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def run(index: PackageIndex, scope_cfg: dict | None) -> list[Finding]:
    if not scope_cfg:
        return []
    files = set(scope_cfg.get("files", []))
    classes = set(scope_cfg.get("classes", []))
    exempt = set(scope_cfg.get("exempt_functions", []))
    if not files or not classes:
        return []
    findings: list[Finding] = []
    for mod in index.modules:
        if mod.rel not in files:
            continue
        findings.extend(_run_module(mod, classes, exempt))
    return findings


def _run_module(mod: Module, classes: set, exempt: set) -> list[Finding]:
    out: list[Finding] = []
    ctx = _enclosing(mod.tree)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        if name not in classes:
            continue
        scope, loop = ctx.get(id(node), ("<module>", None))
        if loop is None:
            continue  # one-off construction: not the churn shape
        fn = scope.rsplit(".", 1)[-1] if scope else "<module>"
        if fn in exempt:
            continue
        # Line-free fingerprint (baseline entries survive line drift).
        loop_kind = (
            "loop" if isinstance(loop, (ast.For, ast.AsyncFor, ast.While))
            else "comprehension"
        )
        out.append(Finding(
            rule="fold-mark-churn",
            file=mod.rel,
            line=node.lineno,
            message=(
                f"{name}(...) constructed per iteration in {scope or '<module>'} "
                "— per-commit mark materialization on the pooled fold path"
            ),
            hint=(
                "emit pooled column rows instead (mark_pool builder/seal); "
                "if this IS a sanctioned oracle boundary, add the function "
                "to fold_churn_scope.exempt_functions in layers.json"
            ),
            detail=f"{name} in {scope or '<module>'} ({loop_kind})",
        ))
    return out
