"""Pass 6 — swallowed-exception: bare ``except ...: pass`` in serving code.

The host and service layers (driver/framework/loader + server/tools/
testing/analysis) are where a silently swallowed exception turns a crash
into an invisible wedge: a supervisor that "handles" a failed respawn by
dropping it relaunches nothing; a front that eats an OSError mid-teardown
leaks sessions; a consumer that swallows a decode error serves stale state
forever.  The kernels/state layers get latitude — probing device features
and unwinding optimistic paths legitimately discard exceptions — so this
pass runs ONLY on modules at or above the ``host`` layer.

Finding: ``swallowed-exception`` — an ``except`` handler whose entire body
is ``pass``.  A handler that at least counts, logs, re-raises, breaks, or
returns is not flagged (the point is that SOMETHING observable or
control-flow-relevant must happen).  Vetted swallows (e.g. "peer went away
during teardown, cleanup happens in the finally") live in the baseline
with a mandatory rationale, same contract as every other pass — or are
rewritten as ``contextlib.suppress(...)``, the stdlib's explicit
this-is-intentional spelling, which this pass deliberately does not chase.

The fingerprint (``detail``) is the squashed handler header + enclosing
function, so a baseline entry survives unrelated line drift.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, PackageIndex

# Default layers this pass covers.  The committed layers.json pins the
# scope EXPLICITLY via its "swallowed_scope" key — an explicit scope naming
# a layer that no longer exists fails loudly, so a layer reshuffle can
# never silently narrow coverage.  Packages without the key (fixture
# trees) get the default intersected with whatever layers they define.
COVERED_LAYERS = ("host", "service")


def _covered_packages(layers: dict, scope_names=None) -> set:
    """Subpackages assigned to a covered layer; ``layers`` is
    ``load_layers`` output ({subpackage: (rank, layer_name)})."""
    defined = {name for _rank, name in layers.values()}
    if scope_names is not None:
        unknown = set(scope_names) - defined
        if unknown:
            raise ValueError(
                f"swallowed_scope names unknown layer(s) {sorted(unknown)} "
                "— swallowed-exception pass has no scope there"
            )
        covered_names = set(scope_names)
    else:
        covered_names = set(COVERED_LAYERS) & defined
    return {
        pkg for pkg, (_rank, name) in layers.items()
        if name in covered_names
    }


def _enclosing_functions(tree: ast.Module) -> dict:
    """handler-id -> dotted enclosing scope name (for the fingerprint)."""
    out: dict = {}

    def walk(node: ast.AST, scope: str) -> None:
        for child in ast.iter_child_nodes(node):
            name = scope
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{scope}.{child.name}" if scope else child.name
            if isinstance(child, ast.ExceptHandler):
                out[id(child)] = scope or "<module>"
            walk(child, name)

    walk(tree, "")
    return out


def _handler_types(handler: ast.ExceptHandler) -> str:
    if handler.type is None:
        return "<bare>"
    return " ".join(ast.unparse(handler.type).split())


def run(index: PackageIndex, layers: dict, scope_names=None) -> list[Finding]:
    covered = _covered_packages(layers, scope_names)
    findings: list[Finding] = []
    for mod in index.modules:
        if mod.subpackage not in covered:
            continue
        findings.extend(_run_module(mod))
    return findings


def _run_module(mod: Module) -> list[Finding]:
    out: list[Finding] = []
    scopes = _enclosing_functions(mod.tree)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not (len(node.body) == 1 and isinstance(node.body[0], ast.Pass)):
            continue
        types = _handler_types(node)
        scope = scopes.get(id(node), "<module>")
        out.append(Finding(
            rule="swallowed-exception",
            file=mod.rel,
            line=node.lineno,
            message=(
                f"except {types}: pass in {scope} swallows the failure "
                "silently"
            ),
            hint=(
                "count/log/re-raise it, narrow it into "
                "contextlib.suppress(...) if discarding is the intent, "
                "or baseline it with a rationale"
            ),
            detail=f"except {types}: pass in {scope}",
        ))
    return out
