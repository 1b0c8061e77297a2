"""Pass 4 — determinism: nondeterministic constructs in byte-identity paths.

BASELINE.json's core invariant is byte-identical convergence: every replica
folding the same ordered op stream must produce the same bytes — states,
digests, summaries, object-store shas.  The scribe fold, the op-apply
kernels, and the summary codecs are therefore *deterministic functions* of
the log, and any host construct whose output depends on interpreter
identity or wall clock silently breaks them on exactly one replica,
which the divergence watchdog then reports as data corruption.

Scope: the module paths listed under ``determinism_scope`` in
``analysis/layers.json`` (op-apply kernels, scribe fold, summary codecs,
object store).  Rules:

- ``det-set-iteration``  — iterating / materializing a set (``for x in s``,
  ``list(s)``): PYTHONHASHSEED-dependent order.  ``sorted(s)``, ``min``/
  ``max``, membership tests stay silent.
- ``det-id-ordering``    — ``id()`` use: interpreter-run-dependent values
  (deadly as sort keys or serialized content).
- ``det-wallclock``      — ``time.time``/``monotonic``/``datetime.now``
  etc. (``time.sleep`` is pacing, not output — exempt).
- ``det-random``         — ``random.*``/``np.random.*``/``uuid``/``secrets``.
- ``det-hash-builtin``   — builtin ``hash()``: salted per process for str/
  bytes (``hashlib`` is the deterministic spelling and stays silent).

Set-typedness is inferred structurally: set literals/comprehensions,
``set()``/``frozenset()`` calls, unions/intersections of those, locals
assigned from them, and ``self.X`` attributes declared ``: set[...]`` or
initialized to ``set(...)`` in the class body / ``__init__``.
"""

from __future__ import annotations

import ast

from .core import Finding, Module, PackageIndex, resolve

WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "datetime.datetime.now", "datetime.datetime.utcnow", "datetime.date.today",
}
RANDOM_HEADS = ("random.", "numpy.random.", "secrets.", "uuid.")


def in_scope(rel: str, scope: list) -> bool:
    return any(rel == s or rel.startswith(s.rstrip("/") + "/") for s in scope)


class _SetTypes(ast.NodeVisitor):
    """Collect set-typed local names per function and set-typed ``self.X``
    attributes per class (from annotations and __init__ assignments)."""

    def __init__(self, mod: Module) -> None:
        self.mod = mod
        self.class_attrs: dict = {}      # class -> set of attr names
        self._stack: list = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append(node.name)
        self.class_attrs.setdefault(node.name, set())
        self.generic_visit(node)
        self._stack.pop()

    def _note_attr(self, target: ast.AST, value: ast.AST | None,
                   annotation: ast.AST | None) -> None:
        if not self._stack:
            return
        if (isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"):
            name = target.attr
        elif isinstance(target, ast.Name):
            name = target.id
        else:
            return
        if _is_set_annotation(annotation) or (value is not None and _is_set_expr(value, set())):
            self.class_attrs[self._stack[-1]].add(name)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._note_attr(node.target, node.value, node.annotation)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._note_attr(t, node.value, None)
        self.generic_visit(node)


def _is_set_annotation(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    txt = ast.unparse(ann) if not isinstance(ann, ast.Constant) else str(ann.value)
    head = txt.split("[")[0].strip().strip('"\'')
    return head in ("set", "frozenset", "Set", "FrozenSet", "typing.Set",
                    "typing.FrozenSet", "AbstractSet", "MutableSet")


def _is_set_expr(node: ast.AST, local_sets: set, class_attrs: set = frozenset()) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in ("set", "frozenset"):
            return True
        if isinstance(fn, ast.Attribute) and fn.attr in (
                "union", "intersection", "difference", "symmetric_difference",
                "copy") and _is_set_expr(fn.value, local_sets, class_attrs):
            return True
        return False
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr, ast.BitAnd,
                                                            ast.Sub, ast.BitXor)):
        return (_is_set_expr(node.left, local_sets, class_attrs)
                or _is_set_expr(node.right, local_sets, class_attrs))
    if isinstance(node, ast.Name):
        return node.id in local_sets
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr in class_attrs
    return False


def run(index: PackageIndex, scope: list) -> list[Finding]:
    findings: list[Finding] = []
    for mod in index.modules:
        if not in_scope(mod.rel, scope):
            continue
        aliases = mod.aliases()
        types = _SetTypes(mod)
        types.visit(mod.tree)
        for fn_node, class_name in _functions(mod.tree):
            _scan_function(mod, aliases, fn_node,
                           types.class_attrs.get(class_name, set()), findings)
    return findings


def _functions(tree: ast.Module):
    """Top-level functions and class methods, each exactly once, with the
    owning class name (nested defs scan as part of their parent)."""
    owner: dict = {}
    nested: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    owner[id(sub)] = node.name
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for sub in ast.walk(node):
                if sub is not node and isinstance(
                        sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nested.add(id(sub))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and id(node) not in nested:
            yield node, owner.get(id(node))


def _scan_function(mod: Module, aliases: dict, fn: ast.AST,
                   class_attrs: set, findings: list) -> None:
    name = fn.name

    # Per-use flow for local names: a name's set-typedness at line L is the
    # verdict of its LAST assignment before L — so ``docs = set(x); docs =
    # sorted(docs); for d in docs`` is silent (the hint's own fix), while
    # ``for d in s: ...`` before a later ``s = set(...)`` doesn't flag the
    # loop, and ``s = set(x); for d in s`` after it still does.
    assigns: list = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns.append((node.lineno, node.col_offset,
                            node.targets[0].id, node.value, None))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            assigns.append((node.lineno, node.col_offset,
                            node.target.id, node.value, node.annotation))
    assigns.sort(key=lambda a: (a[0], a[1]))

    def typed_at(var: str, line: int, stack: frozenset) -> bool:
        last = None
        for ln, _col, tgt, value, ann in assigns:
            if ln >= line:
                break
            if tgt == var:
                last = (ln, value, ann)
        if last is None:
            return False
        ln, value, ann = last
        if ann is not None and _is_set_annotation(ann):
            return True
        if value is None or (var, ln) in stack:
            return False
        return _expr_is_set(value, ln, stack | {(var, ln)})

    def _expr_is_set(node: ast.AST, line: int, stack: frozenset = frozenset()) -> bool:
        if isinstance(node, ast.Name):
            return typed_at(node.id, line, stack)
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr in class_attrs
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
            return (_expr_is_set(node.left, line, stack)
                    or _expr_is_set(node.right, line, stack))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("union", "intersection", "difference",
                                       "symmetric_difference", "copy"):
            return _expr_is_set(node.func.value, line, stack)
        return _is_set_expr(node, set(), class_attrs)

    def set_typed(e: ast.AST) -> bool:
        return _expr_is_set(e, getattr(e, "lineno", 0))

    def flag(rule: str, node: ast.AST, message: str, hint: str, detail: str) -> None:
        findings.append(Finding(rule=rule, file=mod.rel,
                                line=getattr(node, "lineno", 0),
                                message=f"{name}: {message}", hint=hint,
                                detail=f"{name}: {detail}"))

    for node in ast.walk(fn):
        if isinstance(node, ast.For) and set_typed(node.iter):
            seg = mod.segment(node.iter, limit=40)
            flag("det-set-iteration", node,
                 f"iterates a set (`{seg}`): PYTHONHASHSEED-dependent order",
                 "wrap in sorted(...) so every replica folds the same order",
                 f"set iteration over `{seg}`")
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if set_typed(gen.iter):
                    seg = mod.segment(gen.iter, limit=40)
                    flag("det-set-iteration", node,
                         f"comprehension over a set (`{seg}`)",
                         "wrap in sorted(...) so every replica folds the same order",
                         f"set iteration over `{seg}`")
        elif isinstance(node, ast.Call):
            fname = resolve(node.func, aliases)
            bare = fname.split(".")[-1] if fname else None
            if (isinstance(node.func, ast.Name)
                    and node.func.id in ("list", "tuple")
                    and node.args and set_typed(node.args[0])):
                seg = mod.segment(node.args[0], limit=40)
                flag("det-set-iteration", node,
                     f"materializes a set in hash order (`{bare}({seg})`)",
                     "use sorted(...) instead",
                     f"set materialization `{bare}({seg})`")
            elif isinstance(node.func, ast.Name) and node.func.id == "id":
                seg = mod.segment(node, limit=40)
                flag("det-id-ordering", node,
                     f"id() use (`{seg}`): interpreter-run-dependent value",
                     "key by a stable identifier (name, seq, sha) instead",
                     f"id() use `{seg}`")
            elif isinstance(node.func, ast.Name) and node.func.id == "hash":
                seg = mod.segment(node, limit=40)
                flag("det-hash-builtin", node,
                     f"builtin hash() (`{seg}`): salted per process for str/bytes",
                     "use hashlib for content hashes",
                     f"hash() use `{seg}`")
            elif fname in WALLCLOCK:
                flag("det-wallclock", node,
                     f"wall-clock read ({fname}) inside a byte-identity path",
                     "thread the timestamp in from the sequenced op instead",
                     f"wallclock {fname}")
            elif fname and fname.startswith(RANDOM_HEADS):
                flag("det-random", node,
                     f"nondeterministic source ({fname}) inside a byte-identity path",
                     "derive from the op stream (seq, client seed) instead",
                     f"random {fname}")
