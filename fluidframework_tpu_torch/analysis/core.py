"""Shared machinery for the fftpu-check passes.

Everything here is pure stdlib ``ast``: the passes must run on a box with
no JAX installed (CI lint tier) and must never import the code under
analysis (importing the package would pull in jax + device init, and an
import-time crash in analyzed code would take the analyzer down with it).
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path


# --------------------------------------------------------------------------
# Findings + baseline
# --------------------------------------------------------------------------

@dataclass
class Finding:
    """One analyzer hit.

    ``detail`` is the stable fingerprint half: baseline entries match on
    ``(rule, file, detail)`` and deliberately NOT on ``line``, so a vetted
    suppression survives unrelated edits shifting line numbers.
    """

    rule: str
    file: str  # posix path relative to the package root's parent
    line: int
    message: str
    hint: str = ""
    detail: str = ""

    def key(self) -> tuple:
        return (self.rule, self.file, self.detail or self.message)

    def render(self) -> str:
        loc = f"{self.file}:{self.line}"
        out = f"{self.rule}  {loc}  {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "file": self.file,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "detail": self.detail or self.message,
        }


class Baseline:
    """Committed suppressions for vetted legacy findings.

    Schema (``analysis/baseline.json``)::

        {"version": 1,
         "suppressions": [
            {"rule": ..., "file": ..., "detail": ..., "rationale": ...},
         ]}

    Every entry MUST carry a non-empty rationale — the analyzer refuses a
    baseline with silent entries (a suppression nobody can explain is a
    finding in itself).  Entries that no longer match any finding are
    reported as *stale* so the baseline shrinks as fixes land.
    """

    def __init__(self, entries: list[dict] | None = None) -> None:
        self.entries = entries or []
        for e in self.entries:
            if not str(e.get("rationale", "")).strip():
                raise ValueError(
                    f"baseline entry without rationale: "
                    f"{e.get('rule')} {e.get('file')} {e.get('detail')!r}"
                )

    @classmethod
    def load(cls, path: Path | str) -> "Baseline":
        data = json.loads(Path(path).read_text())
        return cls(data.get("suppressions", []))

    @staticmethod
    def entry_key(e: dict) -> tuple:
        return (e.get("rule"), e.get("file"), e.get("detail"))

    def apply(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding], list[dict]]:
        """-> (unsuppressed, suppressed, stale_entries)."""
        index = {self.entry_key(e): e for e in self.entries}
        used: set = set()
        keep: list[Finding] = []
        quiet: list[Finding] = []
        for f in findings:
            if f.key() in index:
                used.add(f.key())
                quiet.append(f)
            else:
                keep.append(f)
        stale = [e for e in self.entries if self.entry_key(e) not in used]
        return keep, quiet, stale


# --------------------------------------------------------------------------
# Package loading
# --------------------------------------------------------------------------

@dataclass
class Module:
    path: Path
    rel: str          # "fluidframework_tpu/server/scribe.py"
    modname: str      # "fluidframework_tpu.server.scribe"
    subpackage: str   # "server" ("<root>" for top-level modules)
    tree: ast.Module
    source: str

    def segment(self, node: ast.AST, limit: int = 60) -> str:
        """Source text of a node, squashed for finding details."""
        try:
            seg = ast.get_source_segment(self.source, node) or ""
        except Exception:
            seg = ""
        seg = " ".join(seg.split())
        return seg[:limit] + ("…" if len(seg) > limit else "")

    def aliases(self) -> dict:
        """Memoized ``alias_map`` — the passes resolve names per function
        and recomputing the import table per function is quadratic."""
        cached = getattr(self, "_aliases", None)
        if cached is None:
            cached = alias_map(self)
            object.__setattr__(self, "_aliases", cached)
        return cached


@dataclass
class PackageIndex:
    pkg_dir: Path
    name: str
    modules: list[Module] = field(default_factory=list)

    def by_modname(self, name: str) -> Module | None:
        for m in self.modules:
            if m.modname == name:
                return m
        return None

    @property
    def subpackages(self) -> set:
        return {m.subpackage for m in self.modules if m.subpackage != "<root>"}


def load_package(pkg_dir: Path | str) -> PackageIndex:
    pkg_dir = Path(pkg_dir).resolve()
    idx = PackageIndex(pkg_dir=pkg_dir, name=pkg_dir.name)
    root = pkg_dir.parent
    for path in sorted(pkg_dir.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        rel = path.relative_to(root).as_posix()
        parts = path.relative_to(root).with_suffix("").parts
        modname = ".".join(parts[:-1] + (parts[-1],))
        if parts[-1] == "__init__":
            modname = ".".join(parts[:-1])
        if path.parent == pkg_dir:
            sub = "<root>"  # top-level module / the package __init__
        else:
            sub = path.relative_to(pkg_dir).parts[0]
        idx.modules.append(
            Module(path=path, rel=rel, modname=modname, subpackage=sub,
                   tree=tree, source=source)
        )
    return idx


# --------------------------------------------------------------------------
# Import resolution
# --------------------------------------------------------------------------

@dataclass
class ResolvedImport:
    target: str        # fully-qualified module (or symbol) name
    line: int
    type_checking: bool


def _type_checking_lines(tree: ast.Module) -> set:
    """Line ranges of ``if TYPE_CHECKING:`` bodies (imports there are
    erased at runtime — the sanctioned way to type-hint across layers).
    Only the exact guard counts: ``if not TYPE_CHECKING:`` or
    ``if TYPE_CHECKING or X:`` bodies DO run and get no exemption."""
    def is_guard(test: ast.AST) -> bool:
        if isinstance(test, ast.Name):
            return test.id == "TYPE_CHECKING"
        if isinstance(test, ast.Attribute):
            return test.attr == "TYPE_CHECKING"
        return False

    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and is_guard(node.test):
            for sub in node.body:
                for n in ast.walk(sub):
                    if hasattr(n, "lineno"):
                        out.add(n.lineno)
    return out


def iter_imports(mod: Module) -> list[ResolvedImport]:
    """Every import in the module resolved to absolute dotted names.

    Relative imports resolve against the module's own package path; for
    ``from PKG import name`` each alias resolves one level deeper (the
    alias may itself be a subpackage — ``from fluidframework_tpu import
    parallel``)."""
    tc = _type_checking_lines(mod.tree)
    # Package path the relative imports resolve against.
    is_pkg_init = mod.path.name == "__init__.py"
    self_pkg = mod.modname if is_pkg_init else mod.modname.rsplit(".", 1)[0]
    out: list[ResolvedImport] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out.append(ResolvedImport(a.name, node.lineno, node.lineno in tc))
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                comps = self_pkg.split(".")
                comps = comps[: len(comps) - (node.level - 1)]
                base = ".".join(comps + ([node.module] if node.module else []))
            for a in node.names:
                target = f"{base}.{a.name}" if base else a.name
                out.append(ResolvedImport(target, node.lineno, node.lineno in tc))
    return out


def alias_map(mod: Module) -> dict:
    """Local name -> fully-qualified dotted target, for resolving
    ``mk.apply_ops`` / ``jnp.any`` / ``partial`` style references."""
    is_pkg_init = mod.path.name == "__init__.py"
    self_pkg = mod.modname if is_pkg_init else mod.modname.rsplit(".", 1)[0]
    out: dict = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
                if a.asname:
                    out[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                base = node.module or ""
            else:
                comps = self_pkg.split(".")
                comps = comps[: len(comps) - (node.level - 1)]
                base = ".".join(comps + ([node.module] if node.module else []))
            for a in node.names:
                target = f"{base}.{a.name}" if base else a.name
                out[a.asname or a.name] = target
    return out


def dotted_name(expr: ast.AST) -> str | None:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts: list[str] = []
    node = expr
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve(expr: ast.AST, aliases: dict) -> str | None:
    """Resolve an expression to a fully-qualified dotted name using the
    module's import aliases (``mk.apply_ops`` ->
    ``fluidframework_tpu.ops.mergetree_kernel.apply_ops``)."""
    dn = dotted_name(expr)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    fq = aliases.get(head, head)
    return f"{fq}.{rest}" if rest else fq


def resolve_in(mod: Module, aliases: dict, expr: ast.AST) -> str | None:
    """``resolve`` + fallback: unqualified references (no import alias on
    the head) are module-local definitions -> ``<modname>.<name>``."""
    dn = dotted_name(expr)
    if dn is None:
        return None
    if dn.split(".")[0] in aliases:
        return resolve(expr, aliases)
    pkg_root = mod.modname.split(".")[0]
    if dn.startswith(pkg_root + ".") or dn == pkg_root:
        return dn
    return f"{mod.modname}.{dn}"


# --------------------------------------------------------------------------
# Function index (shared by jit-safety / donation / mesh-safety)
# --------------------------------------------------------------------------

@dataclass
class FuncInfo:
    mod: Module
    node: ast.AST                 # FunctionDef | Lambda
    qualname: str                 # "pkg.mod.f" / "pkg.mod.Class.m"
    class_name: str | None = None

    def params(self) -> list[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args]
        return names

    def kwonly(self) -> list[str]:
        return [p.arg for p in self.node.args.kwonlyargs]


def build_func_index(index: PackageIndex) -> dict:
    out: dict = {}
    for mod in index.modules:
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out[f"{mod.modname}.{node.name}"] = FuncInfo(
                    mod, node, f"{mod.modname}.{node.name}")
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        q = f"{mod.modname}.{node.name}.{sub.name}"
                        out[q] = FuncInfo(mod, sub, q, class_name=node.name)
    return out


# --------------------------------------------------------------------------
# Symbol tables for the concurrency passes (threads / lock-order /
# lock-consistency / blocking-under-lock).  One copy here: the suite is 11
# passes and cannot afford private walkers per pass.
# --------------------------------------------------------------------------

HANDLER_BASES = {
    "StreamRequestHandler", "BaseRequestHandler", "DatagramRequestHandler",
    "BaseHTTPRequestHandler", "SimpleHTTPRequestHandler",
}


@dataclass(frozen=True)
class FuncKey:
    """A function's identity for the concurrency walkers.  ``modname`` is
    None for the per-module passes (threads), set for the package-wide
    walks (lock-order / blocking-under-lock)."""

    class_name: str | None
    name: str
    modname: str | None = None

    def label(self) -> str:
        return (f"{self.class_name}.{self.name}" if self.class_name
                else self.name)


class ModuleView:
    """Per-module symbol tables: top-level functions, classes + their
    methods, socketserver/http handler subclasses, and per-class
    ``self.X = ClassName(...)`` attribute types."""

    def __init__(self, mod: Module) -> None:
        self.mod = mod
        self.aliases = mod.aliases()
        self.functions: dict = {}    # FuncKey(class, name) -> FunctionDef
        self.classes: dict = {}      # name -> ClassDef
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[FuncKey(None, node.name)] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.functions[FuncKey(node.name, sub.name)] = sub

    def handler_classes(self) -> set:
        out = set()
        for name, node in self.classes.items():
            for base in node.bases:
                dn = dotted_name(base) or ""
                if dn.split(".")[-1] in HANDLER_BASES:
                    out.add(name)
        return out


def local_types(fn: ast.AST, view: ModuleView) -> dict:
    """var name -> class name, from ``x = ClassName(...)`` and ``x: T``
    annotations (string annotations included)."""
    out: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            dn = dotted_name(node.value.func)
            if dn in view.classes:
                out[node.targets[0].id] = dn
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            ann = node.annotation
            txt = (ann.value if isinstance(ann, ast.Constant)
                   else ast.unparse(ann))
            head = str(txt).strip().strip('"\'').split("[")[0].split(".")[-1]
            if head in view.classes:
                out[node.target.id] = head
    # Parameter annotations.
    args = getattr(fn, "args", None)
    if args is not None:
        for p in args.posonlyargs + args.args + args.kwonlyargs:
            if p.annotation is not None:
                txt = (p.annotation.value if isinstance(p.annotation, ast.Constant)
                       else ast.unparse(p.annotation))
                head = str(txt).strip().strip('"\'').split("[")[0].split(".")[-1]
                if head in view.classes:
                    out[p.arg] = head
    return out


class PackageView:
    """Package-wide symbol tables + cross-module call resolution for the
    lock passes.  Resolution covers: module-local functions, ``self.``
    methods, locally-typed vars (constructor assignment / annotation —
    imported classes included), ``self.attr`` objects whose class is known
    from a constructor assignment anywhere in the owning class, and
    imported module functions (``recovery.write_checkpoint_records`` /
    ``from .recovery import write_checkpoint_records``)."""

    def __init__(self, index: PackageIndex) -> None:
        self.index = index
        self.pkg_root = index.name
        self.views: dict = {m.modname: ModuleView(m) for m in index.modules}
        # fq class name -> (modname, ClassName)
        self.classes: dict = {}
        for m in index.modules:
            for cname in self.views[m.modname].classes:
                self.classes[f"{m.modname}.{cname}"] = (m.modname, cname)
        self._attr_types: dict = {}   # (modname, Class) -> {attr: (mod, Cls)}
        self._fn_types: dict = {}     # FuncKey -> local var types

    @classmethod
    def of(cls, index: PackageIndex) -> "PackageView":
        """The memoized view for an index: three passes share one run's
        symbol tables instead of rebuilding them (the gate runs in every
        Docker build and pre-commit loop)."""
        pv = getattr(index, "_package_view", None)
        if pv is None:
            pv = cls(index)
            index._package_view = pv
        return pv

    def function(self, key: FuncKey) -> ast.AST | None:
        view = self.views.get(key.modname)
        if view is None:
            return None
        return view.functions.get(FuncKey(key.class_name, key.name))

    def all_functions(self):
        for modname, view in self.views.items():
            for k in view.functions:
                yield FuncKey(k.class_name, k.name, modname)

    # ------------------------------------------------------------- typing
    def _resolve_class(self, mod: Module, view: ModuleView,
                       ctor: ast.AST) -> tuple | None:
        """A ``ClassName(...)`` constructor expression -> (modname, Class)
        for classes defined anywhere in the package.  Imports through a
        subpackage facade (``from ..fanout import FanoutPlane`` riding the
        ``fanout/__init__`` re-export) chase one hop through the facade's
        own alias map."""
        dn = dotted_name(ctor)
        if dn is None:
            return None
        if dn in view.classes:
            return (mod.modname, dn)
        fq = resolve_in(mod, view.aliases, ctor)
        if not fq:
            return None
        loc = self.classes.get(fq)
        if loc is not None:
            return loc
        head, _, name = fq.rpartition(".")
        facade = self.views.get(head)
        if facade is not None and name:
            fq2 = facade.aliases.get(name)
            if fq2:
                return self.classes.get(fq2)
        return None

    def fn_local_types(self, key: FuncKey) -> dict:
        """var name -> (modname, Class), package-wide class resolution."""
        cached = self._fn_types.get(key)
        if cached is not None:
            return cached
        view = self.views[key.modname]
        mod = view.mod
        fn = self.function(key)
        out: dict = {}
        if fn is not None:
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call):
                    cls = self._resolve_class(mod, view, node.value.func)
                    if cls is not None:
                        out[node.targets[0].id] = cls
            # Annotations (parameter + AnnAssign), by bare class name.
            for var, cname in local_types(fn, view).items():
                out.setdefault(var, (mod.modname, cname))
            args = getattr(fn, "args", None)
            if args is not None:
                for p in args.posonlyargs + args.args + args.kwonlyargs:
                    if p.annotation is None:
                        continue
                    txt = (p.annotation.value
                           if isinstance(p.annotation, ast.Constant)
                           else ast.unparse(p.annotation))
                    head = (str(txt).strip().strip('"\'')
                            .split("[")[0].split(".")[-1])
                    for fqc, loc in self.classes.items():
                        if fqc.rsplit(".", 1)[-1] == head:
                            out.setdefault(p.arg, loc)
                            break
        self._fn_types[key] = out
        return out

    def attr_types(self, modname: str, class_name: str) -> dict:
        """self-attribute name -> (modname, Class) from constructor
        assignments (``self.X = ClassName(...)``) in the class body."""
        cache_key = (modname, class_name)
        cached = self._attr_types.get(cache_key)
        if cached is not None:
            return cached
        view = self.views[modname]
        mod = view.mod
        out: dict = {}
        cls = view.classes.get(class_name)
        if cls is not None:
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t = node.targets[0]
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and isinstance(node.value, ast.Call)):
                        loc = self._resolve_class(mod, view, node.value.func)
                        if loc is not None:
                            out[t.attr] = loc
        self._attr_types[cache_key] = out
        return out

    # --------------------------------------------------------- call edges
    def resolve_call(self, key: FuncKey, types: dict,
                     call: ast.Call) -> FuncKey | None:
        """Resolve a call site to a package FuncKey (None: not ours /
        not statically resolvable)."""
        view = self.views[key.modname]
        mod = view.mod
        func = call.func
        if isinstance(func, ast.Name):
            # Module-local function, or a from-imported one.
            if FuncKey(None, func.id) in view.functions:
                return FuncKey(None, func.id, key.modname)
            fq = view.aliases.get(func.id)
            if fq and fq.startswith(self.pkg_root + "."):
                return self._by_fq(fq)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        meth = func.attr
        if isinstance(base, ast.Name):
            if base.id == "self" and key.class_name:
                if FuncKey(key.class_name, meth) in view.functions:
                    return FuncKey(key.class_name, meth, key.modname)
                return None
            loc = types.get(base.id)
            if loc is not None:
                m2, c2 = loc
                if FuncKey(c2, meth) in self.views[m2].functions:
                    return FuncKey(c2, meth, m2)
                return None
            # alias.module_fn(...)  (e.g. ``recovery.write_checkpoint...``)
            fq = view.aliases.get(base.id)
            if fq and fq.startswith(self.pkg_root + "."):
                return self._by_fq(f"{fq}.{meth}")
            return None
        # self.attr.meth(): the attr's class from constructor assignments.
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self" and key.class_name):
            loc = self.attr_types(key.modname, key.class_name).get(base.attr)
            if loc is not None:
                m2, c2 = loc
                if FuncKey(c2, meth) in self.views[m2].functions:
                    return FuncKey(c2, meth, m2)
        # mod-qualified deep chains (pkg.sub.mod.fn).
        fq = resolve_in(mod, view.aliases, func)
        if fq and fq.startswith(self.pkg_root + "."):
            return self._by_fq(fq)
        return None

    def _by_fq(self, fq: str) -> FuncKey | None:
        """``pkg.a.b.f`` / ``pkg.a.b.Class.m`` -> FuncKey."""
        head, _, last = fq.rpartition(".")
        if head in self.views:
            if FuncKey(None, last) in self.views[head].functions:
                return FuncKey(None, last, head)
            return None
        m_head, _, cls = head.rpartition(".")
        if m_head in self.views and cls in self.views[m_head].classes:
            if FuncKey(cls, last) in self.views[m_head].functions:
                return FuncKey(cls, last, m_head)
        return None

    # ---------------------------------------------------- module constants
    def module_constants(self, modname: str) -> dict:
        """NAME -> str value for simple top-level string assignments
        (``SEG_AXIS = "segs"``) — the mesh-safety axis resolver's table."""
        view = self.views.get(modname)
        if view is None:
            return {}
        cached = getattr(view, "_constants", None)
        if cached is None:
            cached = {}
            for node in view.mod.tree.body:
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, str):
                    cached[node.targets[0].id] = node.value.value
            view._constants = cached
        return cached


# --------------------------------------------------------------------------
# Lock identity
# --------------------------------------------------------------------------

class LockNamer:
    """Name the lock behind a ``with <expr>:`` item.

    Identity scheme (the precision the lock passes need without a type
    system): an attribute named in the ``shared_locks`` registry unifies
    package-wide on its bare name (``self.ckpt_lock`` in the engine and
    ``engine.ckpt_lock`` in models/recovery are ONE lock); otherwise the
    id is class-qualified (``FanoutPlane._lock``) when the base object's
    class is known, and module-qualified (``mod:?.attr``) when not — so
    the dozen unrelated ``_lock`` attributes never collapse into false
    cycles."""

    def __init__(self, shared: frozenset) -> None:
        self.shared = frozenset(shared)

    def name(self, expr: ast.AST, *, modname: str, class_name: str | None,
             types: dict) -> str | None:
        if isinstance(expr, ast.Name):
            if expr.id in self.shared:
                return expr.id
            return f"{modname}:{expr.id}"
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            if attr in self.shared:
                return attr
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and class_name:
                    return f"{class_name}.{attr}"
                loc = types.get(base.id)
                if loc is not None:
                    cls = loc[1] if isinstance(loc, tuple) else loc
                    return f"{cls}.{attr}"
            return f"{modname}:?.{attr}"
        return None


# --------------------------------------------------------------------------
# The lock-flow scanner + worklist engine
# --------------------------------------------------------------------------

class LockFlowScan:
    """One function body scanned under an inherited held-lock set.

    Collects, with the exact held set at each site:

    - ``writes``   — attribute assignments: (attr, line, held, is_self,
      owner_class or None for untyped bases)
    - ``acquires`` — ``with <lock>:`` items: (lock_id, line, held_before)
    - ``edges``    — resolved package call sites: (FuncKey|local key,
      held, line)
    - ``calls``    — EVERY call site: (ast.Call, held) — the
      blocking-under-lock classifier's feed

    ``resolver(call, types) -> key | None`` abstracts module-local
    (threads) vs package-wide (lock passes) call resolution, so this is
    the ONE walker all four lock-aware passes share."""

    def __init__(self, fn: ast.AST, held: frozenset, namer: LockNamer, *,
                 modname: str, class_name: str | None, types: dict,
                 resolver) -> None:
        self.fn = fn
        self.base_held = frozenset(held)
        self.namer = namer
        self.modname = modname
        self.class_name = class_name
        self.types = types
        self.resolver = resolver
        self.writes: list = []
        self.acquires: list = []
        self.edges: list = []
        self.calls: list = []

    def run(self) -> "LockFlowScan":
        self._scan(self.fn.body, self.base_held)
        return self

    def _scan(self, stmts: list, held: frozenset) -> None:  # noqa: C901
        for st in stmts:
            if isinstance(st, ast.With):
                # Items evaluate LEFT TO RIGHT with earlier items' locks
                # already held: ``with a, b:`` acquires b under a (the
                # a -> b edge), and a blocking context expr in a later
                # item runs under the earlier locks.
                inner = set(held)
                for item in st.items:
                    self._expr(item.context_expr, frozenset(inner))
                    if isinstance(item.context_expr, (ast.Name, ast.Attribute)):
                        lid = self.namer.name(
                            item.context_expr, modname=self.modname,
                            class_name=self.class_name, types=self.types,
                        )
                        if lid is not None:
                            self.acquires.append(
                                (lid, item.context_expr.lineno,
                                 frozenset(inner))
                            )
                            inner.add(lid)
                self._scan(st.body, frozenset(inner))
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (st.targets if isinstance(st, ast.Assign)
                           else [st.target])
                for t in targets:
                    self._note_write(t, held)
                if getattr(st, "value", None) is not None:
                    self._expr(st.value, held)
                continue
            if isinstance(st, (ast.If, ast.While)):
                self._expr(st.test, held)
                self._scan(st.body, held)
                self._scan(st.orelse, held)
                continue
            if isinstance(st, ast.For):
                self._expr(st.iter, held)
                self._scan(st.body, held)
                self._scan(st.orelse, held)
                continue
            if isinstance(st, ast.Try):
                self._scan(st.body, held)
                for h in st.handlers:
                    self._scan(h.body, held)
                self._scan(st.orelse, held)
                self._scan(st.finalbody, held)
                continue
            for node in ast.walk(st):
                if isinstance(node, ast.expr):
                    self._expr(node, held, walk=False)

    def _note_write(self, target: ast.AST, held: frozenset) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._note_write(e, held)
            return
        if isinstance(target, ast.Starred):
            self._note_write(target.value, held)
            return
        if isinstance(target, ast.Subscript) and isinstance(
                target.value, ast.Attribute):
            # self.x[k] = v mutates the container held by attr x.
            target = target.value
        if isinstance(target, ast.Attribute):
            is_self = (isinstance(target.value, ast.Name)
                       and target.value.id == "self")
            owner = None
            if is_self:
                owner = self.class_name
            elif isinstance(target.value, ast.Name):
                loc = self.types.get(target.value.id)
                if loc is not None:
                    owner = loc[1] if isinstance(loc, tuple) else loc
            self.writes.append(
                (target.attr, target.lineno, held, is_self, owner))

    def _expr(self, node: ast.AST, held: frozenset, walk: bool = True) -> None:
        nodes = ast.walk(node) if walk else [node]
        for n in nodes:
            if isinstance(n, ast.Call):
                self.calls.append((n, held))
                callee = self.resolver(n, self.types)
                if callee is not None:
                    self.edges.append((callee, held, getattr(n, "lineno", 0)))


def walk_lock_flow(entries, make_scan, max_items: int = 200000,
                   canonical=None) -> dict:
    """The shared worklist: ``entries`` is [(key, held_frozenset)];
    ``make_scan(key, held) -> LockFlowScan | None`` (None: key has no
    body we can scan).  Each (key, held) context is scanned exactly once;
    call edges enqueue the callee under the callsite's held set, passed
    through ``canonical`` when given (the blocking pass projects held
    sets onto the critical locks there, bounding the context count).
    Returns {key: {held: scan}}.

    Exhausting ``max_items`` RAISES: a truncated walk would report clean
    on an unfinished analysis — the gate must fail loudly, never
    false-clean (the current package uses ~3k items; the ceiling exists
    only to turn a pathological context explosion into a visible error).
    """
    done: dict = {}
    work = list(entries)
    budget = max_items
    while work:
        if budget <= 0:
            raise RuntimeError(
                f"lock-flow walk exceeded its {max_items}-item work "
                "budget — context explosion; raise max_items or add a "
                "canonicalizer"
            )
        budget -= 1
        key, held = work.pop()
        ctxs = done.setdefault(key, {})
        if held in ctxs:
            continue
        scan = make_scan(key, held)
        ctxs[held] = scan
        if scan is None:
            continue
        for callee, cheld, _line in scan.edges:
            work.append(
                (callee, canonical(cheld) if canonical is not None else cheld)
            )
    return done
