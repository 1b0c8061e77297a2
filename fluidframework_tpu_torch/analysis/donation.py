"""Pass 3 — donation: use-after-donate of ``donate_argnums`` arguments.

The reference's ``staging_aliased_swaps`` bug was exactly this class: a buffer
handed to a donated dispatch and then touched again on the host while XLA
already owned (and was overwriting) it.  On CPU the aliasing makes it a
silent corruption; on TPU a deleted-buffer error *if you're lucky*.

Mechanics: the jit-registration scan (shared with jit_safety) records every
callable wrapped with a non-empty ``donate_argnums`` — module-level
``X = jax.jit(f, donate_argnums=(0,))``, decorated defs,
``self._prog = mesh_fleet_program(...)`` (donates arg 0) — then every
function body is walked with a small dataflow: calling a donating callable
marks the argument expressions at donated positions (plain names or
``self.attr`` chains) as *surrendered*; any later read before a rebinding
is a ``donate-use-after-dispatch`` finding.  Branches analyze both arms
(union — donated in either arm is donated after), and loop bodies run
twice so a donation at the bottom of a loop poisons uses at the top of the
next iteration (the classic "dispatch in a loop without rebinding" bug).

The idiomatic pattern stays silent::

    self._state = self._megastep(self._state, ops, pays)   # rebind kills it
"""

from __future__ import annotations

import ast

from .core import Finding, Module, PackageIndex, build_func_index, dotted_name
from .jit_safety import scan_registrations


def _donators(index: PackageIndex) -> dict:
    """Callable key -> donated positions.

    Keys: fully-qualified bound names (``pkg.mod.X``) and bare ``self.X``
    attribute names (matched per call site on ``self.X(...)``)."""
    func_index = build_func_index(index)
    out: dict = {}
    for reg in scan_registrations(index, func_index):
        if not reg.wrap.donate_argnums or reg.bound_to is None:
            continue
        out[reg.bound_to] = frozenset(reg.wrap.donate_argnums)
    return out


class _FuncDonationScan:
    def __init__(self, mod: Module, donators: dict, display: str,
                 findings: list) -> None:
        self.mod = mod
        self.aliases = mod.aliases()
        self.donators = donators
        self.display = display
        self.findings = findings

    def _call_donates(self, call: ast.Call) -> frozenset | None:
        dn = dotted_name(call.func)
        if dn is None:
            return None
        if dn in self.donators:               # self.X(...) form
            return self.donators[dn]
        head = dn.split(".")[0]
        fq = self.aliases.get(head, None)
        if fq is not None:
            rest = dn.split(".", 1)
            cand = fq if len(rest) == 1 else f"{fq}.{rest[1]}"
            if cand in self.donators:
                return self.donators[cand]
        cand = f"{self.mod.modname}.{dn}"
        return self.donators.get(cand)

    @staticmethod
    def _argkey(expr: ast.AST) -> str | None:
        """Donated-argument tracking key: plain name or dotted attr chain."""
        return dotted_name(expr)

    def _loads_in(self, node: ast.AST) -> list:
        """(key, line) for every Name/Attribute *load* chain in ``node``."""
        out = []
        for n in ast.walk(node):
            if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(n, "ctx", None), ast.Load):
                # Only take maximal chains: skip if parent is an Attribute
                # load (handled at the parent).  Cheap approximation: emit
                # every chain; duplicates are harmless for matching.
                k = dotted_name(n)
                if k:
                    out.append((k, getattr(n, "lineno", 0)))
        return out

    def scan(self, stmts: list, donated: dict) -> dict:  # noqa: C901
        """``donated``: key -> line of the donating call.  Returns the
        donated set live at the end of the block."""
        for st in stmts:
            if isinstance(st, ast.If):
                # The test evaluates FIRST: a donating call inside it (e.g.
                # ``if prog(state, ops) is None:``) poisons both arms.
                self._check_expr(st.test, donated)
                d1 = self.scan(st.body, dict(donated))
                d2 = self.scan(st.orelse, dict(donated))
                donated = {**d1, **d2}
                continue
            if isinstance(st, (ast.For, ast.While)):
                if isinstance(st, ast.While):
                    self._check_expr(st.test, donated)
                else:
                    self._check_expr(st.iter, donated)
                # Two passes: donations at the bottom of the body reach
                # uses at the top on the next iteration.
                d = self.scan(st.body, dict(donated))
                d = self.scan(st.body, d)
                d = self.scan(st.orelse, d)
                donated = {**donated, **d}
                continue
            if isinstance(st, ast.Try):
                d = self.scan(st.body, dict(donated))
                for h in st.handlers:
                    d = self.scan(h.body, d)
                d = self.scan(st.orelse, d)
                donated = self.scan(st.finalbody, {**donated, **d})
                continue
            if isinstance(st, ast.With):
                for item in st.items:
                    self._check_expr(item.context_expr, donated)
                donated = self.scan(st.body, donated)
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # nested scope
            # Straight-line statement: check uses, record fresh donations,
            # THEN apply rebindings — `x = prog(x)` donates x and rebinds
            # it in the same statement, leaving nothing donated after.
            new_donations = self._check_stmt_uses_and_calls(st, donated)
            for k, line in new_donations.items():
                donated[k] = line
            if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = st.targets if isinstance(st, ast.Assign) else [st.target]
                for t in targets:
                    self._kill(t, donated)
        return donated

    def _kill(self, target: ast.AST, donated: dict) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._kill(e, donated)
            return
        if isinstance(target, ast.Starred):
            self._kill(target.value, donated)
            return
        k = dotted_name(target)
        if k is None and isinstance(target, ast.Subscript):
            k = dotted_name(target.value)
        if k:
            donated.pop(k, None)

    def _check_stmt_uses_and_calls(self, st: ast.AST, donated: dict) -> dict:
        """Flag reads of donated keys in ``st``; return fresh donations made
        by calls inside it (applied by the caller AFTER same-line rebinds
        are NOT yet visible -> a use in the very statement that donates is
        the call's own argument list, which is fine)."""
        new: dict = {}
        calls = [n for n in ast.walk(st) if isinstance(n, ast.Call)]
        donating_arg_nodes: set = set()
        for call in calls:
            positions = self._call_donates(call)
            if not positions:
                continue
            for i, arg in enumerate(call.args):
                if i in positions:
                    k = self._argkey(arg)
                    if k:
                        new[k] = call.lineno
                    for n in ast.walk(arg):
                        donating_arg_nodes.add(id(n))
        # Uses of previously-donated keys anywhere in this statement.  The
        # donating call's own arguments are exempt only for donations this
        # statement makes — feeding a buffer donated by an EARLIER dispatch
        # back in (the loop-without-rebind bug) is a use like any other.
        if donated:
            for n in ast.walk(st):
                if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                        getattr(n, "ctx", None), ast.Load):
                    k = dotted_name(n)
                    if id(n) in donating_arg_nodes and k not in donated:
                        continue
                    if k in donated:
                        self.findings.append(Finding(
                            rule="donate-use-after-dispatch",
                            file=self.mod.rel,
                            line=getattr(n, "lineno", 0),
                            message=(
                                f"{self.display}: `{k}` read after being "
                                f"donated to a dispatch at line {donated[k]} "
                                "(XLA owns that buffer now)"
                            ),
                            hint=(
                                "rebind the name to the dispatch result "
                                "(x = prog(x, ...)) or pass a copy"
                            ),
                            detail=f"{self.display}: use of `{k}` after donation",
                        ))
                        donated.pop(k, None)  # one finding per donation
        return new

    def _check_expr(self, expr: ast.AST | None, donated: dict) -> None:
        if expr is None:
            return
        fake = ast.Expr(value=expr)
        ast.copy_location(fake, expr)
        new = self._check_stmt_uses_and_calls(fake, donated)
        for k, line in new.items():
            donated[k] = line


def run(index: PackageIndex) -> list[Finding]:
    donators = _donators(index)
    findings: list[Finding] = []
    if not donators:
        return findings
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan = _FuncDonationScan(mod, donators, node.name, findings)
                scan.scan(node.body, {})
    return findings
