"""The port's static analyzer (``fluidframework_tpu_torch.analysis``,
``fftpu-torch-check``) against the reference's.

Every test of ``tests/test_analysis.py`` runs here as a test of its own:
the port's copy of its code (``torch_twins.port_twin``: every
``fluidframework_tpu`` import pointed at the port, so ``PKG`` is
``fluidframework_tpu_torch/`` and the seeded violations land in a copy of
the port's tree) with its own assertions.  While it runs, every pass the
port runs on a fixture package also runs in the reference's analyzer on the
same directory with the same arguments, and so does every package load:
the two must give the same findings as ``(rule, file, line, detail)``
lists, or raise the same error.

The gates over the real tree read one whole-port scan by each analyzer,
made once per session and shared by the xdist workers through a file
(``whole_scan``): the port's CLI as a subprocess (``--json
--no-baseline``), and the reference's ``run_all`` with the port's
``layers.json`` and an empty baseline.  ``test_package_is_clean`` is the
port's tier-1 gate; ``test_whole_port_parity`` holds the raw findings of
the two analyzers equal over the port.
"""

from __future__ import annotations

import fcntl
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import torch_twins as twins

from fluidframework_tpu.analysis import cli as ref_cli
from fluidframework_tpu.analysis import core as ref_core
import test_analysis as ref_tests

from fluidframework_tpu_torch.analysis import cli as port_cli
from fluidframework_tpu_torch.analysis.core import Baseline

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "fluidframework_tpu_torch"
PASS_MODULES = ("blocking", "determinism", "donation", "jit_safety", "layer_check",
                "lock_consistency", "lock_order", "markchurn", "mesh_safety",
                "swallowed", "threads")
# The real-tree gates: served by the shared whole-port scan below.
WHOLE_TREE = ("test_package_is_clean", "test_console_entry_point_runs")
# Where the port's copy of the reference's source differs:
# - the git helper runs without a time limit; the port's copy gets one;
# - two seedings flip a donation the port's tree does not have (torch has
#   no buffer donation, so no program of the port donates): the port's copy
#   plants the same hazard as a donating program of its own beside the
#   engine, and as donation added to ``mesh_seg_program``.
SUBS = (
    ("cwd=cwd, check=True, capture_output=True,",
     "cwd=cwd, check=True, capture_output=True, timeout=60,"),
    ('"\\n\\ndef _seeded_bad(state, ops, pays):\\n"',
     '"\\n\\n_seeded_prog = jax.jit(mk.apply_megastep, donate_argnums=(0,))\\n"\n'
     '         "\\n\\ndef _seeded_bad(state, ops, pays):\\n"'),
    ('"    out = _fleet_megastep(state, ops, pays)\\n"',
     '"    out = _seeded_prog(state, ops, pays)\\n"'),
    ('s.replace("donate: bool = False", "donate: bool = True")',
     's.replace("    return program\\n",\n'
     '                         "    return jax.jit(program, donate_argnums=(0,))\\n")'),
)


def port_module():
    return twins.port_twin("test_analysis.py", SUBS)


def _cases() -> list[tuple[str, str, dict]]:
    """``(id, test name, keyword params)`` for every test of the reference
    module, parametrized ones expanded (ids as pytest gives them there),
    the params those of the port's copy."""
    assert [n for n in vars(ref_tests) if n.startswith("test_")] == [
        n for n in vars(port_module()) if n.startswith("test_")]
    out = []
    for name, fn in vars(port_module()).items():
        if not (name.startswith("test_") and inspect.isfunction(fn)) or name in WHOLE_TREE:
            continue
        sets = [({}, [])]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            names = [n.strip() for n in mark.args[0].split(",")]
            ids = mark.kwargs.get("ids")
            vals = [v if len(names) > 1 else (v,) for v in mark.args[1]]
            sets = [({**kw, **dict(zip(names, v))}, tag + [ids[i] if ids else str(v[0])])
                    for kw, tag in sets for i, v in enumerate(vals)]
        for kw, tag in sets:
            out.append((f"{name}[{'-'.join(tag)}]" if tag else name, name, kw))
    return out


CASES = _cases()


def _keyed(findings) -> list[tuple]:
    return [(f.rule, f.file, f.line, f.detail) for f in findings]


def _outcome(fn):
    try:
        return "ok", fn()
    except Exception as e:  # the same refusal must come from both analyzers
        return "raised", e


class Twin:
    """Runs the reference's pass (or package load) beside each of the
    port's and requires equal results."""

    def __init__(self):
        self.compared = 0
        self.ref_index: dict = {}  # id(port index) -> (port index, the reference's)

    def check(self, port_call, ref_call, key):
        got_kind, got = _outcome(port_call)
        want_kind, want = _outcome(ref_call)
        if got_kind == "raised" or want_kind == "raised":
            assert (got_kind, type(got).__name__, str(got)) == (
                want_kind, type(want).__name__, str(want)), key
        else:
            assert key(got) == key(want)
        self.compared += 1
        if got_kind == "raised":
            raise got
        return got

    def pass_run(self, port_run, ref_run):
        def run(index, *a, **kw):
            pair = self.ref_index.get(id(index))
            ref = (pair[1] if pair is not None and pair[0] is index
                   else ref_core.load_package(index.pkg_dir))
            return self.check(lambda: port_run(index, *a, **kw),
                              lambda: ref_run(ref, *a, **kw), _keyed)
        return run

    def load(self, port_load):
        def load(pkg_dir):
            ref = []
            index = self.check(
                lambda: port_load(pkg_dir),
                lambda: ref.append(ref_core.load_package(pkg_dir)) or ref[0],
                lambda idx: [m.rel for m in idx.modules])
            self.ref_index[id(index)] = (index, ref[0])
            return index
        return load


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twin(case, request, monkeypatch):
    """The reference test's copy in the port, its assertions held, every
    analysis it makes held finding for finding to the reference's."""
    _cid, name, params = case
    mod = port_module()
    twin = Twin()
    for pm in PASS_MODULES:
        port_mod = getattr(mod, pm)
        ref_mod = getattr(ref_tests, pm)
        monkeypatch.setattr(port_mod, "run", twin.pass_run(port_mod.run, ref_mod.run))
    monkeypatch.setattr(port_cli, "load_package", twin.load(port_cli.load_package))
    monkeypatch.setattr(mod, "load_package", twin.load(mod.load_package))
    fn = getattr(mod, name)
    wanted = [p for p in inspect.signature(fn).parameters if p not in params]
    fn(**params, **{w: request.getfixturevalue(w) for w in wanted})
    if "tmp_path" in wanted and not twin.compared:
        # The body analyzed none of its fixture packages (it failed before
        # the analysis, as it meant to): run each through both analyzers.
        tmp = request.getfixturevalue("tmp_path")
        pkgs = sorted(p.parent.parent for p in tmp.rglob("analysis/layers.json"))
        assert pkgs, "the test built no fixture package"
        for pkg in pkgs:
            got, want = port_cli.run_all(pkg), ref_cli.run_all(pkg)
            for k in ("findings", "suppressed"):
                assert _keyed(got[k]) == _keyed(want[k]), (pkg, k)
            assert got["stale_baseline"] == want["stale_baseline"]


# ------------------------------------------------------------ the whole tree

def _scan(out_dir: Path) -> dict:
    empty = out_dir / "empty_baseline.json"
    empty.write_text(json.dumps({"suppressions": []}))
    proc = subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.analysis.cli", str(PKG),
         "--json", "--no-baseline"],
        capture_output=True, text=True, cwd=str(REPO), timeout=300,
    )
    ref = ref_cli.run_all(PKG, layers_path=PKG / "analysis" / "layers.json",
                          baseline_path=empty)
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr,
            "ref_findings": _keyed(ref["findings"]), "ref_n_modules": ref["n_modules"]}


@pytest.fixture(scope="module")
def whole_scan(tmp_path_factory):
    """One scan of the port's tree by each analyzer for the session: the
    first worker to get here makes it under a file lock, the others read
    its file."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = shared / "torch_analysis_scan.json"
    with open(shared / "torch_analysis_scan.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}")
                tmp.write_text(json.dumps(_scan(shared)))
                tmp.replace(out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return json.loads(out.read_text())


def test_package_is_clean(whole_scan):
    """The port's tier-1 gate: no unsuppressed finding on the committed
    tree, no stale baseline entry, every suppression with a rationale, no
    ``blocking-under-lock`` suppressed at all."""
    assert whole_scan["rc"] == 0, whole_scan["stdout"] + whole_scan["stderr"]
    result = json.loads(whole_scan["stdout"])
    assert result["n_modules"] > 100
    assert result["clean"] is True
    assert not result["stale_baseline"], (
        f"stale baseline entries (remove them): {result['stale_baseline']}")
    entries = json.loads((PKG / "analysis" / "baseline.json").read_text())["suppressions"]
    Baseline.load(PKG / "analysis" / "baseline.json")  # refuses a missing rationale
    assert all(e["rationale"].strip() for e in entries)
    assert result["n_suppressed"] == len(result["findings"])
    assert not [e for e in entries if e["rule"] == "blocking-under-lock"]


def test_console_entry_point_runs(whole_scan):
    """``python -m fluidframework_tpu_torch.analysis.cli <pkg>`` (the
    ``fftpu-torch-check`` body) exits 0 on the committed tree."""
    assert whole_scan["rc"] == 0, whole_scan["stdout"] + whole_scan["stderr"]
    result = json.loads(whole_scan["stdout"])
    assert result["clean"] is True and result["counts"] == {}


def test_whole_port_parity(whole_scan):
    """Both analyzers over the port's tree, with its layers.json and no
    baseline, give the same raw findings."""
    result = json.loads(whole_scan["stdout"])
    got = [(f["rule"], f["file"], f["line"], f["detail"]) for f in result["findings"]]
    want = [tuple(f) for f in whole_scan["ref_findings"]]
    assert got == want
    assert result["n_modules"] == whole_scan["ref_n_modules"]


def test_cli_text_mode_on_the_port(tmp_path):
    """The console script's text report, as the reference's console test
    reads it, on a package with nothing to find: exit 0 and the summary
    line's ``0 findings``."""
    pkg = tmp_path / "fluidframework_tpu_torch"
    (pkg / "analysis").mkdir(parents=True)
    (pkg / "analysis" / "layers.json").write_text(json.dumps(ref_tests.FIXTURE_LAYERS))
    (pkg / "low.py").write_text("X = 1\n")
    proc = subprocess.run(
        [sys.executable, "-m", "fluidframework_tpu_torch.analysis.cli", str(pkg)],
        capture_output=True, text=True, cwd=str(REPO), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "fftpu-torch-check: 1 modules, 0 findings" in proc.stdout
