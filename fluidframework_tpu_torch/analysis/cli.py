"""``fftpu-torch-check``: run every pass over the port, apply the baseline.

A copy of ``fluidframework_tpu/analysis/cli.py``; the default package is
the port (``python -m fluidframework_tpu_torch.analysis.cli`` from the
repo root).

Usage::

    fftpu-torch-check fluidframework_tpu_torch/         # exit 0 iff clean
    fftpu-torch-check fluidframework_tpu_torch/ --json  # machine-readable
    fftpu-torch-check pkg/ --rules layer-check,determinism
    fftpu-torch-check pkg/ --no-baseline             # include suppressed findings
    fftpu-torch-check pkg/ --changed-only            # pre-commit: git-diff scope

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage/config error.

``--changed-only`` scopes the REPORT to modules touched by the working
tree's ``git diff`` (staged + unstaged + untracked).  The analysis itself
still runs package-wide — the cross-module passes (layer-check edges,
lock-order cycles, blocking-under-lock reach) need the whole call/import
graph to be sound — so the scoping degrades gracefully: a changed module
that completes a cross-module hazard still reports it, an unchanged
module's legacy findings stay out of the pre-commit loop.  Per-pass wall
time ships in ``--json`` (``pass_times_ms``) either way, so the bench/CI
artifacts can watch the gate's own budget.

The default layers/baseline configs are the committed
``<pkg>/analysis/layers.json`` and ``<pkg>/analysis/baseline.json``; both
are overridable so tests (and other repos) can point at fixtures.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from . import (
    blocking, determinism, donation, jit_safety, layer_check,
    lock_consistency, lock_order, markchurn, mesh_safety, swallowed, threads,
)
from .core import Baseline, Finding, load_package

PASSES = (
    "layer-check", "jit-safety", "donation", "determinism", "threads",
    "swallowed-exception", "fold-mark-churn", "lock-order",
    "lock-consistency", "blocking-under-lock", "mesh-safety",
)


def run_all(
    pkg_dir: Path | str,
    layers_path: Path | str | None = None,
    baseline_path: Path | str | None = None,
    rules: list | None = None,
    only_files: set | None = None,
) -> dict:
    """Run the suite; -> {"findings", "suppressed", "stale_baseline",
    "counts", "n_modules", "pass_times_ms"} with findings sorted by
    (file, line).  ``only_files`` (relative posix paths) filters the
    REPORTED findings — the analysis is package-wide regardless (see
    --changed-only)."""
    pkg_dir = Path(pkg_dir).resolve()
    if not pkg_dir.is_dir():
        raise FileNotFoundError(f"not a package directory: {pkg_dir}")
    if layers_path is None:
        layers_path = pkg_dir / "analysis" / "layers.json"
    if baseline_path is None:
        cand = pkg_dir / "analysis" / "baseline.json"
        baseline_path = cand if cand.exists() else None

    index = load_package(pkg_dir)
    layers_cfg = json.loads(Path(layers_path).read_text())
    layer_map = layer_check.load_layers(layers_path)
    det_scope = layers_cfg.get("determinism_scope", [])
    concurrency_scope = layers_cfg.get("concurrency_scope")
    mesh_scope = layers_cfg.get("mesh_scope")

    selected = set(rules or PASSES)
    unknown = selected - set(PASSES)
    if unknown:
        raise ValueError(f"unknown pass(es): {sorted(unknown)} (know {PASSES})")

    runners = {
        "layer-check": lambda: layer_check.run(index, layer_map),
        "jit-safety": lambda: jit_safety.run(index),
        "donation": lambda: donation.run(index),
        "determinism": lambda: determinism.run(index, det_scope),
        "threads": lambda: threads.run(index),
        "swallowed-exception": lambda: swallowed.run(
            index, layer_map, layers_cfg.get("swallowed_scope")
        ),
        "fold-mark-churn": lambda: markchurn.run(
            index, layers_cfg.get("fold_churn_scope")
        ),
        "lock-order": lambda: lock_order.run(index, concurrency_scope),
        "lock-consistency": lambda: lock_consistency.run(
            index, concurrency_scope
        ),
        "blocking-under-lock": lambda: blocking.run(index, concurrency_scope),
        "mesh-safety": lambda: mesh_safety.run(index, mesh_scope),
    }

    findings: list[Finding] = []
    pass_times_ms: dict = {}
    for name in PASSES:
        if name not in selected:
            continue
        t0 = time.perf_counter()
        findings += runners[name]()
        pass_times_ms[name] = round((time.perf_counter() - t0) * 1e3, 2)
    findings.sort(key=lambda f: (f.file, f.line, f.rule))

    baseline = Baseline.load(baseline_path) if baseline_path else Baseline()
    unsuppressed, suppressed, stale = baseline.apply(findings)
    if only_files is not None:
        unsuppressed = [f for f in unsuppressed if f.file in only_files]
        suppressed = [f for f in suppressed if f.file in only_files]
        stale = []  # full-tree bookkeeping: not a pre-commit concern
    counts: dict = {}
    for f in unsuppressed:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "findings": unsuppressed,
        "suppressed": suppressed,
        "stale_baseline": stale,
        "counts": counts,
        "n_modules": len(index.modules),
        "pass_times_ms": pass_times_ms,
    }


def changed_files(pkg_dir: Path | str) -> set:
    """Working-tree changes vs HEAD (staged + unstaged + untracked),
    as the package-root-relative posix paths findings carry."""
    pkg_dir = Path(pkg_dir).resolve()
    root = pkg_dir.parent
    out: set = set()
    for cmd in (
        # --relative: paths against OUR cwd (the package parent), not the
        # git root — the two differ when the repo nests the package.
        ["git", "diff", "--name-only", "--relative", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(
            cmd, cwd=root, capture_output=True, text=True, timeout=30,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"--changed-only needs a git checkout: {' '.join(cmd)} "
                f"failed: {proc.stderr.strip() or proc.stdout.strip()}"
            )
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line:
                out.add(Path(line).as_posix())
    return out


def main(argv: list | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="fftpu-torch-check",
        description="layer-check + JAX-safety static analysis (pure AST)",
    )
    p.add_argument("package", nargs="?", default="fluidframework_tpu_torch",
                   help="package directory to analyze")
    p.add_argument("--layers", default=None, help="layers.json override")
    p.add_argument("--baseline", default=None, help="baseline.json override")
    p.add_argument("--no-baseline", action="store_true",
                   help="report suppressed findings too")
    p.add_argument("--rules", default=None,
                   help=f"comma-separated subset of {','.join(PASSES)}")
    p.add_argument("--changed-only", action="store_true",
                   help="report findings only in git-diff-touched modules "
                        "(analysis still runs package-wide)")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="machine-readable output (bench/CI artifacts)")
    args = p.parse_args(argv)

    try:
        only = changed_files(args.package) if args.changed_only else None
        result = run_all(
            args.package,
            layers_path=args.layers,
            baseline_path=args.baseline,
            rules=args.rules.split(",") if args.rules else None,
            only_files=only,
        )
    except SyntaxError as e:
        # A malformed file in the analyzed tree is a usage-class error
        # (exit 2), not a crash: report the offending file:line.
        print(f"fftpu-torch-check: cannot parse {e.filename}:{e.lineno}: {e.msg}",
              file=sys.stderr)
        return 2
    except (FileNotFoundError, ValueError, RuntimeError, json.JSONDecodeError,
            UnicodeDecodeError, OSError) as e:
        print(f"fftpu-torch-check: {e}", file=sys.stderr)
        return 2

    shown = list(result["findings"])
    if args.no_baseline:
        shown += result["suppressed"]
        shown.sort(key=lambda f: (f.file, f.line, f.rule))

    if args.as_json:
        print(json.dumps({
            "clean": not result["findings"],
            "n_modules": result["n_modules"],
            "counts": result["counts"],
            "n_suppressed": len(result["suppressed"]),
            "stale_baseline": result["stale_baseline"],
            "pass_times_ms": result["pass_times_ms"],
            **({"changed_only": True, "n_changed": len(only)}
               if only is not None else {}),
            "findings": [f.to_json() for f in shown],
        }, indent=2))
    else:
        for f in shown:
            print(f.render())
        for e in result["stale_baseline"]:
            print(
                f"stale-baseline  {e.get('file')}  entry no longer matches "
                f"anything: {e.get('rule')} {e.get('detail')!r} — remove it"
            )
        n = len(result["findings"])
        scope = f" ({len(only)} changed files)" if only is not None else ""
        print(
            f"fftpu-torch-check: {result['n_modules']} modules{scope}, "
            f"{n} finding{'s' if n != 1 else ''}, "
            f"{len(result['suppressed'])} baselined, "
            f"{len(result['stale_baseline'])} stale baseline entr"
            f"{'ies' if len(result['stale_baseline']) != 1 else 'y'}"
        )
    return 1 if result["findings"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
