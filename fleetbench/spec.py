"""Finding a cell's pieces by name.

``BENCHMARK.json`` (at the checkout's root) says which metrics a cell
reports.  Everything else is a file of its own under this folder:

- ``workloads/<cell>.json``: the cell's configuration and traffic names,
  its chips, its sample of docs to compare and, for an open loop, its rate;
- ``configs/<config>.json``: the deployment (engine family and sizes);
- ``traffic/<traffic>.json``: the mix (its drive and the generator's parameters);
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones (those that list it, or list no cells)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """A metric's ``read`` function, from ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "fleetbench.metrics._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(name: str):
    return importlib.import_module(f"fleetbench.families.{name}").Family


def drive(name: str):
    return importlib.import_module(f"fleetbench.drives.{name}")
