"""Pass 1 — layer-check: downward-only imports per ``layers.json``.

The reference Fluid repo commits ``layerInfo.json`` and fails the build on
any dependency pointing upward (SURVEY §1); this is that check for the
repro.  ``analysis/layers.json`` assigns every package
subpackage to one named layer (index 0 = bottom); a module may import only
from its own layer or below.  ``if TYPE_CHECKING:`` imports are exempt
(erased at runtime — the sanctioned cross-layer type-hint channel); lazy
function-local imports are NOT exempt (a deferred upward import is still an
upward dependency, just one that hides from the import graph until the hot
path runs).

Rules:
- ``layer-upward-import``      — import targets a higher layer
- ``layer-undeclared-package`` — subpackage missing from layers.json (new
  subpackages must declare their layer before they ship)
"""

from __future__ import annotations

import json
from pathlib import Path

from .core import Finding, PackageIndex, iter_imports


def load_layers(path: Path | str) -> dict:
    """-> {subpackage: (rank, layer_name)}."""
    data = json.loads(Path(path).read_text())
    out: dict = {}
    for rank, layer in enumerate(data["layers"]):
        for pkg in layer["packages"]:
            if pkg in out:
                raise ValueError(f"layers.json assigns {pkg!r} twice")
            out[pkg] = (rank, layer["name"])
    return out


def run(index: PackageIndex, layers: dict) -> list[Finding]:
    findings: list[Finding] = []
    known = set(layers)
    flagged_undeclared: set = set()
    for mod in index.modules:
        if mod.subpackage == "<root>":
            # The package facade (__init__) may re-export from anywhere.
            continue
        if mod.subpackage not in known:
            if mod.subpackage not in flagged_undeclared:
                flagged_undeclared.add(mod.subpackage)
                findings.append(Finding(
                    rule="layer-undeclared-package",
                    file=mod.rel,
                    line=1,
                    message=f"subpackage {mod.subpackage!r} has no layer in layers.json",
                    hint="add it to analysis/layers.json at the layer it belongs to",
                    detail=f"undeclared subpackage {mod.subpackage}",
                ))
            continue
        src_rank, src_layer = layers[mod.subpackage]
        for imp in iter_imports(mod):
            if imp.type_checking:
                continue
            if not imp.target.startswith(index.name + "."):
                continue
            tparts = imp.target.split(".")
            tsub = tparts[1] if len(tparts) > 1 else None
            if tsub is None or tsub == mod.subpackage:
                continue
            if tsub not in known:
                # Target may be a top-level module ("fluidframework_tpu.x")
                # or a symbol re-exported by the facade — not a layer edge.
                continue
            dst_rank, dst_layer = layers[tsub]
            if dst_rank > src_rank:
                # Trim symbol imports back to module granularity for a
                # stable fingerprint: "...mesh.doc_mesh" and "...mesh"
                # are the same dependency edge.
                target_mod = imp.target
                if index.by_modname(target_mod) is None:
                    target_mod = target_mod.rsplit(".", 1)[0]
                findings.append(Finding(
                    rule="layer-upward-import",
                    file=mod.rel,
                    line=imp.line,
                    message=(
                        f"{mod.subpackage!r} (layer {src_layer}) imports "
                        f"{target_mod} ({dst_layer!r} is above it)"
                    ),
                    hint=(
                        "invert the dependency (move the shared contract "
                        "down a layer) or baseline it with a rationale"
                    ),
                    detail=f"imports {target_mod}",
                ))
    # One finding per (file, target-module): a module importing two symbols
    # from the same upward module is one edge, not two findings.
    seen: set = set()
    deduped: list[Finding] = []
    for f in findings:
        k = f.key()
        if k not in seen:
            seen.add(k)
            deduped.append(f)
    return deduped
