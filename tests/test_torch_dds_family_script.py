"""``chip_smoke.py`` phase 22 (``dds_family``) on the CPU, in both packages.

The phase's own code runs here at a small size: 3 rounds of the family
script (4 ``FluidContainer``s from a ``LocalServiceClient``, one channel of
each of the 16 registry types, 16 seeded edits a container a round, one
container offline for two rounds, a fifth booted from a stored summary)
with every string on ``KernelMergeTree`` at S=64 (the port's with
``device="cpu"``).  Once as the script stands, once with its package
imports pointed at the JAX package (every string on the reference's
``KernelMergeTree``): the actions, the sequenced message streams, every
container's summary and views, the agent scheduler's events and every
kernel replica's raw state columns and error latch must be equal.  The
corpus part (a) and the legacy v1 part (b) give equal results in both
packages too, and the phase itself (its card checks: the kernel run
against the oracle replay) passes on the port at this size.

Tolerance: exact.
"""

from __future__ import annotations

import json
import re
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

from fluidframework_tpu.dds.kernel_backend import KernelMergeTree as RefKMT  # noqa: E402
from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree as PortKMT  # noqa: E402
from test_torch_kernel_merge_tree import assert_raw_equal  # noqa: E402

GEOM = dict(max_segments=64, remove_slots=4, prop_slots=4, text_capacity=512,
            max_insert_len=16, ob_slots=4)
SIZES = dict(containers=4, rounds=3, edits=16, drop=(1, 0, 2), boot_round=1)

_ref_smoke: list = []


def reference_smoke() -> types.ModuleType:
    """``chip_smoke.py`` with every port import pointed at the JAX package."""
    if not _ref_smoke:
        path = ROOT / "chip_smoke.py"
        src = re.sub(r"\bfluidframework_tpu_torch\b", "fluidframework_tpu", path.read_text())
        mod = types.ModuleType("chip_smoke_on_reference")
        mod.__file__ = str(path)
        exec(compile(src, str(path), "exec"), mod.__dict__)
        _ref_smoke.append(mod)
    return _ref_smoke[0]


def _kernels():
    made = {"port": [], "ref": []}

    def port():
        made["port"].append(PortKMT(**GEOM, device="cpu"))
        return made["port"][-1]

    def ref():
        made["ref"].append(RefKMT(**GEOM))
        return made["ref"][-1]

    return made, port, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_family_script_runs_alike_in_both_packages(seed):
    made, port_kmt, ref_kmt = _kernels()
    port = chip_smoke._family_run(port_kmt, seed, SIZES)
    ref = reference_smoke()._family_run(ref_kmt, seed, SIZES)
    assert json.dumps(port["actions"]) == json.dumps(ref["actions"])
    for key in ("stream", "summaries", "views", "agent_log", "blocks", "errors",
                "edits", "syncs", "containers", "kernels"):
        assert port[key] == ref[key], key
    assert port["kernels"] == port["containers"] == 5 and port["errors"] == [0] * 5
    assert port["regenerated"] > 0 and port["blocks"][-1] == port["blocks"][0]
    # Every kernel replica made, the boot's included, ends with equal raw
    # columns (padding remnants included) and error latch.
    assert len(made["port"]) == len(made["ref"])
    for k, (a, b) in enumerate(zip(made["ref"], made["port"])):
        assert_raw_equal(a.state, b.state, f"replica {k}")
    kinds = {a[2][0] for a in port["actions"] if a[0] == "edit"}
    assert len(kinds) >= 25, sorted(kinds)


def test_family_corpus_and_v1_alike_in_both_packages():
    _made, port_kmt, ref_kmt = _kernels()
    ref_cs = reference_smoke()
    port = chip_smoke._family_corpus(port_kmt)
    ref = ref_cs._family_corpus(ref_kmt)
    assert port == ref
    assert not port["differ"] and not port["state_differ"]
    assert port["string_backends"] == ["KernelMergeTree"] and len(port["loaded"]) == 9
    docs = {}
    for key, cs, make in (("port", chip_smoke, port_kmt), ("ref", ref_cs, ref_kmt)):
        run = cs._family_run(None, 0, SIZES)
        docs[key] = cs._family_v1(make, {"family": run["string"]})
    assert docs["port"] == docs["ref"]
    assert docs["port"]["family"]["markers"] > 0


def test_phase_passes_on_the_cpu(monkeypatch):
    """The phase as ``main`` calls it, on the CPU at S=64: the corpus,
    the kernel run against the oracle replay, the v1 round trips."""
    monkeypatch.setattr(chip_smoke, "STRING_CLIENT_GEOM", GEOM)
    line = chip_smoke.phase_dds_family(0, "cpu", "cpu", SIZES)
    assert line["identical_to_oracle"] and line["containers"] == 5
    assert line["edits"] == 16 * (4 + 5 + 5) and line["regenerated_ops"] > 0
    assert set(line["v1"]) == {"corpus", "family"}
