"""The port's debugger driver and devtools against the JAX package's, exact.

The reference's ``tests/test_devtools_debugger.py`` (the debugger driver
holding, stepping and playing a document's ops; devtools' container
inspection, logger metrics, HTTP surface and channel views) runs in both
packages through ``torch_twins``: the same edits through each package's
local service, containers and debugger.  Each case's assertions hold in
both, the sequenced message streams are equal, and so is what each package
showed along the way, call by call: every controller ``step``,
``play_to_seq``, ``resume`` and ``next_seq`` with its result and the
pending and released counts after it, every string text read, every
``visualize_channel`` view and every devtools JSON (``DevtoolsServer`` on
an ephemeral port).

Then ``chip_smoke.py`` phase 23 (``debugger``) on the CPU at a small size
(S=64, inserts split at 8 characters): its viewer on the port's
``KernelMergeTree`` (``device="cpu"``) checkpoints equal to the oracle
viewer's, its summary viewer's equal too, and ``apply_op`` counted once a
call at least once for each insert and remove it stepped.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import pytest

import torch_twins as twins

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FILE = "test_devtools_debugger.py"
CASES = twins.cases(FILE)


def record_surface(root: str, monkeypatch) -> list:
    """Log what package ``root``'s debugger and devtools show, call by
    call, into the returned list."""
    log: list = []
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    ctl = imp("driver.debugger_driver").DebugController
    for name in ("step", "play_to_seq", "resume", "next_seq"):
        fn = getattr(ctl, name)

        def logged(self, *a, _fn=fn, _name=name):
            out = _fn(self, *a)
            log.append([_name, list(a), out, self.pending, self.released])
            return out

        monkeypatch.setattr(ctl, name, logged)
    devtools = imp("tools.devtools")
    visualize = devtools.visualize_channel

    def logged_visualize(channel):
        out = visualize(channel)
        log.append(["visualize_channel", out])
        return out

    monkeypatch.setattr(devtools, "visualize_channel", logged_visualize)
    mod = (twins.port_twin(FILE) if root.endswith("_torch")
           else importlib.import_module(FILE[:-3]))
    monkeypatch.setattr(mod, "visualize_channel", logged_visualize)
    for cls_name in ("ContainerDevtools", "FluidDevtools"):
        cls = getattr(devtools, cls_name)
        for name in ("to_json", "metrics") if cls_name == "FluidDevtools" else ("to_json",):
            fn = getattr(cls, name)

            def logged_json(self, _fn=fn, _name=f"{cls_name}.{name}"):
                out = _fn(self)
                log.append([_name, json.loads(json.dumps(out))])
                return out

            monkeypatch.setattr(cls, name, logged_json)
    string = imp("dds.channels").SharedStringChannel
    text = string.text

    def logged_text(self):
        out = text.fget(self)
        log.append(["text", self.id, out])
        return out

    monkeypatch.setattr(string, "text", property(logged_text))
    return log


def test_every_reference_case_is_twinned():
    assert len(CASES) == 8, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    logs = {key: record_surface(root, monkeypatch)
            for key, root in (("ref", "fluidframework_tpu"), ("port", "fluidframework_tpu_torch"))}
    twins.run_pair(case, monkeypatch)
    assert logs["port"], "the case showed nothing"
    assert json.dumps(logs["port"], sort_keys=True) == json.dumps(logs["ref"], sort_keys=True)


PHASE_GEOM = dict(max_segments=64, text_capacity=1024, max_insert_len=8)
PHASE_SIZES = dict(n_edits=40, summary_at=20, stepped=8, play_to=16, every=4, live=4)


def test_phase_debugger_checkpoints_on_cpu(monkeypatch):
    """Phase 23's own code and checks at a small size, its card viewers on
    the port's ``KernelMergeTree`` on the CPU (launches counted on the CPU
    too, where the card's counter counts only CUDA calls)."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    monkeypatch.setattr(mk, "count_launch",
                        lambda x, fn: setattr(fn, "launches", fn.launches + 1))
    line = chip_smoke.phase_debugger(3, "cpu", "cpu", geom=PHASE_GEOM, sizes=PHASE_SIZES)
    assert line["identical_to_oracle"] is True
    card, oracle, summary = (line["replays"][n] for n in ("card", "oracle", "summary"))
    assert card["held"] == oracle["held"] and card["first_seq"] == oracle["first_seq"]
    assert card["stepped"] == PHASE_SIZES["stepped"] and card["played"] > 0
    assert summary["first_seq"] > line["summary_seq"] and summary["held"] < card["held"]
    assert line["checkpoints_compared"] >= line["sequenced"] // PHASE_SIZES["every"]
    edits = line["edits"]
    assert line["launches"]["card"]["apply_op"] >= edits["ins"] + edits["rem"]
    assert line["launches"]["card"]["compact"] > 0
    assert line["launches"]["oracle"] == {"apply_op": 0, "compact": 0, "restamp": 0}
