"""``chip_smoke.py`` phase 16's seeded SharedString script, run on the CPU in
both packages with all four clients on ``RefMergeTree``.

The script's code is the script's own (``_string_client_run``): once as it
stands, once with its package imports pointed at the JAX package.  Cut to
1,200 edits, the script raises ``ValueError`` in
``RefMergeTree.converged_position`` (from
``SharedStringChannel._resolve_interval_op``, after the stash round's
rehydrate) in both packages alike, after the same actions and the same
sequenced messages: a fault of the reference that the port shares.  At
4,000 edits, the size the phase runs at, both packages run the script to
its end with equal streams and texts.
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

FAULT = "position 554 beyond perspective-visible length"


def _reference_smoke() -> types.ModuleType:
    """``chip_smoke.py`` with every port import pointed at the JAX package."""
    path = ROOT / "chip_smoke.py"
    src = re.sub(r"\bfluidframework_tpu_torch\b", "fluidframework_tpu", path.read_text())
    mod = types.ModuleType("chip_smoke_on_reference")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def _run(mod, monkeypatch, n_edits: int) -> dict:
    """The seeded script (seed 0, the phase's geometry and rejoin period)
    with four ``RefMergeTree`` clients; the sequenced log is kept from the
    run's document, so it is there after a fault too."""
    monkeypatch.setattr(mod, "STRING_CLIENT_KINDS", "oooo")
    docs = []
    init = mod._StringClients.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        docs.append(self.doc)

    monkeypatch.setattr(mod._StringClients, "__init__", keep)
    taken: list = []
    out: dict = {"error": None}
    try:
        res = mod._string_client_run("cpu", mod.STRING_CLIENT_GEOM, 0, n_edits, 6,
                                     sink=taken.append)
        out.update(text=res["text"], edits=res["edits"], reconnects=res["reconnects"],
                   rehydrated=res["rehydrated"])
    except ValueError as err:
        frames = []
        tb = err.__traceback__
        while tb is not None:
            frames.append(tb.tb_frame.f_code.co_name)
            tb = tb.tb_next
        out["error"] = (str(err), frames[-2:])
    (doc,) = docs
    out["actions"] = json.dumps(taken)
    out["stream"] = [dict(json.loads(m.to_json()), timestamp=0) for m in doc.sequencer.log]
    return out


@pytest.mark.parametrize("n_edits", [1200, 4000])
def test_phase16_script_runs_alike_in_both_packages(n_edits, monkeypatch):
    port = _run(chip_smoke, monkeypatch, n_edits)
    ref = _run(_reference_smoke(), monkeypatch, n_edits)
    assert port["actions"] == ref["actions"]
    assert port["stream"] == ref["stream"]
    assert port == ref
    if n_edits == 1200:
        message, frames = port["error"]
        assert message == FAULT
        assert frames == ["_resolve_interval_op", "converged_position"]
        assert '"rehydrate"' in port["actions"]
    else:
        assert port["error"] is None
        assert port["edits"] >= n_edits and port["rehydrated"] == 1
