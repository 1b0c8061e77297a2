"""Whole runs of each cell at a tiny size on the CPU (the look for a card
skipped): the result line's shape, and ``correct`` coming out false for
the control and for each fault the timed path can have.  The cell on the
card is the ``cuda`` test at the end."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from fleetbench import harness, spec

CELLS = ["string_fleet_10k.catchup", "string_fleet_10k.live"]
ROOT = spec.ROOT
# The catch-up cell is held out of BENCHMARK.json (its ops_per_s swings with
# the host's speed by more than any bound allows); its files and readers stay,
# run here with the metrics it reports.
HELD_METRICS = {
    "string_fleet_10k.catchup": {
        False: [{"name": "ops_per_s", "unit": "ops/s"}, {"name": "setup_s", "unit": "s"}],
        True: [{"name": n, "unit": u} for n, u in (
            ("ingest_us_per_op.catchup", "us"), ("step_ms.catchup", "ms"),
            ("fleet_program_roofline.catchup", "%"), ("device_idle_pct.catchup", "%"))],
    },
}


def tiny(name: str):
    cell = spec.load("workloads", name)
    config = spec.load("configs", cell["config"])
    traffic = spec.load("traffic", cell["traffic"])
    config["engine"].update(n_docs=48, max_segments=256, text_capacity=1024)
    traffic.update(prefix_ops=8)
    if "rounds" in traffic:
        traffic["rounds"] = 24
    cell["sample"] = {"heavy": 4, "random": 12}
    if "rate_ops_per_s" in cell:
        cell["rate_ops_per_s"] = 400
    return cell, config, traffic


def run_tiny(name, trace=False, control=False, hooks=None, seconds=4.0, seed=2**35 + 11):
    cell, config, traffic = tiny(name)
    if name in HELD_METRICS:
        metrics = HELD_METRICS[name][trace]
    else:
        metrics = spec.cell_metrics(spec.benchmark(), name, trace)
    res = harness.run_cell(name, cell, config, traffic, metrics, seed, seconds, trace, "cpu",
                           time.perf_counter(), control=control, hooks=hooks)
    res.pop("diag")
    return res, metrics


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name):
    res, metrics = run_tiny(name)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in metrics}
    for m in metrics:
        assert res["metrics"][m["name"]]["unit"] == m["unit"]
        assert res["metrics"][m["name"]]["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert res["checks"]["docs_differing"] == {"value": 0, "limit": 0, "rule": "<="}
    json.dumps(res)


@pytest.mark.parametrize("name,host_metrics", [
    ("string_fleet_10k.catchup", {"ingest_us_per_op.catchup", "step_ms.catchup"}),
    ("string_fleet_10k.live", {"step_ms.live"}),
])
def test_traced_run_reads_the_host_metrics(name, host_metrics):
    res, metrics = run_tiny(name, trace=True)
    # On the CPU no device metric is read: only the harness's spans.
    assert set(res["metrics"]) == host_metrics
    assert host_metrics < {m["name"] for m in metrics}
    for v in res["metrics"].values():
        assert v["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    res, _ = run_tiny(name, control=True)
    assert res["correct"] is False and res["checks"]["docs_differing"]["value"] > 0


def _unchanged_step(family):
    """A step that returns its state unchanged (from the window on: the
    boot's step stays sound)."""
    step = family.step
    booted = []

    def unchanged(eng, compact):
        if booted:
            eng._megastep = lambda state, *a, **k: state
        booted.append(True)
        step(eng, compact)

    family.step = unchanged


def _half_batch(family):
    """Half of the batch left out: every other doc's window lines never
    ingested (its boot lines still are)."""
    ingest = family.ingest

    def half(eng, d, blob):
        if d % 2 == 0:
            ingest(eng, d, blob)

    family.ingest = half


def _altered_answer(family):
    """A doc's view altered where the program produces it."""
    make = family.new_engine

    def new_engine():
        eng = make()
        real = eng.text
        eng.text = lambda d: real(d)[1:] + "?"
        return eng

    family.new_engine = new_engine


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    res, _ = run_tiny(name, hooks=FAULTS[fault])
    assert res["correct"] is False, res["checks"]


def test_docs_off_the_batch_are_not_correct():
    """A geometry the traffic outgrows: the grown docs leave the fleet batch
    for overflow lanes, whose texts are right but were not made by the
    timed programs."""
    def small(family):
        family.engine_args.update(max_segments=48)

    res, _ = run_tiny("string_fleet_10k.catchup", hooks=small)
    assert res["checks"]["docs_off_path"]["value"] > 0
    assert res["checks"]["docs_differing"]["value"] == 0
    assert res["correct"] is False


def test_no_card_no_result():
    """Without a card the command exits with an error and prints nothing on
    standard output; so does a directory holding only BENCHMARK.json and
    the benchmark's folder (the program is missing)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "fleetbench.run", "--workload", "string_fleet_10k.live",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bare_checkout_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "fleetbench", tmp_path / "fleetbench",
                    ignore=shutil.ignore_patterns(".out", ".cache", "__pycache__"))
    cmd = [sys.executable, "-m", "fleetbench.run", "--workload", "string_fleet_10k.live",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs on the card only")
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cmd = [sys.executable, "-m", "fleetbench.run", "--workload", name, "--seed", "12345",
           "--seconds", "3", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["kind"] == card
