"""The port's deployment tier: the launcher's netserver shards and the
fleet tier's ``python -m`` entry point, as real processes.

- The compose topology in miniature runs once in each package: two
  launcher shards (each package's own netserver processes), one writer a
  document over the real TCP delta stream routed by ``shard_index``, and
  one ``fleet_main`` process a shard (the reference's with
  ``--platform cpu``, the port's with ``--device cpu``) draining the
  firehose.  Both runs must report the same texts, and every document's
  sequenced log, read back over each shard's HTTP delta storage, must be
  equal message by message (wire JSON; the sequencer's wall-clock
  ``timestamp`` is left out, since it is read in another process).
- The reference's launcher cases (the supervisor's restart of a killed
  shard, the restart budget's crash-loop detection, the heartbeat file and
  ``promote``) run as the port's copy through ``torch_twins.port_twin``:
  its launcher spawns the port's netserver.  The reference's own run of
  them is ``tests/test_deployment.py``; their traces hold no document.
- ``test_packaging_artifacts_agree`` reads the reference's ``deploy/``
  files and stays out: the port has no packaging of its own beyond its
  ``pyproject.toml`` console scripts, which are checked here.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys

import pytest

import torch_twins as twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu"}
REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
DEVICE_FLAG = {REF: ["--platform", "cpu"], PORT: ["--device", "cpu"]}

LAUNCHER_CASES = ("test_launcher_supervise_restarts_crashed_shard",
                  "test_launcher_restart_budget_detects_crash_loop",
                  "test_launcher_heartbeat_and_promote_revives_crash_looped_shard")


def compose(root: str, doc_ids=("doc0", "doc1", "doc2", "doc3"), edits: int = 3) -> dict:
    """The compose topology in package ``root``: texts from the fleet
    processes' last status lines and each document's sequenced log."""
    imp = lambda m: importlib.import_module(f"{root}.{m}")
    launcher, nd = imp("server.launcher"), imp("driver.network_driver")
    SharedString = imp("dds.shared_string").SharedString
    dep = launcher.launch({"shards": [{"name": "s0"}, {"name": "s1"}]})
    fleets: list[subprocess.Popen] = []
    out: dict = {"texts": {}, "fleet": {}, "logs": {}}
    try:
        by_shard: dict[int, list[str]] = {0: [], 1: []}
        for d in doc_ids:
            by_shard[launcher.shard_index(d, 2)].append(d)
        assert all(by_shard.values()), by_shard
        for d in doc_ids:
            _host, port, _http = dep.endpoint_for(d)
            ss = SharedString(client_id=f"w-{d}")
            conn = nd.NetworkDeltaConnection(
                "127.0.0.1", port, d, ss.client_id, "write",
                listener=ss.process, nack_listener=None, signal_listener=None)
            conn.sync()
            for i in range(edits):
                ss.insert_text(len(ss.text) // 2, f"{d}-{i};")
                if i == edits - 1:
                    ss.remove_range(0, 2)
                for m in ss.take_outbox():
                    conn.submit(m)
                conn.sync()
            out["texts"][d] = ss.text
            conn.disconnect()
        # Op rows: the inserts and the one remove of each document.
        rows = {si: (edits + 1) * len(docs) for si, docs in by_shard.items()}
        for si, shard in enumerate(dep.shards):
            fleets.append(subprocess.Popen(
                [sys.executable, "-m", f"{root}.server.fleet_main",
                 "--port", str(shard.port), "--docs", ",".join(by_shard[si]),
                 "--exit-after-rows", str(rows[si]), *DEVICE_FLAG[root]],
                stdout=subprocess.PIPE, text=True, cwd=REPO, env=ENV))
        for si, proc in enumerate(fleets):
            stdout, _ = proc.communicate(timeout=180)
            assert proc.returncode == 0, stdout[-500:]
            status = json.loads(stdout.strip().splitlines()[-1])
            assert status["done"] and status["errors"] == 0
            out["fleet"].update(status["texts"])
        for d in doc_ids:
            _host, port, http_port = dep.endpoint_for(d)
            storage = nd.NetworkDocumentServiceFactory(
                "127.0.0.1", port, http_port).create_document_service(d).connect_to_delta_storage()
            msgs = [json.loads(m.to_json()) for m in storage.get_deltas(1, 0)]
            out["logs"][d] = [{k: v for k, v in m.items() if k != "timestamp"} for m in msgs]
    finally:
        for proc in fleets:
            if proc.poll() is None:
                proc.kill()
        dep.stop()
    return out


def test_compose_topology_matches_reference():
    native = importlib.import_module(f"{PORT}.native.ingest_native")
    if not native.available():
        pytest.skip("native ingest encoder unavailable")
    want, got = compose(REF), compose(PORT)
    assert got["fleet"] == got["texts"]  # the fleet tier converged on the port
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    # A join, the ops, a leave.
    assert all(len(log) == 1 + (3 + 1) + 1 for log in got["logs"].values())


@pytest.mark.parametrize("name", LAUNCHER_CASES)
def test_launcher_case_on_the_port(name):
    port = twins.port_twin("test_deployment.py")
    assert port.launch.__module__ == f"{PORT}.server.launcher"
    getattr(port, name)()


def test_console_scripts_resolve():
    """The port's console scripts name callables of the port."""
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        scripts = dict(re.findall(r'(fftpu-torch-[\w-]+) = "([\w.:]+)"', f.read()))
    assert set(scripts) == {"fftpu-torch-fleet", "fftpu-torch-netserver",
                            "fftpu-torch-launcher", "fftpu-torch-summary-inspect",
                            "fftpu-torch-trace", "fftpu-torch-check"}
    for target in scripts.values():
        mod, fn = target.split(":")
        assert mod.startswith(f"{PORT}.") and callable(getattr(importlib.import_module(mod), fn))


def test_launcher_spawns_the_ports_netserver_without_jax():
    """A shard of the port's launcher runs the port's netserver module and
    sets no JAX variable in its environment."""
    launcher = importlib.import_module(f"{PORT}.server.launcher")
    dep = launcher.launch({"shards": [{"name": "s0"}]})
    try:
        proc = dep.shards[0].proc
        assert proc.args[1:3] == ["-m", f"{PORT}.server.netserver"]
        with open(f"/proc/{proc.pid}/environ", "rb") as f:
            env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
        assert env.get(b"JAX_PLATFORMS") == os.environb.get(b"JAX_PLATFORMS")
        assert dep.manifest()["shards"][0]["pid"] == proc.pid
    finally:
        dep.stop()
