"""The port's network service plane against the JAX package's, exact.

- Every case of the reference's ``tests/test_fanout.py`` (the plane's
  encode-once publish and drain, the broadcaster lambda's shared frames,
  drop-and-resync byte identity, the boot marker, the historian's HTTP
  caching contract, presence, the firehose over TCP, the fleet consumer's
  snapshot-boot resync and its refusal, the driver's boot listener) runs
  in both packages through ``torch_twins``.  The port's
  copy builds its ``DocBatchEngine`` on the CPU (``device="cpu"``).
- Both cases of ``tests/test_network_service.py`` run each package's own
  netserver as a subprocess (``python -m <package>.server.netserver``)
  with client containers in a second process.  The concurrent-edit case
  sequences two processes' ops in arrival order, so its two runs are held
  to the same converged text (as sorted characters) and not to one log.
- Tenant auth (``server/auth.py``) and admission control
  (``server/admission.py``) in the netserver: a valid token connects and
  edits, a forged one, a missing storage token and an unauthenticated
  firehose are refused; an overloaded document nacks submits with
  ``retryAfter`` and ``canRetry`` and admits the same op when resubmitted
  after the overload clears.  Each scenario runs in both packages.

The twins' traces (every document's sequenced log as wire JSON, every
container runtime's summary) and each scenario's observations must be
equal.  Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import http.client
import importlib
import json
import os
import select
import subprocess
import sys
import tempfile

import pytest

import torch_twins as twins

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
READY_TIMEOUT_S = 30


@contextlib.contextmanager
def historian_store(root: str):
    """The reference module's ``historian_store`` fixture in ``root``."""
    store = importlib.import_module(f"{root}.server.gitstore").GitSnapshotStore()
    store.save(10, {"root": {"a": "v1", "big": {"x": 1, "y": 2}}})
    store.save(20, {"root": {"a": "v2", "big": {"x": 1, "y": 2}}})
    tier_cls = importlib.import_module(f"{root}.fanout").HistorianTier
    tier = tier_cls(lambda doc: store if doc == "doc" else None).start()
    try:
        yield tier, store
    finally:
        tier.stop()


@contextlib.contextmanager
def tmp_dir(root: str):
    import pathlib

    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@contextlib.contextmanager
def server_proc(root: str):
    """The reference module's ``server_proc`` fixture: ``root``'s netserver
    as a process on ephemeral ports.  Its readiness line must come within
    ``READY_TIMEOUT_S`` seconds, or the process is killed and the case
    fails."""
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{root}.server.netserver", "--port", "0"],
        stdout=subprocess.PIPE, text=True, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    try:
        readable, _w, _x = select.select([proc.stdout], [], [], READY_TIMEOUT_S)
        line = proc.stdout.readline() if readable else ""
        if not line.strip():
            raise TimeoutError(f"{root}'s netserver printed no readiness line "
                               f"within {READY_TIMEOUT_S} s")
        ready = json.loads(line)
        yield ready["port"], ready["httpPort"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


FANOUT = twins.cases(
    "test_fanout.py",
    fixtures={"historian_store": {"store": historian_store}, "tmp_path": {"tmp": tmp_dir}},
    subs=(('recovery="off", doc_keys=["d0"],', 'recovery="off", doc_keys=["d0"], device="cpu",'),),
)
NETWORK = twins.cases("test_network_service.py", fixtures={"server_proc": {"proc": server_proc}})
ARRIVAL_ORDER = "network_service::test_cross_process_concurrent_edits[proc]"


def test_every_reference_case_is_twinned():
    ids = [c[0] for c in FANOUT + NETWORK]
    assert len(ids) == len(set(ids)) == 16 + 2, len(ids)
    assert ARRIVAL_ORDER in ids


@pytest.mark.parametrize("case", FANOUT, ids=[c[0] for c in FANOUT])
def test_fanout_case_matches_reference(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


@pytest.mark.parametrize("case", NETWORK, ids=[c[0] for c in NETWORK])
def test_network_service_case_matches_reference(case, monkeypatch):
    if case[0] != ARRIVAL_ORDER:
        twins.run_pair(case, monkeypatch)
        return
    texts = []
    for root, fn in zip((REF, PORT), case[1:]):
        with monkeypatch.context() as mp:
            seen = twins.install(twins.packages()["port" if root == PORT else "ref"], mp)
            fn()
            (rt,) = seen["ContainerRuntime"]
            texts.append(rt.datastore("root").get_channel("text").text)
    assert sorted(texts[0]) == sorted(texts[1]) == sorted("ABbase")


# ---------------------------------------------------------------- auth
def _get(port: int, path: str, token: str | None = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path, headers={"Authorization": f"Bearer {token}"} if token else {})
    r = conn.getresponse()
    out = (r.status, json.loads(r.read()))
    conn.close()
    return out


def _consume(port: int, doc: str, token: str | None) -> dict:
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall((json.dumps({"t": "consume", "doc": doc, "token": token}) + "\n").encode())
        return json.loads(s.makefile("r").readline())


def auth_scenario(root: str) -> list:
    imp = lambda m: importlib.import_module(f"{root}.{m}")
    tm = imp("server.auth").TokenManager()
    key = tm.create_tenant("acme", key="k-acme")  # the key is passed: no draw
    plane = imp("server.netserver").ServicePlane().start()
    out = [key]
    try:
        plane.service.enable_auth(tm)
        nd = imp("driver.network_driver")
        good = nd.NetworkDocumentServiceFactory(
            "127.0.0.1", plane.nexus.port, plane.http.port,
            token_provider=lambda doc, client: tm.sign("acme", doc, client))
        Container, registry = imp("loader").Container, imp("dds.channels").default_registry
        d = Container.create_detached(registry(), container_id="creator")
        d.runtime.create_datastore("root").create_channel("sharedString", "text")
        d.attach("doc", good, "creator")
        text = d.runtime.datastore("root").get_channel("text")
        text.insert_text(0, "signed")
        d.runtime.flush()
        good.sync_all()
        out.append(text.text)
        # A token signed for another client, and one from an unknown tenant.
        for provider in (lambda doc, client: tm.sign("acme", doc, "someone-else"),
                         lambda doc, client: "nobody:" + "0" * 64):
            bad = nd.NetworkDocumentServiceFactory(
                "127.0.0.1", plane.nexus.port, plane.http.port, token_provider=provider)
            try:
                Container.load("doc", bad, registry(), "intruder")
                out.append("admitted")
            except imp("driver.definitions").DriverError as e:
                out.append(["refused", str(e), e.can_retry])
        # Storage reads need a token scoped to the storage client.
        out.append(_get(plane.http.port, "/doc/doc/deltas?from=1"))
        store_token = tm.sign("acme", "doc", "__storage__")
        status, body = _get(plane.http.port, "/doc/doc/deltas?from=1", store_token)
        out.append([status, [(m["type"], m["sequenceNumber"]) for m in body["ops"]]])
        # The firehose exposes the whole log: refused without a token.
        out.append(_consume(plane.nexus.port, "doc", None))
        out.append(_consume(plane.nexus.port, "doc", tm.sign("acme", "doc", "__consumer__")))
        good.sync_all()
    finally:
        for conn in list(good.live_connections):
            conn.disconnect()
        plane.stop()
    return out


def admission_scenario(root: str) -> list:
    imp = lambda m: importlib.import_module(f"{root}.{m}")
    adm, messages = imp("server.admission"), imp("protocol.messages")
    controller = adm.AdmissionController(adm.AdmissionConfig(
        max_pending=6, max_consumer_backlog=0, base_retry_after_s=0.25))
    plane = imp("server.netserver").ServicePlane(admission=controller).start()
    nd = imp("driver.network_driver")
    seen, nacks, conns = {"idle": [], "w0": []}, [], {}
    try:
        for name in seen:
            conns[name] = nd.NetworkDeltaConnection(
                "127.0.0.1", plane.nexus.port, "d0", name, "write",
                listener=seen[name].append, nack_listener=nacks.append,
                signal_listener=None)
        for c in conns.values():
            c.sync()
        last = lambda who: seen[who][-1].seq if seen[who] else 0
        client_seq = {"idle": 0, "w0": 0}

        def send(who, contents=None, kind=messages.MessageType.OP, reuse=None):
            if reuse is None:
                client_seq[who] += 1
            m = messages.UnsequencedMessage(
                client_id=who, client_seq=reuse or client_seq[who], ref_seq=last(who),
                type=kind, contents=contents)
            before = len(nacks)
            conns[who].submit(m)
            for c in conns.values():
                c.sync()
            return m if len(nacks) > before else None

        # The idle client never acks: the collab window (seq - MSN) grows
        # with each of w0's ops until the door closes, and every later op
        # is shed before the sequencer sees it.
        shed = [m for m in (send("w0", {"i": i}) for i in range(10)) if m is not None]
        out = [[[n.client_seq, n.reason, n.retry_after] for n in nacks], controller.stats()]
        with plane.nexus.lock:
            out.append(plane.http.service_stats()["admission"])
        # The idle client catches up with a noop (NOOPs always pass the
        # door), which moves the MSN: each shed op, resubmitted with its
        # own clientSeq, is admitted.
        before = len(nacks)
        for m in shed:
            send("idle", kind=messages.MessageType.NOOP)
            send("w0", m.contents, reuse=m.client_seq)
        out.append(len(nacks) - before)
        # The chaos hook sheds the next submit whatever the load.
        controller.force_overload("d0", 1)
        forced = send("w0", {"i": "forced"})
        out.append([nacks[-1].client_seq, nacks[-1].retry_after, forced.client_seq])
        send("idle", kind=messages.MessageType.NOOP)
        out.append(send("w0", forced.contents, reuse=forced.client_seq) is None)
        # Both clients saw one stream from w0's join on.
        n = len(seen["w0"])
        out.append([m.to_json() for m in seen["idle"][-n:]] == [m.to_json() for m in seen["w0"]])
        out.append(controller.stats())
    finally:
        for c in conns.values():
            c.disconnect()
        plane.stop()
    return out


@pytest.mark.parametrize("scenario", [auth_scenario, admission_scenario],
                         ids=["auth", "admission"])
def test_auth_and_admission_nacks_match_reference(scenario, monkeypatch):
    trace = twins.run_pair((scenario.__name__, lambda: scenario(REF), lambda: scenario(PORT)),
                           monkeypatch)
    result = trace["result"]
    if scenario is auth_scenario:
        assert result[1] == "signed"
        assert [r[0] for r in result[2:4]] == ["refused", "refused"]
        assert result[4][0] == 401 and result[5][0] == 200
        assert result[6]["t"] == "error" and result[7]["t"] == "consuming"
    else:
        assert result[0] and all(n[2] > 0 for n in result[0])
        assert result[1]["shed_ops"] == len(result[0]) and result[2]["overload"] == 1
        assert result[3] == 0  # the resubmitted ops were admitted
        assert result[4][1] == 0.25 and result[5] is True and result[6] is True
        # Joins, the admitted ops, a noop and an op a shed op, the forced
        # pair, the leaves.
        assert len(trace["logs"][0]) == 2 + (10 - len(result[0])) + 2 * len(result[0]) + 2 + 2
