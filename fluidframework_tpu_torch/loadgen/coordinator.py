"""loadgen coordinator: spawn the plant, drive the phases, one verdict.

A port of ``fluidframework_tpu/loadgen/coordinator.py``.  It spawns the
port's ``server.netserver``, ``server.fleet_main`` and ``loadgen.worker``;
the fleets serve on ``device`` (``run_loadgen(device=...)``: the card by
default, ``"cpu"`` where the caller asks for it), and so does the
coordinator's scribe pool.  Beside the reference's report the port's
carries, per fleet, its ``device``, its program ``launches`` (from the
fleet's final drain line) and its final ``states``; per worker whether it
initialised CUDA (``workers_cuda_initialized``); and the run's ``device``.
At drain every doc's mirrored sequenced log is written to
``<workdir>/logs/<doc>.jsonl`` (one wire message a line), so any replay
can be made again.

Topology (the deploy/compose.yaml shape, ports ephemeral): N netserver
shard processes (TCP nexus + HTTP alfred + historian snapshot tier), one
device-fleet process per (shard, family) behind ``FleetConsumer``
(``--family tree`` runs the TreeBatchEngine tier), and M worker
processes, each dialed into the coordinator's control socket for phase
barriers and stats shipping.

The coordinator additionally mirrors every doc's sequenced log over the
HTTP deltas front into its own durable topic + scribe pool (the
deployment's scribe tier), which gives it three things at drain time:
the per-doc target seqs for coordinated fleet drain, the fault-free host
oracle replays for the byte-identity verdict, and the no-double-ack scan
over the scribe plane.

``run_loadgen`` returns the report dict that ``bench.py --config
loadgen`` commits as the run artifact; any invariant violation raises
``LoadgenVerdictError`` instead of reporting success.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import select
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field

from ..dds.mergetree_ref import RefMergeTree
from ..device import DEFAULT_DEVICE, resolve_device
from ..dds.tree.changeset import apply_commit, commit_from_json
from ..dds.tree.editmanager import EditManager
from ..dds.tree.forest import Forest
from ..driver.definitions import DriverError
from ..driver.network_driver import (
    HttpDeltaStorageService,
    HttpStorageService,
    _Http,
)
from ..protocol.messages import DeltaType, MessageType, SequencedMessage
from ..runtime.summary import parse_scribe_ack
from ..server.ordered_log import DurableTopic
from ..server.partition_manager import ScribePool
from ..server.scribe import ScribeConfig
from ..utils.telemetry import Histogram
from .schedule import (
    FAMILIES,
    DocSpec,
    LoadSchedule,
    make_load_schedule,
)
from .worker import oracle_chan_string, oracle_map, oracle_matrix

FLEET_FAMILIES = ("string", "tree")


class LoadgenVerdictError(AssertionError):
    """An invariant failed at drain: divergence, double-ack, or foreign
    presence delivery.  Carries every failure, not just the first."""

    def __init__(self, failures: list) -> None:
        super().__init__("; ".join(failures))
        self.failures = failures


# ----------------------------------------------------------- host oracles
def oracle_text(log) -> str:
    """Fault-free replay through the host reference merge tree (the
    string family's byte-identity oracle — the chaos harness contract)."""
    tree = RefMergeTree()
    quorum: dict[str, int] = {}
    for msg in log:
        if msg.type == MessageType.JOIN:
            quorum[msg.contents["clientId"]] = msg.contents["short"]
        elif msg.type == MessageType.OP:
            c = msg.contents
            kind = c["type"]
            client = quorum[msg.client_id]
            if kind == DeltaType.INSERT:
                tree.apply_insert(c["pos1"], c["seg"], msg.seq, client, msg.ref_seq)
            elif kind == DeltaType.REMOVE:
                tree.apply_remove(c["pos1"], c["pos2"], msg.seq, client, msg.ref_seq)
            elif kind == DeltaType.ANNOTATE:
                for prop, value in c["props"].items():
                    tree.apply_annotate(
                        c["pos1"], c["pos2"], int(prop), value,
                        msg.seq, client, msg.ref_seq,
                    )
    return tree.visible_text()


def oracle_tree(log) -> list:
    """Fault-free replay through a host EditManager + Forest (the tree
    family's byte-identity oracle: root-field node JSON)."""
    em, forest = EditManager(), Forest()
    for msg in log:
        if msg.type != MessageType.OP:
            continue
        c = msg.contents
        trunk = em.add_sequenced(
            client_id=msg.client_id,
            revision=(c["sid"], c["rev"]),
            change=commit_from_json(c["changes"]),
            ref_seq=msg.ref_seq,
            seq=msg.seq,
        )
        em.advance_min_seq(msg.min_seq)
        apply_commit(forest.root, trunk)
    return [n.to_json() for n in forest.root_field]


ORACLES = {
    "string": oracle_text,
    "tree": oracle_tree,
    "map": oracle_map,
    "matrix": oracle_matrix,
    "chan_string": oracle_chan_string,
}


def _norm(value):
    """JSON round-trip normalization: worker digests crossed the control
    socket as JSON, so the oracle side must compare in the same space."""
    return json.loads(json.dumps(value))


# ------------------------------------------------------------ subprocesses
@dataclass
class _ShardProc:
    proc: subprocess.Popen
    reader: _LineReader
    port: int
    http_port: int
    historian_port: int


@dataclass
class _FleetProc:
    proc: subprocess.Popen
    reader: _LineReader
    family: str
    docs: list
    drain_file: str
    metrics_port: int | None = None
    final: dict = field(default_factory=dict)


def _http_json(host: str, port: int, path: str) -> dict:
    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return json.loads(resp.read() or b"{}")
    finally:
        conn.close()


class _LineReader:
    """Deadline-bounded line reads off a subprocess pipe.

    Owns its own byte buffer over a non-blocking fd: a buffered
    ``readline()`` would slurp multiple lines off the OS pipe and leave
    ``select()`` reporting nothing readable while a complete line sits in
    the Python-level buffer — the classic select-vs-stdio deadlock."""

    def __init__(self, stream) -> None:
        self._fd = stream.fileno()
        os.set_blocking(self._fd, False)
        self._buf = bytearray()
        self._eof = False

    def readline(self, deadline: float, what: str) -> str:
        while True:
            i = self._buf.find(b"\n")
            if i >= 0:
                line = bytes(self._buf[: i + 1])
                del self._buf[: i + 1]
                return line.decode()
            if self._eof:
                raise RuntimeError(f"unexpected EOF from {what}")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"timed out waiting for {what}")
            r, _, _ = select.select([self._fd], [], [], min(remaining, 1.0))
            if r:
                chunk = os.read(self._fd, 65536)
                if chunk:
                    self._buf += chunk
                else:
                    self._eof = True


class LoadPlant:
    """The live plant: processes, control plane, mirror, verdict."""

    def __init__(
        self,
        workdir: str,
        schedule: LoadSchedule,
        host: str = "127.0.0.1",
        deadline_s: float = 600.0,
        max_pending: int = 4096,
        max_consumer_backlog: int = 1024,
        device: str = DEFAULT_DEVICE,
    ) -> None:
        self.device = str(resolve_device(device))
        self.workdir = workdir
        self.sched = schedule
        self.host = host
        self.deadline = time.monotonic() + deadline_s
        self.max_pending = max_pending
        self.max_consumer_backlog = max_consumer_backlog
        self.n_shards = 1 + max(d.shard for d in schedule.docs)
        self.shards: list[_ShardProc] = []
        self.fleets: list[_FleetProc] = []
        self.workers: list[subprocess.Popen] = []
        self.control: dict[int, tuple] = {}  # worker_id -> (sock, rfile)
        self._control_srv: socket.socket | None = None
        self.logs: dict[str, list[SequencedMessage]] = {
            d.doc_id: [] for d in schedule.docs
        }
        self._cursor = {d.doc_id: 0 for d in schedule.docs}
        os.makedirs(workdir, exist_ok=True)
        with open(os.path.join(workdir, "schedule.json"), "w") as f:
            f.write(schedule.to_json() + "\n")
        self.topic = DurableTopic(
            "deltas", 2, os.path.join(workdir, "topic"),
            encode=lambda m: m.to_json(),
            decode=SequencedMessage.from_json,
        )
        self.pool = ScribePool(
            self.topic, os.path.join(workdir, "scribe"),
            config=ScribeConfig(max_ops=16), device=self.device,
        )
        for i in range(2):
            self.pool.add_member(f"scribe-{i}")
        self._env = dict(os.environ)

    # --------------------------------------------------------------- spawn
    def _spawn(self, name: str, cmd: list, pipe: bool = True) -> subprocess.Popen:
        return subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE if pipe
            else open(os.path.join(self.workdir, f"{name}.out"), "w"),
            stderr=open(os.path.join(self.workdir, f"{name}.err"), "w"),
            env=self._env,
        )

    def start_shards(self) -> None:
        for i in range(self.n_shards):
            proc = self._spawn(f"shard{i}", [
                sys.executable, "-m", "fluidframework_tpu_torch.server.netserver",
                "--port", "0", "--http-port", "0", "--historian-port", "0",
                "--max-pending", str(self.max_pending),
                "--max-consumer-backlog", str(self.max_consumer_backlog),
            ])
            reader = _LineReader(proc.stdout)
            ready = json.loads(reader.readline(
                self.deadline, f"shard{i} readiness"
            ))
            self.shards.append(_ShardProc(
                proc=proc, reader=reader, port=ready["port"],
                http_port=ready["httpPort"],
                historian_port=ready["historianPort"],
            ))

    def start_fleets(self) -> None:
        """One fleet process per (shard, family) with docs there — each a
        checkpointed batched engine behind FleetConsumer, exactly the
        compose.yaml application tier.  Every fleet is spawned before any
        readiness is read, so their start-ups (a device context each)
        overlap."""
        serial = 0
        for si, shard in enumerate(self.shards):
            for family in FLEET_FAMILIES:
                fdocs = [
                    d.doc_id for d in self.sched.docs
                    if d.shard == si and d.family == family
                ]
                if not fdocs:
                    continue
                drain_file = os.path.join(
                    self.workdir, f"drain-{serial}.json"
                )
                cmd = [
                    sys.executable, "-m",
                    "fluidframework_tpu_torch.server.fleet_main",
                    "--host", self.host, "--port", str(shard.port),
                    "--docs", ",".join(fdocs), "--family", family,
                    "--checkpoint-dir",
                    os.path.join(self.workdir, f"ckpt-{serial}"),
                    "--checkpoint-every", "32",
                    "--drain-file", drain_file,
                    "--status-every", "3600",
                    "--idle-sleep", "0.005",
                    "--megastep-k", "2",
                    "--metrics-port", "0",
                    "--device", self.device,
                ]
                if family == "tree":
                    cmd += [
                        "--capacity", "256", "--pool-capacity", "1024",
                        "--max-insert-len", "4", "--ops-per-step", "8",
                    ]
                else:
                    cmd += [
                        "--capacity", "512", "--text-capacity", "8192",
                        "--max-insert-len", "8", "--ops-per-step", "8",
                    ]
                proc = self._spawn(f"fleet{serial}", cmd)
                self.fleets.append(_FleetProc(
                    proc=proc, reader=_LineReader(proc.stdout),
                    family=family, docs=fdocs, drain_file=drain_file,
                ))
                serial += 1
        for serial, fleet in enumerate(self.fleets):
            # Readiness: skip restored/metricsPort preamble lines.
            while True:
                line = json.loads(fleet.reader.readline(
                    self.deadline, f"fleet{serial} readiness",
                ))
                if "metricsPort" in line and "ready" not in line:
                    fleet.metrics_port = line["metricsPort"]
                if line.get("ready"):
                    break

    def start_workers(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind((self.host, 0))
        srv.listen(len(self.sched.workers))
        srv.settimeout(max(1.0, self.deadline - time.monotonic()))
        self._control_srv = srv
        control_port = srv.getsockname()[1]
        shards_cfg = [
            {
                "port": s.port,
                "http_port": s.http_port,
                "historian_port": s.historian_port,
            }
            for s in self.shards
        ]
        for ws in self.sched.workers:
            cfg = {
                "host": self.host,
                "control_port": control_port,
                "zipf_a": self.sched.zipf_a,
                "scopes": self.sched.scopes,
                "docs": [
                    {"doc_id": d.doc_id, "family": d.family, "shard": d.shard}
                    for d in self.sched.docs
                ],
                "shards": shards_cfg,
                "worker": {
                    "worker_id": ws.worker_id,
                    "seed": ws.seed,
                    "ramp_ops": ws.ramp_ops,
                    "steady_ops": ws.steady_ops,
                    "boots": ws.boots,
                    "reconnect_every": ws.reconnect_every,
                    "signal_every": ws.signal_every,
                    "interests": ws.interests,
                },
            }
            path = os.path.join(self.workdir, f"worker{ws.worker_id}.json")
            with open(path, "w") as f:
                json.dump(cfg, f, indent=2)
            self.workers.append(self._spawn(f"worker{ws.worker_id}", [
                sys.executable, "-m", "fluidframework_tpu_torch.loadgen.worker",
                "--config", path,
            ], pipe=False))
        for _ in self.sched.workers:
            conn, _addr = srv.accept()
            conn.settimeout(max(1.0, self.deadline - time.monotonic()))
            rfile = conn.makefile("r", encoding="utf-8")
            hello = json.loads(rfile.readline())
            assert hello.get("t") == "hello", f"bad hello: {hello}"
            self.control[hello["worker"]] = (conn, rfile)
        assert len(self.control) == len(self.sched.workers)

    # ------------------------------------------------------------- barriers
    def run_barrier_phase(self, name: str) -> dict:
        """Release every worker into ``name`` together; block until every
        ``phase_done`` arrives.  Returns per-worker stats keyed by id."""
        for wid in sorted(self.control):
            sock, _ = self.control[wid]
            sock.sendall(
                (json.dumps({"t": "phase", "name": name}) + "\n").encode()
            )
        out = {}
        for wid in sorted(self.control):
            _, rfile = self.control[wid]
            line = rfile.readline()
            if not line:
                raise RuntimeError(
                    f"worker {wid} hung up during {name}: "
                    + self._worker_err_tail(wid)
                )
            resp = json.loads(line)
            if resp.get("t") == "error":
                raise RuntimeError(
                    f"worker {wid} failed in {name}:\n{resp['trace']}"
                )
            assert resp.get("phase") == name, f"barrier skew: {resp}"
            out[wid] = resp["stats"]
        return out

    def _worker_err_tail(self, wid: int) -> str:
        path = os.path.join(self.workdir, f"worker{wid}.err")
        try:
            with open(path) as f:
                return f.read()[-2000:]
        except OSError:
            return "<no stderr captured>"

    # --------------------------------------------------------------- mirror
    def mirror(self) -> None:
        """Page every doc's sequenced log over the HTTP deltas front into
        the coordinator's durable topic (the deployment's deltas-topic
        produce seam, here across a real process boundary) and fold the
        scribe pool over the new tail."""
        for doc in self.sched.docs:
            shard = self.shards[doc.shard]
            svc = HttpDeltaStorageService(
                _Http(self.host, shard.http_port), doc.doc_id
            )
            while True:
                cur = self._cursor[doc.doc_id]
                try:
                    batch = svc.get_deltas(cur + 1, cur + 512)
                except DriverError:
                    break  # doc not created yet (no traffic landed)
                if not batch:
                    break
                for m in batch:
                    self.topic.produce(doc.doc_id, m)
                    self.logs[doc.doc_id].append(m)
                self._cursor[doc.doc_id] = batch[-1].seq
        self.pool.pump()

    # ----------------------------------------------------------- boot storm
    def seed_snapshots(self) -> None:
        """Make the boot-storm phase REAL: upload each fleet doc's current
        oracle state as its snapshot (the scribe-summary analog over the
        HTTP storage front), so the historian serves representative
        payloads with live ETags."""
        for doc in self.sched.docs:
            if doc.family not in FLEET_FAMILIES:
                continue
            log = self.logs[doc.doc_id]
            seq = max((m.seq for m in log), default=0)
            state = ORACLES[doc.family](log)
            storage = HttpStorageService(
                _Http(self.host, self.shards[doc.shard].http_port),
                doc.doc_id,
            )
            storage.write_snapshot(seq, {"family": doc.family, "state": state})

    def historian_stats(self) -> dict:
        totals: dict[str, int] = {}
        for shard in self.shards:
            st = _http_json(self.host, shard.historian_port, "/status")
            for k, v in st.items():
                if isinstance(v, int):
                    totals[k] = totals.get(k, 0) + v
        return totals

    def shard_status(self) -> list:
        return [
            _http_json(self.host, s.http_port, "/status")
            for s in self.shards
        ]

    def write_logs(self) -> None:
        """Every doc's mirrored sequenced log as wire JSON lines under
        ``<workdir>/logs`` (the run's replayable record)."""
        logs_dir = os.path.join(self.workdir, "logs")
        os.makedirs(logs_dir, exist_ok=True)
        for doc_id, log in self.logs.items():
            with open(os.path.join(logs_dir, f"{doc_id}.jsonl"), "w") as f:
                for m in log:
                    f.write(m.to_json() + "\n")

    # ---------------------------------------------------------------- drain
    def drain_fleets(self) -> None:
        """Coordinated drain: drop per-doc target seqs (the mirrored OP
        head) into each fleet's drain file, then collect the final
        byte-identity state (texts/trees) from its done=true line."""
        want = {
            d.doc_id: max(
                (m.seq for m in self.logs[d.doc_id]
                 if m.type == MessageType.OP),
                default=0,
            )
            for d in self.sched.docs
            if d.family in FLEET_FAMILIES
        }
        for fleet in self.fleets:
            tmp = fleet.drain_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"want": {d: want[d] for d in fleet.docs}}, f)
            os.replace(tmp, fleet.drain_file)  # never a torn read
        for fleet in self.fleets:
            while True:
                line = json.loads(fleet.reader.readline(
                    self.deadline,
                    f"fleet drain ({fleet.family}: {fleet.docs})",
                ))
                if line.get("done"):
                    fleet.final = line
                    break
            rc = fleet.proc.wait(
                timeout=max(1.0, self.deadline - time.monotonic())
            )
            assert rc == 0, f"fleet exited {rc}: {fleet.docs}"

    # -------------------------------------------------------------- verdict
    def verdict(self, drain_stats: dict) -> dict:
        failures: list = []
        converged = {f: 0 for f in FAMILIES}

        # Fleet tier: device state vs host oracle replay, byte identity.
        for fleet in self.fleets:
            states = fleet.final.get(
                "trees" if fleet.family == "tree" else "texts", {}
            )
            for doc_id in fleet.docs:
                want = _norm(ORACLES[fleet.family](self.logs[doc_id]))
                got = _norm(states.get(doc_id))
                if got != want:
                    failures.append(
                        f"{doc_id}: fleet diverged from oracle "
                        f"(got {got!r}, want {want!r})"
                    )

        # Every worker replica vs its family oracle.
        for doc in self.sched.docs:
            want = _norm(ORACLES[doc.family](self.logs[doc.doc_id]))
            ok = True
            for wid, stats in drain_stats.items():
                got = stats["digests"].get(doc.doc_id)
                if got != want:
                    ok = False
                    failures.append(
                        f"{doc.doc_id}: worker {wid} replica diverged "
                        f"(got {got!r}, want {want!r})"
                    )
            if ok:
                converged[doc.family] += 1

        # No double-acks across the scribe plane's topic.
        seen: set = set()
        doubles: list = []
        for p in range(self.topic.n_partitions):
            part = self.topic.partition(p)
            for rec in part.read(part.base):
                ack = parse_scribe_ack(rec.payload)
                if ack is not None:
                    key = (ack[0], ack[1])
                    if key in seen:
                        doubles.append(key)
                    seen.add(key)
        if doubles:
            failures.append(f"double-acked summaries: {doubles}")

        # Scoped presence: no worker ever received a foreign-scope signal,
        # and the fanout plane really dropped filtered deliveries.
        presence = {"sent": 0, "recv": 0, "foreign": 0}
        for stats in drain_stats.values():
            for k in presence:
                presence[k] += stats["presence"][k]
        if presence["foreign"]:
            failures.append(
                f"{presence['foreign']} foreign-scope presence deliveries"
            )
        statuses = self.shard_status()
        scope_drops = sum(
            s.get("fanout", {}).get("presence_scope_drops", 0)
            for s in statuses
        )
        if presence["sent"] and not scope_drops:
            failures.append(
                "presence published across the scope universe but the "
                "fanout plane recorded zero scoped drops"
            )

        if failures:
            raise LoadgenVerdictError(failures)
        return {
            "converged_docs": converged,
            "summary_acks": len(seen),
            "double_acks": 0,
            "presence": {**presence, "fanout_scope_drops": scope_drops},
            "shard_status": statuses,
        }

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        self.start_shards()
        self.start_fleets()
        self.start_workers()

        self.run_barrier_phase("ramp")
        self.mirror()
        self.run_barrier_phase("steady")
        self.mirror()

        self.seed_snapshots()
        hist_before = self.historian_stats()
        boot_stats = self.run_barrier_phase("boot_storm")
        hist_after = self.historian_stats()

        drain_stats = self.run_barrier_phase("drain")
        self.mirror()
        self.write_logs()
        self.drain_fleets()
        verdict = self.verdict(drain_stats)

        for wid in sorted(self.control):
            sock, _ = self.control[wid]
            with contextlib.suppress(OSError):
                sock.sendall(b'{"t": "bye"}\n')
        for proc in self.workers:
            proc.wait(timeout=max(1.0, self.deadline - time.monotonic()))

        return self._report(drain_stats, boot_stats, verdict,
                            hist_before, hist_after)

    def _report(self, drain_stats, boot_stats, verdict,
                hist_before, hist_after) -> dict:
        # Lossless histogram merge: per-phase client op e2e latency across
        # every worker, exactly as if sampled in one process.
        merged: dict[str, Histogram] = {}
        counters: dict[str, int] = {}
        for stats in drain_stats.values():
            for name, wire in stats["hists"].items():
                h = Histogram.from_wire(wire)
                if name in merged:
                    merged[name].merge(h)
                else:
                    merged[name] = h
            for k, v in stats["counters"].items():
                counters[k] = counters.get(k, 0) + v

        def hist_row(h: Histogram | None) -> dict:
            if h is None or h.count == 0:
                return {"count": 0}
            return {
                "count": h.count,
                "p50_ms": round(h.percentile(0.5) * 1e3, 3),
                "p99_ms": round(h.percentile(0.99) * 1e3, 3),
                "max_ms": round(h.max * 1e3, 3),
            }

        fleet_rows = [
            {
                "family": f.family,
                "docs": f.docs,
                "rows": f.final.get("rows"),
                "bytes": f.final.get("bytes"),
                "pump_pauses": f.final.get("pump_pauses"),
                "pump_resumes": f.final.get("pump_resumes"),
                "device": f.final.get("device"),
                "launches": f.final.get("launches"),
                "states": f.final.get(
                    "trees" if f.family == "tree" else "texts", {}
                ),
            }
            for f in self.fleets
        ]
        shard_statuses = verdict.pop("shard_status")
        server = {
            "torn_sockets": sum(
                s.get("torn_sockets", 0) for s in shard_statuses
            ),
            "admission_shed_ops": sum(
                s.get("admission", {}).get("shed_ops", 0)
                for s in shard_statuses
            ),
            "admission_overload_events": sum(
                s.get("admission", {}).get("overload_events", 0)
                for s in shard_statuses
            ),
            "fleets": fleet_rows,
        }
        historian = {
            k: hist_after.get(k, 0) - hist_before.get(k, 0)
            for k in ("requests", "cold_serves", "not_modified_304")
        }
        return {
            "seed": self.sched.seed,
            "device": self.device,
            "workers": len(self.sched.workers),
            "workers_cuda_initialized": {
                str(w): s.get("cuda_initialized")
                for w, s in sorted(drain_stats.items())
            },
            "shards": self.n_shards,
            "docs": [
                {"doc_id": d.doc_id, "family": d.family, "shard": d.shard}
                for d in self.sched.docs
            ],
            "phases": {
                name: hist_row(merged.get(name))
                for name in ("ramp", "steady")
            },
            "boot_storm": {
                "cold": hist_row(merged.get("boot_cold")),
                "not_modified": hist_row(merged.get("boot_304")),
                "historian": historian,
                "per_worker_boots": {
                    str(w): s for w, s in sorted(boot_stats.items())
                },
            },
            "client": counters,
            "server": server,
            "convergence": {
                "verdict": "byte-identical",
                "converged_docs": verdict["converged_docs"],
            },
            "scribe": {
                "summary_acks": verdict["summary_acks"],
                "double_acks": verdict["double_acks"],
            },
            "presence": verdict["presence"],
        }

    # ------------------------------------------------------------- teardown
    def close(self) -> None:
        for wid in sorted(self.control):
            sock, rfile = self.control[wid]
            with contextlib.suppress(OSError):
                rfile.close()
                sock.close()
        if self._control_srv is not None:
            with contextlib.suppress(OSError):
                self._control_srv.close()
        procs = self.workers + [f.proc for f in self.fleets] + [
            s.proc for s in self.shards
        ]
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
        for proc in procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=10)
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            if proc.stdout is not None:
                proc.stdout.close()
        self.pool.close()


DEFAULT_DOC_MATRIX = {
    "string": 2, "tree": 1, "map": 1, "matrix": 1, "chan_string": 1,
}


def run_loadgen(
    workdir: str,
    seed: int = 17,
    n_workers: int = 4,
    n_shards: int = 2,
    doc_matrix: dict | None = None,
    ramp_ops: int = 6,
    steady_ops: int = 18,
    boots: int = 4,
    deadline_s: float = 600.0,
    host: str = "127.0.0.1",
    device: str = DEFAULT_DEVICE,
) -> dict:
    """Build the plant, run every phase, return the report dict (raises
    ``LoadgenVerdictError`` on any invariant violation).  The fleets and
    the scribe pool run on ``device``: the card unless the caller asks for
    ``"cpu"``; asking for the card without one raises."""
    matrix = dict(doc_matrix or DEFAULT_DOC_MATRIX)
    docs: list = []
    i = 0
    for family in FAMILIES:
        for k in range(matrix.get(family, 0)):
            docs.append(DocSpec(
                doc_id=f"{family}{k}", family=family, shard=i % n_shards,
            ))
            i += 1
    assert any(d.family in FLEET_FAMILIES for d in docs), (
        "loadgen needs at least one fleet-consumed doc (string/tree)"
    )
    schedule = make_load_schedule(
        seed, n_workers, docs,
        ramp_ops=ramp_ops, steady_ops=steady_ops, boots=boots,
    )
    plant = LoadPlant(workdir, schedule, host=host, deadline_s=deadline_s,
                      device=device)
    try:
        return plant.run()
    finally:
        plant.close()
