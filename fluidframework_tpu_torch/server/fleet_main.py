"""Runnable device-fleet consumer: the port's deployable serving tier.

A port of ``fluidframework_tpu/server/fleet_main.py``.  One process per
shard: consumes a firehose for a document set into a batched engine on the
card and steps it continuously — wire bytes to device with no per-op Python
(``server/fleet_consumer.py`` over ``models/doc_batch_engine.py`` or, with
``--family tree``, ``models/tree_batch_engine.py``).

    python -m fluidframework_tpu_torch.server.fleet_main \
        --host 127.0.0.1 --port 7070 --docs doc0,doc1,doc2 [--device cpu]

``--device`` picks the engine's device (``cuda``, the default, or ``cpu``;
there is no fallback: asking for ``cuda`` without a card exits with an
error).  Emits one JSON status line per --status-every seconds (rows
applied, bytes consumed, per-doc error flags) for process supervisors;
``--exit-after-rows`` bounds the run (tests / draining restarts).  Standby,
lease, bounded-staleness checkpoints, boot-from-summary, the historian
resync, the metrics port, traces and coordinated drains behave as the
reference's, with two additions of the port's own: a coordinated drain
compacts the fleet before its final checkpoint, and every ``done`` line
carries the engine's ``device`` and the ``launches`` of its fleet programs
in this process (counted on a card only).

Placement: ``--mesh N`` serves the fleet over an N-shard docs mesh on
``--device`` (``--seg-shards S`` makes it docs x segs, so hot docs can
promote to S-shard segment lanes); ``--spare-slots`` reserves free rows for
live migration and ``--rebalance-every`` checks for hot shards every so
many seconds, printing a ``migrations`` line with the new ``placement``
after each move.  The reference caps N at its device count; the port's
shards share one device, so N is taken as given.  Without ``--mesh`` the
engine serves with cohort steps (``use_mesh=False``), as the reference's
does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def status_snapshot(eng, doc_ids, rows=0, bytes_consumed=0, **extra) -> dict:
    """One fleet status line as a dict (the supervisor surface): rows/bytes
    consumed, error state, and the engine's full health counters —
    including the megastep pipeline surface (``megastep_k``,
    ``steps_per_dispatch``, ``staging_overlap_packs``).  Module-level so
    tests and tools can assert on the exact shape ``main`` emits."""
    errs = eng.errors()
    # Status is a drain point: flush residual sampled-telemetry buckets so
    # tail samples below sample_every reach the sink with the snapshot.
    flush = getattr(eng, "flush_telemetry", None)
    if flush is not None:
        flush()
    health = eng.health()
    out = {
        "rows": rows,
        "bytes": bytes_consumed,
        "errors": int(errs.sum()),
        "health": health,
        **extra,
    }
    if health.get("overload"):
        # Sustained-overload visibility at the top of the status line (the
        # supervisor's graceful-degradation signal, next to error state).
        out["overload"] = True
    if errs.any():
        out["errorDocs"] = [
            doc_ids[i] for i in range(len(doc_ids)) if errs[i]
        ]
    quarantine = getattr(eng, "quarantine", None)
    if quarantine:
        out["quarantinedDocs"] = sorted(doc_ids[d] for d in quarantine)
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--docs", required=True, help="comma-separated doc ids")
    p.add_argument("--family", choices=("string", "tree"), default="string",
                   help="engine family for this shard: a string-doc "
                        "DocBatchEngine (default) or a tree-doc "
                        "TreeBatchEngine (the drain line then carries "
                        "root-field node JSON instead of texts)")
    p.add_argument("--pool-capacity", type=int, default=4096,
                   help="tree family: shared columnar mark-pool capacity")
    p.add_argument("--drain-file", default=None,
                   help="coordinated drain: poll this path for a JSON "
                        "object {\"want\": {doc: seq}}; once present, pump "
                        "until every doc's applied seq reaches its target, "
                        "checkpoint, emit the final texts/trees status line "
                        "(done=true) and exit 0")
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--text-capacity", type=int, default=65536)
    p.add_argument("--ops-per-step", type=int, default=32)
    p.add_argument("--max-insert-len", type=int, default=8)
    p.add_argument("--idle-sleep", type=float, default=0.02)
    p.add_argument("--historian", default=None,
                   help="host:port of the snapshot-boot historian tier; "
                        "enables {\"t\":\"resync\",\"boot\":true} "
                        "handling (fetch snapshot, adopt, re-consume)")
    p.add_argument("--status-every", type=float, default=10.0)
    p.add_argument("--exit-after-rows", type=int, default=0)
    p.add_argument("--recovery", choices=("grow", "oracle", "off"),
                   default="grow")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for durable per-doc checkpoint records; "
                        "enables bounded recovery + restart-from-checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=256,
                   help="ops per doc between durable checkpoints "
                        "(with --checkpoint-dir)")
    p.add_argument("--scribe-dir", default=None,
                   help="a scribe service directory (server/scribe.py): "
                        "boot each doc from its latest ACKED summary commit "
                        "instead of replaying full history")
    p.add_argument("--watchdog-every", type=int, default=0,
                   help="engine steps between divergence-watchdog sweeps "
                        "(0 disables)")
    p.add_argument("--standby", action="store_true",
                   help="run as a WARM STANDBY: warm the serving "
                        "programs, trail --checkpoint-dir continuously, "
                        "and promote to primary the moment the lease in "
                        "--lease-file lapses (requires both flags).  On "
                        "promotion the process attaches the firehose and "
                        "serves; the seq-floor dedupe replays only the "
                        "post-checkpoint tail")
    p.add_argument("--lease-file", default=None,
                   help="primary-lease file (server/failover.LeaseFile): "
                        "a primary acquires + heartbeats it; a standby "
                        "watches it for expiry.  Epoch-fenced, so a "
                        "paused ex-primary can never reclaim a promoted "
                        "lease")
    p.add_argument("--lease-ttl", type=float, default=2.0,
                   help="lease ttl seconds (renewed every ttl/3; failover "
                        "detection latency is bounded by this)")
    p.add_argument("--standby-poll", type=float, default=0.25,
                   help="seconds between standby trailing passes "
                        "(checkpoint re-adoption cadence)")
    p.add_argument("--ckpt-stale-ops", type=int, default=0,
                   help="bounded-staleness checkpoints: background-write "
                        "any dirty doc this many applied ops behind its "
                        "durable record (0 = off; composes with "
                        "--checkpoint-every, which bounds hot docs)")
    p.add_argument("--ckpt-stale-seconds", type=float, default=0.0,
                   help="bounded-staleness checkpoints: background-write "
                        "any doc dirty for this many seconds (0 = off) — "
                        "bounds the recovery replay tail of COLD docs")
    p.add_argument("--ckpt-sweep-interval", type=float, default=0.25,
                   help="seconds between background checkpoint sweeps "
                        "(with --ckpt-stale-ops/--ckpt-stale-seconds)")
    p.add_argument("--readmit-after-steps", type=int, default=0,
                   help="auto-readmit quarantined docs after this many "
                        "engine steps (backoff-doubled per flap; 0 = manual)")
    p.add_argument("--poison-budget", type=int, default=0,
                   help="quarantine flaps before a doc is permanently "
                        "oracle-routed (0 = unlimited)")
    p.add_argument("--megastep-k", type=int, default=8,
                   help="max op slices fused into one device dispatch "
                        "(adaptive by queue depth; 1 = exact per-slice "
                        "dispatch, the pre-megastep behavior)")
    p.add_argument("--mesh", type=int, default=0,
                   help="serve the fleet over an N-shard docs mesh on "
                        "--device (one launch steps every shard; 0 = no "
                        "mesh: cohort steps for Zipf stragglers)")
    p.add_argument("--spare-slots", type=int, default=0,
                   help="extra free device rows beyond the fleet (landing "
                        "room for live hot-shard doc migration; rounds up "
                        "per shard)")
    p.add_argument("--rebalance-every", type=float, default=0.0,
                   help="seconds between hot-shard checks: migrate the "
                        "deepest-queued doc off any shard loaded over 2x "
                        "the fleet mean (0 = no auto-rebalance)")
    p.add_argument("--seg-shards", type=int, default=0,
                   help="with --mesh: carve a segs axis of this width out "
                        "of the mesh (docs x segs) so hot docs can promote "
                        "to segment-parallel serving; composes with "
                        "--rebalance-every (a shard hot from one doc "
                        "promotes that doc instead of migrating it)")
    p.add_argument("--seg-rebalance-every", type=int, default=0,
                   help="ops applied on a segment lane between segment "
                        "re-blocks (0 = manual)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the engine's device: the card (default) or the "
                        "CPU's plain PyTorch path; no fallback between them")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus /metrics + JSON /status on this "
                        "port (0 = ephemeral, reported in the readiness "
                        "line; omit = off).  Aggregates engine health, "
                        "op-latency histograms and transport counters")
    p.add_argument("--trace", default=None,
                   help="record a flight-recorder trace of the serving "
                        "path (ingest/upload/dispatch/readback spans) and "
                        "dump it as Chrome trace-event JSON to this path "
                        "on exit (Perfetto-loadable)")
    p.add_argument("--trace-capacity", type=int, default=65536,
                   help="flight-recorder ring capacity in events (old "
                        "events overwrite; the dump reports drops)")
    args = p.parse_args(argv)

    import os as _os

    from .fleet_consumer import FleetConsumer
    from .ordered_log import CheckpointStore

    doc_ids = [d for d in args.docs.split(",") if d]
    store = (
        CheckpointStore(args.checkpoint_dir)
        if args.checkpoint_dir is not None
        else None
    )
    mesh = None
    if args.mesh:
        from ..parallel.mesh import doc_mesh, docs_segs_mesh

        # Every shard on --device (-1, all visible devices, is one here).
        devices = [args.device] * max(args.mesh, 1)
        if args.seg_shards > 1:
            mesh = docs_segs_mesh(devices, args.seg_shards)
        else:
            mesh = doc_mesh(devices)
    if args.family == "tree":
        from ..models.tree_batch_engine import TreeBatchEngine

        eng = TreeBatchEngine(
            len(doc_ids),
            capacity=args.capacity,
            pool_capacity=args.pool_capacity,
            max_insert_len=args.max_insert_len,
            ops_per_step=args.ops_per_step,
            mesh=mesh,
            spare_slots=args.spare_slots,
            checkpoint_store=store,
            checkpoint_every=args.checkpoint_every if store is not None else 0,
            doc_keys=doc_ids,
            megastep_k=args.megastep_k,
            device=args.device,
        )
    else:
        from ..models.doc_batch_engine import DocBatchEngine

        eng = DocBatchEngine(
            len(doc_ids),
            max_segments=args.capacity,
            text_capacity=args.text_capacity,
            max_insert_len=args.max_insert_len,
            ops_per_step=args.ops_per_step,
            use_mesh=mesh is not None,
            mesh=mesh,
            spare_slots=args.spare_slots,
            recovery=args.recovery,
            checkpoint_store=store,
            checkpoint_every=args.checkpoint_every if store is not None else 0,
            doc_keys=doc_ids,
            watchdog_every=args.watchdog_every,
            readmit_after_steps=args.readmit_after_steps,
            poison_budget=args.poison_budget,
            megastep_k=args.megastep_k,
            seg_rebalance_every=args.seg_rebalance_every,
            device=args.device,
        )
    if store is not None and not args.standby:
        # Restart path: restore durable checkpoints BEFORE consuming, so
        # the firehose catch-up replay of already-checkpointed ops is
        # skipped and recovery replay stays bounded.  A standby skips
        # this eager pass — WarmStandby.prepare() performs the initial
        # adoption (refresh trail, no recovery incident); doubling it
        # here would re-read every record and open a stray boot clock.
        restored = eng.restore_from_checkpoints()
        if restored:
            print(json.dumps({
                "restored": [doc_ids[d] for d in restored],
                "health": eng.health(),
            }), flush=True)
    boot_store = None
    if args.scribe_dir is not None:
        # Boot-from-summary: cold docs (no local checkpoint) seed from the
        # scribe's latest ACKED commits, so catch-up replays only the
        # post-ack tail instead of full history.
        from .scribe import SummaryRecordStore

        boot_store = SummaryRecordStore.open(args.scribe_dir)
    recorder = None
    if args.trace:
        from ..observability import FlightRecorder, install

        recorder = install(FlightRecorder(args.trace_capacity))
    lease = heartbeat = None
    if args.lease_file:
        from .failover import LeaseFile

        lease = LeaseFile(
            args.lease_file, holder=f"fleet-{_os.getpid()}",
            ttl_s=args.lease_ttl,
        )
    if args.standby:
        # Warm standby: programs warmed, checkpoints trailed, promotion
        # on primary lease loss — then fall through into the serving path
        # below exactly like a primary (the consumer's seq-floor dedupe
        # replays only the post-checkpoint tail).
        if store is None or lease is None:
            p.error("--standby requires --checkpoint-dir and --lease-file")
        from .failover import WarmStandby

        ws = WarmStandby(eng, store, lease=lease, poll_s=args.standby_poll)
        ws.prepare()
        print(json.dumps({
            "standby": True, "leaseFile": args.lease_file,
            "health": eng.health(),
        }), flush=True)
        ws.watch()
        ws.promote()
        print(json.dumps({
            "promoted": True, "health": eng.health(),
        }), flush=True)
    elif lease is not None:
        if not lease.acquire():
            print(json.dumps({
                "error": "lease held by another primary",
                "lease": lease.read(),
            }), flush=True)
            return 1
    if lease is not None and lease.epoch >= 0:
        from .failover import LeaseHeartbeat

        heartbeat = LeaseHeartbeat(lease).start()
    historian = None
    if args.historian:
        hh, _, hp = args.historian.rpartition(":")
        try:
            historian = (hh or "127.0.0.1", int(hp))
        except ValueError:
            p.error(f"--historian wants host:port, got {args.historian!r}")
    fc = FleetConsumer(args.host, args.port, eng, doc_ids,
                       boot_store=boot_store, historian=historian)
    if fc.booted_docs:
        print(json.dumps({
            "bootedFromSummary": [doc_ids[d] for d in fc.booted_docs],
            "health": eng.health(),
        }), flush=True)
    metrics_srv = None
    if args.metrics_port is not None:
        # The scrapeable fleet surface: /metrics (Prometheus text) +
        # /status (JSON) over the live engine/consumer state — a soak run
        # is inspectable with curl, no debugger attached.
        from ..observability import MetricsPlane, MetricsServer

        plane = MetricsPlane()
        plane.register("fleet", fc.health)
        latency = getattr(eng, "latency_histograms", None)
        if latency is not None:
            plane.register("latency", latency)
        metrics_srv = MetricsServer(plane, port=args.metrics_port).start()
        print(json.dumps({"metricsPort": metrics_srv.port}), flush=True)
    # Readiness line: everything a coordinator needs to attach — the shard
    # this consumer rides, the doc set and family it serves, and (when on)
    # the scrapeable metrics port.  Emitted AFTER the firehose attached, so
    # a supervisor reading it knows the consume subscriptions exist.
    ready = {
        "ready": True,
        "family": args.family,
        "docs": doc_ids,
        "port": args.port,
    }
    if metrics_srv is not None:
        ready["metricsPort"] = metrics_srv.port
    print(json.dumps(ready), flush=True)
    ckpt_writer = None
    if store is not None and (args.ckpt_stale_ops or args.ckpt_stale_seconds):
        # Bounded-staleness delta checkpoints: a background sweep keeps
        # every doc's durable record within the configured ops/seconds of
        # the live stream, so a successor's (or standby's) replay tail
        # stays small even for docs too cold to hit --checkpoint-every.
        from ..models.recovery import BackgroundCheckpointWriter

        ckpt_writer = BackgroundCheckpointWriter(
            eng,
            max_ops_behind=args.ckpt_stale_ops,
            max_seconds_behind=args.ckpt_stale_seconds,
            interval_s=args.ckpt_sweep_interval,
        ).start()

    def status(**extra) -> None:
        if ckpt_writer is not None:
            extra.setdefault("ckptWriter", ckpt_writer.stats())
        if heartbeat is not None:
            extra.setdefault("lease", heartbeat.stats())
        print(json.dumps(status_snapshot(
            eng, doc_ids, rows=fc.rows_staged,
            bytes_consumed=fc.bytes_consumed,
            # Consumer-side flow control (the engine's overload gauges
            # ride inside health): which partitions are paused right now
            # and how often the gate cycled.
            paused_docs=len(fc.paused_socks),
            pump_pauses=fc.pump_pauses,
            pump_resumes=fc.pump_resumes,
            **extra,
        )), flush=True)

    def final_state() -> dict:
        """The per-family identity surface for the done=True status line,
        with the port's own keys: the engine's ``device`` and the launches
        of its fleet programs in this process (``count_launch``: on a card
        only)."""
        if args.family == "tree":
            from ..ops import tree_kernel as tk

            progs = (tk.apply_nested_megastep, tk.compact_nested)
            out = {"trees": {d: eng.tree_json(i) for i, d in enumerate(doc_ids)}}
        else:
            from ..ops import mergetree_kernel as mk

            progs = (mk.apply_megastep, mk.compact)
            out = {"texts": {d: eng.text(i) for i, d in enumerate(doc_ids)}}
        out["device"] = str(eng.device)
        out["launches"] = {fn.__name__: fn.launches for fn in progs}
        return out

    drain_want: dict | None = None
    last_drain_poll = 0.0
    last_status = time.monotonic()
    last_rebalance = time.monotonic()
    try:
        while True:
            staged = fc.pump()
            if (
                args.rebalance_every
                and mesh is not None
                and time.monotonic() - last_rebalance >= args.rebalance_every
            ):
                last_rebalance = time.monotonic()
                moves = eng.rebalance_hot_shards()
                if moves:
                    # Summary ownership follows the docs: the supervisor
                    # re-aligns from this line.
                    print(json.dumps({
                        "migrations": [
                            {"doc": doc_ids[d], "from": s, "to": t}
                            for d, s, t in moves
                        ],
                        "placement": eng.placement(),
                    }), flush=True)
            if heartbeat is not None and heartbeat.lost:
                # Fenced out: another holder took the lease (we stalled
                # past the ttl and a standby promoted).  Stand down WITHOUT
                # checkpointing: the successor owns the shared store now,
                # and a force-write here could overwrite its newer records
                # with our stale state — regressing the durable floor the
                # fencing exists to protect.
                status(leaseLost=True)
                return 1
            if fc.dead_socks:
                # A shard closed our firehose (restart/shutdown): exit
                # nonzero so the supervisor restarts this tier — sleeping
                # on dead sockets would look healthy while applying
                # nothing forever.  Checkpoint first so the restart
                # resumes from here instead of replaying history.
                fc.step()
                eng.maybe_checkpoint(force=True)
                status(disconnected=sorted(
                    doc_ids[i] for i in fc.dead_socks
                ))
                return 1
            if staged or fc.paused_socks:
                # Paused partitions mean staged backlog over the watermark:
                # keep stepping so the gate can re-arm those sockets, even
                # when this pump read nothing (flow control, not idleness).
                fc.step()
            else:
                time.sleep(args.idle_sleep)
            now = time.monotonic()
            if now - last_status >= args.status_every:
                last_status = now
                status()
            if args.exit_after_rows and fc.rows_staged >= args.exit_after_rows:
                eng.maybe_checkpoint(force=True)
                status(done=True, **final_state())
                return 0
            if args.drain_file is not None:
                # Coordinated drain: once the supervisor drops the drain
                # file (per-doc target seqs), pump until every doc's
                # applied floor reaches its target, then emit the final
                # per-family state and exit cleanly.
                if drain_want is None and now - last_drain_poll >= 0.1:
                    last_drain_poll = now
                    if _os.path.exists(args.drain_file):
                        with open(args.drain_file) as f:
                            drain_want = json.load(f)["want"]
                if drain_want is not None:
                    fc.step()
                    if all(
                        eng.hosts[i].last_seq >= int(drain_want.get(d, 0))
                        for i, d in enumerate(doc_ids)
                    ):
                        # The port compacts a drained fleet (K3, or K8 for
                        # trees) before its final checkpoint, so a restart
                        # boots from compacted rows; the identity surface
                        # is unchanged.
                        eng.compact()
                        eng.maybe_checkpoint(force=True)
                        status(done=True, drained=True, **final_state())
                        return 0
    except KeyboardInterrupt:
        eng.maybe_checkpoint(force=True)
        return 0
    finally:
        fc.close()
        if ckpt_writer is not None:
            ckpt_writer.stop()
        if heartbeat is not None:
            heartbeat.stop()
        if lease is not None:
            # Clean shutdown hands the lease over immediately (a standby
            # promotes now, not after the ttl runs out).
            lease.release()
        flush = getattr(eng, "flush_telemetry", None)
        if flush is not None:
            flush()  # shutdown drain: no tail samples silently dropped
        if metrics_srv is not None:
            metrics_srv.stop()
        if recorder is not None:
            n = recorder.export_chrome_trace(args.trace)
            print(json.dumps({
                "trace": args.trace, "events": n,
                "dropped": recorder.dropped,
            }), flush=True)


def cli() -> None:
    """Console-script entry (pyproject fftpu-torch-fleet)."""
    sys.exit(main())


if __name__ == "__main__":
    cli()
