#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (fluidframework_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed N] [--trace-dir DIR] [--only cross_card|chaos_ranks]

``--trace-dir`` writes the Chrome traces of the recorded turns there
(nothing is written by default); ``--only`` builds the kernels and runs
the cross-card phases alone (see 24 and 25).

It builds every hand-written kernel of the port from ``csrc/`` with nvcc
(sm_90a; one compile per source, started together, then one link), then
runs these phases on the card, one JSON line each:

1. ``kernels``: K1 (``resolve_positions``) against its plain PyTorch
   version on the same card tensors — edge cases, the edges of its tiles,
   the batched form and the long-document size (Q=256, S=262,144) — exact
   equality; then, at the long-document shape and the segment lane's
   (Q=1, S=16,384), its call time (CUDA events) and device time
   (torch.profiler) beside its bound and the same function in PyTorch
   calls (``torch.cumsum`` then ``torch.searchsorted``); also at the
   4-shard lane's shape ([4, 16,384] lengths, one query a shard).
1b. ``rebase_kernel``: K9 (``rebase_window``) against its plain PyTorch
   version on the same card tensors and on the CPU, exact on every output
   of every step, at ``bench.py``'s microbench windows (W=256 and W=4,096
   windows of C=8 multi-insert commits) and one tree_deep window (W=1,
   C=256); call and device time, the plain version's, the host pooled
   fold's over the same windows, the bytes bound; then one window per
   ``DeviceRebaser.fold`` (the serving form) against the pooled fold.
2. ``fleet``: config-3 geometry (10,000 SharedString docs, S=1024,
   T=8192, R=4, P=2, B=16, K=8) fed Zipf-skewed 4-writer insert/remove
   traffic, a round per ``DocBatchEngine.ingest_batch`` call, through
   ``step``/``compact``; no error bits, and a seeded sample of 64 docs
   replayed per message through the same engine on the CPU gives
   byte-identical state rows.  Run at ``recovery="grow"``, then, to price
   recovery, in turns at ``"off"``, ``"grow"``, ``"grow"``, ``"off"``: the
   first grow of the turns ingests per message (``ingest``), the second
   runs with a flight recorder installed (phase shares of ``ingest``,
   ``upload``, ``dispatch``, ``readback``, then a recorded checkpoint
   sweep of the 64 sampled docs).  Each line carries the op-latency p50
   and p99, the ingest watermarks and the overload gauges.
3. ``recovery``: the fleet's geometry and traffic at ``recovery="grow"``
   with seeded faults (8 docs past the text capacity, 8 past the segment
   count, 4 with an insert past their length): no error bits, 16 overflow
   lanes at the doubled capacity, 4 quarantined docs; the faulted docs and
   64 others replayed on the CPU are identical; two watchdog sweeps of 64
   find nothing, and the device digest K4 (``fleet_digest``) is timed
   beside its bytes bound and equals its CPU result; on a 256-doc engine a
   tampered codepoint is caught by exactly one doc passing the digest
   pre-filter and quarantined; a forced checkpoint sweep restores into a
   fresh engine identically (the restore's scatter timed alone), and both
   engines stay identical through two more rounds, while a re-fed
   checkpointed round is skipped.
4. ``hot_doc``: config-1 geometry (one doc, S=16,384, T=131,072) — a
   4-writer trace through the one-shard segment lane
   (``apply_megastep_seg``, whose containment searches are K1 launches)
   equals the single lane on the same trace.
5. ``long_doc``: the long-document query plane's resolve at Q=256 over
   262,144 segments (K1), mark and visible length, against numpy.
6. ``fleet_programs``: the fleet programs timed alone beside their bytes
   bounds — K2 (one K=8 ``apply_megastep`` of the fleet's second
   megastep, [8, 10,000, 16]), K3 (``set_min_seq`` + ``compact`` of the
   10,000 docs) and K6 (``apply_megastep_seg`` and ``compact_seg`` at the
   hot document); their launches per path follow in a
   ``fleet_programs_launches`` line.
7. ``tree_fleet``: 1,024 SharedTree docs of ``bench.py``'s config-5
   stream (4 writers with their own subtrees and one shared subtree, 8
   edits per writer a round with one round of ref lag, 40% string
   leaves; capacity 2,048, pool 16,384, B=32, K=8) through
   ``TreeBatchEngine.ingest``/``step`` for 4 rounds: no error bits, the
   4 seeded docs that pass 2,048 rows (and only they) routed to the host
   fallback, a CPU replay of 64 sampled docs and the 4 identical (raw
   columns, ``tree_json``, ``values``, ``em.summarize()``); a forced
   checkpoint sweep restored into a fresh engine identically, and both
   engines identical through one more round.  The rounds run with a
   flight recorder installed: the host fold's phase shares
   (``host_fold_mark_alloc``/``_rebase``/``_compose``/``_translate``).
   Then ``tree_legacy_emit``, a path of its own: the first 64 docs'
   rounds through two fresh engines, one with the plan cache and one with
   the per-row emit (``plan_cache=False``), in turns that swap each round:
   every raw column, the error latch and the fallbacks equal, plan hits
   only on the first; each engine's ingest and step times on a
   ``tree_legacy_emit`` line.
8. ``tree_deep``: one doc seeded with a 10,000-leaf mixed-type subtree
   under 32 writer subtrees, then 32 writers x 8 edits x 4 rounds;
   ``device_fraction`` 1.0 and identical to a CPU replay.
9. ``tree_churn``: 256 docs whose writers alternate inserts and removes
   (capacity 128): compaction (K8) must run; a sample of 64 identical to
   a CPU replay.
9b. ``wire_ingest``: ``bench.py``'s config-3 ingest stream (128 docs, 16
   rounds, 4 writers) as JSON lines through ``ingest_lines`` (the C++
   encoder, ``native/ingest.cpp``), as messages through ``ingest_batch``
   and through ``ingest``: ops/s of each; after ``step`` every doc's
   raw columns and error latch identical across them and a CPU run, the
   library loaded and every ``ingest_lines`` doc native.  Then
   tree_churn's stream through ``TreeBatchEngine.ingest_lines``
   (``native_wire=True``) round by round: every doc identical to the
   tree_churn engine's, native tree batches and no native decode error.
10. ``tree_programs``: K7 (``apply_nested_megastep``) on the ring the
    tree fleet stages from one more round, and K8 (``compact_nested``) on
    the fleet's state, timed alone beside their bytes bounds and held
    against the CPU on 64 docs; then K7's two routes (masked over every
    doc, or on the gathered rows of the docs that hold a kind) timed in
    turns on that ring with its ops kept for 1/16 to all of the docs.
11. ``tree_rebase``: config 5 with the device rebase window (K9) on:
    tree_deep's stream (its phase 8 engine, the pooled fold, is the other
    side) and the tree fleet's cut to 256 docs, in turns on, off, off, on;
    every doc's summary and tree JSON identical between the settings;
    ingest s, edits/s, ``device_rebase_fraction``, ``rebase_fallbacks``,
    ``rebase_windows``; the fleet's last turn runs with a flight recorder
    (the rebase window's encode/dispatch/decode spans).
12. ``map_lww``: config 2 — one map (K=256) fed 64 batches of 256
    SET/DELETE ops plus a CLEAR, then 10,000 maps through
    ``apply_batch_fleet``, 16 batches; both equal a CPU run exactly.
13. ``matrix``: config 4 — one 256 x 256 matrix seeded with 128 rows and
    columns, 16 steps of 64 SET_CELL ops from 64 writers with two of
    writer 0's row and column inserts and removes interleaved in each and
    FWW on some cells; the state and ``to_grid`` equal a CPU run exactly.
14. ``serving``: the serving tier, through its entry points.
    (a) A firehose stand-in (``FirehoseFeeder``: one thread answers the
    consume handshake, one sends JSON lines) serves the fleet's traffic
    for all 10,000 docs over local TCP to ``FleetConsumer`` over a
    ``DocBatchEngine`` at config-3 geometry (``recovery="grow"``): joins
    and round 0 warm it (``run_for``), rounds 1-15 are the timed drain
    (drain ops/s and wire -> device ops/s as ``bench.py``
    ``_wire_ingest_rate`` defines them), then a scribe summaryAck triggers
    the compaction; no error bits, and 64 sampled docs identical to a CPU
    ``ingest_lines`` replay of the same bytes.  RLIMIT_NOFILE's soft limit
    is raised to two sockets a doc; a lower hard limit cuts the doc count,
    written in the line as ``reduced``.  (b) tree_churn's stream to a
    ``TreeBatchEngine`` over the same feeder, a step a round: every doc
    identical to the tree_churn engine's.  (c) A ``ScribeLambda`` on the
    card and one on the CPU summarize one topic of 64 string, 64 tree and
    64 map docs (map_lww's op mix) and 4 matrices (the matrix phase's
    stream, cut to 4 steps): the same commit SHAs, ``refs.json`` and git
    objects; engines booted from ``SummaryRecordStore`` and fed the whole
    stream equal engines fed it all.  (d) A primary of 512 docs with a
    ``BackgroundCheckpointWriter``; a ``WarmStandby`` prepares (warmup,
    timed), trails, and promotes when the primary releases its lease; the
    promoted engine and a cold successor without warmup take the stream:
    both equal the primary on 64 sampled docs; first-step times and the
    promotion's ``recovery_p50_ms``.  (e) ``python -m
    fluidframework_tpu_torch.server.fleet_main --device cuda`` over 256
    docs, twice on one checkpoint directory: its ``done`` texts equal an
    in-process engine's, and the second run prints ``restored`` with
    ``checkpointed_ops_skipped > 0``.
15. ``sharded``: the sharded fleet, one line a part, every check exact.
    (a) The fleet's shared traffic (8 of its rounds) for all 10,000 docs on
    a 4-shard ``doc_mesh(["cuda"] * 4)`` with 64 spare slots: after round 3
    16 docs migrate with their rows staged; at round 4 shard 0's docs take
    two rounds ahead of the rest and ``rebalance_hot_shards()`` (factor
    2.0) is called until it migrates a doc.  Every doc's raw row and latch
    equal a control engine with no mesh fed the same stream (which
    re-packs the moved docs through the checkpoint codec at the same
    points), and 64 sampled unmoved docs a CPU replay; ops/s of each, ms
    per ``migrate_doc``.  (b) The control runs with ``use_mesh=False``
    (cohort steps for the Zipf stragglers) and a third engine with the
    default full-fleet step: identical state, ``cohort_steps > 0``; the
    runs go in turns mesh, cohort, full, full, cohort, mesh; the cohort
    gather and scatter timed alone.  (c) A hot doc at config-1 geometry
    (S=16,384, T=131,072) among 64 cold docs on
    ``docs_segs_mesh(["cuda"] * 8, seg_shards=4)``, promoted mid-stream by
    ``enable_segment_sharding`` and later by ``rebalance_hot_shards``' own
    promotion (a move to -1), re-blocked every 128 lane rows, demoted at
    the end: every doc equals an oracle engine that serves the hot doc in
    its batch row; ``seg_occupancy`` sums to the live count; the lane's
    rows/s and one n=4 ``apply_megastep_seg`` timed alone beside its bytes
    bound.  (d) tree_churn's stream on a 4-shard mesh with 16 spare slots,
    8 docs migrated mid-stream: every doc equals the tree_churn engine's.
    (e) ``python -m fluidframework_tpu_torch.server.fleet_main --device
    cuda --mesh 4 --spare-slots 16 --rebalance-every 0.5 --seg-shards 2``
    over 256 docs: a ``migrations`` line appears and its ``done`` texts
    equal an in-process engine's.
16. ``string_client``: the SharedString client path through its entry
    points: one ``LocalService`` document with four ``ContainerRuntime``
    clients (config 1's four writers), each holding a ``sharedString``;
    clients 0 and 2 on ``KernelMergeTree(device="cuda")`` at config 1's
    single-document geometry (S=16,384, T=131,072, the reference's default
    slot counts), 1 and 3 on ``RefMergeTree``.  A seeded script of 4,000
    edits (``main`` runs 500 of them, ``CUTS``; inserts, removes, annotates, plain and sided obliterates,
    interval adds), each client flushing after its edits and a sync a
    round; every sixth round a kernel client drops, edits offline and
    rejoins (its pending ops regenerate through K5), and once it stashes
    and rehydrates through ``apply_stashed``.  Every sync checks that the
    four clients' texts, resolved annotations and intervals are equal.
    The same script then runs with the kernel clients on the CPU: every
    kernel replica's raw state, error latch and summary, the sequenced
    stream and the text identical.  Then the squash regeneration (pending
    inserts and removes that cancel, a pending obliterate whose range a
    remote remove took) on a replica restored from the summary, card
    against CPU.  Outside the path, the one-doc programs (``apply_op``,
    K3, K5's ``restamp``, ``drop_squashed``, ``strip_stamp``) are timed
    alone on the final state beside their bytes bounds and held against
    the CPU.  Phase 16 runs first, right after the build, before any
    torch.profiler session (one leaves every later launch dearer on the
    host: ``apply_op`` 3.0 -> 4.2 ms a call on an H100); its programs are
    timed after phase 1b, as every other program is.
17. ``dds_clients``: the port's own DDS clients drive the card's
    programs, right after phase 16 (whose CPU run goes on meanwhile in
    its own process).  (a) 16 SharedTree docs of config 5's
    per-doc shape (4 writers with their own sub-arrays and a shared one,
    under one root array node; 8 edits a writer a round at the round's
    ref_seq, 40% string leaves; 4 rounds: the configuration's 64 docs of
    8 rounds, cut as the phase's ``reduced`` lists), each writer a
    ``ContainerRuntime`` with a ``sharedTree`` over one ``LocalService``,
    session ids from a generator seeded with ``--seed``; per doc a schema
    op (a typed view's ``initialize``), a transaction and a typed-view
    edit a round, one fork merged back, one edit undone and redone through
    ``UndoRedoStackManager``, and writer 3 offline and back every fourth
    round (resubmits); then a late client per doc loads from another's
    ``summary_tree``.  Each doc's log feeds ``TreeBatchEngine`` round by
    round at tree_fleet's geometry, once with the host fold and once with
    ``device_rebase=True``: every doc's ``tree_json`` equals every
    client's forest (JSON text), the fallback docs are listed, and 8
    sampled docs' raw columns equal a CPU engine's.  (b) 64 SharedMatrix
    clients on one ``LocalDocument`` (config 4: 128 seeded rows and
    columns, 16 steps of 64 ops, two of them row or column inserts or
    removes) into the scribe's matrix family on the card (K10 in batches
    of 16): every cell equals every client's.  (c) 4 SharedMap clients
    (config 2: 256 keys, 64 batches of 256 SET and DELETE ops, a CLEAR
    halfway) into the scribe's map family: every key equal.  (d) K11
    alone: each program on the card equals the CPU at its user's shape,
    the rebase arithmetic equals the host changeset rebase on 200 seeded
    changes, the reference's dry-run case gives [99, 30, 10] over 8
    docs; call times beside the bytes bounds (device times at the end of
    the script).  The path fails unless K7, K9, the map and matrix
    programs and every K11 program launched on it.  Its line carries the
    clients' and engines' edits/s, each part's seconds, ``over_cap``
    against a 150 s budget and ``reduced`` (the tree leg's cut).
18. ``network``: the network service plane and the loader, right after
    phase 16's CPU run is read.  (a) ``server.launcher.launch`` brings up
    two netserver shards of the port as processes (host only).  (b) The
    client leg: on its ``shard_index`` shard, one document made as
    ``tests/test_loader.py`` ``boot_doc`` makes it (a ``sharedString``
    "text" and a ``sharedMap`` "meta") and four loader ``Container``s over
    ``NetworkDocumentServiceFactory``, two with ``KernelMergeTree`` on the
    card at config 1's geometry and two on ``RefMergeTree``, run phase
    16's seeded script at 500 edits (of its 2,000, for the script's
    time limit; the line's ``reduced`` names the cut; a kernel client drops
    and rejoins through its ``ConnectionManager`` every sixth round; one
    stash goes
    through ``get_pending_local_state`` and ``Container.load``); every
    client runs a ``SummaryManager``, and a late client loads on the card
    from the newest snapshot over HTTP.  Every sync checks the four texts,
    annotations and intervals; every replica's channel summary equals the
    others', the late client's view equals them.  Then, as a path of its
    own, the squash regeneration runs on a replica restored from a kernel
    client's summary.  (c) The fleet leg: 256 docs and a hot doc over the
    two shards by ``shard_index``; the shard without the hot doc serves
    its docs at config-3 geometry, the hot doc's shard serves all of its
    docs (the hot doc and the cold docs that hash there) at config-1
    geometry, as one engine has one geometry; 4 network writers a doc
    (``SharedString`` over ``NetworkDeltaConnection``) running 8 rounds
    (``main`` runs 4, ``NET_REDUCED``) of phase 2's mix (each submit
    sequenced before the next; the hot doc takes 64 ops a round); one
    in-process ``FleetConsumer`` a shard over a ``DocBatchEngine`` on the
    card (the hot doc's shard on a docs x segs mesh with 4 segment shards,
    the hot doc promoted by ``enable_segment_sharding`` after round 3, or
    after round 1 of ``main``'s 4, and demoted at the end); a step and a compact a round.  No error bits, every doc's
    text equals its writers', and 32 sampled docs and the hot doc equal,
    raw row and latch, a CPU engine fed the streams read back over each
    shard's HTTP delta storage.  (d) ``python -m
    fluidframework_tpu_torch.server.fleet_main --device cuda`` over the
    other shard's docs: its last status line's texts equal the consumer's.
    The line carries the clients' edits/s and sync p50 ms, the writers'
    submit ops/s, the firehose -> device ops/s, the step seconds, each
    shard's geometry and doc count, each shard's sequenced ops
    (``/status``), the late client's boot seconds,
    each part's seconds and ``over_cap`` against a 150 s budget.
19. ``chaos``: the chaos soak over the whole serving stack, first of all
    phases and in a fresh process (``bench.py:2075`` runs it so), so no
    other phase warms the restores its recovery percentiles measure: the
    reference's headline soak (``bench.py:2117-2140``: seed 10, 240 ticks;
    ``main`` runs 120, ``CUTS``;
    6 string and 3 tree docs, every fault kind of ``testing/chaos.py``
    twice, warm standbys, 0.25 s checkpoint staleness, churn 0.08,
    ``ChaosStack``'s own engine geometry) through ``run_soak`` on the card,
    the tree engine on a mesh of 8 shards of the card, the service plane's
    documents sequenced by the native deli (``NativeSequencer``); then, as
    a path of its own (``chaos_migrate``), the reference's mixed-fleet
    chaos smoke (``tests/test_chaos.py:502``), whose two ``migrate`` faults
    move tree docs between shards (the soak's two target string docs,
    which the stack serves unsharded, so they are skip-counted there, as in
    the reference).  Fails unless every invariant held (each doc's fleet
    state and every writer equal the fault-free oracle replay, no double
    acks, bounded queues and recovery, the RSS bound on what the soak adds
    to its process), every fault kind fired, both families promoted a
    standby at each fleet kill, the engines' state was on the card, the
    native deli sequenced every document, K2, K3, K7 and K8 launched on
    the soak, and the smoke made a real migration over 8 shards.  The line
    carries the soak's seconds, ops sequenced and ops/s, op latency
    p50/p99 under fault, both families' recovery p50/p99 and intervals,
    events by kind, the counters, admission, the scribe pool's health, the
    process's peak RSS beside the RSS of the bare CUDA-initialised torch
    process (the child's, before the port loads) and the bound, the
    launches of K2, K3, K7, K8, the restore scatter and the cohort gather
    and scatter on each path, and whether the native deli served.
20. ``native_plane``: the native dispatch plane
    (``parallel/native_plane.py``: the fleet megastep and compact as the
    host C++ row loops of ``native/megastep.cpp``, built with g++), right
    after phase 18, before any profiler session.  (a) On phase 6's state
    and ring ([8, 10,000, 16] at config 3, made here and handed to phase 6):
    K2 on the card and the native megastep (columns copied out of the
    card, stepped on the host, copied back) give every raw column, padding
    remnants included, and the error latch byte for byte; so do K3 and the
    native compact over the 10,000 docs.  The line carries K2's and K3's
    call times (CUDA events) beside the native loop's host time and the
    two copies.  (b) In a fresh process whose
    ``FFTPU_TORCH_DISPATCH_PLANE`` names the native plane: the fleet's
    traffic for its first 256 docs and 4 rounds into a 1,024-doc
    ``DocBatchEngine(device="cuda", use_mesh=False)`` on each plane (cohort
    steps: the cohort gather and scatter and K4 on the card, the fleet
    programs on the host on the native plane): equal raw state and texts,
    no K2 or K3 launched on the native plane; checkpoints written on one
    plane restore on the other, both ways; a seg-shard request on the
    native plane leaves ``seg_plane_unsupported`` = 1.  Ops/s on each plane.
21. ``loadgen``: the loadgen traffic plant (``loadgen/``) at ``bench.py
    --config loadgen``'s size (seed 17, 6 workers on a host with 8 CPUs or
    more, else 4; 2 shards; ramp 8, steady 24, boots 6; the default doc
    matrix: 2 string, 1 tree, 1 map, 1 matrix and 1 channel-string doc),
    right after phase 19 and, like it, in a process of its own:
    ``run_loadgen(device="cuda")`` spawns 2 netserver shards, three
    ``fleet_main --device cuda`` processes (the string and tree fleets) and
    the worker OS processes, which run their phases over real TCP.  Fails
    unless the verdict is byte-identical for every family, no summary was
    double-acked, no foreign presence arrived, the historian served 304s,
    every fleet's engine state was on the card and launched its fleet
    programs (K2 and K3, or K7 and K8: the final drain line's ``launches``;
    a drained fleet compacts before its final checkpoint) and no worker
    initialised CUDA.  The line carries ramp, steady and boot-storm p50 and
    p99, ops sequenced and a row per fleet.
22. ``dds_family``: the rest of the DDS family, the snapshot corpus and
    the fluid-static framework with their strings on the card, right after
    phase 17, before any profiler session.  Every string channel's backend
    is ``KernelMergeTree`` on the card at phase 16's geometry
    (S=16,384, T=131,072).  (a) The snapshot corpus
    (``testing/snapshot_corpus.py``): every ``SCRIPTS`` entry regenerated
    into a temporary directory is byte-identical to its committed
    ``tests/snapshots/<name>.v<fmt>.json``, and every committed file,
    ``sharedString.v1.json`` included, loads into a container and
    reproduces its recorded state.  (c) A ``ContainerSchema`` with one
    channel of each of the registry's 16 types, four ``FluidContainer``s
    from a ``LocalServiceClient`` running a seeded script of 8 rounds of 16
    edits a container (string inserts, removes, annotates, markers and
    intervals; directory and map sets; counter, cell and register writes;
    queue adds, acquires and completes; ``AgentScheduler`` picks and
    releases over the task manager; pact sets, ink strokes, JSON OT, json1
    and property-tree ops; tree inserts and sets; matrix sets and row
    inserts); container 1 disconnects at round 3 (editing offline) and
    reconnects at round 5, so its pending string ops regenerate through
    K5's ``restamp``, and a fifth container boots from a summary stored at
    round 6.  Every sync checks the connected containers' views equal.  The
    same actions with every string on the oracle (``RefMergeTree``) give
    the same sequenced messages, container summaries, views, agent events
    and summary blocks, byte for byte.  (b) The corpus string and the
    oracle run's family string go through the legacy v1 chunks
    (``dds/snapshot_v1.py``) into a replica on the card
    (``import_summary``): its text, per-position props and markers equal
    the decoded oracle's.  The path fails unless ``apply_op``, K3 and K5's
    ``restamp`` launched on it.  The line carries each part's seconds,
    the edits/s on the card and on the oracle, the launches and
    ``over_cap`` against a 30 s budget.
23. ``debugger``: a document's history stepped op by op through the
    debugger driver (``driver/debugger_driver.py``) into viewers whose
    strings are on the card, right after phase 22.  Two writer containers
    (a ``sharedString`` with an interval collection and a ``sharedMap``,
    their strings on the oracle) make 1,000 seeded inserts, removes,
    interval adds and map sets over the local service.  (a) Two read-mode
    viewers load through ``DebuggerDocumentServiceFactory(inner,
    from_snapshot=False)`` before the datastore's attach op, one with its
    strings on ``KernelMergeTree`` on the card at phase 16's geometry, one
    on the oracle; each steps the held history the same way (``step(1)``
    for 200 messages, ``play_to_seq(350)``, ``resume()``) and records, at
    every sequence number that is a multiple of 50, its text and every
    channel's ``visualize_channel`` view: the two lists are equal, the card
    replica latched no error and launched ``apply_op`` at least once for
    each insert and remove.  (b) A third viewer boots on the card from the
    summary container 0 stores after 500 edits and steps only the tail:
    its checkpoints equal (a)'s.  Then live edits pass straight through to
    all three.  (c) ``FluidDevtools`` registers the three viewers and its
    ``DevtoolsServer`` (an ephemeral port) serves each container's JSON:
    the card viewers' equal the oracle's but for the container's key and
    id, and no view carries an ``"error"`` key.  The path fails unless
    ``apply_op`` and K3 launched on it.  The line carries the messages
    stepped, steps/s on the card and on the oracle, the checkpoints
    compared, the launches and each part's seconds, with ``over_cap``
    against a 60 s budget.
24. ``cross_card``: the rank mesh, one process a rank
    (``parallel.mesh.rank_mesh``), run last.  With two or more visible
    cards the ranks join an NCCL group, one rank a card (up to 4); on one
    card 4 ranks join a gloo group with every rank's rows on card 0 (the
    card count picks the backend; the line prints ``backend`` and
    ``cards``).  The parent builds nothing (the kernels are built) and
    starts the ranks, each with a timeout on ``init_process_group`` and
    the parent's cap on the whole world.  One docs x segs mesh
    (``seg_shards`` = the ranks) serves the fleet's first 4 rounds for all
    10,000 docs at config 3's geometry (2,517 slots a rank), a config-1
    hot doc (8 rounds of the four-writer soup, staged with the first fleet
    round: a K=4 lane megastep) promoted to a lane over
    every rank (S=16,384, T=131,072), and one doc migrated across ranks
    with its rows staged; then the long document (Q=256, S=262,144) over
    the same ranks.  Meanwhile the parent serves the same stream on one
    card (the stacked docs x segs mesh of phase 15).  It fails unless
    every rank's raw rows and latches equal the one-card engine's at the
    same slots (blake2b digests of each row's bytes), the hot doc's lane
    equals the stacked lane leaf for leaf, 32 sampled docs' texts equal a
    CPU replay, the error counts, quarantine and overflow sets agree, the
    migrated doc changed ranks with its row byte-identical, the long-doc
    answers equal K1's plain version, and on every rank K2, K3, K6, its
    compaction and K1 launched (the counts set to 0 just before the
    rank's main path and read just after; they join the ``kernels`` line
    as ``cross_card_ranks``).  A rank's traceback fails the phase.  Per
    rank it prints the launches, each step's seconds, K2's call and device
    time on its rows (ranks in turn, after the parent has left the card),
    the lane's seconds, rows/s and collectives an op, ``psum`` and
    ``all_gather`` ms a call, and one K6 call at [4, 16] over the ranks.
    ``--only cross_card`` runs the build and this phase alone, the last
    line's ``count`` the visible cards; over NCCL it then runs K1 and K9
    on tensors on ``cuda:1`` with ``cuda:0`` current against their plain
    versions (``other_card_kernels``, which phase 1 also runs with two or
    more cards), ``fleet_main --mesh N`` under ``torch.distributed.run``
    on the same ranks (``cross_entry``: 256 docs of the fleet traffic's
    first 4 rounds from a firehose; rank 0 alone prints, its texts equal
    an engine's on the CPU fed the same bytes, K2 launched) and its tree
    leg (``--family tree``: the first 64 docs of tree_fleet's stream that
    are not faulted, 4 rounds; its trees equal a CPU engine's, K7
    launched), then phase 25.
25. ``chaos_ranks``: ``run_chaos`` with the tree tier on a rank mesh, one
    process a rank, after phase 24 (NCCL with two or more cards, one rank
    a card up to 4; gloo with 4 ranks on card 0 otherwise): the
    reference's mixed-fleet smoke (``tests/test_chaos.py:502``: seed 16,
    30 ticks, 2 string docs, a nack storm, two tree-doc migrations, a
    fleet kill, a torn socket; standbys, 0.25 s staleness sweeps, the
    native deli) with 8 tree docs.  Rank 0 runs the stack and decides
    every fault; every rank serves its shard of the tree engine.  It
    fails unless every rank exits 0 within its cap, the invariants hold
    (oracle identity for both families, no double acks, bounded queues),
    one restart promoted a standby per family, a migration moved a doc
    between ranks, every rank stepped and made the collectives in step,
    and on every rank K7 and K8 launched (they join the ``kernels`` line
    as ``chaos_ranks``).  It prints each rank's launches and tree step
    ms, the tree recovery p50/p99 and the collectives a tick.
    ``--only chaos_ranks`` runs the build and this phase alone.

The fleet's traffic is made once, after phase 18, and shared by phases
2, 3, 6, 14, 15, 20 and 24 (a ``traffic`` line gives its generation time); each tree
path makes its own from the seed, outside its timed window.  Phases 2-5,
7-9b, 11-15 and 18-23 are the port's main path (the counts of phases 19
and 20(b) are taken in their own processes, phase 21's in its fleets'
processes): the launch counters of K1, of the
fleet programs, of K7 and K8, of K9, of the map and matrix programs and of
the cohort gather and scatter are set to 0 just before each of them and
read just after, and a path
that runs K1 (phases 4 and 5), K7 (phases 7-9b and 11), K8 (phases 7 and
9), K9 (phase 11), the fleet program on wire_ingest (9b), the map
program (12) or the matrix program (13) fails the run if it never
launched; so does the serving path (14) unless K2, K3, K7, K8 and the map
and matrix programs all launched on it.  Phase 15's parts are paths of
their own: ``sharded_fleet`` fails unless K2, K3 and the cohort gather and
scatter launched, ``sharded_hot`` unless K1 and K6 (``apply_megastep_seg``,
``compact_seg``) did, ``sharded_tree`` unless K7 did; ``string_client``
(16) fails unless the one-doc ``apply_op``, K3's ``compact`` and K5's
``restamp`` launched on it, and its squash regeneration, a path of its
own (``string_squash``: the runtime never asks for squash), unless K5's
``drop_squashed`` and ``strip_stamp`` did; phase 18's ``network_clients``
and ``network_squash`` paths the same, and ``network_fleet`` unless K2,
K3, K6 (both programs) and K1 did; ``dds_family`` (22) unless
``apply_op``, K3 and K5's ``restamp`` did; ``debugger`` (23) unless
``apply_op`` and K3 did; ``cross_card`` (24) unless K2, K3, K6 (both
programs) and K1 launched on every rank; ``chaos_ranks`` (25) unless K7
and K8 did.  Then
it prints the ``kernels`` summary line (K1 with its launches by path, the
segment lane's among them; K7, K8, K9, map, matrix; K2 and K3 at the
fleet's shape; K6 at 4 shards; the cohort gather and scatter; the one-doc
``apply_op`` and K5; K11's seven programs), the card's name and power
limit, and, last, the
``{"ok": true, ...}`` line.
Any failure exits nonzero without that line; so does a machine without a
CUDA card, or a directory without the port.  ``main`` runs eight phases
below the sizes above (``CUTS``: the recovery phase at the traffic's
first 1,000 docs with 16 sampled docs and 10 of its 20 faulted docs (4
past the text capacity, 4 past the segment count, 2 quarantined),
phase 15's fleet part at its three
checked turns (no timing turns), the serving phase's fleet_main entry at
64 docs, tree_fleet at 256 docs, so
``time_tree_programs`` holds K7 and K8 on a 256-doc ring and times K7's
routes at 2 of their 4 shares, tree_rebase at 32 fleet docs, the serving
phase's scribe at 16 string, tree and map docs of 64, phase 16 at 500 of
its 4,000 edits, and phase 19's soak at 120 of its 240 ticks) to stay inside the
script's 1,200 s limit; its ``cuts`` line, printed first, lists them, and
every phase line carries ``script_s``, the script's seconds so far.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import gzip
import http.client
import json
import os
import shutil
import subprocess
import tempfile
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


_T0 = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also carries the script's seconds so
    far (``script_s``)."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ traffic

def zipf_counts(n_docs: int, ops_per_step: int, a: float) -> np.ndarray:
    """Per-doc ops per round by Zipf rank (doc 0 busiest, floor 1)."""
    w = (np.arange(n_docs, dtype=np.float64) + 1.0) ** (-a)
    return np.maximum(1, np.round(ops_per_step * w / w[0]).astype(np.int64))


def fleet_traffic(n_docs: int, rounds: int, ops_per_round: int, ins_len: int,
                  seed: int, writers: int = 4):
    """Zipf-skewed multi-writer SharedString traffic as sequenced wire
    messages: per round every op stamps ref_seq at the round start (writers
    are mutually concurrent), writer slots alternate insert (``ins_len``
    chars at a random own-perspective position) / remove (2 chars of that
    same insert), and the MSN is the round start.  Returns per-round lists
    of (doc, message) and the join messages."""
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    D, W = n_docs, writers
    counts = zipf_counts(D, ops_per_round, 1.1)
    joins = [
        (d, SequencedMessage(
            client_id=f"w{w}", client_seq=0, ref_seq=0, seq=0, min_seq=0,
            type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w},
        ))
        for d in range(D) for w in range(W)
    ]
    lengths = np.zeros(D, np.int64)
    seq = np.zeros(D, np.int64)
    out = []
    for _r in range(rounds):
        ref = seq.copy()
        own_extra = np.zeros((D, W), np.int64)
        pair_pos = np.zeros((D, W), np.int64)
        rows = []
        for b in range(int(counts.max())):
            w = b % W
            docs = np.nonzero(b < counts)[0]
            own_len = lengths[docs] + own_extra[docs, w]
            insert = (b // W) % 2 == 0
            if insert:
                pos = np.minimum((rng.random(len(docs)) * (own_len + 1)).astype(np.int64), own_len)
                pair_pos[docs, w] = pos
                own_extra[docs, w] += ins_len
                texts = rng.integers(97, 123, size=(len(docs), ins_len))
            else:
                pos = pair_pos[docs, w]
                own_extra[docs, w] -= 2
            seq[docs] += 1
            for j, d in enumerate(docs.tolist()):
                if insert:
                    contents = {"type": 0, "pos1": int(pos[j]),
                                "seg": "".join(map(chr, texts[j]))}
                else:
                    contents = {"type": 1, "pos1": int(pos[j]), "pos2": int(pos[j]) + 2}
                rows.append((d, SequencedMessage(
                    client_id=f"w{w}", client_seq=int(seq[d]), ref_seq=int(ref[d]),
                    seq=int(seq[d]), min_seq=int(ref[d]), contents=contents,
                )))
        lengths = lengths + own_extra.sum(axis=1)
        out.append(rows)
    return joins, out


def four_writer_trace(seed: int, n_rounds: int, max_insert_len: int):
    """Multi-writer rounds with real ref_seq lag over one document:
    inserts (some multi-chunk), removes, annotates and sided obliterates of
    each writer's own content, valid in each op's own perspective.  Returns
    (ops[N, 8], payloads[N, L], ref[N]) op rows."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    rng = np.random.default_rng(seed)
    rows, refs = [], []
    length = 0
    seq = 0
    writers = 4
    empty = np.zeros(max_insert_len, np.int32)
    for _r in range(n_rounds):
        ref = seq
        base = length
        own = [0] * writers
        last_ins = [(0, 0)] * writers
        for w in range(writers):
            for _ in range(2):
                own_len = base + own[w]
                kind = rng.integers(0, 5)
                seq += 1
                if kind in (0, 1) or own_len < 4:
                    tlen = int(rng.integers(1, 20))
                    pos = int(rng.integers(0, own_len + 1))
                    text = "".join(chr(97 + rng.integers(0, 26)) for _ in range(tlen))
                    new = mk.encode_insert(pos, text, seq, w, ref, max_insert_len)
                    last_ins[w] = (pos, tlen)
                    own[w] += tlen
                elif kind == 2:
                    p, ln = last_ins[w]
                    p2 = min(p + max(1, ln // 2), own_len)
                    new = [(np.array([mk.OpKind.REMOVE, seq, w, ref, p, p2, 0, 0], np.int32), empty)]
                    own[w] -= p2 - p
                    last_ins[w] = (p, 0)
                elif kind == 3:
                    p = int(rng.integers(0, own_len - 1))
                    p2 = int(rng.integers(p + 1, own_len + 1))
                    new = [(np.array(
                        [mk.OpKind.ANNOTATE, seq, w, ref, p, p2,
                         int(rng.integers(0, 2)), int(rng.integers(1, 100))], np.int32,
                    ), empty)]
                else:
                    p, ln = last_ins[w]
                    if ln >= 2:
                        new = [(mk.encode_obliterate(
                            p, mk.SIDE_BEFORE, p + ln - 1, mk.SIDE_AFTER, seq, w, ref,
                        ), empty)]
                        own[w] -= ln
                        last_ins[w] = (p, 0)
                    else:
                        new = [(np.array([mk.OpKind.NOOP, seq, w, ref, 0, 0, 0, 0], np.int32), empty)]
                rows.extend(new)
                refs.extend([ref] * len(new))
        length = base + sum(own)
    return (np.stack([o for o, _ in rows]), np.stack([p for _, p in rows]),
            np.asarray(refs, np.int64))


# ----------------------------------------------------------------- timing

def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ----------------------------------------------------------------- phases

def _random_lens(rng, n_segs, vis_p=0.7, max_len=9):
    lens = rng.integers(0, max_len, size=n_segs).astype(np.int32)
    return np.where(rng.random(n_segs) < vis_p, lens, 0).astype(np.int32)


def _queries(rng, lens, n):
    total = int(lens.sum())
    qs = rng.integers(0, max(total, 1) + 3, size=n).astype(np.int32)
    return np.concatenate([qs, np.asarray([-1, -7, total, total + 5], np.int32)])


def _edge_queries(rng, lens, tile, n=300):
    """``n`` queries (more than one query chunk of the kernel): the prefix
    at every tile start and the total, one below each, one past the end,
    and random positions."""
    incl = np.cumsum(lens, dtype=np.int64)
    total = int(incl[-1])
    edges = np.unique(np.concatenate([[0], incl[tile - 1::tile], [total]]))
    fixed = np.concatenate([edges, edges - 1, [total + 5]])
    return np.concatenate([fixed, rng.integers(0, total + 3, size=n - len(fixed))]).astype(np.int32)


def tile_edge_cases(rng, tile):
    """K1 cases at the edges of its tiles: S one below, at and one past a
    tile, a ragged third tile, and 3 * tile + 3 segments with whole zero-sum
    tiles at the start, in the middle and at the end (tile 2 and the tail)."""
    cases = []
    for S, zero in ((tile - 1, ()), (tile, ()), (tile + 1, ()), (2 * tile + 3, ()),
                    (3 * tile + 3, (0,)), (3 * tile + 3, (1,)), (3 * tile + 3, (2, 3))):
        lens = _random_lens(rng, S)
        for t in zero:
            lens[t * tile:(t + 1) * tile] = 0
        cases.append((lens, _edge_queries(rng, lens, tile)))
    return cases


# Every K1 kernel's name contains this, in this design and the earlier one.
K1_NAME = "resolve_positions_"


def device_ms_by_name(fn, iters: int = 50) -> dict[str, float]:
    """Mean device time per call of ``fn`` of each device activity
    (kernels, copies, fills), by name, from torch.profiler; empty when the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "device_time_total", None)
        t = t if t is not None else evt.cuda_time_total
        if t:
            out[evt.key] = t / 1e3 / iters
    return out


def _device_sum(by_name: dict[str, float], name: str | None = None) -> float | None:
    """Sum over the activities whose name contains ``name`` (all when None);
    None when there are none."""
    return sum(v for k, v in by_name.items() if name is None or name in k) or None


def time_k1(rk, lens, qs, iters: int, plain_iters: int) -> dict:
    """K1 and its yardsticks on the same card tensors: call times (CUDA
    events over back-to-back calls, so host issue counts) and device times
    (torch.profiler).  ``library`` is the same function from ``lens`` in two
    PyTorch calls (cumsum, then searchsorted); ``library_search`` is the
    search alone over a prefix computed beforehand."""
    import torch

    incl = torch.cumsum(lens, -1, dtype=torch.int32)

    def k1():
        return rk.resolve_positions(lens, qs)

    def library():
        return torch.searchsorted(torch.cumsum(lens, -1, dtype=torch.int32), qs, right=True)

    # The function needs about Q*log2(S) compares, far below the bytes
    # bound: lens and the queries read once, the three outputs written once.
    nbytes = 4 * lens.numel() + 4 * qs.numel() + 3 * 4 * qs.numel()
    k1_device = device_ms_by_name(k1)
    return {
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes", "bound_bytes": nbytes,
        "kernel_ms": cuda_ms(k1, iters),
        "kernel_device_ms": _device_sum(k1_device, K1_NAME),
        # Everything the wrapper puts on the card per call, by activity.
        "call_device_ms": _device_sum(k1_device),
        "call_device_ms_by_name": {
            k.replace("(anonymous namespace)::", "").split("(")[0]: v for k, v in k1_device.items()
        },
        "plain_ms": cuda_ms(lambda: rk.resolve_positions_plain(lens, qs), plain_iters, warmup=2),
        "library_ms": cuda_ms(library, iters),
        "library_device_ms": _device_sum(device_ms_by_name(library)),
        "library_search_ms": cuda_ms(lambda: torch.searchsorted(incl, qs, right=True), iters),
    }


def k1_mismatch(qs, plane: str, got, want, want_cpu, again) -> str:
    """What a K1 disagreement was, for its failure message: the output
    plane; how many queries differ between the kernel, the plain version on
    the card and the plain version on the CPU; the first few such queries
    with the three values; and whether a second launch on the same inputs
    gave the same kernel output."""
    q = qs.reshape(-1)
    g, w, wc = (t.reshape(-1) for t in (got, want, want_cpu))
    at = ((g != w) | (g != wc) | (w != wc)).nonzero().flatten()[:4].tolist()
    return json.dumps({
        "plane": plane,
        "kernel_vs_plain_card": int((got != want).sum()),
        "kernel_vs_plain_cpu": int((got != want_cpu).sum()),
        "plain_card_vs_plain_cpu": int((want != want_cpu).sum()),
        "first": [{"at": i, "q": int(q[i]), "kernel": int(g[i]), "plain_card": int(w[i]),
                   "plain_cpu": int(wc[i])} for i in at],
        "second_launch_same": bool((again == got).all()),
    })


def phase_kernels(seed: int, card: str) -> dict:
    """K1 on the card against its plain version on the same card tensors
    (and the plain version on the CPU), exact; then timings at the
    long-document shape and the segment lane's."""
    import torch

    from fluidframework_tpu_torch.ops import resolve_kernel as rk

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cases = [
        (np.asarray([3, 0, 2], np.int32), np.asarray([0, 2, 3, 4, 5, 99, -1, -7], np.int32)),
        (np.zeros(256, np.int32), np.asarray([0, 1, 2, -1], np.int32)),
    ]
    for n_segs in (1, 7, 128, 1023, 1024, 1025, 1500, 4096, 16384):
        lens = _random_lens(rng, n_segs)
        cases.append((lens, _queries(rng, lens, 37)))
    cases += tile_edge_cases(rng, rk.TILE)
    big_lens = _random_lens(rng, 262_144)
    big_q = rng.integers(-3, int(big_lens.sum()) + 3, size=256).astype(np.int32)
    cases.append((big_lens, big_q))
    # Batched forms [D, S] x [D, Q]: random, and D=3 at the tile edges.
    lens_b = np.stack([_random_lens(rng, 3000) for _ in range(3)])
    batched = [(lens_b, np.stack([_queries(rng, lens_b[d], 60) for d in range(3)]))]
    lens_e = np.stack([_random_lens(rng, 2 * rk.TILE + 3) for _ in range(3)])
    lens_e[1, :rk.TILE] = 0
    lens_e[2, rk.TILE:] = 0
    batched.append((lens_e, np.stack([_edge_queries(rng, row, rk.TILE) for row in lens_e])))
    # The 4-shard segment lane's shape: [4, 16,384] lengths, one query a
    # shard (each shard's local coordinate, some before or past it).
    lens_4 = np.stack([_random_lens(rng, 16_384) for _ in range(4)])
    q_4 = np.asarray([[int(lens_4[0].sum()) // 2], [-3], [int(lens_4[2].sum())], [0]], np.int32)
    batched.append((lens_4, q_4))
    max_err = 0
    hits = 0
    for lens, qs in cases + batched:
        lt = torch.from_numpy(lens).to(dev)
        qt = torch.from_numpy(qs).to(dev)
        got = rk.resolve_positions(lt, qt)
        want = rk.resolve_positions_plain(lt, qt)
        want_cpu = rk.resolve_positions_plain(torch.from_numpy(lens), torch.from_numpy(qs))
        torch.cuda.synchronize()
        for plane, g, w, wc in zip(("idx", "off", "hit"), got, want, want_cpu):
            g, w = g.cpu(), w.cpu()
            max_err = max(max_err, int((g.long() - w.long()).abs().max()))
            if not (torch.equal(g, w) and torch.equal(g, wc)):
                again = rk.resolve_positions(lt, qt)[("idx", "off", "hit").index(plane)].cpu()
                check(False, f"K1 disagrees with its plain version at lens {lens.shape}, "
                             f"queries {qs.shape}: " + k1_mismatch(qs, plane, g, w, wc, again))
        hits += int(got[2].sum())

    lt = torch.from_numpy(big_lens).to(dev)
    qt = torch.from_numpy(big_q).to(dev)
    S, Q = lt.shape[0], qt.shape[0]
    long_doc = time_k1(rk, lt, qt, 200, 20)
    # Segment-lane shape: one query over a 16,384-segment hot doc.
    ls = torch.from_numpy(_random_lens(rng, 16_384)).to(dev)[None]
    qs1 = torch.zeros((1, 1), dtype=torch.int32, device=dev) + int(ls.sum()) // 2
    seg_lane = time_k1(rk, ls, qs1, 500, 200)
    ls4 = torch.from_numpy(lens_4).to(dev)
    seg_lane4 = time_k1(rk, ls4, torch.from_numpy(q_4).to(dev), 500, 200)
    out = {
        "phase": "kernels", "card": card, "cases": len(cases) + len(batched),
        "hits_checked": hits, "max_abs_err": max_err, "tile": rk.TILE,
        "S": S, "Q": Q, **long_doc,
        **{f"seg_lane_{k}": v for k, v in seg_lane.items()},
        **{f"seg_lane4_{k}": v for k, v in seg_lane4.items()},
    }
    if torch.cuda.device_count() >= 2:
        out["other_card"] = other_card_kernels(seed)
    emit(out)
    return out


def other_card_kernels(seed: int) -> dict:
    """K1 (the long-document shape) and K9 (256 microbench windows of C=8)
    on tensors on ``cuda:1`` while ``cuda:0`` is the current device, against
    their plain versions on the CPU, exact: each launcher launches on its
    tensors' card, with that card's stream.  Needs two cards."""
    import torch

    from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9
    from fluidframework_tpu_torch.ops import resolve_kernel as rk

    other = torch.device("cuda", 1)
    rng = np.random.default_rng(seed + 25)
    lens = torch.from_numpy(_random_lens(rng, 262_144))
    qs = torch.from_numpy(rng.integers(-3, int(lens.sum()) + 3, size=256).astype(np.int32))
    pool, windows = rebase_microbench_windows(seed + 25, 256)
    reb = DeviceRebaser(pool, device="cpu")
    c = torch.from_numpy(np.stack([reb.encode_commit(c).row for c, _ in windows]))
    xs = torch.from_numpy(np.stack([np.stack([reb.encode_commit(x).row for x in xw])
                                    for _, xw in windows]))
    elig = torch.ones(xs.shape[:2], dtype=torch.uint8)
    with torch.cuda.device(0):
        got1 = rk.resolve_positions(lens.to(other), qs.to(other))
        got9 = rk9.rebase_window(c.to(other), xs.to(other), elig.to(other))
        torch.cuda.synchronize(other)
        current = torch.cuda.current_device()
    k1 = all(torch.equal(g.cpu(), w) for g, w in zip(got1, rk.resolve_positions_plain(lens, qs)))
    k9 = all(torch.equal(g.cpu(), w) for g, w in zip(got9, rk9.rebase_window_plain(c, xs, elig)))
    check(current == 0, f"other card: the current device moved to {current}")
    check(k1, "K1 on cuda:1 (cuda:0 current) disagrees with its plain version")
    check(k9, "K9 on cuda:1 (cuda:0 current) disagrees with its plain version")
    return {"device": str(other), "current": current, "k1_equal": k1, "k9_equal": k9,
            "k1_shape": [int(lens.shape[0]), int(qs.shape[0])], "k9_shape": list(xs.shape[:2])}


def _state_rows_equal(a, b) -> bool:
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    return all(
        np.array_equal(x.cpu().numpy(), y.cpu().numpy())
        for x, y in zip(mk.leaves(a), mk.leaves(b))
    )


class SliceClock:
    """Per-slice wall times of ``apply_megastep`` on the fleet path.

    With no OBLITERATE in a slice, each slice starts with the obliterate
    gate's one host sync (``_ob_table_nonempty``), so the time from one
    gate read to the next is one slice issued and run on the card; the
    last slice of a megastep ends at the caller's ``end()`` after a sync.
    Also counts the op rows each slice applied.  Installs by wrapping the
    two module functions; ``close()`` restores them."""

    def __init__(self, mk):
        self.mk = mk
        self.gate, self.apply_op = mk._ob_table_nonempty, mk._apply_op
        self.slice_s: list[float] = []
        self.slice_rows: list[int] = []
        self._t = None

        def gate(st):
            out = self.gate(st)
            self._mark()
            return out

        def apply_op(st, op, payload, kinds, ob_flag):
            self.slice_rows[-1] += int((kinds != mk.OpKind.NOOP).sum())
            return self.apply_op(st, op, payload, kinds, ob_flag)

        mk._ob_table_nonempty, mk._apply_op = gate, apply_op

    def _mark(self) -> None:
        now = time.perf_counter()
        if self._t is not None:
            self.slice_s.append(now - self._t)
        self._t = now
        self.slice_rows.append(0)

    def end(self) -> None:
        """Close the running slice (call after a device sync)."""
        if self._t is not None:
            self.slice_s.append(time.perf_counter() - self._t)
            self._t = None

    def close(self) -> None:
        self.mk._ob_table_nonempty, self.mk._apply_op = self.gate, self.apply_op


# Config-3 geometry: the fleet and recovery phases' engines.
FLEET_GEOM = dict(max_segments=1024, text_capacity=8192, remove_slots=4,
                  prop_slots=2, ops_per_step=16, megastep_k=8, max_insert_len=16)


def install_recorder(capacity: int):
    """A fresh flight recorder installed as the process's global one."""
    from fluidframework_tpu_torch.observability import FlightRecorder, install

    return install(FlightRecorder(capacity=capacity))


def recorder_line(rec, trace_dir: str | None, name: str, events=None) -> dict:
    """A trace's summary: phase shares and seconds per span name, events
    kept and dropped; the Chrome trace goes to ``trace_dir`` when given."""
    from fluidframework_tpu_torch.observability import phase_shares, phase_totals

    events = rec.events() if events is None else events
    out = {"events": len(events), "dropped": rec.dropped,
           "phase_shares": phase_shares(events), "phase_s": phase_totals(events)}
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{name}.json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(rec.chrome_trace(), f)
        out["trace"] = path
    return out


def latency_gauges(eng) -> dict:
    """The engine's op-latency, watermark and overload surface."""
    h = eng.health()
    return {
        "latency_samples": h["latency_samples"],
        "latency_p50_ms": h.get("latency_p50_ms"), "latency_p99_ms": h.get("latency_p99_ms"),
        "ingest_watermarks": eng.ingest_watermarks(),
        **{k: h[k] for k in ("overload", "overloaded_docs", "overload_events",
                             "queue_depth_max")},
    }


def phase_fleet(seed: int, card: str, device: str, traffic, n_docs: int = 10_000,
                rounds: int = 16, step_every: int = 8, sample: int = 64,
                recovery: str = "grow", geom: dict = FLEET_GEOM, ingest: str = "batch",
                record: bool = False, trace_dir: str | None = None) -> dict:
    """The fleet at ``recovery`` on ``device``: the first ``rounds`` rounds
    of ``traffic`` (``fleet_traffic``'s joins and rounds for ``n_docs``),
    each round through one ``ingest_batch`` call (``ingest="batch"``) or
    per-message ``ingest`` (``"message"``).  ``record`` installs a flight
    recorder for the timed window (phase shares in the line), then records
    a checkpoint sweep of the sampled docs into a scratch store."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.observability import uninstall
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    geom = dict(geom, recovery=recovery)
    joins, rounds_msgs = traffic[0], traffic[1][:rounds]
    check(len(rounds_msgs) == rounds, f"fleet: traffic holds {len(rounds_msgs)} rounds")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = DocBatchEngine(n_docs, device=device, **geom)
    pick = np.sort(np.random.default_rng(seed + 1).choice(n_docs, size=min(sample, n_docs), replace=False))
    local = {int(d): j for j, d in enumerate(pick)}
    for d, m in joins:
        eng.ingest(d, m)
    clock = SliceClock(mk)
    ingest_s = step_s = compact_s = 0.0
    slices = 0
    rec = install_recorder(1 << 16) if record else None
    try:
        t_all = time.perf_counter()
        for r, msgs in enumerate(rounds_msgs):
            t1 = time.perf_counter()
            if ingest == "batch":
                eng.ingest_batch([d for d, _ in msgs], [m for _, m in msgs])
            else:
                for d, m in msgs:
                    eng.ingest(d, m)
            ingest_s += time.perf_counter() - t1
            if (r + 1) % step_every == 0 or r + 1 == len(rounds_msgs):
                t1 = time.perf_counter()
                slices += eng.step()
                if on_card:
                    torch.cuda.synchronize()
                clock.end()
                t2 = time.perf_counter()
                eng.compact()
                if on_card:
                    torch.cuda.synchronize()
                step_s += t2 - t1
                compact_s += time.perf_counter() - t2
        wall_s = time.perf_counter() - t_all
        trace = None
        if rec is not None:
            trace = recorder_line(rec, trace_dir, f"fleet_{recovery}")
            # A recorded checkpoint sweep of the sampled docs (outside the
            # timed window: the fleet runs without a store).
            ck_dir = tempfile.mkdtemp(prefix="chip_smoke_fleet_ckpt_")
            try:
                eng.checkpoint_store = CheckpointStore(ck_dir)
                n0 = len(rec.events())
                written = eng.maybe_checkpoint(docs=[int(d) for d in pick])
                check(len(written) == len(pick),
                      f"fleet: checkpointed {len(written)} of {len(pick)} sampled docs")
                trace["sampled_checkpoint_s"] = recorder_line(
                    rec, None, "", rec.events()[n0:])["phase_s"]
            finally:
                eng.checkpoint_store = None
                shutil.rmtree(ck_dir, ignore_errors=True)
    finally:
        clock.close()
        if rec is not None:
            uninstall()
    ops_applied = eng.counters.get("ops_staged")
    errored = eng.error_count()
    check(errored == 0, f"fleet latched error bits on {errored} docs")
    check(len(clock.slice_s) == slices, "fleet slice clock lost a slice")
    # The check's replay runs after the timed window: the sampled docs'
    # messages through the same engine on the CPU, stepped at the same
    # rounds.
    ref = DocBatchEngine(len(pick), device="cpu", **geom)
    for d, m in joins:
        if d in local:
            ref.ingest(local[d], m)
    for r, msgs in enumerate(rounds_msgs):
        for d, m in msgs:
            if d in local:
                ref.ingest(local[d], m)
        if (r + 1) % step_every == 0 or r + 1 == len(rounds_msgs):
            ref.step()
            ref.compact()
    same = sum(_state_rows_equal(eng.doc_state(int(d)), ref.doc_state(j)) for j, d in enumerate(pick))
    check(same == len(pick), f"{len(pick) - same} of {len(pick)} sampled docs differ from the CPU replay")
    out = {
        "phase": "fleet", "card": card, "recovery": recovery, "ingest": ingest,
        "recorder": record, "docs": n_docs,
        "rounds": rounds, "ops_applied": ops_applied, "slices": slices,
        "megasteps": eng.counters.get("megastep_dispatches"),
        "ingest_s": ingest_s, "step_s": step_s,
        "compact_s": compact_s, "wall_s": wall_s, "ops_per_s": ops_applied / wall_s,
        "slice_s": clock.slice_s, "slice_rows": clock.slice_rows,
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
        "ob_gate_syncs": eng.health()["ob_gate_syncs"],
        "ingest_batch_rows": eng.counters.get("ingest_batch_rows"),
        "sampled_docs_identical": same,
        **latency_gauges(eng),
    }
    if trace is not None:
        out["trace"] = trace
    emit(out)
    return out


def fault_traffic(n_docs: int, rounds: int, extra: int, geom: dict, seed: int,
                  faulted: int = 20):
    """Seeded faults for the recovery phase, over ``rounds`` rounds plus
    ``extra`` later ones, on ``faulted`` docs (a multiple of 5) away from
    the Zipf head (their Zipf traffic is dropped; writer w0 alone, each op
    seeing every earlier one); at 20:

    - 8 ``text`` docs append inserts of 4 chunks until the text pool passes
      ``text_capacity`` (ERR_TEXT_OVERFLOW) and remove 2 chars a round;
    - 8 ``seg`` docs insert 2 chars strictly inside a segment (+2 segments
      each) until they pass ``max_segments`` (ERR_SEG_OVERFLOW);
    - 4 ``pos`` docs insert once past their visible length in the middle
      round (ERR_POS_RANGE: quarantine), with valid inserts around it.

    Returns ({kind: [docs]}, {doc: [[message] per round]})."""
    from fluidframework_tpu_torch.protocol.messages import SequencedMessage

    rng = np.random.default_rng(seed + 7)
    skip = min(100, n_docs // 2)
    picks = rng.choice(np.arange(skip, n_docs), size=faulted, replace=False).tolist()
    k = 2 * faulted // 5
    plan = {"text": sorted(picks[:k]), "seg": sorted(picks[k:2 * k]), "pos": sorted(picks[2 * k:])}
    T, S, L = geom["text_capacity"], geom["max_segments"], geom["max_insert_len"]
    chunk = 4 * L
    text_per_round = -(-(T + chunk) // (rounds * chunk))
    seg_per_round = -(-(S // 2 + 8) // rounds)
    out = {}
    for kind, docs in plan.items():
        for d in docs:
            seq = 0
            length = 0
            segs = []  # the seg docs' segment lengths, in order
            per_round = []
            for r in range(rounds + extra):
                floor = seq
                msgs = []

                def op(contents):
                    nonlocal seq
                    seq += 1
                    msgs.append(SequencedMessage(
                        client_id="w0", client_seq=seq, ref_seq=seq - 1, seq=seq,
                        min_seq=floor, contents=contents,
                    ))

                if kind == "text":
                    for _ in range(text_per_round):
                        op({"type": 0, "pos1": length, "seg": "".join(
                            map(chr, rng.integers(97, 123, size=chunk)))})
                        length += chunk
                    op({"type": 1, "pos1": 0, "pos2": 2})
                    length -= 2
                elif kind == "seg":
                    if not segs:
                        op({"type": 0, "pos1": 0, "seg": "s" * L})
                        segs = [L]
                    for _ in range(seg_per_round):
                        cand = [i for i, n in enumerate(segs) if n >= 2]
                        i = cand[int(rng.integers(0, len(cand)))]
                        cut = int(rng.integers(1, segs[i]))
                        op({"type": 0, "pos1": sum(segs[:i]) + cut, "seg": "yz"})
                        segs[i:i + 1] = [cut, 2, segs[i] - cut]
                else:
                    if r == rounds // 2:
                        op({"type": 0, "pos1": length + 5, "seg": "bad"})
                    op({"type": 0, "pos1": 0, "seg": "ok"})
                    length += 2
                per_round.append(msgs)
            out[d] = per_round
    return plan, out


def _fleet_rounds(rounds_msgs, faults, r, docs=None):
    """Round ``r``'s messages: the Zipf traffic without the fault docs',
    then the fault docs' (restricted to ``docs`` when given)."""
    msgs = [(d, m) for d, m in rounds_msgs[r] if d not in faults]
    msgs += [(d, m) for d in sorted(faults) for m in faults[d][r]]
    return msgs if docs is None else [(d, m) for d, m in msgs if d in docs]


def _lane_of(eng, d: int):
    return ("overflow" if d in eng.overflow else "quarantine" if d in eng.quarantine
            else "oracle" if d in eng.oracles else "batch")


def _summary(eng, d: int) -> dict:
    """A doc's summary: its host oracle's, or its device state's through
    the checkpoint codec."""
    from fluidframework_tpu_torch.dds import kernel_backend as kb

    tree = eng.quarantine.get(d) or eng.oracles.get(d)
    if tree is not None:
        return tree.export_summary()
    names = {v: k for k, v in eng.hosts[d].prop_slot.items()}
    return kb.state_to_summary(eng.doc_state(d), names)


def _docs_equivalent(a, da: int, b, db: int) -> bool:
    """Two engines hold the same document: lane, lane geometry, text,
    annotations and summary (a restored row is the original's summary
    packed afresh, so its raw columns differ from a row with history)."""
    if (_lane_of(a, da), a.text(da), a.annotations(da)) != (_lane_of(b, db), b.text(db), b.annotations(db)):
        return False
    if da in a.overflow and (
        (a.overflow[da].geometry, a.overflow[da].growths)
        != (b.overflow[db].geometry, b.overflow[db].growths)
    ):
        return False
    return _summary(a, da) == _summary(b, db)


@contextlib.contextmanager
def _host_views(*engines):
    """Each engine's batch state read through one host (numpy) copy of it
    inside the block: the views of its docs (text, annotations, summaries;
    a tree doc's ``tree_json``) come from the copy, one transfer from the
    card in place of several a doc, and a row is numpy views in place of
    tensor views.  The block only reads."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    saved = [e.state for e in engines]
    try:
        for e in engines:
            tree = isinstance(e.state, tk.NestedForestState)
            e.state = (tk.to_numpy if tree else mk.to_numpy)(e.state)
        yield
    finally:
        for e, st in zip(engines, saved):
            e.state = st


def _docs_identical(a, da: int, b, db: int) -> bool:
    """``_docs_equivalent`` and, for device-held docs, every raw state
    column (batch row or overflow lane) equal."""
    if not _docs_equivalent(a, da, b, db):
        return False
    return _lane_of(a, da) not in ("batch", "overflow") or _state_rows_equal(
        a.doc_state(da), b.doc_state(db))


def digest_bound(state) -> tuple[int, float]:
    """K4's bytes bound: every column it reads once (text, seg_len,
    seg_start, rem_keys, text_end, nseg) and its int64 output written once."""
    D, T = state.text.shape
    S = state.seg_len.shape[-1]
    nbytes = 4 * D * (T + (2 + len(state.rem_keys)) * S + 2) + 8 * D
    return nbytes, nbytes / H100_BYTES_PER_S * 1e3


def phase_recovery(seed: int, card: str, device: str, traffic, n_docs: int = 10_000,
                   rounds: int = 16, step_every: int = 8, sample: int = 64,
                   geom: dict = FLEET_GEOM, tamper_docs: int = 256, faulted: int = 20) -> dict:
    """The recovery and durability path at the fleet phase's geometry on
    ``device``: ``traffic`` (``fleet_traffic``'s joins and at least
    ``rounds`` + 2 rounds for ``n_docs``) with seeded faults through
    ``recovery="grow"``, a
    CPU replay of the faulted docs and a sample, two watchdog sweeps (K4
    timed against its bound), a tamper check, a forced checkpoint sweep,
    a restore into a fresh engine, and traffic after it."""
    import torch

    from fluidframework_tpu_torch.dds import kernel_backend as kb
    from fluidframework_tpu_torch.models.doc_batch_engine import (
        DocBatchEngine, fleet_digest, scatter_rows,
    )
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    geom = dict(geom, recovery="grow")
    joins, rounds_msgs = traffic
    check(len(rounds_msgs) >= rounds + 2, f"recovery: traffic holds {len(rounds_msgs)} rounds")
    # The first ``n_docs`` docs of the traffic (all of them uncut).
    joins = [(d, m) for d, m in joins if d < n_docs]
    rounds_msgs = [[(d, m) for d, m in rnd if d < n_docs] for rnd in rounds_msgs]
    t0 = time.perf_counter()
    plan, faults = fault_traffic(n_docs, rounds, 2, geom, seed, faulted)
    gen_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    launches0 = resolve_positions.launches
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    parts_s = {}
    t_lap = [time.perf_counter()]

    def lap(name):
        """The seconds since the previous lap, as the line's ``parts_s``."""
        now = time.perf_counter()
        parts_s[name] = now - t_lap[0]
        t_lap[0] = now

    try:
        eng = DocBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        # recover() as a whole (its error-count read waits for the queued
        # megasteps), and the grow replays inside it.
        timers = {"recover": 0.0, "_recover_doc": 0.0}
        for name in timers:
            def timed(*a, _fn=getattr(eng, name), _name=name, **kw):
                t = time.perf_counter()
                out = _fn(*a, **kw)
                timers[_name] += time.perf_counter() - t
                return out

            setattr(eng, name, timed)
        for d, m in joins:
            eng.ingest(d, m)
        t_all = time.perf_counter()
        for r in range(rounds):
            for d, m in _fleet_rounds(rounds_msgs, faults, r):
                eng.ingest(d, m)
            if (r + 1) % step_every == 0 or r + 1 == rounds:
                eng.step()
                eng.compact()
                sync()
        wall_s = time.perf_counter() - t_all
        lap("rounds")
        ops_applied = eng.counters.get("ops_staged")
        check(not eng.errors().any(), "recovery left error bits")
        check(sorted(eng.overflow) == sorted(plan["text"] + plan["seg"]),
              f"overflow lanes {sorted(eng.overflow)}")
        check(all(eng.overflow[d].geometry["text_capacity"] == 2 * geom["text_capacity"]
                  for d in plan["text"]), "text lanes not at twice the text capacity")
        check(all(eng.overflow[d].geometry["max_segments"] == 2 * geom["max_segments"]
                  for d in plan["seg"]), "segment lanes not at twice the segments")
        check(sorted(eng.quarantine) == plan["pos"], f"quarantined {sorted(eng.quarantine)}")

        # The faulted docs and a sample replayed on the CPU, same rounds.
        rng = np.random.default_rng(seed + 2)
        others = np.setdiff1d(np.arange(n_docs), np.asarray(sorted(faults)))
        pick = sorted(faults) + sorted(rng.choice(others, size=min(sample, len(others)),
                                                  replace=False).tolist())
        local = {d: j for j, d in enumerate(pick)}
        cpu = DocBatchEngine(len(pick), device="cpu", **geom)
        t1 = time.perf_counter()
        for d, m in joins:
            if d in local:
                cpu.ingest(local[d], m)
        for r in range(rounds):
            for d, m in _fleet_rounds(rounds_msgs, faults, r, local):
                cpu.ingest(local[d], m)
            if (r + 1) % step_every == 0 or r + 1 == rounds:
                cpu.step()
                cpu.compact()
        cpu_replay_s = time.perf_counter() - t1
        lap("cpu_replay")
        same = sum(_docs_identical(eng, d, cpu, j) for d, j in local.items())
        check(same == len(pick), f"{len(pick) - same} of {len(pick)} docs differ from the CPU replay")

        # Watchdog at full width: two sweeps of 64, then K4 alone.
        t1 = time.perf_counter()
        failed = eng.watchdog(sample=64) + eng.watchdog(sample=64)
        sync()
        watchdog_s = time.perf_counter() - t1
        check(not failed, f"watchdog failed docs {failed}")
        wd = {k: eng.counters.get(k) for k in ("watchdog_checks", "watchdog_prefiltered")}
        # Sweep 1 verifies 64 of the batch docs; sweep 2 skips those (their
        # digest and stream did not move) and verifies the next 64.
        eligible = n_docs - len(faults)
        first = min(64, eligible)
        check(wd == {"watchdog_checks": first + min(64, eligible - first),
                     "watchdog_prefiltered": first}, f"watchdog {wd}")
        peak_mem = torch.cuda.max_memory_allocated() if on_card else None
        dig_bytes, dig_bound_ms = digest_bound(eng.state)
        digest = {"digest_bytes": dig_bytes, "digest_bound_ms": dig_bound_ms}
        if on_card:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            card_dig = fleet_digest(eng.state)
            sync()
            digest.update(
                digest_peak_extra_bytes=torch.cuda.max_memory_allocated() - base,
                digest_ms=cuda_ms(lambda: fleet_digest(eng.state), 10, warmup=2),
                digest_device_ms=_device_sum(device_ms_by_name(lambda: fleet_digest(eng.state), 10)),
            )
            cpu_dig = fleet_digest(mk.from_numpy(mk.to_numpy(eng.state), device="cpu"))
            check(torch.equal(card_dig.cpu(), cpu_dig), "K4 on the card differs from the CPU")

        lap("watchdog_digest")
        # Tamper check on a separate engine at the same geometry.
        tw = DocBatchEngine(tamper_docs, device=device, **geom)
        t_joins, t_rounds = fleet_traffic(tamper_docs, 2, geom["ops_per_step"], 8, seed + 3)
        for d, m in t_joins + [x for rnd in t_rounds for x in rnd]:
            tw.ingest(d, m)
        tw.step()
        check(tw.watchdog(sample=tamper_docs) == [], "tamper engine: clean sweep failed")
        victim = int(np.random.default_rng(seed + 4).integers(0, tamper_docs))
        row = mk.to_numpy(mk.doc_row(tw.state, victim))
        _, vis = mk._host_vis(row, mk.ALL_ACKED, -3)
        seg = int(np.flatnonzero(vis & (row.seg_len[: len(vis)] > 0))[0])
        at = int(row.seg_start[seg])
        before_text = tw.text(victim)
        pref0 = tw.counters.get("watchdog_prefiltered")
        tw.state.text[victim, at] = 97 + (int(row.text[at]) - 96) % 26
        check(mk.visible_text(mk.doc_row(tw.state, victim)) != before_text, "tamper changed nothing")
        t_card = fleet_digest(tw.state).cpu()
        t_cpu = fleet_digest(mk.from_numpy(mk.to_numpy(tw.state), device="cpu"))
        check(torch.equal(t_card, t_cpu), "K4 differs between the card and the CPU (tamper rows)")
        caught = tw.watchdog(sample=tamper_docs)
        tamper = {
            "tamper_docs": tamper_docs, "tamper_caught": caught,
            "tamper_prefiltered": tw.counters.get("watchdog_prefiltered") - pref0,
        }
        check(caught == [victim] and victim in tw.quarantine, f"tamper: caught {caught}")
        check(tamper["tamper_prefiltered"] == tamper_docs - 1, f"tamper {tamper}")
        check(tw.text(victim) == before_text, "tampered doc's oracle text differs")
        del tw
        lap("tamper")

        # Checkpoint sweep, then restore into a fresh engine.
        t1 = time.perf_counter()
        written = eng.maybe_checkpoint(force=True)
        checkpoint_s = time.perf_counter() - t1
        ck_root = os.path.join(ck_dir, "checkpoints")
        ck_bytes = sum(os.path.getsize(os.path.join(ck_root, n)) for n in os.listdir(ck_root))
        check(len(written) == n_docs, f"checkpointed {len(written)}")
        eng2 = DocBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        t1 = time.perf_counter()
        restored = eng2.restore_from_checkpoints()
        sync()
        restore_s = time.perf_counter() - t1
        lap("checkpoint_restore")
        check(restored == sorted(written), "restore missed docs")
        # Every restored doc holds the original's summary, lane and text;
        # a sampled batch row equals, column by column, the original's
        # summary packed at the batch geometry (what restore must write).
        with _host_views(eng, eng2):
            check(all(_docs_equivalent(eng, d, eng2, d) for d in restored),
                  "restored docs differ")
        lap("restore_check")
        sampled = [d for d in pick if d in set(restored)]
        for d in sampled:
            if _lane_of(eng, d) == "batch":
                want = kb.summary_to_state_host(
                    _summary(eng, d), eng2.geometry, eng2.hosts[d].prop_slot.__getitem__)
                check(_state_rows_equal(eng2.doc_state(d), mk.from_numpy(want, device="cpu")),
                      f"restored row {d} is not its summary's pack")

        lap("row_pack_check")
        # The parallel restore's scatter alone (K4's neighbour on the table):
        # the restored batch rows written again from a host stack — the
        # same bytes, so the state does not change.
        scatter = {}
        if on_card:
            rows = [int(eng2._slot[d]) for d in restored if _lane_of(eng2, d) == "batch"]
            stacked = mk.tree_map(lambda x: x[rows], mk.to_numpy(eng2.state))
            nbytes = 2 * sum(x.nbytes for x in mk.leaves(stacked))
            # The library part alone: one ``index_copy_`` per leaf from rows
            # already on the card (the host-to-device copy left out).
            idx = torch.tensor(rows, device="cuda")
            on_dev = [torch.from_numpy(y).cuda() for y in mk.leaves(stacked)]

            def index_copy():
                for x, y in zip(mk.leaves(eng2.state), on_dev):
                    x.index_copy_(0, idx, y)

            scatter = {
                "scatter_rows": len(rows), "scatter_bytes": nbytes,
                "scatter_bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                "scatter_ms": cuda_ms(lambda: scatter_rows(eng2.state, rows, stacked), 3, warmup=1),
                "scatter_device_ms": _device_sum(device_ms_by_name(
                    lambda: scatter_rows(eng2.state, rows, stacked), 3)),
                "scatter_library_ms": cuda_ms(index_copy, 3, warmup=1),
                "scatter_library_device_ms": _device_sum(device_ms_by_name(index_copy, 3)),
            }
            del stacked, on_dev

        lap("scatter_timing")
        # Two more rounds to both engines, then one checkpointed round again.
        live = set(restored)
        for r in (rounds, rounds + 1):
            for d, m in _fleet_rounds(rounds_msgs, faults, r, live):
                eng.ingest(d, m)
                eng2.ingest(d, m)
        for e in (eng, eng2):
            e.step()
            e.compact()
        sync()
        check(eng2.counters.get("checkpointed_ops_skipped") == 0, "new ops were skipped")
        check(all(_docs_equivalent(eng, d, eng2, d) for d in sampled),
              "post-restore traffic diverged")
        dig0 = fleet_digest(eng2.state).cpu()
        for d, m in _fleet_rounds(rounds_msgs, faults, rounds - 1, live):
            eng2.ingest(d, m)
        eng2.step()
        skipped = eng2.counters.get("checkpointed_ops_skipped")
        check(skipped > 0 and torch.equal(fleet_digest(eng2.state).cpu(), dig0)
              and all(_docs_equivalent(eng, d, eng2, d) for d in sampled),
              "re-fed checkpointed round changed the restored engine")
        lap("post_restore")
        health = eng.health()
        out = {
            "phase": "recovery", "card": card, "docs": n_docs, "rounds": rounds,
            "recovery": "grow", "faults": {k: len(v) for k, v in plan.items()},
            "fault_gen_s": gen_s, "ops_applied": ops_applied, "wall_s": wall_s,
            "ops_per_s": ops_applied / wall_s, "recover_s": timers["recover"],
            "replay_s": timers["_recover_doc"],
            "cpu_replay_docs": len(pick), "cpu_replay_s": cpu_replay_s,
            "watchdog_s": watchdog_s, **wd, **digest, **tamper,
            "checkpoint_docs": len(written), "checkpoint_bytes": ck_bytes,
            "checkpoint_s": checkpoint_s, "restore_docs": len(restored),
            "restore_s": restore_s, **scatter, "peak_mem_bytes": peak_mem,
            # Since K4's measurement: the restore's second engine included.
            "peak_mem_restore_bytes": torch.cuda.max_memory_allocated() if on_card else None,
            "checkpointed_ops_skipped": skipped,
            "k1_launches": resolve_positions.launches - launches0,
            **{k: health.get(k) for k in (
                "capacity_recoveries", "quarantines", "poison_ops_dropped",
                "recovery_replay_len", "quarantine_replay_len", "overflow_docs",
                "quarantined_docs", "checkpoints_written", "megastep_dispatches",
                "megastep_slices")},
            "docs_restored": eng2.counters.get("docs_restored"),
            "parts_s": parts_s,
        }
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    emit(out)
    return out


def phase_hot_doc(seed: int, card: str, device: str, S: int = 16_384,
                  T: int = 131_072, rounds: int = 96) -> dict:
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.parallel import mesh as pm

    L, K, B = 8, 8, 16
    ops, pays, refs = four_writer_trace(seed, rounds, L)
    n = -(-len(ops) // (K * B)) * K * B
    ops = np.concatenate([ops, np.zeros((n - len(ops), 8), np.int32)])
    pays = np.concatenate([pays, np.zeros((n - len(pays), L), np.int32)])
    refs = np.concatenate([refs, np.full(n - len(refs), refs[-1])])
    mesh = pm.docs_segs_mesh(device, seg_shards=1)
    proto = mk.init_state(S, 4, 2, T, 8, device=device)
    blocked = mk.seg_shard_state(proto, 1)
    seg_prog = pm.mesh_seg_program(mk.apply_megastep_seg, mesh, pm.seg_state_specs(blocked))
    seg_compact = pm.mesh_seg_program(mk.compact_seg, mesh)
    seg = pm.shard_seg_state(blocked, mesh)
    single = mk.batch_state(proto, 1)
    launches0 = resolve_positions.launches
    seg_s = single_s = 0.0
    for c in range(n // (K * B)):
        o = ops[c * K * B:(c + 1) * K * B].reshape(K, B, 8)
        p = pays[c * K * B:(c + 1) * K * B].reshape(K, B, L)
        min_seq = int(refs[(c + 1) * K * B - 1])
        t1 = time.perf_counter()
        seg = seg_compact(seg_prog(seg, o, p), min_seq)
        if device == "cuda":
            torch.cuda.synchronize()
        seg_s += time.perf_counter() - t1
        t1 = time.perf_counter()
        single = mk.apply_megastep(single, o[:, None], p[:, None])
        single = mk.compact(mk.set_min_seq(single, np.asarray([min_seq], np.int32)))
        if device == "cuda":
            torch.cuda.synchronize()
        single_s += time.perf_counter() - t1
    k1 = resolve_positions.launches - launches0
    a = mk.canonical_doc(mk.doc_row(single, 0))
    b = mk.canonical_doc(mk.seg_gather_state(seg, max_segments=S))
    bad = [k for k in a if not np.array_equal(a[k], b[k])]
    check(not bad, f"segment lane diverged from the single lane in {bad}")
    check(a["error"] == 0, f"hot doc latched error bits {a['error']}")
    if device == "cuda":
        check(k1 > 0, "segment lane never launched K1")
    out = {
        "phase": "hot_doc", "card": card, "S": S, "T": T, "op_rows": int(len(ops)),
        "live_segments": a["nseg"], "text_end": a["text_end"],
        "seg_lane_s": seg_s, "single_lane_s": single_s,
        "seg_rows_per_s": len(ops) / seg_s, "k1_launches": k1,
        "identical": True,
    }
    emit(out)
    return out


def phase_long_doc(seed: int, card: str, device: str, S: int = 262_144, Q: int = 256) -> dict:
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.parallel import mesh as pm
    from fluidframework_tpu_torch.parallel.long_doc import make_sharded_ops, shard_doc_state
    from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED, NO_REMOVE

    rng = np.random.default_rng(seed)
    seg_len = rng.integers(1, 9, size=S).astype(np.int32)
    removed = rng.random(S) < 0.15
    host = mk.to_numpy(mk.init_state(S, 2, 2, int(seg_len.sum()), 8, device="cpu"))
    rem0 = np.where(removed, S + 1 + np.arange(S), NO_REMOVE).astype(np.int32)
    host = host._replace(
        nseg=np.asarray(S, np.int32),
        seg_start=(np.cumsum(seg_len) - seg_len).astype(np.int32),
        seg_len=seg_len,
        ins_key=np.arange(1, S + 1, dtype=np.int32),
        ins_client=np.zeros(S, np.int32),
        rem_keys=(rem0,) + host.rem_keys[1:],
    )
    mesh = pm.doc_mesh(device)
    state = shard_doc_state(mk.from_numpy(host, device="cpu"), mesh)
    vis_len, resolve, mark = make_sharded_ops(mesh, state)
    lens = np.where(removed, 0, seg_len).astype(np.int64)
    total = int(lens.sum())
    queries = rng.integers(0, total, size=Q).astype(np.int32)
    launches0 = resolve_positions.launches
    t1 = time.perf_counter()
    gi, off = resolve(state, queries, ALL_ACKED, -2)
    if device == "cuda":
        torch.cuda.synchronize()
    resolve_s = time.perf_counter() - t1
    k1 = resolve_positions.launches - launches0
    incl = np.cumsum(lens)
    want_i = np.searchsorted(incl, queries, side="right")
    want_o = queries - (incl[want_i] - lens[want_i])
    check(np.array_equal(gi.cpu().numpy(), want_i) and np.array_equal(off.cpu().numpy(), want_o),
          "long-doc resolve disagrees with numpy")
    check(int(vis_len(state, ALL_ACKED, -2)) == total, "long-doc visible length")
    out_state = mark(state, 40, 4000, S + 10 * S, 3, ALL_ACKED, -2)
    prefix = incl - lens
    in_range = (lens > 0) & (prefix >= 40) & (incl <= 4000)
    want_rem0 = np.where((rem0 == NO_REMOVE) & in_range, S + 10 * S, rem0)
    check(np.array_equal(out_state.rem_keys[0].cpu().numpy(), want_rem0), "long-doc mark")
    if device == "cuda":
        check(k1 > 0, "long-doc resolve never launched K1")
    out = {"phase": "long_doc", "card": card, "S": S, "Q": Q,
           "resolve_s": resolve_s, "k1_launches": k1, "identical": True}
    emit(out)
    return out


# ------------------------------------------------- fleet programs alone

def nbytes_of(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_program(fn, iters: int, prof_iters: int | None = None, uncounted=None) -> dict:
    """Call time (CUDA events over ``iters`` back-to-back calls) and device
    time (torch.profiler over ``prof_iters`` calls, every activity) of one
    device program.  ``uncounted``: the program whose launch counter the
    timing calls leave as they found it (timing inside a main-path phase,
    whose count is the path's own launches)."""
    launches = uncounted.launches if uncounted is not None else None
    out = {"ms": cuda_ms(fn, iters, warmup=1),
           "device_ms": _device_sum(device_ms_by_name(fn, prof_iters or iters))}
    if uncounted is not None:
        uncounted.launches = launches
    return out


def state_bound(state_leaves, ring_leaves=()) -> tuple[int, float]:
    """The bytes bound of a program that reads and writes a state once and
    reads an op ring once, at the card's memory rate."""
    nbytes = 2 * nbytes_of(state_leaves) + nbytes_of(ring_leaves)
    return nbytes, nbytes / H100_BYTES_PER_S * 1e3


def leaf_max_err(got, want, n: int | None = None) -> int:
    """The largest absolute difference between two leaf lists (the first
    ``n`` rows of ``got`` against ``want`` when ``n`` is given), as int64
    on the host."""
    return max(int((g[:n].cpu().long() - w.cpu().long()).abs().max()) if w.numel() else 0
               for g, w in zip(got, want))


def fleet_ring(traffic, n_docs: int = 10_000, geom: dict = FLEET_GEOM) -> dict:
    """The state and ring of the fleet phase's second megastep on the card:
    an engine takes rounds 0-7 of ``traffic`` and steps and compacts, then
    rounds 8-15 are drained into one K=8 ring.  Returns the state, the
    ring on the card (``ops``, ``pays``), its host kinds, ``K``, every
    doc's MSN floor (``mins``) and the doc count."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    joins, rounds_msgs = traffic
    eng = DocBatchEngine(n_docs, device="cuda", **dict(geom, recovery="off"))
    for d, m in joins:
        eng.ingest(d, m)
    for r in range(8):
        for d, m in rounds_msgs[r]:
            eng.ingest(d, m)
    eng.step()
    eng.compact()
    for r in range(8, 16):
        for d, m in rounds_msgs[r]:
            eng.ingest(d, m)
    busy = sorted(eng._busy)
    K = eng._select_k(busy)
    stage = eng._staging()
    ops, pays = stage.acquire(K, eng.capacity)
    for k in range(K):
        rows = [int(r) for r in eng._slot[busy]]  # the docs' state rows
        stage.mark(k, eng._drain_into(busy, ops[k], pays[k], rows=rows))
        busy = [d for d in busy if d in eng._busy]
    kinds = ops[..., 0].copy()
    dev_ops, dev_pays = stage.upload(ops, pays)
    mins = torch.as_tensor([h.min_seq for h in eng.hosts], dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    return {"state": eng.state, "ops": dev_ops, "pays": dev_pays,
            "kinds": kinds, "K": K, "mins": mins, "n_docs": n_docs}


def phase_fleet_programs(seed: int, card: str, traffic, n_docs: int = 10_000,
                         geom: dict = FLEET_GEOM, hot_S: int = 16_384,
                         hot_T: int = 131_072, hot_rounds: int = 96,
                         cmp_docs: int = 256, ring: dict | None = None) -> dict:
    """K2 (``apply_megastep``), K3 (``set_min_seq`` + ``compact``) and K6
    (``apply_megastep_seg``, ``compact_seg``) timed alone on the card.

    K2 and K3 run at the fleet phase's geometry on the state and ring of
    its second megastep (``fleet_ring``; ``ring``, when given, is the one
    phase 20 built from the same traffic).  The card's K2 and K3 outputs
    on the first ``cmp_docs`` rows (the Zipf
    head among them) must equal the same programs run on CPU copies of
    those rows' state and ring.  K6 runs at the hot document's geometry
    on the state after half of its trace, with the next K x B chunk.  Each
    is printed beside its bytes bound (state read and written once, plus
    the ring)."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import _fleet_compact_body
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.parallel import mesh as pm

    if ring is None:
        ring = fleet_ring(traffic, n_docs, geom)
    state, dev_ops, dev_pays = ring["state"], ring["ops"], ring["pays"]
    kinds, K, mins = ring["kinds"], ring["K"], ring["mins"]
    del ring
    torch.cuda.synchronize()
    k2 = time_program(lambda: mk.apply_megastep(state, dev_ops, dev_pays, kinds=kinds), 2, 1)
    after = mk.apply_megastep(state, dev_ops, dev_pays, kinds=kinds)
    k3 = time_program(lambda: _fleet_compact_body(after, mins), 5)
    n = min(cmp_docs, n_docs)
    cpu_s = mk.tree_map(lambda x: x[:n].cpu(), state)
    want2 = mk.apply_megastep(cpu_s, dev_ops[:, :n].cpu(), dev_pays[:, :n].cpu(),
                              kinds=kinds[:, :n])
    err2 = leaf_max_err(mk.leaves(after), mk.leaves(want2), n)
    check(err2 == 0, f"K2 on the card differs from the CPU by {err2}")
    cpu_after = mk.tree_map(lambda x: x[:n].cpu(), after)
    err3 = leaf_max_err(mk.leaves(_fleet_compact_body(after, mins)),
                        mk.leaves(_fleet_compact_body(cpu_after, mins[:n].cpu())), n)
    check(err3 == 0, f"K3 on the card differs from the CPU by {err3}")
    k2_bytes, k2_bound = state_bound(mk.leaves(state), (dev_ops, dev_pays))
    k3_bytes, k3_bound = state_bound(mk.leaves(state), (mins,))
    del state, after, cpu_s, want2, cpu_after

    L, Kh, B = 8, 8, 16
    h_ops, h_pays, h_refs = four_writer_trace(seed, hot_rounds, L)
    chunks = len(h_ops) // (Kh * B)
    mesh = pm.docs_segs_mesh("cuda", seg_shards=1)
    proto = mk.init_state(hot_S, 4, 2, hot_T, 8, device="cuda")
    blocked = mk.seg_shard_state(proto, 1)
    seg_prog = pm.mesh_seg_program(mk.apply_megastep_seg, mesh, pm.seg_state_specs(blocked))
    seg_compact = pm.mesh_seg_program(mk.compact_seg, mesh)
    seg = pm.shard_seg_state(blocked, mesh)

    def chunk(c):
        rows = slice(c * Kh * B, (c + 1) * Kh * B)
        return (h_ops[rows].reshape(Kh, B, 8), h_pays[rows].reshape(Kh, B, L),
                int(h_refs[(c + 1) * Kh * B - 1]))

    for c in range(chunks // 2):
        o, p, ms = chunk(c)
        seg = seg_compact(seg_prog(seg, o, p), ms)
    o, p, ms = chunk(chunks // 2)
    o_t, p_t = torch.from_numpy(o).cuda(), torch.from_numpy(p).cuda()
    okinds = o[..., 0].copy()
    torch.cuda.synchronize()
    k6_mega = time_program(lambda: seg_prog(seg, o_t, p_t, kinds=okinds), 2, 1)
    seg_after = seg_prog(seg, o_t, p_t, kinds=okinds)
    k6_compact = time_program(lambda: seg_compact(seg_after, ms), 5)
    k6_bytes, k6_bound = state_bound(mk.leaves(seg), (o_t, p_t))
    k6c_bytes, k6c_bound = state_bound(mk.leaves(seg))
    out = {
        "phase": "fleet_programs", "card": card,
        "k2": {"shape": [K, n_docs, geom["ops_per_step"]], **k2,
               "bound_ms": k2_bound, "bound_bytes": k2_bytes, "bound_by": "bytes",
               "max_abs_err": err2, "compared_docs": n},
        "k3": {"docs": n_docs, **k3, "bound_ms": k3_bound, "bound_bytes": k3_bytes,
               "bound_by": "bytes", "max_abs_err": err3, "compared_docs": n},
        "k6_megastep": {"shape": [Kh, B], "S": hot_S, "T": hot_T, **k6_mega,
                        "bound_ms": k6_bound, "bound_bytes": k6_bytes, "bound_by": "bytes"},
        "k6_compact": {"S": hot_S, "T": hot_T, **k6_compact, "bound_ms": k6c_bound,
                       "bound_bytes": k6c_bytes, "bound_by": "bytes"},
    }
    emit(out)
    return out


# ----------------------------------------------------------- tree paths

# The tree fleet's geometry (``bench.py`` ``bench_config5`` at fleet width).
TREE_FLEET_GEOM = dict(capacity=2048, pool_capacity=16_384, ops_per_step=32, megastep_k=8)
TREE_DEEP_GEOM = dict(capacity=16_384, pool_capacity=65_536, ops_per_step=32, megastep_k=8)
TREE_CHURN_GEOM = dict(capacity=128, pool_capacity=1024, ops_per_step=32, megastep_k=8)
# The docs of the tree fleet's stream that ``tree_legacy_emit`` takes.
TREE_LEGACY_DOCS = 64


def tree_traffic(seed: int, n_docs: int, rounds: int, writers: int = 4,
                 ops_per_writer: int = 8, faulted=(), fault_edits: int = 0,
                 fault_leaves: int = 32, shared_leaves: int = 0, churn: bool = False):
    """SharedTree edit streams of ``bench.py``'s ``bench_config5`` shape as
    sequenced wire messages: per doc ``writers`` writer-owned subtrees
    (an ``obj`` node whose ``kids`` field starts as one leaf) plus one
    shared subtree, seeded by writer 0, then ``rounds`` rounds in which
    each writer submits ``ops_per_writer`` edits with its ref_seq at the
    round start (one round of lag).  Even edits insert into the shared
    ``kids`` at 0 (concurrent inserts that rebase against each other),
    odd ones set (half) or insert (half) in the writer's own subtree;
    leaves are 40% strings of 3-10 chars, else ints.

    - ``shared_leaves``: the shared subtree starts with that many leaves,
      and the whole seed is one commit;
    - ``churn``: each writer alternates an insert and a remove in its own
      subtree instead;
    - ``faulted`` docs: writer 0 adds ``fault_edits`` edits a round, each
      inserting ``fault_leaves`` int leaves into its own subtree.

    Returns ``rounds + 1`` lists of (doc, message): the seed round, then
    one per round."""
    from fluidframework_tpu_torch.dds.tree.changeset import (
        commit_to_json, make_insert, make_remove, make_set_value,
    )
    from fluidframework_tpu_torch.dds.tree.forest import Node
    from fluidframework_tpu_torch.dds.tree.schema import leaf
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    W = writers
    faulted = set(int(d) for d in faulted)

    def rand_leaf():
        if rng.random() < 0.4:
            n = int(rng.integers(3, 11))
            return leaf("".join(chr(97 + int(c)) for c in rng.integers(0, 26, n)))
        return leaf(int(rng.integers(1000)))

    def msg(seq, ref, w, rev, change):
        return SequencedMessage(
            client_id=f"w{w}", client_seq=rev, ref_seq=ref, seq=seq,
            min_seq=max(0, ref - 1), type=MessageType.OP,
            contents={"type": "edit", "sid": f"s{w}", "rev": rev,
                      "changes": commit_to_json([change])})

    out = [[] for _ in range(rounds + 1)]
    for d in range(n_docs):
        nodes = [Node(type="obj", fields={"kids": [leaf(0)]}) for _ in range(W)]
        nodes.append(Node(type="obj", fields={"kids": (
            [rand_leaf() for _ in range(shared_leaves)] if shared_leaves else [leaf(0)])}))
        if shared_leaves:
            seed_changes = [make_insert([], "", 0, nodes)]
        else:
            seed_changes = [make_insert([], "", i, [n]) for i, n in enumerate(nodes)]
        seq = 0
        for ch in seed_changes:
            seq += 1
            out[0].append((d, msg(seq, seq - 1, 0, seq, ch)))
        revs = [seq] * W
        sizes = [1] * W
        for r in range(1, rounds + 1):
            ref = seq
            for w in range(W):
                for k in range(ops_per_writer):
                    seq += 1
                    revs[w] += 1
                    if churn:
                        if k % 2 == 1 and sizes[w] > 0:
                            ch = make_remove([("", w)], "kids", int(rng.integers(sizes[w])), 1)
                            sizes[w] -= 1
                        else:
                            ch = make_insert([("", w)], "kids", int(rng.integers(sizes[w] + 1)),
                                             [rand_leaf()])
                            sizes[w] += 1
                    elif k % 2 == 0:
                        ch = make_insert([("", W)], "kids", 0, [rand_leaf()])
                    elif rng.random() < 0.5 and sizes[w] > 0:
                        ch = make_set_value([("", w), ("kids", int(rng.integers(sizes[w])))],
                                            rand_leaf().value)
                    else:
                        ch = make_insert([("", w)], "kids", int(rng.integers(sizes[w] + 1)),
                                         [rand_leaf()])
                        sizes[w] += 1
                    out[r].append((d, msg(seq, ref, w, revs[w], ch)))
                if w == 0 and d in faulted:
                    for _ in range(fault_edits):
                        seq += 1
                        revs[w] += 1
                        ch = make_insert([("", w)], "kids", 0, [
                            leaf(int(v)) for v in rng.integers(1000, size=fault_leaves)])
                        sizes[w] += fault_leaves
                        out[r].append((d, msg(seq, ref, w, revs[w], ch)))
    return out


def _drive_tree(eng, rounds_msgs, local=None, on_card: bool = False) -> dict:
    """Ingest each round's messages (those of the docs in ``local``,
    renumbered through it, when given) and step after each round."""
    import torch

    ingest_s = step_s = 0.0
    edits = slices = 0
    for msgs in rounds_msgs:
        t = time.perf_counter()
        for d, m in msgs:
            if local is None:
                eng.ingest(d, m)
            elif d in local:
                eng.ingest(local[d], m)
            else:
                continue
            edits += 1
        ingest_s += time.perf_counter() - t
        t = time.perf_counter()
        slices += eng.step()
        if on_card:
            torch.cuda.synchronize()
        step_s += time.perf_counter() - t
    return {"edits": edits, "ingest_s": ingest_s, "step_s": step_s, "slices": slices}


def _tree_views_equal(a, da: int, b, db: int) -> bool:
    """Two tree engines hold the same document: lane, ``tree_json`` and
    ``values`` and the EditManager summary, compared as JSON text (True
    and 1 differ; a restored summary holds lists where the live one holds
    tuples)."""
    return (
        (da in a.fallbacks) == (db in b.fallbacks)
        and json.dumps(a.tree_json(da)) == json.dumps(b.tree_json(db))
        and json.dumps(a.values(da)) == json.dumps(b.values(db))
        and json.dumps(a.hosts[da].em.summarize(), sort_keys=True)
        == json.dumps(b.hosts[db].em.summarize(), sort_keys=True)
    )


def _tree_docs_identical(a, da: int, b, db: int) -> bool:
    """``_tree_views_equal`` and every raw column of the two device rows."""
    import torch

    sa, sb = int(a._slot[da]), int(b._slot[db])  # the docs' state rows
    return _tree_views_equal(a, da, b, db) and all(
        torch.equal(x[sa].cpu(), y[sb].cpu()) for x, y in zip(a.state, b.state)
    )


def _tree_replay(geom, rounds_msgs, docs) -> tuple:
    """The listed docs' streams through a TreeBatchEngine on the CPU,
    stepped at the same rounds; returns (engine, doc -> local index)."""
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    local = {int(d): j for j, d in enumerate(docs)}
    ref = TreeBatchEngine(len(docs), device="cpu", **geom)
    t = time.perf_counter()
    _drive_tree(ref, rounds_msgs, local)
    return ref, local, time.perf_counter() - t


def _tree_run_line(name, card, eng, run, gen_s, on_card, compacts) -> dict:
    import torch

    h = eng.health()
    wall = run["ingest_s"] + run["step_s"]
    return {
        "phase": name, "card": card, "docs": eng.n_docs, "edits": run["edits"],
        "traffic_gen_s": gen_s, "ingest_s": run["ingest_s"], "step_s": run["step_s"],
        "edits_per_s": run["edits"] / wall,
        "host_translation_edits_per_s": run["edits"] / run["ingest_s"],
        "slices": run["slices"], "dispatches": h["megastep_dispatches"],
        "compacts": compacts, "fallback_docs": sorted(eng.fallbacks),
        "device_fraction": eng.device_fraction(),
        "translation_plan_hit_rate": h["translation_plan_hit_rate"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated() if on_card else None,
    }


def phase_tree_fleet(seed: int, card: str, device: str, n_docs: int = 1024,
                     rounds: int = 4, n_faulted: int = 4, sample: int = 64,
                     fault_edits: int = 24, geom: dict = TREE_FLEET_GEOM,
                     record: bool = False, trace_dir: str | None = None) -> tuple:
    """The SharedTree fleet: ``bench_config5``'s stream at ``n_docs`` docs
    through ``TreeBatchEngine.ingest``/``step`` (a step after every
    round), with ``n_faulted`` seeded docs whose writer 0 inserts
    ``fault_edits`` x 32 extra leaves a round until they pass
    ``capacity`` rows: they must latch on the device and route to the host
    fallback.  Then a CPU replay of a seeded sample plus the faulted docs
    (raw columns, views and summaries identical, same fallbacks), a forced
    checkpoint sweep restored into a fresh engine (every doc's views and
    summary equal), and one more round through both engines.  ``record``
    installs a flight recorder over the timed rounds (the host-fold phase
    shares in the line).  Returns the phase's line, the inputs of a K7 ring
    that the engine stages from a further round (``tree_fleet_ring``), for
    timing K7 and K8 alone, and the main rounds' messages, for
    ``tree_legacy_emit``."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.observability import uninstall
    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    on_card = device == "cuda"
    t0 = time.perf_counter()
    faulted, traffic = _tree_fleet_stream(seed, n_docs, rounds + 2, n_faulted, fault_edits)
    gen_s = time.perf_counter() - t0
    main_rounds, extra, ring_round = traffic[:rounds + 1], traffic[rounds + 1:rounds + 2], traffic[-1]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_tree_ckpt_")
    try:
        eng = TreeBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        k8_0 = tk.compact_nested.launches
        rec = install_recorder(1 << 20) if record else None
        try:
            run = _drive_tree(eng, main_rounds, on_card=on_card)
        finally:
            if rec is not None:
                uninstall()
        line = _tree_run_line("tree_fleet", card, eng, run, gen_s, on_card,
                              tk.compact_nested.launches - k8_0)
        if rec is not None:
            line["recorder"] = True
            line["trace"] = recorder_line(rec, trace_dir, "tree_fleet")
        check(not eng.errors().any(), "tree_fleet: error bits left after step()")
        check(sorted(eng.fallbacks) == faulted,
              f"tree_fleet: fallbacks {sorted(eng.fallbacks)}, expected the faulted docs {faulted}")
        others = [h for d, h in enumerate(eng.hosts) if d not in eng.fallbacks]
        check(all(h.device_commits == h.total_commits for h in others),
              "tree_fleet: a commit of a device doc did not apply on the device")
        total = sum(h.total_commits for h in eng.hosts)
        host_only = sum(eng.hosts[d].total_commits - eng.hosts[d].device_commits for d in faulted)
        check(eng.device_fraction() == (total - host_only) / total,
              "tree_fleet: device_fraction is not the faulted docs' post-routing commits")

        pick = np.random.default_rng(seed + 1).choice(
            [d for d in range(n_docs) if d not in faulted], size=min(sample, n_docs - n_faulted),
            replace=False)
        docs = sorted(int(d) for d in pick) + faulted
        ref, local, replay_s = _tree_replay(geom, main_rounds, docs)
        same = sum(_tree_docs_identical(eng, d, ref, local[d]) for d in docs)
        check(same == len(docs), f"tree_fleet: {len(docs) - same} of {len(docs)} docs differ from the CPU replay")
        check(sorted(ref.fallbacks) == sorted(local[d] for d in faulted),
              "tree_fleet: the CPU replay routed other docs")

        t = time.perf_counter()
        written = eng.maybe_checkpoint(force=True)
        sweep_s = time.perf_counter() - t
        ck_bytes = sum(os.path.getsize(os.path.join(root, f))
                       for root, _dirs, files in os.walk(ck_dir) for f in files)
        check(len(written) == n_docs, f"tree_fleet: checkpointed {len(written)} of {n_docs} docs")
        eng2 = TreeBatchEngine(n_docs, device=device, checkpoint_store=CheckpointStore(ck_dir), **geom)
        t = time.perf_counter()
        restored = eng2.restore_from_checkpoints()
        restore_s = time.perf_counter() - t
        t = time.perf_counter()
        eng2.step()
        if on_card:
            torch.cuda.synchronize()
        rematerialize_s = time.perf_counter() - t
        check(len(restored) == n_docs, f"tree_fleet: restored {len(restored)} of {n_docs} docs")
        with _host_views(eng, eng2):
            same = sum(_tree_views_equal(eng, d, eng2, d) for d in range(n_docs))
        check(same == n_docs, f"tree_fleet: {n_docs - same} restored docs differ")
        _drive_tree(eng, extra, on_card=on_card)
        _drive_tree(eng2, extra, on_card=on_card)
        with _host_views(eng, eng2):
            same = sum(_tree_views_equal(eng, d, eng2, d) for d in range(n_docs))
        check(same == n_docs, f"tree_fleet: {n_docs - same} docs differ after a round past the restore")
        check(not eng.errors().any() and not eng2.errors().any(),
              "tree_fleet: error bits after the round past the restore")
        ring = tree_fleet_ring(eng, ring_round)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    line.update({
        "rounds": rounds, "faulted": faulted, "replayed_docs": len(docs),
        "cpu_replay_s": replay_s, "checkpoint_s": sweep_s, "checkpoint_bytes": ck_bytes,
        "restore_s": restore_s, "rematerialize_s": rematerialize_s,
        "restored_identical": n_docs, "identical_after_extra_round": n_docs,
    })
    emit(line)
    return line, ring, main_rounds


def tree_legacy_emit(card: str, device: str, rounds_msgs) -> dict:
    """The per-row emit translation (``plan_cache=False``) against the plan
    cache: two fresh engines on ``device`` (``TREE_FLEET_GEOM``) take the
    messages of the first ``TREE_LEGACY_DOCS`` docs of ``rounds_msgs``
    (``phase_tree_fleet``'s main rounds), a step after every round, the
    two engines in turns that swap each round so that neither always goes
    first.  Every raw state
    column (padding remnants included), the error latch and the fallbacks
    must be equal, and only the plan-cache engine may count plan hits.
    Emits and returns the part's line: each engine's ingest and step
    times, and its ingest rate over the rounds it went first and over
    those it went second."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    on_card = device == "cuda"
    t0 = time.perf_counter()
    n_docs = min(TREE_LEGACY_DOCS, 1 + max(d for msgs in rounds_msgs for d, _m in msgs))
    local = {d: d for d in range(n_docs)}
    names = ("plan_cache", "legacy")
    engines = {name: TreeBatchEngine(n_docs, device=device, plan_cache=name == "plan_cache",
                                     **TREE_FLEET_GEOM) for name in names}
    zero = {"edits": 0, "ingest_s": 0.0, "step_s": 0.0}
    runs = {name: {turn: dict(zero) for turn in ("first", "second")} for name in names}
    for r, msgs in enumerate(rounds_msgs):
        for turn, name in zip(("first", "second"), names if r % 2 == 0 else names[::-1]):
            run = _drive_tree(engines[name], [msgs], local, on_card=on_card)
            for key in zero:
                runs[name][turn][key] += run[key]
    cached, legacy = engines["plan_cache"], engines["legacy"]
    for name in type(cached.state)._fields:
        a, b = getattr(cached.state, name), getattr(legacy.state, name)
        check(a.device.type == b.device.type == device and torch.equal(a, b),
              f"tree_legacy_emit: the legacy engine's {name} column differs from the plan cache's")
    check(cached.errors().tolist() == legacy.errors().tolist(),
          "tree_legacy_emit: the legacy engine's error latch differs from the plan cache's")
    check(sorted(cached.fallbacks) == sorted(legacy.fallbacks) and all(
        json.dumps(cached.tree_json(d)) == json.dumps(legacy.tree_json(d))
        for d in cached.fallbacks), "tree_legacy_emit: the legacy engine's fallbacks differ")
    hits = cached.health().get("translation_plan_hits", 0)
    legacy_hits = legacy.health().get("translation_plan_hits", 0)
    check(hits > 0, "tree_legacy_emit: the plan-cache engine counted no plan hit")
    check(legacy_hits == 0, f"tree_legacy_emit: the legacy engine counted {legacy_hits} plan hits")
    out = {"phase": "tree_legacy_emit", "card": card, "docs": n_docs,
           "rounds": len(rounds_msgs), "fallback_docs": sorted(legacy.fallbacks), "plan_hits": hits}
    for name, turns in runs.items():
        edits = sum(t["edits"] for t in turns.values())
        ingest_s = sum(t["ingest_s"] for t in turns.values())
        out[name] = {"edits": edits, "host_translation_edits_per_s": edits / ingest_s,
                     "ingest_s": ingest_s, "step_s": sum(t["step_s"] for t in turns.values())}
        for turn, t in turns.items():
            out[name][f"edits_per_s_{turn}"] = t["edits"] / t["ingest_s"]
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


def tree_fleet_ring(eng, msgs) -> tuple:
    """K7's inputs as the engine's next step would see them: ``msgs``
    ingested, then one ring staged from the queues as ``_step_fleet``
    stages it (the engine's own ``_select_k``, ``_staging`` and
    ``_drain_into``).  Returns (state, ops, payloads, host ops)."""
    for d, m in msgs:
        eng.ingest(d, m)
    busy = sorted(eng._busy)
    K = eng._select_k(busy)
    stage = eng._staging()
    ops, pays = stage.acquire(K, eng.fleet_capacity)
    for k in range(K):
        stage.mark(k, eng._drain_into(busy, ops[k], pays[k]))
        busy = [d for d in busy if d in eng._busy]
    host_ops = ops[..., :3].copy()
    dev_ops, dev_pays = stage.upload(ops, pays)
    return eng.state, dev_ops, dev_pays, host_ops


def tree_deep_traffic(seed: int, writers: int = 32, rounds: int = 4, leaves: int = 10_000):
    """tree_deep's stream (``tree_traffic`` of one doc seeded by one commit
    with a shared subtree of ``leaves`` leaves)."""
    return tree_traffic(seed + 5, 1, rounds, writers=writers, shared_leaves=leaves)


def phase_tree_deep(seed: int, card: str, device: str, writers: int = 32, rounds: int = 4,
                    leaves: int = 10_000, geom: dict = TREE_DEEP_GEOM) -> tuple:
    """``BASELINE.json`` config 5's shape: one document seeded by one commit
    of ``writers`` writer subtrees and a shared subtree of ``leaves``
    mixed-type leaves, then ``writers`` x 8 edits a round for ``rounds``
    rounds; the whole doc stays on the device and equals a CPU replay.
    Returns the phase's line and its engine (the pooled fold's result that
    the ``tree_rebase`` path holds its device window against)."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    on_card = device == "cuda"
    t0 = time.perf_counter()
    traffic = tree_deep_traffic(seed, writers, rounds, leaves)
    gen_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = TreeBatchEngine(1, device=device, **geom)
    k8_0 = tk.compact_nested.launches
    run = _drive_tree(eng, traffic, on_card=on_card)
    line = _tree_run_line("tree_deep", card, eng, run, gen_s, on_card,
                          tk.compact_nested.launches - k8_0)
    check(not eng.errors().any(), "tree_deep: error bits left after step()")
    check(not eng.fallbacks and eng.device_fraction() == 1.0,
          f"tree_deep: device_fraction {eng.device_fraction()}, fallbacks {sorted(eng.fallbacks)}")
    ref, local, replay_s = _tree_replay(geom, traffic, [0])
    check(_tree_docs_identical(eng, 0, ref, 0), "tree_deep: the doc differs from its CPU replay")
    line.update({"writers": writers, "rounds": rounds, "seed_leaves": leaves,
                 "nodes": int(eng.state.alive.sum()), "cpu_replay_s": replay_s})
    emit(line)
    return line, eng


def phase_tree_churn(seed: int, card: str, device: str, n_docs: int = 256, rounds: int = 8,
                     sample: int = 64, geom: dict = TREE_CHURN_GEOM) -> tuple:
    """Insert/remove churn: each writer alternates an insert and a remove
    in its own subtree, so the host's row bound passes 75% of ``capacity``
    while live rows stay low; K8 (``compact_nested``) must run, and a
    seeded sample equals its CPU replay.  Returns the line and (the engine,
    its traffic as per-round, per-doc JSON-lines chunks): the wire_ingest
    path holds ``ingest_lines`` against it."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    on_card = device == "cuda"
    t0 = time.perf_counter()
    traffic = tree_traffic(seed + 9, n_docs, rounds, churn=True)
    gen_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eng = TreeBatchEngine(n_docs, device=device, **geom)
    k8_0 = tk.compact_nested.launches
    run = _drive_tree(eng, traffic, on_card=on_card)
    k8 = tk.compact_nested.launches - k8_0
    line = _tree_run_line("tree_churn", card, eng, run, gen_s, on_card, k8)
    check(not eng.errors().any() and not eng.fallbacks,
          f"tree_churn: error bits or fallbacks {sorted(eng.fallbacks)}")
    if on_card:
        check(k8 > 0, "tree_churn: compact_nested never launched")
    docs = sorted(int(d) for d in np.random.default_rng(seed + 2).choice(
        n_docs, size=min(sample, n_docs), replace=False))
    ref, local, replay_s = _tree_replay(geom, traffic, docs)
    same = sum(_tree_docs_identical(eng, d, ref, local[d]) for d in docs)
    check(same == len(docs), f"tree_churn: {len(docs) - same} of {len(docs)} docs differ from the CPU replay")
    line.update({"rounds": rounds, "live_rows_max": int(eng.state.alive.sum(-1).max()),
                 "replayed_docs": len(docs), "cpu_replay_s": replay_s})
    emit(line)
    # The wire_ingest path takes the stream as JSON-lines chunks (bytes,
    # which the garbage collector does not track), so the messages die here.
    return line, (eng, [_doc_blobs(n_docs, msgs) for msgs in traffic])


def wire_traffic(n_docs: int, rounds: int, writers: int, seed: int) -> tuple:
    """``bench.py``'s ``_string_ingest_rate`` stream: every round each of
    ``writers`` writers inserts "abcd" at a random position of every doc,
    valid at the round start (ref_seq and MSN at the round start).
    Returns the joins and the ops as (doc, message) lists."""
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    joins = [
        (d, SequencedMessage(
            seq=0, min_seq=0, ref_seq=0, client_id=f"w{w}", client_seq=0,
            type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w}))
        for d in range(n_docs) for w in range(writers)
    ]
    lengths = np.zeros((n_docs,), np.int64)
    seqs = np.zeros((n_docs,), np.int64)
    ops = []
    for r in range(rounds):
        refs = seqs.copy()
        for w in range(writers):
            for d in range(n_docs):
                pos = int(rng.integers(0, lengths[d] + 1))
                seqs[d] += 1
                ops.append((d, SequencedMessage(
                    seq=int(seqs[d]), min_seq=int(refs[d]), ref_seq=int(refs[d]),
                    client_id=f"w{w}", client_seq=r, type=MessageType.OP,
                    contents={"type": 0, "pos1": pos, "seg": "abcd"})))
        lengths += 4 * writers
    return joins, ops


def _doc_blobs(n_docs: int, msgs) -> list[bytes]:
    """Each doc's messages as one JSON-lines chunk, in stream order."""
    parts = [[] for _ in range(n_docs)]
    for d, m in msgs:
        parts[d].append(m.wire_line())
    return [b"".join(p) for p in parts]


def phase_wire_ingest(seed: int, card: str, device: str, churn, n_docs: int = 128,
                      rounds: int = 16, writers: int = 4, geom: dict = FLEET_GEOM) -> dict:
    """The wire-ingest paths.  ``bench.py``'s config-3 ingest probe stream
    (``_string_ingest_rate(128, rounds=16, writers=4)``) at config-3
    geometry goes into four engines: JSON lines through ``ingest_lines``
    (the C++ encoder), messages through one ``ingest_batch`` call and
    through per-message ``ingest`` on ``device``, and per-message on the
    CPU; after ``step`` every doc's raw state columns and error latch are
    identical across the four, the native library is loaded and every doc
    of the first engine is in native mode.  Then tree_churn's stream
    (``churn``: that path's engine, fed through ``ingest``, and its
    traffic as JSON-lines chunks) goes through a tree engine's ``ingest_lines`` with
    ``native_wire=True``, round by round: every doc identical to the churn
    engine's (raw columns, tree JSON, values, summary), with native tree
    batches and no native decode error."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.native import ingest_native

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    joins, ops = wire_traffic(n_docs, rounds, writers, seed + 21)
    blobs = _doc_blobs(n_docs, joins + ops)
    gen_s = time.perf_counter() - t0
    geom = dict(geom, recovery="off")
    out = {"phase": "wire_ingest", "card": card, "docs": n_docs, "rounds": rounds,
           "writers": writers, "ops": len(ops), "wire_bytes": sum(map(len, blobs)),
           "traffic_gen_s": gen_s}

    engines = {}
    nat = engines["native"] = DocBatchEngine(n_docs, device=device, **geom)
    check(ingest_native.loaded(), "wire_ingest: the native ingest library is not loaded")
    t = time.perf_counter()
    for d in range(n_docs):
        nat.ingest_lines(d, blobs[d])
    out["native_ingest_s"] = time.perf_counter() - t
    modes = sorted({h.mode for h in nat.hosts})
    check(modes == ["native"], f"wire_ingest: ingest_lines left docs in modes {modes}")
    for name, dev in (("batch", device), ("message", device), ("cpu", "cpu")):
        eng = engines[name] = DocBatchEngine(n_docs, device=dev, **geom)
        for d, m in joins:
            eng.ingest(d, m)
        t = time.perf_counter()
        if name == "batch":
            eng.ingest_batch([d for d, _ in ops], [m for _, m in ops])
        else:
            for d, m in ops:
                eng.ingest(d, m)
        out[f"{name}_ingest_s"] = time.perf_counter() - t
    for name in ("native", "batch", "message"):
        out[f"{name}_ingest_ops_per_s"] = len(ops) / out[f"{name}_ingest_s"]
    for name, eng in engines.items():
        t = time.perf_counter()
        eng.step()
        sync()
        out[f"{name}_step_s"] = time.perf_counter() - t
    cpu = engines["cpu"]
    for name, eng in engines.items():
        check(np.array_equal(eng.errors(), cpu.errors()),
              f"wire_ingest: the {name} engine's error latches differ from the CPU run")
        same = sum(_state_rows_equal(eng.doc_state(d), cpu.doc_state(d)) for d in range(n_docs))
        check(same == n_docs, f"wire_ingest: {n_docs - same} docs of the {name} engine "
                              "differ from the CPU run")
    check(not cpu.errors().any(), "wire_ingest: error bits latched")
    out["identical_docs"] = n_docs
    del engines, nat, cpu

    churn_eng, round_blobs = churn
    tn = churn_eng.n_docs
    tnat = TreeBatchEngine(tn, device=device, native_wire=True, **TREE_CHURN_GEOM)
    ingest_s = step_s = 0.0
    for blobs_r in round_blobs:
        t = time.perf_counter()
        for d, blob in enumerate(blobs_r):
            if blob:
                tnat.ingest_lines(d, blob)
        ingest_s += time.perf_counter() - t
        t = time.perf_counter()
        tnat.step()
        sync()
        step_s += time.perf_counter() - t
    h = tnat.health()
    check(h.get("tree_native_batches", 0) > 0, "wire_ingest: no native tree batch")
    check(h.get("tree_native_decode_errors", 0) == 0,
          f"wire_ingest: {h.get('tree_native_decode_errors')} native tree decode errors")
    check(not tnat.errors().any() and sorted(tnat.fallbacks) == sorted(churn_eng.fallbacks),
          "wire_ingest: tree error bits or fallbacks differ from tree_churn's")
    same = sum(_tree_docs_identical(tnat, d, churn_eng, d) for d in range(tn))
    check(same == tn, f"wire_ingest: {tn - same} of {tn} tree docs differ between "
                      "ingest_lines and ingest")
    edits = sum(blob.count(b"\n") for blobs_r in round_blobs for blob in blobs_r)
    out["tree"] = {"docs": tn, "edits": edits, "native_batches": h["tree_native_batches"],
                   "ingest_lines_s": ingest_s, "step_s": step_s,
                   "ingest_lines_edits_per_s": edits / ingest_s, "identical_docs": same}
    emit(out)
    return out


def time_tree_programs(card: str, ring, cmp_docs: int = 64,
                       shares=(1 / 16, 1 / 4, 1 / 2, 1)) -> dict:
    """K7 on the tree fleet's staged ring and K8 on its state, timed alone
    and held against the same call on the CPU for the first ``cmp_docs``
    docs (exact), beside their bytes bounds.

    Then K7's routes on that ring: for each share f, the ops of all docs
    but the first f x D become NOOP rows, and the ring runs with every
    kind on the masked route (``SUBSET_FRACTION`` past D) and on the
    gathered route (``SUBSET_FRACTION`` 0), in turns masked, gathered,
    gathered, masked."""
    import torch

    from fluidframework_tpu_torch.ops import tree_kernel as tk

    s, ops, pays, host_ops = ring
    D = s.parent.shape[0]
    n = min(cmp_docs, D)

    def k7(o=ops, h=host_ops):
        return tk.apply_nested_megastep(s, o, pays, host_ops=h)

    def max_err(got, want):
        return max(int((g[:n].cpu().long() - w.long()).abs().max()) for g, w in zip(got, want))

    cpu_s = tk.tree_map(lambda x: x[:n].cpu(), s)
    want = tk.apply_nested_megastep(cpu_s, ops[:, :n].cpu(), pays[:, :n].cpu(),
                                    host_ops=host_ops[:, :n])
    err7 = max_err(k7(), want)
    check(err7 == 0, f"K7 on the card differs from the CPU by {err7}")
    nbytes, bound = state_bound(list(s), (ops, pays))
    out = {"phase": "tree_programs", "card": card}
    out["k7"] = {"shape": list(ops.shape[:3]), **time_program(k7, 3),
                 "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                 "max_abs_err": err7, "compared_docs": n}
    err8 = max_err(tk.compact_nested(s), tk.compact_nested(cpu_s))
    check(err8 == 0, f"K8 on the card differs from the CPU by {err8}")
    nbytes, bound = state_bound(list(s))
    out["k8"] = {"docs": D, **time_program(lambda: tk.compact_nested(s), 5),
                 "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                 "max_abs_err": err8, "compared_docs": n}

    split = tk.SUBSET_FRACTION
    routes = {}
    try:
        for f in shares:
            keep = max(1, round(f * D))
            o, h = ops.clone(), host_ops.copy()
            o[:, keep:] = 0
            h[:, keep:] = 0
            turns = {"masked": [], "gathered": []}
            for route in ("masked", "gathered", "gathered", "masked"):
                tk.SUBSET_FRACTION = 2 * D if route == "masked" else 0
                turns[route].append(time_program(lambda: k7(o, h), 3, 1))
            routes[f"{keep}/{D}"] = turns
    finally:
        tk.SUBSET_FRACTION = split
    out["k7_routes"] = routes
    emit(out)
    return out


# ------------------------------------------------------- K9 and tree_rebase

def rebase_microbench_windows(seed: int, n_windows: int, window: int = 8) -> tuple:
    """``bench.py``'s ``_rebase_kernel_microbench`` windows: each folds one
    multi-insert commit ([Skip, Insert, ...]: 4 one-leaf inserts at
    distinct positions of 32, in one field) through ``window`` such commits.
    Returns (pool, [(c, xs)])."""
    from fluidframework_tpu_torch.dds.tree import mark_pool as mp
    from fluidframework_tpu_torch.dds.tree.changeset import Commit, Insert, NodeChange, Skip, _wrap
    from fluidframework_tpu_torch.dds.tree.schema import leaf

    rng = np.random.default_rng(seed)
    pool = mp.MarkPool()

    def multi_insert():
        marks, cur = [], 0
        for p in sorted(int(p) for p in rng.choice(32, size=4, replace=False)):
            if p > cur:
                marks.append(Skip(p - cur))
                cur = p
            marks.append(Insert([leaf(int(rng.integers(1000)))]))
        return mp.pool_commit(pool, Commit([_wrap([("", 0)], NodeChange(fields={"kids": marks}))]))

    return pool, [(multi_insert(), [multi_insert() for _ in range(window)])
                  for _ in range(n_windows)]


def tree_deep_window(seed: int, window: int = 256) -> tuple:
    """One window of tree_deep's shape: the 257th edit of its stream folded
    through the 256 edits before it (32 writers' inserts into the shared
    subtree, sets and inserts in their own).  Returns (pool, [(c, xs)])."""
    from fluidframework_tpu_torch.dds.tree import mark_pool as mp

    pool = mp.MarkPool()
    traffic = tree_deep_traffic(seed, rounds=2)
    commits = [mp.pool_commit_from_json(pool, m.contents["changes"])
               for msgs in traffic[1:] for _d, m in msgs]
    return pool, [(commits[window], commits[:window])]


def _fold_json(c, xs) -> str:
    from fluidframework_tpu_torch.dds.tree.changeset import commit_to_json

    return json.dumps([commit_to_json(c)] + [commit_to_json(x) for x in xs])


def time_serving_folds(reb, windows, encs, host, host_ms: float) -> dict:
    """The serving form of K9, one window per ``DeviceRebaser.fold`` (pack,
    one copy up, one launch, one copy down, decode), over ``windows``,
    held against the pooled fold's results ``host`` (``host_ms`` in all).
    The fold's cost is split by timing its parts alone on the same
    windows: ``_dispatch`` (pack and the device round trip), and the
    launch alone on one window's rows already on the card, synchronized
    after each call."""
    import torch

    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    W, C = len(windows), len(windows[0][1])
    cap = 1 << (C - 1).bit_length()
    gc.collect()
    t = time.perf_counter()
    folds = [reb.fold(c, xs) for c, xs in windows]
    torch.cuda.synchronize()
    fold_s = time.perf_counter() - t
    same = sum(_fold_json(fc, fx) == _fold_json(hc, hx)
               for (fc, fx, _st), (hc, hx) in zip(folds, host))
    check(same == W, f"K9 serving folds: {W - same} of {W} differ from the pooled fold")
    check(reb.stats()["rebase_fallbacks"] == 0, "K9 serving folds fell back")
    t = time.perf_counter()
    for enc_c, xe in encs:
        reb._dispatch(enc_c, xe, cap)
    dispatch_s = time.perf_counter() - t
    enc_c, xe = encs[0]
    dev = reb.device
    c1 = torch.from_numpy(enc_c.row[None]).to(dev)
    x1 = torch.from_numpy(np.stack([x.row for x in xe])[None]).to(dev)
    e1 = torch.ones((1, C), dtype=torch.uint8, device=dev)
    for _ in range(3):
        rk9.rebase_window(c1, x1, e1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(W):
        rk9.rebase_window(c1, x1, e1)
        torch.cuda.synchronize()
    launch_s = time.perf_counter() - t
    return {"windows": W, "C": C, "fold_us_per_window": fold_s / W * 1e6,
            "dispatch_us_per_window": dispatch_s / W * 1e6,
            "launch_sync_us_per_window": launch_s / W * 1e6,
            "one_window_device_ms": _device_sum(
                device_ms_by_name(lambda: rk9.rebase_window(c1, x1, e1), 20), "rebase_window"),
            "pooled_fold_us_per_window": host_ms / W * 1e3, "identical": same}


def phase_rebase_kernel(seed: int, card: str) -> dict:
    """K9 (``rebase_window``) against its plain version on the same card
    tensors (and on the CPU), exact on every output of every step, at four
    shapes: ``bench.py``'s microbench windows at W=256 and W=4,096 (C=8),
    one tree_deep window (W=1, C=256) and the serving shape tree_rebase
    launches (W=1, C=16: a fold of 9-16 entries pads to 16).  For each:
    call and device time, device us per step of the window's chain (the W
    windows run side by side), the plain version's time, the host pooled
    fold (``mark_pool.rebase_pair``) over the same windows, and the bytes
    bound (packed inputs read once, outputs written once; the window itself
    is a serial chain of C steps).  Then the serving form, one window per
    fold (``DeviceRebaser.fold``: one copy up, one launch, one copy down,
    the decode), against the pooled fold on the W=256 windows, identical."""
    import torch

    from fluidframework_tpu_torch.dds.tree import mark_pool as mp
    from fluidframework_tpu_torch.dds.tree.device_rebase import DeviceRebaser
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9

    dev = torch.device("cuda")
    out = {"phase": "rebase_kernel", "card": card}
    shapes = (("microbench_256", lambda: rebase_microbench_windows(seed, 256), 50, 5),
              ("microbench_4096", lambda: rebase_microbench_windows(seed + 1, 4096), 20, 3),
              ("tree_deep_window", lambda: tree_deep_window(seed), 20, 1),
              ("serving_16", lambda: rebase_microbench_windows(seed + 2, 1, window=16), 50, 3))
    serving = None
    for name, make, iters, plain_iters in shapes:
        pool, windows = make()
        reb = DeviceRebaser(pool, device=dev)
        encs = [(reb.encode_commit(c), [reb.encode_commit(x) for x in xs]) for c, xs in windows]
        check(all(e is not None and all(x is not None for x in xe) for e, xe in encs),
              f"K9 {name}: a window commit is not device-encodable")
        W, C = len(windows), len(windows[0][1])
        c_rows = torch.from_numpy(np.stack([e.row for e, _ in encs]))
        xs_rows = torch.from_numpy(np.stack([np.stack([x.row for x in xe]) for _, xe in encs]))
        elig = torch.ones((W, C), dtype=torch.uint8)
        cd, xd, ed = c_rows.to(dev), xs_rows.to(dev), elig.to(dev)
        got = rk9.rebase_window(cd, xd, ed)
        want = rk9.rebase_window_plain(cd, xd, ed)
        want_cpu = rk9.rebase_window_plain(c_rows, xs_rows, elig)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        check(all(torch.equal(g.cpu(), w.cpu()) and torch.equal(g.cpu(), wc)
                  for g, w, wc in zip(got, want, want_cpu)),
              f"K9 disagrees with its plain version at {name} (W={W}, C={C})")
        gc.collect()  # a collection inside the timed fold would be the previous shape's
        t = time.perf_counter()
        host = []
        for c, xs in windows:
            new_xs = []
            for x in xs:
                c, xw = mp.rebase_pair(c, x)
                new_xs.append(xw)
            host.append((c, new_xs))
        host_ms = (time.perf_counter() - t) * 1e3

        def kernel():
            return rk9.rebase_window(cd, xd, ed)

        by_name = device_ms_by_name(kernel, iters)
        nbytes = nbytes_of([cd, xd, ed, *got])
        device_ms = _device_sum(by_name, "rebase_window")
        out[name] = {
            "W": W, "C": C, "valid_steps": int(got[1][..., 0].sum()), "max_abs_err": err,
            "ms": cuda_ms(kernel, iters, warmup=2),
            "device_ms": device_ms,
            "us_per_step": device_ms * 1e3 / C if device_ms is not None else None,
            "call_device_ms": _device_sum(by_name),
            "plain_ms": cuda_ms(lambda: rk9.rebase_window_plain(cd, xd, ed), plain_iters, warmup=1),
            "host_fold_ms": host_ms,
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_bytes": nbytes, "bound_by": "bytes",
            "library_ms": None,
        }
        if name == "microbench_256":
            serving = time_serving_folds(reb, windows, encs, host, host_ms)
        del pool, windows, reb, encs, host, got, want, want_cpu
    out["serving"] = serving
    out["note"] = ("a window is a serial chain of C dependent steps; the bytes bound "
                   "ignores that chain")
    emit(out)
    return out


def phase_tree_rebase(seed: int, card: str, device: str, deep, fleet_docs: int = 256,
                      rounds: int = 4, deep_geom: dict = TREE_DEEP_GEOM,
                      deep_shape: dict | None = None, trace_dir: str | None = None) -> dict:
    """BASELINE config 5 through ``TreeBatchEngine`` with the device rebase
    window (K9) on and off, on the same streams: tree_deep's (one doc, a
    10,000-leaf seed commit, 32 writers x 8 edits x 4 rounds; ``deep`` is
    the tree_deep path's engine, the pooled fold) and the tree fleet's cut
    to ``fleet_docs`` docs (its writers and edits kept), in turns on, off,
    off, on.  Every doc's ``em.summarize()`` and ``tree_json`` must be
    byte-identical between the settings; ingest s, edits/s and the
    rebaser's gauges per run.  The fleet's last turn (on) runs with a
    flight recorder (the rebase window's spans), against the first (on)
    without.  ``deep_geom`` and ``deep_shape`` (the
    ``tree_deep_traffic`` arguments) must be those of ``deep``'s run."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.observability import uninstall

    on_card = device == "cuda"
    deep_shape = deep_shape or {}

    def views(eng, d):
        return (json.dumps(eng.hosts[d].em.summarize(), sort_keys=True),
                json.dumps(eng.tree_json(d), sort_keys=True))

    def run(n_docs, geom, traffic, device_rebase, record=False):
        eng = TreeBatchEngine(n_docs, device=device, device_rebase=device_rebase, **geom)
        rec = install_recorder(1 << 19) if record else None
        try:
            r = _drive_tree(eng, traffic, on_card=on_card)
        finally:
            if rec is not None:
                uninstall()
        h = eng.health()
        line = {"device_rebase": device_rebase, "recorder": record,
                "edits": r["edits"], "ingest_s": r["ingest_s"],
                "step_s": r["step_s"], "edits_per_s": r["edits"] / (r["ingest_s"] + r["step_s"]),
                "host_translation_edits_per_s": r["edits"] / r["ingest_s"]}
        for k in ("device_rebase_fraction", "rebase_fallbacks", "rebase_windows",
                  "device_rebase_steps", "rebase_encode_rejects"):
            line[k] = h.get(k)
        if rec is not None:
            line["trace"] = recorder_line(
                rec, trace_dir, f"tree_rebase_{'on' if device_rebase else 'off'}")
        check(not eng.errors().any(), "tree_rebase: error bits left after step()")
        return eng, line

    out = {"phase": "tree_rebase", "card": card}
    deep_eng, deep_on = run(1, deep_geom, tree_deep_traffic(seed, **deep_shape), True)
    check(views(deep_eng, 0) == views(deep, 0),
          "tree_rebase: tree_deep's summary or tree JSON differs between device_rebase on and off")
    check(deep_on["device_rebase_fraction"] > 0, "tree_rebase: tree_deep resolved no step on K9")
    out["tree_deep"] = {"on": deep_on, "identical_docs": 1}
    del deep_eng

    traffic = tree_traffic(seed + 13, fleet_docs, rounds)
    turns, first = [], {}
    for i, setting in enumerate((True, False, False, True)):
        eng, line = run(fleet_docs, TREE_FLEET_GEOM, traffic, setting, record=i == 3)
        turns.append(line)
        first.setdefault(setting, eng)
        del eng
    same = sum(views(first[True], d) == views(first[False], d) for d in range(fleet_docs))
    check(same == fleet_docs,
          f"tree_rebase: {fleet_docs - same} of {fleet_docs} fleet docs differ between settings")
    check(all(t["device_rebase_fraction"] > 0 for t in turns if t["device_rebase"]),
          "tree_rebase: the fleet resolved no step on K9")
    out["tree_fleet"] = {"docs": fleet_docs, "rounds": rounds, "turns": turns,
                         "identical_docs": same}
    if on_card:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


# ------------------------------------------------------------ map and matrix

def map_ops(rng, shape, K: int) -> tuple:
    """SET/DELETE ops over ``shape`` (maps x ops) with keys in [0, K)."""
    kinds = rng.integers(1, 3, size=shape).astype(np.int32)
    keys = rng.integers(0, K, size=shape).astype(np.int32)
    vals = rng.integers(0, 1 << 20, size=shape).astype(np.int32)
    return kinds, keys, vals


def phase_map_lww(seed: int, card: str, device: str, K: int = 256, B: int = 256,
                  batches: int = 64, n_maps: int = 10_000, fleet_batches: int = 16) -> dict:
    """BASELINE config 2: one SharedMap of K=256 key slots fed ``batches``
    batches of B=256 SET/DELETE ops, plus a CLEAR sequenced halfway,
    through ``apply_batch``; then a fleet of ``n_maps`` maps through
    ``apply_batch_fleet``, ``fleet_batches`` batches of B ops a map.  Both
    end states, and ``host_items`` of sampled maps,
    must equal a CPU run's exactly.  Ops/s (host upload included), and the
    fleet program's call and device time beside its bytes bound."""
    import torch

    from fluidframework_tpu_torch.ops import map_kernel as mpk

    on_card = device == "cuda"
    rng = np.random.default_rng(seed + 21)
    seq = 0
    one = []
    for i in range(batches):
        if i == batches // 2:  # the CLEAR, sequenced between two batches
            seq += 1
            one.append(tuple(np.asarray([v], np.int32) for v in (mpk.MapOpKind.CLEAR, -1, 0, seq)))
        kinds, keys, vals = map_ops(rng, (B,), K)
        one.append((kinds, keys, vals, np.arange(seq + 1, seq + B + 1, dtype=np.int32)))
        seq += B
    state = mpk.init_state(K, device=device)
    t = time.perf_counter()
    for batch in one:
        state = mpk.apply_batch(state, *batch)
    if on_card:
        torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    cpu = mpk.init_state(K, device="cpu")
    for batch in one:
        cpu = mpk.apply_batch(cpu, *batch)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(state, cpu)),
          "map_lww: the single map differs from its CPU run")
    check(mpk.host_items(state) == mpk.host_items(cpu), "map_lww: host_items differ")

    fleet = mpk.batch_state(mpk.init_state(K, device=device), n_maps)
    fleet_cpu = mpk.batch_state(mpk.init_state(K, device="cpu"), n_maps)
    fleet_s = 0.0
    last = None
    for i in range(fleet_batches):
        kinds, keys, vals = map_ops(rng, (n_maps, B), K)
        seqs = (seq + 1 + np.arange(n_maps * B, dtype=np.int64).reshape(n_maps, B)).astype(np.int32)
        seq += n_maps * B
        batch = tuple(torch.from_numpy(a) for a in (kinds, keys, vals, seqs))
        t = time.perf_counter()
        fleet = mpk.apply_batch_fleet(fleet, *batch)
        if on_card:
            torch.cuda.synchronize()
        fleet_s += time.perf_counter() - t
        fleet_cpu = mpk.apply_batch_fleet(fleet_cpu, *batch)
        last = batch
    check(all(torch.equal(a.cpu(), b) for a, b in zip(fleet, fleet_cpu)),
          "map_lww: the map fleet differs from its CPU run")
    sample = np.random.default_rng(seed + 3).choice(n_maps, size=min(64, n_maps), replace=False)
    for d in sample.tolist():
        check(mpk.host_items(mpk.MapState(*(x[d] for x in fleet)))
              == mpk.host_items(mpk.MapState(*(x[d] for x in fleet_cpu))),
              f"map_lww: host_items of map {d} differ")
    out = {"phase": "map_lww", "card": card, "K": K, "B": B, "batches": batches,
           "ops_per_s": (batches * B + 1) / one_s, "live_keys": len(mpk.host_items(state)),
           "fleet_maps": n_maps, "fleet_batches": fleet_batches,
           "fleet_ops_per_s": fleet_batches * n_maps * B / fleet_s,
           "fleet_state_bytes": nbytes_of(fleet)}
    if on_card:
        dev_batch = tuple(x.to(device) for x in last)
        nbytes, bound = state_bound(list(fleet), dev_batch)
        out["fleet_program"] = {"shape": [n_maps, K, B],
                                **time_program(lambda: mpk.apply_batch_fleet(fleet, *dev_batch), 10,
                                               uncounted=mpk.apply_batch_fleet),
                                "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                                "max_abs_err": 0}
    emit(out)
    return out


MATRIX_GEOM = dict(max_rows=256, max_cols=256, max_segments=128)


def matrix_traffic(seed: int, steps: int = 16, B: int = 64, writers: int = 64,
                   seeded: int = 128) -> list:
    """BASELINE config 4's traffic: writer 0 seeds ``seeded`` rows and
    columns, then ``steps`` steps of ``B`` SET_CELL ops from ``writers``
    writers at the step's ref_seq (about one in ten with the FWW flag),
    with two of writer 0's row or column inserts and removes interleaved
    in each step.  Returns the seed ops and one [B + 2, 8] array a step."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk

    K = mxk.MatrixOpKind
    rng = np.random.default_rng(seed + 31)
    seed_ops = np.asarray([[K.INSERT_ROWS, 1, 0, 0, 0, seeded, 0, 0],
                           [K.INSERT_COLS, 2, 0, 1, 0, seeded, 0, 0]], np.int32)
    rows = cols = seeded
    seq = 2
    out = []
    for s in range(steps):
        ref, n_rows, n_cols = seq, rows, cols
        ops = np.zeros((B + 2, mxk.MATRIX_OP_FIELDS), np.int32)
        for b in range(B + 2):
            seq += 1
            if b in (0, B // 2):
                axis_rows = (s + b) % 2 == 0
                n = rows if axis_rows else cols
                insert = (s // 2 + b) % 2 == 0
                kind = (K.INSERT_ROWS if axis_rows else K.INSERT_COLS) if insert else \
                    (K.REMOVE_ROWS if axis_rows else K.REMOVE_COLS)
                pos = int(rng.integers(0, n + 1 if insert else n))
                ops[b] = [kind, seq, 0, seq - 1, pos, 1, 0, 0]
                delta = 1 if insert else -1
                if axis_rows:
                    rows += delta
                else:
                    cols += delta
            else:
                ops[b] = [K.SET_CELL, seq, b % writers, ref, int(rng.integers(0, n_rows)),
                          int(rng.integers(0, n_cols)), int(rng.integers(0, 1 << 20)),
                          int(rng.random() < 0.1)]
        out.append(ops)
    return [seed_ops] + out


def mk_leaves(state) -> list:
    """Every tensor of a matrix state, both permutation merge-trees' too."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    return mk.leaves(state.rows) + mk.leaves(state.cols) + list(state[2:])


def phase_matrix(seed: int, card: str, device: str, steps: int = 16, B: int = 64) -> dict:
    """BASELINE config 4: one SharedMatrix of 256 x 256 cells (128
    permutation segments) seeded with 128 rows and columns, then ``steps``
    steps of ``B`` SET_CELL ops from 64 writers through ``apply_ops``,
    writer 0's row and column inserts and removes interleaved (two a
    step), FWW on some cells.  The end
    state (both permutation merge-trees' raw columns included) and
    ``to_grid`` must equal a CPU run's exactly, with no error bit.  Ops/s,
    and one step's program call and device time beside its bytes bound."""
    import torch

    from fluidframework_tpu_torch.ops import matrix_kernel as mxk

    on_card = device == "cuda"
    traffic = matrix_traffic(seed, steps, B)
    state = mxk.apply_ops(mxk.init_state(**MATRIX_GEOM, device=device), traffic[0])
    if on_card:
        torch.cuda.synchronize()
    t = time.perf_counter()
    for ops in traffic[1:]:
        state = mxk.apply_ops(state, ops)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    cpu = mxk.init_state(**MATRIX_GEOM, device="cpu")
    for ops in traffic:
        cpu = mxk.apply_ops(cpu, ops)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(mk_leaves(state), mk_leaves(cpu))),
          "matrix: the end state differs from its CPU run")
    grid = mxk.to_grid(state)
    check(grid == mxk.to_grid(cpu), "matrix: to_grid differs from the CPU run")
    check(int(state.error) == 0 and int(state.rows.error) == 0 and int(state.cols.error) == 0,
          "matrix: error bits set")
    check(int(state.fww) == 1, "matrix: no FWW write was seen")
    out = {"phase": "matrix", "card": card, "shape": [MATRIX_GEOM["max_rows"], MATRIX_GEOM["max_cols"]],
           "steps": steps, "B": B, "ops": steps * (B + 2), "ops_per_s": steps * (B + 2) / wall,
           "grid_rows": len(grid), "grid_cols": len(grid[0]) if grid else 0,
           "cells_set": sum(v is not None for row in grid for v in row)}
    if on_card:
        ops_dev = torch.as_tensor(traffic[-1], device=device)
        kinds = traffic[-1][:, 0]
        nbytes, bound = state_bound(mk_leaves(state), (ops_dev,))
        out["step_program"] = {"shape": [B + 2, mxk.MATRIX_OP_FIELDS],
                               **time_program(lambda: mxk.apply_ops(state, ops_dev, kinds), 3, 1,
                                              uncounted=mxk.apply_ops_fleet),
                               "bound_ms": bound, "bound_bytes": nbytes, "bound_by": "bytes",
                               "max_abs_err": 0}
    emit(out)
    return out


# ------------------------------------------------------------------ serving

class _FeederServer:
    """The firehose stand-in's server (see ``FirehoseFeeder``): one thread
    accepts subscriptions and answers the consume handshake
    (``{"t":"consume","doc":...}``, then ``{"t":"consuming"}``), a second
    sends each subscriber its doc's JSON lines, wave by wave."""

    def __init__(self, waves: list[dict[str, bytes]]):
        import queue
        import socket
        import threading

        self.waves = waves
        self.released = 0
        self.subscriptions = 0
        self._closed = False
        self._subs: list = []
        self._lock = threading.Lock()
        self._jobs = queue.Queue()
        self._sock = socket.create_server(("127.0.0.1", 0), backlog=1024)
        self.port = self._sock.getsockname()[1]
        self._threads = [threading.Thread(target=self._accept, daemon=True),
                         threading.Thread(target=self._send, daemon=True)]
        for t in self._threads:
            t.start()

    def _accept(self) -> None:
        import socket

        self._sock.settimeout(0.2)  # wakes to see close()
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(4096)
                if not chunk:
                    break
                buf += chunk
            if not buf.endswith(b"\n"):
                conn.close()
                continue
            doc = json.loads(buf)["doc"]
            with self._lock:
                # The ack goes out before any of the doc's data is queued.
                self._subs.append((conn, doc))
                self.subscriptions += 1
                conn.sendall(b'{"t":"consuming"}\n')
                for w in range(self.released):
                    self._jobs.put((conn, self.waves[w].get(doc, b"")))

    def _send(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            conn, data = job
            if data:
                try:
                    conn.sendall(data)
                except OSError:
                    pass  # the subscriber went away
            self._jobs.task_done()

    def release(self, wave: int) -> int:
        with self._lock:
            self.released += 1
            for conn, doc in self._subs:
                self._jobs.put((conn, self.waves[wave].get(doc, b"")))
        return sum(map(len, self.waves[wave].values()))

    def drop_subscribers(self) -> None:
        with self._lock:
            subs, self._subs = self._subs, []
        for conn, _doc in subs:
            conn.close()

    def close(self) -> None:
        self._closed = True
        self._threads[0].join(timeout=10)
        self._sock.close()
        self._jobs.put(None)
        self.drop_subscribers()
        self._threads[1].join(timeout=10)


def _feeder_main(conn, waves, fd_need: int) -> None:
    """The feeder process: serve ``waves`` and answer the parent's
    commands until ``close``."""
    _raise_fd_limit(fd_need)
    server = _FeederServer(waves)
    conn.send(server.port)
    while True:
        cmd, arg = conn.recv()
        if cmd == "release":
            conn.send(server.release(arg))
        elif cmd == "flush":
            server._jobs.join()
            conn.send(None)
        elif cmd == "subscriptions":
            conn.send(server.subscriptions)
        elif cmd == "drop":
            server.drop_subscribers()
            conn.send(None)
        else:
            server.close()
            conn.send(None)
            return


class FirehoseFeeder:
    """A firehose stand-in over local TCP, in a process of its own (each
    subscription holds a socket at both ends; two processes halve each
    one's file descriptors).  ``waves[w][doc_id]`` is a doc's JSON-lines
    bytes of wave ``w``: ``release(w)`` sends wave ``w`` to every
    subscriber, and a later subscriber gets every released wave at once."""

    def __init__(self, waves: list[dict[str, bytes]]):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self.released = 0
        fd_need = len({d for w in waves for d in w}) + 512
        self._proc = ctx.Process(target=_feeder_main, args=(child, waves, fd_need), daemon=True)
        self._proc.start()
        self.port = self._conn.recv()

    def _call(self, cmd: str, arg=None):
        self._conn.send((cmd, arg))
        return self._conn.recv()

    @property
    def subscriptions(self) -> int:
        return self._call("subscriptions")

    def release(self, wave: int) -> int:
        """Send wave ``wave`` to every subscriber; returns its bytes."""
        check(wave == self.released, f"feeder: wave {wave} released out of order")
        self.released += 1
        return self._call("release", wave)

    def flush(self) -> None:
        """Wait until every queued send reached the kernel."""
        self._call("flush")

    def drop_subscribers(self) -> None:
        self._call("drop")

    def close(self) -> None:
        if self._proc.is_alive():
            self._call("close")
        self._proc.join(timeout=30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()


def _raise_fd_limit(need: int) -> int:
    """Raise RLIMIT_NOFILE's soft limit to ``need`` as far as the hard
    limit allows; returns the soft limit in force."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    want = need if hard == resource.RLIM_INFINITY else min(need, hard)
    if want > soft:
        resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
    return resource.getrlimit(resource.RLIMIT_NOFILE)[0]


def _doc_waves(doc_ids, rounds_msgs, groups) -> list[dict[str, bytes]]:
    """Per wave (a list of indices into ``rounds_msgs``), each doc's
    messages of those rounds as one JSON-lines chunk, in stream order."""
    out = []
    for group in groups:
        parts: dict[str, list[bytes]] = {}
        for r in group:
            for d, m in rounds_msgs[r]:
                parts.setdefault(doc_ids[d], []).append(m.wire_line())
        out.append({k: b"".join(v) for k, v in parts.items()})
    return out


def _rounds_for(traffic, n_docs: int, rounds: int) -> tuple:
    """``fleet_traffic``'s joins and first ``rounds`` rounds for docs below
    ``n_docs``."""
    joins = [(d, m) for d, m in traffic[0] if d < n_docs]
    return joins, [[(d, m) for d, m in r if d < n_docs] for r in traffic[1][:rounds]]


def _serve_fleet(seed, device, traffic, n_docs, rounds, sample, geom, reduced) -> dict:
    """Part (a): the string fleet over the wire."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.runtime.summary import make_scribe_ack
    from fluidframework_tpu_torch.server.fleet_consumer import FleetConsumer

    on_card = device == "cuda"
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"d{d}" for d in range(n_docs)]
    # Wave 0: the joins and round 0 (it warms the consumer and the step);
    # wave 1: every later round (the timed drain); wave 2: the scribe's
    # summaryAck for doc 0, the compaction trigger.
    waves = _doc_waves(doc_ids, [joins + rounds_msgs[0]] + rounds_msgs[1:],
                       [[0], list(range(1, rounds))])
    last0 = max(m.seq for r in rounds_msgs for d, m in r if d == 0)
    waves.append({doc_ids[0]: make_scribe_ack(doc_ids[0], last0, "0" * 64).wire_line()})
    rows = [len(rounds_msgs[0]), sum(len(r) for r in rounds_msgs[1:])]
    wire_bytes = sum(sum(map(len, w.values())) for w in waves)
    out = {"docs": n_docs, "rounds": rounds, "ops": sum(rows), "wire_bytes": wire_bytes,
           **reduced}
    feeder = FirehoseFeeder(waves)
    feeder.release(0)
    eng = DocBatchEngine(n_docs, device=device, **geom)
    t = time.perf_counter()
    fc = FleetConsumer("127.0.0.1", feeder.port, eng, doc_ids)
    try:
        out["subscribe_s"] = time.perf_counter() - t
        check(feeder.subscriptions == n_docs, f"serving: {feeder.subscriptions} subscriptions")
        t = time.perf_counter()
        fc.run_for(rows[0])
        if on_card:
            torch.cuda.synchronize()
        out["warm_wave_s"] = time.perf_counter() - t
        # The timed wave sits in the kernel's socket buffers before the
        # clock starts (bench.py _wire_ingest_rate's two waves).
        feeder.release(1)
        feeder.flush()
        time.sleep(0.25)
        t0 = time.perf_counter()
        idle = 0
        while fc.rows_staged < sum(rows):
            if fc.pump(0.005) == 0:
                idle += 1
                check(idle < 2000, f"serving: firehose idle at {fc.rows_staged}/{sum(rows)} rows")
            else:
                idle = 0
        t_drain = time.perf_counter() - t0
        fc.step()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # The ack arrives after the drain: the pump that reads it compacts.
        feeder.release(2)
        for _ in range(2000):
            if fc.bytes_consumed >= wire_bytes:
                break
            fc.pump(0.005)
        check(fc.bytes_consumed == wire_bytes,
              f"serving: consumed {fc.bytes_consumed} of {wire_bytes} bytes")
        h = fc.health()
        check(h["msn_compactions"] == 1, "serving: the summaryAck did not compact the fleet")
        check(not fc.dead_socks, f"serving: dead sockets {sorted(fc.dead_socks)[:8]}")
        check(eng.error_count() == 0, f"serving: {eng.error_count()} docs latched error bits")
        modes = sorted({x.mode for x in eng.hosts})
        check(modes == ["native"], f"serving: docs left the native path ({modes})")
        out.update({"drain_s": t_drain, "step_s": dt - t_drain,
                    "drain_ops_per_s": rows[1] / t_drain, "wire_ops_per_s": rows[1] / dt,
                    "timed_ops": rows[1], "rows_staged": fc.rows_staged,
                    "pump_pauses": h["pump_pauses"], "megasteps": h["megastep_dispatches"]})
    finally:
        fc.close()
        feeder.close()
    # The CPU replay of the same bytes, stepped and compacted at the same
    # points, holds the sampled docs.
    pick = sorted(int(d) for d in np.random.default_rng(seed + 1).choice(
        n_docs, size=min(sample, n_docs), replace=False))
    ref = DocBatchEngine(len(pick), device="cpu", **geom)
    for w, wave in enumerate(waves):
        for j, d in enumerate(pick):
            if wave.get(doc_ids[d]):
                ref.ingest_lines(j, wave[doc_ids[d]])
        if w < 2:
            ref.step()
        else:
            ref.compact()
    same = sum(_state_rows_equal(eng.doc_state(d), ref.doc_state(j)) for j, d in enumerate(pick))
    check(same == len(pick), f"serving: {len(pick) - same} of {len(pick)} sampled docs differ "
                             "from the CPU ingest_lines replay")
    out["sampled_docs_identical"] = same
    return out


def _serve_tree(device, churn) -> dict:
    """Part (b): tree_churn's stream over the wire, one step a round."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.server.fleet_consumer import FleetConsumer

    churn_eng, round_blobs = churn
    n = churn_eng.n_docs
    doc_ids = [f"t{d}" for d in range(n)]
    waves = [{doc_ids[d]: blob for d, blob in enumerate(blobs) if blob} for blobs in round_blobs]
    feeder = FirehoseFeeder(waves)
    eng = TreeBatchEngine(n, device=device, **TREE_CHURN_GEOM)
    fc = FleetConsumer("127.0.0.1", feeder.port, eng, doc_ids)
    want = 0
    t0 = time.perf_counter()
    try:
        for w in range(len(waves)):
            want += feeder.release(w)
            for _ in range(4000):
                if fc.bytes_consumed >= want:
                    break
                fc.pump(0.005)
            check(fc.bytes_consumed == want, f"serving tree: consumed {fc.bytes_consumed} of {want}")
            fc.step()
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = fc.health()
    finally:
        fc.close()
        feeder.close()
    check(not eng.errors().any() and sorted(eng.fallbacks) == sorted(churn_eng.fallbacks),
          "serving tree: error bits or fallbacks differ from tree_churn's")
    same = sum(_tree_docs_identical(eng, d, churn_eng, d) for d in range(n))
    check(same == n, f"serving tree: {n - same} of {n} docs differ from the tree_churn engine's")
    edits = sum(blob.count(b"\n") for w in waves for blob in w.values())
    return {"docs": n, "edits": edits, "wall_s": wall, "edits_per_s": edits / wall,
            "rows_staged": h["rows_staged"], "native_batches": h.get("tree_native_batches", 0),
            "identical_docs": same}


def scribe_traffic(seed: int, n_strings: int, n_trees: int, n_maps: int, n_matrices: int,
                   matrix_steps: int) -> list:
    """The scribe's topic as (doc id, message) pairs in produce order:
    config-3 string docs (``fleet_traffic``, 8 rounds), config-5 tree docs
    (``tree_traffic``, 4 rounds), maps of map_lww's op mix (256 SET and
    DELETE ops over 256 keys, a CLEAR halfway) and matrices of the matrix
    phase's stream (``matrix_traffic``, ``matrix_steps`` steps), as wire
    messages."""
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    def op(seq, ref, contents, client="w0"):
        return SequencedMessage(client_id=client, client_seq=seq, ref_seq=ref, seq=seq,
                                min_seq=0, contents=contents)

    out = []
    joins, rounds = fleet_traffic(n_strings, 8, FLEET_GEOM["ops_per_step"], 8, seed + 51)
    out += [(f"s{d}", m) for d, m in joins + [x for r in rounds for x in r]]
    out += [(f"t{d}", m) for r in tree_traffic(seed + 52, n_trees, 4) for d, m in r]
    kinds, keys, vals = map_ops(np.random.default_rng(seed + 53), (n_maps, 256), 256)
    for d in range(n_maps):
        seq = 0
        for b in range(256):
            if b == 128:
                seq += 1
                out.append((f"m{d}", op(seq, seq - 1, {"type": "clear"})))
            seq += 1
            key = f"k{keys[d, b]}"
            out.append((f"m{d}", op(seq, seq - 1, {"type": "set", "key": key,
                                                   "value": int(vals[d, b])}
                                    if kinds[d, b] == 1 else {"type": "delete", "key": key})))
    K = mxk.MatrixOpKind
    names = {K.INSERT_ROWS: "insertRows", K.INSERT_COLS: "insertCols",
             K.REMOVE_ROWS: "removeRows", K.REMOVE_COLS: "removeCols"}
    for x in range(n_matrices):
        out += [(f"x{x}", SequencedMessage(
            client_id=f"w{w}", client_seq=0, ref_seq=0, seq=0, min_seq=0,
            type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w}))
            for w in range(64)]
        for ops in matrix_traffic(seed + 54 + x, matrix_steps):
            for kind, seq, client, ref, a, b, v, fww in ops.tolist():
                if kind == K.SET_CELL:
                    c = {"type": "set", "row": a, "col": b, "value": v}
                    if fww:
                        c["fwwMode"] = True
                else:
                    c = {"type": names[kind], "pos": a, "count": b}
                out.append((f"x{x}", op(seq, ref, c, client=f"w{client}")))
    return out


def _serve_scribe(seed, device, n_strings, n_trees, n_maps, n_matrices, matrix_steps,
                  sample) -> dict:
    """Part (c): the scribe on ``device`` against the same scribe on the
    CPU, then engines booted from its summaries."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.runtime.summary import parse_scribe_ack
    from fluidframework_tpu_torch.server.ordered_log import Topic
    from fluidframework_tpu_torch.server.scribe import (
        ScribeConfig,
        ScribeLambda,
        SummaryRecordStore,
    )

    t = time.perf_counter()
    msgs = scribe_traffic(seed, n_strings, n_trees, n_maps, n_matrices, matrix_steps)
    gen_s = time.perf_counter() - t
    cfg = ScribeConfig(max_ops=64, map_max_keys=256,
                       matrix_shape=(MATRIX_GEOM["max_rows"], MATRIX_GEOM["max_cols"]),
                       matrix_segments=MATRIX_GEOM["max_segments"])
    cut = (3 * len(msgs)) // 5
    runs = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_scribe_")
    try:
        for dev in dict.fromkeys((device, "cpu")):
            topic = Topic("deltas", 4)
            sc = ScribeLambda(topic, os.path.join(root, dev), config=cfg, device=dev)
            t = time.perf_counter()
            for part in (msgs[:cut], msgs[cut:]):
                for doc, m in part:
                    topic.produce(doc, m)
                sc.pump()
            sc.summarize_all()
            sc.pump()
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            sc.close()
            with open(os.path.join(root, dev, "objects", "objects.jsonl"), "rb") as f:
                objects = f.read()
            with open(os.path.join(root, dev, "refs.json"), "rb") as f:
                refs = f.read()
            acks = [parse_scribe_ack(r.payload) for p in range(topic.n_partitions)
                    for r in topic.partition(p).read(0)]
            runs[dev] = {"scribe": sc, "wall": wall, "objects": objects, "refs": refs,
                         "acks": [a for a in acks if a is not None]}
        main, cpu = runs[device], runs["cpu"]
        check(main["refs"] == cpu["refs"], "scribe: refs.json differs from the CPU scribe's")
        check(main["acks"] == cpu["acks"], "scribe: the commit SHAs differ from the CPU scribe's")
        check(main["objects"] == cpu["objects"], "scribe: git objects differ from the CPU scribe's")
        sc = main["scribe"]
        h = sc.health()
        n_docs = n_strings + n_trees + n_maps + n_matrices
        check(h["failed_docs"] == 0 and h["acked_docs"] == n_docs,
              f"scribe: {h['failed_docs']} failed, {h['acked_docs']} of {n_docs} acked")
        store = SummaryRecordStore.from_scribe(sc)
        fams: dict[str, int] = {}
        for d in store.docs():
            fams[store.family(d)] = fams.get(store.family(d), 0) + 1
        check(fams == {"doc_batch": n_strings, "tree_batch": n_trees, "map_batch": n_maps,
                       "matrix_batch": n_matrices}, f"scribe: families {fams}")
        # Engines booted from the acked summaries, then fed the whole
        # stream (the covered prefix skips by seq floor), equal engines fed
        # it all.
        rng = np.random.default_rng(seed + 4)
        t = time.perf_counter()
        s_idx = {f"s{d}": d for d in range(n_strings)}
        s_msgs = [(s_idx[doc], m) for doc, m in msgs if doc in s_idx]
        primary = DocBatchEngine(n_strings, device=device, **FLEET_GEOM)
        boot = DocBatchEngine(n_strings, device=device, doc_keys=list(s_idx), **FLEET_GEOM)
        check(boot.restore_from_checkpoints(store=store) == list(range(n_strings)),
              "scribe: the string docs did not all boot from their summaries")
        for eng in (primary, boot):
            for d, m in s_msgs:
                eng.ingest(d, m)
            eng.step()
            eng.compact()  # the scribe's replica compacts as it folds
        pick = sorted(rng.choice(n_strings, size=min(sample, n_strings), replace=False).tolist())
        same = sum(_docs_equivalent(primary, d, boot, d) for d in pick)
        check(same == len(pick), f"scribe: {len(pick) - same} booted string docs differ")
        skipped = boot.health()["checkpointed_ops_skipped"]
        check(skipped > 0, "scribe: the boot replay skipped nothing")
        t_idx = {f"t{d}": d for d in range(n_trees)}
        t_msgs = [(t_idx[doc], m) for doc, m in msgs if doc in t_idx]
        tprimary = TreeBatchEngine(n_trees, device=device, **TREE_FLEET_GEOM)
        tboot = TreeBatchEngine(n_trees, device=device, doc_keys=list(t_idx), **TREE_FLEET_GEOM)
        check(tboot.restore_from_checkpoints(store=store) == list(range(n_trees)),
              "scribe: the tree docs did not all boot from their summaries")
        tboot.step()
        for eng in (tprimary, tboot):
            for d, m in t_msgs:
                eng.ingest(d, m)
            eng.step()
        tpick = sorted(rng.choice(n_trees, size=min(sample, n_trees), replace=False).tolist())
        # The served views: a booted EditManager's trunk window holds the
        # rebased commits in another (equivalent) form than a live one's,
        # in the reference as well, so its summary is not compared.
        tsame = sum(json.dumps(tprimary.tree_json(d)) == json.dumps(tboot.tree_json(d))
                    and json.dumps(tprimary.values(d)) == json.dumps(tboot.values(d))
                    for d in tpick)
        check(tsame == len(tpick), f"scribe: {len(tpick) - tsame} booted tree docs differ")
        boot_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"docs": n_docs, "messages": len(msgs), "matrix_steps": matrix_steps,
            "traffic_gen_s": gen_s, "wall_s": main["wall"], "cpu_wall_s": cpu["wall"],
            "summaries": h["summaries_written"],
            "summaries_per_s": h["summaries_written"] / main["wall"],
            "acks": len(main["acks"]), "object_bytes": len(main["objects"]),
            "git_sharing_ratio": h["git_sharing_ratio"],
            "handles_reused": h.get("summary_handles_reused", 0),  # a counter, absent at 0
            "booted_strings_equal": same, "booted_trees_equal": tsame,
            "boot_ops_skipped": skipped, "boot_s": boot_s}


def _serve_failover(seed, device, traffic, n_docs, rounds, sample, geom) -> dict:
    """Part (d): a primary with a background checkpoint writer, and a warm
    standby that prepares, trails and promotes on the lease's release."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.models.recovery import BackgroundCheckpointWriter
    from fluidframework_tpu_torch.observability import uninstall
    from fluidframework_tpu_torch.server.failover import LeaseFile, WarmStandby
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def feed(eng, r):
        eng.ingest_batch([d for d, _ in rounds_msgs[r]], [m for _, m in rounds_msgs[r]])

    # One round past the kill: the promoted engine's first step then has
    # work however far the writer and the trails got (a fully caught-up
    # standby replays nothing, and its recovery clock waits for work).
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds + 1)
    half = rounds // 2
    root = tempfile.mkdtemp(prefix="chip_smoke_failover_")
    store_dir = os.path.join(root, "ckpt")
    lease_path = os.path.join(root, "lease.json")
    out = {"docs": n_docs, "rounds": rounds, "rounds_after_kill": 1}
    try:
        primary = DocBatchEngine(n_docs, device=device,
                                 checkpoint_store=CheckpointStore(store_dir), **geom)
        lease = LeaseFile(lease_path, "primary", ttl_s=60.0)
        check(lease.acquire(), "failover: the primary could not take the lease")
        writer = BackgroundCheckpointWriter(primary, max_seconds_behind=0.05,
                                            interval_s=0.02).start()
        try:
            for d, m in joins:
                primary.ingest(d, m)
            for r in range(half):
                feed(primary, r)
                primary.step()
            sync()
            time.sleep(0.2)
            eng = DocBatchEngine(n_docs, device=device,
                                 checkpoint_store=CheckpointStore(store_dir), **geom)
            ws = WarmStandby(eng, CheckpointStore(store_dir),
                             lease=LeaseFile(lease_path, "standby", ttl_s=60.0))
            rec = install_recorder(1 << 12)
            try:
                t = time.perf_counter()
                ws.prepare()
                sync()
                out["prepare_s"] = time.perf_counter() - t
                out["warmup_s"] = recorder_line(rec, None, "")["phase_s"].get("warmup")
            finally:
                uninstall()
            out["warmup_dispatches"] = eng.health()["warmup_dispatches"]
            out["adopted_at_prepare"] = sum(h.restored for h in eng.hosts)
            for r in range(half, rounds):
                feed(primary, r)
                primary.step()
                sync()
                ws.trail()
            check(not ws.should_promote(), "failover: the standby would promote under a live lease")
        finally:
            writer.stop()
        out["writer"] = writer.stats()
        check(out["writer"]["ckpt_writer_records"] > 0 and out["writer"]["ckpt_writer_errors"] == 0,
              f"failover: checkpoint writer {out['writer']}")
        # A cold successor from the same store, without warmup, for the
        # first-step comparison (built before the kill: the recovery clock
        # times the standby alone).
        cold = DocBatchEngine(n_docs, device=device,
                              checkpoint_store=CheckpointStore(store_dir), **geom)
        cold.restore_from_checkpoints()
        # The primary shuts down cleanly: its lease release promotes.
        lease.release()
        check(ws.should_promote(), "failover: the released lease does not promote the standby")
        t_kill = time.monotonic()
        ws.promote(incident_started_at=t_kill)
        out["trails"], out["adoptions"] = ws.trails, ws.adoptions
        check(ws.lease.epoch >= 0, "failover: the promoted standby does not hold the lease")
        steps = {}
        for name, e in (("warm", eng), ("cold", cold)):
            for d, m in joins:
                e.ingest(d, m)
            for r in range(rounds + 1):
                feed(e, r)  # the checkpointed prefix skips by seq floor
            t = time.perf_counter()
            e.step()
            sync()
            steps[name] = time.perf_counter() - t
        feed(primary, rounds)  # what the primary would hold had it lived
        primary.step()
        h = eng.health()
        pick = sorted(int(d) for d in np.random.default_rng(seed + 5).choice(
            n_docs, size=min(sample, n_docs), replace=False))
        same = sum(_docs_equivalent(primary, d, eng, d) for d in pick)
        check(same == len(pick), f"failover: {len(pick) - same} promoted docs differ from the primary")
        same_cold = sum(_docs_equivalent(primary, d, cold, d) for d in pick)
        check(same_cold == len(pick), f"failover: {len(pick) - same_cold} cold docs differ")
        check(eng.error_count() == 0, "failover: error bits after the promotion")
        check(h["recovery_incidents"] == 1 and h["standby_promotions"] == 1,
              f"failover: incidents {h['recovery_incidents']}, promotions {h['standby_promotions']}")
        out.update({"first_step_warm_s": steps["warm"], "first_step_cold_s": steps["cold"],
                    "recovery_p50_ms": h["recovery_p50_ms"],
                    "checkpointed_ops_skipped": h["checkpointed_ops_skipped"],
                    "identical_docs": same})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def _serve_entry(device, traffic, n_docs, rounds, geom) -> dict:
    """Part (e): ``fleet_main`` as a subprocess, twice on one checkpoint
    directory, against an in-process engine fed the same bytes."""
    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"e{d}" for d in range(n_docs)]
    half = rounds // 2
    waves = _doc_waves(doc_ids, [joins + rounds_msgs[0]] + rounds_msgs[1:],
                       [list(range(half)), list(range(half, rounds))])
    wave_rows = [sum(len(r) for r in rounds_msgs[:half]), sum(len(r) for r in rounds_msgs[half:])]
    feeder = FirehoseFeeder(waves)
    root = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    repo = os.path.dirname(os.path.abspath(__file__))
    out = {"docs": n_docs, "rounds": rounds, "rows": wave_rows}
    try:
        cmd = [sys.executable, "-m", "fluidframework_tpu_torch.server.fleet_main",
               "--port", str(feeder.port), "--docs", ",".join(doc_ids), "--device", device,
               "--checkpoint-dir", os.path.join(root, "ckpt"),
               "--capacity", str(geom["max_segments"]),
               "--text-capacity", str(geom["text_capacity"]),
               "--max-insert-len", str(geom["max_insert_len"]),
               "--ops-per-step", str(geom["ops_per_step"]),
               "--megastep-k", str(geom["megastep_k"]), "--status-every", "600"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        runs = []
        for w in range(2):
            feeder.release(w)
            t = time.perf_counter()
            proc = subprocess.run([*cmd, "--exit-after-rows", str(wave_rows[w])],
                                  capture_output=True, text=True, timeout=300, env=env, cwd=repo)
            wall = time.perf_counter() - t
            check(proc.returncode == 0,
                  f"entry: fleet_main run {w} exited {proc.returncode}: {proc.stderr[-1500:]}")
            runs.append(([json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")],
                         wall))
            feeder.drop_subscribers()
        eng = DocBatchEngine(n_docs, device=device, **geom)
        texts = []
        for wave in waves:
            for d, doc in enumerate(doc_ids):
                if wave.get(doc):
                    eng.ingest_lines(d, wave[doc])
            eng.step()
            texts.append({doc: eng.text(d) for d, doc in enumerate(doc_ids)})
        (first, wall0), (second, wall1) = runs
        check(first[-1].get("done") and first[-1]["errors"] == 0, "entry: run 0 did not end clean")
        check(first[-1]["texts"] == texts[0], "entry: run 0's texts differ from the in-process engine")
        check(second[0].get("restored") == doc_ids, "entry: run 1 did not restore every doc")
        check(second[-1].get("done") and second[-1]["errors"] == 0, "entry: run 1 did not end clean")
        skipped = second[-1]["health"]["checkpointed_ops_skipped"]
        check(skipped > 0, "entry: the restart replay skipped nothing")
        check(second[-1]["texts"] == texts[1], "entry: run 1's texts differ from the in-process engine")
        out.update({"run_s": [wall0, wall1], "checkpointed_ops_skipped": skipped,
                    "checkpoints_written": first[-1]["health"]["checkpoints_written"]})
    finally:
        feeder.close()
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_serving(seed: int, card: str, device: str, traffic, churn, n_docs: int = 10_000,
                  rounds: int = 16, sample: int = 64, geom: dict = FLEET_GEOM,
                  scribe_docs: tuple = (64, 64, 64, 4), matrix_steps: int = 4,
                  failover_docs: int = 512, failover_rounds: int = 8,
                  entry_docs: int = 256, entry_rounds: int = 8) -> dict:
    """Phase 14, the serving tier on ``device``: (a) the string fleet over
    the wire, (b) the tree fleet over the wire, (c) the scribe, (d)
    failover, (e) the ``fleet_main`` entry point (see the module
    docstring).  ``traffic`` is ``fleet_traffic``'s for ``n_docs`` docs;
    ``churn`` is ``phase_tree_churn``'s engine and stream."""
    geom = dict(geom, recovery="grow")
    out = {"phase": "serving", "card": card}
    t_all = time.perf_counter()
    # Each subscription holds a socket here and one in the feeder process.
    need = n_docs + 512
    limit = _raise_fd_limit(need)
    reduced = {}
    if limit < need:
        cut = max(64, limit - 512)
        reduced = {"reduced": f"docs {n_docs} -> {cut}: RLIMIT_NOFILE hard limit {limit}"}
        n_docs = cut
    out["fd_limit"] = limit
    parts = (
        ("wire_fleet", lambda: _serve_fleet(seed, device, traffic, n_docs, rounds, sample, geom,
                                            reduced)),
        ("wire_tree", lambda: _serve_tree(device, churn)),
        ("scribe", lambda: _serve_scribe(seed, device, *scribe_docs, matrix_steps, sample)),
        ("failover", lambda: _serve_failover(seed, device, traffic, failover_docs,
                                             failover_rounds, sample, geom)),
        ("entry", lambda: _serve_entry(device, traffic, entry_docs, entry_rounds, geom)),
    )
    for name, part in parts:
        t = time.perf_counter()
        out[name] = part()
        out[name]["part_s"] = time.perf_counter() - t
        gc.collect()
    out["wall_s"] = time.perf_counter() - t_all
    emit(out)
    return out


# ------------------------------------------------ phase 15: the sharded fleet

SHARDED_ROUNDS = 8      # of the fleet's shared traffic, for parts (a), (b)
SHARDED_MIGRATE_AT = 3  # parts (a), (b): 16 docs move after this round is ingested
SHARDED_BURST_AT = 4    # rounds 4 and 5: shard 0's docs run a round ahead


def _repack(eng, d: int) -> None:
    """What a migration (or a demotion) does to doc ``d``'s row, on an
    engine that keeps the doc in place: the row through the checkpoint
    codec, re-packed at the batch geometry into its own slot.  A control
    engine re-packs the docs the sharded engine moved at the same point of
    the stream, so every raw row of the two compares exactly."""
    from fluidframework_tpu_torch.dds import kernel_backend as kb
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    h = eng.hosts[d]
    summary = kb.state_to_summary(mk.to_numpy(eng.doc_state(d)),
                                  {v: k for k, v in h.prop_slot.items()})
    eng._put_row(int(eng._slot[d]), kb.summary_to_state_host(
        summary, eng.geometry, lambda p: eng._prop_slot_for_geom(h, p, eng.geometry)))


def _fleets_differ(a, b) -> tuple[int, int]:
    """(docs whose raw rows differ, docs whose error latch differs) between
    two string engines, each doc read at its own slot, compared on the
    device."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    n = a.n_docs
    ia = torch.as_tensor(a._slot, device=a.device)
    ib = torch.as_tensor(b._slot, device=b.device)
    diff = torch.zeros(n, dtype=torch.bool, device=a.device)
    for x, y in zip(mk.leaves(a.state), mk.leaves(b.state)):
        diff |= (x.index_select(0, ia) != y.index_select(0, ib).to(a.device)).reshape(n, -1).any(-1)
    latch = int((np.asarray(a.errors()[:n]) != np.asarray(b.errors()[:n])).sum())
    return int(diff.sum()), latch


def _sharded_fleet_run(eng, joins, rounds_msgs, role: str, plan: dict, shard0: set,
                       on_card: bool) -> dict:
    """One run of parts (a)/(b) over ``rounds_msgs``: a round an
    ``ingest_batch``, a step and a compact every two rounds; after round
    ``SHARDED_MIGRATE_AT`` is ingested the docs of ``plan["migrate"]`` move
    to the next shard with their rows still staged; at
    ``SHARDED_BURST_AT`` shard 0's docs take two rounds before the others.
    The ``"mesh"`` role migrates, calls ``rebalance_hot_shards()`` after
    every step (a serving loop's window) and at the burst until it makes a
    move, recording its moves in ``plan``; the ``"control"`` role re-packs
    the same docs at the same points (``_repack``)."""
    import torch

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def ingest(msgs):
        if msgs:
            eng.ingest_batch([d for d, _ in msgs], [m for _, m in msgs])

    def step():
        eng.step()
        eng.compact()

    def moved(point, moves):
        if role == "mesh":
            plan.setdefault(point, []).extend(moves)
        else:
            for d in plan.get(point, []):
                _repack(eng, d)

    out = {"migrate_ms": []}
    for d, m in joins:
        eng.ingest(d, m)
    sync()
    t0 = time.perf_counter()
    r = 0
    while r < len(rounds_msgs):
        if r == SHARDED_BURST_AT:
            both = [x for rr in (r, r + 1) for x in rounds_msgs[rr]]
            ingest([x for x in both if x[0] in shard0])
            if role == "mesh":
                moves = []
                for _ in range(4):
                    moves = eng.rebalance_hot_shards(2.0)
                    if moves:
                        break
                check(moves and all(t >= 0 for _d, _s, t in moves),
                      f"sharded: the burst on shard 0 made no migration ({moves})")
                out["burst_moves"] = moves
                moved("burst", [d for d, _s, _t in moves])
            else:
                moved("burst", None)
            ingest([x for x in both if x[0] not in shard0])
            step()
            r += 2
            continue
        ingest(rounds_msgs[r])
        if r == SHARDED_MIGRATE_AT:
            if role == "mesh":
                for d in plan["migrate"]:
                    check(len(eng.hosts[d].queue) > 0, f"sharded: doc {d} has no staged rows")
                    t = time.perf_counter()
                    ok = eng.migrate_doc(d, (eng.shard_of(d) + 1) % eng.n_shards)
                    sync()
                    out["migrate_ms"].append((time.perf_counter() - t) * 1e3)
                    check(ok, f"sharded: migrate_doc({d}) refused")
            else:
                for d in plan["migrate"]:
                    _repack(eng, d)
        if r % 2 == 1:
            step()
            if role == "mesh":
                moves = eng.rebalance_hot_shards(2.0)
                moved(f"step{r}", [d for d, _s, _t in moves])
            else:
                moved(f"step{r}", None)
        r += 1
    sync()
    out["wall_s"] = time.perf_counter() - t0
    out["ops"] = eng.counters.get("ops_staged")
    out["ops_per_s"] = out["ops"] / out["wall_s"]
    return out


def _sharded_fleet(seed: int, card: str, device: str, traffic, n_docs: int = 10_000,
                   rounds: int = SHARDED_ROUNDS, spare: int = 64, sample: int = 64,
                   geom: dict = FLEET_GEOM, turns: int = 6) -> dict:
    """Parts (a) and (b): the config-3 fleet on a 4-shard mesh with
    ``spare`` spare slots (migrations, a hot-shard rebalance) against a
    control with no mesh (``use_mesh=False``: cohort steps) and the default
    full-fleet engine; every doc's raw row and latch equal across the
    three, 64 sampled unmoved docs equal a CPU replay; ops/s of each in
    turns (the first ``turns`` of mesh, cohort, full, full, cohort, mesh:
    the checked three, then the timing turns in reverse)."""
    import gc

    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.parallel.mesh import doc_mesh

    on_card = device == "cuda"
    geom = dict(geom, recovery="grow")
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    mesh = doc_mesh([device] * 4)
    rng = np.random.default_rng(seed + 15)
    # Docs 1.. of every shard: doc 0, the Zipf head, is the burst's move.
    plan = {"migrate": sorted(int(d) for d in rng.choice(np.arange(1, n_docs), 16, replace=False))}
    makers = {
        "mesh": lambda: DocBatchEngine(n_docs, mesh=mesh, spare_slots=spare, **geom),
        "cohort": lambda: DocBatchEngine(n_docs, device=device, use_mesh=False, **geom),
        "full": lambda: DocBatchEngine(n_docs, device=device, **geom),
    }
    shard0 = None
    runs: dict[str, list] = {k: [] for k in makers}
    engines = {}
    # Checked turns first (mesh, then the two controls), then timing turns
    # in reverse: mesh, cohort, full, full, cohort, mesh.
    for turn, name in enumerate(("mesh", "cohort", "full", "full", "cohort", "mesh")[:turns]):
        eng = makers[name]()
        if shard0 is None:
            shard0 = {d for d in range(n_docs) if eng.shard_of(d) == 0}
        role = "mesh" if name == "mesh" else "control"
        # The timing turn of the mesh records its moves apart; the
        # controls re-pack the checked mesh run's.
        run_plan = plan if role == "control" or turn == 0 else {"migrate": plan["migrate"]}
        run = _sharded_fleet_run(eng, joins, rounds_msgs, role, run_plan, shard0, on_card)
        runs[name].append(run)
        if turn < 3:
            engines[name] = eng
        if turn == 2:
            m, c, f = engines["mesh"], engines["cohort"], engines["full"]
            for other_name, other in (("cohort", c), ("full", f)):
                rows, latch = _fleets_differ(m, other)
                check(rows == 0 and latch == 0,
                      f"sharded: {rows} rows / {latch} latches differ from the {other_name} engine")
            check(m.error_count() == 0 and not m.overflow and not m.quarantine,
                  "sharded: the mesh engine latched or recovered docs")
            check(c.cohort_steps > 0 and f.cohort_steps == 0 and m.cohort_steps == 0,
                  f"sharded: cohort steps {c.cohort_steps} / {f.cohort_steps} / {m.cohort_steps}")
            h = m.health()
            moved_docs = set(plan["migrate"]) | {d for k, v in plan.items() if k != "migrate"
                                                 for d in v}
            check(h["doc_migrations"] == len(moved_docs),
                  f"sharded: {h['doc_migrations']} migrations for {len(moved_docs)} moves")
            pick = sorted(int(d) for d in rng.choice(
                [d for d in range(n_docs) if d not in moved_docs], sample, replace=False))
            local = {d: j for j, d in enumerate(pick)}
            ref = DocBatchEngine(len(pick), device="cpu", **geom)
            t = time.perf_counter()
            _sharded_fleet_run(ref, [(local[d], x) for d, x in joins if d in local],
                               [[(local[d], x) for d, x in rr if d in local] for rr in rounds_msgs],
                               "control", {"migrate": []}, {local[d] for d in pick if d in shard0},
                               False)
            replay_s = time.perf_counter() - t
            same = sum(_state_rows_equal(m.doc_state(d), ref.doc_state(j)) for d, j in local.items())
            check(same == len(pick), f"sharded: {len(pick) - same} sampled docs differ from the CPU")
            shard_line = {
                "n_shards": m.n_shards, "capacity": m.capacity, "docs_per_shard": m.docs_per_shard,
                "free_slots": [m.free_slots(s) for s in range(m.n_shards)],
                "shard_ops": h["shard_ops"], "migrations": h["doc_migrations"],
                "hot_shard_rebalances": h["hot_shard_rebalances"],
                "burst_moves": runs["mesh"][0]["burst_moves"],
                "cohort": {"full_steps": c.full_steps, "cohort_steps": c.cohort_steps,
                           "cohort_lanes": c.cohort_lanes},
                "full": {"full_steps": f.full_steps},
                "identical_docs": n_docs, "sampled_docs_identical": same, "cpu_replay_s": replay_s,
            }
            if on_card:
                shard_line["cohort_programs"] = _time_cohort_pair(c)
            engines.clear()
            del m, c, f, ref
        del eng
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    migrate_ms = [x for run in runs["mesh"] for x in run["migrate_ms"]]
    return {
        "docs": n_docs, "rounds": rounds, "spare_slots": spare, "turns": turns,
        "reduced": f"rounds 16 -> {rounds} (the fleet phase's 16 rounds of the shared traffic)",
        "ops": runs["mesh"][0]["ops"],
        "ops_per_s": {k: [r["ops_per_s"] for r in v] for k, v in runs.items()},
        "wall_s": {k: [r["wall_s"] for r in v] for k, v in runs.items()},
        "migrate_ms_mean": float(np.mean(migrate_ms)), "migrate_ms_max": float(np.max(migrate_ms)),
        "migrate_calls": len(migrate_ms), **shard_line,
    }


def _time_cohort_pair(eng, Kc: int = 16) -> dict:
    """``gather_cohort`` and ``scatter_cohort`` timed alone at the fleet's
    geometry on a 16-lane cohort (12 busy slots, 4 pad lanes) of ``eng``'s
    state, beside their bytes bounds (the cohort's rows read and written
    once).  The scatter writes the rows it gathered: the state's bytes do
    not change.  Each is held against the same program on CPU copies of
    the cohort's rows (copied one row at a time): the gather's lanes, and
    the rows a scatter of changed lanes leaves (then the gathered lanes
    are written back)."""
    import torch

    from fluidframework_tpu_torch.models import doc_batch_engine as dbe
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    busy = np.arange(12, dtype=np.int64) * 97
    idx = np.full((Kc,), busy[-1], np.int64)
    idx[:12] = eng._slot[busy]
    valid = np.zeros((Kc,), bool)
    valid[:12] = True
    state = eng.state
    counts = dbe.gather_cohort.launches, dbe.scatter_cohort.launches
    sub = dbe.gather_cohort(state, idx)
    row_bytes = nbytes_of(mk.leaves(sub)) // Kc
    rows = sorted(set(idx.tolist()))
    local = np.asarray([rows.index(int(i)) for i in idx], np.int64)

    def host_rows(st):
        return mk.tree_map(lambda x: torch.stack([x[r].cpu() for r in rows]), st)

    errs = {"gather": leaf_max_err(mk.leaves(sub),
                                   mk.leaves(dbe.gather_cohort(host_rows(state), local)))}
    changed = mk.tree_map(lambda x: x + 1, sub)
    want = dbe.scatter_cohort(host_rows(state), mk.tree_map(lambda x: x.cpu(), changed),
                              local, valid)
    errs["scatter"] = leaf_max_err(mk.leaves(host_rows(dbe.scatter_cohort(
        state, changed, idx, valid))), mk.leaves(want))
    dbe.scatter_cohort(state, sub, idx, valid)
    for name, err in errs.items():
        check(err == 0, f"sharded: the cohort {name} differs from the CPU by {err}")
    out = {}
    for name, fn, nbytes in (
        ("gather", lambda: dbe.gather_cohort(state, idx), 2 * Kc * row_bytes),
        ("scatter", lambda: dbe.scatter_cohort(state, sub, idx, valid), 2 * 12 * row_bytes),
    ):
        out[name] = {"lanes": Kc, **time_program(fn, 20), "bound_bytes": nbytes,
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
                     "max_abs_err": errs[name]}
    dbe.gather_cohort.launches, dbe.scatter_cohort.launches = counts
    return out


def hot_doc_messages(seed: int, rounds: int, writers: int = 4) -> tuple:
    """``four_writer_trace``'s op soup as sequenced wire messages for one
    document: per round every writer makes two edits at the round's
    ref_seq (inserts of 1-19 chars, removes, annotates and sided
    obliterates of its own insert), MSN at the round start.  Returns the
    joins and per-round message lists."""
    from fluidframework_tpu_torch.protocol.messages import MessageType, SequencedMessage

    rng = np.random.default_rng(seed)
    joins = [SequencedMessage(client_id=f"w{w}", client_seq=0, ref_seq=0, seq=0, min_seq=0,
                              type=MessageType.JOIN, contents={"clientId": f"w{w}", "short": w})
             for w in range(writers)]
    out = []
    length = seq = 0
    for _r in range(rounds):
        ref, base = seq, length
        own = [0] * writers
        last_ins = [(0, 0)] * writers
        msgs = []
        for w in range(writers):
            for _ in range(2):
                own_len = base + own[w]
                kind = int(rng.integers(0, 5))
                p, ln = last_ins[w]
                if kind in (0, 1) or own_len < 4 or (kind == 4 and ln < 2):
                    tlen = int(rng.integers(1, 20))
                    pos = int(rng.integers(0, own_len + 1))
                    text = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, tlen))
                    c = {"type": 0, "pos1": pos, "seg": text}
                    last_ins[w] = (pos, tlen)
                    own[w] += tlen
                elif kind == 2:
                    p2 = min(p + max(1, ln // 2), own_len)
                    c = {"type": 1, "pos1": p, "pos2": p2}
                    own[w] -= p2 - p
                    last_ins[w] = (p, 0)
                elif kind == 3:
                    a = int(rng.integers(0, own_len - 1))
                    b = int(rng.integers(a + 1, own_len + 1))
                    c = {"type": 2, "pos1": a, "pos2": b,
                         "props": {int(rng.integers(0, 2)): int(rng.integers(1, 100))}}
                else:
                    c = {"type": 5, "pos1": {"pos": p, "before": True},
                         "pos2": {"pos": p + ln - 1, "before": False}}
                    own[w] -= ln
                    last_ins[w] = (p, 0)
                seq += 1
                msgs.append(SequencedMessage(client_id=f"w{w}", client_seq=seq, ref_seq=ref,
                                             seq=seq, min_seq=ref, contents=c))
        length = base + sum(own)
        out.append(msgs)
    return joins, out


# Config-1 geometry for phase 15's hot doc; 16 obliterate slots, as the
# reference's segment-lane tests give the four-writer op soup.
HOT_GEOM = dict(max_segments=16_384, text_capacity=131_072, remove_slots=4, prop_slots=2,
                ob_slots=16, max_insert_len=8, ops_per_step=16, megastep_k=8)


def _sharded_hot(seed: int, card: str, device: str, traffic, n_cold: int = 64,
                 hot_rounds: int = 80, spare: int = 64, geom: dict = HOT_GEOM) -> dict:
    """Part (c): a hot doc at config-1 geometry among ``n_cold`` cold docs
    (the fleet traffic's first docs) on an 8-device docs x segs mesh with 4
    segment shards, against an oracle engine that serves the hot doc in its
    batch row (no mesh, no lanes) and re-packs the docs the sharded engine
    moves or demotes at the same points (``_repack``).  The hot doc's
    rounds in five parts, stepped two rounds at a time with a rebalance
    window after each step: batch; promoted by ``enable_segment_sharding``
    (with rows staged) and re-blocked every 128 lane rows
    (``seg_rebalance_every``), demoted; batch; eight rounds staged at once,
    a deep queue that ``rebalance_hot_shards`` answers (the cold docs of
    its shard migrate off, then the hot doc promotes: a move to -1); the
    lane, demoted at the end.  Every doc's raw row and latch equal the oracle's at the end;
    on the lanes the hot doc's gathered document equals the oracle row's
    live content and ``seg_occupancy`` sums to its live count."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions
    from fluidframework_tpu_torch.parallel.mesh import docs_segs_mesh

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    hjoins, hrounds = hot_doc_messages(seed + 3, hot_rounds)
    cjoins, crounds = _rounds_for(traffic, n_cold, 3)
    mesh = docs_segs_mesh([device] * 8, seg_shards=4)
    hot = DocBatchEngine(1 + n_cold, mesh=mesh, spare_slots=spare, seg_rebalance_every=128,
                         **geom)
    oracle = DocBatchEngine(1 + n_cold, device=device, **geom)
    engines = (hot, oracle)
    for eng in engines:
        for m in hjoins:
            eng.ingest(0, m)
        for d, m in cjoins:
            eng.ingest(d + 1, m)
    # The hot doc's rounds in five parts (80 rounds: 16, 24, 10, 8, 22).
    bounds = [0, hot_rounds // 5, hot_rounds // 2, 5 * hot_rounds // 8,
              29 * hot_rounds // 40, hot_rounds]
    parts = [hrounds[bounds[i]:bounds[i + 1]] for i in range(5)]
    out = {"S": geom["max_segments"], "T": geom["text_capacity"], "cold_docs": n_cold,
           "hot_msgs": sum(len(r) for r in hrounds), "seg_shards": hot.seg_shards,
           "n_shards": hot.n_shards}
    lane_rows = 0
    lane_s = 0.0
    captured = {}
    seg_prog = hot._seg_megastep

    def capture(state, ops, pays, kinds=None):
        # The deepest ring the lane dispatches, for K6's timing alone.
        if ops.shape[0] > captured.get("ring", (None, np.zeros((0,))))[1].shape[0]:
            captured["ring"] = (state, ops, pays, kinds)
        return seg_prog(state, ops, pays, kinds=kinds)

    hot._seg_megastep = capture

    def feed(msgs, cold_round=None):
        for eng in engines:
            for m in msgs:
                eng.ingest(0, m)
            if cold_round is not None:
                for d, m in crounds[cold_round]:
                    eng.ingest(d + 1, m)

    def step_both():
        nonlocal lane_rows, lane_s
        lane = hot.seg_lanes.get(0)
        rows = len(lane.queue) if lane is not None else 0
        t = time.perf_counter()
        hot.step()
        sync()
        if lane is not None:
            lane_rows += rows
            lane_s += time.perf_counter() - t
        oracle.step()
        for eng in engines:
            eng.compact()

    def check_lane(tag):
        a = mk.canonical_doc(mk.to_numpy(oracle.doc_state(0)))
        b = mk.canonical_doc(hot.doc_state(0))
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        check(not bad, f"sharded hot ({tag}): the lane differs from the oracle in {bad}")
        check(mk.seg_replica_mismatch(hot.seg_lanes[0].state) == [],
              f"sharded hot ({tag}): the lane's replicas disagree")
        occ = hot.health()["seg_occupancy"]
        check(sum(occ) == b["nseg"], f"sharded hot ({tag}): occupancy {occ} vs {b['nseg']} live")
        return occ

    moves = []

    def rebalance():
        """One rebalance window; the oracle re-packs every doc it moved."""
        got = hot.rebalance_hot_shards(2.0)
        for d, _s, t in got:
            if t >= 0:
                _repack(oracle, d)
        moves.extend(got)
        return got

    def serve(rounds, cold_round=None, first=None):
        """Two rounds a step, as a serving loop steps; a rebalance window
        after each step.  ``first`` runs after the first two rounds are
        staged, before their step."""
        for i in range(0, len(rounds), 2):
            feed([m for r in rounds[i:i + 2] for m in r], cold_round if i == 0 else None)
            if i == 0 and first is not None:
                first()
            step_both()
            rebalance()

    def promote():
        check(hot.enable_segment_sharding(0), "sharded hot: enable_segment_sharding refused")

    # Part 1 in the batch, with a cold round.
    serve(parts[0], 0)
    # Part 2 on the lane: promoted with its first rows staged.
    serve(parts[1], first=promote)
    out["occupancy_first_lane"] = check_lane("first lane")
    check(hot.health()["seg_rebalances"] >= 1, "sharded hot: the lane never re-blocked")
    check(hot.disable_segment_sharding(0), "sharded hot: the demotion refused")
    _repack(oracle, 0)
    # Part 3 in the batch, with a cold round.
    serve(parts[2], 1)
    # Part 4: the hot doc's rounds staged at once, a deep queue: the
    # rebalance moves the cold docs of its shard off, then promotes it.
    feed([m for r in parts[3] for m in r])
    for _ in range(2 * hot.docs_per_shard):
        if any(t == -1 for _d, _s, t in rebalance()):
            break
    check(moves and moves[-1][0] == 0 and moves[-1][2] == -1 and 0 in hot.seg_lanes,
          f"sharded hot: no promotion by rebalance ({moves})")
    step_both()
    # Part 5 on the lane.
    serve(parts[4], 2)
    out["occupancy_second_lane"] = check_lane("second lane")
    hot._seg_megastep = seg_prog
    # K6 at n=4 alone on a captured ring, held against the same program on
    # CPU copies of its inputs (its launches, and K1's inside, stay off the
    # path's counts).
    timing = {}
    if on_card and "ring" in captured:
        st, o, p, kinds = captured["ring"]
        counts = mk.apply_megastep_seg.launches, resolve_positions.launches
        timing = time_program(lambda: seg_prog(st, o, p, kinds=kinds), 2, 1)
        want = mk.apply_megastep_seg(
            mk.tree_map(lambda x: x.cpu(), st), torch.as_tensor(o).cpu(),
            torch.as_tensor(p).cpu(), group=mk.StackedShardGroup(hot.seg_shards), kinds=kinds)
        err = leaf_max_err(mk.leaves(seg_prog(st, o, p, kinds=kinds)), mk.leaves(want))
        check(err == 0, f"sharded hot: K6 at n=4 differs from the CPU by {err}")
        mk.apply_megastep_seg.launches, resolve_positions.launches = counts
        nbytes, bound = state_bound(mk.leaves(st), (o, p))
        timing.update({"shape": [int(o.shape[0]), int(o.shape[1])], "seg_shards": 4,
                       "bound_bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
                       "max_abs_err": err})
    check(hot.disable_segment_sharding(0), "sharded hot: the final demotion refused")
    _repack(oracle, 0)
    rows, latch = _fleets_differ(hot, oracle)
    check(rows == 0 and latch == 0, f"sharded hot: {rows} rows / {latch} latches differ")
    check(hot.error_count() == 0 and not hot.overflow, "sharded hot: latched or overflowed")
    h = hot.health()
    out.update({
        "moves": moves, "seg_promotions": h["seg_promotions"],
        "seg_demotions": h["seg_demotions"], "seg_rebalances": h["seg_rebalances"],
        "doc_migrations": h["doc_migrations"], "lane_rows": lane_rows, "lane_s": lane_s,
        "lane_rows_per_s": lane_rows / lane_s if lane_s else None,
        "k6_n4": timing, "identical_docs": 1 + n_cold,
    })
    return out


def _sharded_tree(seed: int, card: str, device: str, churn, spare: int = 16,
                  n_migrate: int = 8) -> dict:
    """Part (d): tree_churn's stream through ``ingest_lines`` into a
    ``TreeBatchEngine`` on a 4-shard mesh with ``spare`` spare slots; 8 docs
    migrate mid-stream (rows staged); every doc equals the tree_churn
    engine's (the moved docs' views and EditManager windows, every other
    doc's raw rows too)."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
    from fluidframework_tpu_torch.parallel.mesh import doc_mesh

    churn_eng, round_blobs = churn
    n = churn_eng.n_docs
    eng = TreeBatchEngine(n, mesh=doc_mesh([device] * 4), spare_slots=spare, **TREE_CHURN_GEOM)
    moved = sorted(int(d) for d in np.random.default_rng(seed + 16).choice(n, n_migrate,
                                                                            replace=False))
    mid = len(round_blobs) // 2
    migrate_ms = []
    t0 = time.perf_counter()
    for r, blobs in enumerate(round_blobs):
        for d, blob in enumerate(blobs):
            if blob:
                eng.ingest_lines(d, blob)
        if r == mid:
            for d in moved:
                t = time.perf_counter()
                check(eng.migrate_doc(d, (eng.shard_of(d) + 1) % eng.n_shards),
                      f"sharded tree: migrate_doc({d}) refused")
                migrate_ms.append((time.perf_counter() - t) * 1e3)
        eng.step()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(not eng.errors().any() and sorted(eng.fallbacks) == sorted(churn_eng.fallbacks),
          "sharded tree: error bits or fallbacks differ from tree_churn's")
    # A moved doc's trunk fold records the removed content in its
    # EditManager window's Remove marks (as a checkpoint sweep's fold does,
    # in both packages), so its summary is compared in its trees only.
    views = sum(
        json.dumps(eng.tree_json(d)) == json.dumps(churn_eng.tree_json(d))
        and json.dumps(eng.values(d)) == json.dumps(churn_eng.values(d)) for d in moved
    )
    rows = sum(_tree_docs_identical(eng, d, churn_eng, d) for d in range(n) if d not in moved)
    check(views == len(moved) and rows == n - len(moved),
          f"sharded tree: {len(moved) - views} moved, {n - len(moved) - rows} other docs differ")
    return {"docs": n, "n_shards": eng.n_shards, "spare_slots": spare, "migrated": moved,
            "migrate_ms": migrate_ms, "wall_s": wall,
            "doc_migrations": eng.counters.get("doc_migrations"), "identical_docs": n}


def _sharded_entry(device: str, traffic, n_docs: int = 256, rounds: int = 8,
                   geom: dict = FLEET_GEOM) -> dict:
    """Part (e): ``fleet_main --mesh 4 --spare-slots 16 --rebalance-every
    0.5 --seg-shards 2`` over ``n_docs`` docs.  Shard 0's docs' rounds
    arrive first (wave 0); once the process prints a ``migrations`` line
    the rest follows (wave 1).  Its ``done`` texts equal an in-process
    engine's fed the same bytes."""
    import queue
    import threading

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"m{d}" for d in range(n_docs)]
    per = -(-n_docs // 4)
    first = [[(d, m) for d, m in r if d < per] for r in rounds_msgs]
    rest = [[(d, m) for d, m in r if d >= per] for r in rounds_msgs]
    waves = _doc_waves(doc_ids, [joins] + first + rest,
                       [list(range(rounds + 1)), list(range(rounds + 1, 2 * rounds + 1))])
    n_rows = sum(len(r) for r in rounds_msgs)
    feeder = FirehoseFeeder(waves)
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.server.fleet_main",
           "--port", str(feeder.port), "--docs", ",".join(doc_ids), "--device", device,
           "--mesh", "4", "--spare-slots", "16", "--rebalance-every", "0.5",
           "--seg-shards", "2", "--capacity", str(geom["max_segments"]),
           "--text-capacity", str(geom["text_capacity"]),
           "--max-insert-len", str(geom["max_insert_len"]),
           "--ops-per-step", str(geom["ops_per_step"]),
           "--megastep-k", str(geom["megastep_k"]), "--status-every", "600",
           "--exit-after-rows", str(n_rows)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    lines: queue.Queue = queue.Queue()
    err = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    feeder.release(0)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=err, text=True, env=env,
                            cwd=repo)
    reader = threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    got: list[dict] = []

    def stderr_tail() -> str:
        err.seek(0)
        return err.read()[-1500:]

    try:
        deadline = time.monotonic() + 240
        while not any("migrations" in x for x in got):
            if time.monotonic() > deadline or proc.poll() is not None:
                check(False, f"entry: no migrations line (last {got[-1:]}): {stderr_tail()}")
            try:
                x = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if x.startswith("{"):
                got.append(json.loads(x))
        feeder.release(1)
        rc = proc.wait(timeout=240)
        reader.join(timeout=10)
        while not lines.empty():
            x = lines.get()
            if x.startswith("{"):
                got.append(json.loads(x))
        check(rc == 0, f"entry: fleet_main exited {rc}: {stderr_tail()}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        feeder.close()
        err.close()
    wall = time.perf_counter() - t0
    eng = DocBatchEngine(n_docs, device=device, **geom)
    for wave in waves:
        for d, doc in enumerate(doc_ids):
            if wave.get(doc):
                eng.ingest_lines(d, wave[doc])
        eng.step()
    done = got[-1]
    check(done.get("done") and done["errors"] == 0, "entry: fleet_main did not end clean")
    check(done["texts"] == {doc: eng.text(d) for d, doc in enumerate(doc_ids)},
          "entry: fleet_main's texts differ from the in-process engine's")
    migrations = [m for x in got if "migrations" in x for m in x["migrations"]]
    h = done["health"]
    check(h["n_shards"] == 4 and h["segment_shards"] == 2, "entry: not served on the 4-shard mesh")
    return {"docs": n_docs, "rounds": rounds, "rows": n_rows, "run_s": wall,
            "migrations": migrations, "doc_migrations": h["doc_migrations"],
            "n_shards": h["n_shards"], "segment_shards": h["segment_shards"]}


def phase_sharded(seed: int, card: str, device: str, traffic, churn, path=None, **sizes) -> dict:
    """Phase 15, the sharded fleet on ``device``: (a)+(b) ``_sharded_fleet``,
    (c) ``_sharded_hot``, (d) ``_sharded_tree``, (e) ``_sharded_entry``, one
    JSON line each (see the module docstring).  ``path(name, fn, ...)``
    runs each part as a main-path path of its own (launch counts);
    ``sizes`` cut each part for a rehearsal (``fleet=dict(...)``,
    ``hot=dict(...)``, ``entry=dict(...)``)."""
    path = path or (lambda _name, fn, *a, **k: fn(*a, **k))
    t_all = time.perf_counter()
    parts = (
        ("fleet", "sharded_fleet", lambda: _sharded_fleet(seed, card, device, traffic,
                                                          **sizes.get("fleet", {}))),
        ("hot", "sharded_hot", lambda: _sharded_hot(seed, card, device, traffic,
                                                    **sizes.get("hot", {}))),
        ("tree", "sharded_tree", lambda: _sharded_tree(seed, card, device, churn)),
        ("entry", "sharded_entry", lambda: _sharded_entry(device, traffic,
                                                          **sizes.get("entry", {}))),
    )
    out = {}
    for name, path_name, part in parts:
        t = time.perf_counter()
        line = path(path_name, part)
        line["part_s"] = time.perf_counter() - t
        emit({"phase": "sharded", "part": name, "card": card, **line})
        out[name] = line
        gc.collect()
    out["wall_s"] = time.perf_counter() - t_all
    emit({"phase": "sharded", "part": "total", "card": card, "wall_s": out["wall_s"]})
    return out


# ------------------------------------------------------ string client path

# Config 1's single document (``bench.py`` ``bench_config1``, four writers)
# as the client path holds it: one KernelMergeTree replica a client at the
# hot document's geometry; remove, prop and obliterate slots and the insert
# chunk stay the reference's defaults (4, 4, 8, 64).
STRING_CLIENT_GEOM = dict(max_segments=16_384, text_capacity=131_072)
STRING_CLIENT_KINDS = "koko"   # clients 0 and 2 on KernelMergeTree, 1 and 3 on RefMergeTree


class _StringClients:
    """Phase 16's document: four ``ContainerRuntime`` clients over one
    ``LocalService`` document, each holding a ``sharedString`` "s"."""

    def __init__(self, device: str, geom: dict):
        from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
        from fluidframework_tpu_torch.server.local_service import LocalService

        self.make_kernel = lambda: KernelMergeTree(**geom, device=device)
        self.doc = LocalService().document("phase16")
        self.clients = [self.container(f"C{i}", k) for i, k in enumerate(STRING_CLIENT_KINDS)]
        self.epoch = [0] * len(self.clients)
        self.doc.process_all()

    def container(self, name: str, kind: str, stash: str | None = None):
        from fluidframework_tpu_torch.dds import channels
        from fluidframework_tpu_torch.runtime import ContainerRuntime

        channels.set_string_backend_factory(self.make_kernel if kind == "k" else None)
        try:
            rt = ContainerRuntime(channels.default_registry(), container_id=name)
            rt.create_datastore("root").create_channel("sharedString", "s")
            rt.connect(self.doc, name, stash=stash)
        finally:
            channels.set_string_backend_factory(None)
        return rt

    def s(self, i: int):
        return self.clients[i].datastore("root").get_channel("s")

    def kernels(self) -> list:
        return [self.s(i).backend for i, k in enumerate(STRING_CLIENT_KINDS) if k == "k"]

    def act(self, action: tuple) -> None:
        kind, i, *rest = action
        rt = self.clients[i]
        if kind == "edit":
            _string_edit(self.s(i), rest[0])
        elif kind == "flush":
            rt.flush()
        elif kind == "sync":
            for c in self.clients:
                c.flush()
            self.doc.process_all()
        elif kind == "drop":
            rt.disconnect()
        elif kind == "rejoin":
            self.epoch[i] += 1
            rt.connect(self.doc, f"C{i}.r{self.epoch[i]}")
            self.doc.process_all()
        elif kind == "rehydrate":
            stash = rt.get_pending_local_state()
            rt.close()
            self.epoch[i] += 1
            self.clients[i] = self.container(f"C{i}.s{self.epoch[i]}", STRING_CLIENT_KINDS[i],
                                             stash=stash)
            self.doc.process_all()
        else:
            raise ValueError(kind)

    def views(self, i: int) -> tuple:
        return _string_views(self.s(i))

    def stream(self) -> list:
        return list(self.doc.sequencer.log)


def _string_views(s) -> tuple:
    """A string channel's text, resolved annotations and intervals."""
    return (s.text, json.dumps(s.annotations(), sort_keys=True),
            sorted(json.dumps(iv.to_json(), sort_keys=True)
                   for iv in s.get_interval_collection("f")))


def _gen_string_edit(rng, s) -> tuple:
    n = len(s.position_text())
    kind = rng.choices(["ins", "rem", "ann", "ob", "obs", "iv"], [42, 20, 12, 7, 4, 15])[0]
    if kind == "ins" or n == 0:
        return ("ins", rng.randint(0, n), rng.choice("abcdefgh") * rng.randint(1, 8))
    p1 = rng.randrange(n)
    p2 = rng.randint(p1 + 1, min(n, p1 + 8))
    if kind == "rem":
        return ("rem", p1, p2)
    if kind == "ann":
        return ("ann", p1, p2, rng.choice(["bold", "color"]), rng.choice([True, "red", 7]))
    if kind == "ob":
        return ("ob", p1, p2)
    if kind == "obs":
        c2 = rng.randint(p1, min(n - 1, p1 + 8))
        s1, s2 = rng.random() < 0.5, rng.random() < 0.5
        if p1 == c2 and not s1 and s2:
            s1 = True
        return ("obs", (p1, s1), (c2, s2))
    return ("iv", p1, rng.randint(p1, min(n - 1, p1 + 16)))


def _string_edit(s, op: tuple) -> None:
    kind, *a = op
    if kind == "ins":
        s.insert_text(*a)
    elif kind == "rem":
        s.remove_range(*a)
    elif kind == "ann":
        s.annotate_range(*a)
    elif kind == "ob":
        s.obliterate_range(*a)
    elif kind == "obs":
        s.obliterate_range_sided(*a)
    else:
        s.get_interval_collection("f").add(*a)


def _string_client_run(device: str, geom: dict, seed: int, n_edits: int,
                       reconnect_every: int, script=None, sink=None, fleet=None) -> dict:
    """One run of phase 16's script.  With ``script`` None the seeded
    script is made as it runs (from the acting client's view), each action
    passed to ``sink`` as it is taken (and None at the end); otherwise the
    actions of ``script`` (any iterable) are replayed one by one.  Every
    sync checks that the four clients' texts, resolved annotations and
    intervals are equal.  ``fleet``: the four clients (phase 16's
    ``_StringClients`` when None; phase 18 passes its loader containers)."""
    import random

    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    fleet = _StringClients(device, geom) if fleet is None else fleet
    rng = random.Random(seed)
    record = script is None
    taken: list = []
    edits = syncs = peak_nseg = 0
    t0 = time.perf_counter()

    def run(action):
        nonlocal edits, syncs, peak_nseg
        taken.append(action)
        if record and sink is not None:
            sink(action)
        fleet.act(action)
        if action[0] == "edit":
            edits += 1
        if action[0] == "sync":
            syncs += 1
            views = [fleet.views(i) for i in range(len(fleet.clients))]
            check(all(v == views[0] for v in views[1:]),
                  f"string_client ({device}): the clients diverged at sync {syncs}")
            peak_nseg = max([peak_nseg] + [int(k.state.nseg) for k in fleet.kernels()])

    if record:
        stash_round = (n_edits // 12) // 2
        r = 0
        while edits < n_edits:
            for i in rng.sample(range(4), 4):
                for _ in range(rng.randint(1, 3)):
                    run(("edit", i, _gen_string_edit(rng, fleet.s(i))))
                run(("flush", i))
            if r % reconnect_every == reconnect_every - 1 or r == stash_round:
                # A kernel client drops with its pending ops, edits offline
                # and comes back (or rehydrates its stash): its pending ops
                # regenerate through K5 against everything sequenced since.
                j = 2 * ((r // reconnect_every) % 2)
                run(("drop", j))
                for _ in range(rng.randint(1, 3)):
                    run(("edit", j, _gen_string_edit(rng, fleet.s(j))))
                run(("rehydrate" if r == stash_round else "rejoin", j))
            run(("sync", 0))
            r += 1
        if sink is not None:
            sink(None)
    else:
        for action in script:
            run(action)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kernels = fleet.kernels()
    return {
        "edits": edits, "syncs": syncs, "seconds": seconds,
        "edits_per_s": edits / seconds, "peak_nseg": peak_nseg,
        "regenerated": sum(k.regenerated for k in kernels),
        "rehydrated": sum(1 for a in taken if a[0] == "rehydrate"),
        "reconnects": sum(1 for a in taken if a[0] == "rejoin"),
        "states": [[x.cpu().numpy() for x in mk.leaves(k.state)] for k in kernels],
        "errors": [k.check_errors() for k in kernels],
        "summaries": [json.dumps(k.export_summary(), sort_keys=True) for k in kernels],
        "stream": [dict(json.loads(m.to_json()), timestamp=0) for m in fleet.stream()],
        "text": fleet.s(0).text, "kernels": kernels,
    }


def _string_client_replay_main(conn, geom: dict, seed: int, n_edits: int,
                               reconnect_every: int) -> None:
    """Phase 16's CPU run in its own process: replays the actions the card
    run sends as it takes them, then sends back its result.  Four intra-op
    threads, to leave the host's other cores to the card run."""
    import torch

    torch.set_num_threads(4)
    try:
        out = _string_client_run("cpu", geom, seed, n_edits, reconnect_every,
                                 script=iter(conn.recv, None))
        out.pop("kernels")
        conn.send(out)
    except Exception:  # the parent reports it and fails the phase
        import traceback

        conn.send({"error": traceback.format_exc()})
    finally:
        conn.close()


def _squash_regeneration(device: str, geom: dict, summary: dict, last_seq: int,
                         seed: int) -> tuple:
    """Reconnect regeneration with squash on one replica restored from the
    document's summary (the runtime never asks for squash, as the
    reference's does not; ``KernelMergeTree.regenerate_pending`` is the
    entry the channel's squash resubmit calls): pending inserts, pending
    removes over half of them (squashed pairs: ``drop_squashed``), pending
    annotates, and a pending obliterate whose range a concurrent remote
    remove takes (retired: ``strip_stamp``).  Returns the re-minted ops and
    the replica."""
    import random

    from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
    from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED, LOCAL_BASE

    rng = random.Random(seed)
    kmt = KernelMergeTree(**geom, device=device)
    kmt.import_summary(summary)
    me = kmt.local_client
    ls = 0

    def local(name, *args):
        nonlocal ls
        ls += 1
        getattr(kmt, name)(*args, LOCAL_BASE + ls, me, ALL_ACKED)

    # The obliterate goes first, while the local view is the acked one, so
    # the remote remove (which sees no pending op) lands on its range.
    p = rng.randint(8, kmt.visible_length() - 8)
    local("apply_obliterate", p, 0, p + 3, 1)
    kmt.apply_remove(p - 2, p + 6, last_seq + 1, 0, last_seq)
    for _ in range(16):
        p = rng.randint(0, kmt.visible_length())
        local("apply_insert", p, "sq" * rng.randint(1, 4))
        if rng.random() < 0.5:
            local("apply_remove", p, p + 2)
        if rng.random() < 0.3:
            local("apply_annotate", max(p - 3, 0), p + 1, 0, 5)
    fresh = iter(range(ls + 1, ls + 10_000)).__next__
    plans = [kmt.regenerate_pending(i, fresh, squash=True) for i in range(1, ls + 1)]
    return plans, kmt


def _time_one_doc_programs(card: str, kmt) -> dict:
    """The one-doc programs of the client path timed alone on a kernel
    replica's final state (S=16,384): ``apply_op`` (one insert), K3
    (``set_min_seq`` + ``compact``), and K5 (``restamp`` of every class,
    ``drop_squashed``, ``strip_stamp``); each result held against the
    same call on the CPU; bytes bounds at 3.35 TB/s.  Called outside the
    path: its launches are not the path's."""
    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    s = kmt.state
    S = s.seg_len.shape[0]
    host = mk.from_numpy(mk.to_numpy(s), device="cpu")
    n = kmt.visible_length()
    op, payload = mk.encode_insert(n // 2, "timing", 1 << 29, 1, 1 << 28, kmt.max_insert_len)[0]
    mask = (torch.arange(S) % 3 == 0).numpy()
    key = int(mk.to_numpy(s).ins_key[0])
    ob_flag = bool((s.ob_key >= 0).any())  # the gate as the path decides it: on the host
    per_seg = [s.seg_start, s.seg_len, s.ins_key, s.ins_client, s.seg_uid, s.seg_obpre,
               *s.rem_keys, *s.rem_clients, *s.prop_keys, *s.prop_vals]
    restamp_cols = [s.ins_key, s.ins_client, *s.rem_keys, *s.rem_clients, *s.prop_keys,
                    s.seg_obpre, s.ob_key, s.ob_client]
    ob_cols = [s.ob_key, s.ob_start_uid, s.ob_end_uid]
    progs = {
        "apply_op": (lambda st: mk.apply_op(st, op, payload, ob_flag=ob_flag),
                     2 * nbytes_of(mk.leaves(s)) + op.nbytes + payload.nbytes),
        "compact": (lambda st: mk.doc_row(mk.compact(
            mk.set_min_seq(mk.one_doc_batch(st), [int(st.min_seq) + 1])), 0),
            2 * nbytes_of(per_seg) + nbytes_of(ob_cols)),
        "restamp": (lambda st: mk.restamp(st, mask, key, key + 1, 3, True, True, True, True),
                    2 * nbytes_of(restamp_cols) + mask.nbytes),
        "drop_squashed": (mk.drop_squashed, 2 * nbytes_of(per_seg) + nbytes_of(ob_cols)),
        "strip_stamp": (lambda st: mk.strip_stamp(st, key),
                        2 * nbytes_of([*s.rem_keys, *s.rem_clients, s.ob_key])),
    }
    out = {}
    for name, (fn, nbytes) in progs.items():
        want = [x.numpy() for x in mk.leaves(fn(host))]
        got = [x.cpu().numpy() for x in mk.leaves(fn(s))]
        err = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max(initial=0))
                  for a, b in zip(got, want))
        check(err == 0, f"{name} on the card disagrees with the CPU")
        out[name] = {"S": S, "ms": cuda_ms(lambda: fn(s), 20, warmup=1), "max_abs_err": err,
                     "bound_bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                     "bound_by": "bytes"}
    # Device times after every call time: the profiler's session leaves
    # later launches dearer on the host.
    for name, (fn, _nbytes) in progs.items():
        out[name]["device_ms"] = _device_sum(device_ms_by_name(lambda: fn(s), 10))
    emit({"phase": "string_client_programs", "card": card, **out})
    return out


def phase_string_client(seed: int, card: str, device: str = "cuda", geom: dict | None = None,
                        n_edits: int = 4000, reconnect_every: int = 6, path=None) -> tuple:
    """Phase 16: the SharedString client path (``ContainerRuntime`` +
    ``LocalService`` + ``SharedStringChannel``), two ``KernelMergeTree``
    replicas on ``device`` and two ``RefMergeTree`` ones, a seeded script
    of ``n_edits`` edits with reconnects and one stash; then the same
    script with the kernel replicas on the CPU: every kernel replica's raw
    state, error latch and summary identical between the runs; and the
    squash regeneration on one replica restored from the summary, held
    against the CPU.  The client run and the squash regeneration are paths
    of their own through ``path`` (``string_client``, ``string_squash``):
    the runtime never asks for squash.  The CPU run replays the card run's
    actions in a process of its own, alongside, and runs on past the card
    run while later phases use the card.  Returns ``finish`` (waits for the CPU run,
    holds the two runs against each other and prints the line) and a
    kernel replica on ``device`` (``_time_one_doc_programs`` times the
    one-doc programs on its state)."""
    import multiprocessing

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    geom = dict(STRING_CLIENT_GEOM if geom is None else geom)
    t0 = time.perf_counter()
    # The CPU run replays the card run's actions in its own process as they
    # are taken, so the two runs share the wall clock.
    ctx = multiprocessing.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_string_client_replay_main,
                       args=(child, geom, seed, n_edits, reconnect_every), daemon=True)
    proc.start()
    child.close()

    def stop():
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()

    run = path if path is not None else (lambda _name, fn, *a, **kw: fn(*a, **kw))
    try:
        card_run = run("string_client", _string_client_run, device, geom, seed, n_edits,
                       reconnect_every, sink=parent.send)
        check(card_run["regenerated"] > 0 and card_run["rehydrated"] == 1,
              "string_client: no op was regenerated, or the stash never rehydrated")
        summary = json.loads(card_run["summaries"][0])
        last_seq = card_run["stream"][-1]["sequenceNumber"]
        plans, sq = run("string_squash", _squash_regeneration, device, geom, summary, last_seq,
                        seed)
        cpu_plans, sq_cpu = _squash_regeneration("cpu", geom, summary, last_seq, seed)
        check(plans == cpu_plans and all(
            np.array_equal(x.cpu().numpy(), y.numpy())
            for x, y in zip(mk.leaves(sq.state), mk.leaves(sq_cpu.state))),
            "string_client: squash regeneration differs between the card and the CPU")
        check(not plans[0], "string_client: the pending obliterate was not retired")
    except BaseException:
        proc.kill()
        raise
    card_s = time.perf_counter() - t0

    def finish() -> dict:
        t1 = time.perf_counter()
        try:
            cpu_run = parent.recv()
        finally:
            stop()
        wait_s = time.perf_counter() - t1
        check("error" not in cpu_run, f"string_client: the CPU run failed: {cpu_run.get('error')}")
        check(card_run["errors"] == cpu_run["errors"] == [0, 0],
              f"string_client: error latches {card_run['errors']} / {cpu_run['errors']}")
        for k, (a, b) in enumerate(zip(card_run["states"], cpu_run["states"])):
            check(all(np.array_equal(x, y) for x, y in zip(a, b)),
                  f"string_client: kernel replica {k}'s state differs between {device} and the CPU")
        check(card_run["summaries"] == cpu_run["summaries"],
              "string_client: kernel summaries differ between the card and the CPU")
        check(card_run["stream"] == cpu_run["stream"] and card_run["text"] == cpu_run["text"],
              "string_client: the sequenced streams differ between the card and the CPU")
        line = {
            "phase": "string_client", "card": card, "clients": STRING_CLIENT_KINDS,
            "geometry": geom, "edits": card_run["edits"], "syncs": card_run["syncs"],
            "reconnects": card_run["reconnects"], "stash_rehydrations": card_run["rehydrated"],
            "regenerated_ops": card_run["regenerated"], "peak_nseg": card_run["peak_nseg"],
            "text_len": len(card_run["text"]), "sequenced": len(card_run["stream"]),
            "edits_per_s": card_run["edits_per_s"], "cpu_edits_per_s": cpu_run["edits_per_s"],
            "run_s": card_run["seconds"], "cpu_run_s": cpu_run["seconds"],
            "squash_plans": len(plans), "identical_to_cpu": True,
            # The card leg (run and squash legs), and the wait for the CPU
            # run after the phases that ran meanwhile.
            "phase_s": card_s, "cpu_wait_s": wait_s,
        }
        emit(line)
        return line

    return finish, card_run["kernels"][0]


# ------------------------------------------------ phase 17: dds clients

# Phase 17's sizes, as main() runs them: (a) config 5's per-doc shape over
# 16 docs of 4 rounds, (b) config 4's matrix, (c) config 2's map, (d) K11 at
# the shapes of its users.  The tree leg's own size is 64 docs of 8 rounds
# (160.2 s alone on an H100 80GB HBM3 at 700 W, over the phase's 150 s cap;
# its clients took 117.5 s of it): its rounds are cut to 4, the least that
# holds writer 3's offline round and rejoin (rounds 1 and 3), then its docs
# to 16, so the whole script keeps inside its 1,200 s limit.
DDS_TREE = dict(n_docs=16, rounds=4, writers=4, edits=8, sample=8)
DDS_REDUCED = {"tree": {"n_docs": "16 (of 64)", "rounds": "4 (of 8)"}}
DDS_MATRIX = dict(writers=64, steps=16, ops=64, seeded=128)
DDS_MAP = dict(writers=4, keys=256, batches=64, ops=256)
DDS_K11 = dict(rebase_b=4096, rebase_m=64, sets_docs=1024, sets_n=2048, sets_b=32,
               forest_n=2048, forest_b=32, forest_docs=1024)
DDS_CAP_S = 150.0

# The earlier phases main() runs below their sizes to keep the whole script
# inside its 1,200 s limit (uncut, with phase 17 at 6 rounds of 64 docs:
# 1,286.4 s on an H100 80GB HBM3 at 700 W).  Each cut is one the phase lines
# show buys time: tree_fleet's timed parts took 103.0 s at 1,024 docs and
# 51.1 s at 512 (the phase 83.2 s at 512 with phase 19 on a slow host, so
# 256 now); tree_rebase 72.0 s at 128 fleet docs and 41.1 s at 64.
# With phase 19 (74.5 s) and the cuts before it the script took 1,103.2 s,
# so the serving phase's scribe runs 32 docs a family (its part 20.8 s,
# against 32.6-34.9 s at 64), tree_rebase 64 fleet docs, and phase 16 2,000
# of its 4,000 edits (its card run took 81.9 s at 4,000).  The recovery
# phase keeps its 16 rounds: at 8 it took 197.9 s, at 16 191.8 s in one run
# (its time goes to per-doc work over the 10,000 docs, not to rounds; again
# with phases 20 and 21 on an H100: 154.9 s at 8 rounds, run first, and
# 146.9 s at 16 in the same process).  Phases 20 and 21 add about 60 s (24.7
# s, its ring 4.2 s, and 35.6 s alone on the card), so tree_rebase runs 32
# fleet docs (41.1 s of timed parts at 64, 72.0 s at 128: about 0.48 s a
# doc) and tree_programs times K7's two routes at 2 of its 4 shares (each
# share is 4 timed turns with a profiler session each).  With those the
# script took 1,040.1 s on an H100 whose host ran the fleet turns 50% slower
# than the 914.1 s run's, so the recovery phase runs the traffic's first
# 5,000 of its 10,000 docs: of its 185.3 s there, 140.3 s were per-doc parts
# over the 10,000 (rounds 55.6, checkpoint and restore 46.6, the
# restored-doc check 21.1, the rounds after the restore 17.0: ``parts_s``).
# Phase 24 (the rank mesh) took 108.5 s alone on one H100 80GB HBM3 at 700 W
# with 40 hot rounds, two K6 calls and a profiler session a K2 turn, and
# 106.7 s in a whole run of 1,320 s on a slower host, so it runs 8 hot rounds,
# one K6 call and one profiler session a rank.  To pay for it the recovery
# phase runs the traffic's first 2,500 docs (137.0 s at 5,000 in a whole run
# of 1,024.3 s; 151.1 s at 2,500 on the slower host, 35.0 s of it the CPU
# replay of the faulted and sampled docs) and replays 32 sampled docs of 64,
# phase 15's fleet part its three checked turns without the three timing
# turns (25.5 s before, 14.2 s after; the rank mesh now carries the fleet
# across shards), and the serving phase's fleet_main entry 128 docs of 256
# (39.5 s at 256 on the slower host).  The whole script then took 942.9 s
# on an H100 80GB HBM3 at 700 W whose host ran it about 1.4 times faster
# than the slower host's 1,326.5 s, too close to the limit there, so the
# recovery phase runs 1,000 docs with 16 sampled (at 2,500 its per-doc
# parts took 74.2 s of 109.2 s), the serving phase's scribe 16 docs a
# family and its entry 64 docs (21.8 s and 28.1 s at 32 and 128), phase 16
# 1,000 edits (its card run 32.0 s at 2,000), and phase 24 times its
# collectives over 50 calls (of 200).  With those the script took 907.7 s
# (the recovery phase 92.8 s: its rounds, 45.7 s, are the faulted docs'
# grow replays and do not shrink with the docs), so phase 19's soak runs
# 120 of its 240 ticks (every fault kind still fires twice; the soak took
# 55.6 s at 240), phase 16 500 edits (17.6 s at 1,000) and phase 18's
# client leg 500 (``NET_REDUCED``; 21.3 s at 1,000).
# Printed in the ``cuts`` line.
CUTS = {
    # of 10,000 docs, of 64 sampled, of 20 faulted (the rounds are their replays)
    "recovery": {"n_docs": 1000, "sample": 16, "faulted": 10},
    "sharded": {"fleet": {"turns": 3}},    # of 6: the checked turns, no timing turns
    "tree_fleet": {"n_docs": 256},         # of 1,024 (time_tree_programs' ring too)
    "tree_rebase": {"fleet_docs": 32},     # of 256
    "tree_programs": {"shares": (1 / 16, 1)},  # of (1/16, 1/4, 1/2, 1)
    # scribe of (64, 64, 64, 4): strings, trees, maps, matrices; entry of 256
    "serving": {"scribe_docs": (16, 16, 16, 4), "entry_docs": 64},
    "string_client": {"n_edits": 500},     # of 4,000
    "chaos": {"ticks": 120},               # of the reference soak's 240
}
# K11's public programs and the reference lines they replace.
K11_PROGRAMS = {"rebase_insert_positions": 86, "rebase_node_positions": 111,
                "apply_value_sets": 150, "apply_value_sets_fleet": 177,
                "apply_forest_op": 238, "apply_forest_ops": 317, "apply_forest_ops_fleet": 317}


@contextlib.contextmanager
def _seeded_sessions(seed: int):
    """Every ``IdCompressor`` made inside draws its session id from one
    generator seeded with ``seed`` (``create_session_id`` patched in the
    port's module), so a run's wire bytes repeat."""
    import random
    import uuid

    from fluidframework_tpu_torch.utils import id_compressor

    rng = random.Random(seed)
    saved = id_compressor.create_session_id
    id_compressor.create_session_id = lambda: str(uuid.UUID(int=rng.getrandbits(128), version=4))
    try:
        yield
    finally:
        id_compressor.create_session_id = saved


def _dds_tree_clients(seed: int, n_docs: int, rounds: int, writers: int, edits: int) -> dict:
    """Part (a)'s clients: per doc ``writers`` ``ContainerRuntime``s with a
    ``sharedTree`` channel over one ``LocalService``.  Config 5's shape
    under one root array node (so the typed view can hold it): one
    sub-array a writer plus one shared, each starting with one leaf.  A
    round: each writer makes ``edits`` edits with its ref_seq at the round
    start (even ones insert at 0 of the shared array, odd ones set or
    insert in its own; 40% of the leaves strings of 3-10 chars) and
    flushes; then the round is sequenced.  Writer 0 initializes the doc
    through a typed view (the schema op) and forks once, edits the branch
    and merges it; writer 1 makes one typed-view edit a round, and once
    captures an edit in an ``UndoRedoStackManager``, undone the next round
    and redone the round after; writer 2 wraps two edits a round in a
    transaction; writer 3 goes offline every fourth round, edits, and
    rejoins two rounds later (its parked ops resubmit).  After the last
    round a late client per doc loads from writer 1's ``summary_tree``.
    Returns the clients, each doc's log and its round boundaries."""
    from fluidframework_tpu_torch.dds.channels import default_registry
    from fluidframework_tpu_torch.dds.tree.changeset import make_insert, make_set_value
    from fluidframework_tpu_torch.dds.tree.schema import leaf
    from fluidframework_tpu_torch.dds.tree.simple_tree import SchemaFactory, TreeViewConfiguration
    from fluidframework_tpu_torch.framework import UndoRedoStackManager
    from fluidframework_tpu_torch.runtime import ContainerRuntime
    from fluidframework_tpu_torch.runtime.summary import materialize
    from fluidframework_tpu_torch.server.local_service import LocalService

    rng = np.random.default_rng(seed + 61)
    sf = SchemaFactory("")
    Sub = sf.array("sub", sf.number, sf.string)
    Doc = sf.array("doc", Sub)
    config = TreeViewConfiguration(Doc)
    W = writers
    svc = LocalService()
    tree = lambda rt: rt.datastore("root").get_channel("t")

    def value():
        if rng.random() < 0.4:
            return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(rng.integers(3, 11))))
        return int(rng.integers(1000))

    def size(t, w):  # the writer's local view of sub-array w
        return len(t.forest.root_field[0].fields[""][w].fields.get("", []))

    def own_edit(t, w, k):
        sub = [("", 0), ("", w)]
        if k % 2 == 0:
            return make_insert([("", 0), ("", W)], "", 0, [leaf(value())])
        n = size(t, w)
        if n and rng.random() < 0.5:
            return make_set_value(sub + [("", int(rng.integers(n)))], value())
        return make_insert(sub, "", int(rng.integers(n + 1)), [leaf(value())])

    docs, t0 = [], time.perf_counter()
    counts = {"edits": 0, "typed": 0, "transactions": 0, "forks": 0, "undo": 0, "redo": 0,
              "offline_rounds": 0, "rejoins": 0}
    for d in range(n_docs):
        doc = svc.document(f"t{d}")
        rts = []
        for w in range(W):
            rt = ContainerRuntime(default_registry(), container_id=f"t{d}w{w}")
            rt.create_datastore("root").create_channel("sharedTree", "t")
            rt.connect(doc, f"t{d}w{w}")
            rts.append(rt)
        doc.process_all()
        views = [tree(rt).typed_view(config) for rt in rts]
        views[0].initialize(Doc([Sub([0]) for _ in range(W + 1)]))
        rts[0].flush()
        doc.process_all()
        docs.append({"doc": doc, "rts": rts, "views": views, "ur": UndoRedoStackManager(),
                     "bounds": [len(doc.sequencer.log)], "epoch": 0, "offline": False})
    capture_round = lambda d: d % max(1, rounds - 2)
    for r in range(rounds):
        for d, x in enumerate(docs):
            rts, doc = x["rts"], x["doc"]
            if x["offline"] and r % 4 == 3:
                x["epoch"] += 1
                rts[3].connect(doc, f"t{d}w3.{x['epoch']}")
                x["offline"] = False
                counts["rejoins"] += 1
            for w, rt in enumerate(rts):
                t = tree(rt)
                for k in range(edits):
                    if w == 2 and k == 1:
                        continue  # made inside the transaction at k == 0
                    change = own_edit(t, w, k)
                    if w == 1 and k == 1 and r == capture_round(d):
                        x["ur"].capture_tree_change(t, change)
                        x["ur"].close_current_operation()
                    elif w == 2 and k == 0:
                        with t.transaction():
                            t.submit_change(change)
                            t.submit_change(own_edit(t, w, 1))
                        counts["transactions"] += 1
                        counts["edits"] += 1
                    else:
                        t.submit_change(change)
                    counts["edits"] += 1
                if w == 0 and r == d % rounds:
                    br = t.fork()
                    br.submit_change(own_edit(br, 0, 1))
                    br.submit_change(own_edit(br, 0, 2))
                    br.merge_into_parent()
                    counts["forks"] += 1
                    counts["edits"] += 2
                if w == 1:
                    x["views"][1].root[1].insert_at_end(value())
                    counts["typed"] += 1
                    counts["edits"] += 1
                    if r == capture_round(d) + 1:
                        counts["undo"] += x["ur"].undo()
                    elif r == capture_round(d) + 2:
                        counts["redo"] += x["ur"].redo()
                rt.flush()
            if r % 4 == 1 and not x["offline"]:
                rts[3].disconnect()
                x["offline"] = True
                counts["offline_rounds"] += 1
            doc.process_all()
            x["bounds"].append(len(doc.sequencer.log))
    for d, x in enumerate(docs):
        rts, doc = x["rts"], x["doc"]
        if x["offline"]:
            x["epoch"] += 1
            rts[3].connect(doc, f"t{d}w3.{x['epoch']}")
            counts["rejoins"] += 1
        for rt in rts:
            rt.flush()
        doc.process_all()
        x["bounds"][-1] = len(doc.sequencer.log)
    run_s = time.perf_counter() - t0
    t = time.perf_counter()
    for d, x in enumerate(docs):
        late = ContainerRuntime(default_registry(), container_id=f"t{d}late")
        late.load_snapshot(materialize(x["rts"][1].build_summary_tree(), None))
        late.connect(x["doc"], f"t{d}late")
        x["doc"].process_all()
        x["late"] = late
    late_s = time.perf_counter() - t
    for x in docs:
        jsons = {json.dumps([n.to_json() for n in tree(rt).forest.root_field], sort_keys=True)
                 for rt in x["rts"] + [x["late"]]}
        check(len(jsons) == 1, "dds_clients: the tree clients of a doc diverged")
        x["json"] = jsons.pop()
    return {"docs": docs, "counts": counts, "run_s": run_s, "late_s": late_s}


def _dds_tree(seed: int, card: str, device: str, n_docs: int, rounds: int, writers: int,
              edits: int, sample: int) -> dict:
    """Part (a): the clients' logs through ``TreeBatchEngine`` on ``device``
    round by round (a step after each), once with the host fold and once
    with ``device_rebase=True``; every doc's ``tree_json`` equals the
    clients' forest JSON (type-strict, as JSON text); ``sample`` docs'
    raw columns, views and EditManager summaries equal a CPU engine's."""
    import torch

    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    on_card = device == "cuda"
    with _seeded_sessions(seed):
        c = _dds_tree_clients(seed, n_docs, rounds, writers, edits)
    docs = c["docs"]
    rounds_msgs = [[(d, m) for d, x in enumerate(docs)
                    for m in x["doc"].sequencer.log[x["bounds"][r]:x["bounds"][r + 1]]]
                   for r in range(len(docs[0]["bounds"]) - 1)]
    rounds_msgs.insert(0, [(d, m) for d, x in enumerate(docs)
                           for m in x["doc"].sequencer.log[:x["bounds"][0]]])
    pick = np.random.default_rng(seed + 62).choice(n_docs, size=min(sample, n_docs),
                                                   replace=False)
    local_docs = sorted(int(d) for d in pick)
    runs = {}
    for rebase in (False, True):
        eng = TreeBatchEngine(n_docs, device=device, device_rebase=rebase, **TREE_FLEET_GEOM)
        run = _drive_tree(eng, rounds_msgs, on_card=on_card)
        check(not eng.errors().any(), f"dds_clients: tree error bits (device_rebase={rebase})")
        same = sum(json.dumps(eng.tree_json(d), sort_keys=True) == docs[d]["json"]
                   for d in range(n_docs))
        check(same == n_docs, f"dds_clients: {n_docs - same} tree docs differ from their "
                              f"clients (device_rebase={rebase})")
        runs[rebase] = (eng, run)
    ref, local, replay_s = _tree_replay(TREE_FLEET_GEOM, rounds_msgs, local_docs)
    for rebase, (eng, _run) in runs.items():
        same = sum(_tree_docs_identical(eng, d, ref, local[d]) for d in local_docs)
        check(same == len(local_docs), f"dds_clients: {len(local_docs) - same} sampled tree "
                                       f"docs differ from the CPU replay (device_rebase={rebase})")
    eng, run = runs[False]
    reng, rrun = runs[True]
    edits_n = c["counts"]["edits"]
    return {
        "docs": n_docs, "rounds": rounds, "writers": writers, "edits_per_writer": edits,
        **c["counts"], "messages": run["edits"],
        "clients_s": c["run_s"], "clients_edits_per_s": edits_n / c["run_s"],
        "late_join_s": c["late_s"],
        "engine_s": run["ingest_s"] + run["step_s"],
        "engine_edits_per_s": edits_n / (run["ingest_s"] + run["step_s"]),
        "engine_ingest_s": run["ingest_s"], "engine_step_s": run["step_s"],
        "rebase_engine_s": rrun["ingest_s"] + rrun["step_s"],
        "rebase_engine_edits_per_s": edits_n / (rrun["ingest_s"] + rrun["step_s"]),
        "fallback_docs": sorted(eng.fallbacks), "rebase_fallback_docs": sorted(reng.fallbacks),
        "device_fraction": eng.device_fraction(),
        "rebase_device_fraction": reng.device_fraction(),
        "device_rebase_fraction": reng.health().get("device_rebase_fraction"),
        "replayed_docs": len(local_docs), "cpu_replay_s": replay_s,
        "clients_equal_engines": n_docs,
    }


def _pump(doc, clients) -> None:
    moved = True
    while moved:
        moved = False
        for c in clients:
            for m in c.take_outbox():
                doc.submit(m)
                moved = True
        if doc.pending_count:
            doc.process_all()
            moved = True


def _dds_matrix(seed: int, device: str, writers: int, steps: int, ops: int,
                seeded: int) -> dict:
    """Part (b): ``writers`` ``SharedMatrix`` clients on one
    ``LocalDocument`` (config 4): writer 0 seeds ``seeded`` rows and
    columns, then ``steps`` steps of ``ops`` ops at the step's ref_seq —
    cell sets from every writer and two of writer 0's row or column
    inserts and removes — sequenced at the step's end.  The log feeds the
    scribe's matrix family on ``device`` (K10 in batches of 16), a flush a
    step; every cell equals every client's."""
    from fluidframework_tpu_torch.dds.shared_matrix import SharedMatrix
    from fluidframework_tpu_torch.server.local_service import LocalDocument
    from fluidframework_tpu_torch.server.scribe import ScribeConfig, _make_doc

    rng = np.random.default_rng(seed + 63)
    doc = LocalDocument("matrix")
    ms = [SharedMatrix(client_id=f"w{i}") for i in range(writers)]
    for m in ms:
        doc.connect(m.client_id, m.process)
    doc.process_all()
    t0 = time.perf_counter()
    ms[0].insert_rows(0, seeded)
    ms[0].insert_cols(0, seeded)
    _pump(doc, ms)
    bounds = [0, len(doc.sequencer.log)]
    structural = 0
    for s in range(steps):
        for b in range(ops):
            if b in (0, ops // 2):
                m, rows_axis = ms[0], (s + b) % 2 == 0
                n = m.row_count if rows_axis else m.col_count
                if (s // 2 + b) % 2 == 0:
                    (m.insert_rows if rows_axis else m.insert_cols)(int(rng.integers(0, n + 1)), 1)
                else:
                    (m.remove_rows if rows_axis else m.remove_cols)(int(rng.integers(0, n)), 1)
                structural += 1
            else:
                m = ms[b % writers]
                m.set_cell(int(rng.integers(0, m.row_count)), int(rng.integers(0, m.col_count)),
                           int(rng.integers(0, 1 << 20)))
        _pump(doc, ms)
        bounds.append(len(doc.sequencer.log))
    clients_s = time.perf_counter() - t0
    grids = [m.to_grid() for m in ms]
    check(all(g == grids[0] for g in grids), "dds_clients: the matrix clients diverged")
    cfg = ScribeConfig(matrix_shape=(MATRIX_GEOM["max_rows"], MATRIX_GEOM["max_cols"]),
                       matrix_segments=MATRIX_GEOM["max_segments"])
    sc = _make_doc("matrix_batch", cfg, device)
    log = doc.sequencer.log
    t = time.perf_counter()
    for a, b in zip(bounds, bounds[1:]):
        for msg in log[a:b]:
            sc.apply(msg)
        sc.flush()
    scribe_s = time.perf_counter() - t
    check(sc.failed is None, f"dds_clients: the matrix scribe failed: {sc.failed}")
    check(sc.grid() == grids[0], "dds_clients: the matrix scribe's cells differ from the clients'")
    n_ops = steps * ops
    return {"writers": writers, "steps": steps, "ops": n_ops, "structural": structural,
            "rows": ms[0].row_count, "cols": ms[0].col_count,
            "clients_s": clients_s, "clients_ops_per_s": n_ops / clients_s,
            "scribe_s": scribe_s, "scribe_ops_per_s": n_ops / scribe_s,
            "cells_equal": True}


def _dds_map(seed: int, device: str, writers: int, keys: int, batches: int, ops: int) -> dict:
    """Part (c): ``writers`` ``SharedMap`` clients on one ``LocalDocument``
    (config 2): ``batches`` batches of ``ops`` SET and DELETE ops over
    ``keys`` keys, from the writers in turn, a CLEAR from writer 0
    halfway; each batch sequenced at its end.  The log feeds the scribe's
    map family on ``device`` (K10 in batches of 16), a flush a batch; every
    key equals every client's."""
    from fluidframework_tpu_torch.dds.shared_map import SharedMap
    from fluidframework_tpu_torch.server.local_service import LocalDocument
    from fluidframework_tpu_torch.server.scribe import ScribeConfig, _make_doc

    rng = np.random.default_rng(seed + 64)
    doc = LocalDocument("map")
    maps = [SharedMap(client_id=f"m{i}") for i in range(writers)]
    for m in maps:
        doc.connect(m.client_id, m.process)
    doc.process_all()
    bounds = [len(doc.sequencer.log)]
    t0 = time.perf_counter()
    for i in range(batches):
        if i == batches // 2:
            maps[0].clear()
        kinds = rng.integers(1, 3, ops)
        ks = rng.integers(0, keys, ops)
        vals = rng.integers(0, 1 << 20, ops)
        for b in range(ops):
            m = maps[b % writers]
            if kinds[b] == 1:
                m.set(f"k{ks[b]}", int(vals[b]))
            else:
                m.delete(f"k{ks[b]}")
        _pump(doc, maps)
        bounds.append(len(doc.sequencer.log))
    clients_s = time.perf_counter() - t0
    items = [m.items() for m in maps]
    check(all(x == items[0] for x in items), "dds_clients: the map clients diverged")
    sc = _make_doc("map_batch", ScribeConfig(map_max_keys=keys), device)
    log = doc.sequencer.log
    for msg in log[:bounds[0]]:
        sc.apply(msg)
    t = time.perf_counter()
    for a, b in zip(bounds, bounds[1:]):
        for msg in log[a:b]:
            sc.apply(msg)
        sc.flush()
    scribe_s = time.perf_counter() - t
    check(sc.items() == items[0], "dds_clients: the map scribe's keys differ from the clients'")
    n_ops = batches * ops + 1
    return {"writers": writers, "keys": keys, "ops": n_ops, "live_keys": len(items[0]),
            "clients_s": clients_s, "clients_ops_per_s": n_ops / clients_s,
            "scribe_s": scribe_s, "scribe_ops_per_s": n_ops / scribe_s, "keys_equal": True}


def _k11_marks(rng, n: int, max_marks: int) -> list:
    """A random change over an n-node field as host marks (the kernel
    tests' generator), at most ``max_marks`` long."""
    from fluidframework_tpu_torch.dds.tree.changeset import Insert, Modify, NodeChange, Remove, Skip
    from fluidframework_tpu_torch.dds.tree.schema import leaf

    marks, pos = [], 0
    while pos < n and len(marks) < max_marks - 1:
        r = rng.random()
        if r < 0.35:
            k = int(rng.integers(1, n - pos + 1))
            marks.append(Skip(k)); pos += k
        elif r < 0.6:
            k = int(rng.integers(1, n - pos + 1))
            marks.append(Remove(k)); pos += k
        elif r < 0.8:
            marks.append(Insert([leaf(int(rng.integers(99))) for _ in range(int(rng.integers(1, 4)))]))
        else:
            marks.append(Modify(NodeChange(value=(1,)))); pos += 1
    if rng.random() < 0.5:
        marks.append(Insert([leaf(7)]))
    return marks


def _k11_host_positions(b, n: int) -> tuple:
    """Insert landings (both sides) and node landings with survival, by
    the host rebase (``changeset.rebase_marks``)."""
    from fluidframework_tpu_torch.dds.tree.changeset import (
        Insert, Modify, NodeChange, Skip, rebase_marks,
    )
    from fluidframework_tpu_torch.dds.tree.schema import leaf

    def land(a, after, want):
        at = 0
        for m in rebase_marks(a, b, a_after=after):
            if isinstance(m, want):
                return at
            at += m.count
        return None

    ins = {after: [land(([Skip(p)] if p else []) + [Insert([leaf(-1)])], after, Insert)
                   for p in range(n + 1)] for after in (True, False)}
    node = [land(([Skip(p)] if p else []) + [Modify(NodeChange(value=(42,)))], True, Modify)
            for p in range(n)]
    return ins, node


def _dds_k11(seed: int, card: str, device: str, rebase_b: int, rebase_m: int, sets_docs: int,
             sets_n: int, sets_b: int, forest_n: int, forest_b: int, forest_docs: int) -> dict:
    """Part (d): K11 alone.  Each function on ``device`` equals the same
    call on the CPU at its user's shape (exact, every column and latch);
    the rebase arithmetic equals the host changeset rebase on 200 seeded
    changes; the reference's dry-run case over 8 docs gives [99, 30, 10];
    then call times (CUDA events) beside the bytes bounds at 3.35 TB/s.
    Returns the line and the timed programs (``time_k11_device`` reads
    their device times later, after every call time of the script)."""
    import torch

    from fluidframework_tpu_torch.ops import tree_kernel as tk

    on_card = device == "cuda"
    rng = np.random.default_rng(seed + 65)
    checked = 0
    for i in range(200):
        n = int(rng.integers(1, 9))
        b = _k11_marks(rng, n, 16)
        kinds, counts = tk.encode_marks(b, 16)
        ins, node = _k11_host_positions(b, n)
        for after in (True, False):
            got = tk.rebase_insert_positions(np.arange(n + 1), kinds, counts, after, device=device)
            check(got.cpu().tolist() == ins[after], f"dds_clients: K11 insert rebase, change {i}")
        pos, live = tk.rebase_node_positions(np.arange(n), kinds, counts, device=device)
        for p in range(n):
            ok = bool(live[p]) == (node[p] is not None) and (node[p] is None or int(pos[p]) == node[p])
            check(ok, f"dds_clients: K11 node rebase, change {i} node {p}")
        checked += 1
    # The reference's multichip dry run, over 8 docs.
    ops = np.zeros((8, 3, tk.FOREST_OP_FIELDS), np.int32)
    pays = np.zeros((8, 3, 8), np.int32)
    ops[:, 0] = [tk.ForestOpKind.INSERT, 1, 0, 3, 0, 0, 0, 0]
    pays[:, 0, :3] = [10, 20, 30]
    ops[:, 1] = [tk.ForestOpKind.MOVE, 2, 0, 1, 3, 0, 0, 0]
    ops[:, 2] = [tk.ForestOpKind.SET, 3, 0, 0, 0, 99, 0, 0]
    dry = tk.apply_forest_ops_fleet(tk.batch_forest(tk.init_forest(16, device=device), 8), ops, pays)
    check(int(dry.error.sum()) == 0 and all(
        tk.forest_values(tk.ForestState(*(x[d] for x in dry))).tolist() == [99, 30, 10]
        for d in range(8)), "dds_clients: K11's dry-run case did not give [99, 30, 10]")

    # The timed shapes, made once.
    marks = _k11_marks(rng, rebase_b, rebase_m)
    kinds, counts = tk.encode_marks(marks, rebase_m)
    qpos = np.arange(rebase_b, dtype=np.int32)
    base = rng.integers(0, 1000, (sets_docs, sets_n)).astype(np.int32)
    idx = rng.integers(-1, sets_n + 1, (sets_docs, sets_b)).astype(np.int32)
    vals = rng.integers(0, 1 << 20, (sets_docs, sets_b)).astype(np.int32)
    seqs = (np.argsort(rng.random((sets_docs, sets_b)), axis=1) + 1).astype(np.int32)

    def forest_ring(n_docs):
        """``forest_b`` ops a doc: inserts first, then removes, sets and
        moves in the live range, a few off the end (range latches)."""
        o = np.zeros((n_docs, forest_b, tk.FOREST_OP_FIELDS), np.int32)
        p = rng.integers(0, 1000, (n_docs, forest_b, 8)).astype(np.int32)
        live = np.zeros(n_docs, np.int64)
        for j in range(forest_b):
            kind = 1 if j < forest_b // 2 else int(rng.integers(1, 5))
            pos = (rng.random(n_docs) * (live + 1)).astype(np.int64)
            cnt = rng.integers(1, 9, n_docs)
            o[:, j, :6] = np.stack([np.full(n_docs, kind), np.full(n_docs, j + 1), pos, cnt,
                                    (rng.random(n_docs) * (live + 1)).astype(np.int64),
                                    rng.integers(0, 1000, n_docs)], 1)
            if kind == 1:
                live = np.minimum(live + cnt, forest_n)
        return o, p

    f_ops, f_pays = forest_ring(forest_docs)
    dev = torch.device(device)
    t_kinds, t_counts, t_pos = (torch.from_numpy(x).to(dev) for x in (kinds, counts, qpos))
    chunk = tk.ChunkState(torch.from_numpy(base).to(dev), torch.zeros(base.shape, dtype=torch.int32,
                                                                       device=dev))
    t_idx, t_vals, t_seqs = (torch.from_numpy(x).to(dev) for x in (idx, vals, seqs))
    forest1 = tk.init_forest(forest_n, device=device)
    forestD = tk.batch_forest(forest1, forest_docs)
    t_ops, t_pays = torch.from_numpy(f_ops).to(dev), torch.from_numpy(f_pays).to(dev)
    progs = {
        "rebase_insert_positions": (
            lambda: tk.rebase_insert_positions(t_pos, t_kinds, t_counts, True, device=dev),
            lambda: tk.rebase_insert_positions(qpos, kinds, counts, True, device="cpu"),
            [rebase_b, rebase_m], 2 * qpos.nbytes + 2 * kinds.nbytes),
        "rebase_node_positions": (
            lambda: tk.rebase_node_positions(t_pos, t_kinds, t_counts, device=dev),
            lambda: tk.rebase_node_positions(qpos, kinds, counts, device="cpu"),
            [rebase_b, rebase_m], 3 * qpos.nbytes + 2 * kinds.nbytes),
        "apply_value_sets_fleet": (
            lambda: tk.apply_value_sets_fleet(chunk, t_idx, t_vals, t_seqs),
            lambda: tk.apply_value_sets_fleet(
                tk.ChunkState(torch.from_numpy(base), torch.zeros(base.shape, dtype=torch.int32)),
                idx, vals, seqs),
            [sets_docs, sets_n, sets_b], 4 * base.nbytes + 3 * idx.nbytes),
        "apply_value_sets": (
            lambda: tk.apply_value_sets(tk.ChunkState(chunk.values[0], chunk.val_seq[0]),
                                        t_idx[0], t_vals[0], t_seqs[0]),
            lambda: tk.apply_value_sets(tk.init_chunk(base[0], device="cpu"), idx[0], vals[0],
                                        seqs[0]),
            [1, sets_n, sets_b], 4 * base[0].nbytes + 3 * idx[0].nbytes),
        "apply_forest_op": (
            lambda: tk.apply_forest_op(forest1, t_ops[0, 0], t_pays[0, 0]),
            lambda: tk.apply_forest_op(tk.init_forest(forest_n, device="cpu"), f_ops[0, 0],
                                       f_pays[0, 0]),
            [1, forest_n, 1], 4 * 4 * forest_n + 2 * 8 + f_ops[0, 0].nbytes + f_pays[0, 0].nbytes),
        "apply_forest_ops": (
            lambda: tk.apply_forest_ops(forest1, t_ops[0], t_pays[0]),
            lambda: tk.apply_forest_ops(tk.init_forest(forest_n, device="cpu"), f_ops[0], f_pays[0]),
            [1, forest_n, forest_b],
            4 * 4 * forest_n + 2 * 8 + f_ops[0].nbytes + f_pays[0].nbytes),
        "apply_forest_ops_fleet": (
            lambda: tk.apply_forest_ops_fleet(forestD, t_ops, t_pays),
            lambda: tk.apply_forest_ops_fleet(
                tk.batch_forest(tk.init_forest(forest_n, device="cpu"), forest_docs), f_ops, f_pays),
            [forest_docs, forest_n, forest_b],
            forest_docs * (4 * 4 * forest_n + 2 * 8) + f_ops.nbytes + f_pays.nbytes),
    }
    out = {}
    for name, (run, cpu_run, shape, nbytes) in progs.items():
        got = run()
        got = got if isinstance(got, tuple) else (got,)
        want = cpu_run()
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((a.cpu().to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        check(err == 0 and all(a.dtype == b.dtype == torch.int32 for a, b in zip(got, want)),
              f"dds_clients: K11 {name} on {device} disagrees with the CPU")
        out[name] = {"shape": shape, "max_abs_err": err, "bound_bytes": int(nbytes),
                     "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    if on_card:
        fns = {name: getattr(tk, name) for name in progs}
        counts0 = {name: f.launches for name, f in fns.items()}
        for name, (run, _cpu, _shape, _nbytes) in progs.items():
            out[name]["ms"] = cuda_ms(run, 5 if "fleet" in name else 20, warmup=1)
        for name, f in fns.items():  # timing launches are not the path's
            f.launches = counts0[name]
    line = {"rebase_changes_checked": checked, "dry_run": [99, 30, 10], "programs": out}
    return line, {name: p[0] for name, p in progs.items()}


def time_k11_device(timed: dict, line: dict) -> None:
    """K11's device times (torch.profiler), taken after every call time
    of the script: the profiler's session leaves later launches dearer on
    the host.  Launch counts stay as the path left them."""
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    for name, run in timed.items():
        f = getattr(tk, name)
        n = f.launches
        line["programs"][name]["device_ms"] = _device_sum(device_ms_by_name(run, 5))
        f.launches = n
    emit({"phase": "dds_clients_k11_device", **{
        name: line["programs"][name]["device_ms"] for name in timed}})


def phase_dds_clients(seed: int, card: str, device: str = "cuda") -> tuple:
    """Phase 17: the port's own DDS clients drive the card's programs —
    (a) SharedTree clients into ``TreeBatchEngine`` (K7, K8, and K9 with
    ``device_rebase=True``), (b) SharedMatrix clients into the scribe's
    matrix family (K10), (c) SharedMap clients into its map family (K10),
    (d) K11 alone, at the ``DDS_*`` sizes.  Returns the line and K11's
    timed programs."""
    import torch

    t0 = time.perf_counter()
    line = {"phase": "dds_clients", "card": card}
    parts_s = {}
    for part, fn in (("tree", lambda: _dds_tree(seed, card, device, **DDS_TREE)),
                     ("matrix", lambda: _dds_matrix(seed, device, **DDS_MATRIX)),
                     ("map", lambda: _dds_map(seed, device, **DDS_MAP))):
        t = time.perf_counter()
        line[part] = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        parts_s[part] = time.perf_counter() - t
    t = time.perf_counter()
    line["k11"], timed = _dds_k11(seed, card, device, **DDS_K11)
    parts_s["k11"] = time.perf_counter() - t
    phase_s = time.perf_counter() - t0
    line.update({"parts_s": parts_s, "phase_s": phase_s, "cap_s": DDS_CAP_S,
                 "over_cap": phase_s > DDS_CAP_S, "reduced": DDS_REDUCED})
    emit(line)
    return line, timed


# ------------------------------------------------ phase 22: the DDS family

# Phase 22's container: one channel of each of the reference registry's 16
# types, declared as a ``ContainerSchema``'s initial objects.
FAMILY_SCHEMA = {
    "text": "sharedString", "kv": "sharedMap", "tree": "sharedTree", "grid": "sharedMatrix",
    "dir": "sharedDirectory", "ink": "ink", "block": "sharedSummaryBlock", "cell": "sharedCell",
    "counter": "sharedCounter", "queue": "consensusQueue",
    "regs": "consensusRegisterCollection", "tasks": "taskManager", "pact": "pactMap",
    "jot": "sharedJsonOT", "json1": "sharedJson1", "props": "propertyTree",
}
# Its script, as main() runs it: 4 containers, 8 rounds of 16 edits a
# container; container ``drop[0]`` disconnects at round ``drop[1]`` (and
# edits offline) and reconnects at round ``drop[2]``; a fifth container
# boots from a summary container 0 stores at ``boot_round``.
FAMILY = dict(containers=4, rounds=8, edits=16, drop=(1, 3, 5), boot_round=6)
FAMILY_TASKS = ("agent-a", "agent-b", "agent-c")
FAMILY_DOC = "family"
FAMILY_CAP_S = 30.0
# Edit kinds: every channel type but the summary block (local only) has at
# least one; a container that is offline draws from the first eight.
FAMILY_KINDS = ("ins", "rem", "ann", "iv", "kv", "dir", "counter", "cell", "mark", "reg",
                "q_add", "q_acq", "q_done", "pick", "release", "pact", "ink", "jot", "json1",
                "prop", "tree", "grid")
FAMILY_OFFLINE = 8


@contextlib.contextmanager
def _seeded_ids(seed: int):
    """``_seeded_sessions`` plus consensus-queue acquire ids drawn from a
    second generator seeded with ``seed``, so two runs of one script send
    the same bytes."""
    import random
    import uuid
    from types import SimpleNamespace

    from fluidframework_tpu_torch.dds import small

    rng = random.Random(seed + 1)
    saved = small._uuid
    small._uuid = SimpleNamespace(
        uuid4=lambda: uuid.UUID(int=rng.getrandbits(128), version=4))
    try:
        with _seeded_sessions(seed):
            yield
    finally:
        small._uuid = saved


class _Family:
    """Phase 22's document: ``FluidContainer``s from one
    ``LocalServiceClient``, each with an ``AgentScheduler`` over its task
    manager.  Every string channel made while it lives comes from
    ``make_string`` (the oracle when None)."""

    def __init__(self, make_string):
        from fluidframework_tpu_torch.dds import channels
        from fluidframework_tpu_torch.framework import ContainerSchema, LocalServiceClient

        channels.set_string_backend_factory(make_string)
        self.client = LocalServiceClient()
        self.schema = ContainerSchema(initial_objects=dict(FAMILY_SCHEMA))
        self.fcs, self.agents, self.connected = [], [], []
        self.handles, self.strokes, self.picked, self.agent_log = [], [], [], []
        fc, _services = self.client.create_container(self.schema, FAMILY_DOC, client_id="c0")
        self._add(fc)
        o = fc.initial_objects
        o["block"].set("config", {"theme": "dark", "family": len(FAMILY_SCHEMA)})
        o["dir"].create_subdirectory("sub")
        o["grid"].insert_rows(0, 4)
        o["grid"].insert_cols(0, 4)
        o["jot"].replace([], {"items": [], "meta": {}})
        o["json1"].replace([], None, {"list": []})
        o["props"].insert_property(["geo"], "NodeProperty", {})
        self.sync()
        for i in range(1, FAMILY["containers"]):
            self.boot(i)

    def _add(self, fc) -> None:
        from fluidframework_tpu_torch.framework import AgentScheduler

        i = len(self.fcs)
        self.fcs.append(fc)
        self.agents.append(AgentScheduler(fc.initial_objects["tasks"]))
        self.connected.append(True)
        self.handles.append([])
        self.strokes.append([])
        self.picked.append(set())
        self.agent_log.append([])

    def boot(self, i: int) -> None:
        """Container ``i`` loads from the newest stored summary and the ops
        after it."""
        fc, _services = self.client.get_container(FAMILY_DOC, self.schema, client_id=f"c{i}")
        self._add(fc)
        self.sync()

    def close(self) -> None:
        from fluidframework_tpu_torch.dds import channels

        channels.set_string_backend_factory(None)

    def o(self, i: int) -> dict:
        return self.fcs[i].initial_objects

    def sync(self) -> None:
        while True:
            for i, fc in enumerate(self.fcs):
                if self.connected[i]:
                    fc.flush()
            if not self.client.service.process_all():
                return

    def act(self, action: tuple) -> None:
        kind, *rest = action
        if kind == "edit":
            self.edit(*rest)
        elif kind == "flush":
            self.fcs[rest[0]].flush()
        elif kind == "sync":
            self.sync()
        elif kind == "drop":
            self.fcs[rest[0]].disconnect()
            self.connected[rest[0]] = False
        elif kind == "rejoin":
            self.fcs[rest[0]].connect()
            self.connected[rest[0]] = True
            self.agents[rest[0]].resume()
            self.sync()
        elif kind == "summary":
            self.fcs[rest[0]].container.summarize_to_storage()
        elif kind == "boot":
            self.boot(rest[0])
        else:
            raise ValueError(kind)

    def edit(self, i: int, op: tuple) -> None:
        from fluidframework_tpu_torch.dds.markers import MARKER_ID_KEY, REF_TILE
        from fluidframework_tpu_torch.dds.tree.changeset import make_insert, make_set_value
        from fluidframework_tpu_torch.dds.tree.schema import leaf

        o = self.o(i)
        kind, *a = op
        if kind in ("ins", "rem", "ann", "iv"):
            _string_edit(o["text"], op)
        elif kind == "mark":
            o["text"].insert_marker(a[0], REF_TILE, {MARKER_ID_KEY: a[1]})
        elif kind == "kv":
            o["kv"].set(*a)
        elif kind == "dir":
            o["dir"].set(*a)
        elif kind == "counter":
            o["counter"].increment(*a)
        elif kind == "cell":
            o["cell"].set(*a)
        elif kind == "reg":
            o["regs"].write(*a)
        elif kind == "q_add":
            o["queue"].add(*a)
        elif kind == "q_acq":
            self.handles[i].append(o["queue"].acquire())
        elif kind == "q_done":
            handle = [h for h in self.handles[i] if h.acquired][a[0]]
            self.handles[i].remove(handle)
            o["queue"].complete(handle)
        elif kind == "pick":
            log = self.agent_log[i]
            self.agents[i].pick(a[0], lambda t=a[0]: log.append(["start", t]),
                                lambda t=a[0]: log.append(["lost", t]))
            self.picked[i].add(a[0])
        elif kind == "release":
            self.agents[i].release(a[0])
            self.picked[i].discard(a[0])
        elif kind == "pact":
            o["pact"].set(*a)
        elif kind == "ink_new":
            self.strokes[i].append(o["ink"].create_stroke({"color": a[0]}))
        elif kind == "ink_pt":
            o["ink"].append_point(self.strokes[i][a[0]], *a[1:])
        elif kind == "jot_ins":
            o["jot"].insert(["items", a[0]], a[1])
        elif kind == "jot_rm":
            o["jot"].remove(["items", a[0]])
        elif kind == "j1_ins":
            o["json1"].insert(["list", a[0]], a[1])
        elif kind == "j1_rm":
            o["json1"].remove(["list", a[0]])
        elif kind == "prop_new":
            o["props"].insert_property(["geo", a[0]], "Int32", a[1])
        elif kind == "prop_set":
            o["props"].set_value(["geo", a[0]], a[1])
        elif kind == "tree_ins":
            o["tree"].submit_change(make_insert([], "", a[0], [leaf(a[1])]))
        elif kind == "tree_set":
            o["tree"].submit_change(make_set_value([("", a[0])], a[1]))
        elif kind == "grid_set":
            o["grid"].set_cell(*a)
        elif kind == "grid_row":
            o["grid"].insert_rows(a[0], 1)
        else:
            raise ValueError(kind)

    def gen(self, rng, i: int) -> tuple:
        """One seeded edit for container ``i``, drawn from its own view."""
        o = self.o(i)
        kinds = FAMILY_KINDS if self.connected[i] else FAMILY_KINDS[:FAMILY_OFFLINE]
        kind = rng.choice(kinds)
        n = len(o["text"].position_text())
        if kind in ("ins", "rem", "ann", "iv", "mark") and (kind == "ins" or n < 2):
            return ("ins", rng.randint(0, n), rng.choice("abcdefgh") * rng.randint(1, 8))
        if kind == "mark":
            return ("mark", rng.randint(0, n), f"m-{i}-{rng.getrandbits(24)}")
        if kind in ("rem", "ann", "iv"):
            p1 = rng.randrange(n)
            p2 = rng.randint(p1 + 1, min(n, p1 + 8))
            if kind == "rem":
                return ("rem", p1, p2)
            if kind == "ann":
                return ("ann", p1, p2, rng.choice(["bold", "color"]), rng.choice([True, "red", 7]))
            return ("iv", p1, rng.randint(p1, min(n - 1, p1 + 16)))
        if kind == "kv":
            return ("kv", f"k{rng.randrange(8)}", rng.randrange(1000))
        if kind == "dir":
            return ("dir", rng.choice(["", "sub"]), f"d{rng.randrange(4)}", rng.randrange(100))
        if kind == "counter":
            return ("counter", rng.randint(-3, 5))
        if kind == "cell":
            return ("cell", {"v": rng.randrange(100), "by": i})
        if kind == "reg":
            return ("reg", f"r{rng.randrange(3)}", rng.randrange(100))
        if kind == "q_done" and any(h.acquired for h in self.handles[i]):
            return ("q_done", 0)
        if kind in ("q_add", "q_done"):
            return ("q_add", f"job-{i}-{rng.randrange(1000)}")
        if kind == "q_acq":
            return ("q_acq",)
        picked = self.picked[i]
        if kind == "release" and picked:
            return ("release", rng.choice(sorted(picked)))
        if kind in ("pick", "release"):
            free = [t for t in FAMILY_TASKS if t not in picked]
            return ("pick", rng.choice(free)) if free else ("release", rng.choice(sorted(picked)))
        if kind == "pact":
            return ("pact", f"p{rng.randrange(3)}", rng.randrange(100))
        if kind == "ink":
            if self.strokes[i] and rng.random() < 0.7:
                return ("ink_pt", rng.randrange(len(self.strokes[i])), rng.randrange(100),
                        rng.randrange(100), 0.5, 0.5)
            return ("ink_new", rng.choice(["red", "blue"]))
        if kind == "jot":
            items = o["jot"].get()["items"]
            if items and rng.random() < 0.3:
                return ("jot_rm", rng.randrange(len(items)))
            return ("jot_ins", rng.randint(0, len(items)), rng.randrange(100))
        if kind == "json1":
            items = o["json1"].get()["list"]
            if items and rng.random() < 0.3:
                return ("j1_rm", rng.randrange(len(items)))
            return ("j1_ins", rng.randint(0, len(items)), rng.randrange(100))
        if kind == "prop":
            mine = sorted(k for k in (o["props"].resolve_path(["geo"]) or {}).get("children", {})
                          if k.startswith(f"c{i}-"))
            if mine and rng.random() < 0.5:
                return ("prop_set", rng.choice(mine), rng.randrange(100))
            return ("prop_new", f"c{i}-{rng.getrandbits(16)}", rng.randrange(100))
        if kind == "tree":
            m = len(o["tree"].forest.root_field)
            if m and rng.random() < 0.4:
                return ("tree_set", rng.randrange(m), rng.randrange(100))
            return ("tree_ins", rng.randint(0, m), rng.randrange(100))
        rows, cols = o["grid"].row_count, o["grid"].col_count
        if rng.random() < 0.15:
            return ("grid_row", rng.randint(0, rows))
        return ("grid_set", rng.randrange(rows), rng.randrange(cols), rng.randrange(100))

    def views(self, i: int) -> str:
        """Container ``i``'s view of every shared channel (the summary
        block is local to each container until a summary carries it)."""
        o = self.o(i)
        return json.dumps({
            "text": _string_views(o["text"]), "markers": o["text"].markers(),
            "kv": o["kv"].items(), "tree": o["tree"].forest.to_json(),
            "grid": o["grid"].to_grid(),
            **{name: o[name].summarize() for name in (
                "dir", "ink", "queue", "regs", "tasks", "pact")},
            "cell": o["cell"].get(), "counter": o["counter"].value, "jot": o["jot"].get(),
            "json1": o["json1"].get(), "props": o["props"].root(),
        }, sort_keys=True)

    def kernels(self) -> list:
        from fluidframework_tpu_torch.dds.mergetree_ref import RefMergeTree

        backends = [fc.initial_objects["text"].backend for fc in self.fcs]
        return [b for b in backends if not isinstance(b, RefMergeTree)]


def _family_run(make_string, seed: int, sizes: dict, script=None) -> dict:
    """One run of phase 22(c)'s script over ``_Family(make_string)``.  With
    ``script`` None the seeded script is made as it runs (each edit from
    the acting container's view) and returned as ``actions``; otherwise
    its actions are replayed one by one.  After every sync the connected
    containers' views must be equal."""
    import random

    rng = random.Random(seed)
    taken: list = []
    edits = syncs = 0
    t0 = time.perf_counter()
    with _seeded_ids(seed):
        fam = _Family(make_string)
        try:
            def run(action):
                nonlocal edits, syncs
                taken.append(action)
                fam.act(action)
                edits += action[0] == "edit"
                if action[0] == "sync":
                    syncs += 1
                    views = [fam.views(i) for i, on in enumerate(fam.connected) if on]
                    check(all(v == views[0] for v in views[1:]),
                          f"dds_family: the containers' views differ at sync {syncs}")

            if script is None:
                j, drop_round, rejoin_round = sizes["drop"]
                for r in range(sizes["rounds"]):
                    if r == drop_round:
                        run(("drop", j))
                    if r == rejoin_round:
                        run(("rejoin", j))
                    if r == sizes["boot_round"]:
                        run(("summary", 0))
                        run(("boot", len(fam.fcs)))
                    for i in rng.sample(range(len(fam.fcs)), len(fam.fcs)):
                        for _ in range(sizes["edits"]):
                            run(("edit", i, fam.gen(rng, i)))
                        if fam.connected[i]:
                            run(("flush", i))
                    run(("sync",))
            else:
                for action in script:
                    run(action)
            check(all(fam.connected), "dds_family: a container is still offline at the end")
            kernels = fam.kernels()
            seconds = time.perf_counter() - t0
            log = fam.client.service.document(FAMILY_DOC).sequencer.log
            text = fam.o(0)["text"]
            return {
                "actions": taken, "edits": edits, "syncs": syncs, "seconds": seconds,
                "edits_per_s": edits / seconds, "containers": len(fam.fcs),
                "stream": [dict(json.loads(m.to_json()), timestamp=0) for m in log],
                "summaries": [json.dumps(fc.container.runtime.summarize(), sort_keys=True)
                              for fc in fam.fcs],
                "views": [fam.views(i) for i in range(len(fam.fcs))],
                "agent_log": fam.agent_log,
                "blocks": [fam.o(i)["block"].get("config") for i in range(len(fam.fcs))],
                "kernels": len(kernels), "errors": [k.check_errors() for k in kernels],
                # ``regenerated`` is the port's counter (a CPU test runs this
                # script on the reference's replicas too, which have none).
                "regenerated": sum(getattr(k, "regenerated", 0) for k in kernels),
                "string": (text.backend, text._connection.ref_seq()),
            }
        finally:
            fam.close()


def _family_corpus(make_string) -> dict:
    """Phase 22(a): every ``SCRIPTS`` entry of the snapshot corpus
    regenerated (``build_entry``) with ``make_string`` behind the string
    channel into a temporary directory, each file against the committed
    one; then every
    committed file, each format version, loaded into a container (its
    channel's summary under the format stamp the file records) and its
    state against the recorded one."""
    from fluidframework_tpu_torch.dds import channels
    from fluidframework_tpu_torch.runtime import ContainerRuntime
    from fluidframework_tpu_torch.testing import snapshot_corpus as sc

    channels.set_string_backend_factory(make_string)
    try:
        with tempfile.TemporaryDirectory() as d:
            differ = []
            for script in sc.SCRIPTS:
                entry = sc.build_entry(script)
                name = f"{script}.v{entry['format']}.json"
                with open(os.path.join(d, name), "w") as f:
                    f.write(sc.canonical(entry) + "\n")
                with open(os.path.join(d, name), "rb") as a, \
                        open(os.path.join(sc.SNAPSHOT_DIR, name), "rb") as b:
                    if a.read() != b.read():
                        differ.append(name)
        loaded, state_differ, backends = [], [], set()
        for name in sorted(os.listdir(sc.SNAPSHOT_DIR)):
            if not name.endswith(".json"):
                continue
            with open(os.path.join(sc.SNAPSHOT_DIR, name)) as f:
                entry = json.load(f)
            rt = ContainerRuntime(channels.default_registry(), container_id="golden")
            rt.load_snapshot({"seq": 0, "minSeq": 0, "quorum": {}, "datastores": {"root": {
                "root": True, "channels": {"golden": {
                    "type": entry["type"], "fmt": entry["format"], "summary": entry["summary"]}}}}})
            ch = rt.datastore("root").get_channel("golden")
            if entry["type"] == "sharedString":
                backends.add(type(ch.backend).__name__)
            loaded.append(name)
            if sc.extract_state(entry["type"], ch) != entry["state"]:
                state_differ.append(name)
    finally:
        channels.set_string_backend_factory(None)
    return {"written": len(sc.SCRIPTS), "differ": differ, "loaded": loaded,
            "state_differ": state_differ, "string_backends": sorted(backends)}


def _family_v1(make_kernel, docs: dict) -> dict:
    """Phase 22(b): each ``(oracle tree, seq)`` of ``docs`` encoded as the
    legacy v1 merge-tree chunks, decoded again and imported into
    ``make_kernel()``'s replica: its text, per-position props and markers
    equal the decoded oracle's, and the text the original's."""
    from fluidframework_tpu_torch.dds.snapshot_v1 import decode_snapshot_v1, encode_snapshot_v1
    from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED

    def views(t):
        return (t.visible_text(ALL_ACKED, -1), t.annotations(ALL_ACKED, -1),
                t.marker_scan(ALL_ACKED, -1))

    out = {}
    for name, (tree, seq) in docs.items():
        blobs = encode_snapshot_v1(tree, seq=seq, get_long_client_id=lambda s: f"client-{s}")
        loaded, seq_back, _min_seq = decode_snapshot_v1(blobs, lambda c: int(c.split("-")[1]))
        kmt = make_kernel()
        kmt.import_summary(loaded.export_summary())
        check(seq_back == seq and views(loaded)[0] == tree.visible_text(ALL_ACKED, -1),
              f"dds_family: the v1 round trip of the {name} string lost its text or seq")
        check(views(kmt) == views(loaded),
              f"dds_family: the {name} string's v1 import differs from the oracle's")
        check(kmt.check_errors() == 0, f"dds_family: the {name} string's import latched errors")
        out[name] = {"blobs": sorted(blobs), "chars": len(views(loaded)[0]),
                     "markers": len(views(loaded)[2]),
                     "annotated": sum(1 for d in views(loaded)[1] if d)}
    return out


def phase_dds_family(seed: int, card: str, device: str = "cuda",
                     sizes: dict | None = None) -> dict:
    """Phase 22 at ``FAMILY``: (a) the snapshot corpus with the string
    channel's backend ``KernelMergeTree`` on ``device`` at
    ``STRING_CLIENT_GEOM`` (``_family_corpus``); (c) the family script's
    containers with every string on ``device`` (``_family_run``), then the
    same actions with every string on the oracle: equal sequenced streams,
    container summaries, views and agent logs; (b) the corpus string and
    the oracle run's family string through the legacy v1 chunks into a
    replica on ``device`` (``_family_v1``).  The line carries each part's
    seconds, the edits/s and the one-doc programs' launches."""
    import torch

    from fluidframework_tpu_torch.dds import channels
    from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.testing import snapshot_corpus as sc

    sizes = dict(FAMILY if sizes is None else sizes)
    make_kernel = lambda: KernelMergeTree(**STRING_CLIENT_GEOM, device=device)  # noqa: E731
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    line = {"phase": "dds_family", "card": card, "geometry": STRING_CLIENT_GEOM,
            "sizes": sizes}
    parts_s = {}
    t0 = t = time.perf_counter()
    corpus = _family_corpus(make_kernel)
    check(not corpus["differ"], f"dds_family: corpus files differ from the committed ones: "
                                f"{corpus['differ']}")
    check(not corpus["state_differ"], f"dds_family: committed files load to other states: "
                                      f"{corpus['state_differ']}")
    check(corpus["string_backends"] == ["KernelMergeTree"],
          f"dds_family: the corpus strings loaded on {corpus['string_backends']}")
    line["corpus"] = corpus
    sync()
    parts_s["corpus"] = time.perf_counter() - t
    t = time.perf_counter()
    run = _family_run(make_kernel, seed, sizes)
    sync()
    parts_s["containers"] = time.perf_counter() - t
    launches = {name: getattr(mk, name).launches for name in ("apply_op", "compact", "restamp")}
    t = time.perf_counter()
    oracle = _family_run(None, seed, sizes, script=run["actions"])
    parts_s["oracle_replay"] = time.perf_counter() - t
    check(run["kernels"] == run["containers"] and oracle["kernels"] == 0,
          "dds_family: a string channel was not on the backend its run asked for")
    check(run["errors"] == [0] * run["kernels"], f"dds_family: error latches {run['errors']}")
    check(run["regenerated"] > 0, "dds_family: no string op was regenerated on the rejoin")
    for key in ("stream", "summaries", "views", "agent_log", "blocks"):
        check(run[key] == oracle[key],
              f"dds_family: the card run's {key} differ from the oracle run's")
    check(run["blocks"][-1] == run["blocks"][0] is not None,
          "dds_family: the booted container's summary block differs from the writer's")
    t = time.perf_counter()
    channels.set_string_backend_factory(None)
    corpus_ch = sc.SCRIPTS["sharedString"]()
    line["v1"] = _family_v1(make_kernel, {
        "corpus": (corpus_ch.backend, corpus_ch._connection.ref_seq()),
        "family": oracle["string"]})
    sync()
    parts_s["v1"] = time.perf_counter() - t
    phase_s = time.perf_counter() - t0
    line.update({
        "containers": run["containers"], "edits": run["edits"], "syncs": run["syncs"],
        "sequenced": len(run["stream"]), "regenerated_ops": run["regenerated"],
        "agent_events": sum(len(log) for log in run["agent_log"]),
        "edits_per_s": run["edits_per_s"], "oracle_edits_per_s": oracle["edits_per_s"],
        "launches": launches, "identical_to_oracle": True,
        "parts_s": parts_s, "phase_s": phase_s, "cap_s": FAMILY_CAP_S,
        "over_cap": phase_s > FAMILY_CAP_S,
    })
    emit(line)
    return line


# ------------------------------------------- phase 23: the debugger and devtools

# Phase 23's sizes, as main() runs them: two writer containers make
# ``n_edits`` seeded edits (inserts, removes, interval adds and map sets);
# container 0 stores a summary once ``summary_at`` edits are sequenced; the
# whole-history viewers step their first ``stepped`` sequenced messages one
# at a time and play to ``play_to`` (a sequence number) before they resume;
# every ``every`` sequence numbers each viewer records a checkpoint;
# ``live`` edits follow once the viewers are live.  A flush sends a
# writer's 1-3 edits as one message, so 1,000 edits are ~500 messages.
DEBUGGER = dict(n_edits=1000, summary_at=500, stepped=200, play_to=350, every=50, live=8)
DEBUGGER_DOC = "debugged"
DEBUGGER_CAP_S = 60.0


def _viewer_views(c) -> dict:
    """Every channel of container ``c`` through ``visualize_channel``."""
    from fluidframework_tpu_torch.tools.devtools import visualize_channel

    return {f"{ds_id}/{ch_id}": visualize_channel(ds.get_channel(ch_id))
            for ds_id, ds in sorted(c.runtime.datastores.items())
            for ch_id in sorted(ds.channels)}


def _view_errors(obj) -> list:
    """The ``"error"`` values anywhere in a view (``visualize_channel``
    catches every exception into that key)."""
    if isinstance(obj, dict):
        return ([obj["error"]] if "error" in obj else []) + [
            e for v in obj.values() for e in _view_errors(v)]
    if isinstance(obj, list):
        return [e for v in obj for e in _view_errors(v)]
    return []


def _debugger_edit(rng, s) -> tuple:
    n = len(s.position_text())
    kind = rng.choices(["ins", "rem", "iv", "kv"], [50, 25, 15, 10])[0]
    if kind == "ins" or (n == 0 and kind != "kv"):
        return ("ins", rng.randint(0, n), rng.choice("abcdefgh") * rng.randint(1, 8))
    if kind == "kv":
        return ("kv", f"k{rng.randrange(16)}", rng.randrange(1000))
    p1 = rng.randrange(n)
    if kind == "rem":
        return ("rem", p1, rng.randint(p1 + 1, min(n, p1 + 8)))
    return ("iv", p1, rng.randint(p1, min(n - 1, p1 + 16)))


class _DebugSession:
    """Phase 23's document: two writer containers over a ``LocalService``
    (their strings on the host oracle), and the viewers that load through
    ``DebuggerDocumentServiceFactory`` in read mode, each behind its own
    controller, which records a checkpoint (the viewer's text and every
    channel's view) whenever it releases a sequence number that is a
    multiple of ``every``."""

    def __init__(self, every: int):
        from fluidframework_tpu_torch.dds.channels import default_registry
        from fluidframework_tpu_torch.driver import LocalDocumentServiceFactory
        from fluidframework_tpu_torch.loader import Container
        from fluidframework_tpu_torch.server.local_service import LocalService

        self.every = every
        self.registry = default_registry
        self.svc = LocalService()
        self.inner = LocalDocumentServiceFactory(self.svc)
        w0 = Container.create_detached(default_registry(), container_id="w0")
        w0.attach(DEBUGGER_DOC, self.inner, "w0")
        self.svc.process_all()
        self.writers = [w0]
        self.viewers: dict = {}

    def create_channels(self) -> None:
        """Container 0 makes the datastore after attach, so its attach op
        is in the sequenced history a viewer replays from nothing."""
        from fluidframework_tpu_torch.loader import Container

        rt = self.writers[0].runtime
        ds = rt.create_datastore("root")
        ds.create_channel("sharedString", "text")
        ds.create_channel("sharedMap", "map")
        rt.submit_datastore_attach("root")
        rt.flush()
        self.svc.process_all()
        self.writers.append(Container.load(DEBUGGER_DOC, self.inner, self.registry(), "w1"))
        self.svc.process_all()

    def load_viewer(self, name: str, make_string, from_snapshot: bool) -> None:
        """A viewer whose strings ``make_string`` makes (None: the oracle);
        the factory is set only while the viewer loads and while its
        controller releases ops (the writers' strings stay on the host)."""
        from fluidframework_tpu_torch.driver.debugger_driver import (
            DebugController,
            DebuggerDocumentServiceFactory,
        )
        from fluidframework_tpu_torch.loader import Container

        session = self

        class Checkpointing(DebugController):
            def __init__(self):
                super().__init__()
                self.checkpoints: list = []
                self.container = None

            def _deliver(self, sink, msg):
                super()._deliver(sink, msg)
                if msg.seq % session.every == 0:
                    self.checkpoints.append((msg.seq, json.dumps(
                        {"text": session.text(self.container),
                         "views": _viewer_views(self.container)}, sort_keys=True)))

        dbg = DebuggerDocumentServiceFactory(self.inner, from_snapshot=from_snapshot)
        ctl = dbg.controllers[DEBUGGER_DOC] = Checkpointing()
        with self.strings(make_string):
            c = Container.load(DEBUGGER_DOC, dbg, self.registry(), name, mode="read")
        ctl.container = c
        self.svc.process_all()
        self.viewers[name] = (c, ctl, make_string)

    @contextlib.contextmanager
    def strings(self, make_string):
        from fluidframework_tpu_torch.dds import channels

        channels.set_string_backend_factory(make_string)
        try:
            yield
        finally:
            channels.set_string_backend_factory(None)

    def release(self, name: str, how: str, arg=None) -> int:
        _c, ctl, make_string = self.viewers[name]
        with self.strings(make_string):
            if how == "step":
                return ctl.step(arg)
            if how == "play_to_seq":
                return ctl.play_to_seq(arg)
            before = ctl.released
            ctl.resume()
            return ctl.released - before

    @staticmethod
    def string(c):
        return c.runtime.datastore("root").get_channel("text")

    def text(self, c):
        return self.string(c).text if "root" in c.runtime.datastores else None

    def edit(self, w: int, op: tuple) -> None:
        kind, *a = op
        ds = self.writers[w].runtime.datastore("root")
        s = ds.get_channel("text")
        if kind == "ins":
            s.insert_text(*a)
        elif kind == "rem":
            s.remove_range(*a)
        elif kind == "iv":
            s.get_interval_collection("marks").add(*a)
        else:
            ds.get_channel("map").set(*a)

    def write(self, rng, n_edits: int, counts: dict) -> None:
        """Rounds of 1-3 edits a writer, flushed, then sequenced, until
        ``n_edits`` more edits are made."""
        made = 0
        while made < n_edits:
            for w in rng.sample(range(len(self.writers)), len(self.writers)):
                for _ in range(rng.randint(1, 3)):
                    op = _debugger_edit(rng, self.string(self.writers[w]))
                    self.edit(w, op)
                    counts[op[0]] = counts.get(op[0], 0) + 1
                    made += 1
                self.writers[w].runtime.flush()
            self.svc.process_all()


def _debugger_replay(session, name: str, stepped: int, play_to: int, sync) -> dict:
    """Step ``name``'s held history: ``step(1)`` for ``stepped`` ops (or
    until the buffer is empty), ``play_to_seq(play_to)``, ``resume()``."""
    _c, ctl, _make = session.viewers[name]
    held, first_seq = ctl.pending, ctl.next_seq()
    t0 = time.perf_counter()
    steps = 0
    while steps < stepped and ctl.pending:
        check(session.release(name, "step", 1) == 1, f"debugger: {name}'s step(1) released nothing")
        steps += 1
    played = session.release(name, "play_to_seq", play_to)
    check(ctl.pending == 0 or ctl.next_seq() > play_to,
          f"debugger: {name} holds seq {ctl.next_seq()} after play_to_seq({play_to})")
    resumed = session.release(name, "resume")
    sync()
    seconds = time.perf_counter() - t0
    check(steps + played + resumed == held and ctl.pending == 0,
          f"debugger: {name} released {steps + played + resumed} of {held} held ops")
    return {"held": held, "first_seq": first_seq, "stepped": steps, "played": played,
            "resumed": resumed,
            "seconds": seconds, "steps_per_s": held / seconds}


def phase_debugger(seed: int, card: str, device: str = "cuda", geom: dict | None = None,
                   sizes: dict | None = None) -> dict:
    """Phase 23 at ``DEBUGGER``: (a) two writers' seeded edits held by two
    whole-history viewers (``from_snapshot=False``), one with its strings
    on ``KernelMergeTree`` on ``device``, one on the oracle, both stepped
    through the controller the same way: their checkpoints are equal, and
    the card replica launched ``apply_op`` at least once for each insert
    and remove it stepped; (b) a viewer booted from the summary container 0
    stores half way steps the tail and ends equal to (a); then live edits
    pass straight through; (c) ``FluidDevtools`` over the three viewers and
    its HTTP surface: the card viewers' container JSON equals the oracle's
    but for the names, and no view carries an ``"error"`` key."""
    import random
    import urllib.request

    import torch

    from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.tools.devtools import DevtoolsServer, FluidDevtools

    geom = dict(STRING_CLIENT_GEOM if geom is None else geom)
    sizes = dict(DEBUGGER if sizes is None else sizes)
    make_kernel = lambda: KernelMergeTree(**geom, device=device)  # noqa: E731
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    progs = ("apply_op", "compact", "restamp")
    launches = lambda: {p: getattr(mk, p).launches for p in progs}  # noqa: E731
    rng = random.Random(seed)
    parts_s: dict = {}
    t0 = t = time.perf_counter()
    session = _DebugSession(sizes["every"])
    session.load_viewer("card", make_kernel, from_snapshot=False)
    session.load_viewer("oracle", None, from_snapshot=False)
    session.create_channels()
    counts: dict = {}
    session.write(rng, sizes["summary_at"], counts)
    summary_seq = session.writers[0].summarize_to_storage()
    session.load_viewer("summary", make_kernel, from_snapshot=True)
    session.write(rng, sizes["n_edits"] - sum(counts.values()), counts)
    writers_text = session.text(session.writers[0])
    check(session.text(session.writers[1]) == writers_text, "debugger: the writers diverged")
    parts_s["writers"] = time.perf_counter() - t
    runs, launched = {}, {}
    for name, stepped in (("card", sizes["stepped"]), ("oracle", sizes["stepped"]),
                          ("summary", sizes["stepped"] // 2)):
        before = launches()
        runs[name] = _debugger_replay(session, name, stepped, sizes["play_to"], sync)
        launched[name] = {p: n - before[p] for p, n in launches().items()}
        parts_s[f"replay_{name}"] = runs[name]["seconds"]
    viewers = {name: c for name, (c, _ctl, _m) in session.viewers.items()}
    ctls = {name: ctl for name, (_c, ctl, _m) in session.viewers.items()}
    card_ck, oracle_ck = ctls["card"].checkpoints, ctls["oracle"].checkpoints
    last_seq = session.svc.document(DEBUGGER_DOC).sequencer.log[-1].seq
    every = sizes["every"]
    for name, ck in (("card", card_ck), ("oracle", oracle_ck)):
        first = runs[name]["first_seq"]
        check([s for s, _ in ck] == list(range(-(-first // every) * every, last_seq + 1, every)),
              f"debugger: the {name} viewer checkpointed at seqs {[s for s, _ in ck]}")
    for (seq, got), (_s, want) in zip(card_ck, oracle_ck):
        check(got == want, f"debugger: the card viewer differs from the oracle's at seq {seq}")
    by_seq = dict(card_ck)
    tail_ck = ctls["summary"].checkpoints
    check(tail_ck and tail_ck[0][0] > summary_seq,
          "debugger: the summary viewer stepped no op above its summary")
    for seq, got in tail_ck:
        check(by_seq.get(seq) == got, f"debugger: the summary viewer differs at seq {seq}")
    stepped_edits = counts.get("ins", 0) + counts.get("rem", 0)
    check(launched["card"]["apply_op"] >= stepped_edits,
          f"debugger: {launched['card']['apply_op']} apply_op launches for {stepped_edits} "
          "stepped inserts and removes")
    check(launched["oracle"]["apply_op"] == 0, "debugger: the oracle viewer launched apply_op")
    for name in ("card", "summary", "oracle"):
        check(session.text(viewers[name]) == writers_text,
              f"debugger: the {name} viewer's text differs from the writers'")
    kernels = [session.string(viewers[n]).backend for n in ("card", "summary")]
    check(all(isinstance(k, KernelMergeTree) for k in kernels),
          "debugger: a card viewer's string is not on KernelMergeTree")
    check(not isinstance(session.string(viewers["oracle"]).backend, KernelMergeTree),
          "debugger: the oracle viewer's string is on KernelMergeTree")
    check([k.check_errors() for k in kernels] == [0, 0], "debugger: a card replica latched errors")

    t = time.perf_counter()
    before = launches()
    live_counts: dict = {}
    session.write(rng, sizes["live"], live_counts)
    sync()
    parts_s["live"] = time.perf_counter() - t
    launched["live"] = {p: n - before[p] for p, n in launches().items()}
    writers_text = session.text(session.writers[0])
    for name, c in viewers.items():
        check(ctls[name].pending == 0 and session.text(c) == writers_text,
              f"debugger: a live edit did not pass straight through to the {name} viewer")

    t = time.perf_counter()
    devtools = FluidDevtools()
    for name, c in viewers.items():
        devtools.register_container(name, c.runtime)
    local = {name: dt.to_json() for name, dt in devtools.containers.items()}
    server = DevtoolsServer(devtools).start()
    try:
        served = {}
        for name in viewers:
            with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/devtools/container/"
                                        f"{name}", timeout=30) as resp:
                served[name] = json.loads(resp.read())
    finally:
        server.stop()
    parts_s["devtools"] = time.perf_counter() - t

    def unnamed(view):
        meta = {k: v for k, v in view["metadata"].items() if k not in ("containerKey",
                                                                        "containerId")}
        return json.dumps({**view, "metadata": meta}, sort_keys=True)

    for name in viewers:
        check(served[name] == json.loads(json.dumps(local[name])),
              f"debugger: devtools served another {name} container than it holds")
        check(not _view_errors(served[name]),
              f"debugger: the {name} viewer's devtools views carry errors "
              f"{_view_errors(served[name])}")
        check(unnamed(served[name]) == unnamed(served["oracle"]),
              f"debugger: devtools shows the {name} viewer other than the oracle's")
    check(not [e for _s, v in card_ck + oracle_ck + tail_ck
               for e in _view_errors(json.loads(v))],
          "debugger: a checkpoint's view carries an error")
    for c in list(viewers.values()) + session.writers:
        c.disconnect()
    phase_s = time.perf_counter() - t0
    line = {
        "phase": "debugger", "card": card, "geometry": geom, "sizes": sizes,
        "edits": counts, "live_edits": live_counts, "sequenced": len(
            session.svc.document(DEBUGGER_DOC).sequencer.log),
        "summary_seq": summary_seq, "replays": runs,
        "ops_stepped": runs["card"]["held"],
        "edits_stepped": sum(counts.values()), "steps_per_s": runs["card"]["steps_per_s"],
        "oracle_steps_per_s": runs["oracle"]["steps_per_s"],
        "summary_ops_stepped": runs["summary"]["held"],
        "checkpoints_compared": len(card_ck) + len(tail_ck),
        "launches": launched, "identical_to_oracle": True,
        "parts_s": parts_s, "phase_s": phase_s, "cap_s": DEBUGGER_CAP_S,
        "over_cap": phase_s > DEBUGGER_CAP_S,
    }
    emit(line)
    return line


# ------------------------------------------- phase 18: the network service plane

# Phase 18's sizes, as main() runs them: (b) phase 16's action mix over four
# loader containers, (c) 256 docs and one hot doc behind two launcher shards
# (the hot doc's shard at config-1 geometry, the other at config-3), 4
# network writers a doc.  The client leg's own size is 2,000 edits; the
# whole script took 1,186 s of its 1,200 s limit with it on an H100 80GB
# HBM3 at 700 W (the client leg 64 s), so it runs 1,000, and since 500
# (NET_REDUCED; ``CUTS`` says why).  The
# fleet leg's own size is 8 rounds; with phase 19 the script took 1,177 s on
# a slow host (the fleet leg's submits 24 s of 8 rounds on a faster one), so
# it runs 4, the hot doc on its lane for the last two (promoted after round
# 1, where its own size promotes it after round 3 and serves it there for 4).
NET_CLIENTS = dict(n_edits=500, reconnect_every=6, summary_ops=400)
NET_FLEET = dict(n_docs=256, writers=4, rounds=4, ops_per_round=16, hot_ops=64, ins_len=8,
                 sample=32, promote_after=1, seg_shards=4)
NET_REDUCED = {"clients": {"n_edits": "500 (of 2,000)"}, "fleet": {"rounds": "4 (of 8)"}}
NET_CAP_S = 150.0
NET_CLIENT_DOC = "net-client"
NET_HOT_DOC = "net-hot"


class _NetStringClients:
    """Phase 18's client leg: phase 16's four clients as loader
    ``Container``s over ``NetworkDocumentServiceFactory``, on the document's
    ``shard_index`` shard of a launcher deployment.  The document is made
    as ``tests/test_loader.py`` ``boot_doc`` makes it (a detached container
    with a ``sharedString`` "text" and a ``sharedMap`` "meta", attached and
    closed).  Each flush is followed by a sync of that client's connection,
    so the shard sequences the clients' ops in the order they were made.
    A drop and a rejoin go through the container's ``ConnectionManager``; a
    rehydrate through ``get_pending_local_state`` and ``Container.load``
    with the stash.  Every client runs a ``SummaryManager``; each sync ticks
    them, and the elected one summarizes to the shard's storage."""

    def __init__(self, device: str, geom: dict, dep, doc_id: str, summary_ops: int):
        from fluidframework_tpu_torch.dds import channels
        from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree
        from fluidframework_tpu_torch.driver.network_driver import NetworkDocumentServiceFactory
        from fluidframework_tpu_torch.loader import Container
        from fluidframework_tpu_torch.runtime.summary import SummaryConfig

        host, port, http_port = dep.endpoint_for(doc_id)
        self.factory = NetworkDocumentServiceFactory(host, port, http_port)
        self.make_kernel = lambda: KernelMergeTree(**geom, device=device)
        self.doc_id = doc_id
        self.config = SummaryConfig(max_ops=summary_ops)
        creator = Container.create_detached(channels.default_registry(), container_id="creator")
        ds = creator.runtime.create_datastore("root")
        ds.create_channel("sharedString", "text")
        ds.create_channel("sharedMap", "meta")
        creator.attach(doc_id, self.factory, "creator")
        self.factory.sync_all()
        creator.close()  # its leave is sequenced: it holds no MSN back
        self.managers: dict = {}
        self.clients = [self.load(f"C{i}", k) for i, k in enumerate(STRING_CLIENT_KINDS)]
        self.epoch = [0] * len(self.clients)
        self.factory.sync_all()
        self.sync_ms: list[float] = []

    def load(self, name: str, kind: str, stash: str | None = None):
        from fluidframework_tpu_torch.dds import channels
        from fluidframework_tpu_torch.loader import Container

        channels.set_string_backend_factory(self.make_kernel if kind == "k" else None)
        try:
            c = Container.load(self.doc_id, self.factory, channels.default_registry(), name,
                               stash=stash)
        finally:
            channels.set_string_backend_factory(None)
        self.managers[c] = c.make_summary_manager(self.config)
        return c

    def s(self, i: int):
        return self.clients[i].runtime.datastore("root").get_channel("text")

    def kernels(self) -> list:
        return [self.s(i).backend for i, k in enumerate(STRING_CLIENT_KINDS) if k == "k"]

    def _sync_one(self, c) -> None:
        conn = c.delta_manager.connection_manager.connection
        if conn is not None and conn.connected:
            conn.sync()

    def act(self, action: tuple) -> None:
        kind, i, *rest = action
        c = self.clients[i]
        if kind == "edit":
            _string_edit(self.s(i), rest[0])
        elif kind == "flush":
            c.runtime.flush()
            self._sync_one(c)
        elif kind == "sync":
            t = time.perf_counter()
            for x in self.clients:
                x.runtime.flush()
                self._sync_one(x)
            self.factory.sync_all()
            self.sync_ms.append((time.perf_counter() - t) * 1e3)
            if any(m.tick() for m in self.managers.values()):
                self.factory.sync_all()  # the summary op, then its ack
        elif kind == "drop":
            c.disconnect()
        elif kind == "rejoin":
            c.connect()  # the connection manager names the new epoch's client
            self.factory.sync_all()
        elif kind == "rehydrate":
            stash = c.get_pending_local_state()
            c.close()
            self.managers.pop(c, None)
            self.epoch[i] += 1
            self.clients[i] = self.load(f"C{i}.s{self.epoch[i]}", STRING_CLIENT_KINDS[i],
                                        stash=stash)
            self.factory.sync_all()
        else:
            raise ValueError(kind)

    def views(self, i: int) -> tuple:
        return _string_views(self.s(i))

    def stream(self) -> list:
        """The document's sequenced messages, read over the shard's HTTP
        delta storage."""
        storage = self.factory.create_document_service(self.doc_id).connect_to_delta_storage()
        return storage.get_deltas(1, 0)

    def summaries(self) -> list[str]:
        return [json.dumps(self.s(i).summarize(), sort_keys=True)
                for i in range(len(self.clients))]

    def close(self) -> None:
        for c in self.clients:
            c.close()
        for conn in list(self.factory.live_connections):
            conn.disconnect()


def _net_clients(seed: int, device: str, dep, geom: dict, n_edits: int, reconnect_every: int,
                 summary_ops: int) -> tuple:
    """Part (b): phase 16's seeded script over the network (see
    ``_NetStringClients``), then a late client loads on ``device`` from the
    newest snapshot over HTTP.  Returns the leg's figures, a kernel
    client's summary and the last sequence number (the squash
    regeneration's inputs)."""
    import torch

    from fluidframework_tpu_torch.dds.kernel_backend import KernelMergeTree

    fleet = _NetStringClients(device, geom, dep, NET_CLIENT_DOC, summary_ops)
    try:
        kinds = [type(s.backend).__name__ for s in map(fleet.s, range(4))]
        check(kinds == ["KernelMergeTree" if k == "k" else "RefMergeTree"
                        for k in STRING_CLIENT_KINDS],
              f"network clients: backends {kinds}")
        run = _string_client_run(device, geom, seed, n_edits, reconnect_every, fleet=fleet)
        check(run["regenerated"] > 0 and run["rehydrated"] == 1,
              "network clients: no op was regenerated, or the stash never rehydrated")
        check(run["errors"] == [0, 0], f"network clients: error latches {run['errors']}")
        summaries = fleet.summaries()
        check(all(x == summaries[0] for x in summaries[1:]),
              "network clients: a kernel replica's summary differs from the oracle's")
        acked = sum(m.acked for m in fleet.managers.values())
        check(acked > 0, "network clients: no summary was acked")
        status, snap = fleet.factory.http.request("GET", f"/doc/{NET_CLIENT_DOC}/snapshot")
        check(status == 200 and snap["seq"] > 0, "network clients: no summary snapshot stored")
        # The late client boots on the card from the newest snapshot.
        t = time.perf_counter()
        late = fleet.load("late", "k")
        fleet.factory.sync_all()
        if device == "cuda":
            torch.cuda.synchronize()
        boot_s = time.perf_counter() - t
        check(isinstance(late.runtime.datastore("root").get_channel("text").backend,
                         KernelMergeTree), "network clients: the late client is not on the kernel")
        check(_string_views(late.runtime.datastore("root").get_channel("text"))
              == fleet.views(0), "network clients: the late client differs")
        summary = run["kernels"][0].export_summary()
        last_seq = run["stream"][-1]["sequenceNumber"]
        late.close()
    finally:
        fleet.close()
    sync_ms = sorted(fleet.sync_ms)
    return {
        "doc": NET_CLIENT_DOC, "clients": STRING_CLIENT_KINDS, "geometry": geom,
        "edits": run["edits"], "syncs": run["syncs"], "reconnects": run["reconnects"],
        "stash_rehydrations": run["rehydrated"], "regenerated_ops": run["regenerated"],
        "sequenced": len(run["stream"]), "text_len": len(run["text"]),
        "summaries_acked": acked, "snapshot_seq": snap["seq"], "peak_nseg": run["peak_nseg"],
        "edits_per_s": run["edits_per_s"], "run_s": run["seconds"],
        "sync_p50_ms": sync_ms[len(sync_ms) // 2], "late_boot_s": boot_s,
        "summaries_equal": True,
    }, summary, last_seq


def _net_storage(dep, doc_id: str):
    """The document's HTTP delta storage on its shard."""
    from fluidframework_tpu_torch.driver.network_driver import NetworkDocumentServiceFactory

    factory = NetworkDocumentServiceFactory(*dep.endpoint_for(doc_id))
    return factory.create_document_service(doc_id).connect_to_delta_storage()


def _net_stream(dep, doc_id: str) -> list:
    """Every sequenced message of the document, read over HTTP."""
    return _net_storage(dep, doc_id).get_deltas(1, 0)


def _net_writer(dep, doc_id: str, client_id: str) -> tuple:
    """A ``SharedString`` writing over ``NetworkDeltaConnection`` to the
    document's shard; the prefix sequenced before it joined (earlier
    writers' joins and ops) is read over the shard's HTTP delta storage."""
    from fluidframework_tpu_torch.dds.shared_string import SharedString
    from fluidframework_tpu_torch.driver.network_driver import NetworkDeltaConnection

    host, port, _http_port = dep.endpoint_for(doc_id)
    ss = SharedString(client_id=client_id)
    conn = NetworkDeltaConnection(host, port, doc_id, client_id, "write", listener=ss.process,
                                  nack_listener=None, signal_listener=None)
    if conn.checkpoint_seq:
        for m in _net_storage(dep, doc_id).get_deltas(1, conn.checkpoint_seq):
            ss.process(m)
    return ss, conn


def _net_fleet_round(writers, counts, rng, ins_len: int) -> int:
    """One round of phase 2's mix through real writers: slot ``b`` of the
    round goes to writer ``b % W`` of every doc whose Zipf count passes
    ``b``; writer slots alternate an insert of ``ins_len`` letters at a
    random place of the writer's view and a remove of 2 characters there.
    Each submit waits for its connection's sync echo, so the shard
    sequences the ops in the order they were made and a run repeats
    message for message; every writer syncs at the round's end.  Returns
    the ops submitted."""
    W = len(writers[0])
    pair: dict = {}
    ops = 0
    for b in range(int(counts.max())):
        w = b % W
        insert = (b // W) % 2 == 0
        for d in np.nonzero(b < counts)[0].tolist():
            ss, conn = writers[d][w]
            n = len(ss.text)
            if insert or n < 2:
                pos = int(rng.integers(0, n + 1))
                ss.insert_text(pos, "".join(chr(int(c)) for c in rng.integers(97, 123, ins_len)))
                pair[d, w] = pos
            else:
                pos = min(pair.get((d, w), 0), n - 2)
                ss.remove_range(pos, pos + 2)
            for m in ss.take_outbox():
                conn.submit(m)
                ops += 1
            conn.sync()
    for ws in writers:
        for _ss, conn in ws:
            conn.sync()
    return ops


def _net_drain(fc, want: int, max_idle_pumps: int = 500) -> None:
    """``FleetConsumer.run_for`` without its closing step: pump until
    ``want`` op rows are staged (stepping only while flow control holds a
    doc paused)."""
    idle = 0
    while fc.rows_staged < want:
        if fc.paused_socks:
            fc.step()
        if fc.pump() == 0:
            idle += 1
            check(idle < max_idle_pumps, f"network fleet: firehose idle at "
                                         f"{fc.rows_staged}/{want} rows")
        else:
            idle = 0


def net_fleet_run(dep, doc_ids: list[str], engines: dict, writers: int, rounds: int,
                  counts, ins_len: int, seed: int, promote=None, sync=None) -> dict:
    """The fleet leg's traffic and consumers: ``writers`` network writers a
    doc, ``rounds`` rounds of ``_net_fleet_round`` with ``counts`` ops a
    round a doc (doc ``i`` of ``doc_ids`` takes ``counts[i]``), and one
    in-process ``FleetConsumer`` a shard over ``engines[shard]`` (its docs in
    ``doc_ids`` order).  After each round every consumer drains the round
    (``_net_drain``), steps and compacts; after round
    ``promote[0]`` the doc ``promote[1]`` (a doc id) is promoted onto a
    segment lane by ``enable_segment_sharding``.  Returns per-doc round
    bounds (the last seq of each round), each doc's writers' texts, the
    consumers' texts and the timings: the writers' connect and submit
    seconds, the consumers' firehose drain seconds (``drain_s``) and step
    and compact seconds (``step_s``)."""
    from fluidframework_tpu_torch.server.fleet_consumer import FleetConsumer
    from fluidframework_tpu_torch.server.launcher import shard_index

    rng = np.random.default_rng(seed)
    n_shards = len(dep.shards)
    by_shard = {s: [d for d in doc_ids if shard_index(d, n_shards) == s] for s in range(n_shards)}
    t = time.perf_counter()
    ws = [[_net_writer(dep, d, f"{d}-w{w}") for w in range(writers)] for d in doc_ids]
    for row in ws:
        for _ss, conn in row:
            conn.sync()
    connect_s = time.perf_counter() - t
    consumers = {}
    try:
        for s, docs in by_shard.items():
            if docs:
                consumers[s] = FleetConsumer("127.0.0.1", dep.shards[s].port, engines[s], docs)
        want = {s: 0 for s in consumers}
        bounds = {d: [] for d in doc_ids}
        submit_s = drain_s = step_s = 0.0
        ops = 0
        for r in range(rounds):
            t = time.perf_counter()
            n = _net_fleet_round(ws, counts, rng, ins_len)
            submit_s += time.perf_counter() - t
            ops += n
            for i, d in enumerate(doc_ids):
                bounds[d].append(ws[i][0][0].current_seq)
                want[shard_index(d, n_shards)] += int(counts[i])
            for s, fc in consumers.items():
                t = time.perf_counter()
                _net_drain(fc, want[s])
                drain_s += time.perf_counter() - t
                t = time.perf_counter()
                fc.step()
                fc.engine.compact()
                if sync is not None:
                    sync()
                step_s += time.perf_counter() - t
            if promote is not None and r == promote[0]:
                s = shard_index(promote[1], n_shards)
                row = by_shard[s].index(promote[1])
                check(engines[s].enable_segment_sharding(row),
                      "network fleet: enable_segment_sharding refused")
        writer_texts = {d: [ss.text for ss, _c in ws[i]] for i, d in enumerate(doc_ids)}
        texts = {d: engines[s].text(by_shard[s].index(d))
                 for s in consumers for d in by_shard[s]}
        rows = {s: fc.rows_staged for s, fc in consumers.items()}
    finally:
        for fc in consumers.values():
            fc.close()
        for row in ws:
            for _ss, conn in row:
                conn.disconnect()
    return {"by_shard": by_shard, "bounds": bounds, "writer_texts": writer_texts,
            "texts": texts, "rows": rows, "ops": ops, "connect_s": connect_s,
            "submit_s": submit_s, "drain_s": drain_s, "step_s": step_s}


def net_fleet_replay(engine, docs: list[str], rows: list[int], streams: dict, bounds: dict,
                     demote_at_end=()) -> None:
    """Feed ``engine`` the sequenced streams of ``docs`` (into engine rows
    ``rows``) round by round as the consumers took them: each round's
    wire lines through ``ingest_lines``, a step and a compact; then re-pack
    the rows in ``demote_at_end`` as a demotion from a segment lane does."""
    rounds = len(next(iter(bounds.values())))
    lo = {d: 0 for d in docs}
    for r in range(rounds):
        for d, row in zip(docs, rows):
            hi = bounds[d][r]
            lines = b"".join(m.wire_line() for m in streams[d] if lo[d] < m.seq <= hi)
            lo[d] = hi
            if lines:
                engine.ingest_lines(row, lines)
        engine.step()
        engine.compact()
    for row in demote_at_end:
        _repack(engine, row)


def _doc_rows_differ(a, rows_a, b, rows_b) -> list[int]:
    """The rows of ``rows_a`` whose raw state (every column, padding
    included) or error latch differs from ``b``'s ``rows_b``."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    ea, eb = np.asarray(a.errors()), np.asarray(b.errors())
    bad = []
    for ra, rb in zip(rows_a, rows_b):
        same = all(np.array_equal(x.cpu().numpy(), y.cpu().numpy()) for x, y in zip(
            mk.leaves(a.doc_state(ra)), mk.leaves(b.doc_state(rb))))
        if not same or ea[ra] != eb[rb]:
            bad.append(ra)
    return bad


def _net_fleet(seed: int, card: str, device: str, dep, n_docs: int, writers: int, rounds: int,
               ops_per_round: int, hot_ops: int, ins_len: int, sample: int, promote_after: int,
               seg_shards: int) -> dict:
    """Part (c): ``n_docs`` docs at config-3 geometry and a hot doc at
    config-1 geometry over the deployment's shards (``shard_index``), fed
    by ``net_fleet_run``.  The hot doc's shard serves its engine (all its
    docs at config-1 geometry) on a docs x segs mesh with ``seg_shards``
    segment shards; the hot doc goes onto a lane after round
    ``promote_after`` and is demoted at the end.  Checks: no error bits,
    every doc's text equals its writers', and the raw rows and latches of
    ``sample`` sampled docs and the hot doc equal a CPU engine's fed the
    same streams read back over each shard's HTTP delta storage."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.parallel.mesh import docs_segs_mesh
    from fluidframework_tpu_torch.server.launcher import shard_index

    on_card = device == "cuda"
    cold = [f"net{d}" for d in range(n_docs)]
    doc_ids = [NET_HOT_DOC] + cold
    n_shards = len(dep.shards)
    hot_shard = shard_index(NET_HOT_DOC, n_shards)
    counts = np.concatenate([[hot_ops], zipf_counts(n_docs, ops_per_round, 1.1)])
    by_shard = {s: [d for d in doc_ids if shard_index(d, n_shards) == s] for s in range(n_shards)}
    cold_geom = dict(FLEET_GEOM, recovery="grow")
    geoms = {s: (dict(HOT_GEOM, recovery="grow") if s == hot_shard else cold_geom)
             for s in range(n_shards)}
    engines = {}
    for s, docs in by_shard.items():
        if s == hot_shard:
            mesh = docs_segs_mesh([device] * (2 * seg_shards), seg_shards=seg_shards)
            engines[s] = DocBatchEngine(len(docs), mesh=mesh, doc_keys=docs, **geoms[s])
        else:
            engines[s] = DocBatchEngine(len(docs), device=device, doc_keys=docs, **geoms[s])
    sync = torch.cuda.synchronize if on_card else None
    t0 = time.perf_counter()
    run = net_fleet_run(dep, doc_ids, engines, writers, rounds, counts, ins_len, seed,
                        promote=(promote_after, NET_HOT_DOC), sync=sync)
    run_s = time.perf_counter() - t0
    hot_eng, hot_row = engines[hot_shard], by_shard[hot_shard].index(NET_HOT_DOC)
    check(hot_row in hot_eng.seg_lanes, "network fleet: the hot doc is not on a segment lane")
    lane = {"seg_occupancy": hot_eng.health()["seg_occupancy"],
            "seg_promotions": hot_eng.health()["seg_promotions"]}
    check(hot_eng.disable_segment_sharding(hot_row), "network fleet: the demotion refused")
    for s, eng in engines.items():
        check(eng.error_count() == 0 and not eng.overflow and not eng.quarantine,
              f"network fleet: shard {s} latched, overflowed or quarantined")
    for d in doc_ids:
        w = run["writer_texts"][d]
        check(all(x == w[0] for x in w[1:]), f"network fleet: {d}'s writers diverged")
        check(run["texts"][d] == w[0], f"network fleet: {d}'s engine text differs from its writers'")
    # The CPU replay: sampled docs of each shard (the hot doc among them).
    rng = np.random.default_rng(seed + 18)
    picked = set(rng.choice(cold, size=min(sample, n_docs), replace=False).tolist())
    t = time.perf_counter()
    replayed = 0
    for s, docs in by_shard.items():
        mine = [d for d in docs if d in picked or d == NET_HOT_DOC]
        if not mine:
            continue
        streams = {d: _net_stream(dep, d) for d in mine}
        cpu = DocBatchEngine(len(mine), device="cpu", doc_keys=mine, **geoms[s])
        rows = list(range(len(mine)))
        demote = [mine.index(NET_HOT_DOC)] if NET_HOT_DOC in mine else []
        net_fleet_replay(cpu, mine, rows, streams, run["bounds"], demote_at_end=demote)
        bad = _doc_rows_differ(engines[s], [docs.index(d) for d in mine], cpu, rows)
        check(not bad, f"network fleet: shard {s} rows {bad} differ from the CPU replay")
        replayed += len(mine)
    replay_s = time.perf_counter() - t
    stats = {}
    for s, shard in enumerate(dep.shards):
        conn = http.client.HTTPConnection("127.0.0.1", shard.http_port, timeout=30)
        try:
            conn.request("GET", "/status")
            resp = conn.getresponse()
            status, body = resp.status, json.loads(resp.read())
        finally:
            conn.close()
        check(status == 200, f"network fleet: shard {s} /status answered {status}")
        stats[shard.name] = {"docs": body["n_docs"],
                             "sequenced": sum(v["log_depth"] for v in body["docs"].values())}
    rows = sum(run["rows"].values())
    return {
        "docs": len(doc_ids), "hot_doc": NET_HOT_DOC, "hot_shard": dep.shards[hot_shard].name,
        "geometry": {dep.shards[s].name: {"docs": len(docs), "hot_doc": s == hot_shard,
                                          **{k: v for k, v in geoms[s].items() if k != "recovery"}}
                     for s, docs in by_shard.items()},
        "writers": writers, "rounds": rounds,
        "ops": run["ops"], "rows": run["rows"], "seg_shards": seg_shards, "lane": lane,
        "connect_s": run["connect_s"], "submit_s": run["submit_s"],
        "submit_ops_per_s": run["ops"] / run["submit_s"],
        "drain_s": run["drain_s"], "step_s": run["step_s"],
        "firehose_to_device_ops_per_s": rows / (run["drain_s"] + run["step_s"]), "run_s": run_s,
        "replayed_docs": replayed, "replay_s": replay_s, "shard_stats": stats,
        "texts": run["texts"], "by_shard": run["by_shard"],
    }


def _net_entry(device: str, dep, fleet: dict) -> dict:
    """``python -m fluidframework_tpu_torch.server.fleet_main`` on the shard
    without the hot doc, over that shard's docs: its catch-up replays the
    whole firehose, and its last status line's texts must equal the
    in-process consumer's."""
    shard = next(s for s in dep.shards if s.name != fleet["hot_shard"])
    si = dep.shards.index(shard)
    docs = fleet["by_shard"][si]
    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "fluidframework_tpu_torch.server.fleet_main",
           "--port", str(shard.port), "--docs", ",".join(docs), "--device", device,
           "--capacity", str(FLEET_GEOM["max_segments"]),
           "--text-capacity", str(FLEET_GEOM["text_capacity"]),
           "--max-insert-len", str(FLEET_GEOM["max_insert_len"]),
           "--ops-per-step", str(FLEET_GEOM["ops_per_step"]),
           "--megastep-k", str(FLEET_GEOM["megastep_k"]), "--status-every", "600",
           "--exit-after-rows", str(fleet["rows"][si])]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=repo)
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"network entry: fleet_main exited {proc.returncode}: "
                                f"{proc.stderr[-1500:]}")
    last = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")][-1]
    check(last.get("done") and last["errors"] == 0, "network entry: fleet_main did not end clean")
    check(last["texts"] == {d: fleet["texts"][d] for d in docs},
          "network entry: fleet_main's texts differ from the in-process consumer's")
    return {"shard": shard.name, "docs": len(docs), "rows": fleet["rows"][si], "run_s": wall}


def phase_network(seed: int, card: str, device: str, path=None) -> dict:
    """Phase 18 at ``NET_CLIENTS`` and ``NET_FLEET``: (a) ``launcher.launch``
    brings up two netserver shards of the port as processes; (b) the
    client leg (``_net_clients``), then the squash regeneration on a kernel
    replica restored from a kernel client's summary (the runtime never
    asks for squash), and (c) the fleet leg (``_net_fleet``), each a path
    of its own through ``path`` (``network_clients``, ``network_squash``,
    ``network_fleet``); then (d) ``fleet_main`` over one shard's docs
    (``_net_entry``)."""
    from fluidframework_tpu_torch.server.launcher import launch

    clients, fleet = NET_CLIENTS, NET_FLEET
    run = path if path is not None else (lambda _name, fn, *a, **kw: fn(*a, **kw))
    t0 = time.perf_counter()
    # Writers and consumers hold a socket each here (the shards' ends are
    # in their own processes).
    limit = _raise_fd_limit(fleet["writers"] * (fleet["n_docs"] + 1) + fleet["n_docs"] + 512)
    line = {"phase": "network", "card": card, "fd_limit": limit}
    t = time.perf_counter()
    dep = launch({"shards": [{"name": "s0"}, {"name": "s1"}]})
    line["launch_s"] = time.perf_counter() - t
    parts_s = {}
    try:
        line["shards"] = dep.manifest()["shards"]
        t = time.perf_counter()
        geom = dict(STRING_CLIENT_GEOM)
        line["clients"], summary, last_seq = run("network_clients", _net_clients, seed, device,
                                                 dep, geom, **clients)
        parts_s["clients"] = time.perf_counter() - t
        t = time.perf_counter()
        plans, _sq = run("network_squash", _squash_regeneration, device, geom, summary,
                         last_seq, seed)
        check(not plans[0], "network clients: the pending obliterate was not retired")
        line["clients"]["squash_plans"] = len(plans)
        parts_s["squash"] = time.perf_counter() - t
        t = time.perf_counter()
        out = run("network_fleet", _net_fleet, seed, card, device, dep, **fleet)
        parts_s["fleet"] = time.perf_counter() - t
        t = time.perf_counter()
        line["entry"] = _net_entry(device, dep, out)
        parts_s["entry"] = time.perf_counter() - t
        out.pop("texts")
        out.pop("by_shard")
        line["fleet"] = out
    finally:
        dep.stop()
    phase_s = time.perf_counter() - t0
    line.update({"parts_s": parts_s, "phase_s": phase_s, "cap_s": NET_CAP_S,
                 "over_cap": phase_s > NET_CAP_S, "reduced": NET_REDUCED})
    emit(line)
    return line


# ------------------------------------------------- phase 19: the chaos soak

# The reference's headline soak (``bench.py --config soak``, :2117-2140):
# ChaosStack's own engine geometry, every fault kind twice, warm standbys,
# bounded-staleness checkpoint writers; the tree engine on a mesh of 8
# shards on the card, the plane's documents on the native deli.
CHAOS_SOAK = dict(seed=10, ticks=240, n_docs=6, n_tree_docs=3, events_per_kind=2,
                  standby=True, ckpt_stale_seconds=0.25, churn_rate=0.08, tree_shards=8,
                  native_sequencer=True)
# The reference's mixed-fleet chaos smoke (tests/test_chaos.py:502): its two
# migrate events move tree docs, where the soak's (seed 10) both target
# string docs, which ChaosStack serves unsharded, so they are skip-counted
# there as in the reference.
CHAOS_MIGRATE = dict(seed=16, ticks=30, n_docs=2, n_tree_docs=2, standby=True,
                     ckpt_stale_seconds=0.25, tree_shards=8, native_sequencer=True,
                     events=[(5, "nack_storm", "cd0", 4), (8, "migrate", "td1", 0),
                             (12, "fleet_kill", "", 0), (18, "torn_socket", "td0", 0),
                             (22, "migrate", "td0", 0)])
CHAOS_TIMEOUT_S = 480
# The child's code: torch and the card first, so its RSS there is that of a
# bare CUDA-initialised torch process, then the soak.
_CHAOS_CHILD = (
    "import resource, sys, torch\n"
    "torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
    "rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0\n"
    "import chip_smoke\n"
    "chip_smoke._chaos_child_main(rss0)\n"
)


def _chaos_programs() -> dict:
    from fluidframework_tpu_torch.models import doc_batch_engine as dbe
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    return {"apply_megastep": mk.apply_megastep, "compact": mk.compact,
            "apply_nested_megastep": tk.apply_nested_megastep,
            "compact_nested": tk.compact_nested, "scatter_rows": dbe.scatter_rows,
            "gather_cohort": dbe.gather_cohort, "scatter_cohort": dbe.scatter_cohort}


def _chaos_child_main(rss_cuda_init_mb: float) -> None:
    """Phase 19's process: the soak on the card, then the migration smoke,
    each a path of its own (the launch counts set to 0 just before it and
    read just after).  Prints one JSON line."""
    import resource

    from fluidframework_tpu_torch.native import native_available
    from fluidframework_tpu_torch.testing.chaos import (
        ChaosEvent, ChaosSchedule, run_chaos, run_soak,
    )

    progs = _chaos_programs()
    out = {"rss_cuda_init_mb": rss_cuda_init_mb, "native_available": native_available()}

    def launches():
        return {name: fn.launches for name, fn in progs.items()}

    for fn in progs.values():
        fn.launches = 0
    t = time.perf_counter()
    out["soak"] = run_soak(device="cuda", **dict(CHAOS_SOAK, **CUTS["chaos"]))
    out["soak_s"] = time.perf_counter() - t
    out["soak_launches"] = launches()
    out["rss_after_soak_mb"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    cfg = dict(CHAOS_MIGRATE)
    schedule = ChaosSchedule(seed=cfg["seed"], events=[
        ChaosEvent(*e) for e in cfg.pop("events")])
    for fn in progs.values():
        fn.launches = 0
    t = time.perf_counter()
    rep = run_chaos(schedule=schedule, device="cuda", **cfg)
    out["migrate_s"] = time.perf_counter() - t
    out["migrate_launches"] = launches()
    out["migrate"] = {k: rep[k] for k in ("invariants", "counters", "recovery", "devices",
                                          "sequencer", "events_by_kind")}
    out["migrate"]["n_shards"] = rep["tree"]["n_shards"]
    print(json.dumps(out), flush=True)


def phase_chaos(card: str, paths: dict | None = None) -> dict:
    """Phase 19: the chaos soak over the whole serving stack on the card,
    in a fresh process (as ``bench.py:2075`` runs it), so no other phase
    warms the restores its recovery percentiles measure.  Fails unless
    every invariant held (``run_chaos`` raises otherwise: byte identity
    of every doc against the reference's fault-free oracles, no double
    acks, bounded queues, bounded recovery; ``run_soak`` the RSS bound),
    every fault kind fired, both families promoted a standby at each fleet
    kill, the engines' state was on the card, the native deli sequenced
    every document, K2, K3, K7 and K8 launched on the soak, and the
    migration smoke moved a tree doc between its 8 shards."""
    import torch

    from fluidframework_tpu_torch.testing.chaos import EVENT_KINDS

    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CHAOS_CHILD], cwd=root, capture_output=True, text=True,
            timeout=CHAOS_TIMEOUT_S,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (root, os.environ.get("PYTHONPATH")) if p)},
        )
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"chaos: the soak's process ran past {CHAOS_TIMEOUT_S} s") from e
    phase_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"chaos: the soak's process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    soak, mig = out["soak"], out["migrate"]
    inv, c, rec = soak["invariants"], soak["counters"], soak["recovery"]
    fired = {
        "fleet_kill": c["fleet_restarts"], "torn_socket": c["torn_sockets"],
        "nack_storm": soak["admission"]["shed_ops"], "scribe_kill": c["scribe_kills"],
        "scribe_crash": c["scribe_crashes"], "migrate": c["doc_migrations"] + c["migrations_skipped"],
        "fsync_delay": soak["events_by_kind"].get("fsync_delay", 0),
    }
    check(out["native_available"], "chaos: the native sequencer library did not build")
    check(soak["sequencer"] == ["NativeSequencer"] and mig["sequencer"] == ["NativeSequencer"],
          f"chaos: documents sequenced by {soak['sequencer']}, {mig['sequencer']}")
    check(all(d.startswith("cuda") for d in (*soak["devices"].values(), *mig["devices"].values())),
          f"chaos: engine state on {soak['devices']}, {mig['devices']}")
    check(inv["converged_docs"] == CHAOS_SOAK["n_docs"]
          and inv["tree_converged_docs"] == CHAOS_SOAK["n_tree_docs"], f"chaos: {inv}")
    check(inv["double_acks"] == 0, "chaos: double acks")
    check(inv["max_queue_depth"] <= inv["queue_depth_bound"]
          and inv["max_tree_queue_depth"] <= inv["tree_queue_depth_bound"], f"chaos: {inv}")
    check(set(soak["events_by_kind"]) >= set(EVENT_KINDS)
          and all(n > 0 for n in fired.values()), f"chaos: faults fired {fired}")
    check(c["standby_promotions"] == 2 * c["fleet_restarts"],
          f"chaos: {c['standby_promotions']} promotions for {c['fleet_restarts']} kills of 2 families")
    bound = inv["recovery_bound_ms"]
    check(rec["incidents"] >= 1 and rec["tree_incidents"] >= 1
          and 0 < soak["recovery_p99_ms"] <= bound and 0 < soak["tree_recovery_p99_ms"] <= bound,
          f"chaos: recovery {rec}")
    check(soak["soak_rss_mb"] < soak["rss_bound_mb"], "chaos: RSS bound")
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"),
                       ("apply_nested_megastep", "K7"), ("compact_nested", "K8")):
        check(out["soak_launches"][prog] > 0, f"{what} was never launched on the chaos path")
    check(mig["counters"]["doc_migrations"] >= 1 and mig["n_shards"] == 8
          and mig["invariants"]["tree_converged_docs"] == CHAOS_MIGRATE["n_tree_docs"],
          f"chaos: migration smoke {mig['counters']}, {mig['n_shards']} shards")
    if paths is not None:
        for name, key in (("chaos", "soak_launches"), ("chaos_migrate", "migrate_launches")):
            for prog, n in out[key].items():
                if prog in paths:
                    paths[prog][name] = n
    line = {
        "phase": "chaos", "card": card, "config": dict(CHAOS_SOAK, **CUTS["chaos"]),
        "phase_s": phase_s, "soak_s": out["soak_s"], "migrate_s": out["migrate_s"],
        "duration_s": soak["duration_s"], "ops_sequenced": soak["ops_sequenced"],
        "ops_per_sec": soak["ops_per_sec"], "p50_ms": soak["p50_ms"], "p99_ms": soak["p99_ms"],
        **{k: soak[k] for k in ("recovery_p50_ms", "recovery_p99_ms", "tree_recovery_p50_ms",
                                "tree_recovery_p99_ms", "events_by_kind", "counters",
                                "admission", "scribe", "invariants", "devices", "sequencer")},
        "fired": fired, "recovery_intervals_ms": rec["intervals_ms"],
        "tree_recovery_intervals_ms": rec["tree_intervals_ms"],
        **{k: soak[k] for k in ("max_rss_mb", "rss_baseline_mb", "soak_rss_mb", "rss_bound_mb")},
        "rss_cuda_init_mb": out["rss_cuda_init_mb"], "rss_after_soak_mb": out["rss_after_soak_mb"],
        "native_sequencer": out["native_available"] and soak["sequencer"] == ["NativeSequencer"],
        "launches": out["soak_launches"],
        "migrate": {"counters": mig["counters"], "n_shards": mig["n_shards"],
                    "launches": out["migrate_launches"],
                    "recovery_p99_ms": mig["recovery"]["recovery_p99_ms"],
                    "tree_recovery_p99_ms": mig["recovery"]["tree_recovery_p99_ms"]},
    }
    emit(line)
    return line


# ------------------------------------------------- phase 20: native plane

NATIVE_PLANE = "fluidframework_tpu_torch.parallel.native_plane"
# Phase 20(b): the fleet's traffic for its first 256 docs and 4 rounds into an
# engine of 1,024 docs on each plane: a busy quarter of the fleet, so every
# step is a cohort step (the cohort gather and scatter and K4 on the card).
NATIVE_ENGINE = dict(n_docs=1024, fed_docs=256, rounds=4, watchdog_every=2)
NATIVE_TIMEOUT_S = 300
# The child's code: the plane comes from FFTPU_TORCH_DISPATCH_PLANE, set by
# the parent, so the engines' first dispatch_plane() resolves it.
_NATIVE_CHILD = (
    "import sys, torch\n"
    "torch.zeros(1, device='cuda'); torch.cuda.synchronize()\n"
    "import chip_smoke\n"
    "chip_smoke._native_child_main(sys.argv[1])\n"
)


def _leaves_diff(a, b) -> int:
    """The largest absolute difference over every raw column of two
    states (tensors on the card), 0 when they are equal byte for byte."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    err = 0
    for x, y in zip(mk.leaves(a), mk.leaves(b)):
        check(x.shape == y.shape and x.dtype == y.dtype, "native plane: leaf shapes differ")
        if not x.equal(y):
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def _native_child_main(path: str) -> None:
    """Phase 20(b)'s process: the same traffic into a ``DocBatchEngine`` on
    the plane ``FFTPU_TORCH_DISPATCH_PLANE`` selected (the native one) and
    one on the torch plane, both with ``device="cuda"``; checkpoints
    restored across the planes both ways; a seg-shard request on the
    native plane.  Prints one JSON line."""
    import importlib

    import torch

    from fluidframework_tpu_torch.models import dispatch
    from fluidframework_tpu_torch.models.doc_batch_engine import (
        DocBatchEngine, gather_cohort, scatter_cohort,
    )
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.protocol.messages import SequencedMessage
    from fluidframework_tpu_torch.server.ordered_log import CheckpointStore

    with open(path) as f:
        data = json.load(f)
    n_docs, fed, geom = data["n_docs"], data["fed_docs"], data["geom"]
    joins = [(d, SequencedMessage.from_json(m)) for d, m in data["joins"]]
    rounds = [[(d, SequencedMessage.from_json(m)) for d, m in rnd] for rnd in data["rounds"]]
    native = dispatch.dispatch_plane()
    out = {"selected_plane": native.__name__,
           "env": os.environ.get(dispatch.PROVIDER_ENV)}
    check(native.__name__ == NATIVE_PLANE, f"native_plane: the variable selected {native.__name__}")
    torch_plane = importlib.import_module("fluidframework_tpu_torch.parallel.mesh")
    progs = {"apply_megastep": mk.apply_megastep, "compact": mk.compact,
             "gather_cohort": gather_cohort, "scatter_cohort": scatter_cohort}
    work = tempfile.mkdtemp(prefix="native_plane_")

    def make(plane, ckpt: str):
        dispatch.register_dispatch_plane(plane)
        return DocBatchEngine(n_docs, device="cuda", use_mesh=False,
                              checkpoint_store=CheckpointStore(ckpt),
                              watchdog_every=NATIVE_ENGINE["watchdog_every"], **geom)

    def run(plane, name: str):
        eng = make(plane, os.path.join(work, name))
        for fn in progs.values():
            fn.launches = 0
        for d, m in joins:
            eng.ingest(d, m)
        ops = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for msgs in rounds:
            eng.ingest_batch([d for d, _ in msgs], [m for _, m in msgs])
            eng.step()
            eng.compact()
            ops += len(msgs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        check(not eng.errors().any(), f"native_plane: error bits on the {name} plane")
        out[name] = {"ops": ops, "wall_s": wall, "ops_per_s": ops / wall,
                     "launches": {k: fn.launches for k, fn in progs.items()},
                     "device": str(eng.state.nseg.device),
                     "full_steps": eng.full_steps, "cohort_steps": eng.cohort_steps,
                     "health": {k: eng.health().get(k, 0) for k in (
                         "megastep_dispatches", "watchdog_checks")}}
        return eng

    eng_n = run(native, "native")
    eng_t = run(torch_plane, "torch")
    out["engine_max_abs_err"] = _leaves_diff(eng_n.state, eng_t.state)
    texts = [eng_t.text(d) for d in range(n_docs)]
    check([eng_n.text(d) for d in range(n_docs)] == texts, "native_plane: texts differ")
    check(out["engine_max_abs_err"] == 0, "native_plane: the two planes' states differ")
    check(out["native"]["launches"]["apply_megastep"] == 0
          and out["native"]["launches"]["compact"] == 0,
          f"native_plane: K2/K3 launched on the native plane {out['native']['launches']}")
    check(out["native"]["cohort_steps"] > 0
          and out["native"]["launches"]["gather_cohort"] > 0,
          "native_plane: the cohort programs never ran on the card")
    check(all(out[p]["device"].startswith("cuda") for p in ("native", "torch")),
          "native_plane: engine state off the card")

    restores = {}
    for src, eng, reader, name in ((os.path.join(work, "native"), eng_n, torch_plane,
                                    "native-to-torch"),
                                   (os.path.join(work, "torch"), eng_t, native,
                                    "torch-to-native")):
        eng.maybe_checkpoint(force=True)
        t = time.perf_counter()
        back = make(reader, src)
        restored = sorted(back.restore_from_checkpoints())
        with _host_views(eng, back):
            same = sum(_docs_equivalent(eng, d, back, d) for d in range(n_docs))
        restores[name] = {"docs": len(restored), "equivalent": same,
                          "s": time.perf_counter() - t}
        check(restored == list(range(fed)) and same == n_docs,
              f"native_plane: {name} restore {restores[name]}")
        del back
    out["restores"] = restores

    dispatch.register_dispatch_plane(native)
    seg = DocBatchEngine(8, device="cuda", seg_shards=2, max_segments=64, text_capacity=512)
    out["seg_plane_unsupported"] = seg.health().get("seg_plane_unsupported", 0)
    out["seg_shards_after"] = seg.seg_shards
    check(out["seg_plane_unsupported"] == 1 and seg.seg_shards == 1,
          f"native_plane: seg request {out['seg_plane_unsupported']}, {seg.seg_shards}")
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out), flush=True)


def phase_native_plane(card: str, traffic, ring: dict, paths: dict | None = None) -> dict:
    """Phase 20: the native dispatch plane (``parallel/native_plane.py``
    over ``native/megastep.cpp``, host C++ built with g++) against the
    card's fleet programs.  (a) On ``fleet_ring``'s state and ring
    ([8, 10,000, 16] at config 3): K2 on the card and the native megastep
    (its columns copied out of the card, stepped on the host, copied back)
    must give every raw column and the error latch byte for byte, and so
    must K3 and the native compact over the 10,000 docs; K2's call time,
    the native loop's host time and the two copies.  (b) In a fresh
    process whose ``FFTPU_TORCH_DISPATCH_PLANE`` names the native plane:
    the fleet's traffic for its first 256 docs and 4 rounds through a
    1,024-doc engine on each plane (``device="cuda"``, cohort steps):
    equal raw state and texts, no K2 or K3 on the native plane (the cohort
    programs and K4 on the card), checkpoints restored across the planes
    both ways, and a seg-shard request downgraded with
    ``seg_plane_unsupported`` = 1."""
    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import _fleet_compact_body
    from fluidframework_tpu_torch.native import megastep_native as mn
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    t0 = time.perf_counter()
    check(mn.available(), "native_plane: libtpumegastep did not build")
    state, dev_ops, dev_pays = ring["state"], ring["ops"], ring["pays"]
    kinds, mins = ring["kinds"], ring["mins"]
    n_ops = int((kinds != 0).sum())
    torch.cuda.synchronize()
    k2_ms = cuda_ms(lambda: mk.apply_megastep(state, dev_ops, dev_pays, kinds=kinds), 2, warmup=1)
    after = mk.apply_megastep(state, dev_ops, dev_pays, kinds=kinds)
    torch.cuda.synchronize()

    def native(st, fn, *args):
        """One native dispatch in its three parts, each timed on the host
        clock (the copies end synchronised)."""
        t = time.perf_counter()
        cols = mn.state_columns(st)
        host_args = [a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in args]
        t_out = time.perf_counter()
        fn(cols, *host_args)
        t_loop = time.perf_counter()
        got = mn.unpack_columns(st, cols)
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        return got, {"copy_out_ms": (t_out - t) * 1e3, "loop_ms": (t_loop - t_out) * 1e3,
                     "copy_in_ms": (t_in - t_loop) * 1e3, "total_ms": (t_in - t) * 1e3}

    nat_after, mega = native(state, mn.run_megastep, dev_ops, dev_pays)
    err2 = _leaves_diff(nat_after, after)
    check(err2 == 0, f"native_plane: the native megastep differs from K2 by {err2}")
    check(int(torch.count_nonzero(nat_after.error)) == int(torch.count_nonzero(after.error)),
          "native_plane: error latches differ")
    del nat_after
    k3_ms = cuda_ms(lambda: _fleet_compact_body(after, mins), 3, warmup=1)
    k3_after = _fleet_compact_body(after, mins)
    nat_compact, comp = native(after, mn.run_compact, mins)
    err3 = _leaves_diff(nat_compact, k3_after)
    check(err3 == 0, f"native_plane: the native compact differs from K3 by {err3}")
    state_bytes = nbytes_of(mk.leaves(state))
    del nat_compact, k3_after, after
    part_a_s = time.perf_counter() - t0

    # (b) a fresh process selecting the plane through the variable.
    t1 = time.perf_counter()
    joins, rounds_msgs = traffic
    fed = NATIVE_ENGINE["fed_docs"]
    payload = {
        "n_docs": NATIVE_ENGINE["n_docs"], "fed_docs": fed, "geom": FLEET_GEOM,
        "joins": [(d, m.to_json()) for d, m in joins if d < fed],
        "rounds": [[(d, m.to_json()) for d, m in rnd if d < fed]
                   for rnd in rounds_msgs[:NATIVE_ENGINE["rounds"]]],
    }
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump(payload, f)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _NATIVE_CHILD, f.name], cwd=root, capture_output=True,
            text=True, timeout=NATIVE_TIMEOUT_S,
            env={**os.environ, "FFTPU_TORCH_DISPATCH_PLANE": NATIVE_PLANE,
                 "PYTHONPATH": os.pathsep.join(
                     p for p in (root, os.environ.get("PYTHONPATH")) if p)},
        )
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"native_plane: the engine process ran past {NATIVE_TIMEOUT_S} s") from e
    finally:
        os.unlink(f.name)
    check(proc.returncode == 0,
          f"native_plane: the engine process exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if paths is not None:  # the native-plane engine's launches, in its process
        for prog, n in child["native"]["launches"].items():
            paths[prog]["native_plane"] = n
    line = {
        "phase": "native_plane", "card": card,
        "ring": {"shape": [ring["K"], ring["n_docs"], FLEET_GEOM["ops_per_step"]],
                 "ops": n_ops, "state_bytes": state_bytes},
        "k2_call_ms": k2_ms, "native_megastep": mega, "megastep_max_abs_err": err2,
        "k3_call_ms": k3_ms, "native_compact": comp, "compact_max_abs_err": err3,
        "native_loop_ops_per_s": n_ops / (mega["loop_ms"] / 1e3),
        "part_a_s": part_a_s, "part_b_s": time.perf_counter() - t1,
        "engine": child, "phase_s": time.perf_counter() - t0,
    }
    emit(line)
    return line


# ------------------------------------------------------ phase 21: loadgen

# bench.py --config loadgen's size (bench.py:2423-2430): seed 17, 6 workers
# on a host with 8 CPUs or more (else 4), 2 shards, ramp 8, steady 24,
# boots 6, the default doc matrix (string 2, tree 1, map 1, matrix 1,
# chan_string 1): three fleet processes on the card.
LOADGEN = dict(seed=17, n_shards=2, ramp_ops=8, steady_ops=24, boots=6, deadline_s=600.0)
LOADGEN_TIMEOUT_S = 660
_LOADGEN_CHILD = "import chip_smoke\nchip_smoke._loadgen_child_main()\n"


def _loadgen_child_main() -> None:
    """Phase 21's process: ``run_loadgen`` at the bench's loadgen size with
    the fleets (and the coordinator's scribe pool) on the card.  Prints
    one JSON line; on a failure, the tails of the plant's stderr files."""
    from fluidframework_tpu_torch.loadgen.coordinator import run_loadgen

    n_cpus = os.cpu_count() or 1
    n_workers = 6 if n_cpus >= 8 else 4
    workdir = tempfile.mkdtemp(prefix="loadgen_")
    t = time.perf_counter()
    try:
        rep = run_loadgen(workdir, n_workers=n_workers, device="cuda", **LOADGEN)
    except BaseException:
        for name in sorted(os.listdir(workdir)):
            if name.endswith(".err"):
                with open(os.path.join(workdir, name)) as f:
                    tail = f.read()[-1500:]
                if tail.strip():
                    print(f"--- {name}\n{tail}", file=sys.stderr)
        raise
    wall = time.perf_counter() - t
    shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"report": rep, "wall_s": wall, "cpus": n_cpus,
                      "n_workers": n_workers}), flush=True)


def phase_loadgen(card: str, paths: dict | None = None) -> dict:
    """Phase 21: the loadgen traffic plant (``loadgen/``) in a process of
    its own: 2 netserver shards, the string and tree fleets
    (``fleet_main --device cuda``) behind ``FleetConsumer``, worker OS
    processes over real TCP across five channel families, through ramp,
    steady, boot storm and drain.  Fails unless the verdict is
    byte-identical for every family, no summary was double-acked, no
    foreign presence arrived, the historian served 304s, every fleet's
    state was on the card and launched its fleet programs (K2 and K3, or
    K7 and K8), and no worker initialised CUDA."""
    from fluidframework_tpu_torch.loadgen.coordinator import DEFAULT_DOC_MATRIX

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _LOADGEN_CHILD], cwd=root, capture_output=True, text=True,
            timeout=LOADGEN_TIMEOUT_S,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (root, os.environ.get("PYTHONPATH")) if p)},
        )
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"loadgen: the plant's process ran past {LOADGEN_TIMEOUT_S} s") from e
    phase_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"loadgen: the plant's process exited {proc.returncode}:\n{proc.stderr[-6000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    rep = out["report"]
    conv = rep["convergence"]
    check(conv["verdict"] == "byte-identical" and conv["converged_docs"] == DEFAULT_DOC_MATRIX,
          f"loadgen: convergence {conv}")
    check(rep["scribe"]["double_acks"] == 0, "loadgen: double acks")
    check(rep["presence"]["foreign"] == 0 and rep["presence"]["fanout_scope_drops"] > 0,
          f"loadgen: presence {rep['presence']}")
    check(rep["boot_storm"]["historian"]["not_modified_304"] > 0,
          f"loadgen: historian {rep['boot_storm']['historian']}")
    programs = {"string": ("apply_megastep", "compact"),
                "tree": ("apply_nested_megastep", "compact_nested")}
    fleets = rep["server"]["fleets"]
    check(len(fleets) == 3, f"loadgen: {len(fleets)} fleet processes")
    for fl in fleets:
        check(str(fl["device"]).startswith("cuda"), f"loadgen: a fleet on {fl['device']}")
        for prog in programs[fl["family"]]:
            check(fl["launches"][prog] > 0,
                  f"loadgen: {prog} never launched in the {fl['family']} fleet {fl['docs']}")
    check(not any(rep["workers_cuda_initialized"].values()),
          f"loadgen: workers initialised CUDA {rep['workers_cuda_initialized']}")
    if paths is not None:  # the fleets' launches, each in its own process
        for fl in fleets:
            for prog, n in fl["launches"].items():
                paths[prog]["loadgen"] = paths[prog].get("loadgen", 0) + n
    line = {
        "phase": "loadgen", "card": card,
        "config": dict(LOADGEN, n_workers=out["n_workers"], cpus=out["cpus"],
                       doc_matrix=DEFAULT_DOC_MATRIX),
        "phase_s": phase_s, "run_s": out["wall_s"],
        "phases": rep["phases"], "boot_storm": {k: rep["boot_storm"][k] for k in (
            "cold", "not_modified", "historian")},
        "ops_sequenced": rep["client"]["ops_sequenced"], "client": rep["client"],
        "fleets": [{k: v for k, v in fl.items() if k != "states"} for fl in fleets],
        "convergence": conv, "scribe": rep["scribe"], "presence": rep["presence"],
        "admission_shed_ops": rep["server"]["admission_shed_ops"],
        "workers_cuda_initialized": rep["workers_cuda_initialized"],
    }
    emit(line)
    return line


# Phase 24: cross-card meshes, one rank a card.  One docs x segs mesh of
# ``ranks`` ranks (seg_shards = ranks) serves the config-3 fleet at full
# width, a config-1 hot doc promoted to a lane over every rank, and one doc
# migrated across ranks; the long document runs over the same ranks.
CROSS_CARD = dict(ranks=4, n_docs=10_000, rounds=4, hot_rounds=8, hot_per_step=8, spare=64,
                  sample=32, migrate_doc=7, long_S=262_144, long_Q=256, k2_iters=10,
                  coll_iters=50)
CROSS_CARD_TIMEOUT_S = 300
_CROSS_CHILD = "import chip_smoke\nchip_smoke._cross_card_rank_main()\n"


def _cross_geom(ranks: int) -> dict:
    """The rank mesh's engine: config 3's fleet geometry (16 obliterate slots,
    as the hot doc's four-writer soup needs), lanes at config 1's S and T."""
    return dict(FLEET_GEOM, ob_slots=16, recovery="grow",
                seg_lane_segments=HOT_GEOM["max_segments"] // ranks,
                seg_lane_text_capacity=HOT_GEOM["text_capacity"])


def _cross_programs() -> dict:
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions

    return {"apply_megastep": mk.apply_megastep, "compact": mk.compact,
            "apply_megastep_seg": mk.apply_megastep_seg, "compact_seg": mk.compact_seg,
            "resolve_positions": resolve_positions}


def _row_hashes(state) -> list:
    """A blake2b digest of every row of a fleet state (all its leaves'
    bytes): the rows compare byte for byte across processes by digest."""
    import hashlib

    import torch

    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    leaves = mk.leaves(state)
    n = int(leaves[0].shape[0])
    flat = torch.cat([x.reshape(n, -1) for x in leaves], 1).cpu().numpy()
    return [hashlib.blake2b(flat[i].tobytes(), digest_size=16).hexdigest() for i in range(n)]


def _cross_drive(eng, traffic, hot_msgs, sizes, hot: int, sync, on_round=None) -> dict:
    """The main path on one engine (a rank's or the parent's): joins, the hot
    doc promoted to its lane, then each fleet round (one ``ingest_batch``)
    with the next ``hot_per_step`` hot rounds (64 lane rows at 8: a K=4
    lane megastep), ``step`` and ``compact``; the migrated doc moves after
    round 2 is staged."""
    joins, rounds = _rounds_for(traffic, sizes["n_docs"], sizes["rounds"])
    hjoins, hrounds = hot_msgs
    eng.ingest_batch([d for d, _ in joins], [m for _, m in joins])
    for m in hjoins:
        eng.ingest(hot, m)
    eng.step()
    check(eng.enable_segment_sharding(hot), "cross_card: enable_segment_sharding refused")
    per = sizes["hot_per_step"]
    out = {"step_s": [], "migrated": None}
    for r, msgs in enumerate(rounds):
        eng.ingest_batch([d for d, _ in msgs], [m for _, m in msgs])
        for rr in hrounds[r * per:(r + 1) * per]:
            for m in rr:
                eng.ingest(hot, m)
        if r == 2:
            d = sizes["migrate_doc"]
            src = eng.shard_of(d)
            check(eng.migrate_doc(d, (src + 3) % eng.n_shards), "cross_card: migrate_doc refused")
            out["migrated"] = {"doc": d, "from": src, "to": eng.shard_of(d),
                               "slot": int(eng._slot[d])}
        t = time.perf_counter()
        eng.step()
        eng.compact()
        sync()
        out["step_s"].append(time.perf_counter() - t)
        if on_round is not None:
            on_round(r)
    return out


def _cross_card_rank_main() -> None:
    """One rank of phase 24 (a process of its own, started by
    ``phase_cross_card``): joins the group (NCCL on its own card, or gloo
    with every rank's rows on card 0), drives the main path on the rank
    mesh with the launch counts set to 0 just before it and read just
    after, then times K2 on its rows (ranks in turn), the lane's
    collectives and K6 over the ranks.  Writes its results to
    ``rank<RANK>.pkl``; a failure prints its traceback and exits 1."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    work, backend = os.environ["CROSS_DIR"], os.environ["CROSS_BACKEND"]
    device, seed = os.environ["CROSS_DEVICE"], int(os.environ["CROSS_SEED"])
    sizes = json.loads(os.environ["CROSS_SIZES"])
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        out = _cross_card_rank(rank, world, device, seed, sizes, work)
        with open(os.path.join(work, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(work, f"rank{rank}.pkl.tmp"),
                   os.path.join(work, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def _cross_card_rank(rank: int, world: int, device: str, seed: int, sizes: dict,
                     work: str) -> dict:
    import torch
    import torch.distributed as dist

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.parallel import long_doc as ld
    from fluidframework_tpu_torch.parallel.mesh import rank_mesh
    from fluidframework_tpu_torch.protocol.stamps import ALL_ACKED

    on_card = device.startswith("cuda")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    progs = _cross_programs()
    t0 = time.perf_counter()
    traffic = fleet_traffic(sizes["n_docs"], sizes["rounds"], FLEET_GEOM["ops_per_step"], 8, seed)
    hot_msgs = hot_doc_messages(seed + 3, sizes["hot_rounds"])
    long_state, queries = _long_doc_input(seed, sizes["long_S"], sizes["long_Q"])
    mesh = rank_mesh(seg_shards=world, device=device)
    eng = DocBatchEngine(sizes["n_docs"] + 1, mesh=mesh, spare_slots=sizes["spare"],
                         **_cross_geom(world))
    hot = sizes["n_docs"]
    setup_s = time.perf_counter() - t0
    group = eng._seg_megastep.group
    captured = {}
    lane = {"s": 0.0, "dispatches": 0, "calls": 0}
    megastep, seg_megastep = eng._megastep, eng._seg_megastep

    def capture(state, ops, pays, kinds=None):
        if ops.shape[0] > captured.get("k", 0):
            captured.update(k=ops.shape[0], ops=ops.clone(), pays=pays.clone(), kinds=kinds.copy())
        return megastep(state, ops, pays, kinds=kinds)

    def timed_lane(state, ops, pays, kinds=None):
        calls, t = group.calls, time.perf_counter()
        out = seg_megastep(state, ops, pays, kinds=kinds)
        sync()
        lane["s"] += time.perf_counter() - t
        lane["dispatches"] += 1
        lane["calls"] += group.calls - calls
        if ops.shape[0] == 4 and "lane" not in captured:
            captured["lane"] = (ops.clone(), pays.clone(), kinds.copy())
        return out

    eng._megastep, eng._seg_megastep = capture, timed_lane
    timed_lane.group = group
    for fn in progs.values():
        fn.launches = 0
    t0 = time.perf_counter()
    run = _cross_drive(eng, traffic, hot_msgs, sizes, hot, sync)
    lstate = ld.shard_doc_state(long_state, mesh)
    _vis, resolve, _mark = ld.make_sharded_ops(mesh, lstate)
    gi, off = resolve(lstate, queries, ALL_ACKED, -2)
    sync()
    main_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in progs.items()}
    eng._megastep, eng._seg_megastep = megastep, seg_megastep
    lo, hi = eng._rows
    rng = np.random.default_rng(seed + 24)
    sample = sorted(int(d) for d in rng.choice(sizes["n_docs"], sizes["sample"], replace=False))
    out = {
        "rank": rank, "device": device, "rows": [lo, hi], "setup_s": setup_s, "main_s": main_s,
        "run": run, "launches": launches,
        "hashes": _row_hashes(eng.state), "latches": eng.state.error.cpu().numpy(),
        "lane": mk.to_numpy(eng.seg_lanes[hot].state),
        "texts": {d: eng.text(d) for d in sample},
        "error_count": eng.error_count(), "quarantine": sorted(eng.quarantine),
        "overflow": sorted(eng.overflow), "long": (gi.cpu().numpy(), off.cpu().numpy()),
        "ob_gate_opens": eng.ob_gate_opens, "ob_gate_syncs": eng.counters.get("ob_gate_syncs"),
        "lane_s": lane["s"], "lane_dispatches": lane["dispatches"],
        "lane_rows": sum(len(r) for r in hot_msgs[1]),
        "collectives_per_dispatch": lane["calls"] / max(lane["dispatches"], 1),
    }
    # Timings, outside the main path.  The parent's engine must be off the
    # card first (it writes "parent_done").  K2 runs on one rank at a time:
    # its call time in turns, then its device time in turns inside one
    # profiler session a rank, the sessions opened together (a session's
    # start costs seconds).
    while not os.path.exists(os.path.join(work, "parent_done")):
        time.sleep(0.05)
    ring = captured
    if ring.get("k"):
        fn = lambda: mk.apply_megastep(eng.state, ring["ops"], ring["pays"],  # noqa: E731
                                       kinds=ring["kinds"])
        out["k2"] = {"shape": list(ring["ops"].shape[:3]), "ms": None, "device_ms": None}
        for r in range(world):
            dist.barrier()
            if r == rank and on_card:
                out["k2"]["ms"] = cuda_ms(fn, sizes["k2_iters"], warmup=3)
        dist.barrier()
        if on_card:
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for r in range(world):
                    dist.barrier()
                    if r == rank:
                        for _ in range(2):
                            fn()
                        torch.cuda.synchronize()
                dist.barrier()
            dev = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "nccl" not in e.key.lower()]
            out["k2"]["device_ms"] = sum(
                (getattr(e, "device_time_total", None) or e.cuda_time_total) for e in dev) / 2e3
    dist.barrier()
    x = torch.ones(1, dtype=torch.int32, device=device)
    for name, coll in (("psum", group.psum), ("all_gather", group.all_gather)):
        dist.barrier()
        sync()
        t = time.perf_counter()
        for _ in range(sizes["coll_iters"]):
            coll(x)
        sync()
        out[f"{name}_ms"] = (time.perf_counter() - t) * 1e3 / sizes["coll_iters"]
    if "lane" in captured:
        ops, pays, kinds = captured["lane"]
        st = eng.seg_lanes[hot].state
        dist.barrier()
        sync()
        t = time.perf_counter()
        mk.apply_megastep_seg(st, ops, pays, group=group, kinds=kinds)
        sync()
        out["k6"] = {"shape": list(ops.shape[:2]), "ms": (time.perf_counter() - t) * 1e3}
    out["backend"] = str(dist.get_backend())
    return out


def _long_doc_input(seed: int, S: int, Q: int) -> tuple:
    """Phase 5's long document (seeded lengths, 15% removed) as a host
    state, and its queries."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.protocol.stamps import NO_REMOVE

    rng = np.random.default_rng(seed)
    seg_len = rng.integers(1, 9, size=S).astype(np.int32)
    removed = rng.random(S) < 0.15
    host = mk.to_numpy(mk.init_state(S, 2, 2, int(seg_len.sum()), 8, device="cpu"))
    rem0 = np.where(removed, S + 1 + np.arange(S), NO_REMOVE).astype(np.int32)
    host = host._replace(
        nseg=np.asarray(S, np.int32), seg_start=(np.cumsum(seg_len) - seg_len).astype(np.int32),
        seg_len=seg_len, ins_key=np.arange(1, S + 1, dtype=np.int32),
        ins_client=np.zeros(S, np.int32), rem_keys=(rem0,) + host.rem_keys[1:],
    )
    total = int(np.where(removed, 0, seg_len).sum())
    return mk.from_numpy(host, device="cpu"), rng.integers(0, total, size=Q).astype(np.int32)


def phase_cross_card(seed: int, card: str, device: str = "cuda", traffic=None, paths=None,
                     sizes: dict | None = None) -> dict:
    """Phase 24: the rank mesh, one process a rank.  With two or more
    visible cards NCCL, one rank a card (up to ``ranks``); on one card
    gloo, every rank's rows on card 0 (the card count picks the backend).
    The parent builds nothing (the kernels are built), starts the ranks,
    and meanwhile serves the same stream on a one-card engine (the stacked
    docs x segs mesh of phase 15); it fails unless every rank's rows and
    latches are byte-identical to the one-card engine's at the same slots
    (blake2b digests), the hot doc's lane equals the stacked lane, sampled
    docs' texts equal a CPU replay, the error counts agree, the migrated
    doc's row is byte-identical, the long-document answers equal K1's
    plain version, and on every rank K2, K3, K6, its compaction and K1
    launched.  A rank's failure or the timeout fails the phase."""
    import pickle
    import shutil

    import torch

    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops.resolve_kernel import resolve_positions_plain
    from fluidframework_tpu_torch.parallel.mesh import docs_segs_mesh

    sizes = dict(CROSS_CARD, **(sizes or {}))
    on_card = device == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    if cards >= 2:
        backend, ranks = "nccl", min(sizes["ranks"], cards)
        rank_devices = [f"cuda:{r}" for r in range(ranks)]
    else:
        backend, ranks = "gloo", sizes["ranks"]
        rank_devices = ["cuda:0" if on_card else "cpu"] * ranks
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="cross_card_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        "WORLD_SIZE": str(ranks), "CROSS_DIR": work, "CROSS_BACKEND": backend,
        "CROSS_SEED": str(seed), "CROSS_SIZES": json.dumps(sizes), "OMP_NUM_THREADS": "2"}
    errs = [open(os.path.join(work, f"rank{r}.err"), "w+") for r in range(ranks)]
    procs = [subprocess.Popen([sys.executable, "-c", _CROSS_CHILD], cwd=root,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
                                   "CROSS_DEVICE": rank_devices[r]},
                              stdout=subprocess.DEVNULL, stderr=errs[r])
             for r in range(ranks)]
    try:
        # The one-card engine on the same stream, while the ranks start.
        if traffic is None:
            traffic = fleet_traffic(sizes["n_docs"], sizes["rounds"], FLEET_GEOM["ops_per_step"],
                                    8, seed)
        hot_msgs = hot_doc_messages(seed + 3, sizes["hot_rounds"])
        hot = sizes["n_docs"]

        def sync():
            if on_card:
                torch.cuda.synchronize()

        t1 = time.perf_counter()
        one = DocBatchEngine(hot + 1, mesh=docs_segs_mesh([device] * ranks, seg_shards=ranks),
                             spare_slots=sizes["spare"], **_cross_geom(ranks))
        one_run = _cross_drive(one, traffic, hot_msgs, sizes, hot, sync)
        want = {"hashes": _row_hashes(one.state), "latches": one.state.error.cpu().numpy(),
                "lane": mk.to_numpy(one.seg_lanes[hot].state), "error_count": one.error_count(),
                "quarantine": sorted(one.quarantine), "overflow": sorted(one.overflow)}
        one_s = time.perf_counter() - t1
        rng = np.random.default_rng(seed + 24)
        sample = sorted(int(d) for d in rng.choice(sizes["n_docs"], sizes["sample"],
                                                   replace=False))
        one_texts = {d: one.text(d) for d in sample}
        check(one.error_count() == 0 and not one.quarantine, "cross_card: the one-card engine latched")
        del one
        if on_card:
            torch.cuda.empty_cache()
        long_state, queries = _long_doc_input(seed, sizes["long_S"], sizes["long_Q"])
        lens = torch.where(long_state.rem_keys[0] == mk.NO_REMOVE, long_state.seg_len, 0)
        plain = resolve_positions_plain(lens[None].to(device), torch.as_tensor(
            queries, device=device)[None])
        want_long = (plain[0][0].cpu().numpy(), plain[1][0].cpu().numpy())
        sync()
        open(os.path.join(work, "parent_done"), "w").close()
        # The CPU replay of the sampled docs.
        t1 = time.perf_counter()
        local = {d: j for j, d in enumerate(sample)}
        joins, rounds = _rounds_for(traffic, sizes["n_docs"], sizes["rounds"])
        cpu = DocBatchEngine(len(sample), device="cpu", **_cross_geom(ranks))
        for msgs in [joins] + rounds:
            mine = [(local[d], m) for d, m in msgs if d in local]
            cpu.ingest_batch([d for d, _ in mine], [m for _, m in mine])
            cpu.step()
            cpu.compact()
        replay = {d: cpu.text(local[d]) for d in sample}
        replay_s = time.perf_counter() - t1
        deadline = time.monotonic() + CROSS_CARD_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            check(time.monotonic() < deadline,
                  f"cross_card: the ranks ran past {CROSS_CARD_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            errs[r].seek(0)
            tails.append(f"rank {r} (rc {procs[r].returncode}):\n{errs[r].read()[-3000:]}")
        raise AssertionError("cross_card: a rank failed:\n" + "\n".join(tails))
    outs = []
    for r in range(ranks):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    shutil.rmtree(work, ignore_errors=True)
    dps = len(want["hashes"]) // ranks
    for o in outs:
        r, (lo, hi) = o["rank"], o["rows"]
        check((lo, hi) == (r * dps, (r + 1) * dps), f"cross_card: rank {r} holds {lo}:{hi}")
        bad = sum(a != b for a, b in zip(o["hashes"], want["hashes"][lo:hi]))
        check(bad == 0, f"cross_card: {bad} rows of rank {r} differ from the one-card engine")
        check(np.array_equal(o["latches"], want["latches"][lo:hi]),
              f"cross_card: rank {r}'s latches differ")
        check(o["texts"] == replay == one_texts,
              f"cross_card: rank {r}'s sampled texts differ from the CPU replay")
        for key in ("error_count", "quarantine", "overflow"):
            check(o[key] == want[key], f"cross_card: rank {r}'s {key} {o[key]} != {want[key]}")
        check(o["run"]["migrated"] == one_run["migrated"],
              f"cross_card: migration {o['run']['migrated']} != {one_run['migrated']}")
        check(np.array_equal(o["long"][0], want_long[0]) and np.array_equal(o["long"][1],
                                                                              want_long[1]),
              f"cross_card: rank {r}'s long-document answers differ from K1's plain version")
        if on_card:
            for prog, n in o["launches"].items():
                check(n > 0, f"cross_card: {prog} never launched on rank {r}")
    lane = mk.tree_map(lambda *xs: np.concatenate(xs), *[o["lane"] for o in outs])
    check(mk.seg_replica_mismatch(lane) == [], "cross_card: the ranks' lane replicas disagree")
    diff = [i for i, (a, b) in enumerate(zip(mk.leaves(lane), mk.leaves(want["lane"])))
            if not np.array_equal(a, b)]
    check(diff == [], f"cross_card: the hot doc's lane differs from the stacked lane (leaves {diff})")
    mig = one_run["migrated"]
    check(mig["from"] != mig["to"], f"cross_card: the doc did not change ranks ({mig})")
    if paths is not None:
        for prog in _cross_programs():
            paths[prog]["cross_card_ranks"] = sum(o["launches"][prog] for o in outs)
    line = {
        "phase": "cross_card", "card": card, "backend": backend, "cards": cards, "ranks": ranks,
        "rank_devices": rank_devices, "docs": sizes["n_docs"], "rounds": sizes["rounds"],
        "hot_rounds": sizes["hot_rounds"], "capacity": len(want["hashes"]), "docs_per_rank": dps,
        "identical_rows": len(want["hashes"]), "sampled_texts": len(sample),
        "migrated": mig, "one_card_s": one_s, "cpu_replay_s": replay_s,
        "ranks_detail": [{
            "rank": o["rank"], "device": o["device"], "launches": o["launches"],
            "setup_s": o["setup_s"], "main_s": o["main_s"], "step_s": o["run"]["step_s"],
            "k2": o.get("k2"), "lane_s": o["lane_s"], "lane_dispatches": o["lane_dispatches"],
            "lane_rows": o["lane_rows"],
            "lane_rows_per_s": o["lane_rows"] / o["lane_s"] if o["lane_s"] else None,
            "collectives_per_dispatch": o["collectives_per_dispatch"],
            "collectives_per_op": o["collectives_per_dispatch"] * o["lane_dispatches"]
            / max(o["lane_rows"], 1),
            "psum_ms": o["psum_ms"], "all_gather_ms": o["all_gather_ms"], "k6": o.get("k6"),
            "ob_gate_opens": o["ob_gate_opens"], "ob_gate_syncs": o["ob_gate_syncs"],
        } for o in outs],
        "phase_s": time.perf_counter() - t0,
    }
    emit(line)
    return line


# Phase 24's entry point over ranks: the fleet traffic's first docs and
# rounds through ``fleet_main --mesh N`` under ``torch.distributed.run``,
# then the tree fleet's first docs and rounds through ``--family tree``.
CROSS_ENTRY = dict(n_docs=256, rounds=4)
CROSS_ENTRY_TREE = dict(fleet_docs=256, n_docs=64, rounds=4)  # fleet_docs: tree_fleet's cut
CROSS_ENTRY_TIMEOUT_S = 300


def _ranked_fleet_main(ranks: int, device: str, doc_ids: list, waves: list, rows: int,
                       args: list, tag: str) -> tuple[list, float]:
    """``fleet_main --mesh ranks`` under ``torch.distributed.run`` fed
    ``waves`` (all released at once) by a firehose until ``rows`` op rows
    are staged; returns its JSON lines and seconds.  Fails unless the
    world exits 0 within ``CROSS_ENTRY_TIMEOUT_S``."""
    feeder = FirehoseFeeder(waves)
    root = tempfile.mkdtemp(prefix="chip_smoke_cross_entry_")
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    try:
        for w in range(len(waves)):
            feeder.release(w)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", str(ranks), "-m", "fluidframework_tpu_torch.server.fleet_main",
               "--mesh", str(ranks), "--port", str(feeder.port), "--docs", ",".join(doc_ids),
               "--device", device, "--checkpoint-dir", os.path.join(root, "ckpt"),
               "--status-every", "600", "--exit-after-rows", str(rows), *args]
        env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
            p for p in (repo, os.environ.get("PYTHONPATH")) if p))
        # The launcher and its ranks in a session of their own, so the cap
        # ends every rank with it.
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env, cwd=repo, start_new_session=True)
        try:
            stdout, stderr = proc.communicate(timeout=CROSS_ENTRY_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            os.killpg(proc.pid, 9)
            proc.communicate()
            raise AssertionError(f"{tag}: the world ran past {CROSS_ENTRY_TIMEOUT_S} s") from e
        run_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"{tag}: the world exited {proc.returncode}: {stderr[-3000:]}")
    finally:
        feeder.close()
        shutil.rmtree(root, ignore_errors=True)
    return [json.loads(x) for x in stdout.splitlines() if x.startswith("{")], run_s


def _one_done_line(lines: list, rows: int, ranks: int, tag: str) -> dict:
    """The world's one ``done`` line (rank 0 alone prints: one ``ready``,
    one ``done``), checked for every row consumed over ``ranks`` shards
    and no error."""
    ready = [x for x in lines if x.get("ready")]
    done = [x for x in lines if x.get("done")]
    check(len(ready) == 1 and len(done) == 1,
          f"{tag}: {len(ready)} ready and {len(done)} done lines (rank 0 alone prints)")
    done = done[0]
    check(done["errors"] == 0 and done["rows"] == rows,
          f"{tag}: {done['errors']} errors, {done['rows']} of {rows} rows")
    check(done["health"]["n_shards"] == ranks,
          f"{tag}: {done['health']['n_shards']} shards for {ranks} ranks")
    return done


def _tree_fleet_stream(seed: int, n_docs: int, rounds: int, n_faulted: int = 4,
                       fault_edits: int = 24) -> tuple:
    """tree_fleet's stream: ``tree_traffic`` of ``n_docs`` docs with
    ``n_faulted`` seeded docs overflowing the capacity; (faulted, rounds)."""
    rng = np.random.default_rng(seed + 11)
    faulted = sorted(int(d) for d in rng.choice(n_docs, size=n_faulted, replace=False))
    return faulted, tree_traffic(seed, n_docs, rounds, faulted=faulted, fault_edits=fault_edits)


def _cross_entry_tree(device: str, ranks: int, seed: int, sizes: dict) -> dict:
    """The tree leg: ``fleet_main --family tree --mesh N`` fed the first
    ``n_docs`` docs and ``rounds`` rounds of tree_fleet's stream (at
    ``fleet_docs`` docs) that are not its faulted docs, against a
    ``TreeBatchEngine`` on the CPU fed the same bytes.  (A faulted doc
    routes to the host fallback at a step, after which its rows stop
    counting: the rows staged would follow the steps' timing, and
    ``--exit-after-rows`` needs them fixed.)"""
    from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine

    n_docs = sizes["n_docs"]
    faulted, traffic = _tree_fleet_stream(seed, sizes["fleet_docs"], sizes["rounds"])
    kept = [d for d in range(sizes["fleet_docs"]) if d not in faulted][:n_docs]
    local = {d: j for j, d in enumerate(kept)}
    doc_ids = [f"t{d}" for d in kept]
    blobs = _doc_blobs(n_docs, [(local[d], m) for rnd in traffic for d, m in rnd if d in local])
    waves = [{doc_ids[d]: blob for d, blob in enumerate(blobs) if blob}]
    eng = TreeBatchEngine(n_docs, device="cpu", **TREE_FLEET_GEOM)
    rows = sum(eng.ingest_lines(d, blob) for d, blob in enumerate(blobs) if blob)
    eng.step()
    want = {doc: eng.tree_json(d) for d, doc in enumerate(doc_ids)}
    geom = TREE_FLEET_GEOM
    lines, run_s = _ranked_fleet_main(
        ranks, device, doc_ids, waves, rows,
        ["--family", "tree", "--capacity", str(geom["capacity"]),
         "--pool-capacity", str(geom["pool_capacity"]),
         "--max-insert-len", str(eng.max_insert_len), "--ops-per-step", str(geom["ops_per_step"]),
         "--megastep-k", str(geom["megastep_k"])], "cross_entry tree")
    done = _one_done_line(lines, rows, ranks, "cross_entry tree")
    check(done["trees"] == want, "cross_entry tree: the trees differ from the CPU engine's")
    if device == "cuda":
        check(done["device"].startswith("cuda"),
              f"cross_entry tree: rank 0 served on {done['device']}")
        check(done["launches"].get("apply_nested_megastep", 0) > 0,
              "cross_entry tree: K7 never launched")
    check(not eng.fallbacks, f"cross_entry tree: docs {sorted(eng.fallbacks)} fell back")
    return {"docs": n_docs, "rounds": sizes["rounds"], "rows": rows, "run_s": run_s,
            "launches": done["launches"], "lines": len(lines)}


def phase_cross_entry(card: str, device: str, ranks: int, seed: int = 0, traffic=None,
                      sizes: dict | None = None, geom: dict = FLEET_GEOM,
                      tree_sizes: dict | None = None) -> dict:
    """``fleet_main --mesh N`` under ``torch.distributed.run``, ``ranks``
    ranks (NCCL, one rank a card, for ``device="cuda"``; gloo for
    ``"cpu"``), fed the fleet traffic's first docs and rounds by a
    firehose, against an engine on the CPU fed the same bytes; then its
    tree leg (``--family tree``, ``_cross_entry_tree``).  Fails unless
    each world exits 0 within its cap, rank 0 alone printed (one ``ready``
    line, one ``done`` line), the done line's texts (trees) equal the
    engine's with no error and every row consumed over ``ranks`` shards,
    and on the cards K2 (K7) launched on rank 0's process (``fleet_main``
    compacts only when it drains, so K3 may not run)."""
    from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine

    sizes = dict(CROSS_ENTRY, **(sizes or {}))
    n_docs, rounds = sizes["n_docs"], sizes["rounds"]
    geom = dict(geom, recovery="grow")
    if traffic is None:
        traffic = fleet_traffic(n_docs, rounds, geom["ops_per_step"], 8, seed)
    joins, rounds_msgs = _rounds_for(traffic, n_docs, rounds)
    doc_ids = [f"x{d}" for d in range(n_docs)]
    waves = _doc_waves(doc_ids, [joins + rounds_msgs[0]] + rounds_msgs[1:],
                       [list(range(rounds))])
    rows = sum(len(r) for r in rounds_msgs)
    lines, run_s = _ranked_fleet_main(
        ranks, device, doc_ids, waves, rows,
        ["--capacity", str(geom["max_segments"]), "--text-capacity", str(geom["text_capacity"]),
         "--max-insert-len", str(geom["max_insert_len"]),
         "--ops-per-step", str(geom["ops_per_step"]), "--megastep-k", str(geom["megastep_k"])],
        "cross_entry")
    eng = DocBatchEngine(n_docs, device="cpu", **geom)
    for d, doc in enumerate(doc_ids):
        if waves[0].get(doc):
            eng.ingest_lines(d, waves[0][doc])
    eng.step()
    done = _one_done_line(lines, rows, ranks, "cross_entry")
    check(done["texts"] == {doc: eng.text(d) for d, doc in enumerate(doc_ids)},
          "cross_entry: the texts differ from the CPU engine's")
    if device == "cuda":
        check(done["device"].startswith("cuda"), f"cross_entry: rank 0 served on {done['device']}")
        check(done["launches"].get("apply_megastep", 0) > 0, "cross_entry: K2 never launched")
    tree = _cross_entry_tree(device, ranks, seed, dict(CROSS_ENTRY_TREE, **(tree_sizes or {})))
    line = {"phase": "cross_entry", "card": card, "device": done["device"], "ranks": ranks,
            "docs": n_docs, "rounds": rounds, "rows": rows, "run_s": run_s,
            "launches": done["launches"], "lines": len(lines), "tree": tree}
    emit(line)
    return line


# Phase 25: the chaos stack's tree tier over a rank mesh.  The reference's
# mixed-fleet smoke (tests/test_chaos.py:502-539: seed 16, 30 ticks, 2
# string docs, standbys, bounded-staleness checkpoints, its schedule) with 8
# tree docs, two a rank of 4, on the native deli; rank 0 runs the whole
# stack and decides every fault, the others serve their shard of the tree
# engine.
CHAOS_RANKS = dict(ranks=4, seed=16, ticks=30, n_docs=2, n_tree_docs=8, standby=True,
                   ckpt_stale_seconds=0.25, native_sequencer=True,
                   events=[(5, "nack_storm", "cd0", 4), (8, "migrate", "td1", 0),
                           (12, "fleet_kill", "", 0), (18, "torn_socket", "td0", 0),
                           (22, "migrate", "td0", 0)])
CHAOS_RANKS_TIMEOUT_S = 240
_CHAOS_RANKS_CHILD = "import chip_smoke\nchip_smoke._chaos_rank_main()\n"


def _chaos_rank_main() -> None:
    """One rank of phase 25 (a process of its own, started by
    ``phase_chaos_ranks``): joins the group (NCCL on its own card, or gloo
    with every rank on card 0), sets K7's and K8's launch counts to 0, runs
    ``run_chaos`` with the tree tier on the rank mesh (every rank with the
    same arguments) and reads the counts.  Writes ``rank<RANK>.pkl`` (rank
    0: the report; the others: their tier's stats); a failure prints its
    traceback and exits 1."""
    import pickle
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from fluidframework_tpu_torch.ops import tree_kernel as tk
    from fluidframework_tpu_torch.parallel.mesh import rank_mesh
    from fluidframework_tpu_torch.testing.chaos import ChaosEvent, ChaosSchedule, run_chaos

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    work, device = os.environ["CHAOS_DIR"], os.environ["CHAOS_DEVICE"]
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    cfg = json.loads(os.environ["CHAOS_CFG"])
    dist.init_process_group(os.environ["CHAOS_BACKEND"],
                            store=dist.FileStore(os.path.join(work, "store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    try:
        schedule = ChaosSchedule(seed=cfg["seed"], events=[ChaosEvent(*e) for e in cfg["events"]])
        kw = {k: v for k, v in cfg.items() if k not in ("ranks", "events")}
        progs = (tk.apply_nested_megastep, tk.compact_nested)
        for fn in progs:
            fn.launches = 0
        t = time.perf_counter()
        out = run_chaos(schedule=schedule, device=device.split(":")[0],
                        tree_mesh=rank_mesh(device=device), **kw)
        out = {"out": out, "run_s": time.perf_counter() - t,
               "launches": {fn.__name__: fn.launches for fn in progs}}
        with open(os.path.join(work, f"rank{rank}.pkl.tmp"), "wb") as f:
            pickle.dump(out, f)
        os.replace(os.path.join(work, f"rank{rank}.pkl.tmp"), os.path.join(work, f"rank{rank}.pkl"))
    finally:
        dist.destroy_process_group()


def phase_chaos_ranks(card: str, device: str = "cuda", paths: dict | None = None,
                      sizes: dict | None = None) -> dict:
    """Phase 25: ``run_chaos`` with the tree tier on a rank mesh, one
    process a rank.  With two or more visible cards NCCL, one rank a card
    (up to ``ranks``); on one card gloo, every rank on card 0 (the card
    count picks the backend).  Fails unless every rank exits 0 within the
    cap, the report's invariants hold (the fleet's texts and trees equal
    the fault-free oracles' replay of the sequenced log, no double acks,
    bounded queues), the kill restarted the fleet once with a standby
    promotion per family, a migration moved a tree doc from one rank's
    block to another's, the tree engine has one shard a rank, every
    follower made rank 0's collectives, and on the card every rank
    launched K7 and K8 (the standbys' warmups compact); the ranks' launches
    join the ``kernels`` line as ``chaos_ranks``."""
    import pickle

    import torch

    cfg = dict(CHAOS_RANKS, **(sizes or {}))
    on_card = device == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    if cards >= 2:
        backend, ranks = "nccl", min(cfg["ranks"], cards)
        rank_devices = [f"cuda:{r}" for r in range(ranks)]
    else:
        backend, ranks = "gloo", cfg["ranks"]
        rank_devices = ["cuda:0" if on_card else "cpu"] * ranks
    cfg["ranks"] = ranks
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chaos_ranks_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p),
        "WORLD_SIZE": str(ranks), "CHAOS_DIR": work, "CHAOS_BACKEND": backend,
        "CHAOS_CFG": json.dumps(cfg), "OMP_NUM_THREADS": "2"}
    errs = [open(os.path.join(work, f"rank{r}.err"), "w+") for r in range(ranks)]
    procs = [subprocess.Popen([sys.executable, "-c", _CHAOS_RANKS_CHILD], cwd=root,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
                                   "CHAOS_DEVICE": rank_devices[r]},
                              stdout=subprocess.DEVNULL, stderr=errs[r])
             for r in range(ranks)]
    try:
        deadline = time.monotonic() + CHAOS_RANKS_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            check(time.monotonic() < deadline,
                  f"chaos_ranks: the ranks ran past {CHAOS_RANKS_TIMEOUT_S} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            errs[r].seek(0)
            tails.append(f"rank {r} (rc {procs[r].returncode}):\n{errs[r].read()[-3000:]}")
        raise AssertionError("chaos_ranks: a rank failed:\n" + "\n".join(tails))
    outs = []
    for r in range(ranks):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    shutil.rmtree(work, ignore_errors=True)
    rep = outs[0]["out"]
    inv, c, rec, tree = rep["invariants"], rep["counters"], rep["recovery"], rep["tree"]
    check(inv["converged_docs"] == cfg["n_docs"]
          and inv["tree_converged_docs"] == cfg["n_tree_docs"], f"chaos_ranks: {inv}")
    check(inv["double_acks"] == 0, "chaos_ranks: double acks")
    check(inv["max_queue_depth"] <= inv["queue_depth_bound"]
          and inv["max_tree_queue_depth"] <= inv["tree_queue_depth_bound"], f"chaos_ranks: {inv}")
    check(c["fleet_restarts"] == 1 and c["standby_promotions"] == 2,
          f"chaos_ranks: {c['fleet_restarts']} restarts, {c['standby_promotions']} promotions")
    check(rec["open"] == 0 and rec["tree_open"] == 0 and rec["tree_incidents"] >= 1,
          f"chaos_ranks: recovery {rec}")
    check(tree["n_shards"] == ranks, f"chaos_ranks: {tree['n_shards']} shards for {ranks} ranks")
    check(any(src != dst for _d, src, dst in tree["moves"]),
          f"chaos_ranks: no migration changed ranks ({tree['moves']})")
    stats = [tree["rank"]] + [o["out"] for o in outs[1:]]
    for r, st in enumerate(stats):
        check(st["rank"] == r and st["steps"] == stats[0]["steps"],
              f"chaos_ranks: rank {r} stepped {st['steps']} times, rank 0 {stats[0]['steps']}")
        check(st["collectives"] == stats[0]["collectives"] + (r > 0),
              f"chaos_ranks: rank {r} made {st['collectives']} collectives")
        if on_card:
            check(st["device"] == rank_devices[r], f"chaos_ranks: rank {r} on {st['device']}")
            for prog, what in (("apply_nested_megastep", "K7"), ("compact_nested", "K8")):
                check(outs[r]["launches"][prog] > 0, f"{what} was never launched on chaos rank {r}")
    if paths is not None:
        for prog in ("apply_nested_megastep", "compact_nested"):
            paths[prog]["chaos_ranks"] = sum(o["launches"][prog] for o in outs)
    line = {
        "phase": "chaos_ranks", "card": card, "backend": backend, "cards": cards, "ranks": ranks,
        "rank_devices": rank_devices, "config": {k: v for k, v in cfg.items() if k != "events"},
        "events": cfg["events"], "duration_s": rep["duration_s"],
        "counters": c, "moves": tree["moves"],
        "tree_recovery_p50_ms": rec["tree_recovery_p50_ms"],
        "tree_recovery_p99_ms": rec["tree_recovery_p99_ms"],
        "recovery_p50_ms": rec["recovery_p50_ms"], "recovery_p99_ms": rec["recovery_p99_ms"],
        "invariants": inv, "devices": rep["devices"], "sequencer": rep["sequencer"],
        "collectives_per_tick": stats[0]["collectives"] / cfg["ticks"],
        "ranks_detail": [{
            "rank": r, "device": st["device"], "launches": outs[r]["launches"],
            "run_s": outs[r]["run_s"], "steps": st["steps"], "step_s": st["step_s"],
            "step_ms_mean": 1e3 * st["step_s"] / max(st["steps"], 1),
            "collectives": st["collectives"],
        } for r, st in enumerate(stats)],
        "phase_s": time.perf_counter() - t0,
    }
    emit(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=None,
                    help="write the recorded turns' Chrome traces here (none by default)")
    ap.add_argument("--only", choices=("cross_card", "chaos_ranks"), default=None,
                    help="build the kernels and run this phase alone (cross_card: phase 24 "
                         "over every visible card, NCCL with two or more, and then "
                         "fleet_main's string and tree families over as many ranks, K1 and "
                         "K9 on a card that is not the current one, and phase 25; "
                         "chaos_ranks: phase 25)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    try:
        from fluidframework_tpu_torch.ops import cuda_build
        from fluidframework_tpu_torch.ops import resolve_kernel as rk
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from the repository root",
              file=sys.stderr)
        return 3
    card = card_label()
    t0 = time.perf_counter()
    cuda_build.build(verbose=True)
    emit({"phase": "build", "card": card, "build_s": time.perf_counter() - t0,
          "library": str(cuda_build.library_path().name),
          "sources": [src.name for src in cuda_build.sources()]})
    if args.only is not None:
        launches = {name: {} for name in (*_cross_programs(), "apply_nested_megastep",
                                          "compact_nested")}
        if args.only == "cross_card":
            line = phase_cross_card(args.seed, card, "cuda", paths=launches)
            if line["backend"] == "nccl":
                emit({"phase": "other_card", **other_card_kernels(args.seed)})
                phase_cross_entry(card, "cuda", line["ranks"], args.seed)
        phase_chaos_ranks(card, "cuda", launches)
        emit({"phase": "only_launches", "only": args.only, **launches})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    # The main path, phase by phase: the launch counts of K1, of the fleet
    # programs (K2, K3, K6), of the tree programs (K7, K8), of K9 and of the
    # map and matrix programs are set to 0 just before each path and read
    # just after it.  A path that runs a kernel fails if it never launched:
    # K1 on the segment lane and the long-document plane, K7 on every tree
    # path, K8 on the tree fleet (its faulted docs pass the compaction
    # watermark) and the churn path, K9 on the device rebase path, the map
    # and matrix programs on theirs.  The
    # fleet runs at recovery="grow" and then, to price recovery's per-step
    # error-count read and log, in turns off, grow, grow, off; every turn
    # ingests a round through one ingest_batch call except the first grow
    # of the turns (per-message ingest), and the second grow of the turns
    # runs with a flight recorder installed.
    from fluidframework_tpu_torch.models import doc_batch_engine as dbe
    from fluidframework_tpu_torch.ops import map_kernel as mpk
    from fluidframework_tpu_torch.ops import matrix_kernel as mxk
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk
    from fluidframework_tpu_torch.ops import rebase_kernel as rk9
    from fluidframework_tpu_torch.ops import tree_kernel as tk

    counters = {"resolve_positions": rk.resolve_positions,
                "apply_megastep": mk.apply_megastep, "compact": mk.compact,
                "apply_megastep_seg": mk.apply_megastep_seg, "compact_seg": mk.compact_seg,
                "apply_nested_megastep": tk.apply_nested_megastep,
                "compact_nested": tk.compact_nested, "rebase_window": rk9.rebase_window,
                "apply_batch_fleet": mpk.apply_batch_fleet,
                "apply_ops_fleet": mxk.apply_ops_fleet,
                "gather_cohort": dbe.gather_cohort, "scatter_cohort": dbe.scatter_cohort,
                "apply_op": mk.apply_op, "restamp": mk.restamp,
                "drop_squashed": mk.drop_squashed, "strip_stamp": mk.strip_stamp,
                **{name: getattr(tk, name) for name in K11_PROGRAMS}}
    paths = {name: {} for name in counters}

    def path(name, fn, *args, **kw):
        for c in counters.values():
            c.launches = 0
        out = fn(*args, **kw)
        for prog, c in counters.items():
            paths[prog][name] = c.launches
        return out

    def check_client_paths(clients, squash):
        """A client path runs the one-doc apply_op, K3 and K5's restamp (its
        reconnects); the squash regeneration beside it runs K5's other two."""
        for name, progs in ((clients, (("apply_op", "the one-doc apply_op"), ("compact", "K3"),
                                       ("restamp", "K5's restamp"))),
                            (squash, (("drop_squashed", "K5's drop_squashed"),
                                      ("strip_stamp", "K5's strip_stamp")))):
            for prog, what in progs:
                check(paths[prog][name] > 0, f"{what} was never launched on the {name} path")

    # Phase 16 (the SharedString client path) runs first, before any
    # torch.profiler session: its rate is host issue, one op at a time, and
    # a profiler session leaves every later launch dearer on the host.
    emit({"phase": "cuts", "why": "the script's 1,200 s limit (1,286 s uncut on an H100)",
          "reduced": CUTS})
    # Phase 19 (the chaos soak) runs first, in a process of its own on a
    # card no other phase has touched yet; phase 21 (the loadgen plant,
    # whose fleets are processes of their own on the card) next, in a
    # process of its own too.
    phase_chaos(card, paths)
    phase_loadgen(card, paths)
    finish_string, string_kmt = phase_string_client(
        args.seed, card, "cuda", n_edits=CUTS["string_client"]["n_edits"], path=path)
    check_client_paths("string_client", "string_squash")
    # Phase 17 (the DDS clients into the card's programs) runs next, also
    # before any profiler session: its rates are host-bound, and K11's
    # call times are taken in it (its device times at the end).  Phase 16's
    # CPU run goes on meanwhile, in its own process, and is read after it.
    dds_line, k11_timed = path("dds_clients", phase_dds_clients, args.seed, card, "cuda")
    for prog, what in (("apply_nested_megastep", "K7"), ("rebase_window", "K9"),
                       ("apply_batch_fleet", "the map program"),
                       ("apply_ops_fleet", "the matrix program"),
                       *((name, f"K11's {name}") for name in K11_PROGRAMS)):
        check(paths[prog]["dds_clients"] > 0, f"{what} was never launched on the dds_clients path")
    # Phase 22 (the DDS family's containers, their strings on the card) runs
    # right after, also before any profiler session: its rates are host
    # issue, one op at a time.
    path("dds_family", phase_dds_family, args.seed, card, "cuda")
    for prog, what in (("apply_op", "the one-doc apply_op"), ("compact", "K3"),
                       ("restamp", "K5's restamp")):
        check(paths[prog]["dds_family"] > 0, f"{what} was never launched on the dds_family path")
    # Phase 23 (a document's history stepped through the debugger into
    # viewers whose strings are on the card) next, also host issue, one op
    # at a time.
    path("debugger", phase_debugger, args.seed, card, "cuda")
    for prog, what in (("apply_op", "the one-doc apply_op"), ("compact", "K3")):
        check(paths[prog]["debugger"] > 0, f"{what} was never launched on the debugger path")
    finish_string()
    # Phase 18 (the network service plane: launcher shards, loader clients,
    # network writers into the card's fleet) runs next, also before any
    # profiler session: its rates are host issue and socket round trips.
    # Its client and fleet legs are paths of their own.
    phase_network(args.seed, card, "cuda", path=path)
    check_client_paths("network_clients", "network_squash")
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"),
                       ("apply_megastep_seg", "K6"), ("compact_seg", "K6's compaction"),
                       ("resolve_positions", "K1")):
        check(paths[prog]["network_fleet"] > 0, f"{what} was never launched on the network_fleet path")
    # One traffic for every fleet turn, the recovery phase (which takes two
    # rounds past the fleet's 16), the native plane and the fleet programs'
    # timing, made outside the timed runs.
    t0 = time.perf_counter()
    traffic = fleet_traffic(10_000, 18, FLEET_GEOM["ops_per_step"], 8, args.seed)
    emit({"phase": "traffic", "docs": 10_000, "rounds": 18,
          "traffic_gen_s": time.perf_counter() - t0})
    # Phase 20 (the native dispatch plane against K2 and K3) runs before any
    # profiler session too: K2's call time is host issue.  Its ring is the
    # one phase 6 times later.
    k2_ring = fleet_ring(traffic)
    phase_native_plane(card, traffic, k2_ring, paths)
    k = phase_kernels(args.seed, card)
    k9 = phase_rebase_kernel(args.seed, card)
    one_doc = _time_one_doc_programs(card, string_kmt)
    del string_kmt
    path("fleet", phase_fleet, args.seed, card, "cuda", traffic, recovery="grow")
    for recovery, ingest, record in (("off", "batch", False), ("grow", "message", False),
                                     ("grow", "batch", True), ("off", "batch", False)):
        phase_fleet(args.seed, card, "cuda", traffic, recovery=recovery, ingest=ingest,
                    record=record, trace_dir=args.trace_dir)
    path("recovery", phase_recovery, args.seed, card, "cuda", traffic, **CUTS["recovery"])
    path("hot_doc", phase_hot_doc, args.seed, card, "cuda")
    path("long_doc", phase_long_doc, args.seed, card, "cuda")
    fleet_programs = phase_fleet_programs(args.seed, card, traffic, ring=k2_ring)
    del k2_ring
    _line, ring, tree_rounds = path("tree_fleet", phase_tree_fleet, args.seed, card, "cuda",
                                    n_docs=CUTS["tree_fleet"]["n_docs"], record=True,
                                    trace_dir=args.trace_dir)
    path("tree_legacy_emit", tree_legacy_emit, card, "cuda", tree_rounds)
    del tree_rounds
    check(paths["apply_nested_megastep"]["tree_legacy_emit"] > 0,
          "K7 was never launched on the tree_legacy_emit path")
    _line, deep = path("tree_deep", phase_tree_deep, args.seed, card, "cuda")
    _line, churn = path("tree_churn", phase_tree_churn, args.seed, card, "cuda")
    path("wire_ingest", phase_wire_ingest, args.seed, card, "cuda", churn)
    tree = time_tree_programs(card, ring, shares=CUTS["tree_programs"]["shares"])
    del ring
    path("tree_rebase", phase_tree_rebase, args.seed, card, "cuda", deep,
         fleet_docs=CUTS["tree_rebase"]["fleet_docs"], trace_dir=args.trace_dir)
    del deep
    mp_line = path("map_lww", phase_map_lww, args.seed, card, "cuda")
    mx_line = path("matrix", phase_matrix, args.seed, card, "cuda")
    path("serving", phase_serving, args.seed, card, "cuda", traffic, churn, **CUTS["serving"])
    sharded = phase_sharded(args.seed, card, "cuda", traffic, churn, path=path, **CUTS["sharded"])
    del churn
    # Phase 24 (the rank mesh: one process a rank, NCCL across cards or gloo
    # on one) last: its ranks' launches land in "cross_card_ranks".
    path("cross_card", phase_cross_card, args.seed, card, "cuda", traffic, paths)
    del traffic
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"),
                       ("apply_megastep_seg", "K6"), ("compact_seg", "K6's compaction"),
                       ("resolve_positions", "K1")):
        check(paths[prog]["cross_card_ranks"] > 0,
              f"{what} was never launched on the cross_card ranks")
    # Phase 25 (the chaos stack's tree tier over the rank mesh) after it:
    # its ranks' launches land in "chaos_ranks".
    phase_chaos_ranks(card, "cuda", paths)
    for prog, what in (("apply_nested_megastep", "K7"), ("compact_nested", "K8")):
        check(paths[prog]["chaos_ranks"] > 0, f"{what} was never launched on the chaos_ranks ranks")
    for name in ("hot_doc", "long_doc", "sharded_hot"):
        check(paths["resolve_positions"][name] > 0, f"K1 was never launched on the {name} path")
    for prog, what in (("apply_megastep_seg", "K6"), ("compact_seg", "K6's compaction")):
        check(paths[prog]["sharded_hot"] > 0, f"{what} was never launched on the sharded_hot path")
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"),
                       ("gather_cohort", "the cohort gather"),
                       ("scatter_cohort", "the cohort scatter")):
        check(paths[prog]["sharded_fleet"] > 0, f"{what} was never launched on the sharded_fleet path")
    check(paths["apply_nested_megastep"]["sharded_tree"] > 0,
          "K7 was never launched on the sharded_tree path")
    for name in ("tree_fleet", "tree_deep", "tree_churn", "wire_ingest", "tree_rebase"):
        check(paths["apply_nested_megastep"][name] > 0, f"K7 was never launched on the {name} path")
    check(paths["apply_megastep"]["wire_ingest"] > 0,
          "the fleet program was never launched on the wire_ingest path")
    check(paths["rebase_window"]["tree_rebase"] > 0, "K9 was never launched on the tree_rebase path")
    check(paths["apply_batch_fleet"]["map_lww"] > 0, "the map program never ran on the map_lww path")
    check(paths["apply_ops_fleet"]["matrix"] > 0, "the matrix program never ran on the matrix path")
    for name in ("tree_fleet", "tree_churn"):
        check(paths["compact_nested"][name] > 0, f"K8 was never launched on the {name} path")
    for prog, what in (("apply_megastep", "K2"), ("compact", "K3"), ("apply_nested_megastep", "K7"),
                       ("compact_nested", "K8"), ("apply_batch_fleet", "the map program"),
                       ("apply_ops_fleet", "the matrix program")):
        check(paths[prog]["serving"] > 0, f"{what} was never launched on the serving path")

    time_k11_device(k11_timed, dds_line["k11"])
    k11 = dds_line["k11"]["programs"]
    emit({"phase": "fleet_programs_launches", **{prog: paths[prog] for prog in (
        "apply_megastep", "compact", "apply_megastep_seg", "compact_seg", "gather_cohort",
        "scatter_cohort")}})
    k2, k3 = fleet_programs["k2"], fleet_programs["k3"]
    k6n4 = sharded["hot"]["k6_n4"]
    cohort = sharded["fleet"]["cohort_programs"]
    k7, k8 = tree["k7"], tree["k8"]
    k9m = k9["microbench_256"]
    mp_prog, mx_prog = mp_line["fleet_program"], mx_line["step_program"]
    emit({"kernels": [{
        "name": "resolve_positions", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/resolve_positions.cu",
        "replaces": "fluidframework_tpu/ops/pallas_kernels.py:65",
        "launches": sum(paths["resolve_positions"].values()),
        "launches_by_path": paths["resolve_positions"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"], "device_ms": k["kernel_device_ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k["library_ms"],
    }, {
        "name": "apply_nested_megastep", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/tree_kernel.py",
        "replaces": "fluidframework_tpu/ops/tree_kernel.py:648",
        "launches": sum(paths["apply_nested_megastep"].values()),
        "launches_by_path": paths["apply_nested_megastep"],
        "max_abs_err": k7["max_abs_err"], "ms": k7["ms"], "device_ms": k7["device_ms"],
        "plain_ms": None, "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
        "library_ms": None,
    }, {
        "name": "compact_nested", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/tree_kernel.py",
        "replaces": "fluidframework_tpu/ops/tree_kernel.py:666",
        "launches": sum(paths["compact_nested"].values()),
        "launches_by_path": paths["compact_nested"],
        "max_abs_err": k8["max_abs_err"], "ms": k8["ms"], "device_ms": k8["device_ms"],
        "plain_ms": None, "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
        "library_ms": None,
    }, {
        "name": "rebase_window", "route": "cuda",
        "source": "fluidframework_tpu_torch/csrc/rebase_window.cu",
        "replaces": "fluidframework_tpu/ops/tree_kernel.py:1146",
        "launches": sum(paths["rebase_window"].values()),
        "launches_by_path": paths["rebase_window"],
        "max_abs_err": max(k9[n]["max_abs_err"] for n in (
            "microbench_256", "microbench_4096", "tree_deep_window", "serving_16")),
        "shape": [k9m["W"], k9m["C"]], "ms": k9m["ms"], "device_ms": k9m["device_ms"],
        "us_per_step": k9m["us_per_step"],
        "plain_ms": k9m["plain_ms"], "bound_ms": k9m["bound_ms"], "bound_by": k9m["bound_by"],
        "library_ms": None, "host_fold_ms": k9m["host_fold_ms"],
    }, {
        "name": "apply_batch_fleet", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/map_kernel.py",
        "replaces": "fluidframework_tpu/ops/map_kernel.py:59",
        "launches": sum(paths["apply_batch_fleet"].values()),
        "launches_by_path": paths["apply_batch_fleet"],
        "max_abs_err": mp_prog["max_abs_err"], "shape": mp_prog["shape"],
        "ms": mp_prog["ms"], "device_ms": mp_prog["device_ms"], "plain_ms": None,
        "bound_ms": mp_prog["bound_ms"], "bound_by": mp_prog["bound_by"], "library_ms": None,
    }, {
        "name": "apply_ops_fleet", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/matrix_kernel.py",
        "replaces": "fluidframework_tpu/ops/matrix_kernel.py:184",
        "launches": sum(paths["apply_ops_fleet"].values()),
        "launches_by_path": paths["apply_ops_fleet"],
        "max_abs_err": mx_prog["max_abs_err"], "shape": mx_prog["shape"],
        "ms": mx_prog["ms"], "device_ms": mx_prog["device_ms"], "plain_ms": None,
        "bound_ms": mx_prog["bound_ms"], "bound_by": mx_prog["bound_by"], "library_ms": None,
    }, {
        "name": "apply_megastep", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/mergetree_kernel.py",
        "replaces": "fluidframework_tpu/ops/mergetree_kernel.py:850",
        "launches": sum(paths["apply_megastep"].values()),
        "launches_by_path": paths["apply_megastep"],
        "max_abs_err": k2["max_abs_err"], "shape": k2["shape"], "ms": k2["ms"],
        "device_ms": k2["device_ms"],
        "plain_ms": None, "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        "name": "compact", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/mergetree_kernel.py",
        "replaces": "fluidframework_tpu/ops/mergetree_kernel.py:1532",
        "launches": sum(paths["compact"].values()),
        "launches_by_path": paths["compact"],
        "max_abs_err": k3["max_abs_err"], "docs": k3["docs"], "ms": k3["ms"],
        "device_ms": k3["device_ms"],
        "plain_ms": None, "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None,
    }, {
        "name": "apply_megastep_seg", "route": "torch",
        "source": "fluidframework_tpu_torch/ops/mergetree_kernel.py",
        "replaces": "fluidframework_tpu/ops/mergetree_kernel.py:1291",
        "launches": sum(paths["apply_megastep_seg"].values()),
        "launches_by_path": paths["apply_megastep_seg"],
        "max_abs_err": k6n4["max_abs_err"], "seg_shards": k6n4["seg_shards"],
        "shape": k6n4["shape"],
        "ms": k6n4["ms"], "device_ms": k6n4["device_ms"], "plain_ms": None,
        "bound_ms": k6n4["bound_ms"], "bound_by": k6n4["bound_by"], "library_ms": None,
    }] + [{
        "name": f"{name}_cohort", "route": "torch",
        "source": "fluidframework_tpu_torch/models/doc_batch_engine.py",
        "replaces": f"fluidframework_tpu/models/doc_batch_engine.py:{line}",
        "launches": sum(paths[f"{name}_cohort"].values()),
        "launches_by_path": paths[f"{name}_cohort"],
        "max_abs_err": cohort[name]["max_abs_err"], "lanes": cohort[name]["lanes"],
        "ms": cohort[name]["ms"], "device_ms": cohort[name]["device_ms"], "plain_ms": None,
        "bound_ms": cohort[name]["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for name, line in (("gather", 222), ("scatter", 249))] + [{
        "name": name, "route": "torch",
        "source": "fluidframework_tpu_torch/ops/mergetree_kernel.py",
        "replaces": f"fluidframework_tpu/ops/mergetree_kernel.py:{line}",
        "launches": sum(paths[name].values()), "launches_by_path": paths[name],
        "max_abs_err": one_doc[name]["max_abs_err"], "S": one_doc[name]["S"],
        "ms": one_doc[name]["ms"], "device_ms": one_doc[name]["device_ms"], "plain_ms": None,
        "bound_ms": one_doc[name]["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for name, line in (("apply_op", 775), ("drop_squashed", 1556), ("strip_stamp", 1571),
                         ("restamp", 1590))] + [{
        "name": name, "route": "torch",
        "source": "fluidframework_tpu_torch/ops/tree_kernel.py",
        "replaces": f"fluidframework_tpu/ops/tree_kernel.py:{line}",
        "launches": sum(paths[name].values()), "launches_by_path": paths[name],
        "max_abs_err": k11[name]["max_abs_err"], "shape": k11[name]["shape"],
        "ms": k11[name]["ms"], "device_ms": k11[name]["device_ms"], "plain_ms": None,
        "bound_ms": k11[name]["bound_ms"], "bound_by": "bytes", "library_ms": None,
    } for name, line in K11_PROGRAMS.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
