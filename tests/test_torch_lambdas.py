"""The port's ordering-service lambdas and partition manager against the
JAX package's, exact.

- Every case of the reference's ``tests/test_pipeline.py``,
  ``tests/test_durable_log.py`` and ``tests/test_partition_rebalance.py``
  runs in both packages through ``torch_twins``.
- One seeded raw-op stream (joins, ops with stale, future and out-of-order
  client sequence numbers, leaves, summaries with live, unknown and
  consumed upload handles over several documents) goes through both
  packages' ``PipelineService`` (Python and native deli) and
  ``DurablePipelineService``, the durable one checkpointed, crashed and
  reopened twice (once past its checkpoint, once with no checkpoint
  since).  Held equal: every deltas-topic record, the op store, the
  summary acks and nacks, the scribe's snapshots, the copier's archive, the
  deli nacks and checkpoints, and ``apply_replay_dedup``'s arming at each
  reopen.  Timestamps (the wall clock) are left out.
- The ``PartitionManager`` with a worker killed mid-stream, and
  ``ScribePool.align_to_placement``, in both packages.

Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import importlib
import pathlib
import tempfile

import numpy as np
import pytest

import torch_twins as twins

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"


@contextlib.contextmanager
def tmp_dir(root: str):
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


CASES = (twins.cases("test_pipeline.py")
         + twins.cases("test_durable_log.py", fixtures={"tmp_path": {"tmp": tmp_dir}})
         + twins.cases("test_partition_rebalance.py"))


def test_every_reference_case_is_twinned():
    assert len(CASES) == 7 + 15 + 8, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


# ------------------------------------------------------------ the raw stream

DOCS = ("docA", "docB", "docC", "docD", "docE")


def raw_stream(seed: int, n: int = 160) -> list[tuple]:
    """Front-end actions with numpy draws: joins, ops (mostly valid, some
    with a stale or future refSeq or a repeated clientSeq), leaves, and
    summaries whose handle is live, unknown, or one already consumed."""
    rng = np.random.default_rng(seed)
    joined: dict[str, dict[str, int]] = {d: {} for d in DOCS}
    heads = {d: 0 for d in DOCS}
    uploads = 0
    out: list[tuple] = []
    for _ in range(n):
        doc = DOCS[int(rng.integers(len(DOCS)))]
        r = rng.random()
        members = joined[doc]
        if r < 0.12 or not members:
            cid = f"c{int(rng.integers(4))}"
            if cid not in members:
                members[cid] = 0
                heads[doc] += 1
                out.append(("join", doc, cid))
        elif r < 0.17:
            cid = sorted(members)[int(rng.integers(len(members)))]
            del members[cid]
            heads[doc] += 1
            out.append(("leave", doc, cid))
        elif r < 0.27:
            cid = sorted(members)[int(rng.integers(len(members)))]
            members[cid] += 1
            kind = int(rng.integers(4))
            if kind < 2:
                uploads += 1
                out.append(("upload", {"type": "tree", "entries": {
                    "runtime": {"type": "blob", "content": {"n": uploads}}}}))
                handle = f"upload_{uploads}"
            elif kind == 2:
                handle = "upload_bogus"
            else:
                handle = f"upload_{max(1, uploads)}"  # possibly consumed
            out.append(("op", doc, cid, members[cid], heads[doc], "summarize", handle))
            heads[doc] += 1
        else:
            cid = sorted(members)[int(rng.integers(len(members)))]
            good = members[cid] + 1
            cseq = good if rng.random() > 0.1 else int(rng.integers(0, good + 2))
            rseq = int(rng.integers(max(0, heads[doc] - 3), heads[doc] + (2 if rng.random() < 0.08 else 1)))
            out.append(("op", doc, cid, cseq, rseq, "op", int(rng.integers(1000))))
            if cseq == good and rseq <= heads[doc]:
                members[cid] = cseq
                heads[doc] += 1
    return out


def _feed(root: str, svc, actions) -> None:
    msgs = importlib.import_module(f"{root}.protocol.messages")
    for act in actions:
        if act[0] == "join":
            svc.join(act[1], act[2])
        elif act[0] == "leave":
            svc.leave(act[1], act[2])
        elif act[0] == "upload":
            svc.upload_summary(act[1])
        else:
            _, doc, cid, cseq, rseq, kind, body = act
            if kind == "summarize":
                m = msgs.UnsequencedMessage(
                    client_id=cid, client_seq=cseq, ref_seq=rseq,
                    type=msgs.MessageType.SUMMARIZE,
                    contents={"handle": body, "refSeq": rseq})
            else:
                m = msgs.UnsequencedMessage(
                    client_id=cid, client_seq=cseq, ref_seq=rseq,
                    type=msgs.MessageType.OP, contents={"n": body})
            svc.submit_op(doc, m)


def _msg(m) -> list:
    return [m.client_id, m.client_seq, m.ref_seq, m.seq, m.min_seq, m.type,
            m.contents, m.metadata, m.short_client]


def _raw(payload) -> list:
    kind, body = payload
    if kind == "op":
        return [kind, body.client_id, body.client_seq, body.ref_seq, body.type, body.contents]
    return [kind, body]


def _deli_state(lam) -> dict:
    ck = lam.checkpoint()
    return {"offset": ck["offset"], "produced": ck["produced"], "docs": ck["docs"],
            "nacks": [[d, n.client_id, n.client_seq, n.reason] for d, n in lam.nacks],
            "dedup_until": lam.dedup_until, "replay_boundary": lam.replay_boundary,
            "replay_responses": sorted(lam.replay_responses)}


def trace(svc) -> dict:
    """What the pipeline holds, timestamps left out."""
    return {
        "deltas": [[[r.offset, r.doc_id, _msg(r.payload)]
                    for r in svc.deltas.partition(p).read(0)]
                   for p in range(svc.deltas.n_partitions)],
        "raw": [[[r.offset, r.doc_id, _raw(r.payload)]
                 for r in svc.rawdeltas.partition(p).read(0)]
                for p in range(svc.rawdeltas.n_partitions)],
        "ops": {d: [_msg(m) for m in svc.ops_of(d)] for d in DOCS},
        "acks": {d: [[m.type, m.contents] for m in svc.ops_of(d)
                     if m.type in ("summaryAck", "summaryNack")] for d in DOCS},
        "snapshots": {d: svc.snapshots_of(d) for d in DOCS},
        "archive": {d: [_raw(p) for p in svc.raw_of(d)] for d in DOCS},
        "deli": [_deli_state(lam) for lam in svc.deli],
        "offsets": [[lam.offset for lam in svc.scriptorium],
                    [lam.offset for lam in svc.scribe],
                    [lam.offset for lam in svc.moira]],
        "uploads": sorted(svc.uploads),
    }


def run_memory(root: str, actions, native: bool) -> dict:
    lambdas = importlib.import_module(f"{root}.server.lambdas")
    svc = lambdas.PipelineService(n_partitions=3, use_native_sequencer=native)
    half = len(actions) // 2
    _feed(root, svc, actions[:half])
    svc.pump()
    _feed(root, svc, actions[half:])
    svc.pump()
    out = trace(svc)
    assert {type(s).__name__ for lam in svc.deli for s in lam.sequencers.values()} == (
        {"NativeSequencer"} if native else {"Sequencer"})
    return out


def run_durable(root: str, actions, directory: str) -> list:
    """Checkpoint after the first third, crash after the second (past the
    checkpoint), reopen; crash again with no checkpoint since, reopen, and
    finish.  A trace at each reopen and at the end."""
    lambdas = importlib.import_module(f"{root}.server.lambdas")
    thirds = [actions[: len(actions) // 3], actions[len(actions) // 3: 2 * len(actions) // 3],
              actions[2 * len(actions) // 3:]]
    traces = []
    svc = lambdas.DurablePipelineService(directory, n_partitions=2)
    _feed(root, svc, thirds[0])
    svc.pump()
    svc.checkpoint()
    _feed(root, svc, thirds[1])
    svc.pump()
    svc.close()  # crash past the checkpoint
    svc = lambdas.DurablePipelineService(directory, n_partitions=2)
    traces.append(trace(svc))
    _feed(root, svc, thirds[2][: len(thirds[2]) // 2])
    svc.pump()
    svc.close()  # crash with no checkpoint since the reopen
    svc = lambdas.DurablePipelineService(directory, n_partitions=2)
    traces.append(trace(svc))
    _feed(root, svc, thirds[2][len(thirds[2]) // 2:])
    svc.pump()
    svc.checkpoint()
    traces.append(trace(svc))
    svc.close()
    return traces


@pytest.mark.parametrize("native", [False, True], ids=["python_deli", "native_deli"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_stream_matches_reference(seed, native):
    actions = raw_stream(seed)
    got, want = run_memory(PORT, actions, native), run_memory(REF, actions, native)
    assert sum(len(v) for v in got["acks"].values()) > 0
    assert any(d["nacks"] for d in got["deli"])
    assert got == want


@pytest.mark.parametrize("seed", [0, 3])
def test_durable_pipeline_restarts_match_reference(seed, tmp_path):
    actions = raw_stream(seed)
    got = run_durable(PORT, actions, str(tmp_path / "port"))
    want = run_durable(REF, actions, str(tmp_path / "ref"))
    assert got == want
    # The restarts re-ticketed nothing twice: each doc's seqs are unique.
    for doc, ops in got[-1]["ops"].items():
        seqs = [m[3] for m in ops]
        assert seqs == sorted(set(seqs)), doc


def _dedup_scenario(root: str, directory: str) -> dict:
    """A summary acked into the durable deltas log after the checkpoint,
    then a crash: what ``apply_replay_dedup`` arms, both ways."""
    lambdas = importlib.import_module(f"{root}.server.lambdas")
    msgs = importlib.import_module(f"{root}.protocol.messages")
    svc = lambdas.DurablePipelineService(directory, n_partitions=1)
    svc.join("doc", "alice")
    svc.pump()
    svc.checkpoint()
    out = {}
    for i, body in enumerate(({"v": 1}, {"v": 2}), start=1):
        h = svc.upload_summary({"type": "tree", "entries": {
            "root": {"type": "blob", "content": body}}})
        svc.submit_op("doc", msgs.UnsequencedMessage(
            client_id="alice", client_seq=i, ref_seq=i, type=msgs.MessageType.SUMMARIZE,
            contents={"handle": h, "refSeq": i}))
    svc.pump()
    svc.close()  # crash: both summaries acked past the checkpoint
    for arm in (True, False):
        rec = lambdas.DurablePipelineService(directory, n_partitions=1)
        deli = lambdas.DeliLambda(rec.rawdeltas, rec.deltas, 0)
        uploads = dict(rec.uploads)
        processed = lambdas.apply_replay_dedup(
            deli, 0, rec.rawdeltas, rec.deltas, uploads, 0, arm_responses=arm)
        out[str(arm)] = {"processed": sorted(processed), "uploads": sorted(uploads),
                         **_deli_state(deli)}
        out[f"trace_{arm}"] = trace(rec)
        rec.close()
    return out


def test_apply_replay_dedup_matches_reference(tmp_path):
    got = _dedup_scenario(PORT, str(tmp_path / "port"))
    want = _dedup_scenario(REF, str(tmp_path / "ref"))
    assert got["True"]["processed"] == [("doc", "upload_1"), ("doc", "upload_2")]
    assert got["True"]["replay_responses"] and not got["False"]["replay_responses"]
    assert got == want


# ------------------------------------------------------ partitions and scribes

def _partition_kill(root: str) -> dict:
    pm_mod = importlib.import_module(f"{root}.server.partition_manager")
    pm = pm_mod.PartitionManager(n_partitions=4)
    seen: dict[str, list] = {}
    for w in ("a", "b", "c"):
        pm.add_worker(w)
    actions = raw_stream(5, 120)
    for d in DOCS:
        pm.subscribe(d, lambda m, d=d: seen.setdefault(d, []).append(m.seq))
    _feed(root, pm, actions[:60])
    pm.pump()
    _feed(root, pm, actions[60:90])
    # The pump's side effects past the periodic checkpoint die with "b".
    for lams in pm.workers["b"].values():
        lams.pump()
    pm.kill_worker("b")
    _feed(root, pm, actions[90:])
    pm.pump()
    pm.remove_worker("a")
    pm.pump()
    return {
        "assignments": pm.assignments(), "rebalances": pm.rebalances,
        "deltas": [[[r.offset, r.doc_id, _msg(r.payload)] for r in pm.deltas.partition(p).read(0)]
                   for p in range(4)],
        "ops": {d: [_msg(m) for m in pm.ops_of(d)] for d in DOCS},
        "snapshots": {d: pm.snapshots_of(d) for d in DOCS},
        "checkpoints": {str(p): c for p, c in sorted(pm.checkpoints.items())},
        "seen": seen,
    }


def test_partition_manager_kill_matches_reference():
    got, want = _partition_kill(PORT), _partition_kill(REF)
    for doc, ops in got["ops"].items():
        seqs = [m[3] for m in ops]
        assert seqs == sorted(set(seqs)), doc
    assert got == want


def _aligned(root: str, directory: str, device: dict) -> dict:
    log = importlib.import_module(f"{root}.server.ordered_log")
    pm_mod = importlib.import_module(f"{root}.server.partition_manager")
    topic = log.Topic("deltas", 4)
    pool = pm_mod.ScribePool(topic, directory, **device)
    for m in ("s1", "s2", "s3"):
        pool.add_member(m)
    placement = {f"d{i}": (i * 3) % 6 for i in range(10)}
    ownership = pool.align_to_placement(placement)
    out = {"ownership": ownership,
           "routes": {d: topic.partition_for(d) for d in placement},
           "assignments": {m: pool.group.assignments(m) for m in sorted(pool.members)}}
    pool.kill_member("s2")
    out["after_kill"] = {m: pool.group.assignments(m) for m in sorted(pool.members)}
    out["health"] = pool.health()
    pool.close()
    return out


def test_scribe_pool_alignment_matches_reference(tmp_path):
    got = _aligned(PORT, str(tmp_path / "port"), {"device": "cpu"})
    want = _aligned(REF, str(tmp_path / "ref"), {})
    assert got == want
