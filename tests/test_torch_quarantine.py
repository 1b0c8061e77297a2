"""The port's quarantine lane, overflow-lane serving and divergence
watchdog against the JAX engine on the same streams.

The flows of tests/test_engine_checkpoint.py and
tests/test_overflow_recovery.py without a checkpoint store: a lane that
keeps serving and compacting, a malformed op isolated to its doc, a
decode failure quarantined at ingest, backoff readmission, the poison
budget, and the watchdog quarantining a diverged doc behind its device
digest pre-filter (K4, ``fleet_digest``, also held against the
reference's ``_fleet_digest`` on random states).  Compared with
``assert_engines_equal`` of tests/test_torch_recovery.py: tolerance 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidframework_tpu.models.doc_batch_engine import _fleet_digest
from fluidframework_tpu_torch.models import doc_batch_engine as port_engine
from fluidframework_tpu_torch.models.doc_batch_engine import fleet_digest
from fluidframework_tpu_torch.ops import mergetree_kernel as tk
from fluidframework_tpu_torch.protocol.stamps import NO_REMOVE

from test_engine_checkpoint import _ins, _join, _op, _schedule
from test_torch_recovery import assert_engines_equal, engines, feed


def test_lane_keeps_serving_and_compacting():
    """Ops after recovery flow to the lane; compaction covers the lane."""
    ref, port = engines(max_segments=4)
    feed((ref, port), 0, [_join("w0", 0)] + [_ins(s, 0, "ab") for s in range(1, 11)])
    feed((ref, port), 1, [_join("w0", 0), _ins(1, 0, "hi")])
    for eng in (ref, port):
        eng.step()
    assert 0 in port.overflow
    tail = [
        _op(11, {"type": 1, "pos1": 0, "pos2": 4}),
        _op(12, {"type": 2, "pos1": 1, "pos2": 5, "props": {"7": 3}}),
        _ins(13, 2, "zz"),
    ]
    for msg in tail:
        msg.min_seq = 12
    feed((ref, port), 0, tail)
    for eng in (ref, port):
        eng.step()
        eng.compact()
    assert_engines_equal(ref, port, 2)
    assert port.text(0) == "abzz" + "ab" * 7
    assert int(port.doc_state(0).min_seq) == 12


def test_malformed_op_isolated_and_readmitted():
    """A poisoned doc quarantines, drops exactly the poison op and stays
    serviceable; its sibling is untouched; readmit returns it to the batch
    (no store here: tests/test_torch_checkpoint.py bounds the replay)."""
    D = 2
    sched = _schedule(D, 9, poison=(1, 6))
    ref, port = engines(D)
    for d in range(D):
        feed((ref, port), d, [_join("w0", 0)])
    seen = [0] * D
    for d, m, _p in sched:
        seen[d] += 1
        feed((ref, port), d, [m])
        if seen[d] % 4 == 0:
            for eng in (ref, port):
                eng.step()
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, D)
    assert 1 in port.quarantine and port.health()["poison_ops_dropped"] == 1
    # Serviceable while quarantined, then readmitted to the batch.
    feed((ref, port), 1, [_ins(2000, 0, "zz")])
    assert port.readmit(1) and ref.readmit(1)
    feed((ref, port), 1, [_ins(2001, 0, "qq")])
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, D)
    assert port.text(1).startswith("qqzz") and port.health()["readmissions"] == 1


def test_decode_failure_quarantines_at_ingest():
    ref, port = engines()
    for d in range(2):
        feed((ref, port), d, [_join("w0", 0), _ins(1, 0, "hi")])
    feed((ref, port), 0, [_ins(2, 0, "xx", client="ghost")])  # not in quorum
    for eng in (ref, port):
        eng.step()
        # A legal-but-unsupported spec is a loud gap, never quarantine.
        with pytest.raises(NotImplementedError):
            eng.ingest(1, _op(2, {"type": 0, "pos1": 0, "seg": {"text": "x"}}))
    feed((ref, port), 1, [_ins(2, 2, "!")])
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, 2)
    assert 0 in port.quarantine and port.text(1) == "hi!"


def test_auto_readmit_after_backoff():
    ref, port = engines(readmit_after_steps=2)
    for d in range(2):
        feed((ref, port), d, [_join("w0", 0), _ins(1, 0, "hi")])
    for eng in (ref, port):
        eng.step()
    feed((ref, port), 0, [_ins(2, 10**6, "XX")])  # poison
    for eng in (ref, port):
        eng.step()
    assert 0 in port.quarantine
    for s in range(3, 7):
        feed((ref, port), 1, [_ins(s, 0, "a")])
        for eng in (ref, port):
            eng.step()
    assert_engines_equal(ref, port, 2)
    assert port.health()["auto_readmissions"] == 1 and 0 not in port.quarantine
    feed((ref, port), 0, [_ins(3, 0, "ok")])
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, 2)


def test_poison_budget_routes_flapping_doc_to_oracle():
    ref, port = engines(readmit_after_steps=1, poison_budget=2)
    feed((ref, port), 0, [_join("w0", 0), _ins(1, 0, "hi")])
    for seq in range(2, 6):
        feed((ref, port), 0, [_ins(seq, 10**6, "XX")])
        for _ in range(4):
            for eng in (ref, port):
                eng.step()
    assert_engines_equal(ref, port, 2)
    assert 0 in port.oracles and port.health()["poison_routed_docs"] == 1
    feed((ref, port), 0, [_ins(6, 0, "zz")])
    assert port.text(0) == ref.text(0) and port.text(0).startswith("zz")


def _tamper(ref, port, d: int, cp: int) -> None:
    """Flip the first codepoint of doc d's text pool behind both engines."""
    ref.state = ref.state._replace(text=ref.state.text.at[d, 0].set(cp))
    port.state.text[d, 0] = cp


def test_watchdog_quarantines_diverged_doc_and_prefilters():
    ref, port = engines(watchdog_every=1)
    for d in range(2):
        feed((ref, port), d, [_join("w0", 0), _ins(1, 0, "hello")])
    for eng in (ref, port):
        eng.step()  # every doc verified, digests pinned
    feed((ref, port), 0, [_ins(2, 0, "a")])  # only doc 0 moves
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, 2)
    assert port.health()["watchdog_prefiltered"] == 1
    assert port._verified_digest == ref._verified_digest
    _tamper(ref, port, 0, ord("X"))
    feed((ref, port), 0, [_ins(3, 0, "b")])
    feed((ref, port), 1, [_ins(2, 5, "!")])
    for eng in (ref, port):
        eng.step()
    assert_engines_equal(ref, port, 2)
    assert 0 in port.quarantine and port.text(0) == "bahello"
    assert port.health()["watchdog_mismatches"] == 1


def test_watchdog_sweep_tamper_passes_only_that_doc_through_the_prefilter():
    """The chip smoke's tamper check at test size: verify every doc, change
    one codepoint of one doc's visible text in its device row, sweep: the
    other docs are prefiltered, that one is quarantined to the oracle."""
    D = 2
    ref, port = engines(D)
    for d in range(D):
        feed((ref, port), d, [_join("w0", 0), _ins(1, 0, f"doc{d}-text")])
    for eng in (ref, port):
        eng.step()
        assert eng.watchdog(sample=D) == []
    before = port.health().get("watchdog_prefiltered", 0)
    _tamper(ref, port, 1, ord("Q"))
    assert ref.watchdog(sample=D) == port.watchdog(sample=D) == [1]
    assert port.health()["watchdog_prefiltered"] == before + D - 1
    assert_engines_equal(ref, port, D)
    assert port.text(1) == "doc1-text"


def _random_fleet(rng, D, S, R, T, OB=4, P=2):
    """A [D, ...] state whose digest columns hold random values, column
    maxima (NO_REMOVE, 2**31-1) and negative int32 bit patterns."""
    host = tk.to_numpy(tk.batch_state(tk.init_state(S, R, P, T, OB, device="cpu"), D))

    def col(shape, hi=1 << 20):
        x = rng.integers(0, hi, size=shape, dtype=np.int64)
        x[rng.random(shape) < 0.05] = 2**31 - 1
        x[rng.random(shape) < 0.05] = -(2**31)
        x[rng.random(shape) < 0.05] = -1
        return x.astype(np.int32)

    return host._replace(
        text=col((D, T), 0x110000), text_end=col((D,)), nseg=col((D,)),
        seg_start=col((D, S)), seg_len=col((D, S)),
        rem_keys=tuple(
            np.where(rng.random((D, S)) < 0.5, NO_REMOVE, col((D, S))).astype(np.int32)
            for _ in range(R)
        ),
    )


@pytest.mark.parametrize("D,S,R,T", [(5, 16, 2, 64), (3, 40, 4, 300)])
def test_fleet_digest_matches_reference(D, S, R, T, monkeypatch):
    host = _random_fleet(np.random.default_rng(D * S), D, S, R, T)
    want = np.asarray(_fleet_digest(jax.tree.map(jnp.asarray, host)))
    got = fleet_digest(tk.from_numpy(host, device="cpu")).numpy()
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 2**32).all()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    # Chunked (one doc per chunk) gives the same digest.
    monkeypatch.setattr(port_engine, "DIGEST_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(fleet_digest(tk.from_numpy(host, device="cpu")).numpy(), got)
