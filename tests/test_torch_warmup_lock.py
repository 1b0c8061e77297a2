"""Neither engine's ``warmup`` holds ``ckpt_lock`` while it loads (on a
cold ``_build/``, builds) the CUDA kernel library.

An nvcc run under ``ckpt_lock`` would stall every ingest behind it, as the
port's constructor already avoids for the native encoder.  Each engine is
built on the CPU; only the warmup's library check sees a ``cuda`` device
(``LibraryCheckSeesCuda``), and ``cuda_build.load`` and ``cuda_build.build``
are replaced by probes that try the engine's ``ckpt_lock`` from another
thread (it is re-entrant, so the warmup's own thread would always get it).
The warmup must have called the library load with the lock free, return
the same dispatch count as a plain CPU warmup, and leave every state byte
as it was.

Tolerance: exact.
"""

from __future__ import annotations

import threading

import pytest
import torch

from fluidframework_tpu_torch.models.doc_batch_engine import DocBatchEngine
from fluidframework_tpu_torch.models.tree_batch_engine import TreeBatchEngine
from fluidframework_tpu_torch.ops import cuda_build

BASE = dict(max_insert_len=8, ops_per_step=4, max_segments=32, text_capacity=256,
            remove_slots=2, prop_slots=2, ob_slots=2)
ENGINES = {
    "doc": lambda: DocBatchEngine(2, device="cpu", megastep_k=6, **BASE),
    "tree": lambda: TreeBatchEngine(2, device="cpu", megastep_k=6),
}


class LibraryCheckSeesCuda:
    """The engine's CPU device, but ``type`` reads ``"cuda"`` until the
    kernel library has been loaded once: the warmup's library check takes
    the card's branch, and everything after it runs on the CPU."""

    def __init__(self, real: torch.device, loads: list):
        self._real = real
        self._loads = loads

    @property
    def type(self) -> str:
        return "cpu" if self._loads else "cuda"

    def __getattr__(self, name):
        return getattr(self._real, name)


def state_leaves(state) -> list:
    """Every tensor of an engine's state, nested tuples flattened."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for part in state for t in state_leaves(part)]


def lock_is_free(lock) -> bool:
    """Whether another thread can take ``lock`` right now (it takes and
    releases it in that thread)."""
    got = []

    def attempt():
        ok = lock.acquire(timeout=0)
        if ok:
            lock.release()
        got.append(ok)

    t = threading.Thread(target=attempt)
    t.start()
    t.join(timeout=30)
    return got == [True]


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_warmup_loads_the_cuda_library_outside_ckpt_lock(kind, monkeypatch):
    plain = ENGINES[kind]().warmup()
    eng = ENGINES[kind]()
    eng._staging()  # the staging ring is made on the real device, up front
    before = [t.clone() for t in state_leaves(eng.state)]
    calls: list = []

    def probe(name):
        def fn(*a, **kw):
            calls.append((name, lock_is_free(eng.ckpt_lock)))
        return fn

    monkeypatch.setattr(cuda_build, "load", probe("load"))
    monkeypatch.setattr(cuda_build, "build", probe("build"))
    monkeypatch.setattr(eng, "device", LibraryCheckSeesCuda(eng.device, calls))
    warmed = eng.warmup()
    assert calls == [("load", True)], calls
    assert warmed == plain
    after = state_leaves(eng.state)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
