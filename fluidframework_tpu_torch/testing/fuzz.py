"""Model-based DDS fuzz harness with an eventual-consistency oracle.

A port of ``fluidframework_tpu/testing/fuzz.py`` (no JAX in it).

Reference parity: @fluid-private/test-dds-utils ``DDSFuzzModel`` /
``createDDSFuzzSuite`` (packages/dds/test-dds-utils/src/ddsFuzzHarness.ts:233)
+ @fluid-private/stochastic-test-utils: a weighted generator of operations,
a reducer applying them to one of N simulated clients, built-in meta-ops
(synchronize, client add, reconnect, offline stash/rehydrate, rollback of
staged ops), convergence validation after every synchronize, seed
minification on failure, and deterministic failure replay.

A model plugs in exactly three things (ddsFuzzHarness.ts's shape):
  - ``channel_type``: which DDS to host,
  - ``generate(rng, channel)``: one weighted random op description,
  - ``reduce(channel, op)``: apply it through the channel's public API,
plus optional ``check_consistent(a, b)`` (defaults to summary equality
after synchronize).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable

from ..dds.channels import default_registry
from ..runtime.container_runtime import ContainerRuntime
from ..server.local_service import LocalService


@dataclass
class DDSFuzzModel:
    name: str
    channel_type: str
    generate: Callable[[random.Random, Any], dict | None]
    reduce: Callable[[Any, dict], None]
    check_consistent: Callable[[Any, Any], None] | None = None
    # meta-op weights (ddsFuzzHarness.ts:155 defaults, simplified)
    weights: dict[str, float] = field(
        default_factory=lambda: {
            "edit": 12.0,
            "flush": 4.0,
            "synchronize": 2.0,
            "reconnect": 0.5,
            "stash": 0.25,
            "add_client": 0.25,
            "rollback": 0.25,
        }
    )


class FuzzClient:
    """One simulated client: container + the single channel under test."""

    def __init__(self, doc, name: str, channel_type: str, stash: str | None = None):
        self.name = name
        self.epoch = 0  # reconnect counter (deterministic identity minting)
        self.container = ContainerRuntime(default_registry(), container_id=name)
        ds = self.container.create_datastore("root")
        ds.create_channel(channel_type, "target")
        self.container.connect(doc, name, stash=stash)

    @property
    def channel(self):
        return self.container.datastore("root").get_channel("target")


class FuzzFailure(AssertionError):
    def __init__(self, seed: int, step: int, trace: list, cause: BaseException):
        super().__init__(
            f"fuzz seed {seed} failed at step {step}: {cause!r}\n"
            f"trace ({len(trace)} actions): {trace}"
        )
        self.seed = seed
        self.step = step
        self.trace = trace
        self.cause = cause


def _default_check(a, b) -> None:
    sa, sb = a.summarize(), b.summarize()
    assert sa == sb, f"divergence:\n  {sa}\n  {sb}"


def run_fuzz_seed(
    model: DDSFuzzModel,
    seed: int,
    steps: int = 120,
    n_clients: int = 3,
    trace: list | None = None,
    replay: bool = False,
) -> None:
    """Run one randomized schedule; raises FuzzFailure on any defect.

    When ``trace`` is given it records the executed action list (for
    minification); with ``replay=True`` the given trace is executed verbatim
    instead (deterministic failure replay, ddsFuzzHarness replay files).
    """
    rng = random.Random(seed)
    svc = LocalService()
    doc = svc.document(f"fuzz-{model.name}-{seed}")
    clients = [FuzzClient(doc, f"C{i}", model.channel_type) for i in range(n_clients)]
    doc.process_all()

    recorded: list = trace if trace is not None else []

    def pick_action(step_rng):
        kinds = list(model.weights)
        weights = [model.weights[k] for k in kinds]
        return step_rng.choices(kinds, weights=weights)[0]

    step = -1
    try:
        schedule = range(len(recorded)) if replay else range(steps)
        for step in schedule:
            if replay:
                action = recorded[step]
            else:
                kind = pick_action(rng)
                ci = rng.randrange(len(clients))
                action = {"kind": kind, "client": ci}
                if kind == "edit":
                    c = clients[ci]
                    if not c.container.has_document:
                        action = {"kind": "noop"}
                    else:
                        op = model.generate(rng, c.channel)
                        if op is None:
                            action = {"kind": "noop"}
                        else:
                            action["op"] = op
                recorded.append(action)
            _apply_action(model, action, clients, doc, rng)
        step += 1
        if not replay:
            # Epilogue: one final convergence check (a replayed trace already
            # carries its own recorded epilogue).
            recorded.append({"kind": "synchronize", "client": 0})
            _apply_action(model, recorded[-1], clients, doc, rng)
    except FuzzFailure:
        raise
    except BaseException as e:
        raise FuzzFailure(seed, step, list(recorded), e) from e


def _apply_action(model: DDSFuzzModel, action: dict, clients, doc, rng) -> None:
    kind = action["kind"]
    if kind == "noop":
        return
    c = clients[action.get("client", 0) % len(clients)]
    if kind == "edit":
        if c.container.has_document:
            model.reduce(c.channel, action["op"])
    elif kind == "flush":
        if c.container.has_document:
            c.container.flush()
    elif kind == "synchronize":
        for cl in clients:
            if cl.container.has_document:
                cl.container.flush()
        doc.process_all()
        live = [cl for cl in clients if cl.container.has_document and cl.container.joined]
        check = model.check_consistent or _default_check
        for other in live[1:]:
            check(live[0].channel, other.channel)
    elif kind == "reconnect":
        if c.container.has_document:
            c.container.disconnect()
            c.epoch += 1
            c.container.connect(doc, f"{c.name}.r{c.epoch}")
            doc.process_all()
    elif kind == "stash":
        if c.container.has_document and not c.container.closed:
            c.container.disconnect()
            stash = c.container.get_pending_local_state()
            c.container.close()
            idx = clients.index(c)
            clients[idx] = FuzzClient(
                doc, f"{c.name}.s", model.channel_type, stash=stash
            )
            doc.process_all()
    elif kind == "add_client":
        clients.append(FuzzClient(doc, f"X{len(clients)}", model.channel_type))
        doc.process_all()
    elif kind == "rollback":
        if c.container.has_document:
            try:
                c.container.rollback_staged()
            except NotImplementedError:
                pass
    else:
        raise ValueError(f"unknown fuzz action {kind!r}")


def minimize(model: DDSFuzzModel, failure: FuzzFailure) -> list:
    """Greedy trace minification (ddsFuzzHarness minification): repeatedly
    drop actions while the failure reproduces."""
    trace = list(failure.trace)

    def still_fails(candidate: list) -> bool:
        t = list(candidate)
        try:
            run_fuzz_seed(model, failure.seed, trace=t, replay=True)
            return False
        except FuzzFailure:
            return True
        except BaseException:
            return True

    changed = True
    while changed:
        changed = False
        i = 0
        while i < len(trace):
            candidate = trace[:i] + trace[i + 1 :]
            if still_fails(candidate):
                trace = candidate
                changed = True
            else:
                i += 1
    return trace


def run_fuzz_suite(
    model: DDSFuzzModel,
    seeds: range | list[int],
    steps: int = 120,
    n_clients: int = 3,
    minify: bool = True,
) -> None:
    """Run many seeds; on the first failure, minify and raise with the
    reduced trace (the suite entry point tests call)."""
    for seed in seeds:
        try:
            run_fuzz_seed(model, seed, steps=steps, n_clients=n_clients)
        except FuzzFailure as f:
            if minify:
                reduced = minimize(model, f)
                raise FuzzFailure(f.seed, f.step, reduced, f.cause) from f.cause
            raise
