"""The port's DDS fuzz harness (``testing/fuzz.py``) against the JAX
package's, exact.

- Every case of the reference's ``tests/test_fuzz_harness.py`` runs in both
  packages through ``torch_twins``, with the string channels on the
  ``RefMergeTree`` oracle and on ``KernelMergeTree`` (the port's on the
  CPU), as the reference's ``string_backend`` fixture runs them.
- ``run_fuzz_seed`` for the same model and seed in both packages: the
  recorded action traces, every document's sequenced log and every
  client's container summary at the end must be equal.  The models are the
  reference test file's own (map, string and tree), each package running
  its own copy.

Tolerance: exact.
"""

from __future__ import annotations

import importlib
import json

import pytest

import test_fuzz_harness as ref_models
import torch_twins as twins

CASES = twins.cases("test_fuzz_harness.py", setup=twins.BACKENDS)
PORT_MODELS = twins.port_twin("test_fuzz_harness.py")


def test_every_reference_case_is_twinned():
    assert len(CASES) == 5 * 2, [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


def _seed_run(root: str, model, seed: int, steps: int):
    fuzz = importlib.import_module(f"{root}.testing.fuzz")

    def run():
        trace: list = []
        fuzz.run_fuzz_seed(model, seed=seed, steps=steps, trace=trace)
        return trace
    return run


@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("model", ["MAP_MODEL", "STRING_MODEL", "TREE_MODEL"])
def test_fuzz_seed_actions_and_states_match(model, seed, monkeypatch):
    pkgs = twins.packages()
    want, _ = twins.run_traced(
        _seed_run("fluidframework_tpu", getattr(ref_models, model), seed, 80),
        pkgs["ref"], monkeypatch)
    got, seen = twins.run_traced(
        _seed_run("fluidframework_tpu_torch", getattr(PORT_MODELS, model), seed, 80),
        pkgs["port"], monkeypatch)
    assert seen["ContainerRuntime"] and seen["LocalDocument"]
    assert len(json.loads(got)["result"]) > 40
    assert got == want
