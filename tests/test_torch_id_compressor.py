"""The port's ``IdCompressor`` against the JAX package's, exact.

The cases of the reference's ``tests/test_utils.py`` ``TestIdCompressor``
run in both packages with the same session ids (``create_session_id`` is
patched in both modules to draw from one seeded sequence): every id,
creation range, normalization, decompression and ``serialize()`` output
must be equal, and the reference test's own assertions hold in both.  A
seeded farm of replicas then covers interleaved generation, finalization
in total order, untake and reset, cross-session normalization and the
serialize / deserialize round trip, comparing the same observations.
"""

from __future__ import annotations

import json
import random
import uuid

import pytest

from fluidframework_tpu.utils import id_compressor as ref_idc
from fluidframework_tpu_torch.utils import id_compressor as port_idc

PKGS = (ref_idc, port_idc)


def seeded_session_ids(seed: int):
    rng = random.Random(seed)
    return lambda: str(uuid.UUID(int=rng.getrandbits(128), version=4))


@pytest.fixture
def run_both(monkeypatch):
    """``run_both(scenario, seed)``: the scenario's trace in each package,
    each with its own copy of one seeded session-id sequence."""

    def run(scenario, seed=0):
        traces = []
        for m in PKGS:
            monkeypatch.setattr(m, "create_session_id", seeded_session_ids(seed))
            out = []
            scenario(m, out.append)
            traces.append(json.dumps(out, sort_keys=True, default=repr))
        assert traces[0] == traces[1]
        return json.loads(traces[1])

    return run


def _rng(r):
    return None if r is None else [r.session_id, r.first_gen_count, r.last_gen_count, r.count]


def local_ids(m, rec):
    c = m.IdCompressor()
    rec(c.session_id)
    rec([c.generate_compressed_id(), c.generate_compressed_id()])
    assert c.generate_compressed_id() == -3


def finalize(m, rec):
    c = m.IdCompressor()
    a, b = c.generate_compressed_id(), c.generate_compressed_id()
    rng = c.take_next_creation_range()
    rec(_rng(rng))
    assert (rng.first_gen_count, rng.last_gen_count) == (1, 2)
    c.finalize_creation_range(rng)
    rec([c.normalize_to_op_space(a), c.normalize_to_op_space(b)])
    e = c.generate_compressed_id()
    rec([e, c.normalize_to_op_space(e), c.serialize()])


def eager_finals(m, rec):
    c = m.IdCompressor(cluster_capacity=4)
    c.generate_compressed_id()
    c.finalize_creation_range(c.take_next_creation_range())
    nxt = [c.generate_compressed_id() for _ in range(7)]
    assert nxt[0] >= 0
    rec([nxt, [c.decompress(i) for i in nxt], c.serialize()])


def cross_client(m, rec):
    a, b = m.IdCompressor(), m.IdCompressor()
    ida = a.generate_compressed_id()
    rng = a.take_next_creation_range()
    a.finalize_creation_range(rng)
    b.finalize_creation_range(rng)
    wire = a.normalize_to_op_space(ida)
    got = b.normalize_to_session_space(wire, a.session_id)
    assert got == wire and b.decompress(got) == a.decompress(ida)
    got2 = b.normalize_to_session_space(-1, a.session_id)
    assert got2 == wire
    rec([wire, got, got2, b.decompress(got), a.serialize(), b.serialize()])


def recompress(m, rec):
    c = m.IdCompressor()
    i = c.generate_compressed_id()
    stable = c.decompress(i)
    assert c.recompress(stable) == i
    c.finalize_creation_range(c.take_next_creation_range())
    rec([stable, c.recompress(stable), c.normalize_to_op_space(i),
         c.try_recompress(str(uuid.UUID(int=5)))])


def out_of_order(m, rec):
    a = m.IdCompressor()
    a.generate_compressed_id()
    r1 = a.take_next_creation_range()
    a.generate_compressed_id()
    r2 = a.take_next_creation_range()
    b = m.IdCompressor()
    with pytest.raises(ValueError, match="out of order") as e:
        b.finalize_creation_range(r2)
    rec(str(e.value))
    b.finalize_creation_range(r1)
    b.finalize_creation_range(r2)
    rec(b.serialize())


def deterministic(m, rec):
    compressors = [m.IdCompressor() for _ in range(3)]
    ranges = []
    for c in compressors:
        for _ in range(5):
            c.generate_compressed_id()
        ranges.append(c.take_next_creation_range())
    for c in compressors:
        for r in ranges:
            c.finalize_creation_range(r)
    states = [c.serialize(with_session=False) for c in compressors]
    assert states[0] == states[1] == states[2]
    rec(states[0])


def round_trip(m, rec):
    c = m.IdCompressor()
    for _ in range(3):
        c.generate_compressed_id()
    c.finalize_creation_range(c.take_next_creation_range())
    c2 = m.IdCompressor.deserialize(c.serialize())
    assert c2.session_id == c.session_id
    rec([c.serialize(), c2.serialize(), c2.normalize_to_op_space(-1), c2.decompress(-3)])
    c3 = m.IdCompressor.deserialize(c.serialize(with_session=False),
                                    session_id=str(uuid.UUID(int=7)))
    rec([c3.serialize(), c3.generate_compressed_id()])


def cluster_expansion(m, rec):
    c = m.IdCompressor(cluster_capacity=2)
    for _ in range(2):
        c.generate_compressed_id()
    c.finalize_creation_range(c.take_next_creation_range())
    for _ in range(6):
        c.generate_compressed_id()
    c.finalize_creation_range(c.take_next_creation_range())
    finals = [c.normalize_to_op_space(-(g + 1)) for g in range(8)]
    assert finals == list(range(8))
    rec([finals, c.serialize()])


def bad_input(m, rec):
    for cap in (0, m.IdCompressor.MAX_CLUSTER_SIZE + 1):
        with pytest.raises(ValueError) as e:
            m.IdCompressor(cluster_capacity=cap)
        rec(str(e.value))
    c = m.IdCompressor()
    c.generate_compressed_id()
    c.take_next_creation_range()
    with pytest.raises(ValueError) as e:
        c.untake_creation_range(5)
    rec(str(e.value))
    c.untake_creation_range(1)
    rec(_rng(c.take_next_creation_range()))


CASES = [local_ids, finalize, eager_finals, cross_client, recompress, out_of_order,
         deterministic, round_trip, cluster_expansion, bad_input]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_reference_cases_match(run_both, case):
    run_both(case)


def farm(n_clients: int, steps: int, seed: int):
    def scenario(m, rec):
        rng = random.Random(seed)
        cs = [m.IdCompressor(cluster_capacity=rng.choice([1, 2, 4, 512]))
              for _ in range(n_clients)]
        generated = [[] for _ in cs]
        for step in range(steps):
            i = rng.randrange(n_clients)
            c = cs[i]
            r = rng.random()
            if r < 0.45:
                generated[i].append(c.generate_compressed_id())
                rec(["gen", i, generated[i][-1]])
            elif r < 0.75:
                rg = c.take_next_creation_range()
                rec(["take", i, _rng(rg)])
                if rg is None:
                    continue
                if rng.random() < 0.15:
                    c.untake_creation_range(rg.first_gen_count)
                    rec(["untake", i])
                    continue
                for other in cs:  # sequenced: every replica in total order
                    other.finalize_creation_range(rg)
            elif r < 0.8:
                c.reset_unfinalized_creation_range()
                rec(["reset", i])
            elif generated[i]:
                sid = rng.choice(generated[i])
                op = c.normalize_to_op_space(sid)
                j = rng.randrange(n_clients)
                try:
                    back = cs[j].normalize_to_session_space(op, c.session_id)
                    rec(["norm", i, j, sid, op, back, cs[j].decompress(back)])
                except Exception as e:  # an unfinalized foreign local id
                    rec(["norm-error", i, j, sid, op, type(e).__name__, str(e)])
                rec(["stable", c.decompress(sid), c.recompress(c.decompress(sid))])
        for i, c in enumerate(cs):
            rec(["state", i, c.serialize(), c.serialize(with_session=False)])
            c2 = m.IdCompressor.deserialize(c.serialize())
            rec(["restored", i, c2.serialize() == c.serialize(), c2.generate_compressed_id()])

    return scenario


@pytest.mark.parametrize("seed", range(4))
def test_seeded_farm_matches(run_both, seed):
    trace = run_both(farm(3, 160, seed), seed=seed)
    assert any(e[0] == "norm" for e in trace)
