"""The port's reference-format SharedTree summary codec against the JAX
package's, both directions, byte for byte.

``dds/tree/reference_summary.py`` reads and writes the reference
implementation's own summary files (ITree JSON: the chunked-forest
FieldBatch blob, the SchemaString, the index stamps).  Those artifacts
live in a checkout named by ``FFTPU_REFERENCE_DIR``, which neither package
has here, so both list none; the summaries these tests write stand in for
them.  Seeded forests and schemas go through both packages' encoders (the
blobs must be byte-equal) and each package decodes the other's output to
the same nodes and registry; whole summary files written by one package
load in the other and re-encode to the same bytes; and the committed
``tests/snapshots/sharedTree.v1.json`` loads in both.
"""

from __future__ import annotations

import json
import os
import random

import pytest

import torch_twins as twins
from fluidframework_tpu.dds.tree import reference_summary as ref_rs
from fluidframework_tpu.dds.tree import schema as ref_schema
from fluidframework_tpu.dds.tree.forest import Node as RefNode
from fluidframework_tpu_torch.dds.tree import reference_summary as port_rs
from fluidframework_tpu_torch.dds.tree import schema as port_schema
from fluidframework_tpu_torch.dds.tree.forest import Node as PortNode

PKGS = {"ref": (ref_rs, ref_schema, RefNode), "port": (port_rs, port_schema, PortNode)}


def rand_field(pkg: str, seed: int, depth: int = 3) -> list:
    """One seeded random field of nodes (leaves of every kind, object nodes
    with and without values, nested fields)."""
    _rs, schema, Node = PKGS[pkg]
    rng = random.Random(seed)

    def node(d):
        if d == 0 or rng.random() < 0.45:
            return schema.leaf(rng.choice([rng.randrange(-50, 100), rng.random(),
                                           "s" * rng.randint(0, 4), True, False, None]))
        return Node(
            type=f"app.T{rng.randrange(3)}",
            value=rng.randrange(10) if rng.random() < 0.3 else None,
            fields={k: [node(d - 1) for _ in range(rng.randint(1, 3))]
                    for k in rng.sample(["a", "b", "c"], rng.randint(1, 3))},
        )

    return [node(depth) for _ in range(rng.randint(0, 5))]


def rand_registry(pkg: str, seed: int):
    _rs, schema, _Node = PKGS[pkg]
    rng = random.Random(seed)
    kinds = [schema.FieldKind.VALUE, schema.FieldKind.OPTIONAL, schema.FieldKind.SEQUENCE]
    types = ["number", "string", "boolean", "null", "app.T0", "app.T1", "app.T2"]
    reg = schema.SchemaRegistry()
    for name in rng.sample(["app.T0", "app.T1", "app.T2"], rng.randint(1, 3)):
        reg.add(schema.NodeSchema(name, {
            k: schema.FieldSchema(rng.choice(kinds), set(rng.sample(types, rng.randint(1, 3))))
            for k in rng.sample(["a", "b", "c"], rng.randint(0, 3))}))
    if rng.random() < 0.4:
        reg.add(schema.array_schema("app.List", set(rng.sample(types, 2))))
    if rng.random() < 0.8:
        reg.root = schema.FieldSchema(rng.choice(kinds), set(rng.sample(types, 2)))
    return reg


def nodes_json(nodes) -> str:
    return json.dumps([n.to_json() for n in nodes], sort_keys=True)


@pytest.mark.parametrize("versions", [(1, 1), (2, 1), (2, 2)])
def test_field_batch_codec_matches_both_ways(versions):
    for seed in range(25):
        blobs = {}
        for pkg, (rs, _s, _n) in PKGS.items():
            field = rand_field(pkg, seed)
            other = {"detached-0": rand_field(pkg, seed + 100, depth=1)} if seed % 3 == 0 else None
            order = ["detached-0", "rootFieldKey"] if other and seed % 2 else None
            blobs[pkg] = rs.encode_field_batch(field, *versions, other_fields=other,
                                               key_order=order)
        assert blobs["port"] == blobs["ref"], seed
        for reader in ("ref", "port"):
            back = PKGS[reader][0].decode_field_batch(blobs["ref"])
            want = ref_rs.decode_field_batch(blobs["ref"])
            assert list(back) == list(want)
            for key in want:
                assert nodes_json(back[key]) == nodes_json(want[key]), (seed, reader, key)


def test_schema_codec_matches_both_ways():
    for seed in range(40):
        regs = {pkg: rand_registry(pkg, seed) for pkg in PKGS}
        for version in (1, 2):
            out = {pkg: PKGS[pkg][0].schema_to_reference(regs[pkg], version) for pkg in PKGS}
            assert out["port"] == out["ref"], (seed, version)
            for reader in ("ref", "port"):
                back = PKGS[reader][0].schema_from_reference(out["ref"])
                want = ref_rs.schema_from_reference(out["ref"])
                assert json.dumps(back.to_json(), sort_keys=True) == json.dumps(
                    want.to_json(), sort_keys=True), (seed, version, reader)


# The document the reference's own summary-load snapshots encode.
def snapshot_doc(pkg: str):
    _rs, schema, Node = PKGS[pkg]
    child = lambda n: Node(type="test schema.child", fields={"count": [schema.leaf(n)]})
    return [Node(type="test schema.parent", fields={
        "child": [Node(type="test schema.nodes", fields={"": [child(1), child(2)]})],
        "label": [schema.leaf("foo")],
    })]


def snapshot_schema(pkg: str):
    _rs, schema, _Node = PKGS[pkg]
    F, K = schema.FieldSchema, schema.FieldKind
    reg = schema.SchemaRegistry()
    reg.add(schema.NodeSchema("test schema.parent", {
        "child": F(K.VALUE, {"test schema.nodes"}), "label": F(K.OPTIONAL, {"string"})}))
    reg.add(schema.array_schema("test schema.nodes", {"test schema.child"}))
    reg.add(schema.NodeSchema("test schema.child", {"count": F(K.VALUE, {"number"})}))
    reg.root = F(K.OPTIONAL, {"test schema.parent"})
    return reg


FORMATS = [  # (top, schema, forest blob, forest top, forest fields)
    (1, 1, "ForestTree", 1, 1),
    (1, 2, "ForestTree", 1, 2),
    (2, 2, "contents", 2, 2),
]


def loaded(pkg: str, fmt, seed: int) -> dict:
    top, schema_v, blob, forest_top, fields_v = fmt
    root = snapshot_doc(pkg) if seed == 0 else rand_field(pkg, seed)
    reg = snapshot_schema(pkg) if seed == 0 else rand_registry(pkg, seed)
    versions = {"EditManager": 1, "Schema": schema_v, "Forest": 1}
    if seed % 2 == 0:
        versions["DetachedFieldIndex"] = 1
    return {
        "root_field": root, "forest_fields": {"rootFieldKey": root},
        "forest_key_order": ["rootFieldKey"], "schema": reg,
        "edit_manager": {"trunk": [], "branches": [], "version": 1},
        "detached": {"data": [], "maxId": -1, "version": 1}, "versions": versions,
        "format": {"top_version": top, "schema_version": schema_v, "schema_lossless": True,
                   "forest_blob": blob, "forest_top_version": forest_top,
                   "forest_fields_version": fields_v},
    }


def loaded_json(x: dict) -> str:
    return json.dumps({
        **{k: v for k, v in x.items() if k not in ("root_field", "forest_fields", "schema")},
        "root_field": [n.to_json() for n in x["root_field"]],
        "forest_fields": {k: [n.to_json() for n in v] for k, v in x["forest_fields"].items()},
        "schema": x["schema"].to_json(),
    }, sort_keys=True)


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("fmt", FORMATS, ids=["v1", "v1-schema2", "v2"])
def test_summary_files_round_trip_across_packages(writer, fmt, tmp_path):
    """A summary file the ``writer`` package encodes is the same bytes the
    other encodes; both loaders read it to the same model, and each
    re-encodes it to the file byte for byte."""
    for seed in range(6):
        files = {pkg: PKGS[pkg][0].encode_reference_tree_summary(loaded(pkg, fmt, seed))
                 for pkg in PKGS}
        assert files["port"] == files["ref"], seed
        path = tmp_path / f"singleTree-Uncompressed-v{fmt[0]}-{seed}.json"
        path.write_text(files[writer], encoding="utf-8")
        reads = {pkg: PKGS[pkg][0].load_reference_tree_summary(str(path)) for pkg in PKGS}
        assert loaded_json(reads["port"]) == loaded_json(reads["ref"]), seed
        for pkg in PKGS:
            assert PKGS[pkg][0].encode_reference_tree_summary(reads[pkg]) == files[writer]


def test_lossy_schema_and_null_leaf_guards():
    """The reference artifacts test's guards, in both packages: a null leaf
    keeps its explicit wire value, and a schema outside the lossless subset
    refuses to regenerate."""
    blob = ('{"keys":["rootFieldKey"],"fields":{"version":2,"identifiers":[],'
            '"shapes":[{"c":{"extraFields":1}},{"a":0}],'
            '"data":[[1,["com.fluidframework.leaf.null",true,null,[]]]]},"version":2}')
    for pkg, (rs, _s, _n) in PKGS.items():
        nodes = rs.decode_field_batch(blob)["rootFieldKey"]
        assert nodes[0].type == "null" and nodes[0].value is None
        assert rs.encode_field_batch(nodes, 2, 2) == blob
        x = loaded(pkg, FORMATS[2], 0)
        x["format"]["schema_lossless"] = False
        with pytest.raises(ValueError, match="lossless subset"):
            rs.encode_reference_tree_summary(x)


def test_snapshot_listing_matches(tmp_path, monkeypatch):
    """Without a reference checkout neither package lists an artifact; over
    one directory of written summaries both list the same files, by
    strategy."""
    assert port_rs.summary_snapshot_files() == ref_rs.summary_snapshot_files() == []
    for strategy in ("Uncompressed", "Compressed"):
        for v in (1, 2):
            (tmp_path / f"singleTree-{strategy}-v{v}-1.json").write_text("{}")
    (tmp_path / "README.md").write_text("")
    for rs in (ref_rs, port_rs):
        monkeypatch.setattr(rs, "SNAPSHOT_DIR", str(tmp_path))
    for strategy in (None, "Uncompressed", "Compressed"):
        got = port_rs.summary_snapshot_files(strategy)
        assert got == ref_rs.summary_snapshot_files(strategy) and got


def test_port_reads_no_directory_unless_named():
    """The port looks for the reference checkout only where
    ``FFTPU_REFERENCE_DIR`` points."""
    if os.environ.get("FFTPU_REFERENCE_DIR"):
        pytest.skip("a reference checkout is named")
    assert port_rs.SNAPSHOT_DIR is None


def test_golden_shared_tree_snapshot_loads_in_both():
    twins.check_golden("sharedTree")
