"""The port's snapshot corpus, legacy v1 sequence snapshots and
reference-artifact loaders against the JAX package's, exact.

- The reference's ``tests/test_snapshot_formats.py`` (every committed
  ``tests/snapshots/*.json`` loads and reproduces its recorded state, the
  corpus scripts have not drifted, the v1 -> v2 upgrade is bit-exact)
  runs in both packages through ``torch_twins``.
- The corpus guard: the port's ``regenerate(directory)`` writes files
  byte-identical to the committed current-format files, with strings on
  either backend (``KernelMergeTree`` on the CPU at a small geometry), and
  refuses to run without a directory; its command line needs ``DIR``.
- The artifact loaders (``reference_snapshots``, ``reference_traces``)
  read a reference checkout that is not here, so a small one is written
  into a temporary directory with the reference's own
  ``encode_snapshot_v1``: v1 artifacts (annotated text, markers, an
  interval-collection header, several body chunks), a legacy-format one,
  and conflict-farm traces in the reference's replay layout.  The
  reference reads it through its module paths (monkeypatched), the port
  through ``FFTPU_REFERENCE_DIR``: both decode, re-encode and replay alike.

Tolerance: exact.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

import torch_twins as twins

REF, PORT = "fluidframework_tpu", "fluidframework_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent
SNAPSHOTS = ROOT / "tests" / "snapshots"
V1_SUBDIR = "packages/dds/sequence/src/test/snapshots/v1"
LEGACY_SUBDIR = "packages/dds/sequence/src/test/snapshots/legacy"
RESULTS_SUBDIR = "packages/dds/merge-tree/src/test/results"
# A small kernel geometry for the corpus strings on KernelMergeTree (its
# insert chunk holds the corpus string's longest insert, 11 characters, in
# one segment, as the oracle does).
SMALL_KMT = dict(max_segments=64, remove_slots=4, prop_slots=4, text_capacity=512,
                 max_insert_len=16, ob_slots=4)


def imp(root: str, mod: str):
    return importlib.import_module(f"{root}.{mod}")


CASES = twins.cases("test_snapshot_formats.py")


def test_every_reference_case_is_twinned():
    n_files = len(list(SNAPSHOTS.glob("*.json")))
    assert len(CASES) == 5 + n_files + 8, len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_case_matches(case, monkeypatch):
    twins.run_pair(case, monkeypatch)


# ----------------------------------------------------------- the corpus guard

@contextlib.contextmanager
def string_backend(kind: str):
    channels = imp(PORT, "dds.channels")
    kmt = imp(PORT, "dds.kernel_backend").KernelMergeTree
    if kind == "kernel":
        channels.set_string_backend_factory(lambda: kmt(**SMALL_KMT, device="cpu"))
    try:
        yield
    finally:
        channels.set_string_backend_factory(None)


@pytest.mark.parametrize("backend", ["oracle", "kernel"])
def test_regenerate_writes_the_committed_corpus(backend, tmp_path):
    corpus = imp(PORT, "testing.snapshot_corpus")
    with string_backend(backend):
        written = corpus.regenerate(str(tmp_path / "out"))
    assert len(written) == len(corpus.SCRIPTS)
    for path in map(Path, written):
        assert path.read_bytes() == (SNAPSHOTS / path.name).read_bytes(), path.name
    assert corpus.SNAPSHOT_DIR == str(SNAPSHOTS)


def test_regenerate_needs_a_directory():
    corpus = imp(PORT, "testing.snapshot_corpus")
    before = {p.name: p.read_bytes() for p in SNAPSHOTS.glob("*.json")}
    with pytest.raises(TypeError):
        corpus.regenerate()
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.testing.snapshot_corpus"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "usage" in proc.stderr
    assert {p.name: p.read_bytes() for p in SNAPSHOTS.glob("*.json")} == before


def test_corpus_entries_match_the_references():
    """The corpus scripts give the same entries in both packages."""
    ref, port = imp(REF, "testing.snapshot_corpus"), imp(PORT, "testing.snapshot_corpus")
    assert list(port.SCRIPTS) == list(ref.SCRIPTS)
    for name in ref.SCRIPTS:
        assert port.canonical(port.build_entry(name)) == ref.canonical(ref.build_entry(name))


# ---------------------------------------------------- a small reference checkout

def _farm(seed: int, n_groups: int = 6, clients: str = "ABC"):
    """A conflict farm of reference ``SharedString`` replicas: the groups
    in the reference's replay layout and the observer replica."""
    ss = imp(REF, "dds.shared_string").SharedString
    doc = imp(REF, "server.local_service").LocalDocument("farm")
    op = imp(REF, "protocol.messages").MessageType.OP
    reps = [ss(client_id=c) for c in clients]
    observer = ss(client_id="__observer__")
    for rep in (*reps, observer):
        doc.connect(rep.client_id, rep.process)
    doc.process_all()
    rng = random.Random(seed)
    groups, text = [], ""
    for g in range(n_groups):
        start = len(doc.sequencer.log)
        order = list(reps) if g == 0 else rng.sample(reps, len(reps))
        for rep in order:
            for _ in range(rng.randint(1, 3)):
                n = len(rep.text)
                k = rng.random()
                if k < 0.55 or n < 4:
                    rep.insert_text(rng.randint(0, n), rng.choice("xyzw") * rng.randint(1, 5))
                elif k < 0.8:
                    p = rng.randrange(n - 1)
                    rep.remove_range(p, min(n, p + rng.randint(1, 3)))
                else:
                    p = rng.randrange(n - 1)
                    rep.annotate_range(p, min(n, p + 3), rng.randint(0, 2), rng.randint(1, 9))
            for m in rep.take_outbox():
                doc.submit(m)
            if rng.random() < 0.5:
                doc.process_all()
        doc.process_all()
        msgs = [json.loads(m.to_json()) for m in doc.sequencer.log[start:]]
        groups.append({"msgs": [m for m in msgs if m["type"] == op],
                       "initialText": text, "resultText": observer.text})
        text = observer.text
    return groups, observer


def _itree(blobs: dict[str, str], header: str | None = None) -> dict:
    """An artifact ITree: the merge-tree blobs under ``content`` and the
    optional interval-collection header beside it."""
    blob = lambda path, value: {"path": path, "type": "Blob",  # noqa: E731
                                "value": {"contents": value, "encoding": "utf-8"}}
    entries = [{"path": "content", "type": "Tree",
                "value": {"entries": [blob(k, v) for k, v in blobs.items()]}}]
    if header is not None:
        entries.append(blob("header", header))
    return {"entries": entries}


def _marker_tree():
    mt = imp(REF, "dds.mergetree_ref").RefMergeTree()
    markers = imp(REF, "dds.markers")
    mt.apply_insert(0, "paragraph one", 1, 0, 0)
    for i, (pos, key) in enumerate(((0, 2), (9, 3), (15, 4))):
        seg = mt.apply_insert(pos, markers.marker_char(markers.REF_TILE), key, 0, key - 1)
        seg.props[markers.MARKER_ID_KEY] = (f"marker{i}", key)
        seg.props[markers.TILE_LABELS_KEY] = (["Eop"], key)
    mt.apply_insert(4, "more", 5, 1, 4)
    mt.update_min_seq(3)
    return mt


def write_checkout(root: Path) -> dict:
    """The reference's artifact layout under ``root``, written with the
    reference's own encoder; what each file should decode to."""
    v1 = imp(REF, "dds.snapshot_v1")
    v1_dir, legacy_dir, results = (root / V1_SUBDIR, root / LEGACY_SUBDIR,
                                   root / RESULTS_SUBDIR)
    for d in (v1_dir, legacy_dir, results):
        d.mkdir(parents=True)
    names = ["A", "B", "C", "__observer__"]
    groups, observer = _farm(0)
    blobs = v1.encode_snapshot_v1(observer.backend, seq=observer.current_seq,
                                  get_long_client_id=lambda s: names[s], chunk_size=16)
    intervals = json.dumps({"intervalCollections/marks": {
        "type": "sharedStringIntervalCollection",
        "value": {"label": "marks", "version": 2, "intervals": [
            [1, 4, 3, 2, {"intervalId": "iv-1", "kind": "word"}],
            [0, 2, 5, 2, {"intervalId": "iv-2"}]]}}})
    (v1_dir / "headerAndBody.json").write_text(json.dumps(_itree(blobs, intervals)))
    marked = _marker_tree()
    mblobs = v1.encode_snapshot_v1(marked, seq=5, get_long_client_id=lambda s: "AB"[s])
    (v1_dir / "withMarkers.json").write_text(json.dumps(_itree(mblobs)))
    settled = imp(REF, "dds.mergetree_ref").RefMergeTree()
    settled.apply_insert(0, "legacy text", 1, 0, 0)
    settled.apply_annotate(0, 6, 0, 1, 2, 0, 1)
    settled.update_min_seq(2)
    header = json.loads(v1.encode_snapshot_v1(settled, 2, lambda s: "A")["header"])
    legacy = {"chunkSegmentCount": len(header["segments"]),
              "segmentTexts": header["segments"],
              "headerMetadata": {"orderedChunkMetadata": [{"id": "header"}],
                                 "totalSegmentCount": len(header["segments"]),
                                 "sequenceNumber": 2}}
    (legacy_dir / "legacyText.json").write_text(
        json.dumps(_itree({"header": json.dumps(legacy)})))
    for seed in (1, 2):
        farm, _obs = _farm(seed, clients="ABCD"[: 2 + seed])
        (results / f"len_8-clients_{2 + seed}-farm-{seed}.json").write_text(json.dumps(farm))
    return {"v1": sorted(p.name for p in v1_dir.iterdir()),
            "legacy": ["legacyText.json"], "traces": sorted(p.name for p in results.iterdir())}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("reference")
    return root, write_checkout(root)


@pytest.fixture
def loaders(checkout, monkeypatch):
    """Both packages' loader modules pointed at ``checkout``: the
    reference's by its module paths, the port's by ``FFTPU_REFERENCE_DIR``."""
    root, _want = checkout
    rs, rt = imp(REF, "testing.reference_snapshots"), imp(REF, "testing.reference_traces")
    monkeypatch.setattr(rs, "V1_SNAPSHOT_DIR", str(root / V1_SUBDIR))
    monkeypatch.setattr(rt, "REFERENCE_RESULTS_DIR", str(root / RESULTS_SUBDIR))
    with monkeypatch.context() as mp:
        mp.setenv("FFTPU_REFERENCE_DIR", str(root))
        ps = importlib.reload(imp(PORT, "testing.reference_snapshots"))
        pt = importlib.reload(imp(PORT, "testing.reference_traces"))
    try:
        yield {"ref": (rs, rt), "port": (ps, pt)}
    finally:
        importlib.reload(ps)
        importlib.reload(pt)


def test_port_lists_nothing_without_the_variable(monkeypatch):
    monkeypatch.delenv("FFTPU_REFERENCE_DIR", raising=False)
    try:
        ps = importlib.reload(imp(PORT, "testing.reference_snapshots"))
        pt = importlib.reload(imp(PORT, "testing.reference_traces"))
        assert ps.V1_SNAPSHOT_DIR is None and pt.REFERENCE_RESULTS_DIR is None
        assert ps.v1_artifact_files() == [] and ps.legacy_artifact_files() == []
        assert pt.reference_trace_files() == []
    finally:
        monkeypatch.undo()
        importlib.reload(ps)
        importlib.reload(pt)


def _tree_json(tree) -> str:
    return twins._canon({"summary": tree.export_summary(),
                         "markers": tree.marker_scan()})


def test_v1_artifacts_decode_and_reencode_alike(loaders, checkout):
    _root, want = checkout
    out = {}
    for key, (rs, _rt) in loaders.items():
        files = rs.v1_artifact_files()
        assert [os.path.basename(p) for p in files] == want["v1"]
        got = []
        for path in files:
            blobs, _extra = rs.artifact_blobs(path)
            names: list[str] = []

            def short(client: str, names=names) -> int:
                if client not in names:
                    names.append(client)
                return names.index(client)

            tree, seq, min_seq, ivs = rs.load_sequence_artifact(path, short)
            v1 = imp(rs.__name__.split(".")[0], "dds.snapshot_v1")
            again = v1.encode_snapshot_v1(tree, seq=seq, get_long_client_id=lambda s: names[s],
                                          chunk_size=16 if "Body" in path else v1.CHUNK_SIZE)
            assert again == blobs, (key, path)
            got.append([_tree_json(tree), seq, min_seq, names,
                        {k: [iv.to_json() for iv in v] for k, v in ivs.items()}])
        out[key] = twins._canon(got)
    assert out["port"] == out["ref"]
    ivs = json.loads(out["port"])[0][4]
    assert [iv["id"] for iv in ivs["marks"]] == ["iv-1", "iv-2"]
    assert len(json.loads(json.loads(out["port"])[1][0])["markers"]) == 3


def test_legacy_artifacts_load_alike(loaders, checkout):
    _root, want = checkout
    out = {}
    for key, (rs, _rt) in loaders.items():
        files = rs.legacy_artifact_files()
        assert [os.path.basename(p) for p in files] == want["legacy"]
        tree, seq, ivs = rs.load_legacy_sequence_artifact(files[0])
        out[key] = twins._canon([_tree_json(tree), seq, ivs])
        assert tree.visible_text() == "legacy text"
    assert out["port"] == out["ref"]


def test_reference_traces_replay_alike(loaders, checkout):
    _root, want = checkout
    out = {}
    for key, (_rs, rt) in loaders.items():
        files = rt.reference_trace_files()
        assert [os.path.basename(p) for p in files] == want["traces"]
        got = []
        for path in files:
            clients, observer = rt.replay_trace(rt.load_trace(path))
            solo = rt.replay_observer_only(rt.load_trace(path))
            got.append([[c.text for c in clients], observer.text,
                        twins._canon(observer.backend.export_summary()),
                        twins._canon(solo.backend.export_summary()),
                        rt.trace_clients(rt.load_trace(path))])
        out[key] = twins._canon(got)
    assert out["port"] == out["ref"]


def test_reference_trace_replays_into_a_kernel_observer(loaders):
    """The observer on ``KernelMergeTree`` (the port's on the CPU) reaches
    every group's recorded text, as the reference's kernel observer does."""
    out = {}
    for key, (_rs, rt) in loaders.items():
        root = rt.__name__.split(".")[0]
        kmt = imp(root, "dds.kernel_backend").KernelMergeTree
        extra = {"device": "cpu"} if root == PORT else {}
        path = rt.reference_trace_files()[0]
        obs = rt.replay_observer_only(rt.load_trace(path),
                                      backend_factory=lambda: kmt(**SMALL_KMT, **extra))
        out[key] = [obs.text, twins._canon(obs.backend.export_summary())]
    assert out["port"] == out["ref"]
