"""The port's tools and ``utils/config`` against the reference's.

- ``tools/trace_viewer``: ``main`` on a port flight-recorder trace (plain
  and gzipped) prints the reference's checks' lines, and ``summarize``
  gives the reference's text for the same events; a bad file exits 1
  (``tests/test_observability.py`` ``TestTraceViewer``).
- ``tools/summary_inspect``: ``list``, ``show`` and ``diff`` over a port
  scribe's ``SummaryRecordStore`` (``tests/test_scribe.py``
  ``test_summary_inspect_cli``), each line equal to the reference CLI's
  over the same directory.
- ``tools/replay_tool``: time travel and the seq cap over the port's
  replay driver and ``Container`` (``tests/test_tooling.py``), the state
  dumps equal to the reference tool's over the same history.
- ``utils/config``: layered typed reads and the monitoring context's child
  logger (``tests/test_utils.py`` ``TestConfig``), and the package's
  exports are the reference's.
"""

from __future__ import annotations

import gzip
import json

import pytest

import fluidframework_tpu.utils as ref_utils
from fluidframework_tpu.dds.channels import default_registry as ref_registry
from fluidframework_tpu.driver import LocalDocumentServiceFactory as RefLocalFactory
from fluidframework_tpu.loader import Container as RefContainer
from fluidframework_tpu.server import LocalService as RefService
from fluidframework_tpu.tools import ReplayTool as RefReplayTool
from fluidframework_tpu.tools import summary_inspect as ref_inspect
from fluidframework_tpu.tools import trace_viewer as ref_viewer
import fluidframework_tpu_torch.utils as port_utils
from fluidframework_tpu_torch.dds.channels import default_registry
from fluidframework_tpu_torch.driver.local_driver import LocalDocumentServiceFactory
from fluidframework_tpu_torch.driver.replay_driver import ReplayDocumentServiceFactory
from fluidframework_tpu_torch.loader.container import Container
from fluidframework_tpu_torch.observability import FlightRecorder
from fluidframework_tpu_torch.server.local_service import LocalService
from fluidframework_tpu_torch.server.scribe import ScribeConfig, ScribeLambda
from fluidframework_tpu_torch.tools import ReplayTool, summary_inspect, trace_viewer
from fluidframework_tpu_torch.utils import CachedConfigProvider, Logger, MonitoringContext

from test_torch_scribe import PORT, _acks, _durable_topic, _join, _string_stream


# ------------------------------------------------------------- trace viewer

def _trace(tmp_path, gz: bool) -> str:
    rec = FlightRecorder()
    with rec.span("dispatch", k=4):
        with rec.span("upload", shards=1):
            pass
    rec.instant("recompile", program="fleet_megastep", cache_size=2)
    rec.instant("migrate_doc", doc="d0", src=0, dst=1)
    path = str(tmp_path / "t.json")
    rec.export_chrome_trace(path)
    if gz:
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            g.write(f.read())
        path += ".gz"
    return path


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gzip"])
def test_trace_viewer_summarizes_a_port_trace(tmp_path, capsys, gz):
    path = _trace(tmp_path, gz)
    assert trace_viewer.main([path, "--top", "5"]) == 0
    out = capsys.readouterr().out
    assert "phase shares" in out
    assert "dispatch" in out and "upload" in out
    assert "recompile events: 1" in out
    assert "fleet_megastep" in out
    assert "migrate_doc" in out
    events = trace_viewer.load_trace(path)
    assert trace_viewer.summarize(events, top=5) == ref_viewer.summarize(events, top=5)


def test_trace_viewer_bad_file(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    assert trace_viewer.main([str(bad)]) == 1
    assert trace_viewer.main([str(tmp_path / "absent.json")]) == 1
    assert "fftpu-torch-trace" in capsys.readouterr().err


# ----------------------------------------------------------- summary inspect

def _scribe_dir(tmp_path) -> str:
    topic = _durable_topic(PORT, tmp_path / "log")
    _join(PORT, "d0", topic)
    _string_stream(PORT, "d0", topic, range(1, 13))
    sdir = str(tmp_path / "scribe")
    scribe = ScribeLambda(topic, sdir, config=ScribeConfig(max_ops=6), device="cpu")
    scribe.pump()
    _string_stream(PORT, "d0", topic, range(13, 25), seed=2)
    scribe.pump()
    assert len(_acks(PORT, topic, "d0")) == 2
    scribe.close()
    topic.close()
    return sdir


def test_summary_inspect_cli(tmp_path, capsys):
    sdir = _scribe_dir(tmp_path)

    def both(args):
        assert summary_inspect.main(args) == 0
        port = capsys.readouterr().out
        assert ref_inspect.main(args) == 0
        assert capsys.readouterr().out == port
        return port

    lines = [json.loads(line) for line in both(["list", sdir]).splitlines()]
    assert len(lines) == 2 and {line["seq"] for line in lines} == {12, 24}
    assert sum(line["latest"] for line in lines) == 1

    shown = json.loads(both(["show", sdir, "--doc", "d0"]))
    assert shown["seq"] == 24 and shown["record"]["engine"] == "doc_batch"

    diff = json.loads(both(["diff", sdir, "--doc", "d0"]))
    assert diff["from"]["seq"] == 12 and diff["to"]["seq"] == 24
    assert any(c["path"].startswith("summary") for c in diff["changes"])


# --------------------------------------------------------------- replay tool

def _seed_service(svc_cls, factory_cls, container_cls, registry):
    """A service with a short recorded history on doc 'd' (the reference
    test's ``seed_service``)."""
    svc = svc_cls()
    factory = factory_cls(svc)
    d = container_cls.create_detached(registry(), container_id="creator")
    ds = d.runtime.create_datastore("root")
    ds.create_channel("sharedString", "text")
    ds.create_channel("sharedMap", "meta")
    d.attach("d", factory, "creator")
    svc.process_all()
    t = d.runtime.datastore("root").get_channel("text")
    for i, word in enumerate(["alpha ", "beta ", "gamma "]):
        t.insert_text(0, word)
        d.runtime.datastore("root").get_channel("meta").set(f"k{i}", i)
        d.runtime.flush()
        svc.process_all()
    return svc, "d"


def _port_service():
    return _seed_service(LocalService, LocalDocumentServiceFactory, Container, default_registry)


def test_replay_tool_time_travel():
    svc, doc_id = _port_service()
    tool = ReplayTool.from_local_service(svc, doc_id)
    text = lambda: tool.container.runtime.datastore("root").get_channel("text").text  # noqa: E731
    assert text() == ""
    log = svc.document(doc_id).sequencer.log
    mid = log[len(log) // 2].seq
    tool.step_to(mid)
    partial = text()
    tool.step_to()
    assert text() == "gamma beta alpha "
    assert partial in ("", "alpha ", "beta alpha ")  # a real prefix state
    with pytest.raises(Exception):  # read-only: the replay container cannot submit
        tool.container.runtime.datastore("root").get_channel("meta").set("x", 1)
        tool.container.runtime.flush()
        tool.container.runtime.submit_protocol_message("propose", {})


def test_replay_to_seq_cap():
    svc, doc_id = _port_service()
    log = svc.document(doc_id).sequencer.log
    cap = log[3].seq
    tool = ReplayTool(ReplayDocumentServiceFactory.from_local_service(svc, to_seq=cap), doc_id)
    tool.step_to()
    assert tool.current_seq <= cap


def test_replay_tool_dumps_equal_the_references():
    """Step by step, the port's replay tool and the reference's hold the
    same text and the same ``current_seq`` over the same history."""
    svc, doc_id = _port_service()
    ref_svc, _ = _seed_service(RefService, RefLocalFactory, RefContainer, ref_registry)
    port_log = svc.document(doc_id).sequencer.log
    ref_log = ref_svc.document(doc_id).sequencer.log
    assert [m.seq for m in port_log] == [m.seq for m in ref_log]
    tool = ReplayTool.from_local_service(svc, doc_id)
    ref_tool = RefReplayTool.from_local_service(ref_svc, doc_id)

    def view(t):
        ds = t.container.runtime.datastore("root")
        meta = ds.get_channel("meta")
        return t.current_seq, ds.get_channel("text").text, {k: meta.get(k) for k in meta.keys()}

    for m in port_log:
        tool.step_to(m.seq)
        ref_tool.step_to(m.seq)
        assert view(tool) == view(ref_tool), m.seq
    assert sorted(tool.state_dump()) == sorted(ref_tool.state_dump())


# ------------------------------------------------------------------ config

def test_config_layered_typed_reads():
    cfg = CachedConfigProvider(
        {"FluidTpu.A": "true", "FluidTpu.N": "42"},
        {"FluidTpu.A": "false", "FluidTpu.B": 7},
    )
    assert cfg.get_bool("FluidTpu.A") is True  # first provider wins
    assert cfg.get_number("FluidTpu.N") == 42.0
    assert cfg.get_number("FluidTpu.B") == 7
    assert cfg.get_bool("FluidTpu.Missing", default=False) is False
    assert cfg.get_string("FluidTpu.A") == "true"


def test_config_monitoring_context_child():
    mc = MonitoringContext(Logger("root"))
    child = mc.child("dds", docId="d9")
    child.logger.generic("x")
    (e,) = mc.logger.events
    assert e["eventName"] == "root:dds:x" and e["docId"] == "d9"


def test_config_reads_match_the_references():
    raw = {"K.bool": "FALSE", "K.one": "1", "K.num": "2.5", "K.bad": "x", "K.int": 3,
           "K.flag": True, "K.list": [1], "K.none": None}
    port = CachedConfigProvider(raw, lambda key: "fallback" if key == "K.none" else None)
    ref = ref_utils.CachedConfigProvider(raw, lambda key: "fallback" if key == "K.none" else None)
    for key in [*raw, "K.missing"]:
        for get in ("get_bool", "get_number", "get_string"):
            assert getattr(port, get)(key, default="d") == getattr(ref, get)(key, default="d"), (
                key, get)


def test_utils_exports_are_the_references():
    assert sorted(port_utils.__all__) == sorted(ref_utils.__all__)
    for name in set(port_utils.__all__) - {"ConfigTypes"}:  # a typing alias
        assert getattr(port_utils, name).__module__.startswith("fluidframework_tpu_torch.utils")
    assert port_utils.ConfigTypes == ref_utils.ConfigTypes
