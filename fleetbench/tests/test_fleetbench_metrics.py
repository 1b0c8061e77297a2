"""The metric arithmetic against hand counts: rates over the whole window,
exact percentiles, the byte count and the trace reduction."""

import json
import time

import numpy as np
import pytest

from fleetbench import arith, readers, roofline, spec
from fleetbench import trace as tracing
from fleetbench.harness import Run, Spans


def test_window_rate_counts_steps_inside_the_window():
    done = [(1.0, 100), (2.5, 100), (9.9, 50)]
    assert arith.window_rate(done, 10.0) == 25.0


def test_nearest_rank_is_exact():
    v = np.arange(1, 101)
    assert arith.nearest_rank(v, 0.5) == 50
    assert arith.nearest_rank(v, 0.95) == 95
    assert arith.nearest_rank(v[::-1], 0.95) == 95
    assert arith.nearest_rank([7.0], 0.95) == 7.0
    assert arith.nearest_rank([1, 2, 3, 4], 0.5) == 2


def test_busy_and_gaps():
    busy, gaps = arith.busy_and_gaps([(1, 3), (2, 4), (6, 7), (11, 12)], 0, 10)
    assert busy == 4
    assert gaps == [(0, 1), (4, 6), (7, 10)]


def test_state_words_match_the_program():
    """The yardstick's count of a doc's state equals the program's state
    today (it is worked out from the shapes, not read from the program)."""
    from fluidframework_tpu_torch.ops import mergetree_kernel as mk

    g = spec.load("configs", "string_fleet_10k")["engine"]
    st = mk.init_state(max_segments=g["max_segments"], remove_slots=g["remove_slots"],
                       prop_slots=g["prop_slots"], text_capacity=g["text_capacity"],
                       ob_slots=g["ob_slots"], device="cpu")
    assert sum(x.numel() for x in mk.leaves(st)) == roofline.string_doc_words(g)
    assert roofline.string_row_words(g) == mk.OP_FIELDS + g["max_insert_len"]


def test_step_and_compact_bytes():
    g = dict(text_capacity=10, max_segments=2, remove_slots=1, prop_slots=1, ob_slots=1,
             max_insert_len=4)
    words = 10 + (6 + 2 + 2) * 2 + 7 + 5
    assert roofline.string_doc_words(g) == words
    # Two steps of 5 ops in all and one compact: the state moves three
    # times over, the rows once.
    assert roofline.steps_bytes(g, 3, 2, 5, 1) == 4 * (2 * 3 * words * 3 + 5 * 12)


def _chrome(events):
    return {"traceEvents": events}


def test_trace_summary(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "fleetbench.traced", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "fleetbench.ingest", "ts": 0, "dur": 400},
        {"ph": "X", "cat": "user_annotation", "name": "fleetbench.step", "ts": 400, "dur": 600},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 410, "dur": 5,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 100, "dur": 5,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 500, "dur": 300, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "fill", "ts": 150, "dur": 50, "args": {"correlation": 2}},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps(_chrome(ev)))
    s = tracing.summarize(str(p))
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(350e-6)
    assert s["step_device_s"] == pytest.approx(300e-6)
    assert s["device_ops"][0] == ["k2", pytest.approx(300e-6)]
    assert s["idle_gaps"][:2] == [["ingest", pytest.approx(300e-6)], ["step", pytest.approx(200e-6)]]


def test_readers():
    spans = Spans()
    spans.seconds.update(step=2.0, ingest=4.0)
    spans.calls.update(step=4)
    spans.ops.update(ingest=2000, step=2000)
    g = spec.load("configs", "string_fleet_10k")["engine"]
    run = Run(setup_s=3.0, spans=spans, traffic={"compact": True},
              out={"done": [(1, 500), (5, 500)], "window_s": 10.0, "latencies": np.array([0.1, 0.2, 0.3])},
              trace={"window_s": 10.0, "busy_s": 2.5, "step_device_s": 2.0},
              peaks={"hbm_bytes_per_s": 3.35e12}, geometry=g, n_docs=10_000)
    assert readers.window_rate(run) == 100.0
    assert readers.step_ms(run) == 500.0
    assert readers.ingest_us_per_op(run) == 2000.0
    assert readers.latency_ms(0.5)(run) == pytest.approx(200.0)
    assert readers.device_idle_pct(run) == 75.0
    want = roofline.steps_bytes(g, 10_000, 4, 2000, 4)
    assert readers.program_roofline(run) == pytest.approx(100 * want / 3.35e12 / 2.0)
    run.trace = None
    assert readers.program_roofline(run) is None and readers.device_idle_pct(run) is None


class _FakeProfiler:
    def __init__(self):
        self.entered = self.exited = 0

    def __enter__(self):
        self.entered += 1

    def __exit__(self, *exc):
        self.exited += 1


def test_spans_trace_the_first_part_of_the_window():
    """The profiler stops at the end of the first span that ends past
    ``trace_s``; ``traced`` keeps the totals up to there."""
    prof = _FakeProfiler()
    spans = Spans(prof, trace_s=0.05)
    spans.start()
    with spans("step", 10):
        pass
    assert spans.traced is None
    with spans("step", 20):
        time.sleep(0.06)
    assert prof.exited == 1 and spans.traced.calls == {"step": 2}
    assert spans.traced.ops == {"step": 30}
    with spans("step", 40):
        pass
    spans.stop()
    assert prof.entered == prof.exited == 1
    assert spans.calls["step"] == 3 and spans.traced.calls == {"step": 2}
