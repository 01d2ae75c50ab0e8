"""The readers of the program's own spans and counters
(``program_trace.py`` and the metrics that use it) on the synthetic
trace of ``test_bench_metrics`` with recorded events whose answers are
known, on a program without the recorder, and on spans that the
program's recorder really recorded."""

import sys
import time

import pytest

from decode_bench import harness, program_trace
from decode_bench import trace as T
from decode_bench.tests.test_bench_metrics import synthetic
from m2dec_tpu_torch import runtime
from m2dec_tpu_torch.runtime import trace

MS = 1_000_000  # ns
READERS = ("pack_ms_per_picture", "launch_ms_per_picture", "pack_idle_pct",
           "launch_idle_pct", "upload_bytes_per_picture")


def recorded():
    """Two calls of the batch entry inside the synthetic window (device
    idle in [0, 5], [22, 40], [46, 60] and [70, 100] ms): pack, upload,
    unpack and steps on the calling thread (1), a fill on a pool thread
    (2), an upload count each call."""
    spans = [("batch.pack", 0, 10 * MS, 1), ("pack.fill", MS, 9 * MS, 2),
             ("batch.upload", 10 * MS, 12 * MS, 1),
             ("batch.unpack", 12 * MS, 14 * MS, 1),
             ("step", 14 * MS, 20 * MS, 1), ("step.mc", 14 * MS, 16 * MS, 1),
             ("step", 20 * MS, 30 * MS, 1),
             ("batch.pack", 50 * MS, 62 * MS, 1), ("step", 62 * MS, 80 * MS, 1)]
    counts = [("upload_bytes", 11 * MS, 1000),
              ("upload_bytes", 51 * MS, 600)]
    return trace.Events(spans, counts, 0)


@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_readers_of_recorded_events(codec, monkeypatch):
    tr = synthetic(codec)
    monkeypatch.setattr(trace, "events", lambda t0, t1: recorded())
    read = {n: harness.read_metric(n, tr) for n in READERS}
    assert read["pack_ms_per_picture"] == pytest.approx(22 / 8)
    assert read["launch_ms_per_picture"] == pytest.approx(34 / 8)
    # idle [0, 5] and [50, 60] inside a pack; [22, 30] and [70, 80]
    # inside a step; of a window of 100 ms
    assert read["pack_idle_pct"] == pytest.approx(15.0)
    assert read["launch_idle_pct"] == pytest.approx(18.0)
    assert read["upload_bytes_per_picture"] == pytest.approx(200.0)


def test_nothing_to_read(monkeypatch):
    """No program span in the window (the synthetic trace lies in 1970),
    and a program without the recorder: every reader reads None."""
    tr = synthetic("h264")
    assert all(harness.read_metric(n, tr) is None for n in READERS)
    monkeypatch.setattr(trace, "events", lambda t0, t1: recorded())
    monkeypatch.setitem(sys.modules, "m2dec_tpu_torch.runtime.trace", None)
    monkeypatch.delattr(runtime, "trace")
    assert program_trace.events(tr) is None
    assert all(harness.read_metric(n, tr) is None for n in READERS)


def test_intervals():
    spans = [("a", 5, 9, 1), ("a", 0, 6, 2), ("b", 1, 2, 1),
             ("a", 20, 40, 1)]
    assert program_trace.union(spans, "a", (2, 30)) == [(2, 9), (20, 30)]
    assert program_trace.overlap_ns([(0, 5), (8, 30)],
                                    [(2, 9), (20, 30)]) == 3 + 1 + 10


def test_recorded_spans_read():
    """Spans of the real recorder, in a window with no device operation:
    the whole pack is idle."""
    trace.start()
    try:
        t0 = time.time_ns()
        with trace.span("batch.pack"):
            time.sleep(0.02)
        with trace.span("step"):
            time.sleep(0.01)
        trace.count("upload_bytes", 4096)
        t1 = time.time_ns()
    finally:
        trace.stop()
    tr = T.Trace([], [], (t0, t1), 4, 1, 4, {"codec": "h265"}, {})
    pack = harness.read_metric("pack_ms_per_picture", tr)
    assert 20 / 4 <= pack < (t1 - t0) / MS / 4
    assert harness.read_metric("pack_idle_pct", tr) == pytest.approx(
        100 * 4 * pack * MS / (t1 - t0))
    assert harness.read_metric("upload_bytes_per_picture", tr) == 1024
