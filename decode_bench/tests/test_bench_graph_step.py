"""The reader of ``h265.graph_step_pct`` on the synthetic trace of
``test_bench_metrics`` with recorded counters whose answer is known, and
on a program that records no ``graph.replay``."""

import pytest

from decode_bench import harness
from decode_bench.tests.test_bench_metrics import synthetic
from m2dec_tpu_torch.runtime import trace

MS = 1_000_000  # ns


def test_graph_step_pct(monkeypatch):
    """Six of the window's 8 pictures replayed as a graph (a capture
    counts for nothing), and none without the counter."""
    tr = synthetic("h265")
    spans = [("step", 14 * MS, 20 * MS, 1)]
    counts = [("graph.capture", 15 * MS, 1)] + [
        ("graph.replay", (20 + k) * MS, 1) for k in range(6)]
    monkeypatch.setattr(trace, "events",
                        lambda t0, t1: trace.Events(spans, counts, 0))
    assert harness.read_metric("h265.graph_step_pct", tr) \
        == pytest.approx(75.0)
    monkeypatch.setattr(trace, "events",
                        lambda t0, t1: trace.Events(spans, counts[:1], 0))
    assert harness.read_metric("h265.graph_step_pct", tr) is None
