"""The port's recorder of host spans and counters
(``m2dec_tpu_torch.runtime.trace``) and the spans of its batch entries,
on the CPU: an H.264 ``MultiStreamPhaseB`` batch of 2 streams at 48x32
and an H.265 ``H265SeqPhaseB`` batch at 64x48 record nothing while
recording is off and decode the same pictures when it is on; on, under
``trace.start()`` and under a CPU ``torch.profiler``, every span appears
nested as the stages nest, on the ``time.time_ns()`` clock; the ring
drops its oldest records and counts them; the Pipeline's stage timers
record their spans on the same clock."""

import pathlib
import sys
import threading
import time

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).parent))

from streamgen.h264_enc import H264BGen  # noqa: E402
from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402
from streamgen.mpeg2_enc import Mpeg2StreamGen  # noqa: E402

from m2dec_tpu_torch import native  # noqa: E402
from m2dec_tpu_torch.codecs.h264 import reconstruct as R264  # noqa: E402
from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder  # noqa: E402
from m2dec_tpu_torch.codecs.h264.plan_host import dev_pool_size  # noqa: E402
from m2dec_tpu_torch.codecs.h265 import reconstruct as R265  # noqa: E402
from m2dec_tpu_torch.codecs.h265.headers import H265Decoder  # noqa: E402
from m2dec_tpu_torch.runtime import trace  # noqa: E402
from m2dec_tpu_torch.runtime.pipeline import Pipeline  # noqa: E402

#: the spans of one batch on the calling thread: name -> its parent
H264_MAIN = {"batch.pack": None, "batch.upload": None,
             "batch.unpack": None, "step": None, "step.mc": "step",
             "step.passes": "step", "step.store": "step"}
H265_MAIN = {"batch.pack": None, "batch.upload": None,
             "batch.unpack": None, "step": None, "step.residual": "step",
             "step.mc": "step", "step.intra": "step",
             "step.deblock": "step", "step.sao": "step",
             "step.store": "step"}


def _h264_phase_a(data):
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    return dec.plans, (dec.max_x, dec.max_y,
                       dev_pool_size(dec.sps.num_ref_frames,
                                     len(dec.frames)))


@pytest.fixture(scope="module")
def h264():
    """Two 48x32 streams of the benchmark's H.264 recipe, their plans
    from the native Phase A, recorded under ``trace.start()``."""
    datas = [H264BGen(48, 32, seed=s, num_ref_frames=2, b_direct_prob=0.3,
                      skip_prob=0.35, intra_prob=0.08, qp=30,
                      disable_deblock=False).generate("IPBPBP")
             for s in (3, 4)]
    t0 = time.time_ns()
    trace.start()
    try:
        runs = [_h264_phase_a(d) for d in datas]
    finally:
        trace.stop()
    slices = [s for s in trace.events(t0, time.time_ns()).spans
              if s[0] == "phase_a.slice"]
    return [p for p, _ in runs], runs[0][1], len(slices)


@pytest.fixture(scope="module")
def h265():
    """A 64x48 stream of the benchmark's H.265 recipe, its plans from
    the native Phase A."""
    data = H265StreamGen(64, 48, seed=5, qp=32, cbf_prob=0.4,
                         modes=ALL_MODES, tmvp=1, deblock=1, sao=1,
                         max_level=1).generate("IPBP")
    dec = H265Decoder(device="cpu")
    dec.set_data(data)
    dec.begin_decode(backend="native", defer_recon=True)
    t0 = time.time_ns()
    trace.start()
    try:
        while dec.decode_picture() == 1:
            pass
    finally:
        trace.stop()
    slices = [s for s in trace.events(t0, time.time_ns()).spans
              if s[0] == "phase_a.slice"]
    plans = dec.plans
    return plans, (plans[0].H, plans[0].W, len(dec.pool)), len(slices)


def _run_h264(h264, monkeypatch, n):
    plans, geom, _ = h264
    plans = [p[:n] for p in plans]
    uploaded = []
    upload = R264.MultiStreamPhaseB._upload

    def keep(self, buf):
        uploaded.append(buf.nbytes)
        return upload(self, buf)

    monkeypatch.setattr(R264.MultiStreamPhaseB, "_upload", keep)
    outs = R264.MultiStreamPhaseB(2, *geom, device="cpu").run(plans)
    return outs, uploaded


def _run_h265(h265, monkeypatch, n):
    plans, geom, _ = h265
    plans = plans[:n]
    uploaded = []
    upload = R265._upload

    def keep(fields, device):
        views = upload(fields, device)
        uploaded.append(next(iter(views.values()))
                        .untyped_storage().nbytes())
        return views

    monkeypatch.setattr(R265, "_upload", keep)
    outs = [R265.H265SeqPhaseB(*geom, device="cpu").run_async(plans)]
    return outs, uploaded


RUNS = {"h264": (_run_h264, H264_MAIN), "h265": (_run_h265, H265_MAIN)}


def _recorded(run, stream, monkeypatch, on, n):
    """(outputs, bytes uploaded, Events, thread id, window) of one batch
    of the first ``n`` pictures with recording ``on``: "start"
    (``trace.start()``), "profiler" (a CPU torch.profiler) or "off"."""
    t0 = time.time_ns()
    if on == "start":
        trace.start()
        try:
            outs, up = run(stream, monkeypatch, n)
        finally:
            trace.stop()
    elif on == "profiler":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            outs, up = run(stream, monkeypatch, n)
        # each span is also a record_function range of the profile
        ranges = {e.name() for e in prof.profiler.kineto_results.events()}
        assert {"batch.pack", "batch.upload", "step", "step.mc"} <= ranges
    else:
        outs, up = run(stream, monkeypatch, n)
    t1 = time.time_ns()
    return outs, up, trace.events(t0, t1), threading.get_ident(), (t0, t1)


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


#: pictures a batch: the whole stream, and under the profiler (which
#: records every torch op of the plain CPU kernels) its first two, I, P
PICTURES = {"start": None, "profiler": 2}


@pytest.mark.parametrize("on", ["start", "profiler"])
@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_spans_of_a_batch(codec, on, h264, h265, monkeypatch):
    run, want = RUNS[codec]
    stream = h264 if codec == "h264" else h265
    n = PICTURES[on]
    base, _, ev, _, _ = _recorded(run, stream, monkeypatch, "off", n)
    assert ev.spans == [] and ev.counts == []
    outs, up, ev, me, (t0, t1) = _recorded(run, stream, monkeypatch, on, n)
    for a, b in zip(outs, base):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    main = [s for s in ev.spans if s[3] == me]
    assert {s[0] for s in main} == set(want)
    assert all(t0 <= s[1] <= s[2] <= t1 for s in ev.spans)
    pictures = stream[0][0] if codec == "h264" else stream[0]
    assert len([s for s in main if s[0] == "step"]) == \
        len(pictures[:n])
    for s in main:
        parent = want[s[0]]
        if parent is not None:
            assert any(_inside(s, p) for p in main if p[0] == parent)
    assert ev.counts and all(c[0] == "upload_bytes" for c in ev.counts)
    assert [c[2] for c in ev.counts] == up
    if codec == "h264":
        pack = next(s for s in main if s[0] == "batch.pack")
        for name in ("pack.measure", "pack.fill"):
            per_stream = [s for s in ev.spans if s[0] == name]
            assert len(per_stream) == 2
            assert all(_inside(s, pack) for s in per_stream)


def test_phase_a_slices(h264, h265):
    assert h264[2] == 2 * len(h264[0][0])
    assert h265[2] == len(h265[0])


def test_setup_build_span(monkeypatch):
    monkeypatch.setattr(native, "_LIBS", {})
    t0 = time.time_ns()
    trace.start()
    try:
        native.load_h264()
    finally:
        trace.stop()
    ev = trace.events(t0, time.time_ns())
    assert [s[0] for s in ev.spans] == ["setup.build"]


def test_ring_drops_oldest():
    t0 = time.time_ns()
    before = len(trace.events(0, 2 ** 63).spans + trace.events(
        0, 2 ** 63).counts)
    dropped = trace.events(0, 0).dropped
    extra = 10
    trace.start()
    try:
        for i in range(trace.CAPACITY + extra):
            trace.count("ring", i)
    finally:
        trace.stop()
    ev = trace.events(t0, time.time_ns())
    assert [c[2] for c in ev.counts] == list(range(extra, trace.CAPACITY
                                                   + extra))
    assert ev.dropped - dropped == before + extra


def test_off_is_one_shared_object():
    assert trace.span("a") is trace.span("b") is trace.NOOP
    with trace.span("a"):
        trace.count("c", 1)


def test_pipeline_stage_spans():
    es = Mpeg2StreamGen(64, 48, seed=3).generate("IPP")
    p = Pipeline(es, device="cpu")
    t0 = time.time_ns()
    trace.start()
    try:
        p.run(lambda f: None)
    finally:
        trace.stop()
    t1 = time.time_ns()
    spans = [s for s in trace.events(t0, t1).spans
             if s[0].startswith("pipeline.")]
    rows = [r.split(",") for r in p.timeline_csv().strip().splitlines()]
    assert sorted(f"pipeline.{n}" for n, _, _ in rows) == \
        sorted(s[0] for s in spans)
    assert all(t0 <= int(a) <= int(b) <= t1 for _, a, b in rows)
