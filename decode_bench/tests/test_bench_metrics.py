"""Every per-layer metric reader and the trace reductions on a
synthetic trace whose answers are known."""

import json

import pytest

from decode_bench import bounds, cache, harness
from decode_bench import trace as T

MS = 1_000_000  # ns


def synthetic(codec: str) -> T.Trace:
    """A 100 ms window: two batches of 4 pictures, each a 30 ms call of
    the batch entry then a wait; kernels of 10 ms from each call, one
    digest kernel, one copy."""
    entry = f"{codec}.run"
    spans = [(entry, 0, 30 * MS), ("digest", 30 * MS, 31 * MS),
             ("wait", 31 * MS, 50 * MS), (entry, 50 * MS, 80 * MS),
             ("digest", 80 * MS, 81 * MS), ("wait", 81 * MS, 100 * MS)]
    kern = "intra_luma_kernel(IntraLumaArgs)" if codec == "h264" \
        else "tile_kernel(TileArgs)"
    ops = [T.DeviceOp("gemm", "kernel", 5 * MS, 15 * MS, entry),
           T.DeviceOp(kern, "kernel", 12 * MS, 22 * MS, entry),
           T.DeviceOp("Memcpy HtoD", "gpu_memcpy", 40 * MS, 45 * MS, entry),
           T.DeviceOp("reduce", "kernel", 44 * MS, 46 * MS, "digest"),
           T.DeviceOp(kern, "kernel", 60 * MS, 70 * MS, entry)]
    cfg = {"codec": codec, "width": 64, "height": 48}
    counts = {"intra_samples": 1000, "intra_blocks": 10} \
        if codec == "h265" else {"intra_mbs": 5}
    return T.Trace(ops, spans, (0, 100 * MS), 8, 2, 2, cfg, counts)


def test_reductions():
    tr = synthetic("h264")
    assert tr.busy_s() == pytest.approx(0.017 + 0.006 + 0.010)
    assert tr.idle_gaps()[0] == (0, 5 * MS)
    assert tr.host_at(90 * MS) == "wait"
    b = T.breakdown(tr)
    assert b["device_ops"][0] == ["intra_luma_kernel(IntraLumaArgs)", 0.02]
    assert len(b["idle_gaps"]) <= 10 and b["idle_gaps"][0][1] == 0.03


def _read(name, tr):
    return harness.read_metric(name, tr)


def test_readers():
    h4, h5 = synthetic("h264"), synthetic("h265")
    assert _read("h264.host_ms_per_picture", h4) == pytest.approx(7.5)
    assert _read("h264.host_ms_per_picture", h5) is None
    assert _read("h265.host_ms_per_picture", h5) == pytest.approx(7.5)
    assert _read("kernels_per_picture", h4) == pytest.approx(3 / 8)
    assert _read("device_idle_pct", h4) == pytest.approx(67.0)
    # 8 pictures of 3 x 4 macroblocks, 5 of them intra
    least = bounds.h264_intra_bytes("intra_luma_kernel", 5, 96) \
        / bounds.HBM_BYTES_S
    assert least == pytest.approx((5 * 805 + 96) / bounds.HBM_BYTES_S)
    assert _read("h264.wavefront_roofline", h4) == pytest.approx(
        100 * least / 0.02)
    # a deblocking pass counts its planes at each launch
    h4.ops.append(T.DeviceOp("deblock_luma_kernel(DeblockLumaArgs)",
                             "kernel", 90 * MS, 95 * MS, "h264.run"))
    least += bounds.h264_deblock_bytes("deblock_luma_kernel", 2, 48, 64) \
        / bounds.HBM_BYTES_S
    assert _read("h264.wavefront_roofline", h4) == pytest.approx(
        100 * least / 0.025)
    assert _read("h264.wavefront_roofline", h5) is None
    assert _read("h265.tile_roofline", h5) == pytest.approx(
        100 * bounds.h265_tile_bytes(1000, 10) / bounds.HBM_BYTES_S / 0.02)
    assert _read("h265.tile_roofline", h4) is None


def test_end_to_end_readers():
    w = harness.Window(2.0, 96, 12.5, [0.0, 1.0], [0.9, 2.0])
    assert _read("frames_per_s", w) == 48.0
    assert _read("setup_s", w) == 12.5


def test_schedule():
    sched = harness.Schedule({"streams": 3, "distinct_gops": 2}, 12)
    assert sched.warm == 2 and sched(2) == [(0, 0, 12), (1, 0, 12),
                                            (0, 0, 12)]
    part = harness.Schedule({"streams": 2, "distinct_gops": 2,
                             "pictures_per_call": 4}, 12)
    assert part.warm == 6 and part(6) == [(0, 0, 4), (1, 0, 4)]
    assert part(8) == [(0, 8, 12), (1, 8, 12)] and part(9)[0] == (1, 0, 4)
    with pytest.raises(ValueError):
        harness.Schedule({"streams": 1, "distinct_gops": 1,
                          "pictures_per_call": 5}, 12)


def test_every_manifest_metric_has_a_reader():
    with open(cache.ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    for m in manifest["per_layer"]:
        for codec in ("h264", "h265"):
            v = _read(m["name"], synthetic(codec))
            assert v is None or v > 0
