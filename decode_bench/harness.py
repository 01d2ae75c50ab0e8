"""One run of one cell: streams from the seed, the program's Phase A and
warm-up, a measured window of whole batches, then the check against the
plain reference and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names its configuration (``decode_bench/configs/<config>.json``) and its
traffic (``decode_bench/traffic/<traffic>.json``); the configuration's
``codec`` names the driver (``decode_bench/drivers/<codec>.py``); each
per-layer metric is read by ``decode_bench/metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
import time

from decode_bench import cache, digest, reference, streams
from decode_bench import trace as T

HERE = cache.HERE
ROOT = cache.ROOT
#: top-level module names that no run may hold once its window closed
BANNED_MODULES = ("jax", "jaxlib", "flax", "m2dec_tpu")
#: the longest window a traced run measures: reading the trace of an
#: H.265 window takes nearly three times the window (1.5 million kernels
#: in 51 s), and the run, with a new seed's reference after it, has to
#: end within its time limit
TRACED_SECONDS = 20.0


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file, with its "name"
    traffic: dict
    end_to_end: list  # manifest entries
    per_layer: list  # manifest entries of metrics that this cell reports


def load_cell(name: str, manifest_path=None) -> Cell:
    with open(manifest_path or ROOT / "BENCHMARK.json") as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    config["name"] = w["config"]
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name, w["chips"], config, traffic,
                [m for m in manifest["end_to_end"] if here(m)],
                [m for m in manifest["per_layer"] if here(m)])


def read_metric(name: str, source):
    """The value of metric ``name`` by its reader
    (``decode_bench/metrics/<name>.py``), or None: an end-to-end metric
    reads the ``Window``, a per-layer metric the ``trace.Trace``."""
    spec = importlib.util.spec_from_file_location(
        f"decode_bench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(source)


@contextlib.contextmanager
def span(spans: list, name: str):
    """Append (name, start, end) of the enclosed host work to spans, in
    the profiler's clock (ns since the epoch)."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        spans.append((name, t0, time.time_ns()))


class Schedule:
    """Which pictures call k of the batch entry decodes: per stream
    (distinct GOP, first picture, end). The traffic's
    ``pictures_per_call`` (default: a whole GOP) divides the GOP into
    parts; stream s decodes GOP (s + r) mod ``distinct_gops`` in round r.
    Calls 0 .. ``warm`` - 1 cover every distinct call once (the
    warm-up); the window starts at round ``distinct_gops``, part 0."""

    def __init__(self, traffic: dict, gop_len: int):
        self.streams = traffic["streams"]
        self.gops = traffic["distinct_gops"]
        self.size = traffic.get("pictures_per_call", gop_len)
        if gop_len % self.size:
            raise ValueError(f"{self.size} pictures a call do not divide "
                             f"a GOP of {gop_len}")
        self.parts = gop_len // self.size
        self.warm = self.gops * self.parts

    def __call__(self, k: int) -> list:
        r, j = divmod(k, self.parts)
        lo = j * self.size
        return [((s + r) % self.gops, lo, lo + self.size)
                for s in range(self.streams)]


@dataclasses.dataclass
class Window:
    """What the end-to-end metric readers read (host clock)."""
    seconds: float  # from the first call's start to the last one's end
    pictures: int  # pictures the window's calls wrote
    setup_s: float
    dispatched: list  # each call's start, s after the window's start
    completed: list  # each call's completion on the device, likewise


def check(got: list, ref: list, sched: Schedule):
    """The comparison that decides ``correct``. ``got``: per call k of
    the batch entry (k, per stream the int64 [pictures, 3] digests of
    its outputs); ``ref``: per distinct GOP the reference's rows
    (``reference.make``). Returns ({name: [value, limit]}, correct, the
    mismatched pictures of the window's calls)."""
    compared = mismatched = window_mismatched = 0
    for k, per_stream in got:
        for d, (g, lo, hi) in zip(per_stream, sched(k)):
            want = ref[g][lo:hi, :3]
            if d.shape == want.shape:
                bad = int((d != want).any(1).sum())
                compared += d.shape[0]
            else:  # pictures missing or extra: all of them wrong
                bad = hi - lo
            mismatched += bad
            if k >= sched.warm:
                window_mismatched += bad
    expected = len(got) * sched.streams * sched.size
    checks = {"mismatched_pictures": [mismatched, 0],
              "unchecked_pictures": [expected - compared, 0]}
    correct = all(v <= lim for v, lim in checks.values()) and compared > 0
    return checks, correct, window_mismatched


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t0: float, log=print) -> dict:
    """One run; returns the result (without ``device``'s name, which the
    caller adds). ``device``: a torch device, the card in a benchmark
    run and the CPU in the harness's own tests."""
    import torch

    cuda = device.type == "cuda"
    if traced:
        seconds = min(seconds, TRACED_SECONDS)
    if cell.traffic["loop"] != "closed":
        raise ValueError(f"traffic loop {cell.traffic['loop']!r}: only "
                         f"a closed loop is driven")
    drv_mod = importlib.import_module(
        f"decode_bench.drivers.{cell.config['codec']}")
    drv = drv_mod.Driver(cell.config, cell.traffic, device)
    sched = Schedule(cell.traffic, len(cell.config["gop"]))
    t = time.perf_counter()
    datas = streams.make(cell.config, seed, sched.gops)
    streams_s = time.perf_counter() - t
    drv.setup(datas)
    dd = digest.DeviceDigest(device)
    side = torch.cuda.Stream(device) if cuda else None
    spans = []

    def digests(outs):
        """Per stream int64 [pictures, 3] of a call's outputs, on a side
        stream after the call (the outputs are kept until it has read
        them)."""
        if not cuda:
            return [torch.stack([dd.planes(p) for p in o], 1) for o in outs]
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            got = [torch.stack([dd.planes(p) for p in o], 1) for o in outs]
        for o in outs:
            for p in o:
                p.record_stream(side)
        return got

    def event():
        if not cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # warm-up: every distinct call once
    warm = [(k, digests(drv.dispatch(sched(k)))) for k in range(sched.warm)]
    sync()
    setup_s = time.perf_counter() - t0 - streams_s

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    calls, in_flight, dispatched, done = [], collections.deque(), [], []
    w0_ns = time.time_ns()
    w0 = time.perf_counter()
    ev0 = event()
    k = sched.warm
    while True:
        dispatched.append(time.perf_counter() - w0)
        with span(spans, drv_mod.SPAN):
            outs = drv.dispatch(sched(k))
        ev = event()
        done.append(ev if cuda else time.perf_counter() - w0)
        with span(spans, "digest"):
            calls.append((k, digests(outs)))
        del outs
        in_flight.append(ev)
        if cuda and len(in_flight) > cell.traffic["ahead"]:
            with span(spans, "wait"):
                in_flight.popleft().synchronize()
        k += 1
        if time.perf_counter() - w0 >= seconds:
            break
    with span(spans, "wait"):
        sync()
    w1 = time.perf_counter()
    w1_ns = time.time_ns()
    if prof is not None:
        prof.stop()
    completed = [ev0.elapsed_time(e) / 1e3 for e in done] if cuda else done
    pictures = len(calls) * sched.streams * sched.size
    window = Window(w1 - w0, pictures, setup_s, dispatched, completed)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    got = [(k, [d.cpu().numpy() for d in ds]) for k, ds in warm + calls]
    drv.close()
    del warm, calls
    if cuda:
        torch.cuda.empty_cache()

    # the check: every picture of every call against the reference
    t = time.perf_counter()
    ref = reference.make(cell.config, seed, datas)
    ref_s = time.perf_counter() - t
    checks, correct, window_mismatched = check(got, ref, sched)
    log(f"window {window.seconds:.3f} s, {len(got) - sched.warm} calls, "
        f"{pictures} pictures; streams {streams_s:.1f} s; reference "
        f"{ref_s:.1f} s", file=sys.stderr)
    log("calls completed at (s): " + " ".join(f"{c:.3f}" for c in completed),
        file=sys.stderr)

    result = {"correct": correct, "attempted": pictures,
              "failed": window_mismatched, "metrics": {}, "device": {
                  "count": cell.chips, "memory_peak_bytes": memory_peak}}
    if traced:
        ops = T.from_profiler(prof, spans, (w0_ns, w1_ns))
        names = reference.STATS[cell.config["codec"]]
        counts = {n: sum(int(ref[g][lo:hi, 3 + i].sum())
                         for k, _ in got if k >= sched.warm
                         for g, lo, hi in sched(k))
                  for i, n in enumerate(names)}
        tr = T.Trace(ops, spans, (w0_ns, w1_ns), pictures,
                     sched.streams, sched.size, cell.config, counts)
        metrics, source = cell.per_layer, tr
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = T.breakdown(tr)
    else:
        metrics, source = cell.end_to_end, window
    for m in metrics:
        v = read_metric(m["name"], source)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    for n, (v, lim) in checks.items():
        log(f"check {n} {v} limit {lim}", file=sys.stderr)
    return result


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(BANNED_MODULES))


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(prog="decode_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t0)
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        **result["device"]}
    found = banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0
