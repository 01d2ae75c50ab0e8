"""What a traced run hands the per-layer metric readers, and the
reductions of the device trace that every reader shares.

The device operations come from ``torch.profiler`` (CUDA activity), the
host spans from the harness's own clock around each call it makes, in
the same nanoseconds since the epoch as the profiler's, so each device
operation is tied to the span in which the host launched it.
"""

from __future__ import annotations

import bisect
import dataclasses

#: activity types of the profiler's device operations
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's own spans (not the program's work)
HARNESS_SPANS = ("digest",)


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "gpu_memcpy" or "gpu_memset"
    start_ns: int
    end_ns: int
    span: str | None  # the host span that launched it, if any


@dataclasses.dataclass
class Trace:
    ops: list  # DeviceOp, inside the window
    spans: list  # (name, start_ns, end_ns) of the host
    window: tuple  # (start_ns, end_ns)
    pictures: int  # pictures completed in the window
    streams: int
    batch: int  # pictures per stream and batch
    config: dict
    counts: dict  # the reference's counts (reference.STATS) summed over
    #               the window's pictures

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def program_kernels(self):
        """Kernels that the program launched (not the harness's)."""
        return [op for op in self.ops
                if op.kind == "kernel" and op.span not in HARNESS_SPANS]

    def span_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of
        their intervals, so overlapping operations count once."""
        busy, end = 0, None
        for s, e in sorted((op.start_ns, op.end_ns) for op in self.ops):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def idle_gaps(self):
        """[(start_ns, end_ns)] of the window in which no device
        operation ran."""
        gaps, t = [], self.window[0]
        for s, e in sorted((op.start_ns, op.end_ns) for op in self.ops):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def host_at(self, t_ns: int) -> str:
        """What the host was doing at t_ns, by the harness's spans."""
        for n, s, e in self.spans:
            if s <= t_ns < e:
                return n
        return "between calls"


def _kind(e) -> str:
    """A profiler event's activity: one of DEVICE_KINDS, "launch" (the
    host's CUDA runtime or driver call) or "other"."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return "launch" if kind in ("cuda_runtime", "cuda_driver") else kind
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "launch" if name.startswith("cu") else "other"


def from_profiler(prof, spans, window) -> list:
    """The device operations of a stopped ``torch.profiler.profile``
    that ran inside ``window``, each tied to its launching span."""
    events = prof.profiler.kineto_results.events()
    kinds = [_kind(e) for e in events]
    launched = {}
    for e, kind in zip(events, kinds):
        if kind == "launch":
            launched[e.correlation_id()] = e.start_ns()
    spans = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in spans]

    def span_of(t):
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t < spans[i][2]:
            return spans[i][0]
        return None

    ops = []
    w0, w1 = window
    for e, kind in zip(events, kinds):
        if kind not in DEVICE_KINDS:
            continue
        s, d = e.start_ns(), e.duration_ns()
        if s + d <= w0 or s >= w1:
            continue
        ops.append(DeviceOp(e.name(), kind, max(s, w0), min(s + d, w1),
                            span_of(launched.get(e.correlation_id()))))
    return ops


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time (by name) and the
    ten longest idle gaps, each named by what the host was doing."""
    by_name = {}
    for op in tr.ops:
        by_name[op.name] = by_name.get(op.name, 0) + op.end_ns - op.start_ns
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, ns / 1e9] for n, ns in top],
            "idle_gaps": [[f"{tr.host_at((s + e) // 2)} at "
                           f"{(s - tr.window[0]) / 1e9:.3f} s", (e - s) / 1e9]
                          for s, e in gaps]}
