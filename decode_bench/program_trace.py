"""The program's own spans and counters in a traced window, for the
readers of the per-layer metrics that look inside the batch entry.

The program records them with ``m2dec_tpu_torch.runtime.trace`` while
the harness's profiler records, on the profiler's clock, so they lie on
the same time line as ``trace.Trace``'s device operations and idle gaps.
A program without that recorder gives nothing, and the readers None.
"""

from __future__ import annotations


def events(tr):
    """The program's ``Events`` (spans, counts, dropped) in the window of
    ``tr``, or None when it recorded no span there."""
    try:
        from m2dec_tpu_torch.runtime import trace
    except ImportError:
        return None
    ev = trace.events(*tr.window)
    return ev if ev.spans else None


def union(spans, name: str, window) -> list:
    """The time inside spans called ``name``, clipped to the window, as
    sorted disjoint [(start_ns, end_ns)]."""
    w0, w1 = window
    out = []
    for s, e in sorted((max(s, w0), min(e, w1))
                       for n, s, e, _ in spans if n == name):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def length_ns(intervals) -> int:
    return sum(e - s for s, e in intervals)


def overlap_ns(a, b) -> int:
    """Nanoseconds that lie in both of two sorted lists of disjoint
    intervals."""
    i = j = t = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            t += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return t


def host_ms_per_picture(tr, name: str):
    """Host milliseconds inside spans ``name`` per picture of the
    window, or None without such a span."""
    ev = events(tr)
    if ev is None or not tr.pictures:
        return None
    ns = length_ns(union(ev.spans, name, tr.window))
    return ns / 1e6 / tr.pictures if ns else None


def idle_pct_inside(tr, name: str):
    """The share of the window, in %, in which no device operation ran
    while the host was inside a span ``name``; None without such a
    span."""
    ev = events(tr)
    if ev is None or not tr.window_s:
        return None
    inside = union(ev.spans, name, tr.window)
    if not inside:
        return None
    return 100.0 * overlap_ns(tr.idle_gaps(), inside) / 1e9 / tr.window_s
