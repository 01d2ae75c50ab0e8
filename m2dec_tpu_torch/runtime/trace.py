"""Host spans and counters of the port, on the clock of ``torch.profiler``.

A span times a stage of the host's work; a counter adds a number (bytes
uploaded). Both are stamped with ``time.time_ns()``, nanoseconds since the
epoch, the clock the profiler stamps its events with, so a span lines up
with the device operations that the host launched inside it::

    from m2dec_tpu_torch.runtime import trace

    with trace.span("batch.pack"):
        ...
    trace.count("upload_bytes", buf.nbytes)

Recording is on between ``start()`` and ``stop()``, and while a
``torch.profiler`` profile records. Otherwise ``span`` returns one shared
no-op object (``NOOP``) and ``count`` returns at once. While a profiler
records, each span also opens a ``torch.profiler.record_function`` range
of its name, so the profile shows each stage's host time beside the
device time of the kernels launched inside it::

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        batcher.run(plans)
    print(prof.key_averages().table(sort_by="cuda_time_total"))
    prof.export_chrome_trace("decode.json")  # chrome://tracing, Perfetto

``events(t0_ns, t1_ns)`` returns what was recorded in a window: spans
``(name, start_ns, end_ns, thread_id)`` and counts ``(name, t_ns, n)``.
The records live in one bounded ring per process; when it is full the
oldest are dropped, and counted.
"""

from __future__ import annotations

import collections
import threading
import time

import torch.autograd.profiler as _profiler

#: records the ring holds
CAPACITY = 1 << 16

Events = collections.namedtuple("Events", "spans counts dropped")

_ring = collections.deque(maxlen=CAPACITY)
_lock = threading.Lock()
_dropped = 0
_on = False


def _append(record) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(record)


class _NoSpan:
    """What ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Span:
    __slots__ = ("name", "t0", "rf")

    def __init__(self, name):
        self.name = name
        self.rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _append((self.name, self.t0, t1, threading.get_ident()))
        return False


def span(name: str):
    """A context manager that records the enclosed work as span
    ``name``."""
    # the profiler's own flag, a module global: the cheapest reliable test
    if _on or _profiler._is_profiler_enabled:
        return _Span(name)
    return NOOP


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``, at the time of the call."""
    if _on or _profiler._is_profiler_enabled:
        _append((name, time.time_ns(), n))


def start() -> None:
    """Record from now on, whether a profiler records or not."""
    global _on
    _on = True


def stop() -> None:
    global _on
    _on = False


def events(t0_ns: int, t1_ns: int) -> Events:
    """The spans that overlap [t0_ns, t1_ns], the counts inside it, and
    how many records the ring has dropped since the process started."""
    with _lock:
        records, dropped = list(_ring), _dropped
    spans = [r for r in records
             if len(r) == 4 and r[1] <= t1_ns and r[2] >= t0_ns]
    counts = [r for r in records if len(r) == 3 and t0_ns <= r[1] <= t1_ns]
    return Events(spans, counts, dropped)
