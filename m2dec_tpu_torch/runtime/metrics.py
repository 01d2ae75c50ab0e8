"""Decode metrics registry (SURVEY §5.5).

The reference's observability is stderr prints + the rdtsc busy/idle
CSV (unithread.h:85-147); this module adds the production counterpart:
per-session counters (frames decoded/output/dropped, pictures errored,
bytes consumed) and rate gauges (decode fps over a sliding window),
exported as a dict / one-line JSON for scraping.  Pure stdlib, no
global state: embed a `Metrics` in a pipeline/decoder driver and call
`snapshot()`.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque


class Metrics:
    """Thread-safe counter/gauge registry with a sliding-window rate."""

    def __init__(self, window_s: float = 5.0):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._window_s = window_s
        self._events: dict[str, deque] = {}
        self._t0 = time.monotonic()

    def inc(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
            dq = self._events.setdefault(name, deque())
            now = time.monotonic()
            dq.append((now, n))
            lo = now - self._window_s
            while dq and dq[0][0] < lo:
                dq.popleft()

    def count(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def rate(self, name: str) -> float:
        """Events/s over the sliding window."""
        with self._lock:
            dq = self._events.get(name)
            if not dq:
                return 0.0
            now = time.monotonic()
            lo = now - self._window_s
            total = sum(n for t, n in dq if t >= lo)
            span = min(self._window_s, now - self._t0) or 1e-9
            return total / span

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counters)
        names = list(out)  # iterate the copy, not the live dict
        out["uptime_s"] = round(time.monotonic() - self._t0, 3)
        for k in names:
            out[f"{k}_per_s"] = round(self.rate(k), 3)
        return out

    def json_line(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)
