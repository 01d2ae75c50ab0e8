"""The share of the traced window's pictures, in %, whose picture step
the program replayed as a CUDA graph (its counter ``graph.replay``, one
count per replayed step) rather than dispatching its ops one by one."""

from decode_bench import program_trace


def read(tr):
    ev = program_trace.events(tr)
    if ev is None or not tr.pictures:
        return None
    n = sum(c for name, _, c in ev.counts if name == "graph.replay")
    return 100.0 * n / tr.pictures if n else None
