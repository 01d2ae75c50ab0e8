"""The share of the traced window, in %, in which no operation ran on
the device while the host was inside the program's host pack of a batch
(its span ``batch.pack``)."""

from decode_bench import program_trace


def read(tr):
    return program_trace.idle_pct_inside(tr, "batch.pack")
