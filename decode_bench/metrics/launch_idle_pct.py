"""The share of the traced window, in %, in which no operation ran on
the device while the host was inside one of the program's picture steps
(its spans ``step``)."""

from decode_bench import program_trace


def read(tr):
    return program_trace.idle_pct_inside(tr, "step")
