"""Host milliseconds per picture inside the program's picture steps (its
spans ``step``: the dispatch of each step's torch ops and kernels), over
the pictures of the traced window."""

from decode_bench import program_trace


def read(tr):
    return program_trace.host_ms_per_picture(tr, "step")
