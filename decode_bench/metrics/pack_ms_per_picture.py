"""Host milliseconds per picture inside the program's host pack of a
batch (its span ``batch.pack``: H.264 ``MultiStreamPhaseB._host_batch``,
H.265 ``stack_plans``), over the pictures of the traced window."""

from decode_bench import program_trace


def read(tr):
    return program_trace.host_ms_per_picture(tr, "batch.pack")
