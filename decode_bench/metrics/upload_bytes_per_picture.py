"""Bytes that the program copied from the host to the device per
picture (its counter ``upload_bytes``, one count per batch's pinned
copy), over the pictures of the traced window."""

from decode_bench import program_trace


def read(tr):
    ev = program_trace.events(tr)
    if ev is None or not tr.pictures:
        return None
    n = sum(c for name, _, c in ev.counts if name == "upload_bytes")
    return n / tr.pictures if n else None
