"""Exception types of the port."""

from __future__ import annotations


class StreamFeatureExcluded(NotImplementedError):
    """A stream uses a feature that one decode path leaves to another.

    The overlapped Turbo drivers raise it where their native Phase A or
    batched Phase B refuses a stream (H.265 mid-row slice starts or a
    native Phase A refusal, MPEG-2 fast mode); the serial decoder then
    decodes the stream (``runtime/pipeline.py`` replays it on this
    error and on no other)."""
