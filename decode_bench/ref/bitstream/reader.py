"""Bitstream reading.

Host-side Phase-A bit reader with the semantics of the reference's cached
`dec_bits` reader (reference: src/lib/bitio.h:40-54, src/lib/bitio.c) —
MSB-first reads, `show`/`get`/`skip`, byte alignment, Exp-Golomb — redesigned
for the two-phase TPU decoder:

* Instead of a pluggable per-refill byte loader with `00 00 03`
  emulation-prevention stripping (reference: src/lib/m2d.cpp:90-126,
  `m2d_load_bytes_skip03`), whole NAL payloads are unescaped up-front with a
  vectorized numpy pass (`unescape_nal`), so entropy engines always read from
  clean contiguous memory.
* Instead of a refill callback + `longjmp` error channel (reference:
  src/lib/bitio.c:112-128, 283-301), exhaustion raises
  `BitstreamExhausted`; the per-picture error containment lives in the
  decoder drivers (m2dec_tpu/runtime/errors.py).

The Python implementation reads from an `int` constructed once per buffer —
bulk `int.from_bytes` is C-speed, and bit extraction is shift/mask on the
big int. This is the correctness-reference engine; the production fast path
is the native C++ Phase-A library (m2dec_tpu/native).
"""

from __future__ import annotations

import numpy as np


class BitstreamError(Exception):
    """Invalid bitstream syntax."""


class BitstreamExhausted(BitstreamError):
    """Read past the end of the buffer (reference: dec_bits_tell_error)."""


def unescape_nal(data: bytes | memoryview | np.ndarray) -> bytes:
    """Strip H.264/H.265 emulation-prevention bytes from a NAL payload.

    Removes every 0x03 that follows a 0x00 0x00 pair (reference semantics:
    src/lib/m2d.cpp:90-126). Vectorized: one pass over numpy arrays instead
    of the reference's per-refill stateful loader.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size < 3:
        return buf.tobytes()
    # mark positions i>=2 where buf[i]==3 and buf[i-1]==0 and buf[i-2]==0
    is3 = buf[2:] == 3
    z1 = buf[1:-1] == 0
    z2 = buf[:-2] == 0
    drop = np.zeros(buf.size, dtype=bool)
    cand = is3 & z1 & z2
    # Consecutive escape handling: "00 00 03 00 00 03" — after removing the
    # first 03, the following 00 00 03 still matches on the raw buffer since
    # the removed byte cannot itself be part of a later 00 00 prefix (it's 03).
    drop[2:] = cand
    return buf[~drop].tobytes()


class BitReader:
    """MSB-first bit reader over a byte buffer.

    API parity with the reference reader (src/lib/bitio.h:57-75):
    `get_bits`/`show_bits`/`skip_bits`/`get_onebit`/`byte_align`/`skip_bytes`,
    plus Exp-Golomb `ue`/`se` (reference: src/lib/m2d.h:92-128).
    """

    # The benchmark's copy reads each field from a window of the bytes
    # (the JAX package's shifts one integer of the whole buffer, which
    # is quadratic in a slice's size) and finds the stop bit once; what
    # every method returns is unchanged.
    __slots__ = ("_last_one", "_nbits", "_pos", "data")

    def __init__(self, data: bytes | memoryview | np.ndarray):
        data = bytes(data)
        self.data = data
        self._nbits = 8 * len(data)
        self._pos = 0  # bits consumed so far
        #: bit index of the buffer's final '1' (-1: none)
        tail = data.rstrip(b"\0")
        self._last_one = (8 * len(tail) - (tail[-1] & -tail[-1]).bit_length()
                          if tail else -1)

    # -- positions ---------------------------------------------------------
    @property
    def bitpos(self) -> int:
        return self._pos

    @property
    def bytepos(self) -> int:
        """Bytes fully or partially consumed (reference: dec_bits_current)."""
        return (self._pos + 7) // 8

    def bits_remaining(self) -> int:
        return self._nbits - self._pos

    # -- core reads --------------------------------------------------------
    def show_bits(self, n: int) -> int:
        if self._pos + n > self._nbits:
            raise BitstreamExhausted(f"show_bits({n}) at bit {self._pos}/{self._nbits}")
        first = self._pos >> 3
        span = ((self._pos & 7) + n + 7) >> 3
        window = int.from_bytes(self.data[first:first + span], "big")
        return (window >> (8 * span - (self._pos & 7) - n)) & ((1 << n) - 1)

    def get_bits(self, n: int) -> int:
        v = self.show_bits(n)
        self._pos += n
        return v

    def skip_bits(self, n: int) -> None:
        if self._pos + n > self._nbits:
            raise BitstreamExhausted(f"skip_bits({n}) at bit {self._pos}/{self._nbits}")
        self._pos += n

    def get_onebit(self) -> int:
        return self.get_bits(1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def is_byte_aligned(self) -> bool:
        return (self._pos & 7) == 0

    def skip_bytes(self, n: int) -> None:
        """Byte-align then skip n bytes (reference: bitio.c:223-241)."""
        self.byte_align()
        self.skip_bits(8 * n)

    # -- Exp-Golomb (reference: m2d.h:92-128) ------------------------------
    def ue(self) -> int:
        """ue(v): unsigned Exp-Golomb."""
        lead = 0
        while self.get_bits(1) == 0:
            lead += 1
            if lead > 32:
                raise BitstreamError("ue(v) leading-zero run > 32")
        if lead == 0:
            return 0
        return (1 << lead) - 1 + self.get_bits(lead)

    def se(self) -> int:
        """se(v): signed Exp-Golomb. k -> (-1)^(k+1) * ceil(k/2)."""
        k = self.ue()
        return (k + 1) >> 1 if (k & 1) else -(k >> 1)

    # -- helpers -----------------------------------------------------------
    def more_rbsp_data(self) -> bool:
        """True if RBSP data remains before the rbsp_stop_one_bit."""
        # The rbsp_stop_one_bit is the FINAL '1' in the stream; data
        # remains iff the next bit to read lies strictly before it.
        return self._pos < self._last_one

    def rbsp_trailing_bits(self) -> None:
        if self.get_bits(1) != 1:
            raise BitstreamError("rbsp_stop_one_bit != 1")
        self.byte_align()


def find_start_codes(data: bytes | np.ndarray) -> np.ndarray:
    """Return byte offsets of every `00 00 01` start-code prefix.

    Vectorized replacement for the reference's incremental scanner
    (src/lib/m2d.cpp:59-88 `m2d_next_start_code`, :130-155
    `m2d_find_mpeg_data`): the whole buffer is scanned once with numpy and
    downstream code iterates over the offset table.
    Offsets point at the first 0x00 of the prefix.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    if buf.size < 3:
        return np.zeros(0, dtype=np.int64)
    # include a prefix at the very end of the buffer (its NAL is empty
    # and dropped, but the previous NAL must not absorb the 00 00 01)
    hit = (buf[:-2] == 0) & (buf[1:-1] == 0) & (buf[2:] == 1)
    return np.flatnonzero(hit).astype(np.int64)
