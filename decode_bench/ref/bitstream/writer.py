"""Bitstream writing.

Used by the test-stream generators (tests/streamgen) and by golden-bitstream
unit fixtures — the TPU-build analog of the reference's `txt2bin` text-pattern
fixtures (reference: src/lib/txt2bin.c:26+, test usage mpeg2.cpp:1736-1795).
The reference has no encoder; streams here exist to exercise the decoder.
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit writer.

    Accumulates into a small integer and flushes completed bytes into a
    bytearray so writing N bits is O(N), not O(N^2).
    """

    def __init__(self) -> None:
        self._out = bytearray()
        self._acc: int = 0  # pending bits, MSB-first
        self._acc_n: int = 0

    def put_bits(self, value: int, n: int) -> "BitWriter":
        if n < 0 or (n and value < 0) or (value >> n):
            raise ValueError(f"put_bits: value {value} does not fit in {n} bits")
        self._acc = (self._acc << n) | value
        self._acc_n += n
        while self._acc_n >= 8:
            self._acc_n -= 8
            self._out.append((self._acc >> self._acc_n) & 0xFF)
        self._acc &= (1 << self._acc_n) - 1
        return self

    def put_bitstring(self, s: str) -> "BitWriter":
        """Write a '0101 1..' pattern string (spaces/underscores ignored)."""
        for ch in s:
            if ch in "01":
                self.put_bits(int(ch), 1)
            elif ch not in " _":
                raise ValueError(f"bad bit char {ch!r}")
        return self

    def ue(self, k: int) -> "BitWriter":
        """Unsigned Exp-Golomb."""
        if k < 0:
            raise ValueError("ue(v) must be >= 0")
        x = k + 1
        n = x.bit_length()
        self.put_bits(0, n - 1)
        return self.put_bits(x, n)

    def se(self, k: int) -> "BitWriter":
        """Signed Exp-Golomb: k>0 -> 2k-1, k<=0 -> -2k."""
        return self.ue(2 * k - 1 if k > 0 else -2 * k)

    def byte_align(self, bit: int = 0) -> "BitWriter":
        while self._acc_n % 8:
            self.put_bits(bit, 1)
        return self

    def rbsp_trailing_bits(self) -> "BitWriter":
        self.put_bits(1, 1)
        return self.byte_align(0)

    @property
    def nbits(self) -> int:
        return len(self._out) * 8 + self._acc_n

    def truncate_to_bits(self, n: int) -> "BitWriter":
        """Discard everything past the first ``n`` bits (n <= nbits)."""
        if n > self.nbits:
            raise ValueError("truncate_to_bits: beyond end")
        nbytes, rem = divmod(n, 8)
        if nbytes < len(self._out):
            acc = self._out[nbytes] >> (8 - rem) if rem else 0
            del self._out[nbytes:]
            self._acc, self._acc_n = acc, rem
        else:
            keep = n - len(self._out) * 8
            self._acc >>= self._acc_n - keep
            self._acc_n = keep
        return self

    def tobytes(self) -> bytes:
        if self._acc_n == 0:
            return bytes(self._out)
        pad = (-self._acc_n) % 8
        tail = (self._acc << pad).to_bytes((self._acc_n + pad) // 8, "big")
        return bytes(self._out) + tail


def escape_nal(payload: bytes) -> bytes:
    """Insert H.264/H.265 `emulation_prevention_three_byte`s.

    Inverse of reader.unescape_nal: any 00 00 0x (x<=3) in the raw RBSP gets
    a 03 inserted after the 00 00.
    """
    out = bytearray()
    zeros = 0
    for b in payload:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)
