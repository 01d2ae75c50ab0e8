"""MPEG Program Stream demuxer.

Host-side front end extracting the video elementary stream from a PS
multiplex, mirroring the reference's pes_demuxer_t semantics
(mpeg_demux.cpp:33-163): pack headers (0xba) skip 8 bytes, 0xb9 ends the
ISO stream, video PES (0xe0) headers are parsed for both MPEG-1 and
MPEG-2 styles, everything else is skipped by its 16-bit length.
"""

from __future__ import annotations


class PsDemuxer:
    """Iterates video ES chunks of a program stream."""

    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.pos = 0

    def _find_start(self):
        i = self.data.find(b"\x00\x00\x01", self.pos)
        if i < 0:
            return -1
        self.pos = i + 3
        return self.data[i + 3] if i + 3 < len(self.data) else -1

    def _get(self, n):
        v = int.from_bytes(self.data[self.pos : self.pos + n], "big")
        self.pos += n
        return v

    def video_packets(self):
        """Yield video PES payload chunks (mpeg_demux_get_video)."""
        while True:
            code = self._find_start()
            if code < 0:
                return
            self.pos += 1
            if code == 0xB9:  # end of iso
                return
            if code == 0xBA:  # pack header (MPEG-1 layout)
                self.pos += 8
                continue
            if code != 0xE0:  # non-video PES / system headers
                ln = self._get(2)
                self.pos += ln
                if ln <= 0:
                    return
                continue
            chunk = self._video_packet()
            if chunk is None:
                return
            if chunk:
                yield chunk

    def _video_packet(self):
        """video_element_packet (mpeg_demux.cpp:72-113)."""
        val = self._get(3)
        packet_tail = self.pos + (val >> 8) - 1
        if (val & 0xC0) == 0x80:  # MPEG-2 PES header
            hl = self._get(2) & 255
            self.pos += hl
        else:  # MPEG-1 PES header
            val &= 255
            while val == 255:
                val = self._get(1)
            if val & 0xC0:
                if val & 0x80:
                    return None
                val = self._get(2) & 255
            if val >= 0x30:
                if val & 0xC0:
                    return None
                self.pos += 9
            elif val & 0x20:
                self.pos += 4
            elif val != 0x0F:
                return None
        head = self.pos
        end = min(packet_tail, len(self.data))
        self.pos = end
        return self.data[head:end]

    def video_stream(self) -> bytes:
        """Concatenated video elementary stream."""
        return b"".join(self.video_packets())
