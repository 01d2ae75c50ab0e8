"""Frame-skip scan (reference M2Decoder::skip_frames, m2decoder.h:96-131).

The reference CLI's ``-f <n>`` walks start codes counting H.264 frame
heads, remembers the last IDR within the first n+1 heads, and collects
SPS/PPS spans seen on the way for replay.

**Replicated reference behavior (a bug chain worth documenting):** after
the scan, the reference replays the collected headers through
``decode_picture`` with a null sentinel terminating the list
(m2decoder.h:121-124).  The sentinel's refill returns -1, but
``endofbuffer_check`` (bitio.c:111-128) only longjmps when the bit cache
is *empty*; with bits still cached, decode continues and the next refill
falls through to ``reread_file_impl``'s file branch (h264dec.cpp:67-84)
which feeds the whole file from position 0.  Net effect: ``-f`` prints
"Skip N frames(M bytes)." and then decodes the entire stream from the
beginning — the skip offset is computed but never used.  The CLI here
reproduces exactly that: same stderr line, full decode.
"""

from __future__ import annotations

START = b"\x00\x00\x01"


def next_start_code(data: bytes, pos: int) -> int:
    """m2d_next_start_code (m2d.cpp:59-88): number of bytes consumed
    from `pos` through (and including) the next 00 00 01, or -1."""
    i = data.find(START, pos)
    if i < 0:
        return -1
    return i + 3 - pos


def h264_skip_scan(data: bytes, skip_frm: int):
    """Scan for the skip target (m2decoder.h:96-131).

    Returns ``(skipped_frames, skipped_bytes, header_spans)`` where
    header_spans are (start, end) byte ranges of SPS/PPS NALs (start-code
    included, reaching through the following start code like the
    reference's ``m2d_next_start_code`` size).  When no IDR is found the
    reference returns -1 and leaves skipped_bytes uninitialized (it then
    prints whatever is on the stack — in practice 0); we return (-1, 0).
    """
    n = len(data)
    pos = 0
    skipped = 0
    skipped_key = 0
    key_off = None
    headers: list[tuple[int, int]] = []
    while pos < n:
        step = next_start_code(data, pos)
        if step < 0:
            break
        pos += step
        if pos + 1 >= n:
            # is_h264frame_head needs >= 2 bytes (m2decoder.h:214-217)
            continue
        nal = data[pos] & 31
        if (data[pos + 1] & 0x80) and nal in (1, 5):
            # frame head: first_mb_in_slice==0 (leading ue bit set)
            if nal == 5:
                key_off = pos - 3
                skipped_key = skipped
            skipped += 1
            if skip_frm < skipped:
                break
        elif nal in (7, 8):
            size = next_start_code(data, pos)
            headers.append((pos - 3, pos + size if size >= 0 else n))
    if key_off is None:
        return -1, 0, headers
    return skipped_key, key_off, headers
