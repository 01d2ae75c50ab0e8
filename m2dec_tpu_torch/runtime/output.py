"""Frame output formats: cropped raw NV12 and per-frame MD5 text.

Byte-compatible with the reference's FileWriterRaw / FileWriterMd5
(reference: src/app/filewrite.h:7-125): crop applied from the padded frame,
luma rows then interleaved-CbCr rows; MD5 output is 32 lowercase hex chars
followed by CRLF per frame. These are the golden-output formats the
conformance harness compares (reference test.sh:1-3).
"""

from __future__ import annotations

import hashlib

import numpy as np


def cropped_nv12_bytes(frame) -> bytes:
    """Apply crop and serialize as the reference's write_cropping does
    (filewrite.h:11-28): luma rows, then NV12 chroma rows.

    FAST_DECODE-mode frames set `raw_stride`: the reference decodes into a
    16-aligned-stride buffer but reports width = mb_w*2 and the writer
    walks it at stride==width (filewrite.h:15), so the output is the first
    width*height bytes of the strided buffer — pad columns leak through as
    zeros. Replicated here when raw_stride > width."""
    stride = getattr(frame, "raw_stride", 0)
    if stride and stride != frame.width:
        y, chroma = frame.nv12()
        h, w = frame.height, frame.width
        ybuf = np.zeros((h, stride), np.uint8)
        ybuf[:, :w] = y
        cbuf = np.zeros((h >> 1, stride), np.uint8)
        cbuf[:, : chroma.shape[1]] = chroma
        return (ybuf.reshape(-1)[: w * h].tobytes()
                + cbuf.reshape(-1)[: w * h >> 1].tobytes())
    left, right, top, bottom = frame.crop
    y, chroma = frame.nv12()
    height = frame.height - top - bottom
    width = frame.width - left - right
    parts = [np.ascontiguousarray(y[top : top + height, left : left + width])]
    ctop = top >> 1
    parts.append(
        np.ascontiguousarray(chroma[ctop : ctop + (height >> 1), left : left + width])
    )
    return b"".join(p.tobytes() for p in parts)


def frame_md5_line(frame) -> bytes:
    """One frame's golden line: 32 hex + CR LF (filewrite.h:98-103)."""
    digest = hashlib.md5(cropped_nv12_bytes(frame)).hexdigest()
    return digest.encode() + b"\r\n"
