"""The decoders' output frame descriptor (the JAX package's
``codecs/mpeg2/decoder.DecodedFrame``, copied whole)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DecodedFrame:
    """Output frame descriptor (reference m2d_frame_t, m2d.h:35-42)."""

    y: np.ndarray  # uint8 [H, W] (padded)
    cb: np.ndarray  # uint8 [H/2, W/2]
    cr: np.ndarray  # uint8 [H/2, W/2]
    width: int  # padded width
    height: int  # padded height
    crop: tuple  # (left, right, top, bottom)
    cnt: int = 0  # temporal reference / POC
    raw_stride: int = 0  # FAST_DECODE: 16-aligned internal stride quirk

    def nv12(self):
        """Planar -> NV12 (luma plane + interleaved CbCr), the reference's
        in-memory format (m2d.h:35-42 chroma layout). Downloads
        device-resident planes on demand."""
        cb = np.asarray(self.cb)
        cr = np.asarray(self.cr)
        h2, w2 = cb.shape
        chroma = np.empty((h2, w2 * 2), np.uint8)
        chroma[:, 0::2] = cb
        chroma[:, 1::2] = cr
        return np.asarray(self.y), chroma
