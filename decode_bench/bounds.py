"""The yardstick's peaks and byte counts.

NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet: 3.35 TB/s of HBM
bandwidth. A kernel's least time is the bytes its work must move over
that rate: each input byte read once and each output byte written once.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12

#: each H.264 deblocking pass reads the planes it filters and writes
#: them back: the luma pass one [S, H, W] plane, the chroma pass two
#: [S, H/2, W/2] planes, so 2 S H W bytes (luma) or S H W bytes (chroma)
#: a launch. The per-macroblock syntax they also read is left out, so
#: this is a lower count.
_H264_DEBLOCK_SHARE = {"deblock_luma_kernel": 2.0,
                       "deblock_chroma_kernel": 1.0}

#: the H.264 intra passes write only the intra-predicted macroblocks. Of
#: each such macroblock they must write its samples (luma 256, chroma
#: 2 x 64), read each sample's residual (2 bytes) and read its
#: neighbours: the line above with the corner and, for luma, the four
#: samples above right (21 luma, 2 x 9 chroma) and the column left (16,
#: 2 x 8). Of every macroblock they must read at least a byte saying
#: whether it is intra. Modes and the rest of the syntax are left out,
#: so this is a lower count.
_H264_INTRA_MB_BYTES = {"intra_luma_kernel": 3 * 256 + 21 + 16,
                        "intra_chroma_kernel": 3 * 128 + 18 + 16}
H264_DEBLOCK_KERNELS = tuple(_H264_DEBLOCK_SHARE)


def h264_deblock_bytes(kernel: str, streams: int, height: int,
                       width: int) -> float:
    """Bytes one launch of H.264 deblocking pass ``kernel`` must move
    for ``streams`` stacked streams of ``height`` x ``width`` pictures."""
    return _H264_DEBLOCK_SHARE[kernel] * streams * height * width


def h264_intra_bytes(kernel: str, intra_mbs: int, mbs: int) -> float:
    """Bytes H.264 intra pass ``kernel`` must move over pictures that
    hold ``mbs`` macroblocks, ``intra_mbs`` of them intra-predicted
    (I_NxN and I_16x16; I_PCM is not the pass's work)."""
    return _H264_INTRA_MB_BYTES[kernel] * intra_mbs + mbs


def h265_tile_bytes(intra_samples: int, cus: int) -> float:
    """Bytes one launch of the H.265 tile kernel must move for a picture
    with ``intra_samples`` intra-predicted samples (luma and chroma)
    in ``cus`` intra transform blocks: each sample's residual read (2
    bytes) and the sample written (1 byte), and one 4-byte word naming
    each block's size, position and mode."""
    return 3.0 * intra_samples + 4.0 * cus
