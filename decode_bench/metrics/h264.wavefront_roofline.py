"""The four H.264 wavefront kernels' share of their roofline, in %: the
sum of their least times (bytes over the HBM peak) over the sum of their
device times. The deblocking passes' bytes are whole planes a launch
(``bounds.h264_deblock_bytes``); the intra passes' are those of the
window's intra macroblocks, which the reference counts
(``bounds.h264_intra_bytes``)."""

from decode_bench import bounds
from decode_bench.drivers.h264 import KERNELS


def read(tr):
    if "intra_mbs" not in tr.counts:
        return None
    h, w = tr.config["height"], tr.config["width"]
    least = spent = 0.0
    intra = set()
    for op in tr.program_kernels():
        k = next((k for k in KERNELS if k in op.name), None)
        if k is None:
            continue
        spent += (op.end_ns - op.start_ns) / 1e9
        if k in bounds.H264_DEBLOCK_KERNELS:
            least += bounds.h264_deblock_bytes(k, tr.streams, h, w) \
                / bounds.HBM_BYTES_S
        else:
            intra.add(k)
    mbs = tr.pictures * (h // 16) * (w // 16)
    for k in intra:
        least += bounds.h264_intra_bytes(k, tr.counts["intra_mbs"], mbs) \
            / bounds.HBM_BYTES_S
    return 100.0 * least / spent if spent else None
