"""The H.265 CTU-tile kernel's share of its roofline, in %: the least
time of the window's pictures (the bytes of ``bounds.h265_tile_bytes``
of their intra samples and blocks, which the reference counts, over the
HBM peak) over the kernel's device time."""

from decode_bench import bounds
from decode_bench.drivers.h265 import KERNELS


def read(tr):
    spent = sum((op.end_ns - op.start_ns) / 1e9
                for op in tr.program_kernels()
                if any(k in op.name for k in KERNELS))
    if not spent or "intra_samples" not in tr.counts:
        return None
    least = bounds.h265_tile_bytes(tr.counts["intra_samples"],
                                   tr.counts["intra_blocks"]) \
        / bounds.HBM_BYTES_S
    return 100.0 * least / spent
