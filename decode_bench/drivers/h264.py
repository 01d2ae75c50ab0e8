"""H.264: the program's native Phase A, then its batch entry,
``MultiStreamPhaseB.run`` for S streams (``BatchedPhaseB.run_async`` for
one), which packs every stream's plans on the host, copies them to the
device in one pinned transfer and reconstructs the pictures with the
four wavefront kernels."""

from __future__ import annotations

from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder
from m2dec_tpu_torch.codecs.h264.plan_host import dev_pool_size
from m2dec_tpu_torch.codecs.h264.reconstruct import (BatchedPhaseB,
                                                     MultiStreamPhaseB)

#: the span around each call of the batch entry
SPAN = "h264.run"
#: the program's wavefront kernels (their CUDA names start so)
KERNELS = ("intra_luma_kernel", "intra_chroma_kernel",
           "deblock_luma_kernel", "deblock_chroma_kernel")


def phase_a(data: bytes):
    """The program's native Phase A of one stream: (plans in decode
    order, (mb_w, mb_h, device pool size))."""
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    return dec.plans, (dec.max_x, dec.max_y,
                       dev_pool_size(dec.sps.num_ref_frames,
                                     len(dec.frames)))


class Driver:
    def __init__(self, config: dict, traffic: dict, device):
        self.n_streams = traffic["streams"]
        self.device = device
        self.batcher = None
        self.plans = []

    def setup(self, datas: list) -> None:
        runs = [phase_a(d) for d in datas]
        geoms = {g for _, g in runs}
        if len(geoms) != 1:
            raise RuntimeError(f"the GOPs differ in geometry: {geoms}")
        self.plans = [p for p, _ in runs]
        geom = geoms.pop()
        self.batcher = (BatchedPhaseB(*geom, device=self.device)
                        if self.n_streams == 1 else
                        MultiStreamPhaseB(self.n_streams, *geom,
                                          device=self.device))

    def dispatch(self, calls: list) -> list:
        """One call of the batch entry: stream s decodes pictures [lo,
        hi) of distinct GOP g, (g, lo, hi) = calls[s]. Returns per
        stream its (y, cb, cr) uint8 device stacks [hi - lo, H, W] in
        decode order, not yet synchronised."""
        plans = [self.plans[g][lo:hi] for g, lo, hi in calls]
        if self.n_streams == 1:
            return [self.batcher.run_async(plans[0])]
        return self.batcher.run(plans)

    def close(self) -> None:
        self.batcher = None
        self.plans = []
