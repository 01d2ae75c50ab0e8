"""H.265: the program's native Phase A, then its batch entry,
``H265SeqPhaseB.run_async`` (one stream), which stacks the batch's plans
on the host (``stack_plans``), copies them in one pinned transfer and
reconstructs the pictures: residual, MC, the intra wavefront as the
CTU-tile kernel, deblocking and SAO."""

from __future__ import annotations

from m2dec_tpu_torch.codecs.h265.headers import H265Decoder
from m2dec_tpu_torch.codecs.h265.reconstruct import H265SeqPhaseB

SPAN = "h265.run"
#: the CTU-tile kernel of csrc/h265_tile.cu
KERNELS = ("tile_kernel",)


def phase_a(data: bytes, device):
    """The program's native Phase A of one stream: (plans in decode
    order, (H, W, pool size))."""
    dec = H265Decoder(device=device)
    dec.set_data(data)
    dec.begin_decode(backend="native", defer_recon=True)
    while dec.decode_picture() == 1:
        pass
    plans = dec.plans
    return plans, (plans[0].H, plans[0].W, len(dec.pool))


class Driver:
    def __init__(self, config: dict, traffic: dict, device):
        if traffic["streams"] != 1:
            raise ValueError("the H.265 batch entry takes one stream")
        self.n_streams = 1
        self.device = device
        self.batcher = None
        self.plans = []

    def setup(self, datas: list) -> None:
        runs = [phase_a(d, self.device) for d in datas]
        geoms = {g for _, g in runs}
        if len(geoms) != 1:
            raise RuntimeError(f"the GOPs differ in geometry: {geoms}")
        self.plans = [p for p, _ in runs]
        self.batcher = H265SeqPhaseB(*geoms.pop(), device=self.device)

    def dispatch(self, calls: list) -> list:
        """One call: pictures [lo, hi) of distinct GOP g, (g, lo, hi) =
        calls[0]; returns [(y, cb, cr)] uint8 device stacks."""
        (g, lo, hi), = calls
        return [self.batcher.run_async(self.plans[g][lo:hi])]

    def close(self) -> None:
        self.batcher = None
        self.plans = []
