"""2-process torch.distributed (gloo) worker of the port's multi-device
decode (m2dec_tpu_torch.parallel.mesh), run by
tests/test_torch_distributed.py:

    python torch_worker.py RANK PORT STREAM.264

Each process is one rank of a 2-rank group on the CPU and holds one
shard. The exchange step: shard 1's picture predicts (zero MVs) from
shard 0's handoff page, which crosses the process boundary; shard 0 gets
zeros. The band step: the stream's first two pictures in 2 MB-row bands,
one per process, with the halo rows crossing the boundary, against the
port's numpy plan interpreter on the whole picture. Imports no jax and
nothing of the JAX package. Prints "proc RANK OK" at the end.
"""

import os
import sys

import numpy as np

rank, port, stream = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from m2dec_tpu_torch.codecs.h264.decoder import (  # noqa: E402
    Frame,
    H264Decoder,
)
from m2dec_tpu_torch.codecs.h264.plan import PicturePlan  # noqa: E402
from m2dec_tpu_torch.codecs.h264.plan_host import _PLAN_KEYS  # noqa: E402
from m2dec_tpu_torch.codecs.h264.recon_ref import (  # noqa: E402
    reconstruct_plan_np,
)
from m2dec_tpu_torch.parallel import mesh as M  # noqa: E402

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=2, rank=rank)
mesh = M.make_mesh(device="cpu")
assert (mesh.size, mesh.shards) == (2, [rank])

# -- the exchange step: 2 GOP shards, one picture each --------------------
n_shards, pool_size, mb_w, mb_h = 2, 2, 2, 2
H, W = mb_h * 16, mb_w * 16
rng = np.random.default_rng(11)  # the same pools on both processes
pools = (rng.integers(0, 256, (n_shards, pool_size, H, W)),
         rng.integers(0, 256, (n_shards, pool_size, H // 2, W // 2)),
         rng.integers(0, 256, (n_shards, pool_size, H // 2, W // 2)))
pools = tuple(p.astype(np.uint8) for p in pools)
p = PicturePlan(mb_w, mb_h)
p.kind[:] = 0
p.slot[:, :, 0] = pool_size  # the cross-process page
p.wp[:, :, :, 0] = 1
stacked = {k: np.stack([getattr(p, k)] * n_shards)[:, None]
           for k in _PLAN_KEYS}
cur_idx = np.ones((n_shards, 1), np.int32)
step = M.h264_gop_xchg_step(mesh, mb_w, mb_h, pool_size, handoff_slot=0,
                            has_i8=False, deblock=False)
pool, outs = step(*pools, stacked, cur_idx)
assert outs[0].shape == (1, 1, H, W)
want = pools[0][0, 0] if rank == 1 else np.zeros((H, W), np.uint8)
assert np.array_equal(outs[0][0, 0].numpy(), want), "cross-process page"
every = M.gather(mesh, outs)
assert np.array_equal(every[0][1, 0].numpy(), pools[0][0, 0])
assert np.array_equal(pool[0][0, 1].numpy(), outs[0][0, 0].numpy())

# -- the band step: two pictures in 2 bands ------------------------------
dec = H264Decoder(record_plans=True)
with open(stream, "rb") as f:
    dec.set_data(f.read())
shadow = step = None
for npic in range(2):
    assert dec.decode_picture() == 1
    plan = dec.plans[-1]
    if shadow is None:
        h, w = dec.frames[0].y.shape
        shadow = [Frame(w, h) for _ in dec.frames]
        step = M.h264_tile_step(mesh, plan.mb_w, plan.mb_h)
    refs = [np.stack([getattr(f, k) for f in shadow])
            for k in ("y", "cb", "cr")]
    band = step(M.h264_tile_plan(plan, 2), *refs)
    whole = M.gather(mesh, band)
    reconstruct_plan_np(plan, shadow)
    f = shadow[plan.cur_idx]
    for got, full, want in zip(band, whole, (f.y, f.cb, f.cr)):
        assert np.array_equal(full.numpy(), want), f"picture {npic}"
        rows = want.shape[0] // 2
        assert np.array_equal(got.numpy(),
                              want[rank * rows:(rank + 1) * rows])

assert not any(m.split(".")[0] in ("jax", "m2dec_tpu") for m in sys.modules)
dist.destroy_process_group()
print(f"proc {rank} OK", flush=True)
