"""Shared helpers of the m2dec_tpu_torch tests: seeded numpy inputs that
go through both the JAX package and the port.

Importing this module pins torch to one intra-op thread, so that the
suite's parallel workers do not oversubscribe the cores."""

import numpy as np
import torch

torch.set_num_threads(1)


def rand_wavefront_plan(mb_w, mb_h, seed, wide=False, kinds=None):
    """Random per-MB intra/deblock metadata (int32 numpy) in the shape of
    tests/test_pallas_kernels.py's plans. wide=True also randomises the
    availability bits, adds IPCM MBs and switched-off deblock edges;
    kinds, a sequence of MB kinds, redraws every MB's kind from it (the
    other fields stay those of kinds=None)."""
    n = mb_w * mb_h
    rng = np.random.default_rng(seed)
    P = {
        "kind": rng.integers(0, 5 if wide else 4, n),
        "res_y": rng.integers(-20, 20, (n, 16, 16)),
        "res_c": rng.integers(-20, 20, (n, 2, 8, 8)),
        "i4_modes": rng.integers(0, 9, (n, 16)),
        "i4_avail": (rng.integers(0, 16, (n, 16)) if wide
                     else np.full((n, 16), 7)),
        "i8_modes": rng.integers(0, 9, (n, 4)),
        "i8_avail": (rng.integers(0, 16, (n, 4)) if wide
                     else np.full((n, 4), 15)),
        "i16_mode": rng.integers(0, 4, n),
        "chroma_mode": rng.integers(0, 4, n),
        "mb_avail": rng.integers(0, 4, n) if wide else np.full(n, 3),
        "deb_str": rng.integers(0, 256, (n, 2, 4)),
        "deb_str4": rng.integers(0, 2, (n, 2)),
        "deb_ab": rng.integers(-4 if wide else 20, 40, (n, 2, 6, 2)),
    }
    if kinds is not None:
        P["kind"] = rng.choice(np.asarray(kinds), n)
    return {k: v.astype(np.int32) for k, v in P.items()}


def rand_planes(mb_w, mb_h, seed):
    """Random uint8 (y, cb, cr) raster planes."""
    rng = np.random.default_rng(seed + 1000)
    H, W = mb_h * 16, mb_w * 16
    return (rng.integers(0, 256, (H, W)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8),
            rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8))


def torch_plan(P, device="cpu"):
    """numpy plan dict -> int32 torch tensors on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int32,
                               device=device) for k, v in P.items()}
