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


def rand_tile_inputs(H, W, ctb_log2, seed, density=0.6, sl2_max=5,
                     modes=None, stray=0.3):
    """Random inputs of the H.265 tile wavefront at a CTB-aligned H x W:
    the padded int32 planes and residuals of ``_LevelRunner`` (luma
    [H+33, W+33], cb over cr) and per-CTU z-slot words (zl, zc) as numpy.

    Every op fits its slot (size <= Smax), and its valid counts stay
    inside what the schedule has reconstructed when it runs: vy ends at
    the CTU's bottom row, and an op on the CTU's top row has vx ending
    in the CTU above-right. So any order the schedule allows gives one
    result. A slot holds an op with probability ``density``, of size up
    to 1 << sl2_max, its mode drawn from ``modes`` (default: all 35);
    luma ops carry the DC stray-pixel bit with probability ``stray``
    (where the pixel stays inside the picture)."""
    from m2dec_tpu_torch.codecs.h265 import reconstruct as R

    rng = np.random.default_rng(seed)
    cols, rows = W >> ctb_log2, H >> ctb_log2
    Hc, Wc = H >> 1, W >> 1
    planes = []
    for h, w in ((H + 33, W + 33), (2 * R._CR0(Hc), Wc + 17)):
        planes.append(rng.integers(0, 256, (h, w)).astype(np.int32))
        planes.append(rng.integers(-40, 40, (h, w)).astype(np.int32))
    words = []
    for luma, cl2 in ((True, ctb_log2), (False, ctb_log2 - 1)):
        C = 1 << cl2
        slots = R._zslot_table(cl2)
        z = np.zeros((cols * rows, len(slots)), np.int32)
        for ctu in range(cols * rows):
            for j, (oy, ox, smax) in enumerate(slots):
                if rng.random() > density:
                    continue
                sl2 = int(rng.integers(2, min(smax.bit_length(),
                                              sl2_max + 1)))
                size = 1 << sl2
                mode = int(rng.integers(0, 35) if modes is None
                           else rng.choice(modes))
                vx_cap = 2 * C - ox if oy == 0 else 127
                vx = int(rng.integers(0, min(vx_cap, 2 * size + 4) + 1))
                if rng.random() < 0.2:
                    vx = min(vx_cap, 127)
                vy = int(rng.integers(0, min(C - oy, 2 * size) + 1))
                y0 = (ctu // cols) * C + oy
                dc1 = (luma and rng.random() < stray
                       and y0 + size < (H if luma else Hc))
                z[ctu, j] = (1 | (2 * dc1) | ((sl2 - 2) << R._ZF_SL2)
                             | (mode << R._ZF_MODE) | (vx << R._ZF_VX)
                             | (vy << R._ZF_VY))
        words.append(z)
    y, ry, c, rc = planes
    return y, c, ry, rc, words[0], words[1]
