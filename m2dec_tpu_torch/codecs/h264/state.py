"""The state carried across to the device: constant tables and the
reference-frame pool.

Phase B has no weights. What it carries is the constant tables of the
JAX package (intra mode matrices and index tables, the quarter-pel
plane table, the deblocking alpha/beta/tc0 tables) and the pool of
reconstructed reference frames. Both are built here from the port's
copies of the JAX package's numpy constants (``plan_host``,
``tables``) and its host frames, so the two packages compute from
identical state.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import plan_host as host
from . import tables


def tables_to_torch(device) -> dict:
    """All constant tables as tensors on ``device``.

    i4_mat / i8_mat: (M f32 [n_line, 9*P], rnd i32, shift i32) — the
    plain mode evaluation; i4_tab / i8_tab: int32 [4, 9, P] stacks of
    the (IA, IB, IC, K3) fir index tables the kernels evaluate in
    integer arithmetic; hp_tab int32 [16, 6]; alpha / beta int32 [52];
    tc0 int32 [3, 52]."""
    dev = torch.device(device)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def mat(m):
        return (t(m[0], torch.float32), t(m[1]), t(m[2]))

    def tab(tb):
        return t(np.stack([np.asarray(a, np.int32) for a in tb]))

    T = tables
    return {
        "i4_mat": mat(host._I4_MAT),
        "i8_mat": mat(host._I8_MAT),
        "i4_tab": tab(host._I4_TAB).contiguous(),
        "i8_tab": tab(host._I8_TAB).contiguous(),
        "hp_tab": t(host._HP_TAB),
        "alpha": t(T.DEBLOCK_ALPHA),
        "beta": t(T.DEBLOCK_BETA),
        "tc0": t(T.DEBLOCK_TC0).contiguous(),
    }


@functools.lru_cache(maxsize=8)
def _cached_tables(device: torch.device) -> dict:
    return tables_to_torch(device)


def device_tables(device) -> dict:
    """tables_to_torch, built once per device (a few KB)."""
    return _cached_tables(torch.device(device))


def pool_from_frames(frames, slots, device):
    """Host ``Frame`` list -> (y [R,H,W], cb, cr [R,H/2,W/2]) uint8
    stacks on ``device``; row i holds frames[slots[i]]."""
    dev = torch.device(device)

    def stack(plane):
        a = np.stack([getattr(frames[s], plane) for s in slots])
        return torch.from_numpy(a).to(dev)

    return stack("y"), stack("cb"), stack("cr")
