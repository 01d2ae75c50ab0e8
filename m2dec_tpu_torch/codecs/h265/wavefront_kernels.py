"""The H.265 CTU-tile intra wavefront as a CUDA kernel, with its plain
version beside it.

The counterpart of ``_wavefront_tile`` in
``m2dec_tpu/codecs/h265/reconstruct.py`` (an XLA ``lax.scan``, not a
Pallas kernel). The kernel lives in ``m2dec_tpu_torch/csrc/h265_tile.cu``
and works in place on the padded int32 planes of ``_LevelRunner``
(luma [H+33, W+33]; cb over cr [2 * _CR0, W/2 + 17]) with the per-CTU
packed z-slot words of ``_ctu_zslots``; the only layout work is here
(dtype, contiguity and shape checks). On a CPU tensor the wrapper runs
the plain version (``reconstruct._wavefront_tile_plain``); on a CUDA
tensor it launches the kernel or raises, never falling back.

One launch per picture runs luma, cb and cr: one CTA of two warps per
(plane, CTU row), taken by ticket, each CTU with an op waiting on a
progress flag of the CTU row above (``_band_progress`` is their zeroed
scratch). A CTA keeps its CTU row's samples, op words and residuals in
shared memory, fetched ahead with ``cp.async`` by one warp while the
other runs the ops; its time follows the longest chain of ops through
that dependency (``op_chain``).

``LAUNCHES`` counts kernel launches, so a run can show it went through
the kernel: a launch captured into a CUDA graph counts once per replay
(``H265SeqPhaseB``), not at the capture.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import _build

#: kernel launches since the last reset
LAUNCHES = {"h265_tile": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t, name, shape, dev):
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or t.device != dev):
        raise ValueError(f"{name}: want int32 {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _band_progress(dev, rows):
    """The kernel's scratch on ``dev``: int32 [3 * rows + 1] zeros, the
    CTUs done per CTU row of luma, cb and cr, then the ticket."""
    return torch.zeros(3 * rows + 1, dtype=torch.int32, device=dev)


@functools.lru_cache(maxsize=1)
def _tile_table_np():
    """The kernel's angular table, packed from ``reconstruct._ANG_FUSED``
    so that it fits in shared memory (26 KB): per (mode - 2, size) row,
    49 int32: the 64 (sel << 8 | pos) of the reference entries and the
    32 (r0 << 8 | c1) of the rows as uint16 pairs (little-endian; pos
    is stored plus one: the main line starts at the corner, -1), then
    fixon | fixidx << 1 | fixpos << 8 | filtk << 16 | transp << 17."""
    from .reconstruct import _ANG_FUSED, _REFCAP

    t = _ANG_FUSED.astype(np.int64)
    rc, b0 = _REFCAP, 2 * _REFCAP + 64
    sel, pos = t[:, :64], t[:, rc:rc + 64]
    r0, c1 = t[:, 2 * rc:2 * rc + 32], t[:, 2 * rc + 32:2 * rc + 64]
    scal = t[:, b0:b0 + 5]
    pos = pos + 1
    fits = [(sel <= 2).all(), (pos < 256).all(), (r0 < 256).all(),
            (c1 < 256).all(), (scal[:, [0, 3, 4]] <= 1).all(),
            (scal[:, 1] < 128).all(), (scal[:, 2] < 256).all()]
    if not all(fits) or min(sel.min(), pos.min(), r0.min(), c1.min(),
                            scal.min()) < 0:
        raise ValueError("the angular table does not pack")
    pairs = np.concatenate([(sel << 8) | pos, (r0 << 8) | c1], 1)
    words = pairs.astype("<u2").view("<i4")
    last = (scal[:, 0] | scal[:, 1] << 1 | scal[:, 2] << 8
            | scal[:, 3] << 16 | scal[:, 4] << 17)
    return np.ascontiguousarray(
        np.concatenate([words, last[:, None].astype(np.int32)], 1))


@functools.lru_cache(maxsize=8)
def _tile_table(dev):
    """The packed angular table on ``dev``, int32 [132, 49]."""
    return torch.from_numpy(_tile_table_np()).to(dev)


def op_chain(words, cols, rows):
    """The longest chain of ops of one plane's tile schedule: CTU (cy, cx)
    runs its ops after CTU cx - 1 of its band and CTU cx + 1 (the last
    CTU at the right edge) of the band above, so the chain is the most
    ops on any path through that dependency. words: the plane's z-slot
    words [n_ctu, n_slots] (a tensor or numpy; host work)."""
    w = words.cpu().numpy() if torch.is_tensor(words) else np.asarray(words)
    n = ((w & 1) != 0).sum(1).reshape(rows, cols)
    done = np.zeros(cols, np.int64)  # the chain to each CTU of a band
    for cy in range(rows):
        up = np.append(done[1:], done[-1])  # CTU cx + 1 of the band above
        left = 0
        for cx in range(cols):
            left = done[cx] = n[cy, cx] + max(left, up[cx])
    return int(done.max())


def tile_wavefront(y, cbcr, res_y, res_cbcr, zl, zc, H, W, ctb_log2,
                   strong_en):
    """The intra wavefront of one picture on the CTU-tile schedule, in
    place on the padded planes y [H+33, W+33] and cbcr (cb over cr), with
    residuals of the same shapes and the z-slot words zl [n_ctu, SL], zc
    [n_ctu, SC]; returns (y, cbcr). H, W: the CTB-aligned picture size.
    CPU: the plain version; CUDA: the kernel, one launch.

    A word's op size must not exceed its slot's largest block (Smax of
    ``_zslot_table``), as ``_ctu_zslots`` guarantees. The words are not
    read on the host to check it (that would cost a synchronisation per
    picture); on a larger op the kernel and the plain version differ."""
    from . import reconstruct as R

    if y.device.type == "cpu":
        return R._wavefront_tile_plain(y, cbcr, res_y, res_cbcr, zl, zc,
                                       H, W, ctb_log2, strong_en)
    lib = _build.load_library("h265_tile")
    dev = y.device
    if dev.type != "cuda":
        raise RuntimeError(f"the tile kernel needs CUDA tensors, got {dev}")
    cols, rows = W >> ctb_log2, H >> ctb_log2
    if (not 3 <= ctb_log2 <= 6
            or (cols << ctb_log2, rows << ctb_log2) != (W, H)):
        raise ValueError(f"{W}x{H} is not a whole number of CTBs of "
                         f"{1 << ctb_log2}")
    Hc, Wc = H >> 1, W >> 1
    n_ctu = cols * rows
    for t, name, shape in (
            (y, "y", (H + 33, W + 33)), (res_y, "res_y", (H + 33, W + 33)),
            (cbcr, "cbcr", (2 * R._CR0(Hc), Wc + 17)),
            (res_cbcr, "res_cbcr", (2 * R._CR0(Hc), Wc + 17)),
            (zl, "zl", (n_ctu, 1 << (2 * (ctb_log2 - 2)))),
            (zc, "zc", (n_ctu, 1 << (2 * (ctb_log2 - 3))))):
        _check(t, name, shape, dev)
    ang = _tile_table(dev)
    progress = _band_progress(dev, rows)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.h265_tile_wavefront(
            y.data_ptr(), cbcr.data_ptr(), res_y.data_ptr(),
            res_cbcr.data_ptr(), zl.data_ptr(), zc.data_ptr(),
            ang.data_ptr(), progress.data_ptr(), H, W, ctb_log2,
            int(bool(strong_en)), stream)
    if err != 0:
        raise RuntimeError(f"h265_tile_wavefront: CUDA launch failed with "
                           f"error {err}")
    # a launch recorded into a CUDA graph is counted at each replay
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["h265_tile"] += 1
    return y, cbcr
