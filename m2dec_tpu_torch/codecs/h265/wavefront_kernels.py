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

One launch per picture runs luma, cb and cr: one CTA per (plane, CTU
row) at a time, taken by ticket, each CTU waiting on a progress flag of
the CTU row above (``_band_progress`` is their zeroed scratch).

``LAUNCHES`` counts kernel launches, so a run can show it went through
the kernel.
"""

from __future__ import annotations

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


def tile_wavefront(y, cbcr, res_y, res_cbcr, zl, zc, H, W, ctb_log2,
                   strong_en):
    """The intra wavefront of one picture on the CTU-tile schedule, in
    place on the padded planes y [H+33, W+33] and cbcr (cb over cr), with
    residuals of the same shapes and the z-slot words zl [n_ctu, SL], zc
    [n_ctu, SC]; returns (y, cbcr). H, W: the CTB-aligned picture size.
    CPU: the plain version; CUDA: the kernel, one launch."""
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
    ang = R._device_tables(dev)["ang32"]
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
    LAUNCHES["h265_tile"] += 1
    return y, cbcr
