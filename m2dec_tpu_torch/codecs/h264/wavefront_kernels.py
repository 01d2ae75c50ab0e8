"""The intra and deblocking wavefronts as CUDA kernels, with their plain
versions beside them.

The counterpart of ``m2dec_tpu/codecs/h264/pallas_wavefront.py``. The
four kernels live in ``m2dec_tpu_torch/csrc/h264_wavefront.cu`` and
work in place on raster uint8 planes with per-MB int32 metadata; the
only layout work is here (dtype, contiguity and shape checks). Each
wrapper runs its plain PyTorch version (``wavefront.py``) only for
tensors that lie on the CPU; for CUDA tensors it launches the kernel or
raises, never falling back.

All four kernels run a pass in ONE launch: one CTA per MB row at a
time, rows taken by ticket, each MB waiting on a per-row progress flag
for the MBs of the row above that it reads (``_row_progress`` is their
zeroed scratch). The planes must start on a 4-byte boundary: the kernels
move samples in 4-byte words.

``LAUNCHES`` counts kernel launches per kernel (1 per pass), so a run
can show it went through them.
"""

from __future__ import annotations

import torch

from ... import _build
from . import wavefront as WF
from .state import device_tables

#: kernel launches since the last reset, per kernel
LAUNCHES = {"intra_luma": 0, "intra_chroma": 0, "deblock_luma": 0,
            "deblock_chroma": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _plane(t, shape, name):
    if t.dtype != torch.uint8 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want uint8 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 4:
        raise ValueError(f"{name} must start on a 4-byte boundary")
    return t.data_ptr()


def _meta(P, key, n, dev, tail=()):
    t = P[key]
    if (t.dtype != torch.int32 or tuple(t.shape) != (n,) + tail
            or t.device != dev):
        raise ValueError(f"plan field {key}: want int32 {(n,) + tail} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def _check_device(plane):
    """The kernels' device. Builds the kernel library first, so that a
    missing source or compiler raises before anything else."""
    _build.load_library("h264_wavefront")
    if plane.device.type != "cuda":
        raise RuntimeError(
            f"wavefront kernels need CUDA tensors, got {plane.device}")
    return plane.device


def _row_progress(dev, mb_h):
    """The row kernels' scratch on ``dev``'s current stream: int32
    [mb_h + 1] zeros, the MBs done per row, then the row ticket."""
    return torch.zeros(mb_h + 1, dtype=torch.int32, device=dev)


def _launch(name, dev, mb_w, mb_h, *args):
    """Launch one pass on ``dev``'s current stream and count it; raises
    on a CUDA error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = getattr(_build.load_library("h264_wavefront"), "h264_" + name)
        err = fn(*args, mb_w, mb_h, stream)
    if err != 0:
        raise RuntimeError(f"h264_{name}: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES[name] += 1


def intra_luma(y, P, has_i8, mb_w, mb_h):
    """Intra luma pass on a raster uint8 [H,W] plane. CPU: plain
    version (returns a new plane); CUDA: the kernel, in place."""
    if y.device.type == "cpu":
        return WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
    dev = _check_device(y)
    n, tabs = mb_w * mb_h, device_tables(dev)
    meta = [_meta(P, k, n, dev, tail) for k, tail in (
        ("kind", ()), ("res_y", (16, 16)), ("i4_modes", (16,)),
        ("i4_avail", (16,)), ("i8_modes", (4,)), ("i8_avail", (4,)),
        ("i16_mode", ()), ("mb_avail", ()))]
    progress = _row_progress(dev, mb_h)
    _launch("intra_luma", dev, mb_w, mb_h,
            _plane(y, (mb_h * 16, mb_w * 16), "y"),
            *(t.data_ptr() for t in meta), tabs["i4_tab"].data_ptr(),
            tabs["i8_tab"].data_ptr(), progress.data_ptr(),
            int(bool(has_i8)))
    return y


def intra_chroma(cb, cr, P, mb_w, mb_h):
    """Intra chroma pass on raster uint8 [H/2,W/2] planes."""
    if cb.device.type == "cpu":
        return WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)
    dev = _check_device(cb)
    n, shape = mb_w * mb_h, (mb_h * 8, mb_w * 8)
    meta = [_meta(P, k, n, dev, tail) for k, tail in (
        ("kind", ()), ("res_c", (2, 8, 8)), ("chroma_mode", ()),
        ("mb_avail", ()))] + [_row_progress(dev, mb_h)]
    _launch("intra_chroma", dev, mb_w, mb_h,
            _plane(cb, shape, "cb"), _plane(cr, shape, "cr"),
            *(t.data_ptr() for t in meta))
    return cb, cr


def _deb_args(P, n, dev):
    """The deblock metadata and tables, as tensors that the caller
    keeps alive across the launch."""
    tabs = device_tables(dev)
    return ([_meta(P, k, n, dev, tail) for k, tail in (
        ("deb_str", (2, 4)), ("deb_str4", (2,)), ("deb_ab", (2, 6, 2)))]
        + [tabs[k] for k in ("alpha", "beta", "tc0")])


def deblock_luma(y, P, mb_w, mb_h):
    """Deblocking luma pass on a raster uint8 [H,W] plane."""
    if y.device.type == "cpu":
        return WF.deblock_luma_plain(y, P, mb_w, mb_h)
    dev = _check_device(y)
    args = _deb_args(P, mb_w * mb_h, dev) + [_row_progress(dev, mb_h)]
    _launch("deblock_luma", dev, mb_w, mb_h,
            _plane(y, (mb_h * 16, mb_w * 16), "y"),
            *(t.data_ptr() for t in args))
    return y


def deblock_chroma(cb, cr, P, mb_w, mb_h):
    """Deblocking chroma pass on raster uint8 [H/2,W/2] planes."""
    if cb.device.type == "cpu":
        return WF.deblock_chroma_plain(cb, cr, P, mb_w, mb_h)
    dev = _check_device(cb)
    shape = (mb_h * 8, mb_w * 8)
    args = _deb_args(P, mb_w * mb_h, dev) + [_row_progress(dev, mb_h)]
    _launch("deblock_chroma", dev, mb_w, mb_h,
            _plane(cb, shape, "cb"), _plane(cr, shape, "cr"),
            *(t.data_ptr() for t in args))
    return cb, cr


def run_wavefronts(y, cb, cr, P, has_i8, deblock, mb_w, mb_h):
    """Intra + deblocking wavefronts on raster uint8 planes y [H,W],
    cb/cr [H/2,W/2] with per-MB int32 plan tensors P (including res_y
    [n,16,16] and res_c [n,2,8,8]). CUDA planes are updated in place;
    returns (y, cb, cr)."""
    y = intra_luma(y, P, has_i8, mb_w, mb_h)
    cb, cr = intra_chroma(cb, cr, P, mb_w, mb_h)
    if deblock:
        y = deblock_luma(y, P, mb_w, mb_h)
        cb, cr = deblock_chroma(cb, cr, P, mb_w, mb_h)
    return y, cb, cr
