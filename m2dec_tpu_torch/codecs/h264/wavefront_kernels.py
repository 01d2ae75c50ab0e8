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

Streams: every wrapper takes one stream's planes [H, W] (cb, cr [H/2,
W/2]) or a stack of S streams' [S, H, W], with the per-MB plan tensors
[S * n, ...] in stream-major order, and runs the S streams in the same
one launch per pass (the progress scratch is [S * mb_h + 1]). On the CPU
it runs the plain version once per stream (``per_stream``).

``LAUNCHES`` counts kernel launches per kernel (1 per pass, whatever S
is), so a run can show it went through them.
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


def per_stream(plain, planes, P, *args):
    """A pass's plain version (``wavefront.py``, one stream) on each
    stream of ``planes`` ([S, H, W] stacks, or [H, W] for one stream),
    with that stream's rows of the plan tensors P ([S * n, ...]); args
    are the plain version's arguments after P, ending in mb_w, mb_h.
    Returns the new planes, stacked like the input (one tensor or a
    tuple, as the plain version returns)."""
    if planes[0].dim() == 2:
        return plain(*planes, P, *args)
    n = args[-2] * args[-1]
    outs = []
    for s in range(planes[0].shape[0]):
        out = plain(*(t[s] for t in planes),
                    {k: v[s * n:(s + 1) * n] for k, v in P.items()}, *args)
        outs.append(out if isinstance(out, tuple) else (out,))
    res = tuple(torch.stack(o) for o in zip(*outs))
    return res if len(res) > 1 else res[0]


def _planes(ts, shape, names):
    """The stream count S and the data pointers of planes of one shape,
    each [H, W] (S = 1) or [S, H, W]. Each stream's plane starts on a
    4-byte boundary when the stack does: H * W is a multiple of 4."""
    S = ts[0].shape[0] if ts[0].dim() == 3 else 1
    want = shape if ts[0].dim() == 2 else (S,) + shape
    for t, name in zip(ts, names):
        if t.dtype != torch.uint8 or tuple(t.shape) != want:
            raise ValueError(f"{name}: want uint8 {want}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name} must start on a 4-byte boundary")
    return S, [t.data_ptr() for t in ts]


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


def _row_progress(dev, rows):
    """The row kernels' scratch on ``dev``'s current stream: int32
    [rows + 1] zeros (rows = S * mb_h), the MBs done per row of each
    stream, then the row ticket."""
    return torch.zeros(rows + 1, dtype=torch.int32, device=dev)


def _launch(name, dev, mb_w, mb_h, S, *args):
    """Launch one pass over S streams on ``dev``'s current stream and
    count it; raises on a CUDA error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn = getattr(_build.load_library("h264_wavefront"), "h264_" + name)
        err = fn(*args, mb_w, mb_h, S, stream)
    if err != 0:
        raise RuntimeError(f"h264_{name}: CUDA launch failed with error "
                           f"{err}")
    LAUNCHES[name] += 1


def intra_luma(y, P, has_i8, mb_w, mb_h):
    """Intra luma pass on raster uint8 [H,W] or [S,H,W] planes. CPU:
    plain version (returns new planes); CUDA: the kernel, in place."""
    if y.device.type == "cpu":
        return per_stream(WF.intra_luma_plain, (y,), P, has_i8, mb_w, mb_h)
    dev = _check_device(y)
    S, (py,) = _planes((y,), (mb_h * 16, mb_w * 16), ("y",))
    n, tabs = S * mb_w * mb_h, device_tables(dev)
    meta = [_meta(P, k, n, dev, tail) for k, tail in (
        ("kind", ()), ("res_y", (16, 16)), ("i4_modes", (16,)),
        ("i4_avail", (16,)), ("i8_modes", (4,)), ("i8_avail", (4,)),
        ("i16_mode", ()), ("mb_avail", ()))]
    progress = _row_progress(dev, S * mb_h)
    _launch("intra_luma", dev, mb_w, mb_h, S, py,
            *(t.data_ptr() for t in meta), tabs["i4_tab"].data_ptr(),
            tabs["i8_tab"].data_ptr(), progress.data_ptr(),
            int(bool(has_i8)))
    return y


def intra_chroma(cb, cr, P, mb_w, mb_h):
    """Intra chroma pass on raster uint8 [H/2,W/2] or [S,H/2,W/2]
    planes."""
    if cb.device.type == "cpu":
        return per_stream(WF.intra_chroma_plain, (cb, cr), P, mb_w, mb_h)
    dev = _check_device(cb)
    S, ptrs = _planes((cb, cr), (mb_h * 8, mb_w * 8), ("cb", "cr"))
    n = S * mb_w * mb_h
    meta = [_meta(P, k, n, dev, tail) for k, tail in (
        ("kind", ()), ("res_c", (2, 8, 8)), ("chroma_mode", ()),
        ("mb_avail", ()))] + [_row_progress(dev, S * mb_h)]
    _launch("intra_chroma", dev, mb_w, mb_h, S, *ptrs,
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
    """Deblocking luma pass on raster uint8 [H,W] or [S,H,W] planes."""
    if y.device.type == "cpu":
        return per_stream(WF.deblock_luma_plain, (y,), P, mb_w, mb_h)
    dev = _check_device(y)
    S, (py,) = _planes((y,), (mb_h * 16, mb_w * 16), ("y",))
    args = (_deb_args(P, S * mb_w * mb_h, dev)
            + [_row_progress(dev, S * mb_h)])
    _launch("deblock_luma", dev, mb_w, mb_h, S, py,
            *(t.data_ptr() for t in args))
    return y


def deblock_chroma(cb, cr, P, mb_w, mb_h):
    """Deblocking chroma pass on raster uint8 [H/2,W/2] or [S,H/2,W/2]
    planes."""
    if cb.device.type == "cpu":
        return per_stream(WF.deblock_chroma_plain, (cb, cr), P, mb_w, mb_h)
    dev = _check_device(cb)
    S, ptrs = _planes((cb, cr), (mb_h * 8, mb_w * 8), ("cb", "cr"))
    args = (_deb_args(P, S * mb_w * mb_h, dev)
            + [_row_progress(dev, S * mb_h)])
    _launch("deblock_chroma", dev, mb_w, mb_h, S, *ptrs,
            *(t.data_ptr() for t in args))
    return cb, cr


def run_wavefronts(y, cb, cr, P, has_i8, deblock, mb_w, mb_h):
    """Intra + deblocking wavefronts on raster uint8 planes y [H,W],
    cb/cr [H/2,W/2] (or [S,...] stacks of S streams) with per-MB int32
    plan tensors P ([S * n, ...], including res_y [.,16,16] and res_c
    [.,2,8,8]). CUDA planes are updated in place; returns (y, cb, cr)."""
    y = intra_luma(y, P, has_i8, mb_w, mb_h)
    cb, cr = intra_chroma(cb, cr, P, mb_w, mb_h)
    if deblock:
        y = deblock_luma(y, P, mb_w, mb_h)
        cb, cr = deblock_chroma(cb, cr, P, mb_w, mb_h)
    return y, cb, cr
