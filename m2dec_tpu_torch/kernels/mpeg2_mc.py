"""MPEG-2 half-pel motion compensation on torch tensors, bit-exact with
the reference.

The counterpart of the per-pixel spec path of
``m2dec_tpu/kernels/mpeg2_mc.py`` (reference: src/lib/motioncomp.cpp
:488-546 dispatch, :39-44 AVERAGE2 round-up average, :313-356 bilinear
(a+b+c+d+2)>>2, :69-76 bidirectional combine (pred1+pred2+1)>>1): one
batched gather-and-blend computes every macroblock of a picture, with
four shifted gathers (a, b; c, d) and a select on the half-pel flags.

Sample positions are clamped to the padded plane explicitly before the
gathers (torch has no clamping gather): when frame and field
predictions are both evaluated and one is selected, the unselected
mode's vectors may point outside the picture.

Chroma vectors use C truncation-toward-zero division by 2
(motioncomp.cpp:506-508 ``mvxy[0] / 2``), which differs from floor
division for negative odd values.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def _avg2(a, b):
    # AVERAGE2 (motioncomp.cpp:39-43): (a+b+1)>>1, round up
    return (a + b + 1) >> 1


def _ctrunc2(v):
    # C truncation-toward-zero division by 2 (motioncomp.cpp:506-508)
    return torch.where(v < 0, -((-v) >> 1), v >> 1)


def _taps(ref, ys, xs, dy):
    """The four taps ref[ys, xs], ref[ys, xs+1], ref[ys+dy, xs],
    ref[ys+dy, xs+1] as flat gathers (positions already clamped)."""
    W = ref.shape[1]
    flat = ref.reshape(-1)
    base = (ys * W + xs).long()
    return (flat[base], flat[base + 1], flat[base + dy * W],
            flat[base + dy * W + 1])


def _halfpel_blend(a, b, c, d, hx, hy):
    hx = hx[:, None, None]
    hy = hy[:, None, None]
    # HALFPEL dispatch (motioncomp.cpp:28, :451-463):
    # 00 copy; 01 horiz avg2(a,b); 10 vert avg2(a,c); 11 (a+b+c+d+2)>>2
    horiz = _avg2(a, b)
    vert = _avg2(a, c)
    both = (a + b + c + d + 2) >> 2
    return torch.where(hy == 1, torch.where(hx == 1, both, vert),
                       torch.where(hx == 1, horiz, a))


def mc_gather(ref, py, px, hx, hy, bh, bw):
    """Half-pel prediction for a batch of blocks from one reference plane.

    ref: int32 [H+1, W+1] plane with one replicated row and column at the
    bottom and right, so the +1 taps are addressable. py, px: int32 [N]
    top-left integer sample position per block; hx, hy: int32 [N]
    half-pel flags. bh, bw: block height and width. Returns int32
    [N, bh, bw] (values in 0..255).
    """
    dev = ref.device
    ys = py[:, None, None] + torch.arange(bh, dtype=I32, device=dev)[
        None, :, None]
    xs = px[:, None, None] + torch.arange(bw, dtype=I32, device=dev)[
        None, None, :]
    ys = ys.clamp(0, ref.shape[0] - 2)
    xs = xs.clamp(0, ref.shape[1] - 2)
    return _halfpel_blend(*_taps(ref, ys, xs, 1), hx, hy)


def mc_gather_field(ref, py, px, hx, hy, bh, bw):
    """Field variant of mc_gather: rows advance by 2 (one field line),
    and the vertical half-pel tap is the NEXT line of the same field
    (reference field MC, mpeg2.cpp:1293-1305). ``py`` is the frame row
    of the field's first line."""
    dev = ref.device
    ys = py[:, None, None] + 2 * torch.arange(bh, dtype=I32, device=dev)[
        None, :, None]
    xs = px[:, None, None] + torch.arange(bw, dtype=I32, device=dev)[
        None, None, :]
    ys = ys.clamp(0, ref.shape[0] - 3)
    xs = xs.clamp(0, ref.shape[1] - 2)
    return _halfpel_blend(*_taps(ref, ys, xs, 2), hx, hy)


def luma_pred(ref, mvx, mvy, mbx, mby):
    """16x16 luma prediction per MB (motioncomp.cpp:488-492); mvx/mvy
    half-pel vectors [N], mbx/mby MB coordinates [N]."""
    px = mbx * 16 + (mvx >> 1)
    py = mby * 16 + (mvy >> 1)
    return mc_gather(ref, py, px, mvx & 1, mvy & 1, 16, 16)


def chroma_pred(ref, mvx, mvy, mbx, mby):
    """8x8 chroma prediction per MB on a planar Cb or Cr plane, with the
    reference's chroma addressing (motioncomp.cpp:504-510): mv_c = mv/2
    truncated, integer part mv_c>>1, half-pel flags mv_c&1."""
    mvx_c = _ctrunc2(mvx)
    mvy_c = _ctrunc2(mvy)
    px = mbx * 8 + (mvx_c >> 1)
    py = mby * 8 + (mvy_c >> 1)
    return mc_gather(ref, py, px, mvx_c & 1, mvy_c & 1, 8, 8)


def combine_bidir(fwd, bwd):
    """Bi-directional combine (AveStore, motioncomp.cpp:66-76)."""
    return (fwd + bwd + 1) >> 1


def luma_pred_field(ref, mv1, mv2, sel, mbx, mby):
    """16x16 luma from two per-field predictions (motion_type=1 in frame
    pictures). mv1/mv2: [N,2] field-unit vectors; sel: [N] 2-bit field
    selects (bit i = source field of destination field i)."""
    outs = []
    for f, mv in ((0, mv1), (1, mv2)):
        mvx, mvy = mv[:, 0], mv[:, 1]
        px = mbx * 16 + (mvx >> 1)
        py = mby * 16 + 2 * (mvy >> 1) + ((sel >> f) & 1)
        outs.append(mc_gather_field(ref, py, px, mvx & 1, mvy & 1, 8, 16))
    return torch.stack(outs, dim=2).reshape(outs[0].shape[0], 16, 16)


def chroma_pred_field(ref, mv1, mv2, sel, mbx, mby):
    """8x8 chroma from two 8x4 field predictions (truncated mv/2)."""
    outs = []
    for f, mv in ((0, mv1), (1, mv2)):
        cmvx = _ctrunc2(mv[:, 0])
        cmvy = _ctrunc2(mv[:, 1])
        px = mbx * 8 + (cmvx >> 1)
        py = mby * 8 + 2 * (cmvy >> 1) + ((sel >> f) & 1)
        outs.append(mc_gather_field(ref, py, px, cmvx & 1, cmvy & 1, 4, 8))
    return torch.stack(outs, dim=2).reshape(outs[0].shape[0], 8, 8)
