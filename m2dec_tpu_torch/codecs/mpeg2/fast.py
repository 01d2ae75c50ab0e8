"""FAST_DECODE mode on torch tensors: DC-only 1/8-scale MPEG-1/2
reconstruction.

The counterpart of ``m2dec_tpu/codecs/mpeg2/fast.py``. The reference's
--enable-fastdec compile mode (configure.ac:34-41) decodes a
1/8-resolution preview: MB_LEN=2 (mpeg2.h:39-43) makes every macroblock
a 2x2 luma patch plus one CbCr pair, the IDCT collapses to a DC add with
no saturation (mpeg2.cpp:33-39), and motion compensation becomes a
full-pel copy with (mv+8)>>4 rounding (motioncomp.cpp:548-599). It is a
Phase-B variant over the same plan tensors: Phase A is unchanged.

Semantics replicated exactly:

* intra store / inter add are raw uint8 arithmetic -- no clipping, the
  value wraps (``& 0xFF``);
* only the dequantized DC participates (the plan's pre-oddification
  ``dc0``); AC coefficients, mismatch control and MPEG-1 oddification
  are skipped (mpeg2.cpp:1071-1084);
* bidirectional averaging is (fwd+bwd)>>1 with truncation;
* chroma MC rounds x to a CbCr pair boundary: byte offset
  ((mv/2)+4)>>3 & ~1 on the interleaved plane, with C division (toward
  zero) for mv/2 (motioncomp.cpp:561-567);
* field MC in frame pictures uses a doubled row stride; the chroma path
  takes only the first field's vector with no field offset
  (mpeg2.cpp:1291-1301 FAST_DECODE branch);
* every sample read is clamped into its plane (JAX's gather clamps;
  torch indexing would raise instead).

There is no hand kernel here: the JAX package has no Pallas kernel for
this mode, and the planes are 1/64 of a picture.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from .reconstruct import _upload

I32 = torch.int32
U8 = torch.uint8


def _ctrunc2(v):
    """C integer division by 2 (truncates toward zero)."""
    return torch.where(v >= 0, v >> 1, -((-v) >> 1))


def _gather(plane, ys, xs):
    h, w = plane.shape
    ys = ys.clamp(0, h - 1).long()
    xs = xs.clamp(0, w - 1).long()
    return plane[ys, xs].to(I32)


def _luma_pred(ref, mvx, mvy, mbx, mby):
    """Frame MC at 1/8 scale: 2x2 full-pel copy (motioncomp.cpp:550-559)."""
    sy = mby * 2 + ((mvy + 8) >> 4)
    sx = mbx * 2 + ((mvx + 8) >> 4)
    d = torch.arange(2, dtype=I32, device=ref.device)
    return _gather(ref, sy[:, None, None] + d[None, :, None],
                   sx[:, None, None] + d[None, None, :])


def _chroma_pred(ref, mvx, mvy, mbx, mby):
    """One CbCr sample: x rounds to the pair boundary
    (motioncomp.cpp:561-567)."""
    cx = _ctrunc2(mvx)
    cy = _ctrunc2(mvy)
    sy = mby + ((cy + 8) >> 4)
    sx = mbx + ((((cx + 4) >> 3) & -2) >> 1)
    return _gather(ref, sy, sx)


def _luma_pred_field(ref, mv1, mv2, fsel, mbx, mby):
    """Field MC rows: row i from field-i MV with doubled stride
    (mpeg2.cpp:1291-1294 with the fast luma copy)."""
    d = torch.arange(2, dtype=I32, device=ref.device)
    rows = []
    for i, mv in enumerate((mv1, mv2)):
        f = (fsel >> i) & 1
        sy = mby * 2 + f + 2 * ((mv[:, 1] + 8) >> 4)
        sx = mbx * 2 + ((mv[:, 0] + 8) >> 4)
        rows.append(_gather(ref, sy[:, None], sx[:, None] + d[None, :]))
    return torch.stack(rows, dim=1)  # [N, 2, 2]


def _chroma_pred_field(ref, mv1, mv2, fsel, mbx, mby):
    """Fast field chroma: field-0 MV only, no field offset, row step 2
    (mpeg2.cpp:1295-1301 FAST_DECODE branch)."""
    cx = _ctrunc2(mv1[:, 0])
    cy = _ctrunc2(mv1[:, 1])
    sy = mby + 2 * ((cy + 8) >> 4)
    sx = mbx + ((((cx + 4) >> 3) & -2) >> 1)
    return _gather(ref, sy, sx)


def reconstruct_fast_arrays(
    intra, fwd, bwd, mvf, mvb, dc0,
    ref0_y, ref0_cb, ref0_cr, ref1_y, ref1_cb, ref1_cr,
    *, mb_w, mb_h,
    mvf2=None, mvb2=None, fsel=None, fieldmc=None,
):
    """DC-only reconstruction onto (mb_h*2, mb_w*2) luma and
    (mb_h, mb_w) chroma uint8 planes, from tensors on one device.

    intra/fwd/bwd/fieldmc: bool [N]; mvf/mvb/mvf2/mvb2: int32 [N, 2]
    half-pel (x, y); fsel: int32 [N]; dc0: integer [N, 6]; refs: uint8
    coarse planes."""
    n = mb_w * mb_h
    dev = dc0.device
    idx = torch.arange(n, dtype=I32, device=dev)
    mbx = idx % mb_w
    mby = idx // mb_w
    has_field = fieldmc is not None

    def pred(rf, rb, framefn, fieldfn):
        pf = framefn(rf, mvf[:, 0], mvf[:, 1], mbx, mby)
        pb = framefn(rb, mvb[:, 0], mvb[:, 1], mbx, mby)
        tail = (n,) + (1,) * (pf.dim() - 1)
        if has_field:
            pf_f = fieldfn(rf, mvf, mvf2, fsel & 3, mbx, mby)
            pb_f = fieldfn(rb, mvb, mvb2, (fsel >> 2) & 3, mbx, mby)
            fm = fieldmc.reshape(tail)
            pf = torch.where(fm, pf_f, pf)
            pb = torch.where(fm, pb_f, pb)
        f3 = fwd.reshape(tail)
        b3 = bwd.reshape(tail)
        return torch.where(f3 & b3, (pf + pb) >> 1, torch.where(b3, pb, pf))

    pred_y = pred(ref0_y, ref1_y, _luma_pred, _luma_pred_field)
    pred_cb = pred(ref0_cb, ref1_cb, _chroma_pred, _chroma_pred_field)
    pred_cr = pred(ref0_cr, ref1_cr, _chroma_pred, _chroma_pred_field)

    res = (dc0.to(I32) + 4) >> 3  # [N, 6] DC-only IDCT
    res_y = res[:, :4].reshape(n, 2, 2)
    out_y = torch.where(intra[:, None, None], res_y, pred_y + res_y) & 0xFF
    out_cb = torch.where(intra, res[:, 4], pred_cb + res[:, 4]) & 0xFF
    out_cr = torch.where(intra, res[:, 5], pred_cr + res[:, 5]) & 0xFF

    y = (out_y.reshape(mb_h, mb_w, 2, 2).permute(0, 2, 1, 3)
         .reshape(mb_h * 2, mb_w * 2).to(U8))
    return (y, out_cb.reshape(mb_h, mb_w).to(U8),
            out_cr.reshape(mb_h, mb_w).to(U8))


#: plan fields of the fast decode, with their wire dtypes
_FAST_FIELDS = {"intra": np.uint8, "fwd": np.uint8, "bwd": np.uint8,
                "mvf": np.int32, "mvb": np.int32, "dc0": np.int16}
#: field MC of frame pictures, sent only for pictures that use it
_FAST_FIELD_MC = {"mvf2": np.int32, "mvb2": np.int32, "fsel": np.int32,
                  "fieldmc": np.uint8}


def reconstruct_picture_fast(plan, ref0, ref1, device=None):
    """Fast-mode reconstruct_picture: same plan/ref interface as
    ``reconstruct.reconstruct_picture``, coarse numpy planes out. Phase
    B runs on ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    has_field = plan.fieldmc is not None and bool(plan.fieldmc.any())
    kinds = dict(_FAST_FIELDS, **(_FAST_FIELD_MC if has_field else {}))
    x = {k: v[0] for k, v in _upload(
        {k: ([np.asarray(getattr(plan, k)).astype(dt)], dt)
         for k, dt in kinds.items()}, dev).items()}
    refs = [torch.from_numpy(np.ascontiguousarray(r[k])).to(dev)
            for r in (ref0, ref1) for k in ("y", "cb", "cr")]
    kw = {}
    if has_field:
        kw = dict(mvf2=x["mvf2"], mvb2=x["mvb2"], fsel=x["fsel"],
                  fieldmc=x["fieldmc"].bool())
    y, cb, cr = reconstruct_fast_arrays(
        x["intra"].bool(), x["fwd"].bool(), x["bwd"].bool(), x["mvf"],
        x["mvb"], x["dc0"], *refs, mb_w=plan.mb_w, mb_h=plan.mb_h, **kw)
    return {"y": y.cpu().numpy(), "cb": cb.cpu().numpy(),
            "cr": cr.cpu().numpy()}
