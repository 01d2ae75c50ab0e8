"""MPEG-1/2 Phase-B reconstruction on torch tensors: batched IDCT, MC
and assembly.

The counterpart of ``m2dec_tpu/codecs/mpeg2/reconstruct.py``. It takes
a PicturePlan (``entropy.py``) and the two reference frames and rebuilds
the whole picture at once, bit-exact with the reference:

* the IDCT is ``kernels/idct_kernels.idct8x8_blocks`` (the CUDA kernel
  on a GPU, the plain version on the CPU);
* MC is the per-pixel spec path of ``kernels/mpeg2_mc.py``;
* store rules: intra = clip(idct) (ClipStore, idct.cpp:364-370), inter =
  clip(pred + idct) (AddStore, idct.cpp:375-382); a non-coded inter
  block has all-zero coefficients, whose IDCT is zero;
* field-DCT luma row interleave (LUMA_BLOCK_OFFSET, mpeg2.cpp:1120).

Whole prediction directions are skipped when no macroblock of the
picture uses them, decided on the host from the numpy plan before it is
copied to the device (``_mc_needs``), so no device value is read back.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...kernels import mpeg2_mc as mc
from ...kernels.idct_kernels import idct8x8_blocks
from ...runtime import trace

I32 = torch.int32
U8 = torch.uint8


def _mc_needs(intra, fwd, bwd, fieldmc):
    """Host flags (need_fwd, need_bwd, has_field) of one picture's numpy
    plan: which predictions some inter macroblock's output reads. The
    forward prediction is read where an MB is bidirectional or not
    backward-only, the backward one wherever ``bwd`` is set."""
    inter = ~np.asarray(intra, bool)
    fwd, bwd = np.asarray(fwd, bool), np.asarray(bwd, bool)
    has_field = fieldmc is not None and bool(np.asarray(fieldmc).any())
    return (bool((inter & (fwd | ~bwd)).any()), bool((inter & bwd).any()),
            has_field)


def _pad1(p):
    """int32 copy of a plane with its last row and column repeated once
    (the +1 taps of the half-pel filter)."""
    p = p.to(I32)
    p = torch.cat([p, p[-1:]], dim=0)
    return torch.cat([p, p[:, -1:]], dim=1)


def reconstruct_arrays(intra, fwd, bwd, mvf, mvb, dct_type, res,
                       ref0, ref1, *, mb_w, mb_h, needs,
                       mvf2=None, mvb2=None, fsel=None, fieldmc=None):
    """One picture from device tensors.

    intra/fwd/bwd: bool [N]; mvf/mvb: int32 [N, 2] half-pel (x, y);
    dct_type: [N]; res: int32 [N, 6, 8, 8], the IDCT of the plan's
    coefficients; ref0/ref1: (y, cb, cr) uint8 planes padded to MB
    multiples; needs: (need_fwd, need_bwd, has_field) of ``_mc_needs``.
    With has_field, mvf2/mvb2/fsel/fieldmc carry the field MC of frame
    pictures. Returns (y, cb, cr) uint8 planes.
    """
    need_fwd, need_bwd, has_field = needs
    n = mb_w * mb_h
    dev = res.device
    idx = torch.arange(n, dtype=I32, device=dev)
    mbx = idx % mb_w
    mby = idx // mb_w
    shapes = ((n, 16, 16), (n, 8, 8), (n, 8, 8))
    fns = ((mc.luma_pred, mc.luma_pred_field),
           (mc.chroma_pred, mc.chroma_pred_field),
           (mc.chroma_pred, mc.chroma_pred_field))

    def direction(refs, mv, mv2, sel):
        out = []
        for plane, (predfn, fieldfn) in zip(refs, fns):
            rp = _pad1(plane)
            p = predfn(rp, mv[:, 0], mv[:, 1], mbx, mby)
            if has_field:
                # field MC in frame pictures (motion_type=1)
                pf = fieldfn(rp, mv, mv2, sel, mbx, mby)
                p = torch.where(fieldmc[:, None, None], pf, p)
            out.append(p)
        return out

    zero = [torch.zeros(s, dtype=I32, device=dev) for s in shapes]
    pf = (direction(ref0, mvf, mvf2, None if fsel is None else fsel & 3)
          if need_fwd else zero)
    pb = (direction(ref1, mvb, mvb2,
                    None if fsel is None else (fsel >> 2) & 3)
          if need_bwd else zero)
    f3, b3 = fwd[:, None, None], bwd[:, None, None]
    pred = [torch.where(f3 & b3, mc.combine_bidir(a, b),
                        torch.where(b3, b, a)) for a, b in zip(pf, pb)]

    # luma assembly: frame DCT = 2x2 block grid; field DCT interleaves
    # rows of the top (blocks 0,1) and bottom (blocks 2,3) half-MB pairs
    # (LUMA_BLOCK_OFFSET semantics, mpeg2.cpp:1120, :1144-1146)
    lb = res[:, :4]
    frame_asm = lb.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4).reshape(
        n, 16, 16)
    top = lb[:, 0:2].permute(0, 2, 1, 3).reshape(n, 8, 16)
    bot = lb[:, 2:4].permute(0, 2, 1, 3).reshape(n, 8, 16)
    field_asm = torch.stack([top, bot], dim=2).reshape(n, 16, 16)
    res_y = torch.where((dct_type == 1)[:, None, None], field_asm,
                        frame_asm)
    resid = (res_y, res[:, 4], res[:, 5])

    intra3 = intra[:, None, None]
    planes = []
    for r, p, blk in zip(resid, pred, (16, 8, 8)):
        v = torch.where(intra3, r, p + r).clamp(0, 255)
        planes.append(v.reshape(mb_h, mb_w, blk, blk).permute(0, 2, 1, 3)
                      .reshape(mb_h * blk, mb_w * blk).to(U8))
    return tuple(planes)


#: plan fields that ride to the device, with their wire dtypes
_PLAN_FIELDS = {"intra": np.uint8, "fwd": np.uint8, "bwd": np.uint8,
                "mvf": np.int32, "mvb": np.int32, "dct_type": np.uint8,
                "coef": np.int16}
#: the field MC of frame pictures, sent only in batches that use it
_FIELD_MC = {"mvf2": np.int32, "mvb2": np.int32, "fsel": np.int32,
             "fieldmc": np.uint8}


def _host_arrays(plans, has_field):
    """{name: (per-picture numpy arrays, wire dtype)} of a batch. With
    has_field, a picture that has no field MC arrays sends zeros."""
    n = plans[0].intra.shape[0]
    kinds = dict(_PLAN_FIELDS, **(_FIELD_MC if has_field else {}))
    out = {}
    for k, dt in kinds.items():
        zero = np.zeros((n, 2) if k in ("mvf2", "mvb2") else (n,), dt)
        out[k] = ([zero if getattr(p, k) is None else getattr(p, k)
                   for p in plans], dt)
    return out


_TORCH_DT = {np.dtype(np.uint8): U8, np.dtype(np.int8): torch.int8,
             np.dtype(np.int16): torch.int16, np.dtype(np.int32): I32}


def _upload(fields, device):
    """Stack the fields into ONE host buffer (pinned for a CUDA device),
    copy it to ``device`` in one transfer, and return typed device views
    {name: tensor [B, ...]}."""
    with trace.span("batch.upload"):
        layout, total = [], 0
        for k, (rows, dt) in fields.items():
            shape = (len(rows),) + rows[0].shape
            nb = int(np.prod(shape)) * np.dtype(dt).itemsize
            layout.append((k, np.dtype(dt), shape, total, nb))
            total += (nb + 15) & ~15
        hbuf = torch.empty(total, dtype=U8,
                           pin_memory=torch.device(device).type == "cuda")
        host = hbuf.numpy()
        for k, dt, shape, off, nb in layout:
            view = host[off:off + nb].view(dt).reshape(shape)
            for b, r in enumerate(fields[k][0]):
                view[b] = r
        trace.count("upload_bytes", hbuf.nbytes)
        dbuf = hbuf.to(device, non_blocking=True)
    return {k: dbuf[off:off + nb].view(_TORCH_DT[dt]).reshape(shape)
            for k, dt, shape, off, nb in layout}


def reconstruct_picture(plan, ref0, ref1, device=None):
    """Reconstruct one picture from its plan.

    ref0/ref1: dicts with 'y', 'cb', 'cr' uint8 numpy planes (forward /
    backward references per the reference's rotation, mpeg2.cpp:159-194).
    Phase B runs on ``device`` (default: the CUDA device). Returns a
    dict of numpy planes."""
    dev = resolve_device(device)
    needs = _mc_needs(plan.intra, plan.fwd, plan.bwd, plan.fieldmc)
    x = {k: v[0] for k, v in _upload(
        _host_arrays([plan], needs[2]), dev).items()}
    refs = [tuple(torch.from_numpy(np.ascontiguousarray(r[k])).to(dev)
                  for k in ("y", "cb", "cr")) for r in (ref0, ref1)]
    field = {k: x[k] for k in _FIELD_MC} if needs[2] else {}
    if needs[2]:
        field["fieldmc"] = field["fieldmc"].bool()
    y, cb, cr = reconstruct_arrays(
        x["intra"].bool(), x["fwd"].bool(), x["bwd"].bool(), x["mvf"],
        x["mvb"], x["dct_type"], idct8x8_blocks(x["coef"]), *refs,
        mb_w=plan.mb_w, mb_h=plan.mb_h, needs=needs, **field)
    return {"y": y.cpu().numpy(), "cb": cb.cpu().numpy(),
            "cr": cr.cpu().numpy()}


class Mpeg2SeqPhaseB:
    """Device-resident frame pool + batched MPEG-1/2 Phase B.

    The twin of the JAX package's Mpeg2SeqPhaseB: a ``pool_size``-slot
    pool of uint8 planes on the device; each picture of a batch reads
    its forward/backward references by slot and writes its own slot
    (m2d_update_frames pointer rotation, mpeg2.cpp:159-194, resolved on
    the host into (cur, r0, r1) triples). ``idct`` computes the batch's
    residuals (``idct8x8_blocks``: the kernel on CUDA)."""

    def __init__(self, mb_w, mb_h, pool_size, device=None,
                 idct=idct8x8_blocks):
        self.device = resolve_device(device)
        self.idct = idct
        self.mb_w, self.mb_h = mb_w, mb_h
        H, W = mb_h * 16, mb_w * 16
        self.pool = (
            torch.zeros((pool_size, H, W), dtype=U8, device=self.device),
            torch.zeros((pool_size, H >> 1, W >> 1), dtype=U8,
                        device=self.device),
            torch.zeros((pool_size, H >> 1, W >> 1), dtype=U8,
                        device=self.device))

    def run_async(self, items):
        """items: list of (plan, cur, r0, r1) in decode order. Returns
        (y [B,H,W], cb, cr) uint8 device tensors without synchronising.
        One host->device copy and one IDCT launch serve the batch."""
        plans = [it[0] for it in items]
        needs = [_mc_needs(p.intra, p.fwd, p.bwd, p.fieldmc)
                 for p in plans]
        has_field = any(nd[2] for nd in needs)
        x = _upload(_host_arrays(plans, has_field), self.device)
        res = self.idct(x["coef"])  # [B, N, 6, 8, 8]
        py, pcb, pcr = self.pool
        B = len(items)
        outs = tuple(torch.empty((B,) + p.shape[1:], dtype=U8,
                                 device=self.device) for p in self.pool)
        for b, (_, cur, r0, r1) in enumerate(items):
            field = ({k: x[k][b] for k in _FIELD_MC} if needs[b][2]
                     else {})
            if field:
                field["fieldmc"] = field["fieldmc"].bool()
            planes = reconstruct_arrays(
                x["intra"][b].bool(), x["fwd"][b].bool(),
                x["bwd"][b].bool(), x["mvf"][b], x["mvb"][b],
                x["dct_type"][b], res[b], (py[r0], pcb[r0], pcr[r0]),
                (py[r1], pcb[r1], pcr[r1]), mb_w=self.mb_w,
                mb_h=self.mb_h, needs=needs[b], **field)
            for pool, out, v in zip(self.pool, outs, planes):
                pool[cur] = v
                out[b] = v
        return outs
