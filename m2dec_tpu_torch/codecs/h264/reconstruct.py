"""H.264 Phase-B reconstruction on torch tensors.

The counterpart of ``m2dec_tpu/codecs/h264/reconstruct.py``: the same
integer arithmetic, written as plain torch ops on an explicit device.
Per picture step of S streams (``_recon_core``): quarter-pel motion
compensation, assembly of the inter pictures, IPCM substitution, then
the intra and deblocking wavefronts (``wavefront_kernels``: CUDA kernels
on a GPU, one launch per pass for all S streams; the plain PyTorch scans
on the CPU). The residual inverse transforms read no reference frame and
run before, once per batch (``_residuals``).

``MultiStreamPhaseB`` keeps S streams' frame pools resident on the
device and runs a batch of pictures of all S from one host->device copy
of the packed wire blobs; ``BatchedPhaseB`` is its one-stream case.
Everything is int32 on the device except the uint8 planes and pools.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...runtime import trace
from ...runtime.golden import stack_checksum
from . import plan_host as host
from .decoder import Frame
from .native_pack import pack_batches
from .state import pool_from_frames
from .wavefront_kernels import run_wavefronts

I32 = torch.int32

# =====================================================================
# batched inverse transforms
# =====================================================================


def _stage4(r):
    e0 = r[..., 0] + r[..., 2]
    e1 = r[..., 0] - r[..., 2]
    e2 = (r[..., 1] >> 1) - r[..., 3]
    e3 = r[..., 1] + (r[..., 3] >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)


def idct4_batch(coef):
    """[..., 16] raster -> [..., 4, 4] residual."""
    c = coef.reshape(coef.shape[:-1] + (4, 4)).to(I32).clone()
    c[..., 0, 0] += 32
    f = _stage4(c)
    g = _stage4(f.transpose(-1, -2))
    return g.transpose(-1, -2) >> 6


def _stage8(r):
    s = [r[..., i] for i in range(8)]
    t0 = s[0] + s[4]
    t2 = s[0] - s[4]
    t4 = (s[2] >> 1) - s[6]
    t6 = s[2] + (s[6] >> 1)
    t1 = s[5] - s[3] - s[7] - (s[7] >> 1)
    t7 = s[3] + s[5] + s[1] + (s[1] >> 1)
    t3 = s[1] + s[7] - s[3] - (s[3] >> 1)
    t5 = s[5] + (s[5] >> 1) + s[7] - s[1]
    t0, t6 = t0 + t6, t0 - t6
    t2, t4 = t2 + t4, t2 - t4
    t1, t7 = t1 + (t7 >> 2), t7 - (t1 >> 2)
    t3, t5 = t3 + (t5 >> 2), (t3 >> 2) - t5
    return torch.stack(
        [t0 + t7, t2 + t5, t4 + t3, t6 + t1, t6 - t1, t4 - t3, t2 - t5,
         t0 - t7], dim=-1)


def idct8_batch(coef):
    c = coef.reshape(coef.shape[:-1] + (8, 8)).to(I32).clone()
    c[..., 0, 0] += 32
    f = _stage8(c)
    g = _stage8(f.transpose(-1, -2))
    return g.transpose(-1, -2) >> 6


def residual_mb(coef_luma, t8x8, has_i8=True):
    """[n,256] + flag -> assembled [n,16,16] luma residual. has_i8=False
    (static: no 8x8-transform MB in the batch) skips the idct8 arm."""
    n = coef_luma.shape[0]
    r4 = idct4_batch(coef_luma.reshape(n, 16, 16))  # [n,16,4,4]
    a4 = (r4.reshape(n, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
          .reshape(n, 16, 16))
    if not has_i8:
        return a4
    r8 = idct8_batch(coef_luma.reshape(n, 4, 64))  # [n,4,8,8]
    a8 = (r8.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
          .reshape(n, 16, 16))
    return torch.where((t8x8 != 0)[:, None, None], a8, a4)


def residual_chroma(coef_chroma):
    """[n,2,4,16] -> [n,2,8,8]."""
    n = coef_chroma.shape[0]
    r = idct4_batch(coef_chroma)  # [n,2,4,4,4]
    return (r.reshape(n, 2, 2, 2, 4, 4).permute(0, 1, 2, 4, 3, 5)
            .reshape(n, 2, 8, 8))


# =====================================================================
# inter prediction (dense 4x4-block windows + 6-tap/bilinear filters)
# =====================================================================

_MC_PAD = 16  # edge-replicate padding of ref planes (UMV fill domain)


def _tap6(a):
    """6-tap along the last axis, windows of 6."""
    return (a[..., :-5] - 5 * a[..., 1:-4] + 20 * a[..., 2:-3]
            + 20 * a[..., 3:-2] - 5 * a[..., 4:-1] + a[..., 5:])


def _pad_refs_edge(refs):
    """Edge-replicate pad of [R,H,W] planes by _MC_PAD, built from
    clamped index gathers (works for every dtype)."""
    R, H, W = refs.shape
    dev = refs.device
    ry = torch.arange(-_MC_PAD, H + _MC_PAD, device=dev).clamp_(0, H - 1)
    rx = torch.arange(-_MC_PAD, W + _MC_PAD, device=dev).clamp_(0, W - 1)
    return refs.index_select(1, ry).index_select(2, rx)


def _byte_windows(planes, pidx, sy, sx, rows, cols):
    """Gather [B,rows,cols] int32 windows from [P,Hp,Wp] uint8 planes:
    plane pidx[b], top-left (sy[b], sx[b]). Callers keep every window
    inside the plane (clamped starts on padded planes). This plain
    gather replaces the JAX package's uint32 word fetch, which was a
    TPU gather-unit device; the bytes are the same."""
    P, Hp, Wp = planes.shape
    dev = planes.device
    ar = torch.arange(rows, device=dev)
    ac = torch.arange(cols, device=dev)
    row = (pidx.long() * Hp + sy.long())[:, None] + ar[None, :]
    idx = row[:, :, None] * Wp + (sx.long()[:, None] + ac[None, :])[:, None, :]
    return planes.reshape(-1)[idx].to(I32)


def _halfpel_planes(refs_p):
    """refs_p [R,Hp,Wp] -> [4,R,Hp,Wp] uint8 stack (G, b, h, j) of the
    full- and half-pel planes (borders never sampled are zero)."""
    P = refs_p.to(I32)
    R, Hp, Wp = P.shape
    raw_b = _tap6(P)                                   # [R,Hp,Wp-5]
    raw_h = _tap6(P.transpose(-1, -2)).transpose(-1, -2)
    raw_j = _tap6(raw_b.transpose(-1, -2)).transpose(-1, -2)

    def embed(a, ro, co):
        return F.pad(a, (co, Wp - co - a.shape[2], ro, Hp - ro - a.shape[1]))

    b = embed(((raw_b + 16) >> 5).clamp(0, 255), 0, 2)
    h = embed(((raw_h + 16) >> 5).clamp(0, 255), 2, 0)
    j = embed(((raw_j + 512) >> 10).clamp(0, 255), 2, 2)
    return torch.stack([P, b, h, j]).to(torch.uint8)


def _qpel_planes(planes4, hp_tab):
    """[4,R,Hp,Wp] half-pel stack -> [16,R,Hp,Wp] quarter-pel planes:
    plane fy*4+fx holds avg(P1[.+o1], P2[.+o2]) per _HP_TAB."""
    P4 = planes4.to(I32)

    def shifted(p, dy, dx):
        a = P4[p]
        if dy:
            a = torch.cat([a[:, 1:, :], torch.zeros_like(a[:, :1, :])], 1)
        if dx:
            a = torch.cat([a[:, :, 1:], torch.zeros_like(a[:, :, :1])], 2)
        return a

    outs = []
    for f in range(16):
        p1, dy1, dx1, p2, dy2, dx2 = (int(v) for v in hp_tab[f])
        if (p1, dy1, dx1) == (p2, dy2, dx2):
            outs.append(planes4[p1])
            continue
        a = shifted(p1, dy1, dx1)
        b = shifted(p2, dy2, dx2)
        outs.append(((a + b + 1) >> 1).to(torch.uint8))
    return torch.stack(outs)


def _luma_mc_qp(planes16, slot, posx, posy, fracx, fracy, H, W, size=4):
    """Quarter-pel luma: ONE size x size window from the 16-phase
    plane stack per prediction."""
    posy_c = posy.clamp(-9, H + 1)
    posx_c = posx.clamp(-9, W + 1)
    nplanes, R, Hp, Wp = planes16.shape
    flat = planes16.reshape(nplanes * R, Hp, Wp)
    sl = slot.clamp(0, R - 1)
    return _byte_windows(flat, (fracy * 4 + fracx) * R + sl,
                         posy_c + _MC_PAD, posx_c + _MC_PAD, size, size)


def _chroma_mc_ilv(refs_ilv_p, slot, posx, posy, fracx, fracy, H, W,
                   size=2):
    """Bilinear chroma from a column-interleaved CbCr plane
    [R, Hc+2p, 2*(Wc+2p)]; returns (pcb, pcr) [B,size,size]."""
    posy_c = posy.clamp(-3, H - 1)
    posx_c = posx.clamp(-3, W - 1)
    t = size + 1
    R = refs_ilv_p.shape[0]
    g = _byte_windows(refs_ilv_p, slot.clamp(0, R - 1), posy_c + _MC_PAD,
                      2 * (posx_c + _MC_PAD), t, 2 * t)
    a = g[:, 0:size, 0 : 2 * size]
    b = g[:, 0:size, 2 : 2 * size + 2]
    c = g[:, 1 : size + 1, 0 : 2 * size]
    d = g[:, 1 : size + 1, 2 : 2 * size + 2]
    fx = fracx[:, None, None]
    fy = fracy[:, None, None]
    out = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
           + (8 - fx) * fy * c + fx * fy * d + 32) >> 6
    return out[:, :, 0::2], out[:, :, 1::2]


def _interleave_chroma(cb_p, cr_p):
    """[R,Hp,Wp] x2 -> [R,Hp,2*Wp] column-interleaved."""
    R_, Hp, Wp = cb_p.shape
    return torch.stack([cb_p, cr_p], dim=-1).reshape(R_, Hp, 2 * Wp)


def _combine_wp(p0, p1, both, w0, w1, o, s):
    """Unified copy/AVERAGE2/explicit/implicit combine (plan.py wp).
    ``both`` is a bool tensor, or a Python bool for a uniform choice."""
    rnd = torch.where(s > 0, torch.ones_like(s) << (s - 1).clamp(min=0), 0)
    if both is False:
        v = ((p0 * w0 + rnd) >> s) + o
    elif both is True:
        v = ((p0 * w0 + p1 * w1 + rnd) >> s) + o
    else:
        uni = ((p0 * w0 + rnd) >> s) + o
        bi = ((p0 * w0 + p1 * w1 + rnd) >> s) + o
        v = torch.where(both, bi, uni)
    return v.clamp(0, 255)


def inter_pass(plan_mv, plan_slot, plan_wp, refs_y, refs_cb, refs_cr,
               mb_w, mb_h, hp_tab, used=None, bi_idx=None, y_off=0):
    """Predict every 4x4 block of one picture of each of S streams (the
    JAX package's dense path): pred_y [S*n,16,16], pred_cb/cr [S*n,8,8]
    int32, garbage for intra MBs (selected out later).

    Plan tensors are [S*n, ...] in stream-major order; refs [S,R,H,W]
    are each stream's reference planes. used: optional [S,K] pool slots
    each stream's picture references (plan slots pre-remapped to
    0..K-1). bi_idx: optional [S,Bb] bi-predicted cell indices of each
    stream's picture, padded with n*16; the second prediction is fetched
    only for those cells. A stream reads only its own K (or R) planes,
    so every stream's bytes are those of a single-stream call.

    y_off: the pixel row of the first of the mb_h MB rows within the
    whole picture (an MB-row band of ``parallel.mesh.h264_tile_step``):
    MVs address the whole reference pictures refs in picture
    coordinates. As in the JAX package, the host-derived MC aux (used,
    bi_idx) is for whole pictures only."""
    if y_off and (used is not None or bi_idx is not None):
        raise ValueError("inter_pass: the MC aux (used, bi_idx) is derived "
                         "for whole pictures; y_off must be 0 with it")
    S, R, H, W = refs_y.shape
    n = mb_w * mb_h
    B = S * n * 16
    dev = plan_mv.device
    sidx = torch.arange(S, device=dev)
    refs = [r.reshape((S * R,) + r.shape[2:])
            for r in (refs_y, refs_cb, refs_cr)]
    K = R
    if used is not None:
        K = used.shape[1]
        u = (used.long() + sidx[:, None] * R).reshape(-1)
        refs = [r[u] for r in refs]
    refs_y_p = _pad_refs_edge(refs[0])
    refs_c_p = _interleave_chroma(_pad_refs_edge(refs[1]),
                                  _pad_refs_edge(refs[2]))
    planes16 = _qpel_planes(_halfpel_planes(refs_y_p), hp_tab)
    # each cell's first plane among the S*K: the stream's slots are
    # clamped to its own K, as a single-stream call clamps them
    cell = torch.arange(B, device=dev)
    kbase = (cell // (n * 16)).to(I32) * K

    def pred_one(sl, base, mvv, bxv, byv):
        sl = sl.clamp(0, K - 1) + base
        mvx, mvy = mvv[:, 0], mvv[:, 1]
        py = _luma_mc_qp(planes16, sl, bxv + (mvx >> 2), byv + (mvy >> 2),
                         mvx & 3, mvy & 3, H, W)
        cxp = (bxv >> 1) + (mvx >> 3)
        cyp = (byv >> 1) + (mvy >> 3)
        pcb, pcr = _chroma_mc_ilv(refs_c_p, sl, cxp, cyp, mvx & 7,
                                  mvy & 7, H >> 1, W >> 1)
        return py, pcb, pcr

    def comb(wpa, pi, pa, pb, mask3):
        w0 = wpa[:, pi, 0][:, None, None]
        w1 = wpa[:, pi, 1][:, None, None]
        o = wpa[:, pi, 2][:, None, None]
        s = wpa[:, pi, 3][:, None, None]
        return _combine_wp(pa, pb, mask3, w0, w1, o, s)

    mb = torch.arange(S * n, dtype=I32, device=dev) % n
    x0 = (mb % mb_w) * 16
    y0 = (mb // mb_w) * 16 + y_off
    blk = torch.arange(16, dtype=I32, device=dev)
    bx = (x0[:, None] + (blk[None, :] & 3) * 4).reshape(B)
    by = (y0[:, None] + (blk[None, :] >> 2) * 4).reshape(B)
    quad = ((blk >> 3) * 2 + ((blk >> 1) & 1)).long()
    slot = plan_slot.reshape(S * n, 4, 2)[:, quad].reshape(B, 2)
    wp = plan_wp.reshape(S * n, 4, 3, 4)[:, quad].reshape(B, 3, 4)
    mv = plan_mv.reshape(B, 2, 2)

    s0, s1 = slot[:, 0], slot[:, 1]
    both = (s0 >= 0) & (s1 >= 0)
    # single-list predictions route through p0 (recorder convention)
    p0_slot = torch.where(s0 >= 0, s0, s1)
    p0_mv = torch.where((s0 >= 0)[:, None], mv[:, 0], mv[:, 1])
    p0y, p0cb, p0cr = pred_one(p0_slot, kbase, p0_mv, bx, by)

    if bi_idx is None:
        p1y, p1cb, p1cr = pred_one(
            torch.where(both, s1, p0_slot), kbase,
            torch.where(both[:, None], mv[:, 1], p0_mv), bx, by)
        both3 = both[:, None, None]
        out_y = comb(wp, 0, p0y, p1y, both3)     # [B,4,4]
        out_cb = comb(wp, 1, p0cb, p1cb, both3)  # [B,2,2]
        out_cr = comb(wp, 2, p0cr, p1cr, both3)
    else:
        # uni combine everywhere; the listed bi cells overwrite. Pad
        # entries (torch does not clamp) land on row B, one past the
        # cells, which is cut off: no host sync to drop them
        bcell = bi_idx.long()
        bcell = torch.where(bcell < n * 16, bcell + sidx[:, None] * n * 16,
                            B).reshape(-1)
        g = bcell.clamp(max=B - 1)
        p1y, p1cb, p1cr = pred_one(s1[g], kbase[g], mv[g, 1], bx[g], by[g])
        wpc = wp[g]
        outs = []
        for pi, p0, p1 in ((0, p0y, p1y), (1, p0cb, p1cb), (2, p0cr, p1cr)):
            out = comb(wp, pi, p0, p0, False)
            out = torch.cat([out, out[:1]])
            out[bcell] = comb(wpc, pi, p0[g], p1, True)
            outs.append(out[:B])
        out_y, out_cb, out_cr = outs

    pred_y = (out_y.reshape(-1, 4, 4, 4, 4).permute(0, 1, 3, 2, 4)
              .reshape(-1, 16, 16))
    pred_cb = (out_cb.reshape(-1, 4, 4, 2, 2).permute(0, 1, 3, 2, 4)
               .reshape(-1, 8, 8))
    pred_cr = (out_cr.reshape(-1, 4, 4, 2, 2).permute(0, 1, 3, 2, 4)
               .reshape(-1, 8, 8))
    return pred_y, pred_cb, pred_cr


# =====================================================================
# intra prediction formulas on lane-stacked neighbour vectors
# =====================================================================


def _sel_mode(stack, mode):
    """stack [M][L,h,w]; mode [L] -> [L,h,w] (mode outside 1..M-1 -> 0)."""
    out = stack[0]
    for m in range(1, len(stack)):
        out = torch.where((mode == m)[:, None, None], stack[m], out)
    return out


def _mode_eval(line, mode, mats, P):
    """line [L,n] int32, mode [L] -> [L,P]: every mode's values as one
    exact f32 matmul with the constant mode matrix, then a select."""
    M, rnd, shift = mats
    acc = torch.matmul(line.to(torch.float32), M)
    vals = (acc.to(I32) + rnd[None]) >> shift[None]
    out = vals[:, 0:P]
    for m in range(1, 9):
        out = torch.where((mode == m)[:, None], vals[:, m * P : m * P + P],
                          out)
    return out


def _dc(av1, av2, sl, st, both_rs, one_r, one_s):
    """where(av1&av2, (sl+st+both_r)>>both_s, av1: (sl+one_r)>>one_s,
    av2: (st+one_r)>>one_s, else 0x80)."""
    br, bs = both_rs
    return torch.where(av1 & av2, (sl + st + br) >> bs,
           torch.where(av1, (sl + one_r) >> one_s,
           torch.where(av2, (st + one_r) >> one_s,
                       torch.full_like(sl, 0x80))))


def intra4_modes(l, t, c, avail, mode, mats):
    """All 9 4x4 modes; l [L,4], t [L,8] top+topright, c [L], avail
    bits, mode [L] -> [L,4,4]."""
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    av4 = (avail & 4) != 0
    t4 = t[:, :4]
    th = torch.where(av4[:, None], t[:, 4:8], t[:, 3:4])
    sl = l.sum(dim=1, dtype=I32)
    st = t4.sum(dim=1, dtype=I32)
    dc = _dc(av1, av2, sl, st, (4, 3), 2, 2)
    line = torch.cat([l, c[:, None], t4, th, dc[:, None]], dim=1)
    return _mode_eval(line, mode, mats, 16).reshape(l.shape[0], 4, 4)


def intra8_modes(t, l, c, tr, avail, mode, mats):
    """All 9 8x8 modes with reference-sample filtering."""
    L = t.shape[0]
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    av4 = (avail & 4) != 0
    av8 = (avail & 8) != 0

    def fir3v(a, b, cc):
        return (a + 2 * b + cc + 2) >> 2

    cprev = torch.where(av8, c, t[:, 0])
    prevv = torch.cat([cprev[:, None], t[:, :6]], dim=1)  # [L,7]
    tp7 = fir3v(prevv, t[:, :7], t[:, 1:8])
    full = torch.cat([t, tr], dim=1)  # [L,16]
    ext = fir3v(full[:, 6:15], full[:, 7:16],
                torch.cat([full[:, 8:16], full[:, 15:16]], dim=1))
    with_tr = torch.cat([tp7, ext], dim=1)  # [L,16]
    no_tr = torch.cat(
        [tp7, ((t[:, 6] + 3 * t[:, 7] + 2) >> 2)[:, None],
         t[:, 7:8].expand(L, 8)], dim=1)
    tp16 = torch.where(av4[:, None], with_tr, no_tr)
    lprev = torch.where(av8, c, l[:, 0])
    lprevv = torch.cat([lprev[:, None], l[:, :6]], dim=1)
    lf7 = fir3v(lprevv, l[:, :7], l[:, 1:8])
    lf = torch.cat([lf7, ((l[:, 6] + 3 * l[:, 7] + 2) >> 2)[:, None]], 1)
    cor = (l[:, 0] + 2 * c + t[:, 0] + 2) >> 2
    sl = lf.sum(dim=1, dtype=I32)
    st = tp16[:, :8].sum(dim=1, dtype=I32)
    dc = _dc(av1, av2, sl, st, (8, 4), 4, 3)
    line = torch.cat([lf, cor[:, None], tp16, dc[:, None]], dim=1)
    return _mode_eval(line, mode, mats, 64).reshape(L, 8, 8)


def intra16_modes(l16, t16, c, avail, mode):
    """16x16 modes; l16/t16 [L,16], c [L] corner -> [L,16,16]."""
    L = l16.shape[0]
    dev = l16.device
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    m_vert = t16[:, None, :].expand(L, 16, 16)
    m_horiz = l16[:, :, None].expand(L, 16, 16)
    sl = l16.sum(dim=1, dtype=I32)
    st = t16.sum(dim=1, dtype=I32)
    dc = _dc(av1, av2, sl, st, (16, 5), 8, 4)
    m_dc = dc[:, None, None].expand(L, 16, 16)
    wv = torch.arange(-7, 9, dtype=I32, device=dev)
    h = (t16 * wv[None, :]).sum(dim=1, dtype=I32) - 8 * c
    v = (l16 * wv[None, :]).sum(dim=1, dtype=I32) - 8 * c
    h = (5 * h + 32) >> 6
    v = (5 * v + 32) >> 6
    a = 16 * (l16[:, 15] + t16[:, 15])
    ys = torch.arange(16, dtype=I32, device=dev)
    val = (a[:, None, None] + (ys[None, None, :] - 7) * h[:, None, None]
           + (ys[None, :, None] - 7) * v[:, None, None] + 16) >> 5
    m_plane = val.clamp(0, 255)
    return _sel_mode([m_vert, m_horiz, m_dc, m_plane], mode)


def intra_chroma_modes(l8, t8, c, avail, mode):
    """Chroma modes on an 8x8 tile -> [L,8,8]."""
    L = l8.shape[0]
    dev = l8.device
    av1 = (avail & 1) != 0
    av2 = (avail & 2) != 0
    sl0 = l8[:, 0:4].sum(dim=1, dtype=I32)
    sl4 = l8[:, 4:8].sum(dim=1, dtype=I32)
    st0 = t8[:, 0:4].sum(dim=1, dtype=I32)
    st4 = t8[:, 4:8].sum(dim=1, dtype=I32)
    k80 = torch.full_like(sl0, 0x80)
    dc0 = torch.where(av1 & av2, (sl0 + st0 + 4) >> 3,
          torch.where(av1, (sl0 + 2) >> 2,
          torch.where(av2, (st0 + 2) >> 2, k80)))
    dc1 = torch.where(av1 & av2, (st4 + 2) >> 2,
          torch.where(av1, (sl0 + 2) >> 2,
          torch.where(av2, (st4 + 2) >> 2, k80)))
    dc2 = torch.where(av1 & av2, (sl4 + 2) >> 2,
          torch.where(av1, (sl4 + 2) >> 2,
          torch.where(av2, (st0 + 2) >> 2, k80)))
    dc3 = torch.where(av1 & av2, (sl4 + st4 + 4) >> 3,
          torch.where(av1, (sl4 + 2) >> 2,
          torch.where(av2, (st4 + 2) >> 2, k80)))
    half = torch.arange(8, device=dev) >= 4
    rsel = half[None, :, None]
    csel = half[None, None, :]
    m_dc = torch.where(
        rsel,
        torch.where(csel, dc3[:, None, None], dc2[:, None, None]),
        torch.where(csel, dc1[:, None, None], dc0[:, None, None]))
    m_horiz = l8[:, :, None].expand(L, 8, 8)
    m_vert = t8[:, None, :].expand(L, 8, 8)
    wv8 = torch.arange(-3, 5, dtype=I32, device=dev)
    h = (t8 * wv8[None, :]).sum(dim=1, dtype=I32) - 4 * c
    v = (l8 * wv8[None, :]).sum(dim=1, dtype=I32) - 4 * c
    h = (17 * h + 16) >> 5
    v = (17 * v + 16) >> 5
    a = 16 * (l8[:, 7] + t8[:, 7])
    ys = torch.arange(8, dtype=I32, device=dev)
    val = (a[:, None, None] + (ys[None, None, :] - 3) * h[:, None, None]
           + (ys[None, :, None] - 3) * v[:, None, None] + 16) >> 5
    m_plane = val.clamp(0, 255)
    return _sel_mode([m_dc.expand(L, 8, 8), m_horiz, m_vert, m_plane],
                     mode)


# =====================================================================
# deblocking filter math
# =====================================================================


def _clip3(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _filter_lines_luma(cols, s, alpha, beta, tc0):
    """cols [L,K,8] (q3 q2 q1 q0 | p0 p1 p2 p3), s [L,K] strength,
    alpha/beta [L,1], tc0 [L,K]. Returns the updated cols."""
    q3, q2, q1, q0 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    p0, p1, p2, p3 = cols[..., 4], cols[..., 5], cols[..., 6], cols[..., 7]
    m = (((q1 - q0).abs() < beta) & ((q0 - p0).abs() < alpha)
         & ((p0 - p1).abs() < beta) & (s > 0))
    m4 = m & (s == 4)
    mn = m & (s < 4)
    cond = (q0 - p0).abs() < ((alpha >> 2) + 2)
    m4s = m4 & cond
    m4w = m4 & ~cond
    aq_s = (q0 - q2).abs() < beta
    ap_s = (p0 - p2).abs() < beta
    tq = q0 + q1 + p0 + 2
    tp = p0 + p1 + q0 + 2
    q0_s = torch.where(aq_s, (tq * 2 + p1 + q2) >> 3,
                       (q1 * 2 + q0 + p1 + 2) >> 2)
    q1_s = (tq + q2) >> 2
    q2_s = (q3 * 2 + q2 * 3 + tq + 2) >> 3
    p0_s = torch.where(ap_s, (tp * 2 + q1 + p2) >> 3,
                       (p1 * 2 + p0 + q1 + 2) >> 2)
    p1_s = (tp + p2) >> 2
    p2_s = (p3 * 2 + p2 * 3 + tp + 2) >> 3
    tw = q1 + p1 + 2
    q0_w = (q1 + q0 + tw) >> 2
    p0_w = (p1 + p0 + tw) >> 2
    aq = (q2 - q0).abs() < beta
    ap = (p2 - p0).abs() < beta
    half = (p0 + q0 + 1) >> 1
    dq1 = _clip3((q2 + half - q1 * 2) >> 1, -tc0, tc0)
    dp1 = _clip3((p2 + half - p1 * 2) >> 1, -tc0, tc0)
    q1_n = torch.where(mn & (tc0 > 0) & aq, q1 + dq1, q1)
    p1_n = torch.where(mn & (tc0 > 0) & ap, p1 + dp1, p1)
    tc = tc0 + aq.to(I32) + ap.to(I32)
    delta = _clip3(((p0 - q0) * 4 + q1 - p1 + 4) >> 3, -tc, tc)
    mdelta = mn & (tc > 0)
    q0_n = torch.where(mdelta, q0 + delta, q0).clamp(0, 255)
    p0_n = torch.where(mdelta, p0 - delta, p0).clamp(0, 255)
    nq2 = torch.where(m4s & aq_s, q2_s, q2)
    nq1 = torch.where(m4s & aq_s, q1_s, torch.where(mn, q1_n, q1))
    nq0 = torch.where(m4s, q0_s, torch.where(m4w, q0_w,
                                             torch.where(mn, q0_n, q0)))
    np2 = torch.where(m4s & ap_s, p2_s, p2)
    np1 = torch.where(m4s & ap_s, p1_s, torch.where(mn, p1_n, p1))
    np0 = torch.where(m4s, p0_s, torch.where(m4w, p0_w,
                                             torch.where(mn, p0_n, p0)))
    return torch.stack([q3, nq2.clamp(0, 255), nq1.clamp(0, 255),
                        nq0.clamp(0, 255), np0.clamp(0, 255),
                        np1.clamp(0, 255), np2.clamp(0, 255), p3], dim=-1)


def _filter_lines_chroma(cols, s, alpha, beta, tc0):
    """cols [L,K,4] (q1 q0 | p0 p1)."""
    q1, q0, p0, p1 = cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3]
    m = (((q1 - q0).abs() < beta) & ((q0 - p0).abs() < alpha)
         & ((p0 - p1).abs() < beta) & (s > 0))
    m4 = m & (s == 4)
    mn = m & (s < 4)
    t = q1 + p1 + 2
    q0_4 = (q1 + q0 + t) >> 2
    p0_4 = (p1 + p0 + t) >> 2
    tc = tc0 + 1
    delta = _clip3(((p0 - q0) * 4 + q1 - p1 + 4) >> 3, -tc, tc)
    nq0 = torch.where(m4, q0_4, torch.where(mn, q0 + delta, q0))
    np0 = torch.where(m4, p0_4, torch.where(mn, p0 - delta, p0))
    return torch.stack([q1, nq0.clamp(0, 255), np0.clamp(0, 255), p1],
                       dim=-1)


def _edge_params(stbyte, str4, ab, nlines, shift, alpha_t, beta_t, tc0_t):
    """Per-line strength + alpha/beta/tc0 for one edge. stbyte/str4 [L];
    ab [L,2] alpha/beta indices (negative alpha index = edge off).
    Returns s [L,K], alpha [L,1], beta [L,1], tc0 [L,K]."""
    k = torch.arange(nlines, dtype=I32, device=stbyte.device)
    j = k >> shift
    s = (stbyte[:, None] >> (2 * j)[None, :]) & 3
    s = torch.where((str4 > 0)[:, None], 4, s)
    aidx = ab[:, 0]
    s = torch.where((aidx >= 0)[:, None], s, 0)
    ai = (aidx.clamp(-16, 35) + 16).long()
    bi = (ab[:, 1].clamp(-16, 35) + 16).long()
    alpha = alpha_t[ai][:, None]
    beta = beta_t[bi][:, None]
    t3 = tc0_t[:, ai].T                                  # [L,3]
    tc0 = torch.where(s <= 1, t3[:, 0:1],
          torch.where(s == 2, t3[:, 1:2], t3[:, 2:3]))
    return s, alpha, beta, tc0


# =====================================================================
# one picture
# =====================================================================


def _assemble(mbs, blk, mb_w, mb_h):
    """Per-MB tiles [S*n, blk, blk] (stream-major) -> S raster planes."""
    return (mbs.reshape(-1, mb_h, mb_w, blk, blk).permute(0, 1, 3, 2, 4)
            .reshape(-1, mb_h * blk, mb_w * blk))


def _pcm_planes(rows, mb_w, mb_h):
    """PCM rows [..., n, 384] of any number of pictures -> their (y, cb,
    cr) raster planes, [P, H, W] for the P pictures."""
    rows = rows.reshape(-1, 384)
    y = _assemble(rows[:, :256], 16, mb_w, mb_h)
    cb = _assemble(rows[:, 256:320], 8, mb_w, mb_h)
    cr = _assemble(rows[:, 320:384], 8, mb_w, mb_h)
    return y, cb, cr


def _residuals(P, has_i8):
    """(res_y [..., 16, 16], res_c [..., 2, 8, 8]) of plan tensors P with
    any leading dims: the residual iDCT, which reads no reference frame,
    so it runs once for a whole batch of pictures and streams."""
    cl, cc = P["coef_luma"], P["coef_chroma"]
    res_y = residual_mb(cl.reshape(-1, 256), P["t8x8"].reshape(-1),
                        has_i8=has_i8)
    res_c = residual_chroma(cc.reshape(-1, 2, 4, 16))
    return (res_y.reshape(cl.shape[:-1] + (16, 16)),
            res_c.reshape(cc.shape[:-3] + (2, 8, 8)))


def _recon_core(P, refs_y, refs_cb, refs_cr, pcm, *, mb_w, mb_h, has_i8,
                deblock, wavefronts=run_wavefronts):
    """One picture of each of S streams. P = dict of int32 plan tensors
    [S*n, ...] in stream-major order, with the residuals res_y and res_c
    (``_residuals``) and optionally the dense-MC aux mc_used [S,K] /
    mc_bi [S,Bb]; refs [S,R,H,W] each stream's pool; pcm = None or the
    pictures' PCM planes (y, cb, cr) [S,H,W]. Returns uint8 planes
    [S,H,W].

    wavefronts: the intra+deblock pass, ``run_wavefronts`` by default
    (kernels on CUDA, plain scans on CPU), called on the [S,H,W] planes."""
    kind = P["kind"]
    res_y, res_c = P["res_y"], P["res_c"]
    with trace.span("step.mc"):
        pred_y, pred_cb, pred_cr = inter_pass(
            P["mv"], P["slot"], P["wp"], refs_y, refs_cb, refs_cr, mb_w,
            mb_h, host._HP_TAB, used=P.get("mc_used"),
            bi_idx=P.get("mc_bi"))
    is_inter = (kind == 0)[:, None, None]
    zero = torch.zeros((), dtype=I32, device=kind.device)
    inter_y = torch.where(is_inter, (pred_y + res_y).clamp(0, 255), zero)
    inter_cb = torch.where(is_inter, (pred_cb + res_c[:, 0]).clamp(0, 255),
                           zero)
    inter_cr = torch.where(is_inter, (pred_cr + res_c[:, 1]).clamp(0, 255),
                           zero)
    y_plane = _assemble(inter_y, 16, mb_w, mb_h)
    cb_plane = _assemble(inter_cb, 8, mb_w, mb_h)
    cr_plane = _assemble(inter_cr, 8, mb_w, mb_h)
    if pcm is not None:
        pcm_y, pcm_cb, pcm_cr = pcm
        kind_mb = kind.reshape(-1, mb_h, mb_w)
        kpix = kind_mb.repeat_interleave(16, 1).repeat_interleave(16, 2)
        kpixc = kind_mb.repeat_interleave(8, 1).repeat_interleave(8, 2)
        y_plane = torch.where(kpix == 4, pcm_y.to(I32), y_plane)
        cb_plane = torch.where(kpixc == 4, pcm_cb.to(I32), cb_plane)
        cr_plane = torch.where(kpixc == 4, pcm_cr.to(I32), cr_plane)
    u8 = torch.uint8
    with trace.span("step.passes"):
        return wavefronts(y_plane.to(u8).contiguous(),
                          cb_plane.to(u8).contiguous(),
                          cr_plane.to(u8).contiguous(), P, has_i8, deblock,
                          mb_w, mb_h)


def _plan_flags(kind, t8x8, deb_str, deb_str4):
    """(has_i8, deblock) static flags, ORed over the arrays given."""
    has_i8 = bool((kind == 2).any() or ((t8x8 != 0) & (kind == 0)).any())
    deblock = bool(deb_str.any() or deb_str4.any())
    return has_i8, deblock


def reconstruct_plan_torch(plan, frames, device=None):
    """Torch Phase B for one plan into frames[plan.cur_idx] (host numpy
    pool), the twin of reconstruct_plan_jax."""
    dev = resolve_device(device)
    slots = plan.used_slots()
    pool = len(frames)
    remap = np.full(pool + 1, 0, np.int32)
    R = host._next_pow2(max(1, len(slots)))
    for i, s in enumerate(slots):
        remap[s] = i
    zero = Frame(frames[0].y.shape[1], frames[0].y.shape[0])
    refs = [frames[s] for s in slots] + [zero] * (R - len(slots))
    ry, rcb, rcr = pool_from_frames(refs, range(R), dev)
    slot_r = np.where(plan.slot >= 0, remap[np.clip(plan.slot, 0, pool)],
                      -1).astype(np.int32)
    P = {k: torch.from_numpy(np.ascontiguousarray(getattr(plan, k),
                                                  np.int32)).to(dev)
         for k in host._PLAN_KEYS if k != "slot"}
    P["slot"] = torch.from_numpy(slot_r).to(dev)
    pcm = None
    if plan.pcm:
        rows = host._pcm_rows([plan], plan.n)
        pcm = _pcm_planes(torch.from_numpy(rows).to(dev), plan.mb_w,
                          plan.mb_h)
    has_i8, deblock = _plan_flags(plan.kind, plan.t8x8, plan.deb_str,
                                  plan.deb_str4)
    P["res_y"], P["res_c"] = _residuals(P, has_i8)
    y, cb, cr = _recon_core(P, ry[None], rcb[None], rcr[None], pcm,
                            mb_w=plan.mb_w, mb_h=plan.mb_h, has_i8=has_i8,
                            deblock=deblock)
    f = frames[plan.cur_idx]
    f.y[:] = y[0].cpu().numpy()
    f.cb[:] = cb[0].cpu().numpy()
    f.cr[:] = cr[0].cpu().numpy()


def _recon_batch(pool_y, pool_cb, pool_cr, stacked, cur_idx, *, mb_w, mb_h,
                 has_i8, deblock, extra=None):
    """N pictures of each of G GOPs on one device, each GOP with its own
    frame pool: the counterpart of the JAX package's ``_recon_batch``
    vmapped over G (the device side of ``parallel.mesh``'s GOP steps).

    pools [G, P, H, W] (cb, cr [G, P, H/2, W/2]) uint8 tensors, written
    in place; stacked: dense int32 plan tensors [G, N, ...] under
    ``_PLAN_KEYS`` on the pools' device, optionally with the dense-MC
    aux mc_used [G, N, K] and mc_bi [G, N, Bb] of plans whose slots are
    remapped to them (as ``MultiStreamPhaseB`` sends them); cur_idx
    [G, N] (host ints < P): the slot each picture writes. extra:
    optional (y, cb, cr) [G, E, H, W] external reference pages that
    plans address as slots P..P+E-1; pictures write only the local
    slots. The residuals run once for the batch; then per picture step
    one ``_recon_core`` over the G GOPs (one launch per wavefront pass
    for all of them) and the pool write. Returns (pools, outs), outs
    (y, cb, cr) [G, N, H, W] in decode order."""
    pools = (pool_y, pool_cb, pool_cr)
    cur_np = np.asarray(cur_idx)
    G, N = cur_np.shape
    Psz = pool_y.shape[1]
    if cur_np.size and not (0 <= cur_np.min() and cur_np.max() < Psz):
        raise ValueError(f"cur_idx must lie in the local pool 0..{Psz - 1}")
    dev = pool_y.device
    cur = (torch.from_numpy(cur_np.astype(np.int64)).to(dev)
           + torch.arange(G, device=dev)[:, None] * Psz)
    res_y, res_c = _residuals(stacked, has_i8)
    n = mb_w * mb_h
    keys = [k for k in host._PLAN_KEYS
            if k not in ("coef_luma", "coef_chroma")]
    outs = tuple(torch.empty((G, N) + p.shape[2:], dtype=p.dtype, device=dev)
                 for p in pools)
    for b in range(N):
        P = {k: stacked[k][:, b].reshape((G * n,) + stacked[k].shape[3:])
             for k in keys}
        P["res_y"] = res_y[:, b].reshape(G * n, 16, 16)
        P["res_c"] = res_c[:, b].reshape(G * n, 2, 8, 8)
        P.update({k: stacked[k][:, b] for k in ("mc_used", "mc_bi")
                  if k in stacked})
        refs = (pools if extra is None else
                tuple(torch.cat([p, e], 1) for p, e in zip(pools, extra)))
        planes = _recon_core(P, *refs, None, mb_w=mb_w, mb_h=mb_h,
                             has_i8=has_i8, deblock=deblock)
        for pool, out, v in zip(pools, outs, planes):
            pool.view((-1,) + pool.shape[2:]).index_copy_(0, cur[:, b], v)
            out[:, b] = v
    return pools, outs


# =====================================================================
# wire unpack (device side of the packed plan blob)
# =====================================================================

#: trailing shapes of palette-compressed fields
_PAL_TAIL = {"mv": (2, 2), "wp": (3, 4), "deb_ab": (2, 6, 2)}

_TORCH_DT = {"uint8": torch.uint8, "int8": torch.int8,
             "int16": torch.int16, "uint16": torch.int16,
             "int32": torch.int32}


def _device_views(buf, layout):
    """Typed per-field views [S, ...] of a device byte buffer [S, total]
    that holds S streams' rows of one layout (the JAX package's
    _wire_views layout; uint16 fields are viewed as int16 and masked).
    Returns {key: tensor | {sub: tensor}}."""
    S = buf.shape[0]
    out = {}
    for path, dtname, shape, off, nb in layout:
        arr = (buf[:, off : off + nb].view(_TORCH_DT[dtname])
               .reshape((S,) + tuple(shape)))
        if dtname == "uint16":
            arr = (arr.to(I32) & 0xFFFF)
        if len(path) == 1:
            out[path[0]] = arr
        else:
            out.setdefault(path[0], {})[path[1]] = arr
    return out


def _unpack_wire(fields, pals):
    """Typed wire fields with leading dims (B, S) -> dense int32 plan
    tensors [B, S, n, ...]: palette rows expanded (pals [S, rows, w],
    each stream's own), sparse coefficient bitmaps scattered."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, dict) and "idx" in v:
            pal = pals[k].to(I32)
            S, rows = pal.shape[:2]
            idx = v["idx"].long()
            soff = torch.arange(S, device=idx.device).reshape(
                (1, S) + (1,) * (idx.dim() - 2)) * rows
            out[k] = pal.reshape(S * rows, -1)[idx + soff].reshape(
                idx.shape + _PAL_TAIL[k])
            continue
        if isinstance(v, dict):
            bits8 = v["bits"].to(I32)
            shifts = torch.arange(7, -1, -1, dtype=I32, device=bits8.device)
            bits = ((bits8[..., None] >> shifts) & 1).reshape(
                bits8.shape[:-1] + (-1,))
            idx = torch.cumsum(bits, dim=-1) - 1
            vals = v["vals"].to(I32)
            dense = torch.gather(
                vals, -1, idx.clamp(0, vals.shape[-1] - 1)) * bits
            m = bits.shape[-1]
            shape = ((m // 256, 256) if k == "coef_luma"
                     else (m // 128, 2, 4, 16))
            out[k] = dense.reshape(bits.shape[:-1] + shape)
        else:
            out[k] = v.to(I32)
    return out


def _unpack_batch(dbuf, layout, has_i8, mb_w, mb_h, pool_size):
    """The stages of a batch that read no reference frame, once for all
    its pictures and streams: the device buffer [S, total] (see
    ``_stack_fields``) -> (P, pcm, cur). P: the plan tensors of picture
    step b at P[k][b], [S*n, ...] stream-major, with the residuals and
    the dense-MC aux mc_used [S,K] / mc_bi [S,Bb]; pcm: None or the PCM
    planes (y, cb, cr) [B,S,H,W]; cur: [B,S] each picture's slot in the
    flat [S*pool_size] pool."""
    S = dbuf.shape[0]

    def picture_major(v):
        return ({s: a.transpose(0, 1) for s, a in v.items()}
                if isinstance(v, dict) else v.transpose(0, 1))

    views = _device_views(dbuf, layout)
    pals = {k[4:]: views.pop(k) for k in list(views) if k.startswith("pal_")}
    pcm_rows = views.pop("pcm", None)
    cur = views.pop("cur").transpose(0, 1).long()
    cur = cur + torch.arange(S, device=cur.device) * pool_size
    aux = {k: views.pop(k).transpose(0, 1) for k in ("mc_used", "mc_bi")}
    dense = _unpack_wire({k: picture_major(v) for k, v in views.items()},
                         pals)
    dense["res_y"], dense["res_c"] = _residuals(dense, has_i8)
    del dense["coef_luma"], dense["coef_chroma"]
    B = cur.shape[0]
    P = {k: v.reshape((B, -1) + v.shape[3:]) for k, v in dense.items()}
    P.update(aux)
    pcm = None
    if pcm_rows is not None:
        pcm = tuple(p.reshape((B, S) + p.shape[1:]) for p in _pcm_planes(
            pcm_rows.transpose(0, 1), mb_w, mb_h))
    return P, pcm, cur


# =====================================================================
# multi-stream Phase B with device-resident frame pools
# =====================================================================


def _stack_fields(blobs, layout, extras, pin):
    """S streams' wire blobs (one layout) and their extra host arrays
    (the same names, shapes and dtypes in every stream) in ONE host
    buffer [S, total]: row s is stream s's blob, then its extras, each
    8-byte aligned, so the whole batch rides one host->device copy. pin:
    allocate it pinned. Returns (buffer, layout of a row)."""
    lay = list(layout)
    total = blobs[0].nbytes
    for name, a in extras[0].items():
        total = (total + 7) & ~7
        lay.append(((name,), a.dtype.name, a.shape, total, a.nbytes))
        total += a.nbytes
    total = (total + 7) & ~7
    buf = torch.empty((len(blobs), total), dtype=torch.uint8,
                      pin_memory=pin)
    rows = buf.numpy()
    for s, (blob, ex) in enumerate(zip(blobs, extras)):
        rows[s, : blob.nbytes] = blob
        for (_, _, _, off, nb), a in zip(lay[len(layout):], ex.values()):
            rows[s, off : off + nb] = np.ascontiguousarray(a).view(
                np.uint8).reshape(-1)
    return buf, tuple(lay)


class MultiStreamPhaseB:
    """S independent streams decoded together on one device, the stacked
    counterpart of the JAX package's ``MultiStreamPhaseB``: one
    [S, pool_size, H, W] frame pool per plane, one ``_DevSlotMap`` per
    stream, and each picture step of all S streams as one set of torch
    ops and one launch per wavefront pass.

    A batch (``run``) takes S plan lists of equal length, of any Phase
    A (the native packer derives the coded map of a plan of the Python
    decoder, which has none): the host packs all S into one buffer,
    copied to the device once (pinned on CUDA); wire unpack and the
    residual iDCT run once for the batch; then per picture step MC,
    assembly, the PCM select, the four passes and the pool write.
    ``wavefronts`` selects the intra+deblock pass (``run_wavefronts``:
    the kernels on CUDA). device=None is the CUDA device (raises without
    one)."""

    def __init__(self, n_streams, mb_w, mb_h, pool_size, device=None,
                 wavefronts=run_wavefronts):
        self.device = resolve_device(device)
        self.n = n_streams
        self.mb_w, self.mb_h = mb_w, mb_h
        self.pool_size = pool_size
        self.wavefronts = wavefronts
        H, W = mb_h * 16, mb_w * 16
        self.pool = tuple(
            torch.zeros((n_streams, pool_size, h, w), dtype=torch.uint8,
                        device=self.device)
            for h, w in ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1)))
        self.smaps = [host._DevSlotMap(pool_size) for _ in range(n_streams)]

    def reset(self):
        """Start every stream's pool over (zeros, no slot mapped)."""
        for p in self.pool:
            p.zero_()
        for m in self.smaps:
            m.reset()

    def _host_batch(self, plans_per_stream):
        """Pack a batch on the host (``_stack_fields``): per stream its
        wire blob with remapped slots, dense-MC aux, device slots,
        palettes and (if any stream has one) PCM rows. Returns (buffer,
        layout, has_i8, deblock), the flags ORed over all streams."""
        if (len(plans_per_stream) != self.n
                or len({len(p) for p in plans_per_stream}) != 1):
            raise ValueError(f"want {self.n} plan lists of one length, got "
                             f"{[len(p) for p in plans_per_stream]}")
        blobs, layout, pals_list, has_i8, deblock = pack_batches(
            plans_per_stream)
        fields = [host._wire_views(b, layout) for b in blobs]
        cur = np.zeros((self.n, len(plans_per_stream[0])), np.int32)
        for s, plans in enumerate(plans_per_stream):
            host._remap_batch(fields[s]["slot"], cur[s], plans,
                              self.smaps[s])
        auxs = host._derive_mc_aux([f["slot"] for f in fields],
                                   self.pool_size, self.mb_w, self.mb_h)
        pcm = any(p.pcm for plans in plans_per_stream for p in plans)
        extras = []
        for s, plans in enumerate(plans_per_stream):
            ex = {"mc_used": auxs[s][0], "mc_bi": auxs[s][1], "cur": cur[s]}
            ex.update({"pal_" + k: v for k, v in pals_list[s].items()})
            if pcm:
                ex["pcm"] = host._pcm_rows(plans, self.mb_w * self.mb_h)
            extras.append(ex)
        buf, layout = _stack_fields(blobs, layout, extras,
                                    self.device.type == "cuda")
        return buf, layout, has_i8, deblock

    def _upload(self, buf):
        """The batch's one host->device copy."""
        with trace.span("batch.upload"):
            trace.count("upload_bytes", buf.nbytes)
            return buf.to(self.device, non_blocking=True)

    def _store(self, b, cur, planes, outs):
        """Picture step b's planes [S,H,W] into each stream's pool slot
        (cur [S], flat pool indices) and into outs [B,S,H,W]."""
        for pool, out, v in zip(self.pool, outs, planes):
            pool.view((-1,) + pool.shape[2:]).index_copy_(0, cur, v)
            out[b] = v

    def run(self, plans_per_stream):
        """Dispatch one batch: S lists of plans in decode order, one
        length. Returns per stream its (y [B,H,W], cb, cr) uint8 device
        stacks in decode order, without synchronising."""
        with trace.span("batch.pack"):
            buf, layout, has_i8, deblock = self._host_batch(
                plans_per_stream)
        dbuf = self._upload(buf)
        with trace.span("batch.unpack"):
            P, pcm, cur = _unpack_batch(dbuf, layout, has_i8, self.mb_w,
                                        self.mb_h, self.pool_size)
        B = cur.shape[0]
        outs = tuple(torch.empty((B,) + p.shape[:1] + p.shape[2:],
                                 dtype=p.dtype, device=self.device)
                     for p in self.pool)
        for b in range(B):
            with trace.span("step"):
                planes = _recon_core(
                    {k: v[b] for k, v in P.items()}, *self.pool,
                    None if pcm is None else tuple(p[b] for p in pcm),
                    mb_w=self.mb_w, mb_h=self.mb_h, has_i8=has_i8,
                    deblock=deblock, wavefronts=self.wavefronts)
                with trace.span("step.store"):
                    self._store(b, cur[b], planes, outs)
        return [tuple(o[:, s] for o in outs) for s in range(self.n)]

    @staticmethod
    def checksums(outs):
        """Per-stream checksums of ``run``'s outputs: int32 [S, 3, 2],
        row s over stream s's whole picture stack as one flat unit
        (``golden.stack_checksum``, equal to ``golden.host_checksum``).
        Waits for the device; only these numbers leave it."""
        return np.stack([stack_checksum(*o).cpu().numpy() for o in outs])


class BatchedPhaseB(MultiStreamPhaseB):
    """One stream: a device-resident frame pool and a batched
    multi-picture Phase B (``MultiStreamPhaseB`` with S = 1).

    Feed plans in decode order; their host frame indexes are translated
    into the compact device slot space by _DevSlotMap
    (``plan_host``)."""

    def __init__(self, mb_w, mb_h, pool_size, device=None,
                 wavefronts=run_wavefronts):
        super().__init__(1, mb_w, mb_h, pool_size, device=device,
                         wavefronts=wavefronts)

    def run_async(self, plans):
        """Dispatch a batch; returns (y [N,H,W], cb, cr) uint8 device
        tensors without synchronising."""
        return self.run([plans])[0]
