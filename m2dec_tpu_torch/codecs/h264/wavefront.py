"""Plain PyTorch version of the intra and deblocking wavefronts.

The counterpart of ``m2dec_tpu/codecs/h264/wavefront.py`` (the XLA scans
that the JAX package runs by default, and the spec its Pallas kernels
are tested against). Pictures are stored SKEWED: MB (mbx, mby) lives at
column block d = mbx + 2*mby of a wide plane, so one anti-diagonal —
and everything it reads — is one contiguous slab. Each scan is a Python
loop over the nd diagonals; every step slices its slab, runs the mode
or filter math for all MBs of the diagonal at once and writes the slab
back IN PLACE into the skewed plane (the scans own the skewed planes
they are given).

The four passes are separate functions (intra luma, intra chroma,
deblock luma, deblock chroma) so each can be held against its CUDA
kernel in ``wavefront_kernels``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .plan_host import _ZORDER
from .state import device_tables

I32 = torch.int32

#: bottom margins are 8 larger than strictly needed by the scan windows:
#: the Pallas kernels load slabs from 8-aligned row bases (8 rows above
#: the window) and read 8 rows past it
ML, MR, MT, MB_ = 48, 64, 16, 24       # luma margins
MLC, MRC, MTC, MBC = 24, 16, 8, 16     # chroma margins


@functools.lru_cache(maxsize=32)
def get_geom(mb_w, mb_h):
    """Host-side skew geometry for one picture shape."""
    nd = mb_w + 2 * mb_h - 2
    n = mb_w * mb_h
    mbymin = np.maximum(0, -(-(np.arange(nd) - mb_w + 1) // 2))
    mbymax = np.minimum(mb_h - 1, np.arange(nd) // 2)
    lmax = int((mbymax - mbymin + 1).max())
    mby0 = np.minimum(mbymin, mb_h - lmax + 1).astype(np.int32)
    lanes = mby0[:, None] + np.arange(lmax)[None, :]   # [nd, L] mby
    mbx = np.arange(nd)[:, None] - 2 * lanes
    valid = (mbx >= 0) & (mbx < mb_w) & (lanes < mb_h)
    lane2mb = np.where(valid, lanes * mb_w + mbx, n).astype(np.int32)
    # skew/unskew tile index tables
    dblk = np.arange(nd)[None, :]
    mbyv = np.arange(mb_h)[:, None]
    sx = dblk - 2 * mbyv
    gidx = np.where((sx >= 0) & (sx < mb_w), mbyv * mb_w + sx,
                    n).astype(np.int32)                 # [mb_h, nd]
    uidx = (np.arange(mb_w)[None, :]
            + 2 * np.arange(mb_h)[:, None]).astype(np.int32)  # [mb_h,mb_w]
    d = np.arange(nd, dtype=np.int32)
    bases = {
        # intra slabs: [Lmax*16+1, 57] luma / [Lmax*8+1, 25] chroma
        "irY": mby0 * 16 + (MT - 1), "icY": d * 16 + (ML - 33),
        "irC": mby0 * 8 + (MTC - 1), "icC": d * 8 + (MLC - 17),
        # deblock own slabs: [Lmax*16, 20] luma / [Lmax*8, 10] chroma
        "orY": mby0 * 16 + MT, "ocY": d * 16 + (ML - 4),
        "orC": mby0 * 8 + MTC, "occ": d * 8 + (MLC - 2),
        # deblock top slabs: [Lmax*16, 16] luma / [Lmax*8, 8] chroma
        "trY": mby0 * 16, "tcY": d * 16 + (ML - 32),
        "trC": mby0 * 8, "tcC": d * 8 + (MLC - 16),
    }
    return {"nd": nd, "lmax": lmax, "lane2mb": lane2mb, "gidx": gidx,
            "uidx": uidx, "mb_h": mb_h,
            "bases": {k: v.astype(np.int32)
                      for k, v in bases.items()}}

INTRA_LUMA_KEYS = ("kind", "res_y", "i4_modes", "i4_avail", "i16_mode",
                   "mb_avail")
I8_KEYS = ("i8_modes", "i8_avail")
INTRA_CHROMA_KEYS = ("kind", "res_c", "chroma_mode", "mb_avail")
DEB_KEYS = ("deb_str", "deb_str4", "deb_ab")


# ---------------------------------------------------------------------
# skew / unskew (tile-granular gathers; dead cells zero)
# ---------------------------------------------------------------------


def skew_plane(plane, gidx, blk, margins):
    """[H, W] -> skewed [mt + H + mb, ml + nd*blk + mr]."""
    mt, mb_, ml, mr = margins
    mb_h, nd = gidx.shape
    H, W = plane.shape
    tiles = (plane.reshape(mb_h, blk, W // blk, blk).permute(0, 2, 1, 3)
             .reshape(-1, blk, blk))
    tiles = torch.cat([tiles, tiles.new_zeros((1, blk, blk))])
    g = torch.as_tensor(gidx.reshape(-1), dtype=torch.long,
                        device=plane.device)
    sk = (tiles[g].reshape(mb_h, nd, blk, blk).permute(0, 2, 1, 3)
          .reshape(mb_h * blk, nd * blk))
    return F.pad(sk, (ml, mr, mt, mb_))


def unskew_plane(sk, uidx, blk, margins):
    """Inverse of skew_plane -> [H, W]."""
    mt, mb_, ml, mr = margins
    mb_h, mb_w = uidx.shape
    core = sk[mt : mt + mb_h * blk, ml : sk.shape[1] - mr]
    nd = core.shape[1] // blk
    tiles = core.reshape(mb_h, blk, nd, blk).permute(0, 2, 1, 3)
    rows = torch.arange(mb_h, device=sk.device)[:, None]
    cols = torch.as_tensor(uidx, dtype=torch.long, device=sk.device)
    out = tiles[rows, cols]  # [mb_h, mb_w, blk, blk]
    return out.permute(0, 2, 1, 3).reshape(mb_h * blk, mb_w * blk)


def skew_luma(plane, g):
    return skew_plane(plane, g["gidx"], 16, (MT, MB_, ML, MR))


def skew_chroma(plane, g):
    return skew_plane(plane, g["gidx"], 8, (MTC, MBC, MLC, MRC))


def unskew_luma(sk, g):
    return unskew_plane(sk, g["uidx"], 16, (MT, MB_, ML, MR))


def unskew_chroma(sk, g):
    return unskew_plane(sk, g["uidx"], 8, (MTC, MBC, MLC, MRC))


# ---------------------------------------------------------------------
# diagonal-major metadata
# ---------------------------------------------------------------------


def diag_gather(P, g, keys):
    """Gather per-MB plan tensors into diagonal-major [nd, Lmax, ...]
    (invalid lanes -> an appended zero row: kind 0 skips intra writes,
    zero deblock strengths skip filtering)."""
    tab = g["lane2mb"]
    out = {}
    for k in keys:
        v = P[k]
        idx = torch.as_tensor(tab.reshape(-1), dtype=torch.long,
                              device=v.device)
        ext = torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])
        out[k] = ext[idx].reshape(tab.shape + tuple(v.shape[1:]))
    return out


# ---------------------------------------------------------------------
# window assembly from slabs
# ---------------------------------------------------------------------


def _slab_windows(slab, lmax, rows):
    """[Lmax*rows+1, C] slab -> [Lmax, rows+1, C] per-lane windows
    (window row 0 = the row above the lane's tile; adjacent windows
    share that row)."""
    idx = (torch.arange(lmax, device=slab.device)[:, None] * rows
           + torch.arange(rows + 1, device=slab.device)[None, :])
    return slab[idx]


def intra_windows_luma(slab, lmax):
    """[Lmax*16+1, 57] -> Ty [Lmax, 17, 25] (row 0: corner + top +
    top-right; rows 1..16: left + tile + 8 columns of the right MB)."""
    win = _slab_windows(slab, lmax, 16)
    return torch.cat([win[:, 0:1, 0:25], win[:, 1:17, 32:57]], dim=1)


def intra_windows_chroma(slab, lmax):
    """[Lmax*8+1, 25] -> Tc [Lmax, 9, 9]."""
    win = _slab_windows(slab, lmax, 8)
    return torch.cat([win[:, 0:1, 0:9], win[:, 1:9, 16:25]], dim=1)


# ---------------------------------------------------------------------
# per-diagonal math on assembled windows
# ---------------------------------------------------------------------


def intra_luma_compute(Ty, P, has_i8, tabs):
    """Ty [L,17,25], P fields [L, ...] -> (tile [L,16,16], is_intra)."""
    from .reconstruct import intra4_modes, intra8_modes, intra16_modes

    kind = P["kind"]
    res = P["res_y"]
    T4 = Ty.clone()
    i4m = P["i4_modes"]
    i4a = P["i4_avail"]
    for oy, ox in _ZORDER:
        blk = (oy >> 2) * 4 + (ox >> 2)
        out = intra4_modes(T4[:, 1 + oy : 5 + oy, ox],
                           T4[:, oy, 1 + ox : 9 + ox], T4[:, oy, ox],
                           i4a[:, blk], i4m[:, blk], tabs["i4_mat"])
        T4[:, 1 + oy : 5 + oy, 1 + ox : 5 + ox] = (
            out + res[:, oy : oy + 4, ox : ox + 4]).clamp(0, 255)
    tile = T4[:, 1:17, 1:17]

    if has_i8:
        i8m = P["i8_modes"]
        i8a = P["i8_avail"]
        T8 = Ty.clone()
        for b in range(4):
            oy, ox = (b >> 1) * 8, (b & 1) * 8
            out = intra8_modes(T8[:, oy, 1 + ox : 9 + ox],
                               T8[:, 1 + oy : 9 + oy, ox], T8[:, oy, ox],
                               T8[:, oy, 9 + ox : 17 + ox], i8a[:, b],
                               i8m[:, b], tabs["i8_mat"])
            T8[:, 1 + oy : 9 + oy, 1 + ox : 9 + ox] = (
                out + res[:, oy : oy + 8, ox : ox + 8]).clamp(0, 255)
        tile = torch.where((kind == 2)[:, None, None], T8[:, 1:17, 1:17],
                           tile)

    out16 = (intra16_modes(Ty[:, 1:17, 0], Ty[:, 0, 1:17], Ty[:, 0, 0],
                           P["mb_avail"], P["i16_mode"]) + res).clamp(0, 255)
    tile = torch.where((kind == 3)[:, None, None], out16, tile)
    return tile, (kind >= 1) & (kind <= 3)


def intra_chroma_compute(Tcb, Tcr, P):
    """Chroma intra on [L,9,9] windows -> (cb, cr) [L,8,8]."""
    from .reconstruct import intra_chroma_modes

    outs = []
    for ci, Tc in enumerate((Tcb, Tcr)):
        pred = intra_chroma_modes(Tc[:, 1:9, 0], Tc[:, 0, 1:9], Tc[:, 0, 0],
                                  P["mb_avail"], P["chroma_mode"])
        outs.append((pred + P["res_c"][:, ci]).clamp(0, 255))
    return outs[0], outs[1]


def deblock_luma_compute(Wy, P, tabs):
    """Luma edge loops on [L,20,20] windows in the reference order: per
    MB all four vertical edges, then all four horizontal edges."""
    from .reconstruct import _edge_params, _filter_lines_luma

    Wy = Wy.clone()
    dstr, dab, d4 = P["deb_str"], P["deb_ab"], P["deb_str4"]
    for axis in (0, 1):
        sb = dstr[:, axis]
        ab = dab[:, axis]
        zero = torch.zeros_like(d4[:, axis])
        for e in range(4):
            s, al, be, tc0 = _edge_params(
                sb[:, e], d4[:, axis] if e == 0 else zero,
                ab[:, 0] if e == 0 else ab[:, 3], 16, 2, tabs["alpha"],
                tabs["beta"], tabs["tc0"])
            c0 = 4 * e
            if axis == 0:
                Wy[:, 4:20, c0 : c0 + 8] = _filter_lines_luma(
                    Wy[:, 4:20, c0 : c0 + 8], s, al, be, tc0)
            else:
                out = _filter_lines_luma(
                    Wy[:, c0 : c0 + 8, 4:20].transpose(1, 2), s, al, be,
                    tc0)
                Wy[:, c0 : c0 + 8, 4:20] = out.transpose(1, 2)
    return Wy


def deblock_chroma_compute(Wcb, Wcr, P, tabs):
    """Chroma edge loops (edges 0 and 2 per axis) on [L,12,12] windows."""
    from .reconstruct import _edge_params, _filter_lines_chroma

    Ws = [Wcb.clone(), Wcr.clone()]
    dstr, dab, d4 = P["deb_str"], P["deb_ab"], P["deb_str4"]
    for axis in (0, 1):
        sb = dstr[:, axis]
        ab = dab[:, axis]
        zero = torch.zeros_like(d4[:, axis])
        for e in (0, 2):
            abrow = 1 if e == 0 else 4
            for ci in range(2):
                Wc = Ws[ci]
                s, al, be, tc0 = _edge_params(
                    sb[:, e], d4[:, axis] if e == 0 else zero,
                    ab[:, abrow + ci], 8, 1, tabs["alpha"], tabs["beta"],
                    tabs["tc0"])
                cc0 = 2 + 4 * (e >> 1)
                if axis == 0:
                    Wc[:, 4:12, cc0 : cc0 + 4] = _filter_lines_chroma(
                        Wc[:, 4:12, cc0 : cc0 + 4], s, al, be, tc0)
                else:
                    out = _filter_lines_chroma(
                        Wc[:, cc0 : cc0 + 4, 4:12].transpose(1, 2), s, al,
                        be, tc0)
                    Wc[:, cc0 : cc0 + 4, 4:12] = out.transpose(1, 2)
    return Ws[0], Ws[1]


# ---------------------------------------------------------------------
# scans over the diagonals (in place on skewed planes)
# ---------------------------------------------------------------------


def _step_P(Pd, d):
    return {k: v[d] for k, v in Pd.items()}


def intra_luma_scan(sky, Pd, g, has_i8, tabs):
    """Intra luma wavefront over a skewed luma plane, in place."""
    b, L = g["bases"], g["lmax"]
    for d in range(g["nd"]):
        r0, c0 = int(b["irY"][d]), int(b["icY"][d])
        Ty = intra_windows_luma(
            sky[r0 : r0 + L * 16 + 1, c0 : c0 + 57].to(I32), L)
        tile, is_intra = intra_luma_compute(Ty, _step_P(Pd, d), has_i8,
                                            tabs)
        tile = torch.where(is_intra[:, None, None], tile, Ty[:, 1:17, 1:17])
        sky[r0 + 1 : r0 + 1 + L * 16, c0 + 33 : c0 + 49] = (
            tile.reshape(L * 16, 16).to(sky.dtype))
    return sky


def intra_chroma_scan(skcb, skcr, Pd, g):
    """Intra chroma wavefront over skewed cb/cr planes, in place."""
    b, L = g["bases"], g["lmax"]
    for d in range(g["nd"]):
        r0, c0 = int(b["irC"][d]), int(b["icC"][d])
        Tcb = intra_windows_chroma(
            skcb[r0 : r0 + L * 8 + 1, c0 : c0 + 25].to(I32), L)
        Tcr = intra_windows_chroma(
            skcr[r0 : r0 + L * 8 + 1, c0 : c0 + 25].to(I32), L)
        P = _step_P(Pd, d)
        ocb, ocr = intra_chroma_compute(Tcb, Tcr, P)
        is_intra = ((P["kind"] >= 1) & (P["kind"] <= 3))[:, None, None]
        for sk, out, Tc in ((skcb, ocb, Tcb), (skcr, ocr, Tcr)):
            out = torch.where(is_intra, out, Tc[:, 1:9, 1:9])
            sk[r0 + 1 : r0 + 1 + L * 8, c0 + 17 : c0 + 25] = (
                out.reshape(L * 8, 8).to(sk.dtype))
    return skcb, skcr


def deblock_luma_scan(sky, Pd, g, tabs):
    """Deblocking luma wavefront over a skewed plane, in place: the own
    slab (left strip + tile) and the top MB's slab per diagonal."""
    b, L = g["bases"], g["lmax"]
    for d in range(g["nd"]):
        orow, ocol = int(b["orY"][d]), int(b["ocY"][d])
        trow, tcol = int(b["trY"][d]), int(b["tcY"][d])
        own = sky[orow : orow + L * 16, ocol : ocol + 20].to(I32)
        top = sky[trow : trow + L * 16, tcol : tcol + 16].to(I32)
        ownr = own.reshape(L, 16, 20)
        topr = top.reshape(L, 16, 16)
        hdr = torch.cat([topr.new_zeros((L, 4, 4)), topr[:, 12:16]], dim=2)
        Wy = deblock_luma_compute(torch.cat([hdr, ownr], dim=1),
                                  _step_P(Pd, d), tabs)
        sky[orow : orow + L * 16, ocol : ocol + 20] = (
            Wy[:, 4:20].reshape(L * 16, 20).to(sky.dtype))
        topr = topr.clone()
        topr[:, 12:16] = Wy[:, 0:4, 4:20]
        sky[trow : trow + L * 16, tcol : tcol + 16] = (
            topr.reshape(L * 16, 16).to(sky.dtype))
    return sky


def deblock_chroma_scan(skcb, skcr, Pd, g, tabs):
    """Deblocking chroma wavefront over skewed cb/cr planes, in place."""
    b, L = g["bases"], g["lmax"]

    def window(sk, orow, ocol, trow, tcol):
        ownr = sk[orow : orow + L * 8, ocol : ocol + 10].to(I32)
        ownr = ownr.reshape(L, 8, 10)
        ownr = torch.cat([ownr.new_zeros((L, 8, 2)), ownr], dim=2)
        topr = sk[trow : trow + L * 8, tcol : tcol + 8].to(I32)
        topr = topr.reshape(L, 8, 8)
        hdr = torch.cat([topr.new_zeros((L, 2, 4)), topr[:, 6:8]], dim=2)
        hdr = torch.cat([topr.new_zeros((L, 2, 12)), hdr], dim=1)
        return torch.cat([hdr, ownr], dim=1), topr

    for d in range(g["nd"]):
        orow, ocol = int(b["orC"][d]), int(b["occ"][d])
        trow, tcol = int(b["trC"][d]), int(b["tcC"][d])
        Wcb, tcb = window(skcb, orow, ocol, trow, tcol)
        Wcr, tcr = window(skcr, orow, ocol, trow, tcol)
        Wcb, Wcr = deblock_chroma_compute(Wcb, Wcr, _step_P(Pd, d), tabs)
        for sk, wc, tp in ((skcb, Wcb, tcb), (skcr, Wcr, tcr)):
            sk[orow : orow + L * 8, ocol : ocol + 10] = (
                wc[:, 4:12, 2:12].reshape(L * 8, 10).to(sk.dtype))
            tp = tp.clone()
            tp[:, 6:8] = wc[:, 2:4, 4:12]
            sk[trow : trow + L * 8, tcol : tcol + 8] = (
                tp.reshape(L * 8, 8).to(sk.dtype))
    return skcb, skcr


# ---------------------------------------------------------------------
# the four passes on raster planes (the kernels' plain versions)
# ---------------------------------------------------------------------


def intra_luma_plain(y, P, has_i8, mb_w, mb_h):
    """Intra luma pass on a raster uint8 [H,W] plane -> new plane."""
    g = get_geom(mb_w, mb_h)
    keys = INTRA_LUMA_KEYS + (I8_KEYS if has_i8 else ())
    sky = intra_luma_scan(skew_luma(y, g), diag_gather(P, g, keys), g,
                          has_i8, device_tables(y.device))
    return unskew_luma(sky, g)


def intra_chroma_plain(cb, cr, P, mb_w, mb_h):
    """Intra chroma pass on raster uint8 planes -> new (cb, cr)."""
    g = get_geom(mb_w, mb_h)
    skcb, skcr = intra_chroma_scan(skew_chroma(cb, g), skew_chroma(cr, g),
                                   diag_gather(P, g, INTRA_CHROMA_KEYS), g)
    return unskew_chroma(skcb, g), unskew_chroma(skcr, g)


def deblock_luma_plain(y, P, mb_w, mb_h):
    """Deblocking luma pass on a raster uint8 plane -> new plane."""
    g = get_geom(mb_w, mb_h)
    sky = deblock_luma_scan(skew_luma(y, g), diag_gather(P, g, DEB_KEYS),
                            g, device_tables(y.device))
    return unskew_luma(sky, g)


def deblock_chroma_plain(cb, cr, P, mb_w, mb_h):
    """Deblocking chroma pass on raster uint8 planes -> new (cb, cr)."""
    g = get_geom(mb_w, mb_h)
    skcb, skcr = deblock_chroma_scan(
        skew_chroma(cb, g), skew_chroma(cr, g),
        diag_gather(P, g, DEB_KEYS), g, device_tables(cb.device))
    return unskew_chroma(skcb, g), unskew_chroma(skcr, g)


def run_wavefronts_plain(y, cb, cr, P, has_i8, deblock, mb_w, mb_h):
    """All four passes in their plain versions, on any device."""
    y = intra_luma_plain(y, P, has_i8, mb_w, mb_h)
    cb, cr = intra_chroma_plain(cb, cr, P, mb_w, mb_h)
    if deblock:
        y = deblock_luma_plain(y, P, mb_w, mb_h)
        cb, cr = deblock_chroma_plain(cb, cr, P, mb_w, mb_h)
    return y, cb, cr
