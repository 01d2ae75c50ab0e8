"""H.265 Phase-B reconstruction on torch tensors.

The counterpart of ``m2dec_tpu/codecs/h265/reconstruct.py``: the same
integer arithmetic, written as plain torch ops on an explicit device. It
consumes the H265Plan tensors (``plan.py``) and the frame pool and
produces the reconstructed, deblocked, SAO-filtered planes, bit-exact
with the reference decoder (reference: src/lib/h265.cpp; the Python
decoder of this package is the scalar spec it is held to):

* residual: the inverse DCT/DST of every aligned s x s tile of a size
  class as two matrix products with the reference's sat16<7>/sat16<12>
  stage saturations, variant-selected (dc-only with the byte-lane wrap,
  horizontal-only, vertical-only, full, transform skip) —
  h265.cpp:1694-2185. The products run in float64, which is exact here
  (|sum| <= 32 * 32768 * 90 < 2^27), so the CPU and the card run the
  same code;
* inter: dense per-4x4-cell MC — luma from quarter-pel phase planes of
  the picture's used reference slots (one 16-sample gather per cell),
  chroma 4-tap on emulated packed-uint64 lanes (two 32-bit lanes held in
  int64 with explicit masks, carries and borrows) replicating
  interp_chroma's borrow-bias arithmetic — h265.cpp:3386-3551;
* intra, on one of two schedules (``wf_mode_for``: tile up to CTB 16,
  level above; the ``wf_mode`` argument forces either):
  - the CTU-tile schedule: one step per CTU anti-diagonal, the CTU's
    z-order unrolled as slots; on a CUDA device one launch of the
    hand-written kernel ``csrc/h265_tile.cu`` per picture
    (``wavefront_kernels.tile_wavefront``), on the CPU its plain version
    ``_wavefront_tile_plain``;
  - the dependency-level schedule (``_schedule_levels``, host numpy
    through the native ``oplevel.cpp``) replayed as a Python loop over
    the host-known levels (``_LevelRunner``); each level applies its ops
    in two size banks, every lane (op) evaluated in parallel from
    neighbour lines gathered out of the pre-level plane, then written
    with one scatter-add of the changes. On a CUDA device each kind of
    level is one captured CUDA graph of those torch ops, replayed per
    level;
* deblocking: whole-frame vertical pass then horizontal pass, strengths
  from the plan's recorded edge maps;
* SAO: a per-pixel map over the pre-SAO plane.

Every decision the JAX graph takes on device values (the MC gate, the
loop bounds, empty banks) is taken here on the host from the numpy plan,
so no device value is read back. ``H265SeqPhaseB`` keeps the frame pool
on the device and runs a batch of pictures from one host->device copy;
on a CUDA device it replays a one-slice picture's whole step on the tile
schedule as one CUDA graph per kind of step (``_graph_key``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...device import resolve_device
from ...errors import StreamFeatureExcluded
from ...native import load_oplevel
from ...runtime import trace
from ..mpeg2.reconstruct import _upload
from . import residual as _RES
from . import wavefront_kernels as TK
from .intrapos_tables import COEF as _ACOEF
from .intrapos_tables import POS as _APOS

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8
F64 = torch.float64


def _clip255(v):
    return v.clamp(0, 255)

# =====================================================================
# transform matrices (exact integer butterflies -> matrices)
# =====================================================================


def _mk_tmat(size_log2):
    size = 1 << size_log2
    line = _RES._LINE[size_log2]
    T = np.zeros((size, size), np.int32)
    for j in range(size):
        e = [0] * size
        e[j] = 1
        T[:, j] = line(e, 1, lambda v: v)
    return T


def _mk_dmat():
    T = np.zeros((4, 4), np.int32)
    for j in range(4):
        e = [0] * 4
        e[j] = 1
        T[:, j] = _RES._dst_line(e, 1, lambda v: v)
    return T


_TMAT = {2: _mk_tmat(2), 3: _mk_tmat(3), 4: _mk_tmat(4), 5: _mk_tmat(5)}
_DMAT = _mk_dmat()


def _sat7(v):
    return ((v + 64) >> 7).clamp(-32768, 32767)


def _sat12(v):
    return ((v + 2048) >> 12).clamp(-32768, 32767)


def _mm(eq, a, b):
    """Integer einsum through float64 (exact for these magnitudes)."""
    return torch.einsum(eq, a.to(F64), b.to(F64)).to(I64)


def residual_plane(coef, tu, sizes, with_dst):
    """coef [H,W] int, tu meta [H/4,W/4] -> residual [H,W] int32.

    Replicates transform/skip_transform variant selection
    (residual.py:314-377) on sanitized coefficient tiles. ``sizes``: the
    TU sizes to evaluate (a size no TU of the plane has adds zero)."""
    H, W = coef.shape
    dev = coef.device
    res = torch.zeros((H, W), dtype=I64, device=dev)
    coef = coef.to(I64)
    tu = tu.to(I64)
    for s in sizes:
        if H % s or W % s:
            continue  # TU size exceeds the CTB (plane is CTB-aligned)
        sl2 = s.bit_length() - 1
        T = _device_tables(dev)[f"tmat{sl2}"]
        N1, N2 = H // s, W // s
        tiles = coef.reshape(N1, s, N2, s).permute(0, 2, 1, 3)
        meta = tu[:: s >> 2, :: s >> 2]
        present = (meta & 1) != 0
        match = present & (((meta >> 1) & 3) == sl2 - 2)
        variant = (meta >> 3) & 3
        # full 2-D: V = sat7(T @ C); out = sat12(V @ T^T)
        V = _sat7(_mm("ky,abyx->abkx", T, tiles))
        full = _sat12(_mm("abyk,xk->abyx", V, T))
        # dc-only with byte-lane wrap (m2d.h:307-326 semantics)
        c00 = tiles[:, :, 0, 0]
        adj = (c00 + 64) >> 7
        lane = adj.abs() & 0xFF
        dcr = torch.where(adj < 0, -lane, lane)[:, :, None, None]
        # horiz-only: pretruncated first row, one sat12 pass, rows equal
        pre = (tiles[:, :, 0, :] + 1) >> 1
        hrow = _sat12(_mm("xk,abk->abx", T, pre))
        # vert-only: sat7 column pass then (v+32)>>6, cols equal
        vcol = _sat7(_mm("yk,abk->aby", T, tiles[:, :, :, 0]))
        vcol = (vcol + 32) >> 6
        v4 = variant[:, :, None, None]
        r = torch.where(v4 == 0, dcr,
            torch.where(v4 == 1, hrow[:, :, None, :],
            torch.where(v4 == 2, vcol[:, :, :, None], full)))
        if s == 4 and with_dst:
            D = _device_tables(dev)["dmat"]
            Vd = _sat7(_mm("ky,abyx->abkx", D, tiles))
            dfull = _sat12(_mm("abyk,xk->abyx", Vd, D))
            dst = ((meta >> 5) & 1) != 0
            r = torch.where(dst[:, :, None, None], dfull, r)
        if s == 4:
            tsk = ((meta >> 6) & 1) != 0
            r = torch.where(tsk[:, :, None, None], (tiles + 16) >> 5, r)
        r = torch.where(match[:, :, None, None], r, 0)
        res = res + r.permute(0, 2, 1, 3).reshape(H, W)
    return res.to(I32)


# =====================================================================
# inter prediction: dense per-4x4-cell MC
# =====================================================================

#: 8-tap rows over offsets -3..+4 per quarter-pel phase (interp_luma
#: _fir1/_fir2/_fir3, h265.cpp:3193-3241; phase 0 = 64 at offset 0 so
#: the unified 2-pass pipeline scales every case to shift 12)
_LTAP = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)


def _edge_rows_cols(H, W, pad, device):
    """Clamped row/column indexes of a plane edge-replicated by ``pad``."""
    return (torch.arange(-pad, H + pad, device=device).clamp(0, H - 1),
            torch.arange(-pad, W + pad, device=device).clamp(0, W - 1))


def _luma_phase_planes(refs_used):
    """Full-precision quarter-pel phase planes for the used ref slots:
    [K, 16, H+16, W+16] int32, plane (fy*4+fx) holding the 2-pass 8-tap
    FIR value (scale 2^12, h265.cpp:3386-3474) at every integer base
    position in [-8, H+8) x [-8, W+8) over the edge-replicated source.
    Per-tap coordinate clamping equals the FIR on the edge-replicated
    extension, and the FIR is constant once its window is fully clamped,
    so clipping gather coordinates into the 8-pad domain is exact for
    arbitrary MVs."""
    K, H, W = refs_used.shape
    rows, cols = _edge_rows_cols(H, W, 12, refs_used.device)
    r = refs_used[:, rows][:, :, cols].to(I32)  # [K, H+24, W+24]
    hv = []
    for fx in range(4):
        acc = None
        for j in range(8):
            t = int(_LTAP[fx, j])
            if t == 0:
                continue
            term = r[:, :, 1 + j : 1 + j + W + 16] * t
            acc = term if acc is None else acc + term
        hv.append(acc)  # [K, H+24, W+16]
    planes = []
    for fy in range(4):
        for fx in range(4):
            acc = None
            for j in range(8):
                t = int(_LTAP[fy, j])
                if t == 0:
                    continue
                term = hv[fx][:, 1 + j : 1 + j + H + 16] * t
                acc = term if acc is None else acc + term
            planes.append(acc)
    return torch.stack(planes, 1)  # [K, 16, H+16, W+16]


def _luma_cell_mc_pp(planes, remap, slot, x0, y0, mvx, mvy, pic_w, pic_h):
    """[B] cells -> [B,4,4] full-precision 2-pass FIR values (scale
    2^12; uni store = (v+2048)>>12 clip, bidir lane = v>>6): one
    16-sample gather per cell from the phase planes."""
    xpos = x0 + (mvx >> 2)
    ypos = y0 + (mvy >> 2)
    ph = (mvy & 3) * 4 + (mvx & 3)
    s = remap[slot.clamp(0, remap.shape[0] - 1)]
    ar4 = torch.arange(4, device=slot.device)
    ys = (ypos[:, None] + ar4[None, :] + 8).clamp(0, pic_h + 15)
    xs_ = (xpos[:, None] + ar4[None, :] + 8).clamp(0, pic_w + 15)
    return planes[s[:, None, None], ph[:, None, None], ys[:, :, None],
                  xs_[:, None, :]]


_CTAP = np.array([
    (0, 64, 0, 0), (2, 58, 10, 2), (4, 54, 16, 2), (6, 46, 28, 4),
    (4, 36, 36, 4), (4, 28, 46, 6), (2, 16, 54, 4), (2, 10, 58, 2),
], np.int32)

_M32 = 0xFFFFFFFF
_BIAS = 0x80000000


def _s32(v):
    """A 32-bit lane (int64 in [0, 2^32)) read as int32."""
    return torch.where(v >= _BIAS, v - (1 << 32), v)


def _chroma_cell_mc(refs_cb, refs_cr, slot, cx0, cy0, mvx, mvy, cw, ch):
    """[B] cells -> (cb, cr) [B,2,2] signed lane values before the store
    shift, replicating interp_chroma's packed-uint64 arithmetic
    (h265.cpp:3475-3551) with two 32-bit lanes held in int64: every
    +, -, * and << that can leave [0, 2^32) is masked back."""
    dev = slot.device
    cxpos = cx0 + (mvx >> 3)
    cypos = cy0 + (mvy >> 3)
    ctap = _device_tables(dev)["ctap"]
    c = ctap[mvx & 7]  # [B,4]
    d = ctap[mvy & 7]
    bx = cxpos - 1
    by = cypos - 1
    ar5 = torch.arange(5, device=dev)
    ys = (by[:, None] + ar5[None, :]).clamp(0, ch - 1)
    xs = (bx[:, None] + ar5[None, :]).clamp(0, cw - 1)
    s = slot.clamp(0, refs_cb.shape[0] - 1)
    # one packed gather serves both components
    ilv = (refs_cb.to(I32) << 8) | refs_cr.to(I32)
    g = ilv[s[:, None, None], ys[:, :, None], xs[:, None, :]].to(I64)
    hi = g >> 8    # [B,5,5] cb lane
    lo = g & 0xFF  # cr lane
    lomask = 0x07FFFFFF

    # pass 1: per row r (5), sample x (2): cols x..x+3
    def pack1(x):
        lo_a = (c[:, 1, None] * lo[:, :, x + 1]
                + c[:, 2, None] * lo[:, :, x + 2])
        hi_a = (c[:, 1, None] * hi[:, :, x + 1]
                + c[:, 2, None] * hi[:, :, x + 2])
        lo_b = (c[:, 0, None] * lo[:, :, x]
                + c[:, 3, None] * lo[:, :, x + 3])
        hi_b = (c[:, 0, None] * hi[:, :, x]
                + c[:, 3, None] * hi[:, :, x + 3])
        lo_r = (lo_a | _BIAS) - lo_b  # no borrow possible
        hi_r = (hi_a - hi_b) & _M32
        return hi_r, lo_r & lomask  # [B,5]

    p1 = [pack1(x) for x in range(2)]
    h_hi = torch.stack([p1[0][0], p1[1][0]], -1)  # [B,5,2]
    h_lo = torch.stack([p1[0][1], p1[1][1]], -1)

    # pass 2: per output y (2): rows y..y+3; lo < 2^27, d < 128: exact
    # lo->hi carry via a 16-bit split of the lo lane
    def mulsum(dk0, h0, dk1, h1):
        hi0, lo0 = h0
        hi1, lo1 = h1
        uu = dk0[:, None] * (lo0 >> 16) + dk1[:, None] * (lo1 >> 16)
        vv = dk0[:, None] * (lo0 & 0xFFFF) + dk1[:, None] * (lo1 & 0xFFFF)
        lo_s = ((uu << 16) + vv) & _M32
        carry = (uu + (vv >> 16)) >> 16
        hi_s = (dk0[:, None] * hi0 + dk1[:, None] * hi1 + carry) & _M32
        return hi_s, lo_s

    outs = []
    for y in range(2):
        hA, lA = mulsum(d[:, 1], (h_hi[:, y + 1], h_lo[:, y + 1]),
                        d[:, 2], (h_hi[:, y + 2], h_lo[:, y + 2]))
        hB, lB = mulsum(d[:, 0], (h_hi[:, y], h_lo[:, y]),
                        d[:, 3], (h_hi[:, y + 3], h_lo[:, y + 3]))
        lA = lA | _BIAS
        borrow = (lA < lB).to(I64)
        wv_lo = (lA - lB) & _M32
        wv_hi = (hA - hB - borrow) & _M32
        outs.append((_s32(wv_hi), _s32(wv_lo ^ _BIAS)))
    cb = torch.stack([outs[0][0], outs[1][0]], 1).to(I32)  # [B,2,2]
    cr = torch.stack([outs[0][1], outs[1][1]], 1).to(I32)
    return cb, cr


def inter_pass(slot, mv, pool_y, pool_cb, pool_cr, pic_w, pic_h, mc_used,
               mc_remap):
    """Dense whole-picture MC from the plan's per-cell slot/mv tensors.

    Returns (mask_cell [ch,cw] bool, mc_y [H,W], mc_cb/[Hc,Wc], mc_cr)
    with mc values already store-rounded+clipped (store_pix semantics,
    h265.cpp:3161-3178). mc_used [K] / mc_remap [16] (host-derived per
    picture): the used ref slots and slot -> index; luma prediction
    reads the quarter-pel phase planes built for just those slots."""
    ch, cw = slot.shape[:2]
    B = ch * cw
    dev = slot.device
    cell = torch.arange(B, dtype=I64, device=dev)
    x0 = (cell % cw) * 4
    y0 = (cell // cw) * 4
    s0 = slot[:, :, 0].reshape(B).to(I64)
    s1 = slot[:, :, 1].reshape(B).to(I64)
    mvf = mv.reshape(B, 2, 2).to(I64)
    both = (s0 >= 0) & (s1 >= 0)
    p0s = torch.where(s0 >= 0, s0, s1)
    p0mv = torch.where((s0 >= 0)[:, None], mvf[:, 0], mvf[:, 1])
    p1s = torch.where(both, s1, p0s)
    p1mv = torch.where(both[:, None], mvf[:, 1], p0mv)
    planes = _luma_phase_planes(pool_y[mc_used, :pic_h, :pic_w])
    remap = mc_remap.to(I64)

    def one(sl, mvv):
        ly = _luma_cell_mc_pp(planes, remap, sl, x0, y0, mvv[:, 0],
                              mvv[:, 1], pic_w, pic_h)
        cb, cr = _chroma_cell_mc(pool_cb, pool_cr, sl, x0 >> 1, y0 >> 1,
                                 mvv[:, 0], mvv[:, 1], pic_w >> 1,
                                 pic_h >> 1)
        return ly, cb, cr

    y_a, cb_a, cr_a = one(p0s, p0mv)
    y_b, cb_b, cr_b = one(p1s, p1mv)
    both3 = both[:, None, None]

    def store(a, b):
        uni = _clip255((a + 2048) >> 12)
        bi = _clip255(((a >> 6) + (b >> 6) + 64) >> 7)
        return torch.where(both3, bi, uni)

    out_y = store(y_a, y_b)        # [B,4,4]
    out_cb = store(cb_a, cb_b)     # [B,2,2]
    out_cr = store(cr_a, cr_b)
    mask = (s0 >= 0) | (s1 >= 0)
    H, W = ch * 4, cw * 4
    mc_y = out_y.reshape(ch, cw, 4, 4).permute(0, 2, 1, 3).reshape(H, W)
    mc_cb = (out_cb.reshape(ch, cw, 2, 2).permute(0, 2, 1, 3)
             .reshape(H >> 1, W >> 1))
    mc_cr = (out_cr.reshape(ch, cw, 2, 2).permute(0, 2, 1, 3)
             .reshape(H >> 1, W >> 1))
    return mask.reshape(ch, cw), mc_y, mc_cb, mc_cr


# =====================================================================
# deblocking: whole-frame vertical-then-horizontal passes
# =====================================================================


def _clip3d(v, lim):
    return torch.minimum(torch.maximum(v, -lim), lim)


def _deblock_luma_windows(win, s, beta, tc):
    """win [..., 4, 8] (rows x p3 p2 p1 p0 q0 q1 q2 q3), recorded
    strength/beta/tc [...]. Port of deblocking_edge_luma_block
    (h265.cpp:4220-4299 / deblock.py:_edge_luma_block)."""
    s = s.to(I32)
    beta = beta.to(I32)
    tc = tc.to(I32)

    def g(r, c):
        return win[..., r, c]

    dp0 = (g(0, 1) - 2 * g(0, 2) + g(0, 3)).abs()
    dq0 = (g(0, 4) - 2 * g(0, 5) + g(0, 6)).abs()
    dp3 = (g(3, 1) - 2 * g(3, 2) + g(3, 3)).abs()
    dq3 = (g(3, 4) - 2 * g(3, 5) + g(3, 6)).abs()
    dpq0 = dp0 + dq0
    dpq3 = dp3 + dq3
    act = (s > 0) & ((dpq0 + dpq3) < beta)

    def dsam(dpq, p3, p0, q0, q3):
        return (((dpq * 2) < (beta >> 2))
                & ((p0 - q0).abs() < ((5 * tc + 1) >> 1))
                & (((p3 - p0).abs() + (q0 - q3).abs()) < (beta >> 3)))

    strong = act & dsam(dpq0, g(0, 0), g(0, 3), g(0, 4), g(0, 7)) \
        & dsam(dpq3, g(3, 0), g(3, 3), g(3, 4), g(3, 7))
    weak = act & ~strong

    p3, p2, p1, p0 = (win[..., 0], win[..., 1], win[..., 2], win[..., 3])
    q0, q1, q2, q3 = (win[..., 4], win[..., 5], win[..., 6], win[..., 7])
    tc2 = (tc * 2)[..., None]
    # strong (all 4 rows, 6 samples, & 0xFF stores)
    sp2 = (p2 + _clip3d(((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2,
                        tc2)) & 0xFF
    sp1 = (p1 + _clip3d(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, tc2)) & 0xFF
    sp0 = (p0 + _clip3d(
        ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0, tc2)) & 0xFF
    sq0 = (q0 + _clip3d(
        ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0, tc2)) & 0xFF
    sq1 = (q1 + _clip3d(((p0 + q0 + q1 + q2 + 2) >> 2) - q1, tc2)) & 0xFF
    sq2 = (q2 + _clip3d(
        ((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3) - q2, tc2)) & 0xFF
    # weak
    beta2 = (beta + (beta >> 1)) >> 3
    de_p = ((dp0 + dp3) < beta2)[..., None]
    de_q = ((dq0 + dq3) < beta2)[..., None]
    tcb = tc[..., None]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wrow = delta.abs() < tcb * 10
    delta = _clip3d(delta, tcb)
    wp0 = _clip255(p0 + delta)
    wq0 = _clip255(q0 - delta)
    wp1 = _clip255(p1 + _clip3d(
        ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1), tcb >> 1))
    wq1 = _clip255(q1 + _clip3d(
        ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1), tcb >> 1))

    sm = strong[..., None]
    wm = weak[..., None] & wrow
    np2_ = torch.where(sm, sp2, p2)
    np1_ = torch.where(sm, sp1, torch.where(wm & de_p, wp1, p1))
    np0_ = torch.where(sm, sp0, torch.where(wm, wp0, p0))
    nq0_ = torch.where(sm, sq0, torch.where(wm, wq0, q0))
    nq1_ = torch.where(sm, sq1, torch.where(wm & de_q, wq1, q1))
    nq2_ = torch.where(sm, sq2, q2)
    return torch.stack([p3, np2_, np1_, np0_, nq0_, nq1_, nq2_, q3], -1)


def _deblock_chroma_windows(win, tc):
    """win [..., 2, 4] (p1 p0 q0 q1), tc [...] (-1 = off)."""
    act = (tc >= 0)[..., None]
    tcb = tc.to(I32)[..., None]
    p1, p0 = win[..., 0], win[..., 1]
    q0, q1 = win[..., 2], win[..., 3]
    delta = _clip3d(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, tcb)
    np0_ = torch.where(act, _clip255(p0 + delta), p0)
    nq0_ = torch.where(act, _clip255(q0 - delta), q0)
    return torch.stack([p1, np0_, nq0_, q1], -1)


def _deblock_dir_luma(plane, dmap):
    """One direction of luma deblocking on [H, W]: windows at columns
    8k+4 (vertical edges; call on the transposed plane + transposed map
    for horizontal)."""
    H, W = plane.shape
    K = W // 8 - 1
    if K <= 0:
        return plane
    body = plane[:, 4 : 4 + 8 * K]
    win = body.reshape(H // 4, 4, K, 8).permute(0, 2, 1, 3)
    prm = dmap[: H // 4, :K].to(I32)
    out = _deblock_luma_windows(win, prm[..., 0], prm[..., 1], prm[..., 2])
    out = out.permute(0, 2, 1, 3).reshape(H, 8 * K)
    plane = plane.clone()
    plane[:, 4 : 4 + 8 * K] = out
    return plane


def _deblock_dir_chroma(plane, cmap):
    """One direction of chroma deblocking: 2x4 windows at columns 8k+6
    (chroma samples)."""
    Hc, Wc = plane.shape
    K = (Wc - 10) // 8 + 1
    if K <= 0:
        return plane
    body = plane[:, 6 : 6 + 8 * K]
    win = body.reshape(Hc // 2, 2, K, 8).permute(0, 2, 1, 3)
    out4 = _deblock_chroma_windows(win[..., :4], cmap[: Hc // 2, :K].to(I32))
    out = torch.cat([out4, win[..., 4:]], -1)
    out = out.permute(0, 2, 1, 3).reshape(Hc, 8 * K)
    plane = plane.clone()
    plane[:, 6 : 6 + 8 * K] = out
    return plane


def deblock_frame(y, cb, cr, dbv, dbh, dbcv, dbch):
    """Whole-frame deblocking of int32 planes from the edge maps."""
    y = _deblock_dir_luma(y, dbv)
    y = _deblock_dir_luma(y.t(), dbh.transpose(0, 1)).t()
    cb = _deblock_dir_chroma(cb, dbcv[..., 0])
    cb = _deblock_dir_chroma(cb.t(), dbch[..., 0].transpose(0, 1)).t()
    cr = _deblock_dir_chroma(cr, dbcv[..., 1])
    cr = _deblock_dir_chroma(cr.t(), dbch[..., 1].transpose(0, 1)).t()
    return y, cb, cr


# =====================================================================
# SAO: per-pixel map over the pre-SAO plane
# =====================================================================

_EO_IDX_T = np.array(
    [-1, 2, 1, -1, 2, 3, -1, 2, 1, -1, 0, 1, -1, 2, 1, -1], np.int32)

#: (sign0 dy,dx), (sign2 dy,dx) per edge class (sao.py:_eo_block)
_EO_NBR = np.array([
    [[0, -1], [0, 1]],
    [[-1, 0], [1, 0]],
    [[-1, -1], [1, 1]],
    [[-1, 1], [1, -1]],
], np.int32)


def _signe(a, b):
    return torch.where(a > b, 1, torch.where(a < b, 2, 0))


def _shift2d(plane, dy, dx):
    """plane shifted so out[y,x] = plane[y+dy, x+dx], edge-replicated
    (boundary pixels are masked out before use)."""
    H, W = plane.shape
    dev = plane.device
    rows = (torch.arange(H, device=dev) + dy).clamp(0, H - 1)
    cols = (torch.arange(W, device=dev) + dx).clamp(0, W - 1)
    return plane[rows][:, cols]


def sao_plane(plane, idx_c, opt_c, off_c, csl2, pic_w, pic_h):
    """One plane's SAO: idx/opt/off per CTU ([rows, cols], [rows, cols],
    [rows, cols, 4]); csl2 = CTU size log2 in this plane's sample units;
    pic_w/pic_h in this plane's units."""
    H, W = plane.shape
    s = 1 << csl2
    dev = plane.device

    def up(m):
        return m.to(I32).repeat_interleave(s, 0).repeat_interleave(
            s, 1)[:H, :W]

    idx = up(idx_c)
    opt = up(opt_c)
    offs = [up(off_c[:, :, k]) for k in range(4)]

    def sel4(code):
        v = offs[0]
        for k in (1, 2, 3):
            v = torch.where(code == k, offs[k], v)
        return v

    yy = torch.arange(H, dtype=I32, device=dev)[:, None]
    xx = torch.arange(W, dtype=I32, device=dev)[None, :]
    inpic = (yy < pic_h) & (xx < pic_w)
    d = plane.to(I32)
    # band offset
    dif = d - (opt << 3)
    bmask = (idx == 1) & (0 <= dif) & (dif < 32) & inpic
    bval = sel4((dif >> 3).clamp(0, 3))
    # edge offset
    s0 = torch.zeros((H, W), dtype=I32, device=dev)
    s2 = torch.zeros((H, W), dtype=I32, device=dev)
    for cls in range(4):
        m = opt == cls
        n0 = _shift2d(d, int(_EO_NBR[cls, 0, 0]), int(_EO_NBR[cls, 0, 1]))
        n1 = _shift2d(d, int(_EO_NBR[cls, 1, 0]), int(_EO_NBR[cls, 1, 1]))
        s0 = torch.where(m, _signe(d, n0).to(I32), s0)
        s2 = torch.where(m, _signe(d, n1).to(I32), s2)
    code = s2 * 4 + s0
    eidx = torch.full((H, W), -1, dtype=I32, device=dev)
    for v in range(16):
        t = int(_EO_IDX_T[v])
        if t != -1:
            eidx = torch.where(code == v, t, eidx)
    xtrim = (opt == 0) | (opt == 2) | (opt == 3)
    ytrim = (opt == 1) | (opt == 2) | (opt == 3)
    etrim = (~xtrim | ((1 <= xx) & (xx <= pic_w - 2))) \
        & (~ytrim | ((1 <= yy) & (yy <= pic_h - 2)))
    emask = (idx == 2) & (eidx >= 0) & etrim & inpic
    eval_ = sel4(eidx.clamp(0, 3))
    return torch.where(bmask, _clip255(d + bval),
                       torch.where(emask, _clip255(d + eval_), d))


# =====================================================================
# intra: angular host tables (derived from intrapos_tables exactly as
# intra_angular.py walks them)
# =====================================================================

_REFCAP = 66
_FILTER_THR = (56, 48, 48, 48, 48, 48, 48, 32, 0, 32, 48, 48, 48, 48,
               48, 48)


def _build_ang_tables():
    n_m = 33
    sel = np.full((n_m, 4, _REFCAP), 2, np.int32)  # 1 extra, 0 main, 2 pad
    pos = np.zeros((n_m, 4, _REFCAP), np.int32)
    fix_on = np.zeros((n_m, 4), np.int32)
    fix_idx = np.zeros((n_m, 4), np.int32)
    fix_pos = np.zeros((n_m, 4), np.int32)
    row_start = np.zeros((n_m, 4, 32), np.int32)
    coef_c1 = np.zeros((n_m, 32), np.int32)
    filt_kind = np.zeros((n_m, 4), np.int32)
    transp = np.zeros(n_m, np.int32)
    for m in range(n_m):
        coef, inc = _ACOEF[m]
        coef_c1[m] = coef
        transp[m] = int(m < 16 and (m & 7) != 0)
        for s in range(4):
            sl2 = s + 2
            pt = _APOS[m][s]
            el = pt[0]
            extras = pt[1 : 1 + el]
            bp = pt[1 + el]
            bl = pt[2 + el]
            assert all(p >= 0 for p in extras)
            for k in range(el):
                sel[m, s, k] = 1
                pos[m, s, k] = extras[k]
            for i in range(bl):
                sel[m, s, el + i] = 0
                pos[m, s, el + i] = bp + i
            if bp + bl == (2 << sl2):
                fix_on[m, s] = 1
                fix_idx[m, s] = el + bl - 1
                fix_pos[m, s] = bp + bl
            filt_kind[m, s] = int((_FILTER_THR[m & 15] & (1 << sl2)) != 0)
            src = inc[0] >> (3 - s)
            step = inc[1]
            for yy in range(1 << sl2):
                row_start[m, s, yy] = src
                if m & 7:
                    if 1 + yy < len(inc):
                        src += inc[1 + yy]
                else:
                    src += step
    return (sel, pos, fix_on, fix_idx, fix_pos, row_start, coef_c1,
            filt_kind, transp)


_ANG = _build_ang_tables()


def _build_ang_fused():
    """All per-(mode,size) angular tables fused into ONE [132, K] int32
    row table (one gather per op). Column layout (RC = _REFCAP):
    [0:RC) SEL | [RC:2RC) POSA | [2RC:2RC+32) ROWST |
    [2RC+32:2RC+64) COEFC1 | then FIXON, FIXIDX, FIXPOS, FILTK,
    TRANSP."""
    (SEL, POSA, FIXON, FIXIDX, FIXPOS, ROWST, COEFC1, FILTK,
     TRANSP) = _ANG
    RC = _REFCAP
    n = 33 * 4
    tbl = np.zeros((n, 2 * RC + 64 + 5), np.int32)
    fl = np.arange(n)
    mm = fl >> 2
    tbl[:, 0:RC] = SEL.reshape(n, RC)
    tbl[:, RC : 2 * RC] = POSA.reshape(n, RC)
    tbl[:, 2 * RC : 2 * RC + 32] = ROWST.reshape(n, 32)
    tbl[:, 2 * RC + 32 : 2 * RC + 64] = COEFC1[mm]
    base = 2 * RC + 64
    tbl[:, base + 0] = FIXON.reshape(n)
    tbl[:, base + 1] = FIXIDX.reshape(n)
    tbl[:, base + 2] = FIXPOS.reshape(n)
    tbl[:, base + 3] = FILTK.reshape(n)
    tbl[:, base + 4] = TRANSP[mm]
    return tbl


_ANG_FUSED = _build_ang_fused()


@functools.lru_cache(maxsize=8)
def _device_tables(device):
    """The constant tables on ``device`` (a few KB), built once per
    device: the transform matrices (float64), the chroma taps and the
    fused angular table (int64). The tile kernel takes its own packing
    of the angular table (``wavefront_kernels._tile_table``)."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    out = {f"tmat{k}": t(v, F64) for k, v in _TMAT.items()}
    out.update(dmat=t(_DMAT, F64), ctap=t(_CTAP, I64),
               ang=t(_ANG_FUSED, I64))
    return out


def _sel_at(arr, idx):
    """arr[l, idx[l]]; idx must be in range."""
    return arr.gather(1, idx[:, None])[:, 0]


# =====================================================================
# intra: per-op neighbour pipelines + mode families
# =====================================================================


def _side_arrays(RAW, omin, om, corner_param, NV):
    """Dense raw/filtered/strong neighbour values at logical positions
    p = -1..NV-1 from an unclamped source vector RAW [L, NV+2]
    (RAW[:, i] = src[i-1]). omin in {-1,0}, om = clamped offset_max.
    corner_param patches the filtered run's E[-2] (the reference's
    get_ref corner quirk, h265.cpp:2590). Index-clamped reads collapse
    to selects of the values at omin and at hi, and the +/-1 shifted
    reads to edge-dup shifts of the clamped vector."""
    P = torch.arange(-1, NV, device=RAW.device)[None, :]  # NV+1 positions
    hi = torch.maximum(om - 1, omin)
    lo_v = torch.where(omin == -1, RAW[:, 0], RAW[:, 1])  # value at omin
    hi_v = _sel_at(RAW, hi + 1)                           # value at hi
    base = RAW[:, : NV + 1]                               # p = -1..NV-1
    rawc = torch.where(P < omin[:, None], lo_v[:, None],
                       torch.where(P > hi[:, None], hi_v[:, None], base))
    e_prev = torch.cat([rawc[:, :1], rawc[:, :-1]], 1)
    use_cp = (P == -1) & (omin[:, None] == -1)
    e_prev = torch.where(use_cp, corner_param[:, None], e_prev)
    e_next = torch.cat([rawc[:, 1:], rawc[:, -1:]], 1)
    filt = (e_prev + 2 * rawc + e_next + 2) >> 2
    c1s = _sel_at(RAW, hi.clamp(max=63) + 1)
    strong = ((63 - P) * lo_v[:, None] + (P + 1) * c1s[:, None] + 32) >> 6
    return rawc, filt, strong


def _extra_vals(RAW, pos, omin, valid, kind):
    """Pointwise get_pix_{raw,filtered,strong} at extras positions
    (intra_angular.py:25-45); pos [L, K] >= 0; kind [L] 0/1/2."""
    cap = RAW.shape[1] - 1
    ix = (pos + 1).clamp(0, cap)
    RAW_m1 = torch.cat([RAW[:, :1], RAW[:, :-1]], 1)
    RAW_p1 = torch.cat([RAW[:, 1:], RAW[:, -1:]], 1)
    c1 = RAW.gather(1, ix)
    prev = RAW_m1.gather(1, ix)
    nxt = RAW_p1.gather(1, ix)
    fir = (prev + 2 * c1 + nxt + 2) >> 2
    tail = (prev + 3 * c1 + 2) >> 2
    head = (3 * c1 + nxt + 2) >> 2
    filt = torch.where(pos <= omin[:, None], head,
                       torch.where(pos >= (valid - 1)[:, None], tail, fir))
    top = torch.maximum(valid - 1, omin)
    ridx = (torch.minimum(torch.maximum(pos, omin[:, None]), top[:, None])
            + 1).clamp(0, cap)
    raw = RAW.gather(1, ridx)
    c0 = torch.where(omin == -1, RAW[:, 0], RAW[:, 1])[:, None]
    c1v = _sel_at(RAW, ((valid - 1).clamp(0, 63) + 1).clamp(0, cap))
    strg = ((63 - pos) * c0 + (pos + 1) * c1v[:, None] + 32) >> 6
    return torch.where((kind == 0)[:, None], raw,
                       torch.where((kind == 1)[:, None], filt, strg))


def _intra_core(RAWL, RAWT, sl2, mode, vx, vy, S, is_luma, strong_en,
                consts):
    """Mode math for one intra op across lanes (int64).

    RAWL/RAWT [L, NV+2] are the unclamped left/top source vectors
    (RAW[:, i] = src[i-1], NV = 2*S+2). Evaluates planar/DC/H/V/angular
    exactly as intra.py / intra_angular.py; positions beyond the
    per-lane valid counts (vx/vy) are never read. Returns (grid [L, S, S],
    dc1v [L] — the DC stray-pixel value). consts: the fused angular
    table (_ANG_FUSED) on the device."""
    TBL = consts
    dev = RAWL.device
    Lb = sl2.shape[0]
    one = torch.ones_like(sl2)
    size = one << sl2
    two_sz = (one * 2) << sl2
    NV = 2 * S + 2
    corner = RAWT[:, 0]
    L0 = RAWL[:, 1]
    T0 = RAWT[:, 1]
    omin_L = torch.where(vx > 0, -1, 0)
    omin_T = torch.where(vy > 0, -1, 0)
    omL = torch.minimum(two_sz, vy)
    omT = torch.minimum(two_sz, vx)
    rawcL, filtL, strongL = _side_arrays(RAWL, omin_L, omL, T0, NV)
    rawcT, filtT, strongT = _side_arrays(RAWT, omin_T, omT, L0, NV)

    ys = torch.arange(S, device=dev)
    xs = ys
    gy = ys[None, :, None]
    gx = xs[None, None, :]
    sz3 = size[:, None, None]

    # ---- strong-smoothing detect (h265.cpp:2435-2456) ----
    if is_luma and strong_en:
        def onedir(lt, RAW, vl):
            d64 = lt + RAW[:, 64] - 2 * RAW[:, 32]
            d32 = lt - RAW[:, 32]
            return torch.where(vl >= 64, d64 * d64 < 64,
                               torch.where(vl >= 32, d32 * d32 < 64, True))

        dflag = torch.where(
            vx > 0,
            torch.where(vy > 0,
                        onedir(corner, RAWT, vx) & onedir(corner, RAWL, vy),
                        onedir(T0, RAWT, vx)),
            torch.where(vy > 0, onedir(L0, RAWL, vy), False))
        dflag = dflag & (sl2 == 5)
    else:
        dflag = torch.zeros((Lb,), dtype=torch.bool, device=dev)

    # ---- planar (h265.cpp:2411-2430) ----
    if is_luma:
        pl_filt = (sl2 >= 3)[:, None]
        pl_strong = pl_filt & dflag[:, None]
        lineL = torch.where(pl_strong, strongL,
                            torch.where(pl_filt, filtL, rawcL))
        lineT = torch.where(pl_strong, strongT,
                            torch.where(pl_filt, filtT, rawcT))
    else:
        lineL, lineT = rawcL, rawcT
    left_bn = torch.where((vy > 0)[:, None], lineL[:, 1 : S + 2],
                          T0[:, None])
    top_bn = torch.where((vx > 0)[:, None], lineT[:, 1 : S + 2],
                         L0[:, None])
    lb = _sel_at(left_bn, size)
    rt = _sel_at(top_bn, size)
    lv = left_bn[:, :S]
    tbn = top_bn[:, :S]
    planar = (((lv << sl2[:, None])[:, :, None]
               + (ys + 1)[None, :, None] * lb[:, None, None]
               + (xs + 1)[None, None, :]
               * (rt[:, None, None] - lv[:, :, None])
               + tbn[:, None, :] * (sz3 - 1 - gy)
               + sz3) >> (sl2[:, None, None] + 1))
    planar = torch.where(((vx <= 0) & (vy <= 0))[:, None, None], 128,
                         planar)

    # ---- DC (h265.cpp:2348-2410) ----
    TT = RAWT[:, 1 : S + 1]
    LL = RAWL[:, 1 : S + 1]

    def edge_sum(vec, vm, vs, fb):
        msk = ys[None, :] < torch.minimum(size, vm.clamp(min=0))[:, None]
        sfull = (vec * msk).sum(1)
        lastv = _sel_at(vec, (vm - 1).clamp(0, S - 1))
        return torch.where(size <= vm, sfull,
                           torch.where(vm > 0, sfull + lastv * (size - vm),
                                       torch.where(vs > 0, fb * size,
                                                   128 * size)))

    st = edge_sum(TT, vx, vy, L0)
    slf = edge_sum(LL, vy, vx, T0)
    dc = (st + slf + size) >> (sl2 + 1)
    dcg = dc[:, None, None].expand(Lb, S, S)
    dc1v = (T0 + 3 * dc + 2) >> 2
    if is_luma:
        both = (vx > 0) & (vy > 0)
        ton = (vx > 0) & (vy <= 0)
        lon = (vy > 0) & (vx <= 0)
        dcb = dc[:, None]
        row0 = torch.where((both | ton)[:, None], (TT + 3 * dcb + 2) >> 2,
                           ((L0 + 3 * dc + 2) >> 2)[:, None])
        col0 = torch.where(ton[:, None], dc1v[:, None],
                           (LL + 3 * dcb + 2) >> 2)
        pix00 = torch.where(both, (T0 + L0 + 2 * dc + 2) >> 2,
                            torch.where(ton, (T0 + dc + 1) >> 1,
                                        (L0 + dc + 1) >> 1))
        dcf = torch.where((gx >= 1) & (gy == 0), row0[:, None, :], dcg)
        dcf = torch.where((gy >= 1) & (gx == 0), col0[:, :, None], dcf)
        dcf = torch.where((gy == 0) & (gx == 0), pix00[:, None, None], dcf)
        apply_f = (sl2 < 5) & (both | ton | lon)
        dcg = torch.where(apply_f[:, None, None], dcf, dcg)

    # ---- horizontal / vertical (h265.cpp:2822-2885) ----
    dcv_h = torch.where(vx > 0, T0, 128)
    hbase = torch.where((vy > 0)[:, None], LL, dcv_h[:, None])
    hg = hbase[:, :, None].expand(Lb, S, S)
    dcv_v = torch.where(vy > 0, L0, 128)
    vbase = torch.where((vx > 0)[:, None], TT, dcv_v[:, None])
    vg = vbase[:, None, :].expand(Lb, S, S)
    if is_luma:
        c0h = torch.where(vy > 0, corner, dcv_h)
        d0h = torch.where(vy > 0, L0, dcv_h)
        row0h = _clip255(d0h[:, None] + ((TT - c0h[:, None]) >> 1))
        condh = ((sl2 < 5) & (vx > 0))[:, None, None]
        hg = torch.where(condh & (gy == 0), row0h[:, None, :], hg)
        c0v = torch.where(vx > 0, corner, dcv_v)
        d0v = torch.where(vx > 0, T0, dcv_v)
        col0v = _clip255(d0v[:, None] + ((LL - c0v[:, None]) >> 1))
        condv = ((sl2 < 5) & (vy > 0))[:, None, None]
        vg = torch.where(condv & (gx == 0), col0v[:, :, None], vg)

    # ---- angular (h265.cpp:2663-2812) ----
    mm = (mode - 2).clamp(0, 32)
    flat = mm * 4 + (sl2 - 2)
    RC = _REFCAP
    B0 = 2 * RC + 64
    # the assembled ref vector only needs indices 0..2S-1 (max table
    # index inside a block 2S-2, max populated SEL/POSA entry 2S-1)
    RCW = min(2 * S, RC)
    row = TBL[flat]                       # one fused-table gather
    selr = row[:, :RCW]
    posr = row[:, RC : RC + RCW]
    if is_luma:
        kind = torch.where(row[:, B0 + 3] == 0, 0,
                           torch.where(dflag, 2, 1))
    else:
        kind = torch.zeros((Lb,), dtype=I64, device=dev)
    horiz = mm < 16
    vmain = torch.where(horiz, vy, vx)
    vsub = torch.where(horiz, vx, vy)
    omin_sub = torch.where(horiz, omin_T, omin_L)
    h3 = horiz[:, None]
    mainRAWC = torch.where(h3, rawcL, rawcT)
    mainF = torch.where(h3, filtL, filtT)
    mainS = torch.where(h3, strongL, strongT)
    main_arr = torch.where((kind == 0)[:, None], mainRAWC,
                           torch.where((kind == 1)[:, None], mainF, mainS))
    subRAW = torch.where(h3, RAWT, RAWL)
    sub_single = torch.where(horiz, L0, T0)
    mainvals = main_arr.gather(1, (posr + 1).clamp(0, NV))
    fixval = _sel_at(mainRAWC, (row[:, B0 + 2] + 1).clamp(0, NV))
    karr = torch.arange(RCW, device=dev)
    fixmask = (karr[None, :] == row[:, B0 + 1][:, None]) \
        & ((row[:, B0 + 0] == 1) & (vmain >= two_sz))[:, None]
    mainvals = torch.where(fixmask, fixval[:, None], mainvals)
    mainvals = torch.where((vmain > 0)[:, None], mainvals,
                           torch.where((vsub > 0)[:, None],
                                       subRAW[:, 1][:, None], 128))
    ev = _extra_vals(subRAW, posr, omin_sub, vsub, kind)
    ev = torch.where((vsub > 0)[:, None], ev,
                     torch.where((vmain > 0)[:, None], sub_single[:, None],
                                 128))
    ref = torch.where(selr == 1, ev, torch.where(selr == 0, mainvals, 0))
    r0 = row[:, 2 * RC : 2 * RC + S]
    c1 = row[:, 2 * RC + 32 : 2 * RC + 32 + S]
    # a = ref[r0[y] + x], b = ref[r0[y] + x + 1]; inside a block the
    # index is at most 2S-2, so the clamp touches only samples outside
    # the block (masked by the caller)
    idxa = (r0[:, :, None] + xs[None, None, :]).clamp(0, RCW - 1)
    idxa = idxa.reshape(Lb, S * S)
    refs1 = torch.cat([ref[:, 1:], ref[:, -1:]], 1)
    a = ref.gather(1, idxa).reshape(Lb, S, S)
    b = refs1.gather(1, idxa).reshape(Lb, S, S)
    c13 = c1[:, :, None]
    ang = (a * (32 - c13) + b * c13 + 16) >> 5
    tr = (row[:, B0 + 4] == 1)[:, None, None]
    ang = torch.where(tr, ang.transpose(1, 2), ang)

    # ---- select ----
    m3 = mode[:, None, None]
    grid = torch.where(m3 == 0, planar,
                       torch.where(m3 == 1, dcg,
                                   torch.where(m3 == 10, hg,
                                               torch.where(m3 == 26, vg,
                                                           ang))))
    return grid, dc1v


def _intra_op_delta(plane, resid, op, S, is_luma, strong_en, H, W,
                    consts, ybase=None):
    """One intra op slot across lanes, as a write: (flat indexes, changes)
    [L*(S+1)^2] for a scatter-add into ``plane`` (int32, contiguous).

    plane/resid: padded int32 planes (content at [0:H, 0:W], pad >= S+1
    below/right); op [L, 7] = (used, y0, x0, sl2, mode, vx, vy).
    Evaluates the prediction (_intra_core), fuses it with the residual
    over the masked size x size region (+ the DC stray pixel) and returns
    the change of each lane's (S+1) x (S+1) window. The change is zero
    outside a lane's block, so windows of one level that overlap add
    nothing to each other; an inactive lane changes nothing.

    ybase: the cb and cr planes ride ONE stacked plane; lanes with y0 >=
    ybase belong to the second segment and clip their neighbour reads to
    [ybase, ybase+H-1] instead of [0, H-1]."""
    op = op.to(I64)
    used = op[:, 0]
    y0, x0 = op[:, 1], op[:, 2]
    sl2 = op[:, 3].clamp(2, 5)
    mode = op[:, 4]
    vx, vy = op[:, 5], op[:, 6]
    Wp = plane.shape[1]
    dev = plane.device
    flat_p = plane.view(-1)
    flat_r = resid.view(-1)
    NV = 2 * S + 2
    ar = torch.arange(-1, NV + 1, device=dev)
    if ybase is None:
        ylo = torch.zeros_like(y0)
    else:
        ylo = torch.where(y0 >= ybase, ybase, 0)
    yhi = ylo + (H - 1)
    ly = torch.minimum(torch.maximum(y0[:, None] + ar[None, :],
                                     ylo[:, None]), yhi[:, None])
    lxc = (x0 - 1).clamp(0, W - 1)
    RAWL = flat_p[ly * Wp + lxc[:, None]].to(I64)       # src_L[-1..NV]
    tyc = torch.minimum(torch.maximum(y0 - 1, ylo), yhi)
    tx = (x0[:, None] + ar[None, :]).clamp(0, W - 1)
    RAWT = flat_p[tyc[:, None] * Wp + tx].to(I64)       # src_T[-1..NV]
    grid, dc1v = _intra_core(RAWL, RAWT, sl2, mode, vx, vy, S, is_luma,
                             strong_en, consts)
    Lb = op.shape[0]
    sz3 = (torch.ones_like(sl2) << sl2)[:, None, None]
    arS1 = torch.arange(S + 1, device=dev)
    idx = ((y0[:, None] + arS1)[:, :, None] * Wp
           + (x0[:, None] + arS1)[:, None, :])         # [L, S+1, S+1]
    rgn = flat_p[idx].to(I64)
    rres = flat_r[idx].to(I64)
    gpad = torch.zeros((Lb, S + 1, S + 1), dtype=I64, device=dev)
    gpad[:, :S, :S] = grid
    gy1 = arS1[None, :, None]
    gx1 = arS1[None, None, :]
    inb = (gy1 < sz3) & (gx1 < sz3)
    out = torch.where(inb, _clip255(gpad + rres), rgn)
    if is_luma:
        stray = (gy1 == sz3) & (gx1 == 0) \
            & (((used >> 1) & 1) == 1)[:, None, None]
        out = torch.where(stray, dc1v[:, None, None], out)
    act = ((used & 1) == 1)[:, None, None]
    delta = torch.where(act, out - rgn, 0)
    return idx.reshape(-1), delta.reshape(-1).to(plane.dtype)


# =====================================================================
# the level schedule (host numpy)
# =====================================================================

#: lane-capacity cap for the level schedule: bounds the packed lane
#: count per level at the price of a few extra levels on capacity-bound
#: pictures (the JAX package's value, so the level tensors are equal)
_LEVEL_CAP = 32
#: big-TU (sl2>=4) lane cap: one big lane costs ~16 small ones on the
#: S=32 apply, so the big bank stays narrow
_LEVEL_CAP_BIG = 4


def _schedule_levels(flat_ops, chg, cwg, stray, cap=_LEVEL_CAP,
                     cap_big=_LEVEL_CAP_BIG):
    """Dependency-level schedule for decode-ordered intra ops, through
    the native scheduler (``native/oplevel.cpp``; its build is required,
    a failed one raises). The algorithm is ``_schedule_levels_py``'s.

    flat_ops [n, 7] int32 rows (used, y0, x0, sl2, mode, vx, vy) in
    decode order; returns per-op levels [n] int32 (0 = inactive)."""
    lv = np.zeros(len(flat_ops), np.int32)
    if not len(flat_ops):
        return lv
    ops = np.ascontiguousarray(flat_ops, np.int32)
    load_oplevel().h265_schedule_levels(
        ops.ctypes.data_as(ctypes.c_void_p), len(ops), np.int32(chg),
        np.int32(cwg), np.int32(bool(stray)), np.int32(cap),
        np.int32(cap_big), lv.ctypes.data_as(ctypes.c_void_p))
    return lv


def _schedule_levels_py(flat_ops, chg, cwg, stray, cap=_LEVEL_CAP,
                        cap_big=_LEVEL_CAP_BIG):
    """The level schedule in Python: the spec the native scheduler is
    held to (about 700 ms per 1080p I picture, so never on the main
    path).

    Replaces the per-CTU z-order replay (the reference's CTU walk,
    h265.cpp:4752-4799) with the minimal sequential structure the data
    requires: each op gets a level such that applying all ops of a level
    in one lane-batched step — reads from the plane state left by
    earlier levels, disjoint writes — produces planes identical to the
    sequential z-order replay. Dependencies on the 4x4-cell grid
    [chg, cwg]: flow (an op reads its own block, the column left of it
    down to y0+2*size and the row above it right to x0+2*size: its level
    exceeds every earlier writer of those cells); anti (a z-later writer
    of a cell some earlier op read lands on no earlier level); output
    (strictly increasing levels)."""
    lw = np.zeros((chg, cwg), np.int32)  # last writer's level per cell
    lr = np.zeros((chg, cwg), np.int32)  # latest reader's level
    lv = np.zeros(len(flat_ops), np.int32)
    occ: dict = {}   # small-bank per-level occupancy
    occb: dict = {}  # big-bank (sl2>=4) occupancy
    for i, op in enumerate(flat_ops):
        used = int(op[0])
        if not (used & 1):
            continue
        y0, x0, sl2 = int(op[1]), int(op[2]), int(op[3])
        s = 1 << sl2
        c0, c1 = x0 >> 2, (x0 + s - 1) >> 2
        r0, r1 = y0 >> 2, (y0 + s - 1) >> 2
        rr0, rc0 = max(0, r0 - 1), max(0, c0 - 1)
        rr1 = min(chg - 1, (y0 + 2 * s) >> 2)
        rc1 = min(cwg - 1, (x0 + 2 * s) >> 2)
        blk_w = lw[r0 : r1 + 1, c0 : c1 + 1]
        m = int(blk_w.max())
        m = max(m, int(lw[rr0 : rr1 + 1, rc0].max()),
                int(lw[rr0, rc0 : rc1 + 1].max()))
        a = int(lr[r0 : r1 + 1, c0 : c1 + 1].max())
        sy = (y0 + s) >> 2 if (stray and (used & 2)) else -1
        if sy >= chg:
            sy = -1
        if sy >= 0:
            m = max(m, int(lw[sy, c0]))
            a = max(a, int(lr[sy, c0]))
        level = max(m + 1, a)
        if cap > 0:
            # delaying past the minimum level is safe because later
            # ops' constraints read the ASSIGNED levels
            o, c = (occb, cap_big) if sl2 >= 4 else (occ, cap)
            while o.get(level, 0) >= c:
                level += 1
            o[level] = o.get(level, 0) + 1
        lv[i] = level
        np.maximum(lr[rr0 : rr1 + 1, rc0], level,
                   out=lr[rr0 : rr1 + 1, rc0])
        np.maximum(lr[rr0, rc0 : rc1 + 1], level,
                   out=lr[rr0, rc0 : rc1 + 1])
        np.maximum(lr[r0 : r1 + 1, c0 : c1 + 1], level,
                   out=lr[r0 : r1 + 1, c0 : c1 + 1])
        lw[r0 : r1 + 1, c0 : c1 + 1] = level
        if sy >= 0:
            lw[sy, c0] = level
            lr[sy, c0] = max(int(lr[sy, c0]), level)
    return lv


#: max ops per wavefront step row. A level with more ops is split into
#: consecutive rows (decode order preserved inside the level, which
#: keeps write-after-read anti-dependencies correct)
_LANE_CAP = 128


def _ceil_pow2(v):
    r = 1
    while r < v:
        r *= 2
    return r


def _level_pack(flat_ops, lv):
    """Row-pack decode-ordered ops by level, split per row into SIZE
    BANKS -> (small [rows, Ls, 7], big [rows, Lb, 7]) int32. A row's
    small (sl2<=3) and big (sl2>=4) ops apply as two passes whose tensor
    extents match their block sizes (8 vs 32/16); both read the
    pre-level plane and a level's writes are disjoint."""
    idx = np.flatnonzero(lv)  # decode order within equal levels
    if len(idx) == 0:
        z = np.zeros((1, 1, 7), np.int32)
        return z, z.copy()
    order = idx[np.argsort(lv[idx], kind="stable")]
    levels = lv[order]
    rows = []
    i = 0
    n = len(order)
    while i < n:
        j = i
        cur = levels[i]
        while j < n and levels[j] == cur and j - i < _LANE_CAP:
            j += 1
        r = order[i:j]
        big = flat_ops[r][:, 3] >= 4
        rows.append((r[~big], r[big]))
        i = j
    Ls = _ceil_pow2(max(1, max(len(s) for s, _ in rows)))
    Lb = _ceil_pow2(max(1, max(len(b) for _, b in rows)))
    out_s = np.zeros((len(rows), Ls, 7), np.int32)
    out_b = np.zeros((len(rows), Lb, 7), np.int32)
    for d, (s, b) in enumerate(rows):
        out_s[d, : len(s)] = flat_ops[s]
        out_b[d, : len(b)] = flat_ops[b]
    return out_s, out_b


def _CR0(Hc):
    """Row base of the cr segment in the stacked chroma plane (cb
    content + its 17-row write pad)."""
    return Hc + 17


def _plan_levels(plan):
    """Level-packed intra op tensors for one plan (cached on the plan):
    (lv_ls, lv_lb, lv_cs, lv_cb) size-bank tensors [D, L, 7]; the chroma
    banks carry each op twice, the second copy targeting the cr segment
    of the stacked chroma plane."""
    cached = getattr(plan, "_levels", None)
    if cached is not None:
        return cached
    flat_l = np.asarray(plan.ops_l, np.int32).reshape(-1, 7)
    flat_c = np.asarray(plan.ops_c, np.int32).reshape(-1, 7)
    lvl = _schedule_levels(flat_l, plan.H >> 2, plan.W >> 2, True)
    lvc = _schedule_levels(flat_c, plan.H >> 3, plan.W >> 3, False)
    pk_cs, pk_cb = _level_pack(flat_c, lvc)

    def dbl(pk):
        cr_ops = pk.copy()
        cr_ops[:, :, 1] += _CR0(plan.H >> 1)
        return np.concatenate([pk, cr_ops], axis=1)

    pk_ls, pk_lb = _level_pack(flat_l, lvl)
    plan._levels = (pk_ls, pk_lb, dbl(pk_cs), dbl(pk_cb))
    return plan._levels


# =====================================================================
# the CTU-tile schedule (host numpy)
# =====================================================================
#
# One step per CTU anti-diagonal d = cx + 2*cy (the reference's own CTU
# wavefront order, h265.cpp:4752-4799), the CTU-local z-order unrolled
# as slots over the 4x4 cell grid: the op whose top-left cell is z-cell
# j applies at slot j. k = 2 in d = cx + k*cy suffices: valid neighbour
# reads reach at most C+S-1 < 2C samples right of the CTU origin and
# never below the CTU row, so a CTU reads only CTUs of earlier
# diagonals. The CUDA kernel (csrc/h265_tile.cu) runs this schedule as
# one CTA per CTU row; _wavefront_tile_plain is its plain version.

#: packed z-slot op fields: used(2) | (sl2-2)(2) | mode(6) | vx(7) | vy(7)
_ZF_USED, _ZF_SL2, _ZF_MODE, _ZF_VX, _ZF_VY = 0, 2, 4, 10, 17


@functools.lru_cache(maxsize=16)
def _zslot_table(cb_log2):
    """Z-ordered (oy, ox, Smax) slots over a CTB's 4x4 cell grid.
    Smax = the largest block size a slot's alignment admits (an op's
    top-left cell determines its slot; quad-tree alignment makes the
    mapping unique and z-monotonic)."""
    n = 1 << (cb_log2 - 2)
    out = []
    for z in range(n * n):
        r = c = 0
        for k in range(cb_log2 - 2):
            c |= ((z >> (2 * k)) & 1) << k
            r |= ((z >> (2 * k + 1)) & 1) << k
        oy, ox = r << 2, c << 2
        smax = 4
        while (smax < 32 and smax < (1 << cb_log2)
               and oy % (smax * 2) == 0 and ox % (smax * 2) == 0):
            smax *= 2
        out.append((oy, ox, smax))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _tile_lanes_band(cols, rows):
    """Band-indexed lane table: ctu_of [D, rows] int32 — the CTU of
    band (CTU row) cy on diagonal d, or -1 (band idle on d)."""
    D = cols + 2 * (rows - 1)
    out = np.full((D, rows), -1, np.int32)
    for d in range(D):
        for cy in range(rows):
            cx = d - 2 * cy
            if 0 <= cx < cols:
                out[d, cy] = cy * cols + cx
    return out


def _pack_zslots(ops, n_slots, cb_log2):
    """Pack a per-CTU op array [n_ctu, CAP, 7] into z-slot field words
    [n_ctu, n_slots] int32 (0 = no op)."""
    flat = np.asarray(ops, np.int32)
    n_ctu = flat.shape[0]
    zl = np.zeros((n_ctu, n_slots), np.int32)
    ic, io = np.nonzero((flat[..., 0] & 1) == 1)
    if len(ic) == 0:
        return zl, ic
    y0, x0 = flat[ic, io, 1], flat[ic, io, 2]
    cb = 1 << cb_log2
    r, c = (y0 % cb) >> 2, (x0 % cb) >> 2
    slot = np.zeros(len(ic), np.int64)
    for k in range(cb_log2 - 2):
        slot |= ((c >> k) & 1) << (2 * k)
        slot |= ((r >> k) & 1) << (2 * k + 1)
    packed = ((flat[ic, io, 0] & 3)
              | ((flat[ic, io, 3] - 2) << _ZF_SL2)
              | (flat[ic, io, 4] << _ZF_MODE)
              | (np.clip(flat[ic, io, 5], 0, 127) << _ZF_VX)
              | (np.clip(flat[ic, io, 6], 0, 127) << _ZF_VY))
    zl[ic, slot] = packed
    return zl, ic


def _ctu_zslots(plan):
    """The plan's per-CTU z-slot words (zl [n_ctu, SL], zc [n_ctu, SC])
    int32, luma and chroma (one chroma word serves cb and cr: HEVC has
    a single chroma mode): what the tile kernel reads."""
    cl2 = plan.size_log2
    zl, _ = _pack_zslots(plan.ops_l, 1 << (2 * (cl2 - 2)), cl2)
    zc, _ = _pack_zslots(plan.ops_c, 1 << (2 * (cl2 - 3)), cl2 - 1)
    return zl, zc


def _diag_zslots(zl, zc, cols, rows):
    """Per-CTU words -> (fzl [D, rows, SL], fzc [D, rows, SC], actm
    [D, 2]): per diagonal and band the words of the band's CTU (0 for
    idle bands), and whether a diagonal has any luma / chroma op."""
    lanes = _tile_lanes_band(cols, rows)          # [D, rows]
    safe = np.maximum(lanes, 0)
    live = (lanes >= 0)[:, :, None]
    fzl = np.where(live, zl[safe], 0).astype(np.int32)
    fzc = np.where(live, zc[safe], 0).astype(np.int32)
    actm = np.stack([(fzl & 1).any(axis=(1, 2)),
                     (fzc & 1).any(axis=(1, 2))], 1)
    return fzl, fzc, actm


def _plan_zslots(plan):
    """Tile-wavefront tensors for one plan (cached):
    (fzl [D, rows, SL], fzc [D, rows, SC], actm [D, 2]) — per-diagonal
    per-band packed z-slot words (0 for idle bands) plus the
    per-diagonal any-luma-op / any-chroma-op flags."""
    cached = getattr(plan, "_zslots", None)
    if cached is not None:
        return cached
    plan._zslots = _diag_zslots(*_ctu_zslots(plan), plan.columns,
                                plan.rows)
    return plan._zslots


def wf_mode_for(ctb_log2):
    """The intra wavefront's schedule for a CTB size: "tile" (one step
    per CTU anti-diagonal, the CTU's z-order unrolled; the CUDA kernel
    on the card) up to CTB 16, "level" (the dependency levels) above.
    The JAX package's rule; its M2DEC_TPU_H265_WF override is the
    ``wf_mode`` argument here."""
    return "tile" if ctb_log2 <= 4 else "level"


def _check_wf_mode(wf_mode):
    if wf_mode not in (None, "tile", "level"):
        raise ValueError(f"wf_mode must be None, 'tile' or 'level', got "
                         f"{wf_mode!r}")
    return wf_mode


#: lanes of each bank's op buffer: the level caps bound a level's ops
#: per bank (the chroma banks carry each op twice, for cb and cr)
_BANK_LANES = {"ls": _LEVEL_CAP, "lb": _LEVEL_CAP_BIG,
               "cs": 2 * _LEVEL_CAP, "cb": 2 * _LEVEL_CAP_BIG}
#: per bank: (luma, block size S of its tensors)
_BANKS = {"ls": (True, 8), "lb": (True, 32), "cs": (False, 8),
          "cb": (False, 16)}


def _bank_rows(pk, key):
    """A bank tensor [D, L, 7] padded with inactive lanes to the bank's
    fixed width, and which levels have an op in it (host list)."""
    out = np.zeros((pk.shape[0], _BANK_LANES[key], 7), np.int32)
    out[:, : pk.shape[1]] = pk
    return out, ((pk[..., 0] & 1) != 0).any(1).tolist()


class _LevelRunner:
    """The intra wavefront of one geometry over static buffers: the
    padded planes (luma [H+33, W+33]; cb over cr, each with 17 pad rows
    and columns) and one op buffer per bank. The tile schedule works in
    place on the same padded planes and uses no op buffer.

    A level runs its small and big bank as two lane batches that both
    read the pre-level plane and then add their changes (the schedule
    lets a z-earlier op read what a z-later op of its level writes). On
    a CUDA device each kind of level (plane, which banks, strong
    smoothing) is captured once as a CUDA graph and replayed per level
    after one copy of its ops into the buffers; the graph launches the
    same ops as the CPU runs. Padding lanes are inactive (used = 0) and
    change nothing."""

    def __init__(self, H, W, device):
        self.H, self.W = H, W
        self.device = device
        self.consts = _device_tables(device)["ang"]
        Hc, Wc = H >> 1, W >> 1

        def z(h, w):
            return torch.zeros((h, w), dtype=I32, device=device)

        self.y, self.ry = z(H + 33, W + 33), z(H + 33, W + 33)
        self.c, self.rc = z(2 * _CR0(Hc), Wc + 17), z(2 * _CR0(Hc), Wc + 17)
        self.ops = {k: torch.zeros((n, 7), dtype=I32, device=device)
                    for k, n in _BANK_LANES.items()}
        self.graphs = {}

    def load(self, y, cb, cr, res_y, res_cb, res_cr):
        """The picture's pre-intra planes and residuals into the buffers
        (zero padding)."""
        H, W, Hc, Wc = self.H, self.W, self.H >> 1, self.W >> 1
        c0 = _CR0(Hc)
        for buf, a, b in ((self.y, y, None), (self.ry, res_y, None),
                          (self.c, cb, cr), (self.rc, res_cb, res_cr)):
            buf.zero_()
            if b is None:
                buf[:H, :W] = a
            else:
                buf[:Hc, :Wc] = a
                buf[c0 : c0 + Hc, :Wc] = b

    def planes(self):
        """Views of the content: (y, cb, cr)."""
        H, W, Hc, Wc = self.H, self.W, self.H >> 1, self.W >> 1
        c0 = _CR0(Hc)
        return (self.y[:H, :W], self.c[:Hc, :Wc],
                self.c[c0 : c0 + Hc, :Wc])

    def _apply(self, banks, strong):
        """One level from the op buffers of ``banks``."""
        luma = _BANKS[banks[0]][0]
        if luma:
            plane, resid, H, W, ybase = self.y, self.ry, self.H, self.W, None
        else:
            plane, resid = self.c, self.rc
            H, W, ybase = self.H >> 1, self.W >> 1, _CR0(self.H >> 1)
        w = [_intra_op_delta(plane, resid, self.ops[k], _BANKS[k][1], luma,
                             strong and k == "lb", H, W, self.consts, ybase)
             for k in banks]
        flat = plane.view(-1)
        for idx, delta in w:
            flat.scatter_add_(0, idx, delta)

    def _capture(self, key):
        """The CUDA graph of one kind of level, captured with inactive
        ops (which change nothing); the buffers' ops are kept."""
        saved = [(b, b.clone()) for b in self.ops.values()]
        for b, _ in saved:
            b.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._apply(*key)  # warm-up outside the capture
        torch.cuda.current_stream(self.device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self._apply(*key)
        for b, v in saved:
            b.copy_(v)
        return g

    def level(self, rows, strong):
        """One level: {bank: its [L, 7] device ops} of the non-empty
        banks."""
        for k, r in rows.items():
            self.ops[k].copy_(r)
        key = (tuple(rows), bool(strong))
        if self.device.type != "cuda":
            self._apply(*key)
            return
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key)
        g.replay()


def _wavefront_luma(wf, ls, has_s, lb, has_b, strong_en):
    """The luma levels in order: small bank (S = 8) and big bank (S =
    32, where strong smoothing lives)."""
    for i, (a, b) in enumerate(zip(has_s, has_b)):
        rows = {}
        if a:
            rows["ls"] = ls[i]
        if b:
            rows["lb"] = lb[i]
        if rows:
            wf.level(rows, strong_en)


def _wavefront_chroma(wf, cs, has_s, cb, has_b):
    """The chroma levels in order on the stacked cb/cr plane: small bank
    (S = 8) and big bank (S = 16)."""
    for i, (a, b) in enumerate(zip(has_s, has_b)):
        rows = {}
        if a:
            rows["cs"] = cs[i]
        if b:
            rows["cb"] = cb[i]
        if rows:
            wf.level(rows, False)


def _tile_ops(words, ctus, cols, C, oy, ox):
    """Op rows [L, 7] (used, y0, x0, sl2, mode, vx, vy) of the packed
    z-slot ``words`` at slot (oy, ox) of CTUs ``ctus`` (CTB C)."""
    return np.stack([words & 3, (ctus // cols) * C + oy,
                     (ctus % cols) * C + ox,
                     ((words >> _ZF_SL2) & 3) + 2,
                     (words >> _ZF_MODE) & 63, (words >> _ZF_VX) & 127,
                     (words >> _ZF_VY) & 127], 1).astype(np.int32)


def _wavefront_tile_plain(y, cbcr, res_y, res_cbcr, zl, zc, H, W,
                          ctb_log2, strong_en):
    """The tile wavefront in plain torch, in place on the _LevelRunner's
    padded planes (luma [H+33, W+33]; cb over cr, ``_CR0`` apart) from
    the per-CTU z-slot words zl, zc (``_ctu_zslots``); returns (y,
    cbcr). The plain version of the CUDA kernel.

    A loop over the diagonals d and then the z-slots j: the ops at slot
    j of the CTUs on diagonal d (one per band) touch disjoint blocks and
    read only what earlier steps wrote, so each (d, j) group is one lane
    batch of ``_intra_op_delta`` at the slot's Smax, added with one
    scatter-add; the chroma words apply to cb and then, shifted by
    ``_CR0``, to cr in the same batch. Groups with no op are skipped on
    the host (the words are read to the host once)."""
    dev = y.device
    consts = _device_tables(dev)["ang"]
    cols, rows = W >> ctb_log2, H >> ctb_log2
    Hc, Wc = H >> 1, W >> 1
    lanes = _tile_lanes_band(cols, rows)
    fzl, fzc, actm = _diag_zslots(zl.cpu().numpy(), zc.cpu().numpy(),
                                  cols, rows)
    for luma, plane, resid, fz, cl2 in ((True, y, res_y, fzl, ctb_log2),
                                        (False, cbcr, res_cbcr, fzc,
                                         ctb_log2 - 1)):
        flat = plane.view(-1)
        for d in np.flatnonzero(actm[:, 0 if luma else 1]):
            band = lanes[d] >= 0
            ctus = lanes[d][band]
            for j, (oy, ox, S) in enumerate(_zslot_table(cl2)):
                f = fz[d, band, j]
                live = (f & 1) != 0
                if not live.any():
                    continue
                ops = _tile_ops(f[live], ctus[live], cols, 1 << cl2, oy, ox)
                if luma:
                    idx, delta = _intra_op_delta(
                        plane, resid, torch.from_numpy(ops).to(dev), S,
                        True, strong_en and S == 32, H, W, consts)
                else:
                    cr = ops.copy()
                    cr[:, 1] += _CR0(Hc)
                    idx, delta = _intra_op_delta(
                        plane, resid,
                        torch.from_numpy(np.concatenate([ops, cr])).to(dev),
                        S, False, False, Hc, Wc, consts, _CR0(Hc))
                flat.scatter_add_(0, idx, delta)
    return y, cbcr


# =====================================================================
# whole picture
# =====================================================================


def _tu_sizes(tu, sizes):
    """The sizes of ``sizes`` that some TU of the numpy meta plane has."""
    t = np.asarray(tu)
    t = t[(t & 1) != 0]
    have = {4 << int(v) for v in np.unique((t >> 1) & 3)}
    return tuple(s for s in sizes if s in have)


class _PicMeta:
    """What the host knows of one picture before Phase B runs, from its
    numpy plan: every branch and loop bound of ``_recon_picture``.
    wf_mode: the intra wavefront's schedule (None: ``wf_mode_for``)."""

    def __init__(self, plan, slices=None, wf_mode=None):
        self.H, self.W = plan.H, plan.W
        self.ctb_log2 = plan.size_log2
        self.pic_w, self.pic_h = plan.pic_width, plan.pic_height
        self.strong_en = bool(plan.strong_intra)
        self.has_sao = bool(plan.has_sao)
        self.cur_idx = int(plan.cur_idx)
        self.slices = slices
        self.sizes_y = _tu_sizes(plan.tu_y, (4, 8, 16, 32))
        self.sizes_cb = _tu_sizes(plan.tu_cb, (4, 8, 16))
        self.sizes_cr = _tu_sizes(plan.tu_cr, (4, 8, 16))
        #: the used reference slots, and slot -> index among them
        self.mc_used = plan.used_slots()
        self.mc_remap = np.zeros(16, np.int32)
        self.mc_remap[self.mc_used] = np.arange(len(self.mc_used))
        self.has_mc = bool(self.mc_used)
        #: the edge and SAO maps (_MAP_KEYS), per slice when sliced
        self.maps = ([getattr(plan, k) for k, _ in _MAP_KEYS]
                     if slices is None else _slice_masked_maps(plan))
        dbv, dbh, dbcv, dbch = self.maps[:4]
        self.deblock = bool(dbv[..., 0].any() or dbh[..., 0].any()
                            or (dbcv >= 0).any() or (dbch >= 0).any())
        self.wf_mode = (_check_wf_mode(wf_mode)
                        or wf_mode_for(plan.size_log2))
        if self.wf_mode == "tile":
            #: the per-CTU z-slot words (zl, zc) of the tile kernel
            self.zslots = _ctu_zslots(plan)
            self.banks = None
        else:
            #: per bank (_BANKS order): (padded rows [D, L, 7], has-op
            #: list)
            self.banks = [_bank_rows(t, k)
                          for t, k in zip(_plan_levels(plan), _BANKS)]
            self.zslots = None


def _slice_masked_maps(plan):
    """Per-slice deblock edge maps + SAO snapshots (leading slice axis).

    Slice s's deblock pass covers exactly the edges its CTUs process
    through the (-4,-4)-shifted window (deblock_ctu): luma edge rows y
    in [ra*CTB-4, rb*CTB-4) (the last slice extends to the plane tail),
    chroma y_c in [ra*CTB/2-2, rb*CTB/2-2). SAO snapshot s keeps the
    final params for CTU rows < rb (parsed by slices <= s) and zeroes
    the not-yet-parsed rows (sao_map starts zeroed)."""
    starts = plan.slice_rows
    S = len(starts)
    bounds = list(starts[1:]) + [plan.rows]
    ctb = 1 << plan.size_log2
    dbv = np.zeros((S,) + plan.dbv.shape, np.int32)
    dbh = np.zeros((S,) + plan.dbh.shape, np.int32)
    dbcv = np.full((S,) + plan.dbcv.shape, -1, np.int32)
    dbch = np.full((S,) + plan.dbch.shape, -1, np.int32)
    sao_idx = np.zeros((S,) + plan.sao_idx.shape, plan.sao_idx.dtype)
    sao_opt = np.zeros((S,) + plan.sao_opt.shape, plan.sao_opt.dtype)
    sao_off = np.zeros((S,) + plan.sao_off.shape, plan.sao_off.dtype)
    for s, (ra, rb) in enumerate(zip(starts, bounds)):
        last = s == S - 1
        # dbv rows r hold edge y = 4r
        lo = max(0, (ra * ctb - 4) // 4)
        hi = plan.dbv.shape[0] if last else max(0, (rb * ctb - 4) // 4)
        dbv[s, lo:hi] = plan.dbv[lo:hi]
        # dbh rows r hold edge y = 8r + 4
        lo = max(0, (ra * ctb - 8) // 8)
        hi = plan.dbh.shape[0] if last else max(0, (rb * ctb - 8) // 8)
        dbh[s, lo:hi] = plan.dbh[lo:hi]
        # dbcv rows r hold chroma edge y_c = 2r
        lo = max(0, (ra * (ctb >> 1) - 2) // 2)
        hi = (plan.dbcv.shape[0] if last
              else max(0, (rb * (ctb >> 1) - 2) // 2))
        dbcv[s, lo:hi] = plan.dbcv[lo:hi]
        # dbch rows r hold chroma edge y_c = 8r + 6
        lo = max(0, (ra * (ctb >> 1) - 8) // 8)
        hi = (plan.dbch.shape[0] if last
              else max(0, (rb * (ctb >> 1) - 8) // 8))
        dbch[s, lo:hi] = plan.dbch[lo:hi]
        sao_idx[s, :rb] = plan.sao_idx[:rb]
        sao_opt[s, :rb] = plan.sao_opt[:rb]
        sao_off[s, :rb] = plan.sao_off[:rb]
    return dbv, dbh, dbcv, dbch, sao_idx, sao_opt, sao_off


def _recon_picture(x, m, pool_y, pool_cb, pool_cr, wf):
    """One picture's Phase B. x: the plan's device tensors (coef_*,
    tu_*, slot, mv, mc_used, mc_remap, the pool slot cur_idx [1], the
    four bank tensors ls, lb, cs, cb in level mode or the z-slot words
    zl, zc in tile mode, and the edge and SAO maps, per slice for a
    multi-slice picture); m: its _PicMeta; wf: the geometry's
    _LevelRunner. Returns (y, cb, cr) uint8 planes."""
    H, W = m.H, m.W
    Hc, Wc = H >> 1, W >> 1
    with trace.span("step.residual"):
        res_y = residual_plane(x["coef_y"], x["tu_y"], m.sizes_y, True)
        res_cb = residual_plane(x["coef_cb"], x["tu_cb"], m.sizes_cb,
                                False)
        res_cr = residual_plane(x["coef_cr"], x["tu_cr"], m.sizes_cr,
                                False)
    # the slot through a device index, so that a captured step reads
    # the slot of the picture it replays
    cur = x["cur_idx"]
    prior_y = pool_y.index_select(0, cur)[0].to(I32)
    prior_cb = pool_cb.index_select(0, cur)[0].to(I32)
    prior_cr = pool_cr.index_select(0, cur)[0].to(I32)
    if m.has_mc:
        # intra pictures have no inter cells: the host skips the MC pass
        with trace.span("step.mc"):
            mask, mc_y, mc_cb, mc_cr = inter_pass(
                x["slot"], x["mv"], pool_y, pool_cb, pool_cr, m.pic_w,
                m.pic_h, x["mc_used"], x["mc_remap"])
            mp = mask.repeat_interleave(4, 0).repeat_interleave(4, 1)
            y = torch.where(mp, _clip255(mc_y + res_y), prior_y)
            mpc = mask.repeat_interleave(2, 0).repeat_interleave(2, 1)
            cb = torch.where(mpc, _clip255(mc_cb + res_cb), prior_cb)
            cr = torch.where(mpc, _clip255(mc_cr + res_cr), prior_cr)
    else:
        y, cb, cr = prior_y, prior_cb, prior_cr
    # intra wavefront over padded planes; cb/cr vertically stacked so
    # each step runs ONE chroma apply for both components
    with trace.span("step.intra"):
        wf.load(y, cb, cr, res_y, res_cb, res_cr)
        if m.wf_mode == "tile":
            # the CUDA kernel on the card, its plain version on the CPU
            TK.tile_wavefront(wf.y, wf.c, wf.ry, wf.rc, x["zl"], x["zc"],
                              H, W, m.ctb_log2, m.strong_en)
        else:
            (_, hs), (_, hb), (_, cs), (_, cb_) = m.banks
            _wavefront_luma(wf, x["ls"], hs, x["lb"], hb, m.strong_en)
            _wavefront_chroma(wf, x["cs"], cs, x["cb"], cb_)
        y, cb, cr = wf.planes()
    cl2 = m.ctb_log2
    pw, ph = m.pic_w, m.pic_h

    def filters(y, cb, cr, s):
        # a span each on a one-slice picture; the replay of a multi-slice
        # picture's filters (below) runs under its step's span alone
        one = s is None
        if m.deblock:
            with trace.span("step.deblock") if one else trace.NOOP:
                y, cb, cr = deblock_frame(y, cb, cr, *(
                    x[k] if one else x[k][s]
                    for k in ("dbv", "dbh", "dbcv", "dbch")))
        if m.has_sao:
            with trace.span("step.sao") if one else trace.NOOP:
                idx, opt, off = (x[k] if one else x[k][s]
                                 for k in ("sao_idx", "sao_opt", "sao_off"))
                y = sao_plane(y, idx[:, :, 0], opt[:, :, 0], off[:, :, 0],
                              cl2, pw, ph)
                cb = sao_plane(cb, idx[:, :, 1], opt[:, :, 1],
                               off[:, :, 1], cl2 - 1, pw >> 1, ph >> 1)
                cr = sao_plane(cr, idx[:, :, 1], opt[:, :, 2],
                               off[:, :, 2], cl2 - 1, pw >> 1, ph >> 1)
        return y, cb, cr

    if m.slices is None:
        y, cb, cr = filters(y, cb, cr, None)
        return y.to(U8), cb.to(U8), cr.to(U8)
    # multi-slice (row-aligned segments): the reference decodes each
    # slice, deblocks its (-4,-4)-shifted CTU windows, then runs the
    # WHOLE-frame SAO pass with the SAO params parsed so far
    # (slice_layer, h265.cpp:4849-4866) — so earlier slices' rows are
    # SAO-filtered once per remaining slice. Cross-slice intra is
    # unavailable, so the pre-deblock reconstruction above is
    # slice-order independent; only the filter sequence replays per
    # slice, on host-masked snapshots of the edge and SAO maps.
    ctb = 1 << cl2
    st_y, st_cb, st_cr = prior_y, prior_cb, prior_cr
    for s, (ra, rb) in enumerate(m.slices):
        ly0, ly1 = ra * ctb, min(rb * ctb, H)
        st_y[ly0:ly1] = y[ly0:ly1]
        st_cb[ly0 >> 1 : ly1 >> 1] = cb[ly0 >> 1 : ly1 >> 1]
        st_cr[ly0 >> 1 : ly1 >> 1] = cr[ly0 >> 1 : ly1 >> 1]
        st_y, st_cb, st_cr = filters(st_y, st_cb, st_cr, s)
    return st_y.to(U8), st_cb.to(U8), st_cr.to(U8)


#: the plan tensors of one picture with their dtype on the wire
_PLAN_KEYS = (("coef_y", np.int16), ("tu_y", np.int16),
              ("coef_cb", np.int16), ("tu_cb", np.int16),
              ("coef_cr", np.int16), ("tu_cr", np.int16),
              ("slot", np.int8), ("mv", np.int16))
_MAP_KEYS = (("dbv", np.int16), ("dbh", np.int16), ("dbcv", np.int16),
             ("dbch", np.int16), ("sao_idx", np.int8),
             ("sao_opt", np.int8), ("sao_off", np.int8))


def _slices_of(plan):
    """The (first, end) CTU rows of a row-aligned multi-slice picture's
    segments, or None for a one-slice picture; mid-row starts raise."""
    multi = plan.multi_slice and len(plan.slice_rows) > 1
    if plan.multi_slice and (not plan.slice_aligned or not multi):
        raise StreamFeatureExcluded(
            "mid-row slice-segment starts keep the Python path "
            "(reference chroma-base domain)")
    if not multi:
        return None
    return tuple(zip(plan.slice_rows,
                     list(plan.slice_rows[1:]) + [plan.rows]))


#: the wavefront's per-picture rows of ``_upload``: the level banks
#: (level mode) and the z-slot words (tile mode)
_WF_KEYS = (*_BANKS, "zl", "zc")


def _wf_rows(m):
    """{key of _WF_KEYS: its rows} of picture meta ``m``'s mode."""
    if m.wf_mode == "tile":
        return dict(zip(("zl", "zc"), m.zslots))
    return {k: m.banks[j][0] for j, k in enumerate(_BANKS)}


def stack_plans(plans, wf_mode=None):
    """Host prep of a batch: the fields of ``_upload`` (every picture's
    plan tensors stacked [N, ...]; the wavefront rows (level banks or
    z-slot words), used slots and, for a multi-slice picture, its
    per-slice maps as one row per key, the pictures' rows concatenated)
    and each picture's _PicMeta. wf_mode: the intra schedule (None:
    ``wf_mode_for`` of each plan's CTB size)."""
    metas = [_PicMeta(p, _slices_of(p), wf_mode) for p in plans]
    fields = {k: ([np.asarray(getattr(p, k)) for p in plans], dt)
              for k, dt in _PLAN_KEYS}
    fields["mc_remap"] = ([m.mc_remap for m in metas], np.int32)
    fields["cur_idx"] = ([np.array([m.cur_idx], np.int32) for m in metas],
                         np.int32)
    used = [np.asarray(m.mc_used, np.int32) for m in metas]
    fields["mc_used"] = ([np.concatenate(used + [np.zeros(1, np.int32)])],
                         np.int32)
    rows = [_wf_rows(m) for m in metas]
    for k in _WF_KEYS:
        have = [r[k] for r in rows if k in r]
        if have:
            fields[k] = ([np.concatenate(have)], np.int32)
    for b, m in enumerate(metas):
        for (k, dt), v in zip(_MAP_KEYS, m.maps):
            fields[f"{k}.{b}"] = ([np.asarray(v)], dt)
    return fields, metas


def _picture_views(x, metas):
    """Per picture, its device views of the uploaded batch ``x``."""
    out = []
    offs = {k: 0 for k in (*_WF_KEYS, "mc_used")}
    for b, m in enumerate(metas):
        v = {k: x[k][b]
             for k, _ in _PLAN_KEYS + (("mc_remap", 0), ("cur_idx", 0))}
        n = len(m.mc_used)
        v["mc_used"] = x["mc_used"][0, offs["mc_used"]:
                                    offs["mc_used"] + n].long()
        offs["mc_used"] += n
        for k, r in _wf_rows(m).items():
            v[k] = x[k][0, offs[k]: offs[k] + len(r)]
            offs[k] += len(r)
        for k, _ in _MAP_KEYS:
            v[k] = x[f"{k}.{b}"][0]
        out.append(v)
    return out


def recon_plan(plan, pool_y, pool_cb, pool_cr, device=None, wf_mode=None):
    """Reconstruct one plan against the pool stacks (numpy or tensors);
    returns (y, cb, cr) uint8 tensors on ``device`` (default: the CUDA
    device). wf_mode: the intra schedule, "tile" or "level" (None:
    ``wf_mode_for`` of the plan's CTB size)."""
    dev = resolve_device(device)
    pools = [torch.as_tensor(p).to(dev) for p in (pool_y, pool_cb, pool_cr)]
    fields, metas = stack_plans([plan], wf_mode)
    x = _picture_views(_upload(fields, dev), metas)[0]
    return _recon_picture(x, metas[0], *pools,
                          _LevelRunner(plan.H, plan.W, dev))


def replay_plans(plans, pool_size=8, device=None, wf_mode=None):
    """Replay recorded plans through Phase B over a fresh pool (the
    decoder's zero-initialized 8-frame pool); returns per-picture
    (y, cb, cr) uint8 numpy planes in decode order. wf_mode: as for
    ``H265SeqPhaseB``."""
    if not plans:
        return []
    ph = H265SeqPhaseB(plans[0].H, plans[0].W, pool_size, device=device,
                       wf_mode=wf_mode)
    outs = []
    for p in plans:
        y, cb, cr = (ph.run_async_one(p) if p.multi_slice
                     else ph.run_async([p]))
        outs.append((y[0].cpu().numpy(), cb[0].cpu().numpy(),
                     cr[0].cpu().numpy()))
    return outs


def _graph_key(m):
    """What fixes the ops and shapes of the picture step of ``m`` (a
    _PicMeta) in one geometry: the steps of one key replay one CUDA
    graph (``H265SeqPhaseB``). What only changes values (coefficients,
    slots, MVs, the used slots and the slot of the picture, z-slot
    words, edge and SAO maps) is read from the graph's inputs."""
    return (m.sizes_y, m.sizes_cb, m.sizes_cr, m.has_mc, len(m.mc_used),
            m.deblock, m.has_sao, m.strong_en, m.ctb_log2, m.pic_w,
            m.pic_h)


class H265SeqPhaseB:
    """Device-resident frame pool + batched multi-picture H.265 Phase B:
    each ``run_async`` copies a batch's plans to the device in one
    pinned transfer, then reconstructs its pictures in decode order,
    each reading the pool [P, H, W] and writing its slot. wf_mode: the
    intra wavefront's schedule, "tile" (the CUDA kernel on the card) or
    "level"; None picks ``wf_mode_for`` of each plan's CTB size (tile up
    to CTB 16).

    On a CUDA device a one-slice picture on the tile schedule runs as
    one CUDA graph of its whole step (``_recon_picture``), one graph per
    ``_graph_key``: the first picture of a key runs eagerly and the step
    is then captured; each later one copies its device views into the
    graph's static inputs and replays it. The graphs share one memory
    pool: they replay in order on one stream, and ``_store`` copies each
    one's planes out before the next replay. The CPU, the level schedule
    (whose per-level graphs do not nest in a capture) and multi-slice
    pictures run eagerly."""

    def __init__(self, H, W, pool_size, device=None, wf_mode=None):
        self.device = resolve_device(device)
        self.wf_mode = _check_wf_mode(wf_mode)
        self.H, self.W = H, W
        self.pool = tuple(
            torch.zeros((pool_size, h, w), dtype=U8, device=self.device)
            for h, w in ((H, W), (H >> 1, W >> 1), (H >> 1, W >> 1)))
        self.wf = _LevelRunner(H, W, self.device)
        #: per _graph_key: (graph, its output planes, [(input name, its
        #: static buffer)]); the static buffers by (name, shape, dtype);
        #: the graphs' memory pool
        self.graphs = {}
        self._static = {}
        self._graph_pool = None

    def _step(self, x, m):
        """The planes of picture step ``m`` from its device views x."""
        if (self.device.type != "cuda" or m.slices is not None
                or m.wf_mode != "tile"):
            return _recon_picture(x, m, *self.pool, self.wf)
        key = _graph_key(m)
        entry = self.graphs.get(key)
        if entry is None:
            # the eager run gives the planes and fills the lazy caches
            # (tables, the kernel's library) before the capture
            planes = _recon_picture(x, m, *self.pool, self.wf)
            self.graphs[key] = self._capture(x, m)
            return planes
        g, planes, inputs = entry
        for k, buf in inputs:
            buf.copy_(x[k])
        g.replay()
        trace.count("graph.replay", 1)
        TK.LAUNCHES["h265_tile"] += 1  # the graph's one tile launch
        return planes

    def _capture(self, x, m):
        """The CUDA graph of ``m``'s step over static copies of x's
        views (recorded, not run)."""
        inputs = []
        for k, v in x.items():
            sk = (k, tuple(v.shape), v.dtype)
            if sk not in self._static:
                self._static[sk] = torch.empty_like(v)
            inputs.append((k, self._static[sk]))
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=self._graph_pool):
            planes = _recon_picture(dict(inputs), m, *self.pool, self.wf)
        trace.count("graph.capture", 1)
        return g, planes, inputs

    def _store(self, b, cur, planes, outs):
        """Picture b's planes into pool slot ``cur`` and into outs."""
        for pool, out, v in zip(self.pool, outs, planes):
            pool[cur] = v
            out[b] = v

    def run_async(self, plans):
        """Dispatch a batch (plans in decode order); returns (y [N,H,W],
        cb, cr) uint8 device tensors without synchronising."""
        if any(p.multi_slice for p in plans):
            raise NotImplementedError(
                "multi-slice pictures dispatch via run_async_one")
        return self._run(plans)

    def run_async_one(self, plan):
        """One row-aligned multi-slice picture against the device pool
        (its per-segment deblock + SAO replay, h265.cpp:4849-4866).
        Returns outs shaped like a batch of 1."""
        return self._run([plan])

    def _run(self, plans):
        with trace.span("batch.pack"):
            fields, metas = stack_plans(plans, self.wf_mode)
        dev = _upload(fields, self.device)
        with trace.span("batch.unpack"):
            xs = _picture_views(dev, metas)
        outs = tuple(torch.empty((len(plans),) + p.shape[1:], dtype=U8,
                                 device=self.device) for p in self.pool)
        for b, (x, m) in enumerate(zip(xs, metas)):
            with trace.span("step"):
                planes = self._step(x, m)
                with trace.span("step.store"):
                    self._store(b, m.cur_idx, planes, outs)
        return outs
