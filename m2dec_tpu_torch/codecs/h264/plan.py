"""H.264 Phase-A/Phase-B boundary: the per-picture decode plan.

The two-phase engine splits the reference's single interleaved
parse+reconstruct MB loop (reference: src/lib/h264.cpp:10210-10251) into
two phases.  Phase A (bit-serial entropy decode: CAVLC/CABAC, MV
prediction, deblock-strength recording) emits the dense tensors in
:class:`PicturePlan`; Phase B (codecs/h264/reconstruct.py) consumes them
with batched integer torch ops on the device.

:class:`PlanRecorder` is the Python Phase-A producer: it taps the
existing bit-exact decoder at every pixel-producing call site, so one
decode yields both the oracle frames and the plan.  The native C++
Phase A fills the same arrays directly.

Plan layout (n = mb_w * mb_h macroblocks, raster order):

* ``kind[n]``        0=inter, 1=intra4x4, 2=intra8x8, 3=intra16x16, 4=IPCM
* ``t8x8[n]``        luma residual uses the 8x8 transform
* ``coef_luma[n,256]``   dequantized luma coefficients, ready for the
  inverse transform (DC already substituted after the Hadamard pass):
  4x4 mode = 16 raster-ordered blocks of 16 (block-raster within the MB);
  8x8 mode = 4 raster-ordered blocks of 64
* ``coef_chroma[n,2,4,16]``  per component, 4 raster 4x4 blocks
* ``i4_modes/i4_avail[n,16]``  per-4x4 pred mode + availability bits
  (1=left,2=top,4=topright,8=topleft), raster block order
* ``i8_modes/i8_avail[n,4]``, ``i16_mode[n]``, ``chroma_mode[n]``,
  ``mb_avail[n]`` (constrained-intra-filtered availability for
  16x16/chroma prediction)
* ``mv[n,16,2,2]``   quarter-pel MVs per 4x4 block (raster), per list
* ``slot[n,4,2]``    reference frame-pool index per 8x8 quadrant per
  list; -1 = list unused
* ``wp[n,4,3,4]``    per-quadrant per-plane (w0, w1, offset, logWD)
  unifying plain copy / AVERAGE2 / explicit / implicit weighting:
  uni:  clip(((p*w0 + rnd) >> s) + o)
  bi:   clip(((p0*w0 + p1*w1 + rnd) >> s) + o), rnd = s ? 1<<(s-1) : 0
* ``pcm``            dict mbpos -> (y 16x16, cb 8x8, cr 8x8 uint8)
* deblock arrays (finalized from the recorded per-MB strengths with the
  reference's raster-order idc/slice-header state machine,
  deblock_pb h264.cpp:10540-10663):
  ``deb_str[n,2,4]`` strength bytes (axis 0: vertical-edge set /
  horizontal-edge set; 4 edges, [0]=MB edge post-gating),
  ``deb_str4[n,2]`` intra MB-edge flag,
  ``deb_ab[n,2,6,2]`` alpha/beta indices (-16-based, negative = off)
  rows: MB-edge luma/cb/cr, inner luma, inner cb, inner cr.
"""

from __future__ import annotations

import numpy as np


KIND_INTER, KIND_I4, KIND_I8, KIND_I16, KIND_PCM = 0, 1, 2, 3, 4

# wp row presets
WP_COPY = (1, 0, 0, 0)
WP_AVG = (1, 1, 0, 1)


class PicturePlan:
    def __init__(self, mb_w, mb_h, alloc="zeros"):
        """alloc="empty" skips zero-initialization: only valid for the
        native Phase A, whose h264p_begin_picture(clear=1) memsets every
        densely-consumed field in C and gates the coefficient planes
        behind the per-MB coded map."""
        n = mb_w * mb_h
        self.mb_w, self.mb_h, self.n = mb_w, mb_h, n
        z = np.empty if alloc == "empty" else np.zeros
        self.kind = z(n, np.int32)
        self.t8x8 = z(n, np.int32)
        self.coef_luma = z((n, 256), np.int32)
        self.coef_chroma = z((n, 2, 4, 16), np.int32)
        self.i4_modes = z((n, 16), np.int32)
        self.i4_avail = z((n, 16), np.int32)
        self.i8_modes = z((n, 4), np.int32)
        self.i8_avail = z((n, 4), np.int32)
        self.i16_mode = z(n, np.int32)
        self.chroma_mode = z(n, np.int32)
        self.mb_avail = z(n, np.int32)
        self.mv = z((n, 16, 2, 2), np.int32)
        self.slot = (np.empty((n, 4, 2), np.int32) if alloc == "empty"
                     else np.full((n, 4, 2), -1, np.int32))
        self.wp = z((n, 4, 3, 4), np.int32)
        self.pcm: dict = {}
        # deblock (filled by finalize_deblock)
        self.deb_str = z((n, 2, 4), np.int32)
        self.deb_str4 = z((n, 2), np.int32)
        self.deb_ab = (np.empty((n, 2, 6, 2), np.int32) if alloc == "empty"
                       else np.full((n, 2, 6, 2), -16, np.int32))
        # per-MB coded-block bitmap (native Phase A; None for the
        # Python recorder producers)
        self.coded = None
        # frame-pool index this picture reconstructs into (driver use)
        self.cur_idx = -1
        self.poc = 0

    # ------------------------------------------------------------------
    def used_slots(self):
        s = np.unique(self.slot)
        return [int(v) for v in s if v >= 0]


class PlanRecorder:
    """Phase-A tap: collects a PicturePlan while the Python decoder runs."""

    def __init__(self, dec):
        self.dec = dec
        self.plan = PicturePlan(dec.max_x, dec.max_y)
        self.plan.cur_idx = dec.cur_idx

    # --- helpers -------------------------------------------------------
    def _mb(self, y, x):
        return (y >> 4) * self.plan.mb_w + (x >> 4)

    def _mb_c(self, y, x):
        return (y >> 3) * self.plan.mb_w + (x >> 3)

    # --- MB kind -------------------------------------------------------
    def set_kind(self, mbpos, kind):
        self.plan.kind[mbpos] = kind

    def set_t8x8(self, mbpos, flag):
        self.plan.t8x8[mbpos] = flag

    # --- intra ---------------------------------------------------------
    def intra4(self, y, x, mode, avail):
        mb = self._mb(y, x)
        blk = ((y & 15) >> 2) * 4 + ((x & 15) >> 2)
        self.plan.i4_modes[mb, blk] = mode
        self.plan.i4_avail[mb, blk] = avail

    def intra8(self, y, x, mode, avail):
        mb = self._mb(y, x)
        blk = ((y & 15) >> 3) * 2 + ((x & 15) >> 3)
        self.plan.i8_modes[mb, blk] = mode
        self.plan.i8_avail[mb, blk] = avail

    def intra16(self, mbpos, mode, avail):
        self.plan.i16_mode[mbpos] = mode
        self.plan.mb_avail[mbpos] = avail

    def chroma_pred(self, mbpos, mode, avail):
        self.plan.chroma_mode[mbpos] = mode
        self.plan.mb_avail[mbpos] = avail

    def pcm(self, mbpos, yblk, cbblk, crblk):
        self.plan.pcm[mbpos] = (yblk.copy(), cbblk.copy(), crblk.copy())

    # --- residual ------------------------------------------------------
    def idct4_luma(self, y, x, coeff16):
        mb = self._mb(y, x)
        blk = ((y & 15) >> 2) * 4 + ((x & 15) >> 2)
        self.plan.coef_luma[mb, blk * 16 : blk * 16 + 16] = coeff16

    def idct4_luma_dc(self, y, x, dc):
        mb = self._mb(y, x)
        blk = ((y & 15) >> 2) * 4 + ((x & 15) >> 2)
        self.plan.coef_luma[mb, blk * 16] = dc

    def idct8_luma(self, y, x, coeff64):
        mb = self._mb(y, x)
        blk = ((y & 15) >> 3) * 2 + ((x & 15) >> 3)
        self.plan.coef_luma[mb, blk * 64 : blk * 64 + 64] = coeff64

    def idct4_chroma(self, c, y, x, coeff16):
        mb = self._mb_c(y, x)
        blk = ((y & 7) >> 2) * 2 + ((x & 7) >> 2)
        self.plan.coef_chroma[mb, c, blk] = coeff16

    def idct4_chroma_dc(self, c, y, x, dc):
        mb = self._mb_c(y, x)
        blk = ((y & 7) >> 2) * 2 + ((x & 7) >> 2)
        self.plan.coef_chroma[mb, c, blk, 0] = dc

    # --- inter ---------------------------------------------------------
    def inter(self, x0, y0, bw, bh, slots, mvs, wp3x4):
        """One predicted partition.

        slots: (slot_l0, slot_l1) frame-pool indices, -1 inactive.
        mvs: [2][2] quarter-pel.  wp3x4: per-plane (w0, w1, o, s).
        """
        p = self.plan
        mb = self._mb(y0, x0)
        ox, oy = x0 & 15, y0 & 15
        wp = np.asarray(wp3x4, np.int32)
        for by in range(oy >> 2, (oy + bh) >> 2):
            for bx in range(ox >> 2, (ox + bw) >> 2):
                blk = by * 4 + bx
                q = (by >> 1) * 2 + (bx >> 1)
                p.slot[mb, q, 0] = slots[0]
                p.slot[mb, q, 1] = slots[1]
                p.wp[mb, q] = wp
                for lx in range(2):
                    if slots[lx] >= 0:
                        p.mv[mb, blk, lx] = (int(mvs[lx][0]), int(mvs[lx][1]))

    # --- deblock -------------------------------------------------------
    def finalize(self):
        """Convert the decoder's DeblockInfo records into flat edge
        parameters (see finalize_deblock)."""
        dec = self.dec
        p = self.plan
        n = p.n
        idc = np.zeros(n, np.int64)
        slicehdr = np.zeros((n, 2), np.int64)
        qpy = np.zeros(n, np.int64)
        qpc = np.zeros((n, 2), np.int64)
        str4 = np.zeros((n, 2), np.int64)
        strs = np.zeros((n, 2), np.int64)
        for i, d in enumerate(dec.deblock):
            idc[i] = d.idc
            slicehdr[i] = d.slicehdr
            qpy[i] = d.qpy
            qpc[i] = d.qpc
            str4[i] = (d.str4_horiz, d.str4_vert)   # (vert-edge, horiz-edge)
            strs[i] = (d.str_horiz, d.str_vert)
        finalize_deblock(p, idc, slicehdr, qpy, qpc, str4, strs,
                         dec.firstline)
        # liveness for device-pool compaction (reconstruct._DevSlotMap)
        p.live = sorted(
            {rf.frame_idx for lx in (0, 1) for rf in dec.refs[lx]
             if rf.in_use} | {p.cur_idx})
        return p


def finalize_deblock(p, idc_a, slicehdr_a, qpy_a, qpc_a, str4_a, str_a,
                     firstline):
    """Flatten raw per-MB deblock records into edge parameters,
    replicating deblock_pb's raster-order running idc/slice-header state
    (h264.cpp:10540-10663) including the firstline quirks.

    Axis-0 of str4_a/str_a: [0] = vertical-edge set (the reference's
    str4_horiz/str_horiz), [1] = horizontal-edge set."""
    max_x, max_y = p.mb_w, p.mb_h
    idc = 0
    a_ofs = b_ofs = 0
    for y in range(max_y):
        for x in range(max_x):
            mbpos = y * max_x + x
            if idc_a[mbpos]:
                idc = int(idc_a[mbpos]) - 1
                a_ofs, b_ofs = int(slicehdr_a[mbpos, 0]), int(
                    slicehdr_a[mbpos, 1])
            if idc == 1:
                continue
            qpy = int(qpy_a[mbpos])
            qpc = (int(qpc_a[mbpos, 0]), int(qpc_a[mbpos, 1]))
            strv = int(str_a[mbpos, 0])
            strh = int(str_a[mbpos, 1])

            def ab(qp):
                return (min(qp + a_ofs, 51) - 16, min(qp + b_ofs, 51) - 16)

            if (x != 0 and (not idc or firstline != max_x)
                    and (strv & 255)):
                lp = mbpos - 1
                p.deb_str[mbpos, 0, 0] = strv & 255
                p.deb_str4[mbpos, 0] = str4_a[mbpos, 0]
                p.deb_ab[mbpos, 0, 0] = ab((qpy + int(qpy_a[lp]) + 1) >> 1)
                for c in range(2):
                    p.deb_ab[mbpos, 0, 1 + c] = ab(
                        (qpc[c] + int(qpc_a[lp, c]) + 1) >> 1)
            if strv & ~255:
                p.deb_ab[mbpos, 0, 3] = ab(qpy)
                for e in range(1, 4):
                    p.deb_str[mbpos, 0, e] = (strv >> (8 * e)) & 255
                if (strv >> 16) & 255:
                    for c in range(2):
                        p.deb_ab[mbpos, 0, 4 + c] = ab(qpc[c])
            if (y != 0 and (not idc or firstline < 0)
                    and (strh & 255)):
                tp = mbpos - max_x
                p.deb_str[mbpos, 1, 0] = strh & 255
                p.deb_str4[mbpos, 1] = str4_a[mbpos, 1]
                p.deb_ab[mbpos, 1, 0] = ab((qpy + int(qpy_a[tp]) + 1) >> 1)
                for c in range(2):
                    p.deb_ab[mbpos, 1, 1 + c] = ab(
                        (qpc[c] + int(qpc_a[tp, c]) + 1) >> 1)
            if strh & ~255:
                p.deb_ab[mbpos, 1, 3] = ab(qpy)
                for e in range(1, 4):
                    p.deb_str[mbpos, 1, e] = (strh >> (8 * e)) & 255
                if (strh >> 16) & 255:
                    for c in range(2):
                        p.deb_ab[mbpos, 1, 4 + c] = ab(qpc[c])
    return p
