"""H.265 Phase-A/Phase-B boundary: the per-picture decode plan.

Mirrors the H.264 engine's architecture (codecs/h264/plan.py): Phase A
(bit-serial CABAC entropy decode, MV derivation, deblock-strength
recording — the reference's sequential CTU walk, h265.cpp:4734-4848)
emits dense per-picture tensors; Phase B (codecs/h265/reconstruct.py)
consumes them with batched integer torch ops.

The decomposition exploits the reference's own scheduling slack:

* inter prediction reads only *reference* frames (no intra-frame
  dependence) -> one dense whole-picture MC pass;
* the in-loop deblocking trails reconstruction by a (-4,-4)-shifted
  window (deblock_ctu, h265.cpp:4125-4384), so intra prediction never
  observes filtered samples -> deblocking decouples into whole-frame
  vertical-then-horizontal passes;
* SAO is a whole-frame second pass over pre-SAO samples
  (sao_oneframe, h265.cpp:4462-4729) -> a pure per-pixel map;
* only the intra chain keeps sequential structure: CTUs run as a
  wavefront over anti-diagonals d = cx + 2*cy, the ops inside a CTU in
  z-order (coding order).

Plan layout (W, H = CTU-aligned plane dims; cells are 4x4 luma):

* ``coef_y [H, W]`` / ``coef_cb``/``coef_cr [H/2, W/2]`` int16 —
  dequantized coefficients at their TU raster positions, *sanitized*:
  only positions the reference transform's selected variant reads are
  kept (the persistent coeff_buf stale-read domains become zeros,
  residual.py:85-190);
* ``tu_y [H/4, W/4]`` / ``tu_cb``/``tu_cr [H/8, W/8]`` int16 — at each
  TU origin: 1 | (log2-2)<<1 | variant<<3 | dst<<5 | tskip<<6, where
  variant = (size<=xy_pos_sum)*2 | ((xy_pos_sum&(size-1))!=0) selects
  the reference's dconly/horiz/vert/full transform path;
* ``slot [H/4, W/4, 2]`` frame-pool index per list (-1 unused),
  ``mv [H/4, W/4, 2, 2]`` — per-4x4-cell motion (PU-uniform, so the
  per-cell decomposition is exact);
* ``ops_l [n_ctu, CAPL, 7]`` / ``ops_c [n_ctu, CAPC, 7]`` int32 — the
  z-ordered intra ops per CTU: (used, y0, x0, size_log2, mode,
  valid_x, valid_y) in plane coordinates (chroma ops in chroma
  coords); flags folded into ``used`` (bit1 = DC stray-pixel write,
  see pred_dc top-only, intra.py:186-198);
* deblock edge parameter maps (recorded from the per-CTU filter with
  strengths/thresholds resolved — h265modules.h:476-662):
  ``dbv [H/4, W/8, 3]`` (str, beta, tc) vertical luma windows at
  x = 8k+4, ``dbh [(H/8), W/4, 3]`` horizontal windows at y = 8k+4,
  ``dbcv [Hc/2, Wc/8, 2]`` / ``dbch [Hc/8, Wc/2, 2]`` chroma tc per
  cb/cr (-1 = off);
* ``sao_* [rows, cols, ...]`` resolved per-CTU SAO parameters
  (left-merge chains flattened).
"""

from __future__ import annotations

import numpy as np


class H265Plan:
    def __init__(self, sps, columns, rows, size_log2):
        self.columns = columns
        self.rows = rows
        self.size_log2 = size_log2
        W = columns << size_log2
        H = rows << size_log2
        self.W, self.H = W, H
        self.pic_width = sps.pic_width
        self.pic_height = sps.pic_height
        self.strong_intra = sps.strong_intra_smoothing
        n = columns * rows
        self.coef_y = np.zeros((H, W), np.int16)
        self.coef_cb = np.zeros((H >> 1, W >> 1), np.int16)
        self.coef_cr = np.zeros((H >> 1, W >> 1), np.int16)
        self.tu_y = np.zeros((H >> 2, W >> 2), np.int16)
        self.tu_cb = np.zeros((H >> 3, W >> 3), np.int16)
        self.tu_cr = np.zeros((H >> 3, W >> 3), np.int16)
        self.slot = np.full((H >> 2, W >> 2, 2), -1, np.int8)
        self.mv = np.zeros((H >> 2, W >> 2, 2, 2), np.int16)
        # z-ordered intra op lists per CTU (padded at finalize)
        self._ops_l = [[] for _ in range(n)]
        self._ops_c = [[] for _ in range(n)]
        self.ops_l = None
        self.ops_c = None
        # deblock edge maps: str 0 = off
        self.dbv = np.zeros((H >> 2, W >> 3, 3), np.int16)
        self.dbh = np.zeros((H >> 3, W >> 2, 3), np.int16)
        self.dbcv = np.full((H >> 2, W >> 4, 2), -1, np.int16)
        self.dbch = np.full((H >> 4, W >> 2, 2), -1, np.int16)
        # SAO per-CTU resolved params
        self.sao_idx = np.zeros((rows, columns, 2), np.int8)  # luma, chroma
        self.sao_opt = np.zeros((rows, columns, 3), np.int8)  # y, cb, cr
        self.sao_off = np.zeros((rows, columns, 3, 4), np.int8)
        self.has_sao = False
        self.multi_slice = False
        # CTU row of each slice-segment start (row-aligned segments; the
        # multi-slice Phase B replays the reference's per-slice
        # decode -> deblock -> whole-frame-SAO sequence from these)
        self.slice_rows = [0]
        self.slice_aligned = True
        self.cur_idx = -1
        self.poc = 0
        self.oracle = None  # test-only: post-picture oracle planes

    def used_slots(self):
        s = np.unique(self.slot)
        return [int(v) for v in s if v >= 0]


class PlanRecorder:
    """Phase-A tap: fills an H265Plan while the Python decoder runs.

    Hook points: Ctu._intra_luma/_intra_chroma (intra ops),
    residual.residual_coding (sanitized coefficients),
    inter_cu.motion_compensate (dense MV/slot cells),
    Deblocking._edge_{luma,chroma}_block (edge parameters), and
    sao_map resolution at finalize."""

    def __init__(self, ctu, cur_idx):
        self.ctu = ctu
        self.plan = H265Plan(ctu.sps, ctu.columns, ctu.rows,
                             ctu.size_log2)
        self.plan.cur_idx = cur_idx

    # -- intra ops -------------------------------------------------------
    def _ctu_idx(self):
        c = self.ctu
        return c.pos_y * c.columns + c.pos_x

    def intra_op(self, is_luma, y0, x0, size_log2, mode, vx, vy):
        p = self.plan
        used = 1
        if is_luma and mode == 1 and size_log2 < 5 and vx > 0 and vy <= 0 \
                and y0 + (1 << size_log2) < p.H:
            used |= 2  # DC top-only stray-row write candidate
        op = [used, y0, x0, size_log2, mode, vx, vy]
        (p._ops_l if is_luma else p._ops_c)[self._ctu_idx()].append(op)

    # -- residual --------------------------------------------------------
    def residual(self, colour, y0, x0, size_log2, coeff, xy_pos_sum,
                 tskip, use_dst):
        """Record the sanitized dequantized coefficient matrix + the
        transform variant the reference selects (residual.py:314-366)."""
        p = self.plan
        size = 1 << size_log2
        variant = (int(size <= xy_pos_sum) * 2
                   + int((xy_pos_sum & (size - 1)) != 0))
        mat = np.zeros((size, size), np.int16)
        if tskip:
            if xy_pos_sum:
                mat[:, :] = np.asarray(
                    coeff[: size * size], np.int64).reshape(size, size)
            else:
                mat[0, 0] = coeff[0]
        elif use_dst:
            if variant == 0:
                mat[0, 0] = coeff[0]
            else:
                mat[:, :] = np.asarray(
                    coeff[: size * size], np.int64).reshape(size, size)
        elif variant == 0:
            mat[0, 0] = coeff[0]
        elif variant == 1:
            mat[0, :] = coeff[:size]
        elif variant == 2:
            mat[:, 0] = [coeff[i << size_log2] for i in range(size)]
        else:
            mat[:, :] = np.asarray(
                coeff[: size * size], np.int64).reshape(size, size)
        meta = (1 | ((size_log2 - 2) << 1) | (variant << 3)
                | (int(use_dst) << 5) | (int(tskip) << 6))
        coefp, tu = ((p.coef_y, p.tu_y), (p.coef_cb, p.tu_cb),
                     (p.coef_cr, p.tu_cr))[colour]
        coefp[y0 : y0 + size, x0 : x0 + size] = mat
        tu[y0 >> 2, x0 >> 2] = meta

    # -- inter -----------------------------------------------------------
    def inter(self, x0, y0, width, height, slot0, slot1, mv0, mv1):
        p = self.plan
        cy, cx = y0 >> 2, x0 >> 2
        ch, cw = height >> 2, width >> 2
        p.slot[cy : cy + ch, cx : cx + cw, 0] = slot0
        p.slot[cy : cy + ch, cx : cx + cw, 1] = slot1
        if slot0 >= 0:
            p.mv[cy : cy + ch, cx : cx + cw, 0] = (int(mv0[0]), int(mv0[1]))
        if slot1 >= 0:
            p.mv[cy : cy + ch, cx : cx + cw, 1] = (int(mv1[0]), int(mv1[1]))

    # -- deblock ---------------------------------------------------------
    def deblock_luma(self, y, x, vert, strength, beta, tc):
        p = self.plan
        if vert:
            p.dbv[y >> 2, (x - 4) >> 3] = (strength, beta, tc)
        else:
            p.dbh[(y - 4) >> 3, x >> 2] = (strength, beta, tc)

    def deblock_chroma(self, y, x, vert, ci, tc):
        p = self.plan
        if vert:
            p.dbcv[y >> 1, (x - 6) >> 3, ci] = tc
        else:
            p.dbch[(y - 6) >> 3, x >> 1, ci] = tc

    # -- finalize ---------------------------------------------------------
    def note_slice(self, first_slice, slice_addr=0):
        if not first_slice:
            p = self.plan
            p.multi_slice = True
            if slice_addr % p.columns:
                p.slice_aligned = False  # mid-row start: Python path
            else:
                p.slice_rows.append(slice_addr // p.columns)

    def finalize_sao(self):
        """Resolve the per-CTU SAO maps through their left-merge chains
        (the reference resolves at apply time, sao.py:_region)."""
        ctu = self.ctu
        p = self.plan
        p.has_sao = bool(ctu.hdr.sao_luma or ctu.hdr.sao_chroma)
        maps = ctu.sao_map
        for y in range(p.rows):
            for x in range(p.columns):
                i = y * p.columns + x
                j = i
                steps = x
                while steps and maps[j].merge_left:
                    j -= 1
                    steps -= 1
                m = maps[j]
                p.sao_idx[y, x, 0] = m.luma_idx
                p.sao_idx[y, x, 1] = m.chroma_idx
                for ei in range(3):
                    p.sao_opt[y, x, ei] = m.elem[ei][1]
                    p.sao_off[y, x, ei] = m.elem[ei][0]

    def finalize(self, drop_stray_on_inter=True):
        p = self.plan
        self.finalize_sao()
        # stray DC writes that a later inter-predicted cell overwrites in
        # decode order must not survive the (early) dense MC pass
        if drop_stray_on_inter:
            inter_cell = (p.slot[:, :, 0] >= 0) | (p.slot[:, :, 1] >= 0)
            for ops in p._ops_l:
                for op in ops:
                    if op[0] & 2:
                        sy = op[1] + (1 << op[3])
                        if inter_cell[sy >> 2, op[2] >> 2]:
                            op[0] &= ~2
        def pack(lists):
            cap = max((len(o) for o in lists), default=0)
            cap = max(1, cap)
            # bucket to limit jit keys
            b = 1
            while b < cap:
                b *= 2
            arr = np.zeros((len(lists), b, 7), np.int32)
            for i, ops in enumerate(lists):
                if ops:
                    arr[i, : len(ops)] = ops
            return arr

        p.ops_l = pack(p._ops_l)
        p.ops_c = pack(p._ops_c)
        return p
