"""H.265 CTU decode: quad-tree parse + in-frame intra reconstruction.

Mirrors the reference's single-pass CTU walk (h265.cpp:4734-4848):
`slice_data` loops coding_tree_unit over the picture; the end-of-slice
terminate bin is read after every CTU EXCEPT the last (the loop breaks on
position first, h265.cpp:4841-4846 — the spec's final flag is never
consumed, same family of quirk as H.264's fill-by-MB-count).

Neighbour state: per-4x4-column records (h265d_neighbour_t) with
pred_mode reset to DC at each CTU top (ctu_pos_increment,
h265.cpp:4830), depth used by split_cu_flag contexts.

Residual decode (transform_unit) is the next milestone; cbf != 0 raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from decode_bench.ref.h265 import cabac as C
from decode_bench.ref.h265 import intra

def _minu(v, b):
    """MINV(static_cast<uint32_t>(v), b): negative v wraps to a huge
    unsigned, so the clamp returns b — boundary-split children whose
    remainder is negative are NOT pruned but decoded with a wrapped
    validity of block_len, predicting into the frame padding
    (quad_tree/transform_tree child args, h265.cpp:4110-4115, 3050-3058).
    """
    return min(v & 0xFFFFFFFF, b)


INTRA_DC = 1
INTRA_PLANAR = 0
INTRA_ANGULAR26 = 26
NEIGHBOUR_NUM = 16  # H265D_NEIGHBOUR_NUM: 4x4 columns per 64-wide CTU


class PredInfo:
    """pred_info_t: per-4x4 inter prediction record."""

    __slots__ = ("ref_idx", "mv")

    def __init__(self):
        self.ref_idx = [-1, -1]
        self.mv = [[0, 0], [0, 0]]

    def reset(self):
        """neighbour_init (h265.cpp:4743-4750): only skip/pu_intra/
        pred_mode/depth are reset; tu_*/pred stay stale on purpose."""
        self.skip = 0
        self.pu_intra = 1
        self.pred_mode = INTRA_DC
        self.depth = 0

    def copy(self):
        p = PredInfo()
        p.ref_idx = list(self.ref_idx)
        p.mv = [list(self.mv[0]), list(self.mv[1])]
        return p

    def same(self, other):
        return self.ref_idx == other.ref_idx and self.mv == other.mv


@dataclasses.dataclass
class Neighbour:
    skip: int = 0
    pu_intra: int = 1
    pred_mode: int = INTRA_DC
    depth: int = 0
    pu_nonzero_coef: int = 0
    tu_intra: int = 1
    tu_nonzero_coef: int = 0
    pred: PredInfo = dataclasses.field(default_factory=PredInfo)

    def reset(self):
        """neighbour_init (h265.cpp:4743-4750): only skip/pu_intra/
        pred_mode/depth are reset; tu_*/pred stay stale on purpose."""
        self.skip = 0
        self.pu_intra = 1
        self.pred_mode = INTRA_DC
        self.depth = 0

    def copy(self):
        n = Neighbour(self.skip, self.pu_intra, self.pred_mode,
                      self.depth, self.pu_nonzero_coef, self.tu_intra,
                      self.tu_nonzero_coef, self.pred.copy())
        return n


def _neighbour_init(arr):
    for n in arr:
        n.skip = 0
        n.pu_intra = 1
        n.pred_mode = INTRA_DC
        n.depth = 0


def intra_pred_candidate(cand_a, cand_b):
    """h265.cpp:1385-1409."""
    if cand_a == cand_b:
        if cand_a <= INTRA_DC:
            return [INTRA_PLANAR, INTRA_DC, INTRA_ANGULAR26]
        return [cand_a, ((cand_a - 3) & 31) + 2, ((cand_a - 1) & 31) + 2]
    if cand_a != INTRA_PLANAR and cand_b != INTRA_PLANAR:
        c = INTRA_PLANAR
    elif cand_a != INTRA_DC and cand_b != INTRA_DC:
        c = INTRA_DC
    else:
        c = INTRA_ANGULAR26
    return [cand_a, cand_b, c]


def intra_chroma_pred_dir(chroma_mode_idx, luma_mode):
    """h265.cpp:1367-1383."""
    if chroma_mode_idx == 0:
        return 34 if luma_mode == 0 else 0
    if chroma_mode_idx == 1:
        return 34 if luma_mode == 26 else 26
    if chroma_mode_idx == 2:
        return 34 if luma_mode == 10 else 10
    if chroma_mode_idx == 3:
        return 34 if luma_mode == 1 else 1
    return luma_mode


class Ctu:
    """h265d_ctu_t equivalent over planar numpy planes."""

    def __init__(self, sps, pps, hdr, frame):
        """Persistent context (h265d_ctu_t): allocated once per sequence;
        per-slice state is (re)set by init_slice (= reference ctu_init,
        h265.cpp:4752-4800). sao_map / deblock storage / coeff_buf and the
        qp-scale cache persist across slices AND pictures (stale-read
        quirks carried on purpose)."""
        self.sps = sps
        self.cb = C.H265Cabac()
        self.size_log2 = sps.log2_ctb
        self.size_log2_min = sps.log2_min_cb
        self.transform_log2 = sps.log2_max_tb
        self.transform_log2_min = sps.log2_min_tb
        self.columns = (sps.pic_width + (1 << self.size_log2) - 1) \
            >> self.size_log2
        self.rows = (sps.pic_height + (1 << self.size_log2) - 1) \
            >> self.size_log2
        self.stride = self.columns << self.size_log2
        self.intra_split = 0
        self.order_luma = [0, 0, 0, 0]
        self.order_chroma = 0
        self.qp_delta_req = 0
        self.coeff_buf = [0] * (32 * 32)  # persistent (stale-read quirk)
        # reference h265d_ctu_t is zero-initialized: qpy starts 0 and the
        # qp-scale cache is only refreshed when slice_qpy differs
        self.qpy = 0
        self.qp_scale = ([0] * 64, [0] * 64, [0] * 64)
        self.qpc_delta = (0, 0)
        self.neighbour_left = [Neighbour() for _ in range(NEIGHBOUR_NUM + 2)]
        self.neighbour_top = [Neighbour()
                              for _ in range(self.columns * NEIGHBOUR_NUM)]
        from decode_bench.ref.h265.deblock import Deblocking
        from decode_bench.ref.h265.sao import SaoMap

        self.deblocking = Deblocking(self)
        self.colpics = None  # set by the decoder when a pool exists
        self.rec = None  # optional plan.PlanRecorder (Phase-A tap)
        self.sao_map = [SaoMap() for _ in range(self.columns * self.rows)]
        self.init_slice(pps, hdr, frame)

    def init_slice(self, pps, hdr, frame):
        """ctu_init (h265.cpp:4752-4800): per-slice-segment reset."""
        self.pps = pps
        self.hdr = hdr
        self.frame = frame
        sps = self.sps
        slice_type = hdr.slice_type
        idc = (2 - (slice_type ^ hdr.cabac_init_flag)) if slice_type < 2 \
            else 0
        self.cb.init_context(hdr.slice_qpy, idc)
        addr = hdr.slice_addr
        self.pos_y = addr // self.columns
        self.pos_x = addr - self.pos_y * self.columns
        self.idx_in_slice = 0
        self.valid_x = sps.pic_width - (self.pos_x << self.size_log2)
        self.valid_y = min(sps.pic_height - (self.pos_y << self.size_log2),
                           1 << self.size_log2)
        if self.qpy != hdr.slice_qpy:
            from decode_bench.ref.h265.residual import qp_to_scale

            self.qpy = hdr.slice_qpy
            self.qp_scale = qp_to_scale(self.qpy, hdr.qpc_delta)
            self.qpc_delta = hdr.qpc_delta
        for nb in self.neighbour_left:
            nb.reset()
        for nb in self.neighbour_top:
            nb.reset()
        self.deblocking.reset_slice(hdr.deblocking_disabled, self.pos_x)
        self.qp_history = [[self.qpy] * 17, [self.qpy] * 17]

    # -- per-CTU --------------------------------------------------------
    def decode_ctu(self, r):
        """coding_tree_unit (h265.cpp:4734-4741)."""
        if self.hdr.sao_luma or self.hdr.sao_chroma:
            from decode_bench.ref.h265.sao import sao_read

            sao_read(self, r)
        idx = self.idx_in_slice
        unavail = (((not self.pos_y or idx < self.columns) * 10)
                   | ((not self.pos_x or not idx) * 5) | 4)
        self.quad_tree(r, self.size_log2, unavail, 0, self.valid_x,
                       0, self.valid_y,
                       self.neighbour_left, 2,
                       self.neighbour_top, self.pos_x * NEIGHBOUR_NUM,
                       self.neighbour_left[1].copy())
        self.deblocking.deblock_ctu()

    def pos_increment(self):
        """ctu_pos_increment (h265.cpp:4802-4833). Returns done flag."""
        sps = self.sps
        pos_x = self.pos_x + 1
        size_log2 = self.size_log2
        if self.columns <= pos_x:
            _neighbour_init(self.neighbour_left[1:])
            self.pos_y += 1
            self.valid_x = sps.pic_width
            if self.pos_y == self.rows - 1:
                self.valid_y = min(
                    sps.pic_height - (self.pos_y << size_log2),
                    1 << size_log2)
            pos_x = 0
        else:
            self.valid_x -= 1 << size_log2
            self.neighbour_left[1] = self.neighbour_left[0].copy()
        self.neighbour_left[0] = self.neighbour_top[
            ((pos_x + 1) << (size_log2 - 2)) - 1].copy()
        self.pos_x = pos_x
        self.idx_in_slice += 1
        top = self.neighbour_top
        base = pos_x * NEIGHBOUR_NUM
        for i in range(NEIGHBOUR_NUM):
            top[base + i].pred_mode = INTRA_DC
        return self.rows <= self.pos_y

    # -- quad tree ------------------------------------------------------
    def quad_tree(self, r, size_log2, unavail, offset_x, valid_x,
                  offset_y, valid_y, left_arr, left_i, top_arr, top_i,
                  lefttop):
        if valid_x <= 0 or valid_y <= 0:
            return
        size = 1 << size_log2
        boundary = valid_x < size or valid_y < size
        if self.size_log2_min < size_log2 and (
                boundary or C.split_cu_flag(
                    self.cb, r, size_log2,
                    left_arr[left_i].depth, top_arr[top_i].depth)):
            # boundary short-circuits: the flag is not read (h265.cpp:4104)
            size_log2 -= 1
            block_len = 1 << size_log2
            info = 1 << (size_log2 - 2)
            lefttop1 = top_arr[top_i + info - 1].copy()
            lefttop2 = left_arr[left_i + info - 1].copy()
            self.quad_tree(r, size_log2, _avail4x4idx0(unavail),
                           offset_x, valid_x, offset_y, valid_y,
                           left_arr, left_i, top_arr, top_i, lefttop)
            lefttop3 = left_arr[left_i + info - 1].copy()
            self.quad_tree(r, size_log2, _avail4x4idx1(unavail),
                           offset_x + block_len, valid_x - block_len,
                           offset_y, _minu(valid_y, block_len),
                           left_arr, left_i, top_arr, top_i + info,
                           lefttop1)
            self.quad_tree(r, size_log2, _avail4x4idx2(unavail),
                           offset_x, _minu(valid_x, block_len * 2),
                           offset_y + block_len, valid_y - block_len,
                           left_arr, left_i + info, top_arr, top_i,
                           lefttop2)
            self.quad_tree(r, size_log2, _avail4x4idx3(unavail),
                           offset_x + block_len,
                           _minu(valid_x - block_len, block_len),
                           offset_y + block_len,
                           _minu(valid_y - block_len, block_len),
                           left_arr, left_i + info, top_arr, top_i + info,
                           lefttop3)
        else:
            self.coding_unit_header(size_log2, left_arr, left_i,
                                    top_arr, top_i)
            if self.hdr.slice_type < 2:
                self.pred_inter(r, size_log2, unavail, offset_x,
                                offset_y, valid_x, valid_y, left_arr,
                                left_i, top_arr, top_i, lefttop)
            else:
                self.pred_intra(r, size_log2, unavail, offset_x,
                                offset_y, valid_x, valid_y, left_arr,
                                left_i, top_arr, top_i)

    def coding_unit_header(self, size_log2, left_arr, left_i,
                           top_arr, top_i):
        """coding_unit_header (h265.cpp:4086-4096): depth fill.

        Depth convention is 64-luma-based: 6 - size_log2
        (intra_depth_fill, h265.cpp:3110-3117)."""
        depth = 6 - size_log2
        num = 1 << (size_log2 - 2)
        for i in range(num):
            left_arr[left_i + i].depth = depth
            top_arr[top_i + i].depth = depth
        if self.pps.cu_qp_delta_enabled:
            self.qp_delta_req = 1

    # -- inter CU (pred_inter, h265.cpp:4044-4073) ----------------------
    def pred_inter(self, r, size_log2, unavail, offset_x, offset_y,
                   valid_x, valid_y, left_arr, left_i, top_arr, top_i,
                   lefttop):
        from decode_bench.ref.h265 import inter_cu

        inter_cu.pred_inter(self, r, size_log2, unavail, offset_x,
                            offset_y, valid_x, valid_y, left_arr,
                            left_i, top_arr, top_i, lefttop)

    # -- intra CU -------------------------------------------------------
    def pred_intra(self, r, size_log2, unavail, offset_x, offset_y,
                   valid_x, valid_y, left_arr, left_i, top_arr, top_i):
        """pred_intra + cu_header_intra (h265.cpp:3997-4084)."""
        cb = self.cb
        part_num = 1
        self.intra_split = 0
        if self.size_log2_min == size_log2 and \
                C.part_mode_intra(cb, r) == 0:
            self.intra_split = 1
            part_num = 4
        pred_flag = 0
        for i in range(part_num):
            pred_flag |= C.prev_intra_luma_pred_flag(cb, r) << i
        neighbour_num = 1 << (size_log2 - 2 - (part_num == 4))
        for i in range(part_num):
            lt = left_i + (i >> 1)
            tt = top_i + (i & 1)
            cand = intra_pred_candidate(left_arr[lt].pred_mode,
                                        top_arr[tt].pred_mode)
            if pred_flag & 1:
                mode = cand[C.mpm_idx(cb, r)]
            else:
                mode = C.rem_intra_luma_pred_mode(cb, r, cand)
            self.order_luma[i] = mode
            pred_flag >>= 1
            for k in range(neighbour_num):
                for nb in (left_arr[lt + k], top_arr[tt + k]):
                    nb.pred_mode = mode
                    nb.tu_intra = 1
                    nb.pu_intra = 1
                    nb.skip = 0
        if part_num != 4:
            self.order_luma[1:] = [self.order_luma[0]] * 3
        chroma_idx = C.intra_chroma_pred_mode(cb, r)
        self.order_chroma = intra_chroma_pred_dir(chroma_idx,
                                                  self.order_luma[0])
        if self.colpics is not None:
            self.colpics.fill(offset_x, offset_y, 1 << size_log2,
                              1 << size_log2, intra=True)
        self.transform_tree(r, size_log2, unavail, 0, 3, offset_x,
                            valid_x, offset_y, valid_y, 0, 0, True,
                            left_arr, left_i, top_arr, top_i)

    # -- transform tree (intra path) ------------------------------------
    def transform_tree(self, r, size_log2, unavail, depth, upper_cbf_cbcr,
                       offset_x, valid_x, offset_y, valid_y, idx, pred_idx,
                       is_intra=True, left_arr=None, left_i=0,
                       top_arr=None, top_i=0):
        """transform_tree (h265.cpp:3026-3076)."""
        cb = self.cb
        # transform_split_decision (h265.cpp:2919-2939)
        if self.transform_log2 < size_log2:
            split = 1
        elif is_intra:
            if depth == 0 and self.intra_split:
                split = 2
            elif (self.transform_log2_min < size_log2 and depth
                  < self.sps.max_transform_hierarchy_depth_intra):
                split = C.split_transform_flag(cb, r, size_log2)
            else:
                split = 0
        elif (self.transform_log2_min < size_log2
              and depth < self.sps.max_transform_hierarchy_depth_inter):
            split = C.split_transform_flag(cb, r, size_log2)
        else:
            split = (depth == 0) and self.intra_split
        # cbf_chroma_update (h265.cpp:2945-2956)
        if 2 < size_log2:
            cbf = (C.cbf_chroma(cb, r, depth) * 2
                   if upper_cbf_cbcr & 2 else 0)
            if upper_cbf_cbcr & 1:
                cbf |= C.cbf_chroma(cb, r, depth)
        else:
            cbf = upper_cbf_cbcr
        if split:
            pi, pinc = (0, 1) if split == 2 else (pred_idx, 0)
            size_log2 -= 1
            if is_intra and size_log2 == 2:
                # 4x4 split: chroma is predicted once at 8x8
                self._intra_chroma(size_log2, offset_x, offset_y,
                                   unavail, valid_x, valid_y)
            depth += 1
            block_len = 1 << size_log2
            blen = 1 << (size_log2 - 2)
            self.transform_tree(r, size_log2, unavail, depth, cbf,
                                offset_x, valid_x, offset_y, valid_y,
                                0, pi, is_intra, left_arr, left_i,
                                top_arr, top_i)
            pi += pinc
            self.transform_tree(r, size_log2, unavail & ~1, depth, cbf,
                                offset_x + block_len, valid_x - block_len,
                                offset_y, _minu(valid_y, block_len), 1, pi,
                                is_intra, left_arr, left_i,
                                top_arr, top_i + blen)
            pi += pinc
            self.transform_tree(r, size_log2, unavail & ~2, depth, cbf,
                                offset_x, _minu(valid_x, block_len * 2),
                                offset_y + block_len, valid_y - block_len,
                                2, pi, is_intra, left_arr, left_i + blen,
                                top_arr, top_i)
            pi += pinc
            self.transform_tree(r, size_log2, 0, depth, cbf,
                                offset_x + block_len,
                                _minu(valid_x - block_len, block_len),
                                offset_y + block_len,
                                _minu(valid_y - block_len, block_len),
                                3, pi, is_intra, left_arr, left_i + blen,
                                top_arr, top_i + blen)
        else:
            if is_intra:
                self._intra_luma(size_log2, offset_x, offset_y, unavail,
                                 valid_x, valid_y, pred_idx)
            if is_intra or depth or cbf:
                cbf = cbf * 2 | C.cbf_luma(cb, r, depth)
            else:
                cbf = cbf * 2 | 1
            if self.qp_delta_req:
                self.qp_delta_req = 0
                if self.pps.cu_qp_delta_enabled:
                    raise NotImplementedError("cu_qp_delta")
            if cbf:
                self.transform_unit(r, size_log2, cbf, idx, pred_idx,
                                    offset_x, offset_y, is_intra)
            if is_intra:
                self.deblocking.record_tu_intra(self.qpy, size_log2,
                                                offset_x, offset_y,
                                                unavail)
            else:
                self.deblocking.record_tu(self.qpy, size_log2, offset_x,
                                          offset_y, unavail, cbf & 1,
                                          left_arr, left_i, top_arr,
                                          top_i)
                num = 1 << (size_log2 - 2)
                for k in range(num):
                    for arr, i0 in ((left_arr, left_i), (top_arr, top_i)):
                        nb = arr[i0 + k]
                        nb.pu_nonzero_coef = cbf & 1
                        nb.tu_intra = 0
                        nb.tu_nonzero_coef = cbf & 1
                        nb.pu_intra = 0

    def _intra_luma(self, size_log2, offset_x, offset_y, unavail,
                    valid_x, valid_y, pred_idx):
        """intra_prediction (h265.cpp:2904-2913): luma + (size>4) chroma."""
        vx = -1 if unavail & 2 else valid_x
        vy = -1 if unavail & 1 else valid_y
        y0 = (self.pos_y << self.size_log2) + offset_y
        x0 = (self.pos_x << self.size_log2) + offset_x
        if self.rec is not None:
            self.rec.intra_op(True, y0, x0, size_log2,
                              self.order_luma[pred_idx], vx, vy)
        intra.predict(self.frame["y"], y0, x0, size_log2, vx, vy,
                      self.order_luma[pred_idx], True,
                      self.sps.strong_intra_smoothing)
        if size_log2 == 2:
            return
        if self.rec is not None:
            self.rec.intra_op(False, y0 >> 1, x0 >> 1, size_log2 - 1,
                              self.order_chroma, vx >> 1, vy >> 1)
        for plane in ("cb", "cr"):
            intra.predict(self.frame[plane], y0 >> 1, x0 >> 1,
                          size_log2 - 1, vx >> 1, vy >> 1,
                          self.order_chroma, False, False)

    def _intra_chroma(self, size_log2, offset_x, offset_y, unavail,
                      valid_x, valid_y):
        """chroma prediction at the 4x4-split point (h265.cpp:3039-3042)."""
        y0 = (self.pos_y << self.size_log2) + offset_y
        x0 = (self.pos_x << self.size_log2) + offset_x
        vx = -1 if unavail & 2 else (valid_x >> 1)
        vy = -1 if unavail & 1 else (valid_y >> 1)
        if self.rec is not None:
            self.rec.intra_op(False, y0 >> 1, x0 >> 1, size_log2,
                              self.order_chroma, vx, vy)
        for plane in ("cb", "cr"):
            intra.predict(self.frame[plane], y0 >> 1, x0 >> 1, size_log2,
                          vx, vy, self.order_chroma, False, False)

    def transform_unit(self, r, size_log2, cbf, idx, pred_idx,
                       offset_x, offset_y, is_intra=True):
        """transform_unit (h265.cpp:2246-2270)."""
        from decode_bench.ref.h265 import residual as RES

        y0 = (self.pos_y << self.size_log2) + offset_y
        x0 = (self.pos_x << self.size_log2) + offset_x
        if cbf & 1:
            order = RES.order_map(self.order_luma[pred_idx]) \
                if (is_intra and size_log2 <= 3) else 0
            RES.residual_coding(self, r, size_log2, 0, self.frame["y"],
                                y0, x0, order, is_intra)
        if cbf & 6:
            if 2 < size_log2:
                size_log2 -= 1
            elif idx != 3:
                return
            else:
                x0 -= 4
                y0 -= 4
            order = RES.order_map(self.order_chroma) \
                if (is_intra and size_log2 == 2) else 0
            if cbf & 4:
                RES.residual_coding(self, r, size_log2, 1,
                                    self.frame["cb"], y0 >> 1, x0 >> 1,
                                    order, False)
            if cbf & 2:
                RES.residual_coding(self, r, size_log2, 2,
                                    self.frame["cr"], y0 >> 1, x0 >> 1,
                                    order, False)


# availability transforms for quad subdivision (h265.cpp:3933-3948 LUTs)
_AVAIL4X4IDX0 = (0, 5, 10, 15, 0, 5, 10, 15, 0, 5, 10, 15, 0, 5, 10, 15)
_AVAIL4X4IDX1 = (4, 4, 6, 6, 4, 4, 6, 6, 12, 12, 14, 14, 12, 12, 14, 14)
_AVAIL4X4IDX2 = (0, 1, 0, 1, 4, 5, 4, 5, 0, 1, 0, 1, 4, 5, 4, 5)
_AVAIL2X1IDX0 = (0, 1, 2, 3, 0, 5, 2, 7, 8, 9, 10, 11, 8, 13, 10, 15)
_AVAIL2X1IDX1 = (8, 9, 8, 9, 12, 13, 12, 13, 8, 9, 8, 9, 12, 13, 12, 13)
_AVAIL1X2IDX0 = (0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 10, 11, 4, 5, 14, 15)
_AVAIL1X2IDX1 = (4, 4, 6, 6, 4, 4, 6, 6, 12, 12, 14, 14, 12, 12, 14, 14)


def _avail4x4idx0(unavail):
    return _AVAIL4X4IDX0[unavail]


def _avail4x4idx1(unavail):
    return _AVAIL4X4IDX1[unavail]


def _avail4x4idx2(unavail):
    return _AVAIL4X4IDX2[unavail]


def _avail4x4idx3(unavail):
    return 12
