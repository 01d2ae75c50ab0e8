"""H.265 in-loop deblocking (reference h265d_deblocking_t,
h265modules.h:476-662 + deblock_ctu, h265.cpp:4125-4384).

Strengths are recorded per 8-pel edge / 4-pel segment during the CTU
walk (intra TUs record strength 2 with the averaged boundary qp), then
the filter runs per CTU over a (-4,-4)-shifted window so each CTU pass
also completes the deferred right/bottom edges of its neighbours;
`pre/post` shuffles carry the top-edge row across the CTU row and the
left column across CTUs.  Filters are the spec strong/weak luma filters
and the 2-sample chroma filter, with the reference's q_thr beta/tc table
and the extended chroma qp mapping.
"""

from __future__ import annotations


def _clip255(v):
    return 0 if v < 0 else (255 if v > 255 else v)


def _clip2(v, lim):
    return 0 if v < 0 else (lim if v > lim else v)


def _clip3delta(d, lim):
    return -lim if d < -lim else (lim if d > lim else d)


Q_THR = (
    (6, 0), (7, 0), (8, 1), (9, 1), (10, 1), (11, 1), (12, 1), (13, 1),
    (14, 1), (15, 1), (16, 1), (17, 2), (18, 2), (20, 2), (22, 2), (24, 3),
    (26, 3), (28, 3), (30, 3), (32, 4), (34, 4), (36, 4), (38, 5), (40, 5),
    (42, 6), (44, 6), (46, 7), (48, 8), (50, 9), (52, 10), (54, 11),
    (56, 13), (58, 14), (60, 16), (62, 18), (64, 20), (64, 22), (64, 24),
)

_QPC_ADJ12 = (
    -12, -11, -10, -9, -8, -7, -6, -5, -4, -3, -2, -1,
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30,
    31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
)


class Deblocking:
    """Strength recorder + per-CTU filter over planar planes."""

    def __init__(self, ctu):
        self.ctu = ctu
        self.edgemax = 1 << (ctu.size_log2 - 3)
        n = self.edgemax
        self.boundary = [[[0, 0] for _ in range(8 * 17)] for _ in range(2)]
        self.topedge = [[0, 0] for _ in range(ctu.columns * n)]
        self.disabled = True

    def reset_slice(self, disabled, pos_x):
        """set_ctu (h265modules.h:600-612): per-slice clear of the
        boundary records and the whole topedge row."""
        self.disabled = disabled
        for d in range(2):
            for e in self.boundary[d]:
                e[0] = e[1] = 0
        for e in self.topedge:
            e[0] = e[1] = 0

    # -- recording ------------------------------------------------------
    def _fill_base(self, dirn, offset_x, offset_y):
        n = self.edgemax
        xgap, ygap = (1, n) if dirn == 0 else (n * 2 + 1, 1)
        org_x = offset_x >> 3
        org_y = offset_y >> 2
        return (org_x * xgap + (org_y + 1) * ygap, ygap, org_y)

    def _record_onedir(self, qpy, dirn, offset_x, offset_y, unavail, length):
        if (offset_x & 7) or (offset_x == 0 and ((unavail >> dirn) & 1)):
            return
        base, ygap, org_y = self._fill_base(dirn, offset_x, offset_y)
        qp = qpy + 1
        hist = self.ctu.qp_history[dirn]
        bnd = self.boundary[dirn]
        for k in range(length):
            bnd[base + k * ygap][1] = (qp + hist[org_y + k]) >> 1
            bnd[base + k * ygap][0] = 2
    @staticmethod
    def _strength_tu(nb):
        return 2 if nb.tu_intra else (1 if nb.tu_nonzero_coef else 0)

    def _record_tu_onedir(self, qpy, dirn, offset_x, offset_y, unavail,
                          length, strength, arr, i0):
        if (offset_x & 7) or (offset_x == 0 and ((unavail >> dirn) & 1)):
            return
        base, ygap, org_y = self._fill_base(dirn, offset_x, offset_y)
        qp = qpy + 1
        hist = self.ctu.qp_history[dirn]
        bnd = self.boundary[dirn]
        for k in range(length):
            e = bnd[base + k * ygap]
            e[1] = (qp + hist[org_y + k]) >> 1
            e[0] = max(e[0], max(strength, self._strength_tu(arr[i0 + k])))

    def record_tu(self, qpy, size_log2, offset_x, offset_y, unavail,
                  strength, left_arr, left_i, top_arr, top_i):
        """record_tu (h265modules.h:629-637)."""
        if self.disabled:
            return
        length = 1 << (size_log2 - 2)
        self._record_tu_onedir(qpy, 0, offset_x, offset_y, unavail,
                               length, strength, left_arr, left_i)
        self._record_tu_onedir(qpy, 1, offset_y, offset_x, unavail,
                               length, strength, top_arr, top_i)

    @staticmethod
    def _mv_diff_large(a, b):
        return ((a[0] - b[0]) ** 2 >= 16) or ((a[1] - b[1]) ** 2 >= 16)

    def _inter_strength(self, nfrm0, nfrm1, cfrm0, cfrm1, n_mv, c_mv,
                        n_swapped, c_swapped):
        """inter_strength (h265modules.h:531-545)."""
        if nfrm0 != cfrm0 or nfrm1 != cfrm1:
            return 1
        if nfrm0 == nfrm1:
            return int(
                (self._mv_diff_large(n_mv[0], c_mv[0])
                 or self._mv_diff_large(n_mv[1], c_mv[1]))
                and (self._mv_diff_large(n_mv[0], c_mv[1])
                     or self._mv_diff_large(n_mv[1], c_mv[0])))
        return int(
            (nfrm0 >= 0 and self._mv_diff_large(n_mv[n_swapped],
                                                c_mv[c_swapped]))
            or (nfrm1 >= 0 and self._mv_diff_large(n_mv[n_swapped ^ 1],
                                                   c_mv[c_swapped ^ 1])))

    def _refidx_to_frameidx(self, refidx, lx):
        return (self.ctu.hdr.ref_list[lx][refidx][1]
                if refidx >= 0 else -1)

    def _record_pu_onedir(self, qpy, dirn, offset_x, offset_y, unavail,
                          length, arr, i0, refidx0, refidx1, mvxy):
        if (offset_x & 7) or (offset_x == 0 and ((unavail >> dirn) & 1)):
            return
        frm0 = self._refidx_to_frameidx(refidx0, 0)
        frm1 = self._refidx_to_frameidx(refidx1, 1)
        c_swapped = 0
        if frm0 < frm1:
            frm0, frm1 = frm1, frm0
            c_swapped = 1
        base, ygap, org_y = self._fill_base(dirn, offset_x, offset_y)
        qp = qpy + 1
        hist = self.ctu.qp_history[dirn]
        bnd = self.boundary[dirn]
        for i in range(length >> 2):
            e = bnd[base + i * ygap]
            e[1] = (qp + hist[org_y + i]) >> 1
            nb = arr[i0 + i]
            if nb.pu_intra:
                s = 2
            elif nb.pu_nonzero_coef:
                s = 1
            else:
                nfrm0 = self._refidx_to_frameidx(nb.pred.ref_idx[0], 0)
                nfrm1 = self._refidx_to_frameidx(nb.pred.ref_idx[1], 1)
                n_swapped = 0
                if nfrm0 < nfrm1:
                    nfrm0, nfrm1 = nfrm1, nfrm0
                    n_swapped = 1
                s = self._inter_strength(nfrm0, nfrm1, frm0, frm1,
                                         nb.pred.mv, mvxy, c_swapped,
                                         n_swapped)
            e[0] = s

    def record_pu(self, qpy, width, height, offset_x, offset_y, unavail,
                  left_arr, left_i, top_arr, top_i, refidx0, refidx1,
                  mvxy):
        """record_pu (h265modules.h:639-647)."""
        if self.disabled:
            return
        self._record_pu_onedir(qpy, 0, offset_x, offset_y, unavail,
                               height, left_arr, left_i, refidx0,
                               refidx1, mvxy)
        self._record_pu_onedir(qpy, 1, offset_y, offset_x, unavail,
                               width, top_arr, top_i, refidx0, refidx1,
                               mvxy)

    def record_tu_intra(self, qpy, size_log2, offset_x, offset_y, unavail):
        """record_tu_intra (h265modules.h:620-627)."""
        if self.disabled:
            return
        length = 1 << (size_log2 - 2)
        self._record_onedir(qpy, 0, offset_x, offset_y, unavail, length)
        self._record_onedir(qpy, 1, offset_y, offset_x, unavail, length)

    # -- per-CTU filtering ----------------------------------------------
    def pre_deblocking(self):
        n = self.edgemax
        ctu = self.ctu
        base = ctu.pos_x * n
        for k in range(n):
            self.boundary[0][k][:] = self.topedge[base + k]

    def post_deblocking(self):
        n = self.edgemax
        ctu = self.ctu
        if ctu.pos_x < ctu.columns - 1:
            # clear_left: carry each row's rightmost vertical edge
            left = self.boundary[1]
            p = 0
            ln = n * 2
            for _ in range(n):
                left[p][:] = left[p + ln]
                for k in range(1, ln + 1):
                    left[p + k][:] = [0, 0]
                p += ln + 1
        else:
            for e in self.boundary[1]:
                e[:] = [0, 0]
        base = ctu.pos_x * n
        for k in range(n):
            self.topedge[base + k][:] = self.boundary[0][n * n * 2 + k]
        # strength elements are 1-byte bitfields: the memset clears
        # boundary[0][n..] exactly (h265modules.h:652-654)
        for k in range(n, 8 * 17):
            self.boundary[0][k][:] = [0, 0]

    def deblock_ctu(self):
        ctu = self.ctu
        if self.disabled:
            return
        n = self.edgemax
        self.pre_deblocking()
        beta_offset = ctu.hdr.beta_offset_div2 * 2
        tc_offset = ctu.hdr.tc_offset_div2 * 2
        y_ctu = ctu.pos_y << ctu.size_log2
        x_ctu = ctu.pos_x << ctu.size_log2
        luma = ctu.frame["y"]
        ly = y_ctu - 4
        lx = x_ctu - 4
        blkv = n * 2 + (ctu.pos_y == ctu.rows - 1)
        blkh = n * 2 + (ctu.pos_x == ctu.columns - 1)
        # vertical luma edges
        bnd = self.boundary[0]
        for by in range(blkv):
            for ex in range(n):
                self._edge_luma_block(bnd[by * n + ex], beta_offset,
                                      tc_offset, luma, ly + by * 4,
                                      lx + ex * 8, True)
        # horizontal luma edges
        bnd = self.boundary[1]
        p = 0
        for ey in range(n):
            for bx in range(blkh):
                self._edge_luma_block(bnd[p + bx], beta_offset, tc_offset,
                                      luma, ly + ey * 8, lx + bx * 4,
                                      False)
            p += n * 2 + 1
        # chroma (4:2:0): every second edge, strength-2 only
        cb_off = ctu.pps.cb_qp_offset
        cr_off = ctu.pps.cr_qp_offset
        cy = (y_ctu >> 1) - 2
        cx = (x_ctu >> 1) - 2
        bnd = self.boundary[0]
        for by in range(blkv):
            for ex in range(n >> 1):
                e = bnd[by * n + ex * 2]
                if e[0] == 2:
                    for plane, off in ((ctu.frame["cb"], cb_off),
                                       (ctu.frame["cr"], cr_off)):
                        self._edge_chroma_block(e[1], off, tc_offset,
                                                plane, cy + by * 2,
                                                cx + ex * 8, True)
        bnd = self.boundary[1]
        p = 0
        for ey in range(n >> 1):
            for bx in range(blkh):
                e = bnd[p + bx]
                if e[0] == 2:
                    for plane, off in ((ctu.frame["cb"], cb_off),
                                       (ctu.frame["cr"], cr_off)):
                        self._edge_chroma_block(e[1], off, tc_offset,
                                                plane, cy + ey * 8,
                                                cx + bx * 2, False)
            p += 2 * (n * 2 + 1)
        self.post_deblocking()

    # -- filters --------------------------------------------------------
    def _edge_luma_block(self, edge, beta_offset, tc_offset, plane, y, x,
                         vert):
        str_, qp = edge
        if str_ == 0:
            return
        beta_qp = (_clip2(qp + beta_offset, 51) if beta_offset else qp) - 16
        if beta_qp < 0:
            return
        ofs = tc_offset + (str_ & 2)
        tc_qp = (_clip2(qp + ofs, 51) if ofs else qp) - 16
        if tc_qp < 0:
            return
        h, w = plane.shape
        if vert:
            if not (0 <= y and y + 3 < h and 0 <= x and x + 7 < w):
                return
            get = lambda r, c: int(plane[y + r, x + c])  # noqa: E731
            put = lambda r, c, v: plane.__setitem__((y + r, x + c), v)  # noqa: E731,E501
        else:
            if not (0 <= x and x + 3 < w and 0 <= y and y + 7 < h):
                return
            get = lambda r, c: int(plane[y + c, x + r])  # noqa: E731
            put = lambda r, c, v: plane.__setitem__((y + c, x + r), v)  # noqa: E731,E501
        if self.ctu.rec is not None:
            self.ctu.rec.deblock_luma(y, x, vert, str_,
                                      Q_THR[beta_qp][0], Q_THR[tc_qp][1])
        dp0 = abs(get(0, 1) - 2 * get(0, 2) + get(0, 3))
        dq0 = abs(get(0, 4) - 2 * get(0, 5) + get(0, 6))
        dp3 = abs(get(3, 1) - 2 * get(3, 2) + get(3, 3))
        dq3 = abs(get(3, 4) - 2 * get(3, 5) + get(3, 6))
        dpq0 = dp0 + dq0
        dpq3 = dp3 + dq3
        d = dpq0 + dpq3
        beta = Q_THR[beta_qp][0]
        if d >= beta:
            return
        tc = Q_THR[tc_qp][1]

        def dsam(dpq, p3, p0, q0, q3):
            if (beta >> 2) <= dpq * 2:
                return False
            if ((5 * tc + 1) >> 1) <= abs(p0 - q0):
                return False
            return (beta >> 3) > abs(p3 - p0) + abs(q0 - q3)

        strong = (dsam(dpq0, get(0, 0), get(0, 3), get(0, 4), get(0, 7))
                  and dsam(dpq3, get(3, 0), get(3, 3), get(3, 4),
                           get(3, 7)))
        if strong:
            tc2 = tc * 2
            for r in range(4):
                p3, p2, p1, p0 = (get(r, 0), get(r, 1), get(r, 2),
                                  get(r, 3))
                q0, q1, q2, q3 = (get(r, 4), get(r, 5), get(r, 6),
                                  get(r, 7))
                put(r, 1, (p2 + _clip3delta(
                    ((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3) - p2,
                    tc2)) & 0xFF)
                put(r, 2, (p1 + _clip3delta(
                    ((p2 + p1 + p0 + q0 + 2) >> 2) - p1, tc2)) & 0xFF)
                put(r, 3, (p0 + _clip3delta(
                    ((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3) - p0,
                    tc2)) & 0xFF)
                put(r, 4, (q0 + _clip3delta(
                    ((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3) - q0,
                    tc2)) & 0xFF)
                put(r, 5, (q1 + _clip3delta(
                    ((p0 + q0 + q1 + q2 + 2) >> 2) - q1, tc2)) & 0xFF)
                put(r, 6, (q2 + _clip3delta(
                    ((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3) - q2,
                    tc2)) & 0xFF)
        else:
            beta2 = (beta + (beta >> 1)) >> 3
            depq = ((dp0 + dp3) < beta2) * 2 + ((dq0 + dq3) < beta2)
            for r in range(4):
                p1 = get(r, 2)
                p0 = get(r, 3)
                q0 = get(r, 4)
                q1 = get(r, 5)
                delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
                if abs(delta) >= tc * 10:
                    continue
                delta = _clip3delta(delta, tc)
                put(r, 3, _clip255(p0 + delta))
                put(r, 4, _clip255(q0 - delta))
                if depq & 2:
                    p2 = get(r, 1)
                    d1 = p1 + _clip3delta(
                        ((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1),
                        tc >> 1)
                    put(r, 2, _clip255(d1))
                if depq & 1:
                    q2 = get(r, 6)
                    d1 = q1 + _clip3delta(
                        ((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1),
                        tc >> 1)
                    put(r, 5, _clip255(d1))

    def _edge_chroma_block(self, qp, qpc_offset, tc_offset, plane, y, x,
                           vert):
        """deblocking_edge_chroma_block (h265.cpp:4301-4320); x/y are in
        CHROMA samples; planar x offsets are half the NV12 bytes."""
        q = _QPC_ADJ12[qp + qpc_offset + 12]
        q = _clip2(q + 2 + tc_offset, 53) - 16
        if q < 0:
            return
        tc = Q_THR[q][1]
        h, w = plane.shape
        if vert:
            if not (0 <= y and y + 1 < h and 0 <= x and x + 3 < w):
                return
            get = lambda r, c: int(plane[y + r, x + c])  # noqa: E731
            put = lambda r, c, v: plane.__setitem__((y + r, x + c), v)  # noqa: E731,E501
        else:
            if not (0 <= x and x + 1 < w and 0 <= y and y + 3 < h):
                return
            get = lambda r, c: int(plane[y + c, x + r])  # noqa: E731
            put = lambda r, c, v: plane.__setitem__((y + c, x + r), v)  # noqa: E731,E501
        if self.ctu.rec is not None:
            ci = int(plane is self.ctu.frame["cr"])
            self.ctu.rec.deblock_chroma(y, x, vert, ci, tc)
        for r in range(2):
            p1 = get(r, 0)
            p0 = get(r, 1)
            q0 = get(r, 2)
            q1 = get(r, 3)
            delta = _clip3delta(((q0 - p0) * 4 + p1 - q1 + 4) >> 3, tc)
            if delta:
                put(r, 1, _clip255(p0 + delta))
                put(r, 2, _clip255(q0 - delta))
