"""H.265 colocated-MV store + temporal MV scaling (reference colpics_t /
temporal_mvscale_t, h265modules.h:664-851).

Each pool frame owns a 16x16-granular grid of colocated prediction
records; scale tables are derived from the POC distances of the whole
8-frame pool (stale POCs included — the reference indexes frm.poc[] for
all 8 slots regardless of validity, so the tables are
deterministically-stale, reproduced as such)."""

from __future__ import annotations


def _clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


def _scale(poc0, refpoc0, poc1, refpoc1):
    diff1 = poc1 - refpoc1
    diff0 = poc0 - refpoc0
    if diff1 == 0:
        return 4096
    td = _clip3(-128, 127, diff1)
    tb = _clip3(-128, 127, diff0)
    n = 16384 + (abs(td) >> 1)  # positive
    tx = n // td if td > 0 else -(n // -td)  # C trunc-toward-zero
    s = (tb * tx + 32) >> 6
    return _clip3(-4096, 4095, s)


def scale_mv(mv, scale):
    """scale_mv (h265.cpp:3625-3635)."""
    v = mv * scale
    if v >= 0:
        v = (v + 127) >> 8
        return v if v <= 32767 else 32767
    v = -((127 - v) >> 8)
    return v if v >= -32768 else -32768


class ColCell:
    """h265d_neighbour_t subset stored in the colocated grid."""

    __slots__ = ("pu_intra", "ref_idx", "mv")

    def __init__(self):
        self.pu_intra = 1
        self.ref_idx = [-1, -1]
        self.mv = [[0, 0], [0, 0]]


def make_colpic(width, height):
    n = (((width + 15) >> 4) * ((height + 15) >> 4))
    return [ColCell() for _ in range(n)]


class Colpics:
    """Per-slice view over the pool's colocated grids."""

    def __init__(self, ctu, pool, cur_idx):
        self.ctu = ctu
        self.pool = pool
        hdr = ctu.hdr
        sps = ctu.sps
        self.curr = pool[cur_idx]["colpic"]
        self.stride = (sps.pic_width + 15) >> 4
        self.width = sps.pic_width
        self.height = sps.pic_height
        col_poc, col_frmidx = hdr.ref_list[
            hdr.colocated_from_l0 ^ 1][hdr.collocated_ref_idx]
        self.ref = pool[col_frmidx]["colpic"]
        # register current frame's list AFTER reading the colocated one
        pool[cur_idx]["fidx"] = [[e[1] & 7 for e in hdr.ref_list[lx]]
                                 for lx in (0, 1)]
        if hdr.slice_type < 2:
            poc = hdr.poc
            pocs = [pool[i]["poc"] for i in range(8)]
            self.colmv = [[_scale(poc, pocs[i], col_poc, pocs[j])
                           for j in range(8)] for i in range(8)]
            self.tmv = [[_scale(poc, pocs[i], poc, pocs[j])
                         for j in range(8)] for i in range(8)]
            self.fidx_curr = pool[cur_idx]["fidx"]
            self.fidx_col = pool[col_frmidx]["fidx"]
            self.lowdelay = all(p <= poc for p in pocs)

    def colmv_scale(self, lx_a, refidx_a, lx_b, refidx_b):
        return self.colmv[self.fidx_curr[lx_a][refidx_a]][
            self.fidx_col[lx_b][refidx_b]]

    def tmv_scale(self, lx_a, refidx_a, lx_b, refidx_b):
        return self.tmv[self.fidx_curr[lx_a][refidx_a]][
            self.fidx_curr[lx_b][refidx_b]]

    def _offset(self, bx, by):
        return (by >> 4) * self.stride + (bx >> 4)

    def get_ref(self, offset_x, offset_y, width, height):
        """get_ref (h265modules.h:793-809): bottom-right cell if inside
        the CTU row and picture, else the center cell."""
        ctu = self.ctu
        base_x = ctu.pos_x << ctu.size_log2
        base_y = ctu.pos_y << ctu.size_log2
        brx = offset_x + width
        bry = offset_y + height
        if (not (bry >> ctu.size_log2) and base_x + brx < self.width
                and base_y + bry < self.height):
            cell = self.ref[self._offset(base_x + brx, base_y + bry)]
            if not cell.pu_intra:
                return cell
        brx = offset_x + (width >> 1)
        bry = offset_y + (height >> 1)
        return self.ref[self._offset(base_x + brx, base_y + bry)]

    def fill(self, offset_x, offset_y, width, height, intra=False,
             pred=None, ref0=-1, ref1=-1):
        """fill (h265modules.h:836-851): one record per 16-aligned
        sample point covered by the PU."""
        ctu = self.ctu
        base_x = ctu.pos_x << ctu.size_log2
        base_y = ctu.pos_y << ctu.size_log2
        for y in range(offset_y, offset_y + height, 4):
            if (base_y + y) & 15:
                continue
            for x in range(offset_x, offset_x + width, 4):
                if (base_x + x) & 15:
                    continue
                cell = self.curr[self._offset(base_x + x, base_y + y)]
                if intra:
                    cell.pu_intra = 1
                else:
                    cell.pu_intra = 0
                    cell.ref_idx = [ref0, ref1]
                    cell.mv = [list(pred.mv[0]), list(pred.mv[1])]
