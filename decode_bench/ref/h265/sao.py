"""H.265 sample-adaptive offset (reference h265.cpp:1017-1132 parse,
:4386-4729 whole-frame apply).

The reference runs SAO as a second whole-frame pass after the slice:
regions of left-merged CTUs are processed together; the pre-SAO bottom
lines of the row above (hline buffers) and the pre-SAO right columns of
the previous region (phase ping-ponged vline buffers) are swapped into
the frame around each region so edge-offset comparisons see pre-SAO
neighbour samples, as the spec requires.  Band offset indexes a 32-band
LUT; edge offsets use the sign-pair index table with offsets 2,3
negated at parse time.
"""

from __future__ import annotations

from decode_bench.ref.h265 import cabac_tables as _CT


def _clip255(v):
    return 0 if v < 0 else (255 if v > 255 else v)


def _signe(x):
    return 2 if x < 0 else (1 if x > 0 else 0)


_EO_IDX = (-1, 2, 1, -1, 2, 3, -1, 2, 1, -1, 0, 1, -1, 2, 1, -1)


class SaoMap:
    __slots__ = ("merge_left", "luma_idx", "chroma_idx", "elem")

    def __init__(self):
        self.merge_left = 0
        self.luma_idx = 0
        self.chroma_idx = 0
        # elem[i]: [offsets x4, opt (band_pos or edge class)]
        self.elem = [[[0, 0, 0, 0], 0] for _ in range(3)]

    def copy_from(self, other):
        self.luma_idx = other.luma_idx
        self.chroma_idx = other.chroma_idx
        self.elem = [[list(e[0]), e[1]] for e in other.elem]


# ---------------------------------------------------------------------
# parse (sao_read, h265.cpp:1066-1130)
# ---------------------------------------------------------------------

def _sao_offset_abs(cb, r, max_bits):
    bits = max_bits
    while bits:
        if cb.bypass(r) == 0:
            break
        bits -= 1
    return max_bits - bits


def _read_block(m, ctu, r):
    cb = ctu.cb
    m.luma_idx = 0
    if ctu.hdr.sao_luma:
        idx = 0
        if cb.decision(r, _CT.SAO_TYPE_IDX):
            idx = 1 + cb.bypass(r)
        if idx:
            m.luma_idx = idx
            _read_offsets(m.elem[0], idx, cb, r)
    m.chroma_idx = 0
    if ctu.hdr.sao_chroma:
        idx = 0
        if cb.decision(r, _CT.SAO_TYPE_IDX):
            idx = 1 + cb.bypass(r)
        if idx:
            m.chroma_idx = idx
            _read_offsets(m.elem[1], idx, cb, r)
            for j in range(4):
                m.elem[2][0][j] = _sao_offset_abs(cb, r, 7)
            if idx == 1:
                _read_band_tail(m.elem[2], cb, r)
            else:
                m.elem[2][1] = m.elem[1][1]
                m.elem[2][0][2] = -m.elem[2][0][2]
                m.elem[2][0][3] = -m.elem[2][0][3]


def _read_offsets(elem, idx, cb, r):
    for j in range(4):
        elem[0][j] = _sao_offset_abs(cb, r, 7)
    if idx == 1:
        _read_band_tail(elem, cb, r)
    else:
        elem[1] = cb.multibypass(r, 2)
        elem[0][2] = -elem[0][2]
        elem[0][3] = -elem[0][3]


def _read_band_tail(elem, cb, r):
    for j in range(4):
        if elem[0][j] and cb.bypass(r):
            elem[0][j] = -elem[0][j]
    elem[1] = cb.multibypass(r, 5)


def sao_read(ctu, r):
    """Per-CTU SAO parse incl. merge resolution (h265.cpp:1103-1130)."""
    cols = ctu.columns
    maps = ctu.sao_map
    i = ctu.pos_y * cols + ctu.pos_x
    m = maps[i]
    m.merge_left = 0
    if ctu.pos_x != 0:
        m.merge_left = ctu.cb.decision(r, _CT.SAO_MERGE_FLAG)
        if m.merge_left:
            return
    if ctu.pos_y != 0:
        if ctu.cb.decision(r, _CT.SAO_MERGE_FLAG):
            # copy from upper, resolved through its left-merge chain
            j = i - cols
            steps = ctu.pos_x
            while steps and maps[j].merge_left:
                j -= 1
                steps -= 1
            m.copy_from(maps[j])
            return
    _read_block(m, ctu, r)


# ---------------------------------------------------------------------
# apply (sao_oneframe, h265.cpp:4462-4729)
# ---------------------------------------------------------------------

def _bo_block(plane, y0, x0, w, h, offsets, band_pos):
    band_top = band_pos << 3
    for yy in range(h):
        for xx in range(w):
            d0 = int(plane[y0 + yy, x0 + xx])
            dif = d0 - band_top
            if 0 <= dif < 32:
                plane[y0 + yy, x0 + xx] = _clip255(d0 + offsets[dif >> 3])


def _eo_block(plane, y0, x0, w, h, offsets, edge, unavail, signbuf):
    if edge == 0:
        if unavail & 1:
            x0 += 1
            w -= 1
        if unavail & 4:
            w -= 1
        for yy in range(h):
            d1 = int(plane[y0 + yy, x0])
            sign0 = _signe(d1 - int(plane[y0 + yy, x0 - 1]))
            for xx in range(w):
                d2 = int(plane[y0 + yy, x0 + xx + 1])
                sign2 = _signe(d1 - d2)
                idx = _EO_IDX[sign2 * 4 + sign0]
                if idx >= 0:
                    plane[y0 + yy, x0 + xx] = _clip255(d1 + offsets[idx])
                d1 = d2
                sign0 = sign2 ^ 3
        return
    xdelta = {1: 0, 2: -1, 3: 1}[edge]
    if xdelta:
        if unavail & 1:
            x0 += 1
            w -= 1
        if unavail & 4:
            w -= 1
    if unavail & 2:
        y0 += 1
        h -= 1
    if unavail & 8:
        h -= 1
    sb = signbuf
    for xx in range(w):
        sb[xx] = _signe(int(plane[y0 + xx * 0 + 0, x0 + xx])
                        - int(plane[y0 - 1, x0 + xx + xdelta]))
    for yy in range(h):
        nxt = {}
        for xx in range(w):
            d0 = int(plane[y0 + yy, x0 + xx])
            sign0 = sb[xx]
            sign2 = _signe(d0 - int(plane[y0 + yy + 1, x0 + xx - xdelta]))
            idx = _EO_IDX[sign2 * 4 + sign0]
            if idx >= 0:
                plane[y0 + yy, x0 + xx] = _clip255(d0 + offsets[idx])
            nxt[xx - xdelta] = sign2 ^ 3
        for k, v in nxt.items():
            if 0 <= k < len(sb):
                sb[k] = v
        if xdelta < 0:
            sb[0] = _signe(int(plane[y0 + yy + 1, x0])
                           - int(plane[y0 + yy, x0 - 1]))
        elif xdelta > 0:
            sb[w - 1] = _signe(
                int(plane[y0 + yy + 1, x0 + w - 1])
                - int(plane[y0 + yy, x0 + w]))


def sao_oneframe(ctu):
    """Whole-frame SAO pass (h265.cpp:4687-4729)."""
    hdr = ctu.hdr
    if not hdr.sao_luma and not hdr.sao_chroma:
        return
    import numpy as np

    sps = ctu.sps
    rows, cols = ctu.rows, ctu.columns
    size = 1 << ctu.size_log2
    width = sps.pic_width
    planes = (ctu.frame["y"], ctu.frame["cb"], ctu.frame["cr"])
    maps = ctu.sao_map
    # hline buffers: pre-SAO bottom lines per CTU column [parity][plane]
    hline = [[np.zeros((1, cols * size), np.uint8) for _ in range(3)]
             for _ in range(2)]
    # per-parity, per-plane-group (0=luma, 1=chroma) column flags
    hflag = [[[0] * cols, [0] * cols] for _ in range(2)]
    signbuf = [0] * (cols * size + 2)  # full-row (merged regions)
    unavail_row = 3
    for y in range(rows):
        luma_y = y * size
        if y != 0:
            par = y & 1
            for ci, plane in enumerate(planes):
                grp = 0 if ci == 0 else 1
                cyy = luma_y if ci == 0 else luma_y >> 1
                clen = size if ci == 0 else size >> 1
                for x in range(cols):
                    if hflag[par][grp][x]:
                        a = plane[cyy - 1, x * clen : (x + 1) * clen].copy()
                        plane[cyy - 1, x * clen : (x + 1) * clen] = \
                            hline[par][ci][0, x * clen : (x + 1) * clen]
                        hline[par][ci][0, x * clen : (x + 1) * clen] = a
        nxt_par = (y ^ 1) & 1
        hflag[nxt_par] = [[0] * cols, [0] * cols]
        vlen = size if y < rows - 1 else (((sps.pic_height - 1)
                                           & (size - 1)) + 1)
        x = 0
        phase = 0
        valid_width = width
        vline = {}  # (parity, ci) -> saved column array or None
        unavail = unavail_row
        while x < cols:
            run = _region(ctu, planes, maps, y, x, size, vlen, unavail,
                          cols - x, phase, valid_width, vline, hline,
                          hflag, signbuf)
            x += run
            valid_width -= size * run
            phase += 1
            unavail &= ~1
        if y != 0:
            par = y & 1
            for ci, plane in enumerate(planes):
                grp = 0 if ci == 0 else 1
                cyy = luma_y if ci == 0 else luma_y >> 1
                clen = size if ci == 0 else size >> 1
                for xx in range(cols):
                    if hflag[par][grp][xx]:
                        plane[cyy - 1, xx * clen : (xx + 1) * clen] = \
                            hline[par][ci][0, xx * clen : (xx + 1) * clen]
        unavail_row = 1 if y < rows - 2 else 9


def _region(ctu, planes, maps, y, x, size, vlen, unavail, maxrun, phase,
            valid_width, vline, hline, hflag, signbuf):
    cols = ctu.columns
    base = y * cols + x
    run = 1
    while run < maxrun and maps[base + run].merge_left:
        run += 1
    m = maps[base]
    hlen = min(size * run, valid_width)
    for ci in (0, 1, 2):
        vline.pop(((phase ^ 1) & 1, ci), None)
    luma_y = y * size
    luma_x = x * size
    # luma
    idx = m.luma_idx
    un = unavail
    if idx:
        if run < maxrun:
            if maps[base + run].luma_idx == 2:
                vline[((phase ^ 1) & 1, 0)] = planes[0][
                    luma_y : luma_y + vlen, luma_x + hlen - 1].copy()
        else:
            un |= 4
        hflag[(y ^ 1) & 1][0][x : x + run] = [1] * run
        hline[(y ^ 1) & 1][0][0, luma_x : luma_x + run * size] = \
            planes[0][luma_y + vlen - 1, luma_x : luma_x + run * size]
        if idx == 1:
            _bo_block(planes[0], luma_y, luma_x, hlen, vlen,
                      m.elem[0][0], m.elem[0][1])
        else:
            key = (phase & 1, 0)
            saved = vline.get(key)
            if saved is not None:
                col = planes[0][luma_y : luma_y + vlen, luma_x - 1].copy()
                planes[0][luma_y : luma_y + vlen, luma_x - 1] = saved
                vline[key] = col
            _eo_block(planes[0], luma_y, luma_x, hlen, vlen,
                      m.elem[0][0], m.elem[0][1], un, signbuf)
            saved = vline.get(key)
            if saved is not None:
                col = planes[0][luma_y : luma_y + vlen, luma_x - 1].copy()
                planes[0][luma_y : luma_y + vlen, luma_x - 1] = saved
                vline[key] = col
    # chroma
    idx = m.chroma_idx
    un = unavail
    cy = luma_y >> 1
    cx = luma_x >> 1
    cvlen = vlen >> 1
    chlen = hlen >> 1
    if idx:
        if run < maxrun:
            if maps[base + run].chroma_idx == 2:
                for ci in (1, 2):
                    vline[((phase ^ 1) & 1, ci)] = planes[ci][
                        cy : cy + cvlen, cx + chlen - 1].copy()
        else:
            un |= 4
        hflag[(y ^ 1) & 1][1][x : x + run] = [1] * run
        for ci in (1, 2):
            hline[(y ^ 1) & 1][ci][0, cx : cx + run * (size >> 1)] = \
                planes[ci][cy + cvlen - 1, cx : cx + run * (size >> 1)]
        if idx == 1:
            _bo_block(planes[1], cy, cx, chlen, cvlen, m.elem[1][0],
                      m.elem[1][1])
            _bo_block(planes[2], cy, cx, chlen, cvlen, m.elem[2][0],
                      m.elem[2][1])
        else:
            for ci in (1, 2):
                key = (phase & 1, ci)
                saved = vline.get(key)
                if saved is not None:
                    col = planes[ci][cy : cy + cvlen, cx - 1].copy()
                    planes[ci][cy : cy + cvlen, cx - 1] = saved
                    vline[key] = col
            _eo_block(planes[1], cy, cx, chlen, cvlen, m.elem[1][0],
                      m.elem[1][1], un, signbuf)
            _eo_block(planes[2], cy, cx, chlen, cvlen, m.elem[2][0],
                      m.elem[2][1], un, signbuf)
            for ci in (1, 2):
                key = (phase & 1, ci)
                saved = vline.get(key)
                if saved is not None:
                    col = planes[ci][cy : cy + cvlen, cx - 1].copy()
                    planes[ci][cy : cy + cvlen, cx - 1] = saved
                    vline[key] = col
    return run
