"""H.265 intra prediction (reference h265.cpp:2246-2918 semantics).

The reference predicts in-frame: neighbour pixels are read directly from
the partially-reconstructed planes, with `valid_x`/`valid_y` carrying the
remaining-frame extents (negative = that edge unavailable) instead of the
spec's reference-sample substitution pass.  Replicated here exactly,
per-channel on planar planes (the reference's N=2 NV12 pair math is
channel-independent).

Implemented modes: planar(0), DC(1), horizontal(10), vertical(26), and
the generic angular family (2..34) via the reference's position tables
(intrapos.h semantics are derived on the fly — see _angular_*).
"""

from __future__ import annotations


def _clip255(v):
    return 0 if v < 0 else (255 if v > 255 else v)


class _Vec:
    """Signed 1-D strided view into a 2-D plane (reference pointer walk)."""

    __slots__ = ("p", "y", "x", "dy", "dx")

    def __init__(self, plane, y, x, dy, dx):
        self.p, self.y, self.x, self.dy, self.dx = plane, y, x, dy, dx

    def __getitem__(self, i):
        return int(self.p[self.y + i * self.dy, self.x + i * self.dx])


# -- neighbour builders (get_multipix_*, h265.cpp:2509-2609) -----------

def multipix_raw(src, offset, offset_min, offset_max, size_log2, length):
    if offset_min <= offset:
        pregap = 0
    else:
        pregap = offset_min - offset
        offset = offset_min
    midlen = min(offset_max - offset, length - pregap)
    out = [0] * (pregap + midlen)
    for i in range(midlen):
        out[pregap + i] = src[offset + i]
    for i in range(pregap):
        out[i] = out[pregap]
    last = out[-1]
    out.extend([last] * (length - len(out)))
    return out


def multipix_filtered(src, offset, offset_min, offset_max, size_log2,
                      length, corner):
    """get_multipix_filtered_core (h265.cpp:2577-2609). `corner` is the
    reference's src[sub_stride - stride] pixel for offset==offset_min<0."""
    if offset_min < offset:
        c0 = src[offset - 1]
        c1 = src[offset]
    elif offset_min == offset:
        c1 = src[offset]
        c0 = corner if offset_min < 0 else c1
    else:
        c0 = c1 = src[offset + 1]
    pos = offset
    out = []
    midlen = min(offset_max - offset - 1, length)
    for _ in range(midlen):
        pos += 1
        c2 = src[pos]
        out.append((c0 + c1 * 2 + c2 + 2) >> 2)
        c0, c1 = c1, c2
    while len(out) < length:
        out.append((c0 + c1 * 3 + 2) >> 2)
        c0 = c1
    if (2 << size_log2) <= offset_max and offset + length == (2 << size_log2):
        out[-1] = c1
    return out


def multipix_strong(src, offset, offset_min, offset_max, size_log2, length):
    """get_multipix_filtered_strong_core (h265.cpp:2550-2557)."""
    c0 = src[-1 if offset_min < 0 else 0]
    c1 = src[min(63, offset_max - 1)]
    out = []
    for i in range(length):
        out.append(((63 - offset) * c0 + (offset + 1) * c1 + 32) >> 6)
        offset += 1
    return out


def detect_strong_filter(enabled, plane, y0, x0, size_log2, valid_x, valid_y):
    """intra_pred_detect_strong_filter (h265.cpp:2435-2456)."""
    if not enabled or size_log2 != 5:
        return False

    def onedir(lt, vec, valid_len):
        if 64 <= valid_len:
            d = lt + vec[64] - vec[32] * 2
        elif 32 <= valid_len:
            d = lt - vec[32]
        else:
            return True
        return d * d < 64

    if 0 < valid_x:
        if 0 < valid_y:
            lt = int(plane[y0 - 1, x0 - 1])
            return (onedir(lt, _Vec(plane, y0 - 1, x0 - 1, 0, 1), valid_x)
                    and onedir(lt, _Vec(plane, y0 - 1, x0 - 1, 1, 0),
                               valid_y))
        return onedir(int(plane[y0 - 1, x0]),
                      _Vec(plane, y0 - 1, x0 - 1, 0, 1), valid_x)
    if 0 < valid_y:
        return onedir(int(plane[y0, x0 - 1]),
                      _Vec(plane, y0 - 1, x0 - 1, 1, 0), valid_y)
    return False


def build_neighbours(plane, y0, x0, size_log2, valid_x, valid_y,
                     filtered, strong, length=None):
    """Left then top neighbour arrays as in intra_pred_planar / angular
    (h265.cpp:2631-2661): each `size+1` long by default (planar), or
    `length` for angular (2*size+1 loads)."""
    size = 1 << size_log2
    n = (size + 1) if length is None else length

    def pick(src, offset_min, offset_max, corner):
        if strong:
            return multipix_strong(src, 0, offset_min, offset_max,
                                   size_log2, n)
        if filtered:
            return multipix_filtered(src, 0, offset_min, offset_max,
                                     size_log2, n, corner)
        return multipix_raw(src, 0, offset_min, offset_max, size_log2, n)

    if 0 < valid_y:
        left = pick(_Vec(plane, y0, x0 - 1, 1, 0),
                    -1 if 0 < valid_x else 0, valid_y,
                    int(plane[y0 - 1, x0 - 1]) if 0 < valid_x else 0)
    else:
        left = [int(plane[y0 - 1, x0])] * n
    if 0 < valid_x:
        top = pick(_Vec(plane, y0 - 1, x0, 0, 1),
                   -1 if 0 < valid_y else 0, valid_x,
                   int(plane[y0 - 1, x0 - 1]) if 0 < valid_y else 0)
    else:
        top = [int(plane[y0, x0 - 1])] * n
    return left, top


# -- DC (h265.cpp:2348-2410) ------------------------------------------

def _sum_edge(plane, y0, x0, size, valid_main, valid_sub, horizontal):
    if horizontal:  # top edge
        vec = _Vec(plane, y0 - 1, x0, 0, 1)
        fallback = _Vec(plane, y0, x0 - 1, 0, 0)
    else:  # left edge
        vec = _Vec(plane, y0, x0 - 1, 1, 0)
        fallback = _Vec(plane, y0 - 1, x0, 0, 0)
    if size <= valid_main:
        return sum(vec[i] for i in range(size))
    if 0 < valid_main:
        return (sum(vec[i] for i in range(valid_main))
                + vec[valid_main - 1] * (size - valid_main))
    if 0 < valid_sub:
        return fallback[0] * size
    return 128 * size


def pred_dc(plane, y0, x0, size_log2, valid_x, valid_y, is_luma):
    size = 1 << size_log2
    dc = (_sum_edge(plane, y0, x0, size, valid_x, valid_y, True)
          + _sum_edge(plane, y0, x0, size, valid_y, valid_x, False)
          + size) >> (size_log2 + 1)
    plane[y0 : y0 + size, x0 : x0 + size] = dc
    if is_luma and size < 32:
        if 0 < valid_x and 0 < valid_y:
            plane[y0, x0] = (int(plane[y0 - 1, x0]) + int(plane[y0, x0 - 1])
                             + dc * 2 + 2) >> 2
            for i in range(1, size):
                plane[y0, x0 + i] = (int(plane[y0 - 1, x0 + i])
                                     + dc * 3 + 2) >> 2
                plane[y0 + i, x0] = (int(plane[y0 + i, x0 - 1])
                                     + dc * 3 + 2) >> 2
        elif 0 < valid_x:  # top only (intra_dc_filter_toponly)
            top0 = int(plane[y0 - 1, x0])
            for i in range(1, size):
                plane[y0, x0 + i] = (int(plane[y0 - 1, x0 + i])
                                     + dc * 3 + 2) >> 2
            plane[y0, x0] = (top0 + dc + 1) >> 1
            dc1 = (top0 + dc * 3 + 2) >> 2
            # the reference's do-while writes `size` rows below the first:
            # rows 1..size — one row PAST the block (h265.cpp:2374-2381);
            # replicate, clamped to the plane
            for i in range(1, min(size + 1, plane.shape[0] - y0)):
                plane[y0 + i, x0] = dc1
        elif 0 < valid_y:  # left only
            left0 = int(plane[y0, x0 - 1])
            plane[y0, x0] = (left0 + dc + 1) >> 1
            dc1 = (left0 + dc * 3 + 2) >> 2
            plane[y0, x0 + 1 : x0 + size] = dc1
            for i in range(1, size):
                plane[y0 + i, x0] = (int(plane[y0 + i, x0 - 1])
                                     + dc * 3 + 2) >> 2


# -- horizontal / vertical (h265.cpp:2822-2885) -----------------------

def _postfilter_row(plane, y0, x0, size, c0):
    d0 = int(plane[y0, x0])
    for x in range(size):
        t0 = d0 + ((int(plane[y0 - 1, x0 + x]) - c0) >> 1)
        plane[y0, x0 + x] = _clip255(t0)


def _postfilter_col(plane, y0, x0, size, c0):
    d0 = int(plane[y0, x0])
    for y in range(size):
        t0 = d0 + ((int(plane[y0 + y, x0 - 1]) - c0) >> 1)
        plane[y0 + y, x0] = _clip255(t0)


def pred_horizontal(plane, y0, x0, size_log2, valid_x, valid_y, is_luma):
    size = 1 << size_log2
    if 0 < valid_y:
        for y in range(size):
            plane[y0 + y, x0 : x0 + size] = plane[y0 + y, x0 - 1]
        if is_luma and size_log2 < 5 and 0 < valid_x:
            _postfilter_row(plane, y0, x0, size,
                            int(plane[y0 - 1, x0 - 1]))
    else:
        dc = int(plane[y0 - 1, x0]) if 0 < valid_x else 128
        plane[y0 : y0 + size, x0 : x0 + size] = dc
        if is_luma and size_log2 < 5 and 0 < valid_x:
            _postfilter_row(plane, y0, x0, size, dc)


def pred_vertical(plane, y0, x0, size_log2, valid_x, valid_y, is_luma):
    size = 1 << size_log2
    if 0 < valid_x:
        for y in range(size):
            plane[y0 + y, x0 : x0 + size] = plane[y0 - 1, x0 : x0 + size]
        if is_luma and size_log2 < 5 and 0 < valid_y:
            _postfilter_col(plane, y0, x0, size,
                            int(plane[y0 - 1, x0 - 1]))
    else:
        dc = int(plane[y0, x0 - 1]) if 0 < valid_y else 128
        plane[y0 : y0 + size, x0 : x0 + size] = dc
        if is_luma and size_log2 < 5 and 0 < valid_y:
            _postfilter_col(plane, y0, x0, size, dc)


# -- planar (h265.cpp:2411-2430, 2631-2661) ---------------------------

def pred_planar(plane, y0, x0, size_log2, valid_x, valid_y, is_luma,
                strong_enabled):
    size = 1 << size_log2
    if valid_x <= 0 and valid_y <= 0:
        plane[y0 : y0 + size, x0 : x0 + size] = 128
        return
    filtered = is_luma and 3 <= size_log2
    strong = filtered and detect_strong_filter(
        strong_enabled, plane, y0, x0, size_log2, valid_x, valid_y)
    left, top = build_neighbours(plane, y0, x0, size_log2, valid_x,
                                 valid_y, filtered, strong)
    left_bottom = left[size]
    right_top = top[size]
    vleft = 0
    for y in range(size):
        lv = left[y]
        topscale = size - 1 - y
        vleft += left_bottom
        xinc = right_top - lv
        base = (lv << size_log2) + vleft
        for x in range(size):
            base += xinc
            plane[y0 + y, x0 + x] = \
                (base + top[x] * topscale + size) >> (size_log2 + 1)


def predict(plane, y0, x0, size_log2, valid_x, valid_y, mode, is_luma,
            strong_enabled):
    """intra_prediction_dispatch (h265.cpp:2886-2906)."""
    if mode == 0:
        pred_planar(plane, y0, x0, size_log2, valid_x, valid_y, is_luma,
                    strong_enabled)
    elif mode == 1:
        pred_dc(plane, y0, x0, size_log2, valid_x, valid_y, is_luma)
    elif mode == 10:
        pred_horizontal(plane, y0, x0, size_log2, valid_x, valid_y, is_luma)
    elif mode == 26:
        pred_vertical(plane, y0, x0, size_log2, valid_x, valid_y, is_luma)
    else:
        from decode_bench.ref.h265.intra_angular import pred_angular

        pred_angular(plane, y0, x0, size_log2, valid_x, valid_y, mode,
                     is_luma, strong_enabled)
