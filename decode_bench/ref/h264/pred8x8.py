"""H.264 High-profile 8x8 intra prediction (9 modes).

Spec 8.3.2.2 with reference-sample filtering, written against the
reference's edge conventions (intra8x8pred_*, h264.cpp:3315-3905):
corner uses the raw top-left only when avail&8, top-right absence
replicates t7 (raw replication for the latter8 extension), l'7/t'7 use
the 3x-tap tail. avail bits: 1=left, 2=top, 4=topright, 8=topleft.
"""

from __future__ import annotations

import numpy as np


def _fir2(a, b):
    return (a + b + 1) >> 1


def _fir3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _raw_refs(plane, y0, x0, avail):
    t = [int(plane[y0 - 1, x0 + k]) for k in range(8)] if avail & 2 else None
    l = [int(plane[y0 + k, x0 - 1]) for k in range(8)] if avail & 1 else None
    c = int(plane[y0 - 1, x0 - 1]) if (avail & 8) or (avail & 3) == 3 else 0
    tr = ([int(plane[y0 - 1, x0 + 8 + k]) for k in range(8)]
          if avail & 4 else None)
    return t, l, c, tr


def _top_filt8(t, c, tr, avail):
    """top8x8line + latter1: t'[0..7]."""
    prev = c if avail & 8 else t[0]
    out = []
    for k in range(7):
        out.append(_fir3(prev, t[k], t[k + 1]))
        prev = t[k]
    t8 = tr[0] if avail & 4 else t[7]
    out.append(_fir3(t[6], t[7], t8))
    return out


def _top_filt16(t, c, tr, avail):
    """top8x8line + latter8: t'[0..15]."""
    prev = c if avail & 8 else t[0]
    out = []
    for k in range(7):
        out.append(_fir3(prev, t[k], t[k + 1]))
        prev = t[k]
    if avail & 4:
        full = t + tr
        for k in range(7, 16):
            nxt = full[k + 1] if k + 1 < 16 else full[15]
            out.append(_fir3(full[k - 1], full[k], nxt))
    else:
        out.append((t[6] + 3 * t[7] + 2) >> 2)
        out.extend([t[7]] * 8)  # RAW replication (top8x8line_latter8)
    return out


def _top_filt7(t, c, avail):
    """top8x8line + latter0: t'[0..6]."""
    prev = c if avail & 8 else t[0]
    out = []
    for k in range(7):
        out.append(_fir3(prev, t[k], t[k + 1]))
        prev = t[k]
    return out


def _left_filt(l, c, avail):
    """left8x8line: l'[0..7]."""
    prev = c if avail & 8 else l[0]
    out = []
    for k in range(7):
        out.append(_fir3(prev, l[k], l[k + 1]))
        prev = l[k]
    out.append((l[6] + 3 * l[7] + 2) >> 2)
    return out


def _corner_filt(plane, y0, x0):
    return (int(plane[y0, x0 - 1]) + 2 * int(plane[y0 - 1, x0 - 1])
            + int(plane[y0 - 1, x0]) + 2) >> 2


def _store(plane, y0, x0, b):
    plane[y0 : y0 + 8, x0 : x0 + 8] = np.asarray(b, np.uint8)


def pred8_vert(plane, y0, x0, avail):
    if not avail & 2:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    tp = _top_filt8(t, c, tr, avail)
    _store(plane, y0, x0, [tp] * 8)


def pred8_horiz(plane, y0, x0, avail):
    if not avail & 1:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    lf = _left_filt(l, c, avail)
    _store(plane, y0, x0, [[lf[y]] * 8 for y in range(8)])


def pred8_dc(plane, y0, x0, avail):
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    if avail & 1:
        lf = _left_filt(l, c, avail)
        if avail & 2:
            tp = _top_filt8(t, c, tr, avail)
            dc = (sum(lf) + sum(tp) + 8) >> 4
        else:
            dc = (sum(lf) + 4) >> 3
    elif avail & 2:
        tp = _top_filt8(t, c, tr, avail)
        dc = (sum(tp) + 4) >> 3
    else:
        dc = 0x80
    plane[y0 : y0 + 8, x0 : x0 + 8] = dc


def pred8_ddl(plane, y0, x0, avail):
    if not avail & 2:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    tp = _top_filt16(t, c, tr, avail)
    d = [_fir3(tp[k], tp[k + 1], tp[k + 2]) for k in range(14)]
    d.append(_fir3(tp[14], tp[15], tp[15]))
    _store(plane, y0, x0, [[d[x + y] for x in range(8)] for y in range(8)])


def pred8_ddr(plane, y0, x0, avail):
    if (avail & 3) != 3:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    tp = _top_filt8(t, c, tr, avail)
    lf = _left_filt(l, c, avail)
    cor = _corner_filt(plane, y0, x0)
    u = [_fir3(tp[0], cor, lf[0])]
    u.append(_fir3(cor, tp[0], tp[1]))
    for x in range(2, 8):
        u.append(_fir3(tp[x - 2], tp[x - 1], tp[x]))
    q = [cor] + lf
    ins = [_fir3(q[j], q[j + 1], q[j + 2]) for j in range(6)] \
        + [_fir3(q[6], q[7], q[8])]
    b = [[u[x - y] if x >= y else ins[y - x - 1] for x in range(8)]
         for y in range(8)]
    _store(plane, y0, x0, b)


def pred8_vr(plane, y0, x0, avail):
    if (avail & 11) != 11:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    tp = _top_filt8(t, c, tr, avail)
    lf = _left_filt(l, c, avail)
    cor = _corner_filt(plane, y0, x0)
    e = [_fir2(cor, tp[0])] + [_fir2(tp[x - 1], tp[x]) for x in range(1, 8)]
    o = [_fir3(tp[0], cor, lf[0]), _fir3(cor, tp[0], tp[1])]
    for x in range(2, 8):
        o.append(_fir3(tp[x - 2], tp[x - 1], tp[x]))
    z = [cor] + lf
    ins = [_fir3(z[j], z[j + 1], z[j + 2]) for j in range(7)]
    b = []
    for y in range(8):
        k, odd = divmod(y, 2)
        base = o if odd else e
        row = [base[x - k] if x >= k
               else ins[2 * (k - x) - 2 + odd] for x in range(8)]
        b.append(row)
    _store(plane, y0, x0, b)


def pred8_hd(plane, y0, x0, avail):
    if (avail & 11) != 11:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    tp = _top_filt7(t, c, avail)
    lf = _left_filt(l, c, avail)
    cor = _corner_filt(plane, y0, x0)
    row0 = [_fir2(lf[0], cor), _fir3(lf[0], cor, tp[0]),
            _fir3(cor, tp[0], tp[1])]
    for x in range(3, 8):
        row0.append(_fir3(tp[x - 3], tp[x - 2], tp[x - 1]))
    z = [cor] + lf
    b = [row0]
    prev = row0
    for y in range(1, 8):
        pair = [_fir2(z[y], z[y + 1] if y + 1 < 9 else z[8]),
                _fir3(z[y - 1], z[y], z[y + 1] if y + 1 < 9 else z[8])]
        row = [pair[0], pair[1]] + prev[:6]
        b.append(row)
        prev = row
    _store(plane, y0, x0, b)


def pred8_vl(plane, y0, x0, avail):
    if not avail & 2:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    tp = _top_filt16(t, c, tr, avail)
    b = []
    for y in range(8):
        k, odd = divmod(y, 2)
        if odd:
            b.append([_fir3(tp[x + k], tp[x + k + 1], tp[x + k + 2])
                      for x in range(8)])
        else:
            b.append([_fir2(tp[x + k], tp[x + k + 1]) for x in range(8)])
    _store(plane, y0, x0, b)


def pred8_hu(plane, y0, x0, avail):
    if not avail & 1:
        return
    t, l, c, tr = _raw_refs(plane, y0, x0, avail)
    lf = _left_filt(l, c, avail)
    v = []
    for i in range(7):
        v.append(_fir2(lf[i], lf[i + 1]))
        v.append(_fir3(lf[i], lf[i + 1], lf[i + 2] if i + 2 < 8 else lf[7]))
    v.extend([lf[7]] * 8)
    _store(plane, y0, x0,
           [[v[2 * y + x] for x in range(8)] for y in range(8)])


#: spec mode order (Table 8-3): 0=V 1=H 2=DC 3=DDL 4=DDR 5=VR 6=HD 7=VL 8=HU
INTRA8x8_PRED = (pred8_vert, pred8_horiz, pred8_dc, pred8_ddl, pred8_ddr,
                 pred8_vr, pred8_hd, pred8_vl, pred8_hu)
