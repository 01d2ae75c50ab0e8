"""Host-side (numpy) pieces of H.264 Phase B, copied from the JAX
package's ``codecs/h264/reconstruct.py``: the quarter-pel and intra-mode
tables, the plan key order, IPCM rows, the coded-block map of a plan
without one, the device-slot map and the dense-MC aux derivation that
run on the host before a batch is copied to the device, and the typed
views of a packed wire blob.
"""

from __future__ import annotations

import numpy as np


#: (plane1, dy1, dx1, plane2, dy2, dx2) per frac index fy*4+fx: every
#: quarter-pel case is avg(P1[pos+o1], P2[pos+o2]) (exact cases use
#: P1 == P2, avg(a, a) == a). Planes: 0=G 1=b 2=h 3=j.
_HP_TAB = np.array([
    (0, 0, 0, 0, 0, 0), (0, 0, 0, 1, 0, 0),   # (fy0) fx 0,1
    (1, 0, 0, 1, 0, 0), (0, 0, 1, 1, 0, 0),   #       fx 2,3
    (0, 0, 0, 2, 0, 0), (1, 0, 0, 2, 0, 0),   # (fy1) fx 0,1
    (1, 0, 0, 3, 0, 0), (1, 0, 0, 2, 0, 1),   #       fx 2,3
    (2, 0, 0, 2, 0, 0), (2, 0, 0, 3, 0, 0),   # (fy2) fx 0,1
    (3, 0, 0, 3, 0, 0), (3, 0, 0, 2, 0, 1),   #       fx 2,3
    (0, 1, 0, 2, 0, 0), (1, 1, 0, 2, 0, 0),   # (fy3) fx 0,1
    (3, 0, 0, 1, 1, 0), (1, 1, 0, 2, 0, 1),   #       fx 2,3
], np.int32)


def _mk_tables4():
    """Index tables for the 9 4x4 modes over line layout:
    [0..3]=left, [4]=corner, [5..12]=top(+topright/substituted),
    [13]=DC."""
    L_, C_, T_, DC_ = 0, 4, 5, 13
    IA = np.zeros((9, 16), np.int32)
    IB = np.zeros((9, 16), np.int32)
    IC = np.zeros((9, 16), np.int32)
    K3 = np.zeros((9, 16), bool)

    def put(m, y, x, kind, a, b, c=0):
        p = y * 4 + x
        K3[m, p] = kind
        IA[m, p], IB[m, p], IC[m, p] = a, b, c
        if not kind:  # fir2 uses (B, C)
            IA[m, p] = b

    for y in range(4):
        for x in range(4):
            # 0 vert / 1 horiz / 2 dc
            put(0, y, x, False, 0, T_ + x, T_ + x)
            put(1, y, x, False, 0, L_ + y, L_ + y)
            put(2, y, x, False, 0, DC_, DC_)
            # 3 ddl
            i = x + y
            put(3, y, x, True, T_ + i, T_ + i + 1, T_ + min(i + 2, 7))
            # 4 ddr: line = [l3..l0, c, t0..t3], center j = 4 + x - y
            def ddr_idx(j):
                if j < 4:
                    return L_ + 3 - j
                if j == 4:
                    return C_
                return T_ + j - 5
            j = 4 + x - y
            put(4, y, x, True, ddr_idx(j - 1), ddr_idx(j), ddr_idx(j + 1))
            # 5 vr
            def tfull(k):
                return C_ if k == 0 else T_ + k - 1
            def lfull(k):
                return C_ if k == 0 else L_ + k - 1
            z = 2 * x - y
            if z >= 0:
                i = x - (y >> 1)
                if z & 1:
                    put(5, y, x, True, tfull(i - 1), tfull(i), tfull(i + 1))
                else:
                    put(5, y, x, False, 0, tfull(i), tfull(i + 1))
            elif z == -1:
                put(5, y, x, True, L_ + 0, C_, T_ + 0)
            else:
                put(5, y, x, True, lfull(y), lfull(y - 1), lfull(y - 2))
            # 6 hd
            z = 2 * y - x
            if z >= 0:
                i = y - (x >> 1)
                if z & 1:
                    put(6, y, x, True, lfull(i - 1), lfull(i), lfull(i + 1))
                else:
                    put(6, y, x, False, 0, lfull(i), lfull(i + 1))
            elif z == -1:
                put(6, y, x, True, T_ + 0, C_, L_ + 0)
            else:
                put(6, y, x, True, tfull(x), tfull(x - 1), tfull(x - 2))
            # 7 vl
            i = x + (y >> 1)
            if y & 1:
                put(7, y, x, True, T_ + i, T_ + i + 1, T_ + min(i + 2, 7))
            else:
                put(7, y, x, False, 0, T_ + i, T_ + i + 1)
            # 8 hu
            z = x + 2 * y
            if z < 5:
                i = y + (x >> 1)
                if z & 1:
                    put(8, y, x, True, L_ + i, L_ + i + 1,
                        L_ + min(i + 2, 3))
                else:
                    put(8, y, x, False, 0, L_ + i, L_ + i + 1)
            elif z == 5:
                put(8, y, x, True, L_ + 2, L_ + 3, L_ + 3)
            else:
                put(8, y, x, False, 0, L_ + 3, L_ + 3)
    return IA, IB, IC, K3


_I4_TAB = _mk_tables4()


def _mode_matrix(tab, n_line):
    """(IA, IB, IC, K3) index tables -> (coef [n_line, 9*P], rnd [9*P],
    shift [9*P]) so that for every mode m and position p
    vals[:, m*P+p] = (line @ coef + rnd)[:, m*P+p] >> shift[m*P+p]
    reproduces fir3(A,B,C) / fir2(B,C) exactly (values <= 2^12, so the
    f32 matmul is exact). Gather-free: runs under Pallas/Mosaic."""
    IA, IB, IC, K3 = tab
    P = IA.shape[1]
    M = np.zeros((n_line, 9 * P), np.float32)
    for m in range(9):
        for p in range(P):
            col = m * P + p
            if K3[m, p]:
                M[IA[m, p], col] += 1
                M[IB[m, p], col] += 2
                M[IC[m, p], col] += 1
            else:
                M[IB[m, p], col] += 1
                M[IC[m, p], col] += 1
    rnd = np.where(K3.reshape(-1), 2, 1).astype(np.int32)
    shift = np.where(K3.reshape(-1), 2, 1).astype(np.int32)
    return M, rnd, shift


_I4_MAT = _mode_matrix(_I4_TAB, 14)


def _mk_tables8():
    """Index tables for the 9 8x8 modes over line layout:
    [0..7]=filtered left, [8]=filtered corner, [9..24]=filtered top
    run t'[0..15], [25]=DC."""
    LF, COR, TP, DC_ = 0, 8, 9, 25
    IA = np.zeros((9, 64), np.int32)
    IB = np.zeros((9, 64), np.int32)
    IC = np.zeros((9, 64), np.int32)
    K3 = np.zeros((9, 64), bool)

    def put(m, y, x, kind, a, b, c=0):
        p = y * 8 + x
        K3[m, p] = kind
        IA[m, p], IB[m, p], IC[m, p] = (a if kind else b), b, c

    def q(j):  # [cor] + lf
        return COR if j == 0 else LF + j - 1

    # hd rows resolved recursively to static indices
    def hd_entry(y, x):
        while y > 0 and x >= 2:
            y -= 1
            x -= 2
        if y == 0:
            if x == 0:
                return (False, 0, LF + 0, COR)
            if x == 1:
                return (True, LF + 0, COR, TP + 0)
            if x == 2:
                return (True, COR, TP + 0, TP + 1)
            return (True, TP + x - 3, TP + x - 2, TP + x - 1)
        zn = y + 1 if y + 1 < 9 else 8
        if x == 0:
            return (False, 0, q(y), q(zn))
        return (True, q(y - 1), q(y), q(zn))

    for y in range(8):
        for x in range(8):
            put(0, y, x, False, 0, TP + x, TP + x)        # vert
            put(1, y, x, False, 0, LF + y, LF + y)        # horiz
            put(2, y, x, False, 0, DC_, DC_)              # dc
            k = x + y                                     # ddl
            put(3, y, x, True, TP + k, TP + k + 1, TP + min(k + 2, 15))
            # ddr
            if x >= y:
                d = x - y
                if d == 0:
                    put(4, y, x, True, TP + 0, COR, LF + 0)
                elif d == 1:
                    put(4, y, x, True, COR, TP + 0, TP + 1)
                else:
                    put(4, y, x, True, TP + d - 2, TP + d - 1, TP + d)
            else:
                j = y - x - 1
                put(4, y, x, True, q(j), q(j + 1), q(min(j + 2, 8)))
            # vr
            kk, odd = divmod(y, 2)
            if x >= kk:
                i = x - kk
                if odd:
                    if i == 0:
                        put(5, y, x, True, TP + 0, COR, LF + 0)
                    elif i == 1:
                        put(5, y, x, True, COR, TP + 0, TP + 1)
                    else:
                        put(5, y, x, True, TP + i - 2, TP + i - 1, TP + i)
                else:
                    if i == 0:
                        put(5, y, x, False, 0, COR, TP + 0)
                    else:
                        put(5, y, x, False, 0, TP + i - 1, TP + i)
            else:
                j = 2 * (kk - x) - 2 + odd
                put(5, y, x, True, q(j), q(j + 1), q(min(j + 2, 8)))
            # hd
            kind, a, b, cc = hd_entry(y, x)
            put(6, y, x, kind, a, b, cc)
            # vl
            i = x + kk
            if odd:
                put(7, y, x, True, TP + i, TP + i + 1, TP + i + 2)
            else:
                put(7, y, x, False, 0, TP + i, TP + i + 1)
            # hu
            v = 2 * y + x
            if v < 14:
                i, vo = divmod(v, 2)
                if vo:
                    put(8, y, x, True, LF + i, LF + i + 1,
                        LF + min(i + 2, 7))
                else:
                    put(8, y, x, False, 0, LF + i, LF + i + 1)
            else:
                put(8, y, x, False, 0, LF + 7, LF + 7)
    return IA, IB, IC, K3


_I8_TAB = _mk_tables8()
_I8_MAT = _mode_matrix(_I8_TAB, 26)


_ZORDER = [(((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8,
            (i & 1) * 4 + ((i >> 2) & 1) * 8) for i in range(16)]


_PLAN_KEYS = ("coef_luma", "coef_chroma", "t8x8", "kind", "i4_modes",
              "i4_avail", "i8_modes", "i8_avail", "i16_mode",
              "chroma_mode", "mb_avail", "mv", "slot", "wp", "deb_str",
              "deb_str4", "deb_ab")


def _pcm_rows(plans, nmb):
    """Dense per-MB IPCM sample rows for a batch: [B, nmb, 384] uint8
    (256 luma raster + 64 cb + 64 cr, the native plan.pcm layout,
    h264parse.cpp mb_intrapcm). Zeros where no PCM MB."""
    rows = np.zeros((len(plans), nmb, 384), np.uint8)
    for b, p in enumerate(plans):
        for mbpos, (yb, cbb, crb) in p.pcm.items():
            rows[b, mbpos, :256] = yb.ravel()
            rows[b, mbpos, 256:320] = cbb.ravel()
            rows[b, mbpos, 320:] = crb.ravel()
    return rows


def coded_coefs(plan):
    """(coef_luma, coef_chroma) of a native plan with the blocks that its
    coded map marks as not written set to 0: ``plan_alloc="empty"``
    leaves them uninitialised, since the native packer reads only the
    coded ones (``h264parse.cpp`` ``for_coded_luma``: bit b of bits
    0..15 is luma block b, 16 coefficients wide, or 64 in an MB with
    8x8 transforms; bit 16 + k is chroma block k of 16, k = 4 * plane +
    block)."""
    c = plan.coded.astype(np.int64)[:, None]
    wide = ((plan.t8x8 != 0) | (plan.kind == 2))[:, None]
    pos = np.arange(256)[None]
    luma = (c >> np.where(wide, pos // 64, pos // 16)) & 1
    chroma = ((c >> (16 + np.arange(128)[None] // 16)) & 1).reshape(
        plan.coef_chroma.shape)
    return (np.where(luma != 0, plan.coef_luma, 0),
            np.where(chroma != 0, plan.coef_chroma, 0))


def derive_coded(plan):
    """The coded map (``coded_coefs``'s bits) of a plan that has none,
    the Python decoder's: a block's bit is set where any of its
    coefficients is nonzero. The native packer reads only coded blocks
    and keeps only their nonzero values, so the plan packs as if every
    block were read."""
    n = plan.n
    wide = (plan.t8x8 != 0) | (plan.kind == 2)
    luma = plan.coef_luma.reshape(n, 16, 16).any(2)
    luma[wide] = False
    luma[wide, :4] = plan.coef_luma[wide].reshape(-1, 4, 64).any(2)
    chroma = plan.coef_chroma.reshape(n, 8, 16).any(2)
    bits = np.concatenate([luma, chroma], 1).astype(np.uint32)
    return (bits << np.arange(24, dtype=np.uint32)).sum(1, dtype=np.uint32)


class _DevSlotMap:
    """Host-side compaction of frame-pool indices for the device pool.

    The host decoder's LRU deliberately wanders across its whole frame
    array (17+ slots at 1080p, reference pointer-rotation semantics,
    m2d_update_frames mpeg2.cpp:159-194 / find_empty_frame) while only
    ~(num_ref_frames + 1) frames are live at once. Device traffic for
    edge-pad, half-pel planes and the pool write scales with pool size,
    so plans' slot / cur_idx values are translated into a compact
    device slot space at dispatch time. A host index's device slot is
    recycled only once the frame can never be referenced again (it left
    ``plan.live`` — the pre-marking reference set plus current, a
    superset of every future plan's reference set)."""

    def __init__(self, cap):
        self.cap = cap
        self.map = {}

    def reset(self):
        self.map.clear()

    def translate(self, plan):
        """-> (tr, dev_cur): tr maps host idx -> dev slot (int32[64],
        unmapped = 0 — never read for unmapped hosts)."""
        slots = plan.used_slots()
        needed = set(slots) | {plan.cur_idx}
        live = set(getattr(plan, "live", None) or range(64))
        for h in needed:
            if h in self.map:
                continue
            used = set(self.map.values())
            free = [s for s in range(self.cap) if s not in used]
            if not free:
                victims = [k for k in self.map
                           if k not in live and k not in needed]
                if not victims:
                    raise RuntimeError(
                        f"device pool cap {self.cap} exceeded "
                        f"(live={sorted(live)})")
                del self.map[victims[0]]
                free = [s for s in range(self.cap)
                        if s not in set(self.map.values())]
            self.map[h] = free[0]
        tr = np.zeros(64, np.int32)
        for h, s in self.map.items():
            tr[h] = s
        return tr, self.map[plan.cur_idx]


#: 4x4 cell -> 8x8 quadrant within an MB (cell index = mb*16 + blk)
_CELL_QUAD = (np.array([((b >> 3) * 2 + ((b >> 1) & 1))
                        for b in range(16)], np.int32))


def _derive_mc_aux(slot_fields, pool_size, mb_w, mb_h):
    """Host MC prep for inter_pass's dense path, run AFTER the
    device-slot remap (the ``compact=False`` branch of the JAX
    package's _derive_mc_aux).

    For each batch's [N, n, 4, 2] slot grid (mutated IN PLACE):
    collects the compact used-slot list per picture and remaps the grid
    to 0..K-1 (the half-pel planes then cover K planes, not the whole
    pool), and lists the cells that need the second prediction with
    ABSOLUTE cell indices. Shapes are pow2-bucketed across every batch
    in `slot_fields`. Returns a list of (used [N,K], bi [N,Bb], None,
    None, None)."""
    cols2 = []
    for sf in slot_fields:
        useds, bis = [], []
        for b in range(sf.shape[0]):
            v = sf[b]
            used = np.unique(v[v >= 0]).astype(np.int32)
            if used.size == 0:
                used = np.zeros(1, np.int32)
            remap = np.zeros(pool_size, np.int32)
            remap[used] = np.arange(len(used), dtype=np.int32)
            np.copyto(v, np.where(
                v >= 0, remap[np.clip(v, 0, pool_size - 1)]
                .astype(v.dtype), v))
            useds.append(used)
            both = (v[:, :, 0] >= 0) & (v[:, :, 1] >= 0)  # [n,4]
            cellboth = both[:, _CELL_QUAD].reshape(-1)
            bis.append(np.flatnonzero(cellboth).astype(np.int32))
        cols2.append((useds, bis))
    K = _next_pow2(max(len(u) for us, _ in cols2 for u in us))
    Bb = _next_pow2(max(1, max(len(x) for _, bs in cols2
                               for x in bs)))
    out = []
    for sf, (useds, bis) in zip(slot_fields, cols2):
        N = sf.shape[0]
        B = sf.shape[1] * 16
        used_arr = np.zeros((N, K), np.int32)
        bi_arr = np.full((N, Bb), B, np.int32)
        for b in range(N):
            used_arr[b, : len(useds[b])] = useds[b]
            bi_arr[b, : len(bis[b])] = bis[b]
        out.append((used_arr, bi_arr, None, None, None))
    return out


def _remap_batch(slot_field, cur_idx, plans, smap):
    """Apply a _DevSlotMap to a batch IN PLACE: slot_field [B, n, 4, 2]
    (any int dtype, -1 preserved) and cur_idx [B] int32."""
    for b, p in enumerate(plans):
        tr, dev_cur = smap.translate(p)
        v = slot_field[b]
        np.copyto(v, np.where(v >= 0, tr[np.clip(v, 0, 63)]
                              .astype(v.dtype), v))
        cur_idx[b] = dev_cur


def dev_pool_size(num_ref_frames, host_pool):
    """Compact device pool size: refs + current + transition margin
    (an IDR's plan keeps the old refs live through its own picture)."""
    return min(host_pool, num_ref_frames + 3)


def _next_pow2(v):
    r = 1
    while r < v:
        r *= 2
    return r


def _wire_views(blob, layout):
    """HOST-side split of a wire blob into typed numpy field views
    (zero-copy; each field is 8-byte aligned in the blob). These views
    are what gets passed to the jitted graph — never the raw blob."""
    out = {}
    for path, dtname, shape, off, nb in layout:
        dt = np.dtype(dtname)
        arr = blob[off : off + nb].view(dt).reshape(shape)
        if len(path) == 1:
            out[path[0]] = arr
        else:
            out.setdefault(path[0], {})[path[1]] = arr
    return out
