"""H.264 CABAC: arithmetic decode engine + syntax-element readers.

Engine mirrors the reference's (m2d.h:130-279): context bytes packed as
``state*2 | valMPS`` with the LPS transition table pre-doubled, 9-bit
offset register refilled straight from the bit reader. Syntax layers
mirror h264.cpp:11052-11900 (mb_type trees, mvd UEG3, ref_idx, cbp,
significance maps, coefficient levels).
"""

from __future__ import annotations

from . import cabac_tables as CT
from .cavlc import COEFF_OFS, _ZIGZAG


class CabacEngine:
    """m2d_cabac_t + h264d context bank (460 contexts)."""

    __slots__ = ("range", "offset", "ctx")

    def __init__(self):
        self.range = 0x1FE
        self.offset = 0
        self.ctx = [0] * 460

    # -- init ----------------------------------------------------------
    def init_context(self, slice_qp, idc):
        """init_cabac_context (m2d.h:136-152)."""
        ctx = self.ctx
        for i, (m, n) in enumerate(CT.CTX_MN[idc]):
            pre = ((m * slice_qp) >> 4) + n
            if pre < 64:
                pre = 1 if pre <= 0 else pre
                ctx[i] = (63 - pre) * 2
            else:
                pre = 126 if pre > 126 else pre
                ctx[i] = (pre - 64) * 2 + 1

    def init_engine(self, r):
        """init_cabac_engine (m2d.h:130-134)."""
        self.range = 0x1FE
        self.offset = r.get_bits(9)

    # -- core ----------------------------------------------------------
    def _renorm(self, r, rng, off):
        bits = 9 - rng.bit_length() if rng else 9
        self.range = rng << bits
        self.offset = (off << bits) | r.get_bits(bits)

    def decision(self, r, idx):
        """cabac_decode_decision_raw (m2d.h:179-243)."""
        c = self.ctx[idx]
        mps = c & 1
        st = c >> 1
        lps = CT.RANGE_TAB_LPS[st][(self.range >> 6) & 3]
        rng = self.range - lps
        off = self.offset
        if off < rng:
            self.ctx[idx] = ((st + (st < 62)) * 2) | mps
            if rng >= 256:
                self.range = rng
                return mps
        else:
            off -= rng
            rng = lps
            self.ctx[idx] = CT.STATE_TRANS[st] ^ mps
            mps ^= 1
        self._renorm(r, rng, off)
        return mps

    def bypass(self, r):
        """cabac_decode_bypass (m2d.h:267-279)."""
        off = (self.offset << 1) | r.get_onebit()
        if off < self.range:
            self.offset = off
            return 0
        self.offset = off - self.range
        return 1

    def multibypass(self, r, num):
        """cabac_decode_multibypass (m2d.h:249-265)."""
        rng = self.range
        off = (self.offset << num) | r.get_bits(num)
        out = 0
        n = num
        while n:
            out *= 2
            if rng <= (off >> (n - 1)):
                off -= rng << (n - 1)
                out |= 1
            n -= 1
        self.offset = off
        return out

    def terminate(self, r):
        """cabac_decode_terminate (h264.cpp:11057-11072)."""
        rng = self.range - 2
        if rng <= self.offset:
            self.range = rng
            return 1
        if rng < 256:
            self._renorm(r, rng, self.offset)
        else:
            self.range = rng
        return 0


# ---------------------------------------------------------------------
# syntax-element readers (dec = H264Decoder, cb = dec.cb, r = bitreader)
# ---------------------------------------------------------------------
MB_INxN = 0
MB_IPCM = 25
#: field-coded significance/last ctx offsets (h264.cpp:11492-11503)
_SIG_OFS_FIELD = ((277, 338), (292, 353), (306, 367), (321, 382),
                  (324, 385), (436, 451))
MB_BDIRECT16x16 = 31


def mb_type_I(dec, r, avail, ctx_idx, slice_type):
    """mb_type_cabac_I (h264.cpp:11074-11100)."""
    cb = dec.cb
    is_i = slice_type == 2
    if is_i:
        add = (((avail & 2) and dec._top().type != MB_INxN)
               + ((avail & 1) and dec.mbleft.type != MB_INxN))
        if not cb.decision(r, ctx_idx + add):
            return MB_INxN
        ctx_idx = 5
    elif not cb.decision(r, ctx_idx):
        return MB_INxN
    if cb.terminate(r):
        return MB_IPCM
    mb_type = cb.decision(r, ctx_idx + 1) * 12 + 1
    if cb.decision(r, ctx_idx + 2):
        mb_type += cb.decision(r, ctx_idx + 2 + is_i) * 4 + 4
    mb_type += cb.decision(r, ctx_idx + 3 + is_i) * 2
    mb_type += cb.decision(r, ctx_idx + 3 + is_i * 2)
    return mb_type


def mb_type_P(dec, r, avail):
    """mb_type_cabac_P (h264.cpp:11102-11114)."""
    cb = dec.cb
    if cb.decision(r, 14):
        return 5 + mb_type_I(dec, r, avail, 17, 0)
    if cb.decision(r, 15):
        return 1 if cb.decision(r, 17) else 2
    return 3 if cb.decision(r, 16) else 0


def mb_type_B(dec, r, avail):
    """mb_type_cabac_B (h264.cpp:11116-11145)."""
    cb = dec.cb
    idx = 27 + (((avail & 1) and dec.mbleft.type != MB_BDIRECT16x16)
                + ((avail & 2) and dec._top().type != MB_BDIRECT16x16))
    if not cb.decision(r, idx):
        return 0
    if not cb.decision(r, 27 + 3):
        return 1 + cb.decision(r, 27 + 5)
    idx = 27 + 4
    mode = cb.decision(r, idx) * 8
    idx += 1
    mode += cb.decision(r, idx) * 4
    mode += cb.decision(r, idx) * 2
    mode += cb.decision(r, idx)
    if mode < 8:
        return mode + 3
    if mode < 13:
        return mode * 2 + cb.decision(r, idx) - 4
    if mode == 13:
        return 23 + mb_type_I(dec, r, avail, 32, 0)
    if mode == 14:
        return 11
    return 22


def mb_skip(dec, r, slice_type):
    """mb_skip_cabac (h264.cpp:11147-11159)."""
    avail = dec._avail()
    ofs = 11 if slice_type == 0 else 24
    if (avail & 1) and dec.mbleft.mb_skip == 0:
        ofs += 1
    if (avail & 2) and dec._top().mb_skip == 0:
        ofs += 1
    return dec.cb.decision(r, ofs)


def intra4x4_pred_mode(dec, r, a, b):
    """intra4x4pred_mode_cabac (h264.cpp:11169-11183)."""
    cb = dec.cb
    pred = min(a, b)
    if not cb.decision(r, 68):
        rem = cb.decision(r, 69)
        rem += cb.decision(r, 69) * 2
        rem += cb.decision(r, 69) * 4
        pred = rem if rem < pred else rem + 1
    return pred


def intra_chroma_pred_mode(dec, r, avail):
    """intra_chroma_pred_mode_cabac (h264.cpp:11185-11198)."""
    cb = dec.cb
    idx = 64 + (int(bool(avail & 2) and dec._top().type < MB_IPCM
                    and dec._top().chroma_pred_mode != 0)
                + int(bool(avail & 1) and dec.mbleft.type < MB_IPCM
                      and dec.mbleft.chroma_pred_mode != 0))
    mode = cb.decision(r, idx)
    if mode:
        while mode < 3 and cb.decision(r, 64 + 3):
            mode += 1
    dec.chroma_pred_mode = mode
    return mode


def cbp(dec, r, avail):
    """cbp_cabac (h264.cpp:11200-11227)."""
    cb = dec.cb
    cbp_a = dec.mbleft.cbp if avail & 1 else 0x0F
    cbp_b = dec._top().cbp if avail & 2 else 0x0F
    inc = (not (cbp_a & 2)) + (not (cbp_b & 4)) * 2
    v = cb.decision(r, 73 + inc)
    inc = (not (v & 1)) + (not (cbp_b & 8)) * 2
    v += cb.decision(r, 73 + inc) * 2
    inc = (not (cbp_a & 8)) + (not (v & 1)) * 2
    v += cb.decision(r, 73 + inc) * 4
    inc = (not (v & 4)) + (not (v & 2)) * 2
    v += cb.decision(r, 73 + inc) * 8
    cbp_a >>= 4
    cbp_b >>= 4
    inc = (cbp_a != 0) + (cbp_b != 0) * 2
    if cb.decision(r, 77 + inc):
        inc = (cbp_a >> 1) + (cbp_b & 2)
        v = v + cb.decision(r, 77 + 4 + inc) * 16 + 16
    return v


def _unary(cb, r, limit):
    """unary_cabac (h264.cpp:11229-11242)."""
    x = 0
    idx = 62
    while limit:
        if cb.decision(r, idx):
            x += 1
            idx = 63
        else:
            break
        limit -= 1
    return x


def qp_delta(dec, r):
    """qp_delta_cabac (h264.cpp:11240-11252)."""
    cb = dec.cb
    idx = 60 + (dec.prev_qp_delta != 0)
    v = cb.decision(r, idx)
    if v:
        v = _unary(cb, r, 52) + 1
        v = ((v if v & 1 else -v) + 1) >> 1
    dec.prev_qp_delta = v
    return v


def mvd(dec, r, ctx_base, mva, mvb):
    """mvd_cabac (h264.cpp:11675-11717): UEG3, ctx by |mva|+|mvb|."""
    cb = dec.cb
    s = abs(int(mva)) + abs(int(mvb))
    inc = 0 if s < 3 else (1 if s <= 32 else 2)
    if not cb.decision(r, ctx_base + inc):
        return 0
    v = 1
    idx = ctx_base + 3
    while cb.decision(r, idx):
        idx += 1 if v < 4 else 0
        v += 1
        if v >= 9:
            exp = 3
            while cb.bypass(r) and exp < 16:
                v += 1 << exp
                exp += 1
            while exp:
                exp -= 1
                v += cb.bypass(r) << exp
            break
    return -v if cb.bypass(r) else v


def mvd_xy(dec, r, mvd_a, mvd_b):
    """mvd_xy_cabac (h264.cpp:11719-11725). Returns (dx, dy)."""
    dx = mvd(dec, r, 40, mvd_a[0], mvd_b[0])
    dy = mvd(dec, r, 47, mvd_a[1], mvd_b[1])
    return dx, dy


def ref_idx_sub(dec, r, inc):
    """ref_idx_cabac_sub (h264.cpp:11780-11788)."""
    cb = dec.cb
    idx = 0
    while cb.decision(r, 54 + inc):
        inc = (inc >> 2) + 4
        idx += 1
    return idx


def sub_mb_types_p(dec, r):
    """sub_mb_type_p_cabac (h264.cpp:11625-11643)."""
    cb = dec.cb
    out = []
    for _ in range(4):
        if cb.decision(r, 21):
            t = 0
        elif not cb.decision(r, 22):
            t = 1
        elif cb.decision(r, 23):
            t = 2
        else:
            t = 3
        out.append(t)
    return out


def sub_mb_type_b_one(dec, r):
    """sub_mb_type_b_one_cabac (h264.cpp:11645-11663)."""
    cb = dec.cb
    if not cb.decision(r, 36):
        return 0
    if not cb.decision(r, 37):
        return 1 + cb.decision(r, 39)
    if cb.decision(r, 38):
        if cb.decision(r, 39):
            return 11 + cb.decision(r, 39)
        t = 7
    else:
        t = 3
    t += cb.decision(r, 39) * 2
    return t + cb.decision(r, 39)


def transform8x8_flag(dec, r, avail):
    """transform_size_8x8_flag_cabac (h264.cpp:11161-11166)."""
    ofs = 399 + (int(bool(avail & 2) and dec._top().transform8x8 != 0)
                 + int(bool(avail & 1) and dec.mbleft.transform8x8 != 0))
    return dec.cb.decision(r, ofs)


# ---------------------------------------------------------------------
# residual block (h264.cpp:11465-11600)
# ---------------------------------------------------------------------
def _bypass_coeff(cb, r):
    """cabac_decode_bypass_coeff (h264.cpp:11525-11536)."""
    ln = 0
    while cb.bypass(r):
        ln += 1
    v0 = (1 << ln) - 1
    if ln:
        v0 += cb.multibypass(r, ln)
    return v0


def residual_block(dec, r, coeff, qmat, avail, pos4x4, cat):
    """residual_block_cabac (h264.cpp:11579-11600).

    The coded_block_flag context comes from the cbf accumulator +
    neighbor cbf bits (ctxidxinc_cbf tables, h264.cpp:11254-11463);
    dc_mask comes from COEFF_OFS.
    """
    cb = dec.cb
    if cat != 5:
        inc = _CTXIDXINC_CBF[pos4x4](dec, dec.cbf, avail)
        flag = cb.decision(r, 85 + inc + cat * 4)
        if not flag:
            return 0
    else:
        flag = 0xF
    dec.cbf |= flag << pos4x4
    ofs, num_coeff, dc_mask = COEFF_OFS[cat]
    # field slices use the field significance-map context offsets
    # (significant_coeff_flag_offset[2][6][2], h264.cpp:11492-11503)
    if dec.hdr.field_pic_flag:
        sig_ofs, last_ofs = _SIG_OFS_FIELD[cat]
    else:
        sig_ofs, last_ofs = CT.SIG_OFS[cat]
    latter = CT.SIG64 if cat == 5 else CT.SIG16
    # significance map (get_coeff_map_cabac)
    coeff_map = []
    i = 0
    ended = False
    for i in range(num_coeff - 1):
        if cb.decision(r, sig_ofs + latter[i][1]):
            coeff_map.append(i)
            if cb.decision(r, last_ofs + latter[i][0]):
                ended = True
                break
    if not ended:
        coeff_map.append(num_coeff - 1)
    # levels (get_coeff_from_map_cabac)
    abs_base = CT.ABS_LEVEL_OFS[cat] + 227
    zigzag = _ZIGZAG[cat]
    coeff[ofs : ofs + num_coeff] = 0
    node = 0
    for mp in range(len(coeff_map) - 1, -1, -1):
        if not cb.decision(r, abs_base + CT.COEFF_ABS_LEVEL_CTX[0][node]):
            lvl = 1
            node = CT.COEFF_ABS_LEVEL_TRANS[0][node]
        else:
            lvl = 2
            idx = abs_base + CT.COEFF_ABS_LEVEL_CTX[1][node]
            node = CT.COEFF_ABS_LEVEL_TRANS[1][node]
            while lvl < 15 and cb.decision(r, idx):
                lvl += 1
            if lvl == 15:
                lvl += _bypass_coeff(cb, r)
        zi = zigzag[coeff_map[mp] + ofs]
        coeff[zi] = (-lvl if cb.bypass(r) else lvl) * int(qmat[zi & dc_mask])
    n = len(coeff_map)
    return n if n <= 15 else 15


# ctxidxinc_cbf dispatch (h264.cpp:11254-11463); index = pos4x4 0..26
def _lt_ipcm(dec):
    return dec.mb_type < MB_IPCM


def _cbf0(dec, cbf, avail):
    ab = (dec.mbleft.cbf & 1) if avail & 1 else _lt_ipcm(dec)
    ab += (dec._top().cbf & 1) * 2 if avail & 2 else _lt_ipcm(dec) * 2
    return ab


def _cbf1(dec, cbf, avail):
    ab = cbf & 1
    ab += (dec._top().cbf & 2) if avail & 2 else _lt_ipcm(dec) * 2
    return ab


def _cbf2(dec, cbf, avail):
    ab = ((dec.mbleft.cbf >> 1) & 1) if avail & 1 else _lt_ipcm(dec)
    return ab + ((cbf * 2) & 2)


def _mk_inner3(n):
    def f(dec, cbf, avail):
        return ((cbf >> (n + 2)) & 1) | ((cbf >> n) & 2)
    return f


def _cbf4(dec, cbf, avail):
    ab = (cbf >> 1) & 1
    ab += ((dec._top().cbf >> 1) & 2) if avail & 2 else _lt_ipcm(dec) * 2
    return ab


def _cbf5(dec, cbf, avail):
    ab = (cbf >> 4) & 1
    ab += ((dec._top().cbf >> 2) & 2) if avail & 2 else _lt_ipcm(dec) * 2
    return ab


def _cbf6(dec, cbf, avail):
    return (cbf >> 3) & 3


def _cbf8(dec, cbf, avail):
    ab = ((dec.mbleft.cbf >> 2) & 1) if avail & 1 else _lt_ipcm(dec)
    return ab + ((cbf >> 1) & 2)


def _cbf9(dec, cbf, avail):
    return ((cbf >> 8) & 1) | ((cbf >> 2) & 2)


def _cbf10(dec, cbf, avail):
    ab = ((dec.mbleft.cbf >> 3) & 1) if avail & 1 else _lt_ipcm(dec)
    return ab + ((cbf >> 7) & 2)


def _cbf12(dec, cbf, avail):
    return ((cbf >> 9) & 1) | ((cbf >> 5) & 2)


def _cbf13(dec, cbf, avail):
    return ((cbf >> 12) & 1) | ((cbf >> 6) & 2)


def _cbf14(dec, cbf, avail):
    return (cbf >> 11) & 3


def _mk_chroma_dc(n):
    def f(dec, cbf, avail):
        ab = ((dec.mbleft.cbf >> (4 + n)) & 1) if avail & 1 else _lt_ipcm(dec)
        ab += (((dec._top().cbf >> (3 + n)) & 2) if avail & 2
               else _lt_ipcm(dec) * 2)
        return ab
    return f


def _mk_chroma_ac0(n):
    def f(dec, cbf, avail):
        ab = (((dec.mbleft.cbf >> (6 + n * 2)) & 1) if avail & 1
              else _lt_ipcm(dec))
        ab += (((dec._top().cbf >> (5 + n * 2)) & 2) if avail & 2
               else _lt_ipcm(dec) * 2)
        return ab
    return f


def _mk_chroma_ac1(n):
    def f(dec, cbf, avail):
        ab = (cbf >> (18 + n * 4)) & 1
        ab += (((dec._top().cbf >> (6 + n * 2)) & 2) if avail & 2
               else _lt_ipcm(dec) * 2)
        return ab
    return f


def _mk_chroma_ac2(n):
    def f(dec, cbf, avail):
        ab = (cbf >> (17 + n * 4)) & 2
        ab += (((dec.mbleft.cbf >> (7 + n * 2)) & 1) if avail & 1
               else _lt_ipcm(dec))
        return ab
    return f


def _cbf_i16dc(dec, cbf, avail):
    inc = ((dec.mbleft.cbf >> 10) & 1) if avail & 1 else 1
    inc += ((dec._top().cbf >> 9) & 2) if avail & 2 else 2
    return inc


_CTXIDXINC_CBF = (
    _cbf0, _cbf1, _cbf2, _mk_inner3(0),
    _cbf4, _cbf5, _cbf6, _mk_inner3(4),
    _cbf8, _cbf9, _cbf10, _mk_inner3(8),
    _cbf12, _cbf13, _cbf14, _mk_inner3(12),
    _mk_chroma_dc(0), _mk_chroma_dc(1),
    _mk_chroma_ac0(0), _mk_chroma_ac1(0), _mk_chroma_ac2(0), _mk_inner3(18),
    _mk_chroma_ac0(1), _mk_chroma_ac1(1), _mk_chroma_ac2(1), _mk_inner3(22),
    _cbf_i16dc,
)
