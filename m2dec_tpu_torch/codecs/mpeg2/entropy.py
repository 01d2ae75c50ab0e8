"""MPEG-1/2 Phase-A entropy decode: headers + slice/macroblock parse.

Bit-serial host-side parse that turns each coded picture into a dense
"decode plan" (per-MB mode/MV tensors + dequantized coefficient tensors)
consumed by the batched Phase-B reconstruction (codecs/mpeg2/reconstruct.py).
This is the two-phase redesign of the reference's interleaved
parse+reconstruct MB loop (reference: src/lib/mpeg2.cpp:1502-1524
`m2d_decode_macroblocks`, :320-623 header parsers).

Bit-exactness notes (reference quirks intentionally preserved):
* intra DC predictor stores the UNSATURATED value; only the emitted DC is
  clamped to [0, 2^(8+prec)-1] and only when dc_size != 0
  (mpeg2.cpp:920-939 `m2d_parse_intra_dc`);
* inverse quant: intra (|QF|*W*qs)>>4, inter ((2|QF|+1)*W*qs)>>5, negate by
  sign, SATURATE(-2048,2047) (mpeg2.cpp:943-961), except the inter-DC
  shortcut value which is not saturated (mpeg2.cpp:1328-1341);
* MPEG-2 mismatch control XORs bit0 of coef[63] when the level sum is even
  (mpeg2.cpp:974-983); MPEG-1 oddification decrements |c| on every even
  nonzero coefficient (mpeg2.cpp:1000-1013);
* motion vectors wrap into [-16<<r_size, 16<<r_size) (mpeg2.cpp:1189-1210);
* predictor reset rules: both at slice start; intra<->inter transitions;
  P-skip and P-no-MC reset both intra DC and MV predictors
  (mpeg2.cpp:740-763, :872-896, :1401-1417).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from m2dec_tpu_torch.bitstream import BitReader, BitstreamError
from . import tables as T

I_VOP, P_VOP, B_VOP = 1, 2, 3

MB_FORWARD, MB_BACKWARD, MB_INTRA, MB_PATTERN, MB_QUANT = 1, 2, 4, 8, 16
MB_MC = MB_FORWARD | MB_BACKWARD


@dataclasses.dataclass
class SeqState:
    """Sequence-level state (reference m2d_seq_header, mpeg2.h:60-77)."""

    width: int = 0
    height: int = 0
    mb_w: int = 0
    mb_h: int = 0
    is_mpeg2: bool = False
    progressive_sequence: int = 0
    aspect_ratio: int = 0
    frame_rate_code: int = 0
    bit_rate: int = 0
    vbv_buffer_size: int = 0
    # quant matrices in raster order: [intra, non-intra, chroma-intra,
    # chroma-non-intra]; 4:2:0 uses only the first two (mpeg2.cpp:1026)
    qmat: tuple = ()

    def __post_init__(self):
        if not self.qmat:
            self.qmat = (
                np.array(T.QMAT_INTRA_DEFAULT, np.int32),
                np.array(T.QMAT_NONINTRA_DEFAULT, np.int32),
                np.array(T.QMAT_INTRA_DEFAULT, np.int32),
                np.array(T.QMAT_NONINTRA_DEFAULT, np.int32),
            )

    def set_size(self, width, height):
        self.width = width
        self.height = height
        self.mb_w = (width + 15) >> 4
        self.mb_h = (height + 15) >> 4


@dataclasses.dataclass
class PicState:
    """Picture-level state (reference m2d_picture, mpeg2.h:85-109)."""

    coding_type: int = 0
    temporal_reference: int = 0
    # r_size[s][xy] = f_code - 1 (mpeg2.cpp:473-476)
    r_size: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((2, 2), np.int32)
    )
    intra_dc_precision: int = 0
    picture_structure: int = 3
    top_field_first: int = 0
    frame_pred_frame_dct: int = 1
    concealment_motion_vectors: int = 0
    q_scale_type: int = 0
    intra_vlc_format: int = 0
    alternate_scan: int = 0
    progressive_frame: int = 1


@dataclasses.dataclass
class PicturePlan:
    """Dense per-picture decode plan: Phase A output, Phase B input."""

    coding_type: int
    temporal_reference: int
    mb_w: int
    mb_h: int
    intra: np.ndarray  # bool [N]
    fwd: np.ndarray  # bool [N]
    bwd: np.ndarray  # bool [N]
    mvf: np.ndarray  # int32 [N, 2] half-pel (x, y)
    mvb: np.ndarray  # int32 [N, 2]
    dct_type: np.ndarray  # uint8 [N]
    coef: np.ndarray  # int16 [N, 6, 64] raster order within block
    covered: np.ndarray  # bool [N] — MB written by some slice
    # field motion in frame pictures (motion_type=1): second field MV per
    # direction, field-select bits (b0/b1 fwd f0/f1, b2/b3 bwd), flag
    dc0: np.ndarray = None  # int16 [N, 6] pre-oddification DC (FAST_DECODE)
    mvf2: np.ndarray = None  # int32 [N, 2] (field units)
    mvb2: np.ndarray = None
    fsel: np.ndarray = None  # uint8 [N]
    fieldmc: np.ndarray = None  # bool [N]

    @classmethod
    def empty(cls, coding_type, temporal_reference, mb_w, mb_h):
        n = mb_w * mb_h
        return cls(
            coding_type=coding_type,
            temporal_reference=temporal_reference,
            mb_w=mb_w,
            mb_h=mb_h,
            intra=np.zeros(n, bool),
            fwd=np.zeros(n, bool),
            bwd=np.zeros(n, bool),
            mvf=np.zeros((n, 2), np.int32),
            mvb=np.zeros((n, 2), np.int32),
            dct_type=np.zeros(n, np.uint8),
            coef=np.zeros((n, 6, 64), np.int16),
            covered=np.zeros(n, bool),
            dc0=np.zeros((n, 6), np.int16),
            mvf2=np.zeros((n, 2), np.int32),
            mvb2=np.zeros((n, 2), np.int32),
            fsel=np.zeros(n, np.uint8),
            fieldmc=np.zeros(n, bool),
        )


def _sign_extend(v, bits):
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


class Mpeg2EntropyDecoder:
    """Parses one picture's slices into a PicturePlan.

    Holds the intra-picture predictor state the reference keeps in
    m2d_mb_current (mpeg2.h:146-172).
    """

    def __init__(self, seq: SeqState, pic: PicState):
        self.seq = seq
        self.pic = pic
        self.scan = np.array(T.SCAN[pic.alternate_scan], np.int32)
        self.q_mapping = T.Q_SCALE[pic.q_scale_type]
        self.intra_dc_scale = 3 - pic.intra_dc_precision
        self.intra_dc_max = (1 << (pic.intra_dc_precision + 8)) - 1
        # table selector includes concealment bit (mpeg2.cpp:485):
        # m2d_dct_tables[ivf] with [2]=[0], [3]=[1] (vld.h:326-331)
        self.intra_vlc = (pic.concealment_motion_vectors * 2) | pic.intra_vlc_format
        # frame_mode (set_coding_extension_param, mpeg2.cpp:489-497):
        # field pictures (structure 1/2) -> 0; frames -> 1/3
        if pic.picture_structure != 3:
            self.frame_mode = 0
        else:
            self.frame_mode = 3 if pic.frame_pred_frame_dct else 1
        self.plan = PicturePlan.empty(
            pic.coding_type, pic.temporal_reference, seq.mb_w, seq.mb_h
        )
        # predictor state
        self.q_scale = 0
        self.dc_pred = np.zeros(3, np.int64)
        self.pmv = np.zeros((2, 2, 2), np.int64)  # [dir][pair][xy]
        self.mb_type = 0  # persists across slices (mpeg2.h:153)
        self.mb_i = -1  # linear MB index (mb_x=-1 encoding at slice start)
        self.mb_y = 0
        self.dct_type = 0
        self.motion_type = None  # (mv_count, is_field_fmt, dmv)

    # ------------------------------------------------------------------
    def n_mbs(self):
        return self.seq.mb_w * self.seq.mb_h

    def is_last(self):
        """m2d_is_last (mpeg2.cpp:1488-1494)."""
        return self.mb_i >= self.n_mbs() - 1

    def _reset_intra(self):
        self.dc_pred[:] = (self.intra_dc_max + 1) >> 1

    def _reset_inter(self):
        self.pmv[:] = 0

    # ------------------------------------------------------------------
    def decode_slice(self, r: BitReader, vertical_pos: int) -> bool:
        """Decode one slice (reference m2d_read_slice + m2d_decode_macroblocks,
        mpeg2.cpp:625-660, :1502-1524). Returns True when the picture's last
        MB has been decoded."""
        self.q_scale = self.q_mapping[r.get_bits(5)]
        if vertical_pos >= self.seq.mb_h:
            return False
        if vertical_pos - self.mb_y > 1:
            # gap slices: rows copied from forward ref (m2d_copy_slice,
            # mpeg2.cpp:715-733) — plan-encode as zero-MV forward copies
            first = (self.mb_y + 1) * self.seq.mb_w
            last = vertical_pos * self.seq.mb_w
            self.plan.fwd[first:last] = True
            self.plan.covered[first:last] = True
        self.mb_y = vertical_pos
        self.mb_i = vertical_pos * self.seq.mb_w - 1
        if r.get_onebit():
            r.get_bits(1 * 2 + 6)
            while r.get_onebit():
                r.get_bits(8)
        # macroblock loop
        self._reset_intra()
        self._reset_inter()
        while True:
            mb_inc = self._mb_address_increment(r)
            if mb_inc > 1:
                self._skip_mbs(mb_inc)
            self.mb_i += 1
            self._parse_macroblock(r)
            if self.is_last():
                self.mb_y = self.seq.mb_h
                return True
            if r.bits_remaining() < 23 or r.show_bits(23) == 0:
                break
        self.mb_y = self.mb_i // self.seq.mb_w
        return False

    def _mb_address_increment(self, r):
        """mpeg2.cpp:1427-1449 (escape accumulates 33 per occurrence)."""
        val = 0
        while True:
            t = T.MB_INC_DEC.read(r)
            if t != "ESC":
                return val + t
            val += 33

    # ------------------------------------------------------------------
    def _skip_mbs(self, mb_inc):
        """Skipped-MB propagation (m2d_skip_mb_P/B, mpeg2.cpp:740-808)."""
        plan = self.plan
        if self.pic.coding_type == B_VOP:
            d = self.mb_type & MB_MC
            is_bidir = d == MB_MC
            dirsel = 0 if is_bidir else (d >> 1)
            for _ in range(mb_inc - 1):
                self.mb_i += 1
                i = self.mb_i
                plan.covered[i] = True
                if is_bidir:
                    plan.fwd[i] = plan.bwd[i] = True
                    plan.mvf[i] = self.pmv[0, 0]
                    plan.mvb[i] = self.pmv[1, 0]
                elif dirsel == 0:
                    plan.fwd[i] = True
                    plan.mvf[i] = self.pmv[0, 0]
                else:
                    plan.bwd[i] = True
                    plan.mvb[i] = self.pmv[1, 0]
            # B-skip does not reset predictors
        else:
            for _ in range(mb_inc - 1):
                self.mb_i += 1
                plan.covered[self.mb_i] = True
                plan.fwd[self.mb_i] = True  # zero-MV copy from ref0
            self._reset_intra()
            self._reset_inter()

    # ------------------------------------------------------------------
    def _parse_macroblock(self, r):
        """m2d_parse_macroblock (mpeg2.cpp:1401-1417)."""
        prev_intra = self.mb_type & MB_INTRA
        mb_type = self._decode_mb_mode(r)
        if mb_type & MB_INTRA:
            if not prev_intra:
                self._reset_intra()
            self._parse_intra_mb(r)
        else:
            if prev_intra:
                self._reset_inter()
            self._parse_inter_mb(r)

    def _decode_mb_mode(self, r):
        """m2d_decode_macroblock_mode (mpeg2.cpp:834-870)."""
        ct = self.pic.coding_type
        if ct == I_VOP:
            mb_type = T.MB_TYPE_DEC[0].read(r)
        else:
            mb_type = T.MB_TYPE_DEC[ct - 1].read(r)
        self.mb_type = mb_type
        fm = self.frame_mode
        if mb_type & MB_MC:
            if fm & 1:
                idx = r.get_bits(2) if fm == 1 else 2
                if idx == 2:
                    self.motion_type = (1, 0, 0)  # frame MVs
                elif idx <= 1:
                    # field MVs in frame pic; idx 0 is the reference's
                    # "dummy" row == row 1 (m2d_motion_type[0][0],
                    # mpeg2.cpp:819)
                    self.motion_type = (2, 1, 0)
                else:
                    # dual prime: the reference parses the dmvectors and
                    # DISCARDS them, then frame-MCs with the single
                    # field-unit MV (m2d_motion_type[0][3] mv_count=1 +
                    # m2d_motion_comp, mpeg2.cpp:819-825, :1212-1220)
                    self.motion_type = (1, 1, 1)
            else:
                # field picture: m2d_motion_type[1][idx] (mpeg2.cpp:826-831)
                idx = r.get_bits(2)
                if idx <= 1:
                    # field MC, 1 mv: vertical_field_select read+discarded,
                    # m2d_motion_comp takes the mv_count==1 (plain) path;
                    # idx 0 is the "dummy" row == row 1
                    # (m2d_motion_type[1][0], mpeg2.cpp:826)
                    self.motion_type = (1, 1, 0)
                elif idx == 2:
                    self.motion_type = (2, 1, 0)  # 16x8 MC (pair path)
                else:
                    self.motion_type = (1, 1, 1)  # field dual prime
        elif fm == 0:
            self.motion_type = (1, 1, 0)  # m2d_motion_type[1][1]
        else:
            self.motion_type = (1, 0, 0)
        if fm == 1 and (mb_type & (MB_PATTERN | MB_INTRA)):
            self.dct_type = r.get_onebit()
        elif fm != 0:
            self.dct_type = 0
        else:
            self.dct_type = 1
        return mb_type

    # -- motion vectors -------------------------------------------------
    def _one_mv(self, r, s, pair, xy, is_field):
        """m2d_one_mv (mpeg2.cpp:1189-1210)."""
        r_size = int(self.pic.r_size[s][xy])
        pred = int(self.pmv[s, pair, xy])
        code = T.MOTION_CODE_DEC.read(r)
        if code != 0:
            residual = 1 + r.get_bits(r_size) if r_size > 0 else 1
            if code >= 0:
                mv = ((code - 1) << r_size) + residual
            else:
                mv = ((code + 1) << r_size) - residual
            mv += pred >> is_field
            limit = 16 << r_size
            if mv < -limit:
                mv += 2 * limit
            elif mv >= limit:
                mv -= 2 * limit
        else:
            mv = pred >> is_field
        self.pmv[s, pair, xy] = mv << is_field
        return mv

    @staticmethod
    def _dmvector(r):
        """dmvector[] parse (discarded, m2d_one_mv_with_dmv
        mpeg2.cpp:1212-1220)."""
        if r.get_onebit():
            r.get_onebit()

    def _motion_vectors(self, r, s):
        """m2d_motion_vectors (mpeg2.cpp:1245-1275): frame MVs or two
        field MVs with per-field reference select."""
        mv_count, fmt_field, dmv = self.motion_type
        if mv_count == 1:
            if fmt_field and not dmv:
                r.get_onebit()  # motion_vertical_field_select
            mx = self._one_mv(r, s, 0, 0, 0)
            if dmv:
                self._dmvector(r)
            my = self._one_mv(r, s, 0, 1, fmt_field)
            if dmv:
                self._dmvector(r)
            # copy first PMV pair into second (mpeg2.cpp:1265-1266)
            self.pmv[s, 1] = self.pmv[s, 0]
            return (mx, my), None, 0
        mvs = []
        sel = 0
        for pair in range(2):
            sel |= r.get_onebit() << pair
            mx = self._one_mv(r, s, pair, 0, 0)
            my = self._one_mv(r, s, pair, 1, 1)
            mvs.append((mx, my))
        return mvs[0], mvs[1], sel

    # -- intra ----------------------------------------------------------
    def _parse_intra_dc(self, r, comp):
        """m2d_parse_intra_dc (mpeg2.cpp:920-939): comp 0=luma, 1=Cb, 2=Cr."""
        size = T.DCT_DC_SIZE_DEC[0 if comp == 0 else 1].read(r)
        dc = int(self.dc_pred[comp])
        if size != 0:
            diff = r.get_bits(size)
            half = 1 << (size - 1)
            if not diff & half:
                diff = diff + 1 - half * 2
            dc += diff
            self.dc_pred[comp] = dc  # stored unsaturated
            dc = min(max(dc, 0), self.intra_dc_max)
        return dc << self.intra_dc_scale

    def _parse_intra_mb(self, r):
        """m2d_parse_intra_macroblock (mpeg2.cpp:1162-1184)."""
        i = self.mb_i
        plan = self.plan
        plan.covered[i] = True
        plan.intra[i] = True
        plan.dct_type[i] = self.dct_type
        if self.mb_type & MB_QUANT:
            self.q_scale = self.q_mapping[r.get_bits(5)]
        if self.pic.concealment_motion_vectors:
            self._motion_vectors(r, 0)  # tuple return ignored
            if not r.get_onebit():
                raise BitstreamError("concealment marker bit")
        for blk in range(4):
            coef = plan.coef[i, blk]
            coef[0] = self._parse_intra_dc(r, 0)
            plan.dc0[i, blk] = self._parse_coef(r, coef, 1, intra=True)
        for blk in range(2):
            coef = plan.coef[i, 4 + blk]
            coef[0] = self._parse_intra_dc(r, blk + 1)
            plan.dc0[i, 4 + blk] = self._parse_coef(r, coef, 1, intra=True)

    # -- inter ----------------------------------------------------------
    def _parse_inter_mb(self, r):
        """m2d_parse_inter_macroblock (mpeg2.cpp:1358-1396)."""
        i = self.mb_i
        plan = self.plan
        plan.covered[i] = True
        plan.dct_type[i] = self.dct_type
        mb_type = self.mb_type
        if mb_type & MB_QUANT:
            self.q_scale = self.q_mapping[r.get_bits(5)]
        if mb_type & MB_MC:
            is_field = self.motion_type[0] == 2
            plan.fieldmc[i] = is_field
            if mb_type & MB_FORWARD:
                plan.fwd[i] = True
                mv1, mv2, sel = self._motion_vectors(r, 0)
                plan.mvf[i] = mv1
                if is_field:
                    plan.mvf2[i] = mv2
                    plan.fsel[i] |= sel
            if mb_type & MB_BACKWARD:
                plan.bwd[i] = True
                mv1, mv2, sel = self._motion_vectors(r, 1)
                plan.mvb[i] = mv1
                if is_field:
                    plan.mvb2[i] = mv2
                    plan.fsel[i] |= sel << 2
        else:
            # no-MC: zero-MV copy + predictor reset (m2d_skip_mb_P(mb, 0))
            plan.fwd[i] = True
            plan.mvf[i] = 0
            self._reset_intra()
            self._reset_inter()
        if mb_type & MB_PATTERN:
            cbp = T.CBP_DEC.read(r)
            for blk in range(4):
                if cbp & (1 << (5 - blk)):
                    plan.dc0[i, blk] = self._parse_inter_block(
                        r, plan.coef[i, blk])
            for blk in range(2):
                if cbp & (1 << (1 - blk)):
                    plan.dc0[i, 4 + blk] = self._parse_inter_block(
                        r, plan.coef[i, 4 + blk])

    def _parse_inter_block(self, r, coef):
        """m2d_parse_inter_block incl. the '1s' DC shortcut
        (mpeg2.cpp:1317-1341)."""
        start = 0
        bits = r.show_bits(2)
        if bits & 2:
            r.skip_bits(2)
            level = 1 if bits == 2 else -1
            q = self.q_scale * int(self.seq.qmat[1][0])
            t = ((2 * abs(level) + 1) * q) >> 5
            coef[0] = np.int16(t if level > 0 else -t)  # NOT saturated
            start = 1
        return self._parse_coef(r, coef, start, intra=False)

    # -- coefficients ----------------------------------------------------
    def _parse_coef(self, r, coef, start_idx, intra):
        """parse_coef template (mpeg2.cpp:1020-1097)."""
        table = T.DCT_TABLE_DEC[self.intra_vlc & 1] if intra else T.DCT_TABLE_DEC[0]
        qmat = self.seq.qmat[0 if intra else 1]
        q_scale = self.q_scale
        scan = self.scan
        mpeg1 = not self.seq.is_mpeg2
        mismatch = int(coef[0]) if start_idx else 0
        idx = start_idx
        while True:
            sym = table.read(r)
            if sym == "EOB":
                break
            if sym == "ESC":
                idx += r.get_bits(6)
                if mpeg1:
                    level = r.get_bits(8)
                    if (level & 0x7F) == 0:
                        level = r.get_bits(8) - (level & 0x80) * 2
                    else:
                        level = _sign_extend(level, 8)
                else:
                    level = _sign_extend(r.get_bits(12), 12)
            else:
                run, level = sym
                idx += run
            if idx >= 64:
                break
            pos = int(scan[idx])
            q = int(qmat[pos]) * q_scale
            if intra:
                t = (abs(level) * q) >> 4
            else:
                t = ((2 * abs(level) + 1) * q) >> 5
            val = -t if level < 0 else t
            val = min(max(val, -2048), 2047)
            mismatch += val
            coef[pos] = val
            idx += 1
        raw0 = int(coef[0])  # pre-oddification DC (FAST_DECODE keeps this)
        if mpeg1:
            # oddification (MismatchMpeg1, mpeg2.cpp:1000-1013)
            c = coef.astype(np.int32)
            even_nz = (c != 0) & ((c & 1) == 0)
            coef[even_nz & (c > 0)] -= 1
            coef[even_nz & (c < 0)] += 1
        else:
            if not mismatch & 1:
                coef[63] ^= 1
        return raw0
