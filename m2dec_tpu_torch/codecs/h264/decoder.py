"""H.264 decoder driver and macroblock layer (CAVLC path).

Behavioral mirror of the reference's decode flow (reference:
src/lib/h264.cpp): NAL dispatch (:871-900), slice header (:1417-1581),
slice_data loop (:10210-10251), macroblock layer dispatch (:9589-9734),
in-place per-MB reconstruction, whole-frame deblocking post-pass
(:10540-10663), reference marking + POC-ordered DPB output (:10665-11050).

Neighbor-context caches replicate the reference's packed per-column state
(left/top prediction modes, nC counts, prev-MB info, deblock strength
records) as plain Python/numpy structures.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from m2dec_tpu_torch.bitstream import BitReader
from m2dec_tpu_torch.bitstream.reader import (
    BitstreamExhausted,
    find_start_codes,
    unescape_nal,
)
from m2dec_tpu_torch.runtime import trace
from . import cabac as AE, cavlc, dpb as dpb_mod, headers, pred, pred8x8 as P8, tables as T, transforms as X
from .dpb import (
    LONG_TERM,
    NOT_IN_USE,
    SHORT_TERM,
    Dpb,
    RefFrame,
    marking_mmco,
    marking_sliding_window,
    ref_pic_init_b,
    ref_pic_init_p,
    ref_pic_list_reordering,
)
from .headers import (
    B_SLICE,
    I_SLICE,
    P_SLICE,
    PPS_NAL,
    SEI_NAL,
    SLICE_IDR_NAL,
    SLICE_NONIDR_NAL,
    SPS_NAL,
    parse_pps,
    parse_sps,
)

MB_INxN, MB_I16x16, MB_IPCM = 0, 1, 25
MB_P16x16, MB_P16x8, MB_P8x16, MB_P8x8, MB_P8x8REF0 = 26, 27, 28, 29, 30
MB_PSKIP = MB_BDIRECT16x16 = 31


@dataclasses.dataclass
class PrevMb:
    """Neighbor cache entry (reference prev_mb_t, h264.h:330-342)."""

    type: int = 0
    cbp: int = 0
    cbf: int = 0
    chroma_pred_mode: int = 0
    transform8x8: int = 0
    mb_skip: int = 0
    direct8x8: int = 0
    ref: np.ndarray = None
    frmidx: np.ndarray = None
    mov: np.ndarray = None  # [4][2][2] int32
    mvd: np.ndarray = None

    def __post_init__(self):
        self.ref = np.zeros((2, 2), np.int32)
        self.frmidx = np.zeros((2, 2), np.int32)
        self.mov = np.zeros((4, 2, 2), np.int32)
        self.mvd = np.zeros((4, 2, 2), np.int32)


@dataclasses.dataclass
class DeblockInfo:
    """deblock_info_t (h264.h:344-348)."""

    idc: int = 0
    qpy: int = 0
    qpc: tuple = (0, 0)
    slicehdr: tuple = (0, 0)  # (alpha_offset, beta_offset), pre-decoded
    str4_vert: int = 0
    str4_horiz: int = 0
    str_vert: int = 0
    str_horiz: int = 0


class Frame:
    def __init__(self, w, h):
        self.y = np.zeros((h, w), np.uint8)
        self.cb = np.zeros((h // 2, w // 2), np.uint8)
        self.cr = np.zeros((h // 2, w // 2), np.uint8)
        self.cnt = 0


@dataclasses.dataclass
class SliceHeader:
    slice_type: int = 0
    pps_id: int = 0
    frame_num: int = 0
    prev_frame_num: int = 0
    first_mb_in_slice: int = 0
    idr: int = 0
    idr_pic_id: int = 0
    poc: int = 0
    poc_lsb: int = 0
    poc_msb: int = 0
    poc1_num_offset: int = 0
    poc2_prev_frameoffset: int = 0
    num_ref_idx_active: tuple = (0, 0)
    qp_delta: int = 0
    disable_deblocking_filter_idc: int = 0
    alpha_c0_offset: int = 0
    beta_offset: int = 0
    mmco5: int = 0
    long_term_reference_flag: int = 0
    adaptive_marking: int = 0
    mmcos: tuple = ()
    direct_spatial_mv_pred_flag: int = 0
    field_pic_flag: int = 0
    bottom_field_flag: int = 0


class H264Decoder:
    """H.264 Annex-B elementary stream decoder (CAVLC I slices onward)."""

    def __init__(self, num_frames=None, dpb_max=-1, record_plans=False,
                 native=False, phase_b=None, plan_alloc="zeros",
                 device=None):
        """native=True: per-MB slice decode runs in C++ (Phase A), plans
        collected without Python reconstruction. phase_b (native only):
        None (plans only; runtime/turbo.py reconstructs them), "torch"
        to reconstruct each picture from its plan on ``device``
        (reconstruct.reconstruct_plan_torch; default: the CUDA device,
        resolved here, so a missing card raises now).
        plan_alloc="empty" (native only) skips plan zero-initialization
        (C-side clear + coded-map gating; see NativeH264Session)."""
        if phase_b not in (None, "torch"):
            raise ValueError(f"phase_b={phase_b!r}: None or 'torch'")
        self.native = native
        self.phase_b = phase_b
        if phase_b == "torch":
            from ...device import resolve_device

            device = resolve_device(device)
        self.device = device
        self.plan_alloc = plan_alloc if native else "zeros"
        self.native_session = None
        if native:
            record_plans = True
        self.sps_store: dict = {}
        self.pps_store: dict = {}
        self.hdr = SliceHeader()
        self.dpb_max_cfg = dpb_max
        self.dpb = Dpb(dpb_max)
        self.num_frames_cfg = num_frames
        self.frames: list[Frame] = []
        self.lru: list[int] = []
        self.refs = [[RefFrame() for _ in range(16)] for _ in range(2)]
        self.cur_idx = -1
        self.data = b""
        self.nal_units: list = []
        self.nal_i = 0
        self.inited = False
        self.nal_id = 0
        #: DPB entries voided by a mid-stream pool reallocation (they
        #: drain as zero-byte frames; see _sps_update)
        self._void_pending = 0
        self.cb = AE.CabacEngine()
        self.is_cabac = False
        self.tc = None  # optional CAVLC->CABAC transcode sink (tests)
        self.rec = None  # active PlanRecorder (Phase-A tap, plan.py)
        self.plans = [] if record_plans else None
        self.weighted_mode = 0
        self.weight_shift = (0, 0)
        self.weight_tab = None

    # ------------------------------------------------------------ input --
    def set_data(self, data: bytes):
        self.data = bytes(data)
        offs = find_start_codes(self.data)
        self.nal_units = []
        for k, off in enumerate(offs):
            start = int(off) + 3
            end = int(offs[k + 1]) if k + 1 < len(offs) else len(self.data)
            # trim trailing zero_bytes before the next start code
            while end > start and self.data[end - 1] == 0:
                end -= 1
            if end > start:
                self.nal_units.append((self.data[start] & 31, self.data[start], start, end))
        self.nal_i = 0

    # ------------------------------------------------------- allocation --
    def _alloc(self, sps):
        n = self.num_frames_cfg or (sps.num_ref_frames + 1 + 2)
        n = min(n + 16, 64) if self.num_frames_cfg is None else n
        self.frames = [Frame(sps.pic_width, sps.pic_height) for _ in range(n)]
        #: pool buffer capacity for the SetFrames sufficiency check
        #: (frames.h sufficient(): the ORIGINAL allocation size)
        self._pool_luma_cap = sps.pic_width * sps.pic_height
        self.lru = [0] * n
        self.max_x = sps.pic_width >> 4
        self.max_y = sps.pic_height >> 4
        nmb = self.max_x * self.max_y
        self.deblock = [DeblockInfo() for _ in range(nmb)]
        # colocated motion pages: the reference gives every L1 ref slot a
        # distinct page at init (init_mb_buffer, h264.cpp:539-544) plus a
        # spare curr_col; pages then travel with RefFrame objects via the
        # post_process std::swap.
        for i in range(16):
            self.refs[1][i].col = self._new_col_page(nmb)
        self.curr_col = self._new_col_page(nmb)
        if self.native:
            from .native_session import NativeH264Session

            self.native_session = NativeH264Session(
                self.max_x, self.max_y, plan_alloc=self.plan_alloc)
        self.inited = True

    def _sps_update(self, sps):
        """Mid-stream SPS: the reference's header-callback reallocation
        (SPS dispatch h264.cpp:885-891 -> M2Decoder::SetFrames,
        m2decoder.h:54-80).  A pool that stays sufficient is kept
        untouched (parameter-only SPS updates); a geometry change
        replaces the pool and re-inits the frame bookkeeping
        (frames_init, h264.cpp:637-643 — fresh buffers, LRU zeroed;
        the typical conforming switch is a drained DPB followed by an
        IDR at the new geometry, which this reproduces byte-exactly).
        A switch to a geometry the pool still covers (e.g. a smaller
        resolution) keeps the pool AND its content: pending DPB frames
        drain normally at their own dimensions while new pictures
        decode into lazily re-shaped slots (_find_empty_frame)."""
        n_needed = self.num_frames_cfg or min(
            sps.num_ref_frames + 1 + 2 + 16, 64)
        sufficient = (n_needed <= len(self.frames)
                      and sps.pic_width * sps.pic_height
                      <= self._pool_luma_cap)
        if sufficient:
            if (sps.pic_width, sps.pic_height) != (
                    self.max_x << 4, self.max_y << 4):
                # set_mb_size (h264.cpp:548-552): geometry switches now;
                # per-geometry scratch rebuilds, pool/DPB/refs stay
                self.max_x = sps.pic_width >> 4
                self.max_y = sps.pic_height >> 4
                nmb = self.max_x * self.max_y
                self.deblock = [DeblockInfo() for _ in range(nmb)]
                self.curr_col = self._new_col_page(nmb)
                if self.native:
                    from .native_session import NativeH264Session

                    self.native_session = NativeH264Session(
                        self.max_x, self.max_y,
                        plan_alloc=self.plan_alloc)
            return
        # frames still pending in the DPB reference the REPLACED pool:
        # the reference then emits zero bytes for each of them (observed:
        # empty-md5 golden lines / no raw bytes) — modelled as void
        # frames drained ahead of the new segment's output
        self._void_pending += len(self.dpb.data)
        self.refs = [[RefFrame() for _ in range(16)] for _ in range(2)]
        self._alloc(sps)  # fresh pool + col pages onto the new refs

    @staticmethod
    def _new_col_page(nmb):
        return {
            "type": np.zeros(nmb, np.int32),
            "ref": np.zeros((nmb, 4), np.int32),
            "mv": np.zeros((nmb, 16, 2), np.int32),
            "map_col_frameidx": np.zeros(16, np.int32),
        }

    # ---------------------------------------------------------- decode --
    def decode_picture(self):
        """h264d_decode_picture (h264.cpp:663-693): decode NALs until one
        picture completes. Returns 1 on completion, -1 at end of stream,
        -2 on mid-NAL truncation (the reference's refill-longjmp error
        containment: setjmp at h264.cpp:673 catches bitio.c:122 and
        returns -2 with the partial picture abandoned; callers drain the
        DPB, m2decoder.h:137-143)."""
        self.hdr.first_mb_in_slice = 1 << 30
        try:
            while self.nal_i < len(self.nal_units):
                nal_type, nal_byte, start, end = self.nal_units[self.nal_i]
                self.nal_i += 1
                payload = unescape_nal(self.data[start + 1 : end])
                r = BitReader(payload)
                if nal_type in (SLICE_NONIDR_NAL, SLICE_IDR_NAL):
                    self.nal_id = nal_byte
                    done = self._read_slice(r)
                    if done:
                        return 1
                elif nal_type == SPS_NAL:
                    sid = parse_sps(r, self.sps_store)
                    if not self.inited:
                        self._alloc(self.sps_store[sid])
                    else:
                        self._sps_update(self.sps_store[sid])
                elif nal_type == PPS_NAL:
                    parse_pps(r, self.pps_store)
                # SEI / AUD / others skipped
        except BitstreamExhausted:
            return -2
        return -1

    def _next_nal_same_picture(self):
        """True when the next NAL is provably another slice of THIS
        picture (first_mb_in_slice > 0) — the licence for decoding the
        current slice asynchronously. Any doubt returns False (the
        slice then runs synchronously; behavior identical)."""
        if self.nal_i >= len(self.nal_units):
            return False
        nal_type, _, start, end = self.nal_units[self.nal_i]
        if nal_type not in (SLICE_NONIDR_NAL, SLICE_IDR_NAL):
            return False
        try:
            head = unescape_nal(self.data[start + 1 : min(end, start + 9)])
            return BitReader(head).ue() > 0
        except Exception:
            return False

    # -------------------------------------------------------- POC calc --
    def _calc_poc(self, r, sps, pps):
        hdr = self.hdr
        if sps.poc_type == 0:
            lsb = r.get_bits(sps.log2_max_poc_lsb)
            if not hdr.field_pic_flag and pps.pic_order_present_flag:
                r.se()  # delta_pic_order_cnt_bottom
            if hdr.first_mb_in_slice != 0:
                return
            if hdr.idr or hdr.mmco5:
                prev_msb = 0
                # mmco5 bottom field keeps prev lsb (h264.cpp:1131-1135)
                prev_lsb = (hdr.poc_lsb if (hdr.mmco5 and hdr.field_pic_flag
                                            and hdr.bottom_field_flag)
                            else 0)
            else:
                prev_lsb, prev_msb = hdr.poc_lsb, hdr.poc_msb
            hdr.poc_lsb = lsb
            half = (1 << sps.log2_max_poc_lsb) >> 1
            if lsb < prev_lsb and half <= prev_lsb - lsb:
                msb = prev_msb + half * 2
            elif prev_lsb < lsb and half < lsb - prev_lsb:
                msb = prev_msb - half * 2
            else:
                msb = prev_msb
            hdr.poc_msb = msb
            hdr.poc = msb + lsb
        elif sps.poc_type == 1:
            d0 = d1 = 0
            if not sps.delta_pic_order_always_zero_flag:
                d0 = r.se()
                if not hdr.field_pic_flag and pps.pic_order_present_flag:
                    d1 = r.se()
            if hdr.first_mb_in_slice != 0:
                return
            frame_num = hdr.frame_num
            if not hdr.idr and not hdr.mmco5:
                if frame_num < hdr.prev_frame_num:
                    hdr.poc1_num_offset += 1 << sps.log2_max_frame_num
            else:
                hdr.poc1_num_offset = 0
            ncyc = sps.num_ref_frames_in_pic_order_cnt_cycle
            if ncyc:
                fn = frame_num + hdr.poc1_num_offset
                if fn != 0:
                    cycle_sum = sps.offset_for_ref_frame[ncyc - 1]
                    fn -= 1
                    if fn != 0 and not (self.nal_id & 0x60):
                        fn -= 1
                    cycle_cnt = 0
                    while cycle_sum <= fn:
                        fn -= cycle_sum
                        cycle_cnt += 1
                    poc = cycle_cnt * cycle_sum + sps.offset_for_ref_frame[fn & 255]
                else:
                    poc = sps.offset_for_ref_frame[0]
                if (self.nal_id & 0x60) == 0:
                    poc += sps.offset_for_non_ref_pic
            else:
                poc = 0
            hdr.poc = poc + d0
        else:
            if hdr.first_mb_in_slice != 0:
                return
            frame_num = hdr.frame_num
            if hdr.idr or hdr.mmco5:
                hdr.poc2_prev_frameoffset = 0
            elif frame_num < hdr.prev_frame_num:
                hdr.poc2_prev_frameoffset += 1 << sps.log2_max_frame_num
            hdr.poc = (frame_num + hdr.poc2_prev_frameoffset) * 2 - (
                (self.nal_id & 0x60) == 0
            )

    # ---------------------------------------------------- frame choice --
    def _find_empty_frame(self):
        """find_empty_frame (h264.cpp:924-962)."""
        for i in range(len(self.frames)):
            if self.dpb.exists(i):
                self.lru[i] = 0
            else:
                self.lru[i] += 1
        for lx in range(2):
            for rf in self.refs[lx]:
                if rf.in_use:
                    self.lru[rf.frame_idx] = 0
        max_idx = int(np.argmax(self.lru))
        self.lru[max_idx] = 0
        self.cur_idx = max_idx
        # lazily re-create the claimed slot at the active geometry: a
        # sufficient-pool SPS change (m2decoder.h SetFrames early-out)
        # keeps the pool, and the reference then decodes new-geometry
        # pictures into the reused buffers; pending DPB frames keep
        # their own dimensions
        f = self.frames[max_idx]
        if f.y.shape != (self.max_y << 4, self.max_x << 4):
            self.frames[max_idx] = Frame(self.max_x << 4,
                                         self.max_y << 4)

    # -------------------------------------------------------- slice hdr --
    def _read_slice(self, r):
        hdr = self.hdr
        prev_first_mb = hdr.first_mb_in_slice
        first_mb = r.ue()
        hdr.first_mb_in_slice = first_mb
        new_picture = first_mb <= prev_first_mb
        if new_picture and prev_first_mb != 1 << 30:
            return False  # invalid ordering (reference returns -2)
        slice_type = r.ue()
        slice_type = slice_type - 5 if slice_type > 4 else slice_type
        hdr.slice_type = slice_type
        if slice_type > 2:
            raise NotImplementedError("SP/SI slices")
        hdr.pps_id = r.ue()
        pps = self.pps_store[hdr.pps_id]
        sps = self.sps_store[pps.seq_parameter_set_id]
        self.is_cabac = bool(pps.entropy_coding_mode_flag)
        if new_picture:
            self._find_empty_frame()
            # output geometry travels with the frame: after a
            # mid-stream SPS switch, frames pending in the DPB emit at
            # THEIR decode-time dimensions, not the active SPS's
            self.frames[self.cur_idx].out_geom = (
                sps.pic_width, sps.pic_height, tuple(sps.frame_crop))
            if not self.native:
                # python MB loop state only; the native session keeps
                # deblock records in its own C arrays (resetting 8160
                # python objects costs ~1 ms/pic at 1080p)
                for d in self.deblock:
                    d.idc = 0
                    d.str_vert = d.str_horiz = 0
                    d.str4_vert = d.str4_horiz = 0
            if self.native:
                self.native_session.begin_picture(self)
            elif self.plans is not None:
                from .plan import PlanRecorder

                self.rec = PlanRecorder(self)
        hdr.frame_num = r.get_bits(sps.log2_max_frame_num)
        if not sps.frame_mbs_only_flag:
            # the reference parses field_pic_flag/bottom_field_flag and
            # otherwise decodes the picture with frame machinery
            # (h264.cpp:1453-1466); is_field only selects the CABAC
            # significance-map context offsets
            hdr.field_pic_flag = r.get_onebit()
            hdr.bottom_field_flag = (r.get_onebit()
                                     if hdr.field_pic_flag else 0)
        else:
            hdr.field_pic_flag = 0
            hdr.bottom_field_flag = 0
        if (self.nal_id & 31) == SLICE_IDR_NAL:
            hdr.idr = 1
            hdr.idr_pic_id = r.ue()
        else:
            hdr.idr = 0
        self.dpb.set_max(sps)
        self.sps, self.pps = sps, pps
        self._set_mb_pos(first_mb)
        self._calc_poc(r, sps, pps)
        self.frames[self.cur_idx].cnt = hdr.poc
        if pps.redundant_pic_cnt_present_flag:
            r.ue()
        max_frame_num = 1 << sps.log2_max_frame_num
        if slice_type == B_SLICE:
            hdr.direct_spatial_mv_pred_flag = r.get_onebit()
        if slice_type in (P_SLICE, B_SLICE):
            if r.get_onebit():  # num_ref_idx_active_override
                n0 = r.ue()
                n1 = r.ue() if slice_type == B_SLICE else pps.num_ref_idx_l1_active_minus1
            else:
                n0 = pps.num_ref_idx_l0_active_minus1
                n1 = pps.num_ref_idx_l1_active_minus1
            hdr.num_ref_idx_active = (n0, n1)
            if slice_type == P_SLICE:
                ref_pic_init_p(self.refs[0], hdr.frame_num, max_frame_num,
                               sps.num_ref_frames)
            else:
                ref_pic_init_b(self.refs[0], self.refs[1], hdr.poc,
                               sps.num_ref_frames)
            ref_pic_list_reordering(r, self.refs[0], sps.num_ref_frames,
                                    hdr.frame_num, max_frame_num)
            if slice_type == B_SLICE:
                ref_pic_list_reordering(r, self.refs[1], sps.num_ref_frames,
                                        hdr.frame_num, max_frame_num)
                if not sps.direct_8x8_inference_flag:
                    raise NotImplementedError(
                        "direct_8x8_inference_flag=0 (reference parity: "
                        "BLOCK=4 temporal-zero path is UB, see bdirect.py)")
                if hdr.direct_spatial_mv_pred_flag == 0:
                    from .bdirect import create_map_col_to_list0
                    create_map_col_to_list0(self)
            self.weighted_mode = 0
            if slice_type == B_SLICE and pps.weighted_bipred_idc:
                if pps.weighted_bipred_idc == 1:
                    self._parse_pred_weight_table(r, slice_type)
                    self.weighted_mode = 1
                else:
                    self.weighted_mode = 2
            elif slice_type == P_SLICE and pps.weighted_pred_flag:
                self._parse_pred_weight_table(r, slice_type)
                self.weighted_mode = 1
        if self.nal_id & 0x60:
            self._dec_ref_pic_marking(r)
        else:
            hdr.mmco5 = 0
        if pps.entropy_coding_mode_flag and slice_type != I_SLICE:
            hdr.cabac_init_idc = r.ue()
        hdr.qp_delta = r.se()
        self._set_qp(pps.pic_init_qp + hdr.qp_delta)
        firstmb_deb = self.deblock[first_mb]
        if pps.deblocking_filter_control_present_flag:
            idc = r.ue()
            hdr.disable_deblocking_filter_idc = idc
            if idc != 1:
                hdr.alpha_c0_offset = r.se() * 2
                hdr.beta_offset = r.se() * 2
            else:
                hdr.alpha_c0_offset = hdr.beta_offset = 0
            firstmb_deb.slicehdr = (hdr.alpha_c0_offset, hdr.beta_offset)
        else:
            hdr.disable_deblocking_filter_idc = 0
            hdr.alpha_c0_offset = hdr.beta_offset = 0
            firstmb_deb.slicehdr = (0, 0)
        firstmb_deb.idc = hdr.disable_deblocking_filter_idc + 1
        return self._slice_data(r)

    def _parse_pred_weight_table(self, r, slice_type):
        """set_weighted_info type 1 + pred_weight_table
        (h264.cpp:1387-1399, :1668-1695)."""
        sy = r.ue()
        sc = r.ue()
        self.weight_shift = (sy, sc)
        tabs = [None, None]
        for lx in range(2):
            n = self.hdr.num_ref_idx_active[lx] + 1
            tab = []
            for _ in range(n):
                if r.get_onebit():
                    wl, ol = r.se(), r.se()
                else:
                    wl, ol = 1 << sy, 0
                if r.get_onebit():
                    wcb, ocb = r.se(), r.se()
                    wcr, ocr = r.se(), r.se()
                else:
                    wcb, ocb = 1 << sc, 0
                    wcr, ocr = 1 << sc, 0
                tab.append(((wl, ol), (wcb, ocb), (wcr, ocr)))
            tabs[lx] = tab
            if slice_type != B_SLICE:
                break
        self.weight_tab = tabs

    def _dec_ref_pic_marking(self, r):
        """dec_ref_pic_marking (h264.cpp:1697-1737)."""
        hdr = self.hdr
        t = r.get_onebit()
        op5 = 0
        mmcos = []
        if (self.nal_id & 31) == SLICE_IDR_NAL:
            hdr.long_term_reference_flag = r.get_onebit()
        else:
            hdr.adaptive_marking = t
            if t:
                for _ in range(16):
                    op = r.ue()
                    if op == 0:
                        break
                    if op == 5:
                        op5 = 1
                        mmcos.append((5, 0, 0))
                    else:
                        a1 = r.ue()
                        a2 = r.ue() if op == 3 else 0
                        mmcos.append((op, a1, a2))
        hdr.mmcos = tuple(mmcos)
        hdr.mmco5 = op5

    # ------------------------------------------------------- QP / qmats --
    def _set_qp(self, qpy):
        """set_qp (h264.cpp:1092-1119)."""
        if qpy < 0:
            qpy += 52
        elif qpy >= 52:
            qpy -= 52
        self.qp = qpy
        self.qmaty = X.qmat4(qpy)
        if self.pps.transform_8x8_mode_flag:
            self.qmaty8 = X.qmat8(qpy)
        self.qp_chroma = [0, 0]
        self.qmatc = [None, None]
        for i in range(2):
            qpc = X.qpc_from_qpy(qpy, self.pps.chroma_qp_index[i])
            self.qp_chroma[i] = qpc
            self.qmatc[i] = self.qmaty if qpc == qpy else X.qmat4(qpc)

    # ------------------------------------------------- MB position ctx ---
    def _set_mb_pos(self, mbpos):
        """set_mb_pos (h264.cpp:556-579)."""
        self.mb_y, self.mb_x = divmod(mbpos, self.max_x)
        self.firstline = self.max_x
        self.prev_qp_delta = 0
        self.mb_pos = mbpos
        # neighbor caches
        self.top_pred = [[2] * 4 for _ in range(self.max_x)]  # 0x22222222
        self.left_pred = [0] * 4
        self.top_pred[self.mb_x] = [0] * 4
        self.top_coef = getattr(self, "top_coef", None)
        if self.top_coef is None or len(self.top_coef) != self.max_x:
            self.top_coef = [[0] * 8 for _ in range(self.max_x)]
        self.left_coef = [0] * 8  # [luma0..3, cb0, cb1, cr0, cr1]
        self.mbtop = getattr(self, "mbtop", None)
        if self.mbtop is None or len(self.mbtop) != self.max_x + 2:
            self.mbtop = [PrevMb() for _ in range(self.max_x + 2)]
        self.mbleft = PrevMb()
        self.lefttop_ref = [0, 0]
        self.lefttop_mv = np.zeros((2, 2), np.int32)
        self.cbf = 0
        self.cbp = 0
        self.mb_type = 0
        self.chroma_pred_mode = 0

    def _avail(self):
        """get_availability (h264.cpp:9704-9715)."""
        mbx, fl = self.mb_x, self.firstline
        return (
            ((mbx != 0 and fl < 0) << 3)
            | ((mbx != self.max_x - 1 and fl <= 1) << 2)
            | ((fl <= 0) << 1)
            | (mbx != 0 and fl != self.max_x)
        )

    def _top(self):
        return self.mbtop[1 + self.mb_x]

    def _topright(self):
        return self.mbtop[2 + self.mb_x]

    def _increment_mb_pos(self):
        ret = self._increment_mb_pos_inner()
        if self.tc is not None:
            self.tc.mb_done(self, ret)
        return ret

    def _increment_mb_pos_inner(self):
        """increment_mb_pos (h264.cpp:591-635)."""
        t, l = self._top(), self.mbleft
        for n in (t, l):
            n.type = self.mb_type
            n.cbp = self.cbp
            n.chroma_pred_mode = self.chroma_pred_mode
        t.cbf = _cbf_top(self.cbf)
        l.cbf = _cbf_left(self.cbf)
        self.cbf = 0
        self.mb_pos += 1
        x = self.mb_x + 1
        if x >= self.max_x:
            x = 0
            self.mb_y += 1
            if self.mb_y >= self.max_y:
                self.mb_x = x
                return -1
        self.mb_x = x
        self.deblock[self.mb_pos].idc = 0
        if self.firstline >= 0:
            self.firstline -= 1
        return 0

    # -------------------------------------------------------- slice data --
    def _slice_data(self, r):
        """slice_data (h264.cpp:10210-10251)."""
        if self.native:
            # wavefront-parallel entropy decode (SURVEY §2.4): when the
            # NEXT NAL provably continues this picture (a slice with
            # first_mb > 0), this slice can decode on a worker thread —
            # its out_state is irrelevant (the next slice header resets
            # position state, and is_filled is knowably False). The
            # picture's last slice runs synchronously after a join.
            with trace.span("phase_a.slice"):
                queued = self.native_session.run_slice(
                    self, r, allow_async=self._next_nal_same_picture())
            if queued:
                return 0
            return self._post_process()
        if self.is_cabac:
            return self._slice_data_cabac(r)
        if self.tc is not None:
            self.tc.begin_slice(self)
        hdr = self.hdr
        while True:
            if hdr.slice_type != I_SLICE:
                skip_num = r.ue()
                if skip_num:
                    if self._skip_mbs(skip_num) < 0:
                        break
                if not r.more_rbsp_data():
                    break
            if self.tc is not None and hdr.slice_type != I_SLICE:
                self.tc.emit_skip_flag(self, 0)
            self._macroblock_layer(r)
            self.mbleft.mb_skip = 0
            self._top().mb_skip = 0
            if self._increment_mb_pos() < 0:
                break
            if not r.more_rbsp_data():
                break
        return self._post_process()

    def _slice_data_cabac(self, r):
        """slice_data CABAC arm (h264.cpp:10215-10250)."""
        hdr = self.hdr
        idc = 0 if hdr.slice_type == I_SLICE else hdr.cabac_init_idc + 1
        self.cb.init_context(self.qp, idc)
        r.byte_align()
        self.cb.init_engine(r)
        while True:
            if hdr.slice_type != I_SLICE:
                if AE.mb_skip(self, r, hdr.slice_type):
                    if self._skip_mbs(1) < 0:
                        break
                    if self.cb.terminate(r):
                        break
                    continue
            self._macroblock_layer_cabac(r)
            self.mbleft.mb_skip = 0
            self._top().mb_skip = 0
            if self._increment_mb_pos() < 0:
                break
            if self.cb.terminate(r):
                break
        return self._post_process()

    def _macroblock_layer_cabac(self, r):
        """macroblock_layer_cabac (h264.cpp:12036-12054)."""
        st = self.hdr.slice_type
        avail = self._avail()
        if st == P_SLICE:
            mbtype = AE.mb_type_P(self, r, avail) - 5
            if mbtype < 0:
                mbtype += MB_BDIRECT16x16
        elif st == B_SLICE:
            mbtype = AE.mb_type_B(self, r, avail) - 23
            if mbtype < 0:
                mbtype += 23 + MB_BDIRECT16x16
        else:
            mbtype = AE.mb_type_I(self, r, avail, 3, st)
        self.mb_type = mbtype
        self._mb_dispatch(r, mbtype, avail)
        if mbtype == MB_IPCM:
            self.cb.init_engine(r)

    # --------------------------------------------------------- mb layer --
    def _macroblock_layer(self, r):
        mbtype = r.ue()
        st = self.hdr.slice_type
        # adjust_mb_type (h264.cpp:9685-9702)
        if st == P_SLICE:
            mbtype -= 5
            if mbtype < 0:
                mbtype += MB_BDIRECT16x16
        elif st == B_SLICE:
            mbtype -= 23
            if mbtype < 0:
                mbtype += 23 + MB_BDIRECT16x16
        self.mb_type = mbtype
        avail = self._avail()
        if self.tc is not None:
            self.tc.emit_mb_type(self, mbtype, avail)
        self._mb_dispatch(r, mbtype, avail)

    def _mb_dispatch(self, r, mbtype, avail):
        if mbtype == MB_INxN:
            self._mb_intra4x4(r, avail)
        elif mbtype < MB_IPCM:
            self._mb_intra16x16(r, mbtype, avail)
        elif mbtype == MB_IPCM:
            self._mb_intrapcm(r)
        else:
            raise NotImplementedError(f"mb type {mbtype}")

    # ------------------------------------------------------------- IPCM --
    def _mb_intrapcm(self, r):
        """mb_intrapcm (h264.cpp:4736-4761)."""
        f = self.frames[self.cur_idx]
        x0, y0 = self.mb_x * 16, self.mb_y * 16
        r.byte_align()
        luma = np.array(
            [[r.get_bits(8) for _ in range(16)] for _ in range(16)], np.uint8
        )
        f.y[y0 : y0 + 16, x0 : x0 + 16] = luma
        cx, cy = x0 // 2, y0 // 2
        # bitstream order: all Cb samples then all Cr samples
        # (reference reads the NV12 plane in two strided passes,
        # h264.cpp:4743-4744 — same stream order)
        chroma = []
        for pl in (f.cb, f.cr):
            blk = np.array(
                [[r.get_bits(8) for _ in range(8)] for _ in range(8)], np.uint8
            )
            pl[cy : cy + 8, cx : cx + 8] = blk
            chroma.append(blk)
        if self.tc is not None:
            self.tc.emit_pcm(self, luma.tobytes() + chroma[0].tobytes()
                             + chroma[1].tobytes())
        if self.rec is not None:
            self.rec.set_kind(self.mb_pos, 4)
            self.rec.pcm(self.mb_pos, luma, chroma[0], chroma[1])
        self.left_coef[:] = [15] * 4 + [15] * 4
        self.top_coef[self.mb_x][:] = [15] * 4 + [15] * 4
        self.left_pred[:] = [2] * 4
        self.top_pred[self.mb_x][:] = [2] * 4
        deb = self.deblock[self.mb_pos]
        deb.qpy = 0
        deb.qpc = (self.qp_chroma[0] - self.qp, self.qp_chroma[1] - self.qp)
        deb.str4_vert = deb.str4_horiz = 1
        deb.str_vert = deb.str_horiz = 0xFF00FF
        self.prev_qp_delta = 0
        self.cbp = 0x3F
        self.cbf = 0x7FFFFFF
        self._intra_save_info()

    def _intra_save_info(self, transform8x8=0):
        """mb_intra_save_info (h264.cpp:3076-3096)."""
        t, l = self._top(), self.mbleft
        self.lefttop_ref[0] = int(t.ref[1][0])
        self.lefttop_ref[1] = int(t.ref[1][1])
        self.lefttop_mv[0] = t.mov[3][0]
        self.lefttop_mv[1] = t.mov[3][1]
        for n in (t, l):
            n.transform8x8 = transform8x8
            n.direct8x8 = 0
            n.mov[:] = 0
            n.mvd[:] = 0
            n.ref[:] = -1
            n.frmidx[:] = -1
        cc = self.curr_col
        cc["type"][self.mb_pos] = 0  # COL_MB16x16
        cc["ref"][self.mb_pos] = -1

    # ----------------------------------------------------- intra common --
    def _avail_intra(self, avail):
        if self.pps.constrained_intra_pred_flag:
            clear = 0
            if MB_IPCM < self._topright().type:
                clear |= 4
            if MB_IPCM < self._top().type:
                clear |= 2
            if MB_IPCM < self.mbleft.type:
                clear |= 1
            avail &= ~clear
        return avail

    def _store_strength_intra(self, str_all):
        deb = self.deblock[self.mb_pos]
        deb.qpy = self.qp
        deb.qpc = (self.qp_chroma[0], self.qp_chroma[1])
        deb.str4_vert = deb.str4_horiz = 1
        deb.str_vert = deb.str_horiz = str_all

    def _read_qp_delta(self, r):
        if self.is_cabac:
            return AE.qp_delta(self, r)
        delta = r.se()
        delta = max(-26, min(25, delta))
        if self.tc is not None:
            self.tc.emit_qp_delta(self, delta)  # ctx uses old prev
        self.prev_qp_delta = delta
        return delta

    def _read_cbp(self, r, avail, inter):
        if self.is_cabac:
            return AE.cbp(self, r, avail)
        v = T.ME_CBP[1 if inter else 0][_read_me(r)]
        if self.tc is not None:
            self.tc.emit_cbp(self, v, avail)
        return v

    def _read_transform8x8_flag(self, r, avail):
        """transform_size_8x8_flag (cavlc 1 bit / cabac ctx 399+)."""
        if self.is_cabac:
            return AE.transform8x8_flag(self, r, avail)
        v = r.get_onebit()
        if self.tc is not None:
            self.tc.emit_transform_flag(self, v, avail)
        return v

    def _mb_intraNxN(self, r, avail):
        """mb_intraNxN (h264.cpp:4173-4184)."""
        if self._read_transform8x8_flag(r, avail):
            self._mb_intra8x8(r, avail)
        else:
            self._mb_intra4x4(r, avail)

    def _pred_intra8x8_modes(self, r, avail_intra):
        """mb_pred_intra8x8 (h264.cpp:3302-3313): 4 modes with the same
        availability-gating quirk as 4x4; packs into the 4x4 pred slots."""
        left = self.left_pred
        top = self.top_pred[self.mb_x]
        a = avail_intra
        if self.is_cabac:
            def m(pa, pb):
                return AE.intra4x4_pred_mode(self, r, pa, pb)
        else:
            def m(pa, pb):
                p = min(pa, pb)
                if not r.get_onebit():
                    rem = r.get_bits(3)
                    p = rem if rem < p else rem + 1
                if self.tc is not None:
                    self.tc.emit_i4x4_mode(self, pa, pb, p)
                return p
        p0 = m(left[0] if a & 2 else 2, top[0] if a & 1 else 2)
        p1 = m(p0 if a & 2 else 2, top[2])
        p2 = m(left[2], p0 if a & 1 else 2)
        p3 = m(p2, p1)
        self.left_pred[:] = [p1, p1, p3, p3]
        self.top_pred[self.mb_x][:] = [p2, p2, p3, p3]
        return (p0, p1, p2, p3)

    def _mb_intra8x8(self, r, avail):
        """mb_intra8x8 (h264.cpp:4131-4171)."""
        avail_intra = self._avail_intra(avail)
        if not avail_intra & 1:
            self.left_pred[:] = [2] * 4
        if not avail_intra & 2:
            self.top_pred[self.mb_x][:] = [2] * 4
        pr = self._pred_intra8x8_modes(r, avail_intra)
        self._intra_chroma_pred(r, avail_intra)
        cbp = self._read_cbp(r, avail, 0)
        if cbp:
            qp_delta = self._read_qp_delta(r)
            if qp_delta:
                self._set_qp(self.qp + qp_delta)
        else:
            self.prev_qp_delta = 0
        f = self.frames[self.cur_idx]
        x0, y0 = self.mb_x * 16, self.mb_y * 16
        coeff = np.zeros(64, np.int64)
        lc, tcf = self.left_coef, self.top_coef[self.mb_x]
        # per-block avail (luma_intra8x8_with_residual, h264.cpp:4093-4121)
        blkav = (
            (avail_intra & ~4) | ((avail_intra & 2) * 2),
            (avail_intra & ~8) | ((avail_intra & 2) * 4) | 1,
            6 | ((avail_intra & 1) * 9),
            11,
        )
        if self.rec is not None:
            self.rec.set_kind(self.mb_pos, 2)
            self.rec.set_t8x8(self.mb_pos, 1)
        cs = [0, 0, 0, 0]
        for b, (oy, ox) in enumerate(((0, 0), (0, 8), (8, 0), (8, 8))):
            P8.INTRA8x8_PRED[pr[b]](f.y, y0 + oy, x0 + ox, blkav[b])
            if self.rec is not None:
                self.rec.intra8(y0 + oy, x0 + ox, pr[b], blkav[b])
            if cbp & (1 << b):
                if b == 0:
                    na = lc[0] if avail & 1 else -1
                    nb = tcf[0] if avail & 2 else -1
                elif b == 1:
                    na = cs[0]
                    nb = tcf[2] if avail & 2 else -1
                elif b == 2:
                    na = lc[2] if avail & 1 else -1
                    nb = cs[1]
                else:
                    na, nb = cs[2], cs[1]
                cs[b] = self._residual_block(r, na, nb, coeff, self.qmaty8,
                                             5, b * 4, avail_intra)
                if cs[b]:
                    X.idct8x8_add(f.y, y0 + oy, x0 + ox, coeff)
                    if self.rec is not None:
                        self.rec.idct8_luma(y0 + oy, x0 + ox, coeff)
        self.left_coef[:4] = [cs[1], cs[1], cs[3], cs[3]]
        self.top_coef[self.mb_x][:4] = [cs[2], cs[2], cs[3], cs[3]]
        self._store_strength_intra(0x00FF00FF)
        self._intra_save_info(transform8x8=1)
        self.cbp = cbp
        self._residual_chroma(r, cbp, avail)

    def _read_mvd_xy(self, r, mvd_a, mvd_b):
        if self.is_cabac:
            return AE.mvd_xy(self, r, mvd_a, mvd_b)
        dx, dy = r.se(), r.se()
        if self.tc is not None:
            self.tc.emit_mvd_xy(self, dx, dy, mvd_a, mvd_b)
        return dx, dy

    def _residual_block(self, r, na, nb, coeff, qmat, cat, pos4x4, avail):
        if self.is_cabac:
            return AE.residual_block(self, r, coeff, qmat, avail, pos4x4, cat)
        cnum = cavlc.residual_block(r, na, nb, coeff, qmat, cat)
        if self.tc is not None:
            self.tc.emit_residual(self, coeff, qmat, cat, pos4x4, avail, cnum)
        if cnum:  # maintain the cbf accumulator in CAVLC mode as well
            self.cbf |= (0xF if cat == 5 else 1) << pos4x4
        return cnum

    # CABAC ref_idx context increments (ref_idx16x16/16x8/8x16/8x8_cabac,
    # h264.cpp:11790-11876)
    def _ref_inc16x16(self, lx, avail):
        l, tp = self.mbleft, self._top()
        return (int(bool(avail & 1) and not (l.direct8x8 & 1)
                    and l.ref[0][lx] > 0)
                + int(bool(avail & 2) and not (tp.direct8x8 & 1)
                      and tp.ref[0][lx] > 0) * 2)

    def _read_ref16x16(self, r, lx, avail):
        t = self.hdr.num_ref_idx_active[lx]
        if not t:
            return 0
        if not self.is_cabac:
            v = _te(r, t)
            if self.tc is not None:
                self.tc.emit_ref(self, v, self._ref_inc16x16(lx, avail))
            return v
        return AE.ref_idx_sub(self, r, self._ref_inc16x16(lx, avail))

    def _read_ref16x8_p0(self, r, lx, avail):
        return self._read_ref16x16(r, lx, avail)

    def _ref_inc16x8_p1(self, lx, avail, ref_idx, vertical):
        l, tp = self.mbleft, self._top()
        if vertical:  # 8x16 right partition
            return (int(ref_idx[lx] > 0)
                    + int(bool(avail & 2) and not (tp.direct8x8 & 2)
                          and tp.ref[1][lx] > 0) * 2)
        return (int(bool(avail & 1) and not (l.direct8x8 & 2)
                    and l.ref[1][lx] > 0)
                + int(ref_idx[lx] > 0) * 2)

    def _read_ref16x8_p1(self, r, lx, avail, ref_idx, vertical):
        t = self.hdr.num_ref_idx_active[lx]
        if not t:
            return 0
        inc_f = lambda: self._ref_inc16x8_p1(lx, avail, ref_idx, vertical)
        if not self.is_cabac:
            v = _te(r, t)
            if self.tc is not None:
                self.tc.emit_ref(self, v, inc_f())
            return v
        return AE.ref_idx_sub(self, r, inc_f())

    def _ref_inc8x8(self, lx, avail, i, pblk, sub_dirs):
        l, tp = self.mbleft, self._top()

        def vb(b):
            return int(sub_dirs[b] >= 0 and pblk[b].ref[lx] > 0)

        if i == 0:
            return (int(bool(avail & 1) and not (l.direct8x8 & 1)
                        and l.ref[0][lx] > 0)
                    + int(bool(avail & 2) and not (tp.direct8x8 & 1)
                          and tp.ref[0][lx] > 0) * 2)
        if i == 1:
            return vb(0) + int(bool(avail & 2) and not (tp.direct8x8 & 2)
                               and tp.ref[1][lx] > 0) * 2
        if i == 2:
            return (int(bool(avail & 1) and not (l.direct8x8 & 2)
                        and l.ref[1][lx] > 0) + vb(0) * 2)
        return vb(2) + vb(1) * 2

    def _read_ref8x8(self, r, lx, avail, i, pblk, sub_dirs, t):
        if not t:
            return 0
        if not self.is_cabac:
            v = _te(r, t)
            if self.tc is not None:
                self.tc.emit_ref(
                    self, v, self._ref_inc8x8(lx, avail, i, pblk, sub_dirs))
            return v
        return AE.ref_idx_sub(
            self, r, self._ref_inc8x8(lx, avail, i, pblk, sub_dirs))

    def _intra_chroma_pred(self, r, avail_intra):
        if self.is_cabac:
            mode = AE.intra_chroma_pred_mode(self, r, avail_intra)
        else:
            mode = r.ue()
            mode = mode if mode <= 3 else 0
            self.chroma_pred_mode = mode
            if self.tc is not None:
                self.tc.emit_chroma_mode(self, mode, avail_intra)
        f = self.frames[self.cur_idx]
        cx, cy = self.mb_x * 8, self.mb_y * 8
        pred.INTRA_CHROMA_PRED[mode](f.cb, cy, cx, avail_intra)
        pred.INTRA_CHROMA_PRED[mode](f.cr, cy, cx, avail_intra)
        if self.rec is not None:
            self.rec.chroma_pred(self.mb_pos, mode, avail_intra)

    # -------------------------------------------------- residual chroma --
    def _residual_chroma(self, r, cbp, avail):
        """residual_chroma (h264.cpp:2373-2461)."""
        f = self.frames[self.cur_idx]
        cx, cy = self.mb_x * 8, self.mb_y * 8
        cbp_c = cbp >> 4
        if not cbp_c:
            self.left_coef[4:] = [0, 0, 0, 0]
            self.top_coef[self.mb_x][4:] = [0, 0, 0, 0]
            return
        coeff = np.zeros(64, np.int64)
        dc = [None, None]
        for i in range(2):
            if self._residual_block(r, 0, 0, coeff, self.qmatc[i], 3,
                                    16 + i, avail):
                dc[i] = X.chroma_dc_transform(coeff)
            else:
                dc[i] = [0, 0, 0, 0]
        planes = (f.cb, f.cr)
        if cbp_c & 2:
            left = list(self.left_coef[4:])
            top = list(self.top_coef[self.mb_x][4:])
            new_left = [0, 0, 0, 0]
            new_top = [0, 0, 0, 0]
            pos = [(0, 0), (0, 4), (4, 0), (4, 4)]
            for i in range(2):
                # per-component neighbor wiring (h264.cpp:2398-2444):
                # c0=(c0left,c0top) c1=(c0,c1top) c2=(c2left,c0) c3=(c2,c1)
                pl = planes[i]
                c0l = left[i * 2] if avail & 1 else -1
                c2l = left[i * 2 + 1] if avail & 1 else -1
                c0t = top[i * 2] if avail & 2 else -1
                c1t = top[i * 2 + 1] if avail & 2 else -1
                nc = [0] * 4
                wiring = [(c0l, c0t), (None, c1t), (c2l, None), (None, None)]
                for b in range(4):
                    na = wiring[b][0]
                    nb_ = wiring[b][1]
                    if b == 1:
                        na = nc[0]
                    elif b == 2:
                        nb_ = nc[0]
                    elif b == 3:
                        na, nb_ = nc[2], nc[1]
                    cnum = self._residual_block(
                        r, na, nb_, coeff, self.qmatc[i], 4,
                        18 + i * 4 + b, avail)
                    nc[b] = cnum
                    by, bx = pos[b]
                    if cnum:
                        coeff[0] = dc[i][b]
                        X.idct4x4_add(pl, cy + by, cx + bx, coeff[:16])
                        if self.rec is not None:
                            self.rec.idct4_chroma(i, cy + by, cx + bx,
                                                  coeff[:16])
                    else:
                        X.idct4x4_dconly_add(pl, cy + by, cx + bx, dc[i][b])
                        if self.rec is not None:
                            self.rec.idct4_chroma_dc(i, cy + by, cx + bx,
                                                     int(dc[i][b]))
                new_left[i * 2] = nc[1]
                new_left[i * 2 + 1] = nc[3]
                new_top[i * 2] = nc[2]
                new_top[i * 2 + 1] = nc[3]
            self.left_coef[4:] = new_left
            self.top_coef[self.mb_x][4:] = new_top
        else:
            for i in range(2):
                pl = planes[i]
                for b, (by, bx) in enumerate([(0, 0), (0, 4), (4, 0), (4, 4)]):
                    X.idct4x4_dconly_add(pl, cy + by, cx + bx, dc[i][b])
                    if self.rec is not None:
                        self.rec.idct4_chroma_dc(i, cy + by, cx + bx,
                                                 int(dc[i][b]))
            self.left_coef[4:] = [0, 0, 0, 0]
            self.top_coef[self.mb_x][4:] = [0, 0, 0, 0]

    # --------------------------------------------------- intra 16x16 -----
    def _mb_intra16x16(self, r, mbtype, avail):
        """mb_intra16x16_* (h264.cpp:4406-4557)."""
        k = mbtype - 1
        pred_mode = k & 3
        cbp = (0, 0x10, 0x20)[(k >> 2) % 3] | (0x0F if k >= 12 else 0)
        f = self.frames[self.cur_idx]
        x0, y0 = self.mb_x * 16, self.mb_y * 16
        avail_intra = self._avail_intra(avail)
        pred.INTRA16_PRED[pred_mode](f.y, y0, x0, avail_intra)
        if self.rec is not None:
            self.rec.set_kind(self.mb_pos, 3)
            self.rec.intra16(self.mb_pos, pred_mode, avail_intra)
        self._intra_chroma_pred(r, avail_intra)
        qp_delta = self._read_qp_delta(r)
        if qp_delta:
            self._set_qp(self.qp + qp_delta)
        na = self.left_coef[0] if avail & 1 else -1
        nb = self.top_coef[self.mb_x][0] if avail & 2 else -1
        coeff = np.zeros(64, np.int64)
        dc = np.zeros(16, np.int64)
        if self._residual_block(r, na, nb, coeff, self.qmaty, 0, 26,
                                avail_intra):
            dc = X.luma_dc_transform(coeff[:16])

        # spatial (by, bx) of coding-order block i (Z-order)
        def blkpos(i):
            by = ((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8
            bx = (i & 1) * 4 + ((i >> 2) & 1) * 8
            return by, bx

        if cbp & 0x0F:
            nc = [0] * 16
            # neighbor nC wiring mirrors mb_intra16x16_acdc (h264.cpp:4500-4542)
            lc, tc = self.left_coef, self.top_coef[self.mb_x]
            wiring = _LUMA_NC_WIRING
            new_left, new_top = [0] * 4, [0] * 4
            for i in range(16):
                na_s, nb_s = wiring[i]
                na = _nc_resolve(na_s, nc, lc, avail, True)
                nb = _nc_resolve(nb_s, nc, tc, avail, False)
                cnum = self._residual_block(r, na, nb, coeff, self.qmaty,
                                            1, i, avail_intra)
                nc[i] = cnum
                by, bx = blkpos(i)
                dci = (by >> 2) * 4 + (bx >> 2)
                if cnum:
                    coeff[0] = dc[dci]
                    X.idct4x4_add(f.y, y0 + by, x0 + bx, coeff[:16])
                    if self.rec is not None:
                        self.rec.idct4_luma(y0 + by, x0 + bx, coeff[:16])
                else:
                    X.idct4x4_dconly_add(f.y, y0 + by, x0 + bx, dc[dci])
                    if self.rec is not None:
                        self.rec.idct4_luma_dc(y0 + by, x0 + bx, int(dc[dci]))
            new_left = [nc[5], nc[7], nc[13], nc[15]]
            new_top = [nc[10], nc[11], nc[14], nc[15]]
            self.left_coef[:4] = new_left
            self.top_coef[self.mb_x][:4] = new_top
        else:
            for i in range(16):
                by, bx = blkpos(i)
                dci = (by >> 2) * 4 + (bx >> 2)
                X.idct4x4_dconly_add(f.y, y0 + by, x0 + bx, dc[dci])
                if self.rec is not None:
                    self.rec.idct4_luma_dc(y0 + by, x0 + bx, int(dc[dci]))
            self.left_coef[:4] = [0] * 4
            self.top_coef[self.mb_x][:4] = [0] * 4
        self.left_pred[:] = [2] * 4
        self.top_pred[self.mb_x][:] = [2] * 4
        self._store_strength_intra(0xFFFFFFFF)
        self._intra_save_info()
        self.cbp = cbp
        self._residual_chroma(r, cbp, avail)

    # ---------------------------------------------------- intra 4x4 ------
    def _mb_intra4x4(self, r, avail):
        """mb_intra4x4 (h264.cpp:3256-3299)."""
        avail_intra = self._avail_intra(avail)
        if not avail_intra & 1:
            self.left_pred[:] = [2] * 4
        if not avail_intra & 2:
            self.top_pred[self.mb_x][:] = [2] * 4
        pr = self._pred_intra4x4_modes(r, avail_intra)
        self._intra_chroma_pred(r, avail_intra)
        cbp = self._read_cbp(r, avail, 0)
        if cbp:
            qp_delta = self._read_qp_delta(r)
            if qp_delta:
                self._set_qp(self.qp + qp_delta)
        else:
            self.prev_qp_delta = 0
        f = self.frames[self.cur_idx]
        x0, y0 = self.mb_x * 16, self.mb_y * 16
        coeff = np.zeros(64, np.int64)
        # per-block avail flags mirror luma_intra4x4_with_residual
        # (h264.cpp:3120-3254)
        blk_avail = _intra4x4_block_avail(avail_intra)
        nc = [0] * 16
        lc, tc = self.left_coef, self.top_coef[self.mb_x]
        new_left, new_top = [0] * 4, [0] * 4
        if self.rec is not None:
            self.rec.set_kind(self.mb_pos, 1)
        for i in range(16):
            by = ((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8
            bx = (i & 1) * 4 + ((i >> 2) & 1) * 8
            pred.INTRA4x4_PRED[pr[i]](f.y, y0 + by, x0 + bx, blk_avail[i])
            if self.rec is not None:
                self.rec.intra4(y0 + by, x0 + bx, pr[i], blk_avail[i])
            if cbp & (1 << (i >> 2)):
                na_s, nb_s = _LUMA_NC_WIRING[i]
                na = _nc_resolve(na_s, nc, lc, avail, True)
                nb = _nc_resolve(nb_s, nc, tc, avail, False)
                cnum = self._residual_block(r, na, nb, coeff, self.qmaty,
                                            2, i, avail_intra)
                nc[i] = cnum
                if cnum:
                    X.idct4x4_add(f.y, y0 + by, x0 + bx, coeff[:16])
                    if self.rec is not None:
                        self.rec.idct4_luma(y0 + by, x0 + bx, coeff[:16])
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[self.mb_x][:4] = [nc[10], nc[11], nc[14], nc[15]]
        self._store_strength_intra(0xFFFFFFFF)
        self._intra_save_info()
        self.cbp = cbp
        self._residual_chroma(r, cbp, avail)

    def _pred_intra4x4_modes(self, r, avail_intra):
        """mb_pred_intra4x4 (h264.cpp:2999-3025), including the reference's
        availability-bit gating exactly as written."""
        left = self.left_pred
        top = self.top_pred[self.mb_x]
        a = avail_intra

        if self.is_cabac:
            def m(pa, pb):
                return AE.intra4x4_pred_mode(self, r, pa, pb)
        else:
            def m(pa, pb):
                p = min(pa, pb)
                if not r.get_onebit():
                    rem = r.get_bits(3)
                    p = rem if rem < p else rem + 1
                if self.tc is not None:
                    self.tc.emit_i4x4_mode(self, pa, pb, p)
                return p

        pr = [0] * 16
        pr[0] = m(left[0] if a & 2 else 2, top[0] if a & 1 else 2)
        pr[1] = m(pr[0] if a & 2 else 2, top[1])
        pr[2] = m(left[1], pr[0] if a & 1 else 2)
        pr[3] = m(pr[2], pr[1])
        pr[4] = m(pr[1] if a & 2 else 2, top[2])
        pr[5] = m(pr[4] if a & 2 else 2, top[3])
        pr[6] = m(pr[3], pr[4])
        pr[7] = m(pr[6], pr[5])
        pr[8] = m(left[2], pr[2] if a & 1 else 2)
        pr[9] = m(pr[8], pr[3])
        pr[10] = m(left[3], pr[8] if a & 1 else 2)
        pr[11] = m(pr[10], pr[9])
        pr[12] = m(pr[9], pr[6])
        pr[13] = m(pr[12], pr[7])
        pr[14] = m(pr[11], pr[12])
        pr[15] = m(pr[14], pr[13])
        self.left_pred[:] = [pr[5], pr[7], pr[13], pr[15]]
        self.top_pred[self.mb_x][:] = [pr[10], pr[11], pr[14], pr[15]]
        return pr

    # ------------------------------------------------------ skip (P/B) ---
    def _skip_mbs(self, skip_num):
        raise NotImplementedError("P/B slices")

    # ------------------------------------------------------ post process --
    def _post_process(self):
        """post_process (h264.cpp:11022-11050)."""
        is_filled = self.mb_y >= self.max_y
        if not is_filled:
            return 0
        from .deblock import deblock_picture

        hdr = self.hdr
        sps = self.sps
        if self.native:
            plan = self.native_session.finish_picture(self)
            self.plans.append(plan)
            if self.phase_b == "torch":
                from .reconstruct import reconstruct_plan_torch

                reconstruct_plan_torch(plan, self.frames, self.device)
        else:
            if self.rec is not None:
                self.rec.plan.poc = hdr.poc
                self.plans.append(self.rec.finalize())
                self.rec = None
            deblock_picture(self)
        max_frame_num = 1 << sps.log2_max_frame_num
        if self.nal_id & 0x60:
            for lx in range(2):
                self._post_marking(lx, max_frame_num)
            # record colocated map + swap col page to the L1 current pic
            self.curr_col["map_col_frameidx"][: sps.num_ref_frames] = [
                self.refs[0][i].frame_idx for i in range(sps.num_ref_frames)
            ]
            self.curr_col["map_col_frameidx"][sps.num_ref_frames :] = (
                self.refs[0][0].frame_idx
            )
            self._swap_col_page()
            self.dpb.insert(hdr.poc, self.cur_idx, hdr.idr | hdr.mmco5)
        else:
            self.dpb.insert_non_idr(hdr.poc, self.cur_idx)
        hdr.prev_frame_num = hdr.frame_num
        hdr.first_mb_in_slice = self.max_x * self.max_x
        return 1

    def _post_marking(self, lx, max_frame_num):
        """post_ref_pic_marking (h264.cpp:10837-10864)."""
        hdr = self.hdr
        refs = self.refs[lx]
        sps = self.sps
        if (self.nal_id & 31) == SLICE_IDR_NAL:
            refs[0].in_use = LONG_TERM if hdr.long_term_reference_flag else SHORT_TERM
            refs[0].frame_idx = self.cur_idx
            refs[0].num = hdr.frame_num
            refs[0].poc = hdr.poc
            for i in range(1, 16):
                refs[i].in_use = NOT_IN_USE
        else:
            if not hdr.idr and not hdr.mmco5:
                self._gap_mbs(refs, max_frame_num)
            if hdr.adaptive_marking:
                if marking_mmco(hdr.mmcos, refs, self.cur_idx, hdr.frame_num,
                                max_frame_num, sps.num_ref_frames, hdr.poc):
                    hdr.frame_num = 0
            else:
                marking_sliding_window(refs, self.cur_idx, hdr.frame_num,
                                       max_frame_num, sps.num_ref_frames,
                                       hdr.poc)

    def _gap_mbs(self, refs, max_frame_num):
        """gap_mbs (h264.cpp:10814-10835)."""
        hdr = self.hdr
        gap = hdr.frame_num - hdr.prev_frame_num
        while gap < 0:
            gap += max_frame_num
        gap -= 1
        if gap <= 0:
            return
        prev = hdr.prev_frame_num
        if gap > 16:
            gap = 16
            prev = hdr.frame_num - 17
        while gap:
            prev += 1
            if prev >= max_frame_num:
                prev -= max_frame_num
            marking_sliding_window(refs, self.cur_idx, prev, max_frame_num,
                                   self.sps.num_ref_frames, hdr.poc)
            gap -= 1

    def _swap_col_page(self):
        """std::swap(curr_col, l1-current .col) (h264.cpp:11041)."""
        poc = 0 if self.hdr.mmco5 else self.hdr.poc
        target = None
        for rf in self.refs[1]:
            if rf.in_use:
                if rf.poc == poc:
                    target = rf
                    break
                if target is None:
                    target = rf
        if target is None:
            target = self.refs[1][0]
        target.col, self.curr_col = self.curr_col, (
            target.col if target.col is not None
            else self._new_col_page(self.max_x * self.max_y)
        )

    # ---------------------------------------------------------- output ---
    #: pool-index sentinel for voided (zero-byte) frames: non-negative
    #: so drain loops continue, out of any plan/slot-map range
    _VOID_IDX = 1 << 20

    def peek_decoded_frame(self, bypass_dpb=False):
        frm = None
        if not bypass_dpb and not self.dpb.is_ready:
            idx = self.dpb.output
        else:
            idx = self.dpb.force_peek()
        if idx < 0:
            return 0, None
        if self._void_pending > 0:
            return 1, self._void_frame()
        return 1, self._frame_out(idx)

    def get_decoded_frame(self, bypass_dpb=False):
        idx, frm = self.pop_decoded_index(bypass_dpb)
        return (0, None) if idx < 0 else (1, frm)

    def pop_decoded_index(self, bypass_dpb=False):
        """get_decoded_frame, also exposing WHICH pool slot was output —
        the mapping the overlapped two-phase driver (runtime/turbo.py)
        needs to pair DPB output events with their Phase-B batches."""
        if not bypass_dpb and not self.dpb.is_ready:
            idx = self.dpb.output
            self.dpb.output = -1
        else:
            idx = self.dpb.force_pop()
        if idx < 0:
            return -1, None
        if self._void_pending > 0:
            self._void_pending -= 1
            return self._VOID_IDX, self._void_frame()
        return idx, self._frame_out(idx)

    def _void_frame(self):
        """Zero-byte output frame for DPB entries orphaned by a
        mid-stream pool reallocation (_sps_update): the reference's
        writer produces no bytes for them (empty-md5 golden lines)."""
        from m2dec_tpu_torch.codecs.mpeg2.decoder import DecodedFrame

        z = np.zeros((0, 0), np.uint8)
        return DecodedFrame(y=z, cb=z, cr=z, width=0, height=0,
                            crop=(0, 0, 0, 0), cnt=0)

    def _frame_out(self, idx):
        from m2dec_tpu_torch.codecs.mpeg2.decoder import DecodedFrame

        f = self.frames[idx]
        geom = getattr(f, "out_geom", None)
        if geom is None:
            sps = self.sps_store[
                self.pps_store[self.hdr.pps_id].seq_parameter_set_id
            ]
            geom = (sps.pic_width, sps.pic_height,
                    tuple(sps.frame_crop))
        w, h, crop = geom
        return DecodedFrame(
            y=f.y, cb=f.cb, cr=f.cr,
            width=w, height=h,
            crop=(crop[0], crop[1], crop[2], crop[3]),
            cnt=f.cnt,
        )

    # ---------------------------------------------- checkpoint/resume ---
    def stream_pos(self) -> int:
        """Byte offset of the first undecoded start code in the buffer
        last given to set_data (vtable stream_pos parity, m2d.h:69)."""
        if self.nal_i < len(self.nal_units):
            return self.nal_units[self.nal_i][2] - 3
        return len(self.data)

    def __getstate__(self):
        """Picture-boundary decode-state checkpoint (SURVEY §5.4 /
        runtime/checkpoint.py): everything persistent — header stores,
        DPB, frame pool, ref lists + colocated pages, POC counters —
        minus the input buffer and per-picture transients."""
        d = self.__dict__.copy()
        d["native_session"] = None  # per-picture scratch; rebuilt lazily
        d["rec"] = None
        d["tc"] = None
        d["data"] = b""
        d["nal_units"] = []
        d["nal_i"] = 0
        if d["plans"] is not None:
            d["plans"] = []  # already-consumed Phase-B plans
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        if self.native and self.inited:
            from .native_session import NativeH264Session

            self.native_session = NativeH264Session(
                self.max_x, self.max_y, plan_alloc=self.plan_alloc)

    def decode_all(self):
        """h264dec-style loop: decode + drain (m2decoder.h:132-157)."""
        frames = []
        while True:
            ready, frm = self.peek_decoded_frame()
            while ready:
                self.get_decoded_frame()
                frames.append(frm)
                ready, frm = self.peek_decoded_frame()
            err = self.decode_picture()
            if err < 0:
                ready, frm = self.peek_decoded_frame(True)
                while ready:
                    self.get_decoded_frame(True)
                    frames.append(frm)
                    ready, frm = self.peek_decoded_frame(True)
                return frames


# -- small helpers ------------------------------------------------------


def _read_me(r):
    # me_golomb (h264.cpp:88-92): out-of-range codeNum indexes entry 0
    v = r.ue()
    return v if v < 48 else 0


def _cbf_top(cbf):
    """cbf_top (h264.cpp:581-584)."""
    return ((cbf >> 16) & 0x700) | ((cbf >> 14) & 0xC0) | ((cbf >> 12) & 0x3C) | ((cbf >> 10) & 3)


def _cbf_left(cbf):
    """cbf_left (h264.cpp:586-589)."""
    return (
        ((cbf >> 16) & 0x600) | ((cbf >> 15) & 0x100) | ((cbf >> 14) & 0x80)
        | ((cbf >> 13) & 0x40) | ((cbf >> 12) & 0x38) | ((cbf >> 11) & 4)
        | ((cbf >> 6) & 2) | ((cbf >> 5) & 1)
    )


# nC neighbor wiring for the 16 luma blocks in coding (Z) order:
# entries are ('L', k) left-cache nibble, ('T', k) top-cache nibble, or
# ('B', i) previously-decoded block i of this MB
# (mirrors h264.cpp:3131-3228 / :4500-4541).
_LUMA_NC_WIRING = [
    (("L", 0), ("T", 0)),
    (("B", 0), ("T", 1)),
    (("L", 1), ("B", 0)),
    (("B", 2), ("B", 1)),
    (("B", 1), ("T", 2)),
    (("B", 4), ("T", 3)),
    (("B", 3), ("B", 4)),
    (("B", 6), ("B", 5)),
    (("L", 2), ("B", 2)),
    (("B", 8), ("B", 3)),
    (("L", 3), ("B", 8)),
    (("B", 10), ("B", 9)),
    (("B", 9), ("B", 6)),
    (("B", 12), ("B", 7)),
    (("B", 11), ("B", 12)),
    (("B", 14), ("B", 13)),
]


def _nc_resolve(spec, nc, cache, avail, is_left):
    kind, k = spec
    if kind == "B":
        return nc[k]
    if is_left:
        return cache[k] if avail & 1 else -1
    return cache[k] if avail & 2 else -1


def _intra4x4_block_avail(ai):
    """Per-4x4-block availability flags, mirroring the hardcoded values in
    luma_intra4x4_with_residual (h264.cpp:3131-3226)."""
    return [
        ai | (4 if ai & 2 else 0),
        ai | (5 if ai & 2 else 1),
        ai | 6,
        3,
        ai | (5 if ai & 2 else 1),
        ai | 1,
        7,
        3,
        ai | 6,
        7,
        ai | 6,
        3,
        7,
        3,
        7,
        3,
    ]


# ======================================================================
# P-slice extension (CAVLC): parse + reconstruction
# (reference: mb_inter16x16/16x8/8x16/8x8 h264.cpp:7336-9164,
#  skip_mbs :10128-10183, p_skip_mb :9736-9766)
# ======================================================================
from . import inter as I  # noqa: E402


def _te(r, rng):
    """te(v) (h264.cpp:94-102)."""
    if rng == 1:
        return r.get_onebit() ^ 1
    v = r.ue()
    return v if v <= rng else rng


def _transposition(a):
    """h264.cpp:6408-6418: transpose 4x4 grid of 2-bit fields."""
    b = 0
    for y in range(0, 8, 2):
        for x in range(0, 32, 8):
            b |= (a & 3) << (x + y)
            a >>= 2
    return b


_EXPAND_STR8x8 = (
    0x00000000, 0x000A000A, 0x00A000A0, 0x00AA00AA,
    0x000A0000, 0x000A000A, 0x00AA00A0, 0x00AA00AA,
    0x00A00000, 0x00AA000A, 0x00A000A0, 0x00AA00AA,
    0x00AA0000, 0x00AA000A, 0x00AA00A0, 0x00AA00AA,
)

_CBP_TRANS8x8 = (0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15)

_STR_MAP_BIT = [
    0x2, 0x8, 0x200, 0x800, 0x20, 0x80, 0x2000, 0x8000,
    0x20000, 0x80000, 0x2000000, 0x8000000, 0x200000, 0x800000,
    0x20000000, 0x80000000,
]


def _zblkpos(i):
    by = ((i >> 1) & 1) * 4 + ((i >> 3) & 1) * 8
    bx = (i & 1) * 4 + ((i >> 2) & 1) * 8
    return by, bx


class _PSliceMixin:
    def _no_residual_inter(self):
        """no_residual_inter (h264.cpp:7324-7333)."""
        self.prev_qp_delta = 0
        self.left_coef[:] = [0] * 8
        self.top_coef[self.mb_x][:] = [0] * 8
        self.mbleft.transform8x8 = 0
        self._top().transform8x8 = 0
        deb = self.deblock[self.mb_pos]
        deb.str_horiz = 0
        deb.str_vert = 0

    def _residual_luma_inter4x4(self, r, cbp):
        """residual_luma_inter4x4 (h264.cpp:6420-6544)."""
        f = self.frames[self.cur_idx]
        x0, y0 = self.mb_x * 16, self.mb_y * 16
        coeff = np.zeros(64, np.int64)
        avail = self._avail_saved
        nc = [0] * 16
        lc, tc = self.left_coef, self.top_coef[self.mb_x]
        str_map = 0
        for i in range(16):
            if not cbp & (1 << (i >> 2)):
                continue
            na_s, nb_s = _LUMA_NC_WIRING[i]
            na = _nc_resolve(na_s, nc, lc, avail, True)
            nb = _nc_resolve(nb_s, nc, tc, avail, False)
            cnum = self._residual_block(r, na, nb, coeff, self.qmaty,
                                        2, i, avail)
            nc[i] = cnum
            if cnum:
                by, bx = _zblkpos(i)
                X.idct4x4_add(f.y, y0 + by, x0 + bx, coeff[:16])
                if self.rec is not None:
                    self.rec.idct4_luma(y0 + by, x0 + bx, coeff[:16])
                str_map |= _STR_MAP_BIT[i]
        self.left_coef[:4] = [nc[5], nc[7], nc[13], nc[15]]
        self.top_coef[self.mb_x][:4] = [nc[10], nc[11], nc[14], nc[15]]
        str_h = _transposition(str_map)
        deb = self.deblock[self.mb_pos]
        deb.str_vert = ((str_map << 8) | str_map) & 0xFFFFFFFF
        deb.str_horiz = ((str_h << 8) | str_h) & 0xFFFFFFFF

    def _residual_luma_inter(self, r, cbp):
        """residual_luma_inter / residual_luma_interNxN
        (h264.cpp:6546-6558 / :6632-6650). `cbp` carries the
        NeedTransform8x8 bit at 0x80."""
        if self.pps.transform_8x8_mode_flag and self.is_cabac:
            # residual_luma_interNxN is wired into the CABAC table only;
            # the reference's CAVLC mb_decode[1] passes the plain
            # residual_luma_inter (4x4 always, flag never read)
            # (h264.cpp:9558-9586 vs :11965-12010)
            t8 = ((cbp & 0x8F) > 0x80
                  and self._read_transform8x8_flag(r, self._avail_saved))
            qp_delta = self._read_qp_delta(r)
            if qp_delta:
                self._set_qp(self.qp + qp_delta)
            self.mbleft.transform8x8 = 1 if t8 else 0
            self._top().transform8x8 = 1 if t8 else 0
            if t8:
                if self.rec is not None:
                    self.rec.set_t8x8(self.mb_pos, 1)
                self._residual_luma_inter8x8(r, cbp)
            else:
                self._residual_luma_inter4x4(r, cbp)
            return
        if (self.tc is not None and self.pps.transform_8x8_mode_flag
                and (cbp & 0x8F) > 0x80):
            # transcode: the CABAC decoder will read a flag here; CAVLC
            # never coded one, so it is always 0. Mirror the CABAC-side
            # neighbor update (residual_luma_interNxN) so later flag
            # contexts match the re-decode.
            self.tc.emit_transform_flag(self, 0, self._avail_saved)
            self.mbleft.transform8x8 = 0
            self._top().transform8x8 = 0
        qp_delta = self._read_qp_delta(r)
        if qp_delta:
            self._set_qp(self.qp + qp_delta)
        self._residual_luma_inter4x4(r, cbp)

    def _residual_luma_inter8x8(self, r, cbp):
        """residual_luma_inter8x8 (h264.cpp:6582-6630)."""
        f = self.frames[self.cur_idx]
        x0, y0 = self.mb_x * 16, self.mb_y * 16
        coeff = np.zeros(64, np.int64)
        avail = self._avail_saved
        lc, tcf = self.left_coef, self.top_coef[self.mb_x]
        cbp &= 15
        cs = [0, 0, 0, 0]
        for b, (oy, ox) in enumerate(((0, 0), (0, 8), (8, 0), (8, 8))):
            if not cbp & (1 << b):
                continue
            if b == 0:
                na = lc[0] if avail & 1 else -1
                nb = tcf[0] if avail & 2 else -1
            elif b == 1:
                na = cs[0]
                nb = tcf[2] if avail & 2 else -1
            elif b == 2:
                na = lc[2] if avail & 1 else -1
                nb = cs[1]
            else:
                na, nb = cs[2], cs[1]
            cs[b] = self._residual_block(r, na, nb, coeff, self.qmaty8,
                                         5, b * 4, avail)
            if cs[b]:
                X.idct8x8_add(f.y, y0 + oy, x0 + ox, coeff)
                if self.rec is not None:
                    self.rec.idct8_luma(y0 + oy, x0 + ox, coeff)
        self.left_coef[:4] = [cs[1], cs[1], cs[3], cs[3]]
        self.top_coef[self.mb_x][:4] = [cs[2], cs[2], cs[3], cs[3]]
        deb = self.deblock[self.mb_pos]
        deb.str_vert = _EXPAND_STR8x8[cbp]
        deb.str_horiz = _EXPAND_STR8x8[_CBP_TRANS8x8[cbp]]

    # -- P macroblocks ----------------------------------------------------
    def _mb_inter16x16(self, r, avail, refmap=1):
        self._avail_saved = avail
        n_active = self.hdr.num_ref_idx_active
        ref_idx = [-1, -1]
        for lx in range(2):
            if refmap & (1 << lx):
                ref_idx[lx] = self._read_ref16x16(r, lx, avail)
        mvs = np.zeros((2, 2), np.int32)
        mvds = np.zeros((2, 2), np.int32)
        for lx in range(2):
            if refmap & (1 << lx):
                (pmx, pmy), mvd_a, mvd_b = I.calc_mv16x16(self, lx, ref_idx[lx], avail)
                dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
                mvds[lx] = (dx, dy)
                mvs[lx] = (pmx + dx, pmy + dy)
        I.inter_pred_basic(self, ref_idx, mvs, 16, 16, 0, 0)
        left4x4 = list(self.left_coef[:4])
        top4x4 = list(self.top_coef[self.mb_x][:4])
        self.cbp = cbp = self._read_cbp(r, avail, 1)
        if cbp:
            self._residual_luma_inter(r, 0x80 | cbp)
        else:
            self._no_residual_inter()
        I.store_info_inter16x16(self, mvs, mvds, ref_idx, left4x4, top4x4)
        self._residual_chroma(r, cbp, avail)

    def _mb_inter16x8(self, r, avail, vertical):
        """16x8 (vertical=False) / 8x16 (vertical=True) with refmap from
        the mb_decode table (always 3 in P)."""
        self._avail_saved = avail
        n_active = self.hdr.num_ref_idx_active
        refmap = 3
        ref_idx = [-1, -1, -1, -1]
        for lx in range(2):
            m = refmap >> (lx * 2)
            ref_idx[lx] = (self._read_ref16x8_p0(r, lx, avail)
                           if m & 1 else -1)
            ref_idx[lx + 2] = (self._read_ref16x8_p1(r, lx, avail, ref_idx,
                                                     vertical)
                               if m & 2 else -1)
        mv_sets = np.zeros((2, 2, 2), np.int32)
        mvd_sets = np.zeros((2, 2, 2), np.int32)
        for lx in range(2):
            m = refmap >> (lx * 2)
            if m & 1:
                if vertical:
                    (px, py), mvd_a, mvd_b = I.calc_mv8x16left(self, lx, ref_idx[lx], avail)
                else:
                    (px, py), mvd_a, mvd_b = I.calc_mv16x8top(self, lx, ref_idx[lx], avail)
                dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
                mvd_sets[0][lx] = (dx, dy)
                mv_sets[0][lx] = (px + dx, py + dy)
            if m & 2:
                if vertical:
                    (px, py), mvd_a, mvd_b = I.calc_mv8x16right(
                        self, lx, ref_idx[lx + 2], avail, ref_idx[lx],
                        mv_sets[0], mvd_sets[0])
                else:
                    (px, py), mvd_a, mvd_b = I.calc_mv16x8bottom(
                        self, lx, ref_idx[lx + 2], avail, ref_idx[lx],
                        mv_sets[0], mvd_sets[0])
                dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
                mvd_sets[1][lx] = (dx, dy)
                mv_sets[1][lx] = (px + dx, py + dy)
        if vertical:
            I.inter_pred_basic(self, ref_idx[:2], mv_sets[0], 8, 16, 0, 0)
            I.inter_pred_basic(self, ref_idx[2:], mv_sets[1], 8, 16, 8, 0)
        else:
            I.inter_pred_basic(self, ref_idx[:2], mv_sets[0], 16, 8, 0, 0)
            I.inter_pred_basic(self, ref_idx[2:], mv_sets[1], 16, 8, 0, 8)
        left4x4 = list(self.left_coef[:4])
        top4x4 = list(self.top_coef[self.mb_x][:4])
        self.cbp = cbp = self._read_cbp(r, avail, 1)
        if cbp:
            self._residual_luma_inter(r, 0x80 | cbp)
        else:
            self._no_residual_inter()
        if vertical:
            I.store_info_inter8x16(self, mv_sets, mvd_sets, ref_idx, left4x4, top4x4)
        else:
            I.store_info_inter16x8(self, mv_sets, mvd_sets, ref_idx, left4x4, top4x4)
        self._residual_chroma(r, cbp, avail)

    # sub_mb: sizes per type (P: 0=8x8, 1=8x4, 2=4x8, 3=4x4)
    def _mb_inter8x8p(self, r, avail, ref0=False):
        self._avail_saved = avail
        pblk = [I.Prev8x8() for _ in range(4)]
        if self.is_cabac:
            sub_mb_type = AE.sub_mb_types_p(self, r)
        else:
            sub_mb_type = [r.ue() for _ in range(4)]
            if max(sub_mb_type) > 3:
                raise ValueError("bad P sub_mb_type")
            if self.tc is not None:
                self.tc.emit_sub_types_p(self, sub_mb_type)
        n_active = self.hdr.num_ref_idx_active
        # ref idx (lx 0 only for P; all P sub types are L0, sub_dir=1)
        t = 0 if ref0 else n_active[0]
        for i in range(4):
            pblk[i].ref[0] = self._read_ref8x8(r, 0, avail, i, pblk,
                                               (1, 1, 1, 1), t)
        for i in range(4):
            self._sub_mb_mv(r, avail, i, pblk, 0, sub_mb_type[i])
        for i in range(4):
            self._sub_mb_dec(i, pblk, sub_mb_type[i])
        left4x4 = list(self.left_coef[:4])
        top4x4 = list(self.top_coef[self.mb_x][:4])
        self.cbp = cbp = self._read_cbp(r, avail, 1)
        need8 = all(t == 0 for t in sub_mb_type)  # need_transform_size_8x8p
        if cbp:
            self._residual_luma_inter(r, (0x80 if need8 else 0) | cbp)
        else:
            self._no_residual_inter()
        I.store_info_intermb8x8(self, pblk, left4x4, top4x4)
        self.mbleft.direct8x8 = 0
        self._top().direct8x8 = 0
        self._residual_chroma(r, cbp, avail)

    def _sub_mb_mv(self, r, avail, blk_idx, pblk, lx, sub_type):
        """sub_mb8x8/8x4/4x8/4x4_mv (h264.cpp:8558-8652)."""
        p = pblk[blk_idx]
        if p.ref[lx] < 0:
            return
        idx = int(p.ref[lx])
        if sub_type == 0:
            (px, py), mvd_a, mvd_b = I.calc_mv8x8(self, 0, lx, idx, avail, blk_idx, pblk, 0)
            dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
            for k in range(4):
                p.mv[k][lx] = (px + dx, py + dy)
                p.mvd[k][lx] = (dx, dy)
        elif sub_type == 1:  # 8x4
            for y in range(2):
                (px, py), mvd_a, mvd_b = I.calc_mv8x8(self, 1, lx, idx, avail, blk_idx, pblk, y)
                dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
                p.mv[y * 2][lx] = (px + dx, py + dy)
                p.mvd[y * 2][lx] = (dx, dy)
                p.mv[y * 2 + 1][lx] = (px + dx, py + dy)
                p.mvd[y * 2 + 1][lx] = (dx, dy)
        elif sub_type == 2:  # 4x8
            for x in range(2):
                (px, py), mvd_a, mvd_b = I.calc_mv8x8(self, 2, lx, idx, avail, blk_idx, pblk, x)
                dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
                p.mv[x][lx] = (px + dx, py + dy)
                p.mvd[x][lx] = (dx, dy)
                p.mv[x + 2][lx] = (px + dx, py + dy)
                p.mvd[x + 2][lx] = (dx, dy)
        else:  # 4x4
            for xy in range(4):
                (px, py), mvd_a, mvd_b = I.calc_mv8x8(self, 3, lx, idx, avail, blk_idx, pblk, xy)
                dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
                p.mv[xy][lx] = (px + dx, py + dy)
                p.mvd[xy][lx] = (dx, dy)

    def _sub_mb_dec(self, blk_idx, pblk, sub_type):
        """sub_mb{8x8,8x4,4x8,4x4}_dec (h264.cpp:8722-8755)."""
        p = pblk[blk_idx]
        ox = (blk_idx & 1) * 8
        oy = (blk_idx & 2) * 4
        if sub_type == 0:
            I.inter_pred_basic(self, p.ref, p.mv[0], 8, 8, ox, oy)
        elif sub_type == 1:
            for y in range(2):
                I.inter_pred_basic(self, p.ref, p.mv[y * 2], 8, 4, ox, oy + y * 4)
        elif sub_type == 2:
            for x in range(2):
                I.inter_pred_basic(self, p.ref, p.mv[x], 4, 8, ox + x * 4, oy)
        else:
            for xy in range(4):
                I.inter_pred_basic(self, p.ref, p.mv[xy], 4, 4,
                                   ox + (xy & 1) * 4, oy + (xy & 2) * 2)

    # -- P skip -----------------------------------------------------------
    def _p_skip_mb(self):
        """p_skip_mb (h264.cpp:9736-9766)."""
        avail = self._avail()
        mv = np.zeros((2, 2), np.int32)
        if (avail & 3) == 3:
            left, top = self.mbleft, self._top()
            l_zero = left.ref[0][0] == 0 and not left.mov[0][0].any()
            t_zero = top.ref[0][0] == 0 and not top.mov[0][0].any()
            if not l_zero and not t_zero:
                (px, py), mvd_a, mvd_b = I.calc_mv16x16(self, 0, 0, avail)
                mv[0] = (px, py)
        ref_idx = [0, -1]
        I.inter_pred_basic(self, ref_idx, mv, 16, 16, 0, 0)
        return mv, ref_idx

    def _skip_mbs(self, skip_num):
        """skip_mbs (h264.cpp:10128-10183), P path."""
        max_run = self.max_x * self.max_y - self.mb_pos
        skip_num = min(skip_num, max_run)
        self.left_pred[:] = [2] * 4
        left4x4 = list(self.left_coef[:4])
        self.left_coef[:4] = [0] * 4
        self.cbp = 0
        self.cbf = 0
        mvds = np.zeros((2, 2), np.int32)
        while skip_num:
            mvs, ref_idx = self._p_skip_mb()
            self.top_pred[self.mb_x][:] = [2] * 4
            top4x4 = list(self.top_coef[self.mb_x][:4])
            self.top_coef[self.mb_x][:4] = [0] * 4
            self._no_residual_inter()
            I.store_info_inter16x16(self, mvs, mvds, ref_idx, left4x4, top4x4)
            left4x4 = [0] * 4
            self.prev_qp_delta = 0
            self.mb_type = MB_PSKIP
            for n in (self.mbleft, self._top()):
                n.type = MB_PSKIP
                n.mb_skip = 1
                n.direct8x8 = 3
            if self._increment_mb_pos() < 0:
                return -1
            skip_num -= 1
        return 0


# mix the P-slice methods into the decoder class
for _name in dir(_PSliceMixin):
    if not _name.startswith("__"):
        setattr(H264Decoder, _name, getattr(_PSliceMixin, _name))


def _mb_dispatch_full(self, r, mbtype, avail):
    if mbtype == MB_INxN:
        if self.pps.transform_8x8_mode_flag:
            self._mb_intraNxN(r, avail)
        else:
            self._mb_intra4x4(r, avail)
    elif mbtype < MB_IPCM:
        self._mb_intra16x16(r, mbtype, avail)
    elif mbtype == MB_IPCM:
        self._mb_intrapcm(r)
    elif mbtype == MB_P16x16:
        self._mb_inter16x16(r, avail)
    elif mbtype == MB_P16x8:
        self._mb_inter16x8(r, avail, vertical=False)
    elif mbtype == MB_P8x16:
        self._mb_inter16x8(r, avail, vertical=True)
    elif mbtype == MB_P8x8:
        self._mb_inter8x8p(r, avail)
    elif mbtype == MB_P8x8REF0:
        self._mb_inter8x8p(r, avail, ref0=True)
    else:
        raise NotImplementedError(f"mb type {mbtype}")


H264Decoder._mb_dispatch = _mb_dispatch_full


# ======================================================================
# B-slice extension stage 1: explicit L0/L1/Bi partitions + B8x8
# (reference mb_decode rows 31-53, h264.cpp:9622-9633)
# ======================================================================

# adjusted mb_type -> (kind, refmap); kind: 0=direct, 1=16x16, 2=16x8,
# 3=8x16, 4=8x8
_B_MB_TABLE = {31: (0, 0)}
_B_MB_TABLE[32] = (1, 1)
_B_MB_TABLE[33] = (1, 2)
_B_MB_TABLE[34] = (1, 3)
for _i, _cbp in enumerate((0x3, 0xC, 0x9, 0x6, 0xB, 0xE, 0x7, 0xD, 0xF)):
    _B_MB_TABLE[35 + _i * 2] = (2, _cbp)
    _B_MB_TABLE[36 + _i * 2] = (3, _cbp)
_B_MB_TABLE[53] = (4, 0)

#: sub_mb_type -> (shape, dir_mask); shape 0=8x8,1=8x4,2=4x8,3=4x4;
#: dir -1 = direct (Table 7-18 / reference sub_mb_b tables)
_B_SUB_TABLE = (
    (0, -1), (0, 1), (0, 2), (0, 3), (1, 1), (2, 1), (1, 2), (2, 2),
    (1, 3), (2, 3), (3, 1), (3, 2), (3, 3),
)


def _mb_dispatch_b(self, r, mbtype, avail):
    if mbtype <= MB_IPCM or self.hdr.slice_type != B_SLICE:
        return _mb_dispatch_full(self, r, mbtype, avail)
    kind, refmap = _B_MB_TABLE[mbtype]
    if kind == 0:
        self._mb_bdirect16x16(r, avail)
    elif kind == 1:
        self._mb_inter16x16(r, avail, refmap=refmap)
    elif kind == 2:
        self._mb_inter16x8_b(r, avail, refmap, vertical=False)
    elif kind == 3:
        self._mb_inter16x8_b(r, avail, refmap, vertical=True)
    else:
        self._mb_inter8x8b(r, avail)


H264Decoder._mb_dispatch = _mb_dispatch_b


def _mb_inter16x8_b(self, r, avail, refmap, vertical):
    """B 16x8/8x16 with per-partition list maps (mb_inter16x8,
    h264.cpp:7606-7655 with mbc->cbp=refmap)."""
    self._avail_saved = avail
    n_active = self.hdr.num_ref_idx_active
    ref_idx = [-1, -1, -1, -1]
    for lx in range(2):
        m = refmap >> (lx * 2)
        if m & 1:
            ref_idx[lx] = self._read_ref16x8_p0(r, lx, avail)
        if m & 2:
            ref_idx[lx + 2] = self._read_ref16x8_p1(r, lx, avail, ref_idx,
                                                    vertical)
    mv_sets = np.zeros((2, 2, 2), np.int32)
    mvd_sets = np.zeros((2, 2, 2), np.int32)
    for lx in range(2):
        m = refmap >> (lx * 2)
        if m & 1:
            if vertical:
                (px, py), mvd_a, mvd_b = I.calc_mv8x16left(self, lx, ref_idx[lx], avail)
            else:
                (px, py), mvd_a, mvd_b = I.calc_mv16x8top(self, lx, ref_idx[lx], avail)
            dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
            mvd_sets[0][lx] = (dx, dy)
            mv_sets[0][lx] = (px + dx, py + dy)
        if m & 2:
            if vertical:
                (px, py), mvd_a, mvd_b = I.calc_mv8x16right(
                    self, lx, ref_idx[lx + 2], avail, ref_idx[lx],
                    mv_sets[0], mvd_sets[0])
            else:
                (px, py), mvd_a, mvd_b = I.calc_mv16x8bottom(
                    self, lx, ref_idx[lx + 2], avail, ref_idx[lx],
                    mv_sets[0], mvd_sets[0])
            dx, dy = self._read_mvd_xy(r, mvd_a, mvd_b)
            mvd_sets[1][lx] = (dx, dy)
            mv_sets[1][lx] = (px + dx, py + dy)
    if vertical:
        I.inter_pred_basic(self, ref_idx[:2], mv_sets[0], 8, 16, 0, 0)
        I.inter_pred_basic(self, ref_idx[2:], mv_sets[1], 8, 16, 8, 0)
    else:
        I.inter_pred_basic(self, ref_idx[:2], mv_sets[0], 16, 8, 0, 0)
        I.inter_pred_basic(self, ref_idx[2:], mv_sets[1], 16, 8, 0, 8)
    left4x4 = list(self.left_coef[:4])
    top4x4 = list(self.top_coef[self.mb_x][:4])
    self.cbp = cbp = self._read_cbp(r, avail, 1)
    if cbp:
        self._residual_luma_inter(r, 0x80 | cbp)
    else:
        self._no_residual_inter()
    if vertical:
        I.store_info_inter8x16(self, mv_sets, mvd_sets, ref_idx, left4x4, top4x4)
    else:
        I.store_info_inter16x8(self, mv_sets, mvd_sets, ref_idx, left4x4, top4x4)
    self._residual_chroma(r, cbp, avail)


def _mb_inter8x8b(self, r, avail):
    """mb_inter8x8 B variant (h264.cpp:9118-9164)."""
    self._avail_saved = avail
    pblk = [I.Prev8x8() for _ in range(4)]
    sub_mb_type = []
    type0_cnt = 0
    ref_blk = {}  # once-computed spatial direct ref/mv (reference ref_blk)
    for i in range(4):
        if self.is_cabac:
            t = AE.sub_mb_type_b_one(self, r)
        else:
            t = r.ue()
            if t > 12:
                raise ValueError("bad B sub_mb_type")
            if self.tc is not None:
                self.tc.emit_sub_type_b(self, t)
        sub_mb_type.append(t)
        if t == 0:
            self._pred_direct8x8(r, avail, i, pblk, ref_blk, type0_cnt)
            type0_cnt += 1
    n_active = self.hdr.num_ref_idx_active
    sub_dirs = [_B_SUB_TABLE[t][1] for t in sub_mb_type]
    for lx in range(2):
        t = n_active[lx]
        dirbit = 1 << lx
        for i in range(4):
            dmask = sub_dirs[i]
            if dmask >= 0:
                pblk[i].ref[lx] = (
                    self._read_ref8x8(r, lx, avail, i, pblk, sub_dirs, t)
                    if dirbit & dmask else -1)
    for lx in range(2):
        for i in range(4):
            if sub_mb_type[i] != 0:
                shape = _B_SUB_TABLE[sub_mb_type[i]][0]
                self._sub_mb_mv(r, avail, i, pblk, lx, shape)
    for i in range(4):
        if sub_mb_type[i] != 0:
            shape = _B_SUB_TABLE[sub_mb_type[i]][0]
            self._sub_mb_dec(i, pblk, shape)
    left4x4 = list(self.left_coef[:4])
    top4x4 = list(self.top_coef[self.mb_x][:4])
    self.cbp = cbp = self._read_cbp(r, avail, 1)
    if cbp:
        # direct_8x8_inference=1: need_transform_size_8x8 is always true
        # (bdirect_functions[1][1], h264.cpp:1364-1377)
        self._residual_luma_inter(r, 0x80 | cbp)
    else:
        self._no_residual_inter()
    I.store_info_intermb8x8(self, pblk, left4x4, top4x4)
    self.mbleft.direct8x8 = ((sub_mb_type[3] == 0) * 2) | (sub_mb_type[1] == 0)
    self._top().direct8x8 = ((sub_mb_type[3] == 0) * 2) | (sub_mb_type[2] == 0)
    self._residual_chroma(r, cbp, avail)


H264Decoder._mb_inter16x8_b = _mb_inter16x8_b
H264Decoder._mb_inter8x8b = _mb_inter8x8b


# ======================================================================
# B-slice stage 2: direct / skip
# ======================================================================
from . import bdirect as BD  # noqa: E402


def _mb_bdirect16x16(self, r, avail):
    """mb_bdirect16x16 (h264.cpp:9402-9430)."""
    self._avail_saved = avail
    msets = np.zeros((16, 2, 2), np.int32)
    ref8 = np.full(8, -1, np.int32)
    if self.hdr.direct_spatial_mv_pred_flag:
        BD.b_skip_mb_spatial(self, ref8, msets)
    else:
        BD.b_skip_mb_temporal(self, ref8, msets)
    left4x4 = list(self.left_coef[:4])
    top4x4 = list(self.top_coef[self.mb_x][:4])
    self.cbp = cbp = self._read_cbp(r, avail, 1)
    if cbp:
        self._residual_luma_inter(r, 0x80 | cbp)
    else:
        self._no_residual_inter()
    page = self.refs[1][0].col
    col_type = int(page["type"][self.mb_pos])
    BD.store_info_direct(self, msets, ref8, left4x4, top4x4, col_type)
    self.mbleft.direct8x8 = 3
    self._top().direct8x8 = 3
    self._residual_chroma(r, cbp, avail)


def _pred_direct8x8(self, r, avail, blk_idx, pblk, shared, type0_cnt):
    if self.hdr.direct_spatial_mv_pred_flag:
        BD.pred_direct8x8_spatial(self, blk_idx, pblk, avail, shared, type0_cnt)
    else:
        BD.pred_direct8x8_temporal(self, blk_idx, pblk, avail, shared, type0_cnt)


def _skip_mbs_full(self, skip_num):
    """skip_mbs (h264.cpp:10128-10183), P and B."""
    slice_type = self.hdr.slice_type
    max_run = self.max_x * self.max_y - self.mb_pos
    skip_num = min(skip_num, max_run)
    self.left_pred[:] = [2] * 4
    left4x4 = list(self.left_coef[:4])
    self.left_coef[:4] = [0] * 4
    self.cbp = 0
    self.cbf = 0
    mvds = np.zeros((2, 2), np.int32)
    while skip_num:
        if self.tc is not None:
            self.tc.emit_skip_flag(self, 1)
        if slice_type == P_SLICE:
            mvs, ref_idx = self._p_skip_mb()
        else:
            msets = np.zeros((16, 2, 2), np.int32)
            ref8 = np.full(8, -1, np.int32)
            if self.hdr.direct_spatial_mv_pred_flag:
                BD.b_skip_mb_spatial(self, ref8, msets)
            else:
                BD.b_skip_mb_temporal(self, ref8, msets)
        self.top_pred[self.mb_x][:] = [2] * 4
        top4x4 = list(self.top_coef[self.mb_x][:4])
        self.top_coef[self.mb_x][:4] = [0] * 4
        if slice_type == B_SLICE:
            page = self.refs[1][0].col
            col_type = int(page["type"][self.mb_pos])
        else:
            col_type = 0
        self._no_residual_inter()
        if slice_type == P_SLICE:
            I.store_info_inter16x16(self, mvs, mvds, ref_idx, left4x4, top4x4)
        else:
            BD.store_info_direct(self, msets, ref8, left4x4, top4x4, col_type)
        left4x4 = [0] * 4
        self.prev_qp_delta = 0
        self.mb_type = MB_PSKIP
        for n in (self.mbleft, self._top()):
            n.type = MB_PSKIP
            n.mb_skip = 1
            n.direct8x8 = 3
        if self._increment_mb_pos() < 0:
            return -1
        skip_num -= 1
    return 0


H264Decoder._mb_bdirect16x16 = _mb_bdirect16x16
H264Decoder._pred_direct8x8 = _pred_direct8x8
H264Decoder._skip_mbs = _skip_mbs_full
