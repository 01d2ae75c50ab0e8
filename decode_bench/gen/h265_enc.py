"""Randomized H.265 conformance-stream generator (CABAC).

Emits SPS/PPS + IDR I-slices for the currently-implemented decode
profile: single slice per picture, SAO/deblocking/scaling/PCM disabled,
intra CUs with no residual (all cbf = 0) in milestone 1.

Syntax shapes mirror the reference parser exactly (h265.cpp:553-720
parameter sets incl. the init_qp_minus26-read-as-ue quirk;
slice_header :858-938; CTU walk :4100+). The CABAC arithmetic encoder is
the shared spec 9.3.4 engine from h264_enc, re-initialized with the
H.265 context table.
"""

from __future__ import annotations

import random

from decode_bench.ref.bitstream.writer import BitWriter, escape_nal
from decode_bench.ref.h265 import cabac_tables as HT
from decode_bench.ref.h265 import residual_tables as RT

from .h264_enc import CabacEncoder

_AVAIL0 = (0, 5, 10, 15, 0, 5, 10, 15, 0, 5, 10, 15, 0, 5, 10, 15)
_AVAIL1 = (4, 4, 6, 6, 4, 4, 6, 6, 12, 12, 14, 14, 12, 12, 14, 14)
_AVAIL2 = (0, 1, 0, 1, 4, 5, 4, 5, 0, 1, 0, 1, 4, 5, 4, 5)

NAL_IDR_W_RADL = 19
NAL_TRAIL_R = 1
NAL_SPS, NAL_PPS = 33, 34


class H265CabacEncoder(CabacEncoder):
    """CabacEncoder with the HEVC context bank + init table."""

    def __init__(self, w, slice_qp, idc):
        super().__init__(w, slice_qp, 0)
        ctx = [0] * HT.NUM_CTX
        for i, (m, n) in enumerate(HT.INIT_MN[idc]):
            pre = ((m * slice_qp) >> 4) + n
            if pre < 64:
                pre = 1 if pre <= 0 else pre
                ctx[i] = (63 - pre) * 2
            else:
                pre = 126 if pre > 126 else pre
                ctx[i] = (pre - 64) * 2 + 1
        self.ctx = ctx


#: milestone-1 mode subset (kept for the early tests)
M1_MODES = (0, 1, 10, 26)
ALL_MODES = tuple(range(35))


class H265StreamGen:
    def __init__(self, width, height, seed=0, ctb_log2=4, min_cb_log2=3,
                 qp=30, modes=M1_MODES, split_prob=0.4, nxn_prob=0.4,
                 cbf_prob=0.0, max_level=3, coeff_prob=0.2,
                 strong_smoothing=0, sign_data_hiding=0,
                 transform_skip=0, tskip_prob=0.5, deblock=0,
                 beta_offset_div2=0, tc_offset_div2=0, sao=0,
                 sao_max_offset=3, skip_prob=0.4, inter_intra_prob=0.25,
                 merge_max=5, amvp_prob=0.0, max_mvd=16, tmvp=0,
                 part_mode_prob=0.0, amp=0, deblock_override=0,
                 slice_local_rps=0, dependent_slices=0):
        self.w = width
        self.h = height
        self.rng = random.Random(seed)
        self.ctb_log2 = ctb_log2
        self.min_cb_log2 = min_cb_log2
        self.min_tb_log2 = 2
        self.max_tb_log2 = min(ctb_log2, 5)
        self.qp = qp
        self.modes = modes
        self.split_prob = split_prob
        self.nxn_prob = nxn_prob
        self.strong_smoothing = strong_smoothing
        self.sign_data_hiding = sign_data_hiding
        self.deblock = deblock
        self.sao = sao
        self.sao_max_offset = sao_max_offset
        self.skip_prob = skip_prob
        self.inter_intra_prob = inter_intra_prob
        self.merge_max = merge_max
        self.amvp_prob = amvp_prob
        self.max_mvd = max_mvd
        #: slice_temporal_mvp: ON only for AMVP-only streams — the
        #: reference's temporal MERGE candidate in P slices carries
        #: uninitialized stack ref_idx[1]/mvd[1] (pred_info_t list[5],
        #: h265.cpp:3694) -> OOB ref-list reads; while AMVP with tmvp
        #: OFF null-derefs (h265.cpp:4030). Indeterminate domains both.
        self.tmvp = tmvp
        self.part_mode_prob = part_mode_prob
        self.amp = amp
        #: per-slice deblock parameter override (slice_header_body,
        #: h265.cpp:896-903)
        self.deblock_override = deblock_override
        #: emit the RPS in the slice header (nopred or inter-predicted
        #: against an SPS set; h265.cpp:722-730)
        self.slice_local_rps = slice_local_rps
        #: emit non-first segments as dependent slice segments
        #: (stale-header inheritance, h265.cpp:910-919)
        self.dependent_slices = dependent_slices
        self.slice_type = 2  # current picture's type during emission
        self.beta_offset_div2 = beta_offset_div2
        self.tc_offset_div2 = tc_offset_div2
        self.transform_skip_enabled = transform_skip
        self.tskip_prob = tskip_prob
        self.cbf_prob = cbf_prob
        self.max_level = max_level
        self.coeff_prob = coeff_prob
        self.cols = (width + (1 << ctb_log2) - 1) >> ctb_log2
        self.rows = (height + (1 << ctb_log2) - 1) >> ctb_log2

    @staticmethod
    def _chroma_dir(cidx, luma_mode):
        if cidx == 0:
            return 34 if luma_mode == 0 else 0
        if cidx == 1:
            return 34 if luma_mode == 26 else 26
        if cidx == 2:
            return 34 if luma_mode == 10 else 10
        if cidx == 3:
            return 34 if luma_mode == 1 else 1
        return luma_mode

    # -- NAL plumbing ---------------------------------------------------
    def _nal(self, out, nal_type, payload_writer):
        w = BitWriter()
        w.put_bits(0, 1)  # forbidden_zero
        w.put_bits(nal_type, 6)
        w.put_bits(0, 6)  # nuh_layer_id
        w.put_bits(1, 3)  # nuh_temporal_id_plus1
        payload_writer(w)
        out += b"\x00\x00\x00\x01" + escape_nal(w.tobytes())

    # -- parameter sets -------------------------------------------------
    def _ptl(self, w):
        w.put_bits(1, 8)    # profile space 0, Main tier, Main (idc 1)
        w.put_bits(1 << 30, 32)  # compatible with Main (flag 1)
        for _ in range(6):
            w.put_bits(0, 8)
        w.put_bits(123, 8)  # level 4.1

    def _sps(self, w):
        w.put_bits(0, 4)  # vps_id
        w.put_bits(0, 3)  # max_sub_layers_minus1
        w.put_bits(1, 1)  # temporal_id_nesting
        self._ptl(w)
        w.ue(0)  # sps_id
        w.ue(1)  # chroma_format_idc 4:2:0
        w.ue(self.w)
        w.ue(self.h)
        w.put_bits(0, 1)  # conformance window (reference derives crop
        # from pic size vs CTB padding on its own)
        w.ue(0)  # bit_depth_luma_minus8
        w.ue(0)  # bit_depth_chroma_minus8
        w.ue(4)  # log2_max_poc_lsb_minus4
        w.put_bits(1, 1)  # sub_layer_ordering_info_present
        w.ue(2)  # max_dec_pic_buffering_minus1
        w.ue(0)  # max_num_reorder
        w.ue(0)  # max_latency
        w.ue(self.min_cb_log2 - 3)
        w.ue(self.ctb_log2 - self.min_cb_log2)
        w.ue(self.min_tb_log2 - 2)
        w.ue(self.max_tb_log2 - self.min_tb_log2)
        w.ue(0)  # max_transform_hierarchy_depth_inter
        w.ue(0)  # max_transform_hierarchy_depth_intra
        w.put_bits(0, 1)  # scaling_list_enabled
        w.put_bits(1 if self.amp else 0, 1)  # amp_enabled
        w.put_bits(1 if self.sao else 0, 1)  # sao_enabled
        w.put_bits(0, 1)  # pcm_enabled
        # num_short_term_ref_pic_sets = 16: the reference sizes its
        # colocated-MV maps by the RPS count (set_second_frame,
        # h265.cpp:121-129) while the frame pool LRU marches through up
        # to 16 indices — fewer sets crash on the first unmapped index
        w.ue(16)
        for i in range(16):
            if i:
                w.put_bits(0, 1)  # inter_rps_pred_flag = 0
            if i == 14:  # {-2}: P anchor skipping one B
                w.ue(1)
                w.ue(0)
                w.ue(1)  # delta_poc_s0_minus1 -> -2
                w.put_bits(1, 1)
            elif i == 15:  # {-1, +1}: B
                w.ue(1)
                w.ue(1)
                w.ue(0)
                w.put_bits(1, 1)
                w.ue(0)  # delta_poc_s1_minus1 -> +1
                w.put_bits(1, 1)
            else:  # {-1}
                w.ue(1)
                w.ue(0)
                w.ue(0)
                w.put_bits(1, 1)
        w.put_bits(0, 1)  # long_term_ref_pics_present
        w.put_bits(1, 1)  # sps_temporal_mvp_enabled
        w.put_bits(self.strong_smoothing, 1)
        w.put_bits(0, 1)  # vui_present
        w.rbsp_trailing_bits()

    def _pps(self, w):
        w.ue(0)  # pps_id
        w.ue(0)  # sps_id
        w.put_bits(1 if self.dependent_slices else 0, 1)  # dependent_slice_segments
        w.put_bits(0, 1)  # output_flag_present
        w.put_bits(0, 3)  # num_extra_slice_header_bits
        w.put_bits(self.sign_data_hiding, 1)
        w.put_bits(0, 1)  # cabac_init_present
        w.ue(0)  # num_ref_idx_l0_default_minus1
        w.ue(0)  # num_ref_idx_l1_default_minus1
        w.ue(self.qp - 26 if self.qp >= 26 else 0)  # QUIRK: read as ue
        w.put_bits(0, 1)  # constrained_intra_pred
        w.put_bits(self.transform_skip_enabled, 1)
        w.put_bits(0, 1)  # cu_qp_delta
        w.se(0)  # cb_qp_offset
        w.se(0)  # cr_qp_offset
        w.put_bits(0, 1)  # slice_chroma_qp_offsets_present
        w.put_bits(0, 1)  # weighted_pred
        w.put_bits(0, 1)  # weighted_bipred
        w.put_bits(0, 1)  # transquant_bypass
        w.put_bits(0, 1)  # tiles
        w.put_bits(0, 1)  # entropy_coding_sync
        w.put_bits(0, 1)  # loop_filter_across_slices
        w.put_bits(1, 1)  # deblocking_filter_control_present
        w.put_bits(1 if self.deblock_override else 0, 1)  # deblocking_filter_override_enabled
        w.put_bits(0 if self.deblock else 1, 1)  # deblocking disabled
        if self.deblock:
            w.se(self.beta_offset_div2)
            w.se(self.tc_offset_div2)
        w.put_bits(0, 1)  # pps_scaling_list_data_present
        w.put_bits(0, 1)  # lists_modification
        w.ue(0)  # log2_parallel_merge_level_minus2
        w.put_bits(0, 1)  # slice_segment_header_extension
        w.put_bits(0, 1)  # pps_extension
        w.rbsp_trailing_bits()

    # -- slice ----------------------------------------------------------
    def _emit_slice_rps(self, w, rps_idx):
        """Slice-local RPS equivalent to SPS set rps_idx — nopred or
        inter-predicted against another SPS set (both parser paths)."""
        pred = self.rng.random() < 0.5
        w.put_bits(1 if pred else 0, 1)  # inter_ref_pic_set_prediction
        if not pred:
            if rps_idx == 14:      # {-2}
                w.ue(1); w.ue(0); w.ue(1); w.put_bits(1, 1)
            elif rps_idx == 15:    # {-1, +1}
                w.ue(1); w.ue(1); w.ue(0); w.put_bits(1, 1)
                w.ue(0); w.put_bits(1, 1)
            else:                  # {-1}
                w.ue(1); w.ue(0); w.ue(0); w.put_bits(1, 1)
            return
        if rps_idx == 14:
            # {-2} from SPS set 0 ({-1}) with delta_rps = -1; the
            # delta_rps candidate itself is excluded via use_delta=0
            w.ue(15)               # delta_idx_minus1 -> index 0
            w.put_bits(1, 1)       # delta_rps_sign (negative)
            w.ue(0)                # abs_delta_rps_minus1 -> -1
            w.put_bits(1, 1)       # j0 (-1 -> -2): used
            w.put_bits(0, 1); w.put_bits(0, 1)  # delta slot: unused
        elif rps_idx == 15:
            # {-1, +1} from SPS set 14 ({-2}) with delta_rps = +1:
            # -2+1 = -1 (neg) and the delta slot itself = +1 (pos)
            w.ue(1)                # delta_idx_minus1 -> index 14
            w.put_bits(0, 1)       # sign (positive)
            w.ue(0)                # abs_delta_rps_minus1 -> +1
            w.put_bits(1, 1)       # j0 used
            w.put_bits(1, 1)       # delta slot used
        else:
            # {-1} from SPS set 14 ({-2}) with delta_rps = +1
            w.ue(1)
            w.put_bits(0, 1)
            w.ue(0)
            w.put_bits(1, 1)       # j0 (-2 -> -1): used
            w.put_bits(0, 1); w.put_bits(0, 1)  # delta slot: unused

    def _slice_header(self, w, slice_type=2, poc=0, rps_idx=0, first=1,
                      addr=0, dependent=0):
        w.put_bits(first, 1)  # first_slice_segment_in_pic
        if slice_type == 2:
            w.put_bits(0, 1)  # no_output_of_prior_pics (IRAP)
        w.ue(0)  # pps_id
        if not first:
            if self.dependent_slices:
                w.put_bits(dependent, 1)  # dependent_slice_segment_flag
            n_ctu = self.cols * self.rows
            nbits = n_ctu.bit_length()  # reference log2ceil = floor+1
            w.put_bits(addr, nbits)  # slice_segment_address
        if dependent:
            # no header body; straight to alignment
            misalign = (-w.nbits) % 8
            w.put_bits(1 << (misalign - 1) if misalign else 0x80,
                       misalign if misalign else 8)
            return
        w.ue(slice_type)
        if slice_type != 2:
            w.put_bits(poc & 0xFF, 8)  # pic_order_cnt_lsb
            if self.slice_local_rps and self.rng.random() < 0.7:
                w.put_bits(0, 1)  # short_term_ref_pic_set_sps_flag
                self._emit_slice_rps(w, rps_idx)
            else:
                w.put_bits(1, 1)  # short_term_ref_pic_set_sps_flag
                w.put_bits(rps_idx, 5)  # idx (bit-length quirk: 5 bits)
            w.put_bits(1 if self.tmvp else 0, 1)  # slice_temporal_mvp
        if self.sao:
            w.put_bits(1, 1)  # slice_sao_luma
            w.put_bits(1, 1)  # slice_sao_chroma
        if slice_type != 2:
            w.put_bits(0, 1)  # num_ref_idx override
            if slice_type == 0:
                self._mvd_l1_zero = self.rng.randint(0, 1)
                w.put_bits(self._mvd_l1_zero, 1)
            if self.tmvp and slice_type == 0:
                w.put_bits(1, 1)  # collocated_from_l0
            w.ue(5 - self.merge_max)  # five_minus_max_num_merge_cand
        w.se(self.qp - (26 + (self.qp - 26 if self.qp >= 26 else 0)))
        if self.deblock_override:
            ov = self.rng.random() < 0.75
            w.put_bits(1 if ov else 0, 1)  # deblocking_filter_override
            if ov:
                dis = self.rng.random() < 0.25
                w.put_bits(1 if dis else 0, 1)  # slice disabled
                if not dis:
                    w.se(self.rng.randint(-6, 6))  # beta_offset_div2
                    w.se(self.rng.randint(-6, 6))  # tc_offset_div2
        # byte alignment (reference skips 8 when already aligned)
        misalign = (-w.nbits) % 8
        w.put_bits(1 << (misalign - 1) if misalign else 0x80,
                   misalign if misalign else 8)

    # -- SAO emission ---------------------------------------------------
    def _emit_sao_offsets(self, enc, idx, edge_class=None):
        rng = self.rng
        offs = [rng.randint(0, self.sao_max_offset) for _ in range(4)]
        for o in offs:
            for _ in range(o):
                enc.bypass(1)
            if o < 7:
                enc.bypass(0)
        if idx == 1:
            for o in offs:
                if o:
                    enc.bypass(rng.randint(0, 1))  # sign
            pos = rng.randrange(32)
            enc.bypass((pos >> 4) & 1)
            enc.bypass((pos >> 3) & 1)
            enc.bypass((pos >> 2) & 1)
            enc.bypass((pos >> 1) & 1)
            enc.bypass(pos & 1)
        elif edge_class is not None:
            enc.bypass((edge_class >> 1) & 1)
            enc.bypass(edge_class & 1)

    def _emit_sao(self, enc, px, py):
        rng = self.rng
        if px:
            merge = rng.random() < 0.3
            enc.decision(HT.SAO_MERGE_FLAG, int(merge))
            if merge:
                return
        if py:
            merge = rng.random() < 0.3
            enc.decision(HT.SAO_MERGE_FLAG, int(merge))
            if merge:
                return
        for comp in (0, 1):
            idx = rng.choice((0, 1, 1, 2, 2))
            enc.decision(HT.SAO_TYPE_IDX, int(idx != 0))
            if not idx:
                continue
            enc.bypass(idx - 1)
            ec = rng.randrange(4) if idx == 2 else None
            self._emit_sao_offsets(enc, idx, ec)
            if comp == 1:  # second chroma elem
                self._emit_sao_offsets(enc, idx,
                                       None if idx == 2 else None)

    # -- CTU emission ---------------------------------------------------
    def _emit_part_mode(self, enc, mode, size_log2):
        """Inverse of part_mode_inter0/1/2 (h265.cpp:1165-1208)."""
        enc_ = enc

        def inter0(m):
            if m == 0:
                enc_.decision(HT.PART_MODE, 1)
            else:
                enc_.decision(HT.PART_MODE, 0)
                enc_.decision(HT.PART_MODE + 1, 2 - m)

        if self.min_cb_log2 < size_log2:
            if not self.amp:
                inter0(mode)
            else:
                if mode == 0:
                    inter0(0)
                elif mode in (1, 2):
                    inter0(mode)
                    enc_.decision(HT.PART_MODE + 3, 1)
                else:
                    base = 1 if mode in (4, 5) else 2
                    inter0(base)
                    enc_.decision(HT.PART_MODE + 3, 0)
                    enc_.bypass(mode & 1)
        else:
            # size == min (8 with our SPS): inter0, no NxN
            inter0(mode)

    def _emit_pu(self, enc, size_log2, width, height, merge_ok,
                 second):
        """One PU: merge or AMVP. Returns True when merged 2Nx2N
        (rqt_root_cbf inference is caller-side for mode 0 only)."""
        rng = self.rng
        amvp = (not merge_ok) or rng.random() < self.amvp_prob
        enc.decision(HT.MERGE_FLAG, 0 if amvp else 1)
        if not amvp:
            self._emit_merge_idx(enc)
            return True
        if self.slice_type == 0:
            depth = self.ctb_log2 - size_log2
            if width + height == 12:
                idc = rng.choice((0, 1))
                enc.decision(HT.INTER_PRED_IDC + 4, idc)
            else:
                idc = rng.choice((0, 1, 2, 2))
                if idc == 2:
                    enc.decision(HT.INTER_PRED_IDC + depth, 1)
                else:
                    enc.decision(HT.INTER_PRED_IDC + depth, 0)
                    enc.decision(HT.INTER_PRED_IDC + 4, idc)
        else:
            idc = 0
        if idc != 1:
            self._emit_mvd(enc)
            enc.decision(HT.MVP_FLAG, rng.randint(0, 1))
        if idc != 0:
            if idc == 1 or not self._mvd_l1_zero:
                self._emit_mvd(enc)
            enc.decision(HT.MVP_FLAG, rng.randint(0, 1))
        return False

    def _emit_mvd(self, enc):
        """mvd_coding inverse (h265.cpp:3723-3740)."""
        rng = self.rng
        vals = [rng.randint(-self.max_mvd, self.max_mvd)
                for _ in range(2)]
        a = [abs(v) for v in vals]
        enc.decision(HT.ABS_MVD_GREATER_FLAG, int(a[0] > 0))
        enc.decision(HT.ABS_MVD_GREATER_FLAG, int(a[1] > 0))
        if a[0]:
            enc.decision(HT.ABS_MVD_GREATER_FLAG + 1, int(a[0] > 1))
        if a[1]:
            enc.decision(HT.ABS_MVD_GREATER_FLAG + 1, int(a[1] > 1))
        for v, av in zip(vals, a):
            if av:
                if av > 1:
                    rem = av - 2
                    bits = 0
                    while (2 << bits) - 2 + (1 << (bits + 1)) <= rem:
                        bits += 1
                    enc_bits = bits
                    for _ in range(bits):
                        enc.bypass(1)
                    enc.bypass(0)
                    suffix = rem - ((2 << bits) - 2)
                    for b in range(bits, -1, -1):
                        enc.bypass((suffix >> b) & 1)
                enc.bypass(int(v < 0))

    def _emit_merge_idx(self, enc):
        maxidx = self.merge_max
        idx = self.rng.randrange(maxidx)
        if maxidx <= 1:
            return
        enc.decision(HT.MERGE_IDX, int(idx != 0))
        if idx:
            k = 1
            while k < idx:
                enc.bypass(1)
                k += 1
            if idx < maxidx - 1:
                enc.bypass(0)

    def _emit_inter_cu(self, enc, size_log2, unavail, left, li, top, ti):
        """P-slice CU: skip / merge 2Nx2N / intra (pred_inter path)."""
        rng = self.rng
        depth = 6 - size_log2
        num = 1 << (size_log2 - 2)
        for i in range(num):
            left[li + i]["depth"] = depth
            top[ti + i]["depth"] = depth
        skip_inc = (((not (unavail & 1)) and left[li]["skip"])
                    + ((not (unavail & 2)) and top[ti]["skip"]))
        # in tmvp streams, P pictures must avoid skip/merge (the
        # reference's P temporal merge candidate is stack garbage)
        merge_ok = not (self.tmvp and self.slice_type == 1)
        do_skip = merge_ok and rng.random() < self.skip_prob
        enc.decision(HT.CU_SKIP_FLAG + int(skip_inc), int(do_skip))
        if do_skip:
            self._emit_merge_idx(enc)
            for i in range(num):
                for arr, i0 in ((left, li), (top, ti)):
                    arr[i0 + i]["skip"] = 1
                    arr[i0 + i]["mode"] = 1
            return
        if rng.random() < self.inter_intra_prob:
            enc.decision(HT.PRED_MODE_FLAG, 1)
            self._emit_cu(enc, size_log2, unavail, left, li, top, ti,
                          set_depth=False)
            return
        enc.decision(HT.PRED_MODE_FLAG, 0)
        # part mode selection (inverse of part_mode_inter0/1/2)
        size = 1 << size_log2
        use_part = rng.random() < self.part_mode_prob
        if use_part:
            if self.amp and size_log2 > self.min_cb_log2:
                mode = rng.choice((1, 2, 4, 5, 6, 7))
            else:
                mode = rng.choice((1, 2))
        else:
            mode = 0
        self._emit_part_mode(enc, mode, size_log2)
        inferred = False
        if mode == 0:
            inferred = self._emit_pu(enc, size_log2, size, size,
                                     merge_ok, False)
        else:
            if mode in (1, 4, 5):  # horizontal splits
                hs = {1: size >> 1, 4: size >> 2, 5: size >> 2}[mode]
                h0 = hs if mode != 5 else size - hs
                self._emit_pu(enc, size_log2, size, h0, merge_ok, False)
                self._emit_pu(enc, size_log2, size, size - h0,
                              merge_ok, True)
            else:  # vertical splits
                ws = {2: size >> 1, 6: size >> 2, 7: size >> 2}[mode]
                w0 = ws if mode != 7 else size - ws
                self._emit_pu(enc, size_log2, w0, size, merge_ok, False)
                self._emit_pu(enc, size_log2, size - w0, size,
                              merge_ok, True)
        if inferred or True:
            if not inferred:
                root = rng.random() < 0.8
                enc.decision(HT.RQT_ROOT_CBF, int(root))
            else:
                root = True
            if root:
                self._emit_ttree(enc, size_log2, 0, 3,
                                 mode != 0, [0] * 4, 0, is_intra=False)
        for i in range(num):
            for arr, i0 in ((left, li), (top, ti)):
                arr[i0 + i]["skip"] = 0
                arr[i0 + i]["mode"] = 1

    def _emit_cu(self, enc, size_log2, unavail, left, li, top, ti,
                 set_depth=True):
        """One intra CU at `size_log2`."""
        rng = self.rng
        depth = 6 - size_log2  # intra_depth_fill convention
        num = 1 << (size_log2 - 2)
        if set_depth:
            for i in range(num):
                left[li + i]["depth"] = depth
                top[ti + i]["depth"] = depth
        part_nxn = False
        if size_log2 == self.min_cb_log2:
            part_nxn = rng.random() < self.nxn_prob
            enc.decision(HT.PART_MODE, 0 if part_nxn else 1)
        part_num = 4 if part_nxn else 1
        nnum = 1 << (size_log2 - 2 - (part_num == 4))
        # pass 1: choose modes and derive flag/payload with the SAME
        # neighbour evolution the decoder sees (fills between parts)
        modes, flags = [], []
        snap = [dict(x) for x in left], [dict(x) for x in top]
        for i in range(part_num):
            la = left[li + (i >> 1)]
            ta = top[ti + (i & 1)]
            cand = _candidates(la["mode"], ta["mode"])
            want = rng.choice(list(self.modes))
            if want in cand:
                flags.append((1, cand.index(want)))
            else:
                rem = want
                for c in cand:
                    if c < want:
                        rem -= 1
                flags.append((0, rem))
            modes.append(want)
            lt, tt = li + (i >> 1), ti + (i & 1)
            for k in range(nnum):
                left[lt + k]["mode"] = want
                left[lt + k]["skip"] = 0
                top[tt + k]["mode"] = want
                top[tt + k]["skip"] = 0
        # pass 2: bin order = all prev_intra flags, then per-part payload
        for f, _ in flags:
            enc.decision(HT.PREV_INTRA_LUMA_PRED_FLAG, f)
        for i in range(part_num):
            f, payload = flags[i]
            if f:
                if payload == 0:
                    enc.bypass(0)
                else:
                    enc.bypass(1)
                    enc.bypass(payload - 1)
            else:
                for b in range(4, -1, -1):
                    enc.bypass((payload >> b) & 1)
        luma0 = modes[0]
        # chroma: derived mode must stay in the implemented set
        choices = [4]
        for idx, base in ((0, 0), (1, 26), (2, 10), (3, 1)):
            derived = 34 if luma0 == base else base
            if derived in self.modes:
                choices.append(idx)
        cidx = rng.choice(choices)
        if cidx == 4:
            enc.decision(HT.INTRA_CHROMA_PRED_MODE, 0)
        else:
            enc.decision(HT.INTRA_CHROMA_PRED_MODE, 1)
            enc.bypass((cidx >> 1) & 1)
            enc.bypass(cidx & 1)
        full_modes = modes if len(modes) == 4 else [modes[0]] * 4
        self._emit_ttree(enc, size_log2, 0, 3, part_nxn, full_modes,
                         self._chroma_dir(cidx, luma0))

    def _emit_ttree(self, enc, size_log2, depth, upper_cbf, intra_split,
                    modes, chroma_mode, idx=0, pred_idx=0, is_intra=True):
        rng = self.rng
        if self.max_tb_log2 < size_log2:
            split = 1
        elif depth == 0 and intra_split:
            split = 2  # intra NxN, or inter non-2Nx2N with hier 0
        else:
            split = 0  # hierarchy depths are 0: no split flag coded
        if 2 < size_log2:
            cbf = 0
            if upper_cbf & 2:
                b = int(rng.random() < self.cbf_prob)
                enc.decision(HT.CBF_CHROMA + depth, b)
                cbf = b * 2
            if upper_cbf & 1:
                b = int(rng.random() < self.cbf_prob)
                enc.decision(HT.CBF_CHROMA + depth, b)
                cbf |= b
        else:
            cbf = upper_cbf
        if split:
            pi, pinc = (0, 1) if split == 2 else (pred_idx, 0)
            for k in range(4):
                self._emit_ttree(enc, size_log2 - 1, depth + 1, cbf,
                                 False, modes, chroma_mode, k, pi,
                                 is_intra)
                pi += pinc
        else:
            if is_intra or depth or cbf:
                bl = int(rng.random() < self.cbf_prob)
                enc.decision(HT.CBF_LUMA + (depth == 0), bl)
            else:
                bl = 1  # forced (inter depth-0 with no chroma cbf)
            cbf = cbf * 2 | bl
            if cbf:
                self._emit_tu(enc, size_log2, cbf, idx, modes[pred_idx],
                              chroma_mode, is_intra)

    # -- residual emission (mirrors residual_coding exactly) -----------
    def _emit_tu(self, enc, size_log2, cbf, idx, luma_mode, chroma_mode,
                 is_intra=True):
        if cbf & 1:
            order = _order_map(luma_mode) \
                if (is_intra and size_log2 <= 3) else 0
            self._emit_residual(enc, size_log2, 0, order)
        if cbf & 6:
            if 2 < size_log2:
                size_log2 -= 1
            elif idx != 3:
                return
            order = _order_map(chroma_mode) \
                if (is_intra and size_log2 == 2) else 0
            if cbf & 4:
                self._emit_residual(enc, size_log2, 1, order)
            if cbf & 2:
                self._emit_residual(enc, size_log2, 2, order)

    def _choose_coeffs(self, size_log2, order_idx):
        """Random sparse coefficient set as {(sub_idx, pos): level}
        where sub_idx is the subblock SCAN rank and pos the inner scan
        pos (15..0 order). At least one coefficient."""
        rng = self.rng
        order = RT.SCAN_ORDER[order_idx][size_log2 - 2]
        sub_log2 = size_log2 - 2
        n_sub = 1 << (2 * sub_log2)
        coeffs = {}
        for i in range(n_sub):
            if i and rng.random() > 0.3:
                continue
            npos = 16
            for pos in range(npos):
                if rng.random() < self.coeff_prob:
                    lvl = rng.randint(1, self.max_level)
                    if rng.random() < 0.5:
                        lvl = -lvl
                    coeffs[(i, pos)] = lvl
        if not coeffs:
            coeffs[(0, rng.randrange(16))] = rng.choice((1, -1))
        return coeffs

    def _emit_residual(self, enc, size_log2, colour, order_idx):
        rng = self.rng
        sdh = self.sign_data_hiding
        if self.transform_skip_enabled and size_log2 == 2:
            tskip = rng.random() < self.tskip_prob
            enc.decision(HT.TRANSFORM_SKIP_FLAG + ((colour + 1) >> 1),
                         int(tskip))
        coeffs = self._choose_coeffs(size_log2, order_idx)
        order = RT.SCAN_ORDER[order_idx][size_log2 - 2]
        sub_log2 = size_log2 - 2
        pos_max = (1 << sub_log2) - 1
        # the scan-last coefficient
        last_sub = max(i for i, _ in coeffs)
        last_pos = max(p for i, p in coeffs if i == last_sub)
        # map (sub rank, inner pos) back to (x, y)
        sxy = order["sub_block_pos"][last_sub]
        inner_xy = _inner_pos_to_xy(order_idx, last_pos)
        lx = ((sxy & pos_max) << 2) + inner_xy[0]
        ly = ((sxy >> sub_log2) << 2) + inner_xy[1]
        if order_idx == 2:
            lx, ly = ly, lx
        raw = RT.LAST_SIG_COEF_PARAM[(colour + 1) >> 1][size_log2 - 2]
        ofs, shift = raw & 15, raw >> 4
        maxpre = size_log2 * 2 - 1
        # prefixes for BOTH components first, then both suffixes
        # (residual_coding read order, h265.cpp:2190-2193)
        prefixes = []
        for val, base in ((lx, HT.LAST_SIG_COEFF_X_PREFIX + ofs),
                          (ly, HT.LAST_SIG_COEFF_Y_PREFIX + ofs)):
            prefix = _last_sig_prefix_of(val)
            for k in range(prefix):
                enc.decision(base + (k >> shift), 1)
            if prefix < maxpre:
                enc.decision(base + (prefix >> shift), 0)
            prefixes.append((prefix, val))
        for prefix, val in prefixes:
            if prefix >= 4:
                nbits = (prefix >> 1) - 1
                rem = val - _PREFIX_ADJ_VAL[prefix - 4]
                for b in range(nbits - 1, -1, -1):
                    enc.bypass((rem >> b) & 1)
        inc_idx = RT.SIG_INC_TBLIDX[order_idx][(colour + 1) >> 1][
            size_log2 - 2]
        inc_ofs = RT.SIG_INC_OFSET[order_idx][(colour + 1) >> 1][
            size_log2 - 2]
        flags = [0] * 9
        greater1ctx = 1
        num = last_pos
        i = last_sub
        while i >= 0:
            sxy = order["sub_block_pos"][i]
            sx = sxy & pos_max
            sy = sxy >> sub_log2
            prev_sbf = ((flags[sy] >> (sx + 1)) & 1) + \
                (((flags[sy + 1] >> sx) & 1) * 2)
            here = {p: v for (si, p), v in coeffs.items() if si == i}
            implicit = ((last_sub - 1) & 0xFFFFFFFF) <= \
                ((i - 1) & 0xFFFFFFFF)
            if not implicit:
                enc.decision(
                    HT.CODED_SUB_BLOCK_FLAG
                    + ((prev_sbf & 1) | (prev_sbf >> 1))
                    + ((colour + 1) & 2), int(bool(here)))
            if implicit or here:
                flags[sy] |= 1 << sx
                inc_tbl = RT.SIG_INC_TBL[inc_idx[sxy != 0][prev_sbf]]
                clist = []
                pos = num
                if i == last_sub:
                    clist.append((pos, abs(here[pos]), here[pos] < 0))
                    pos -= 1
                while 0 < pos:
                    b = pos in here
                    enc.decision(HT.SIG_COEFF_FLAG + inc_ofs
                                 + inc_tbl[pos], int(b))
                    if b:
                        clist.append((pos, abs(here[pos]), here[pos] < 0))
                    pos -= 1
                if pos == 0:
                    if not clist and sxy:
                        pass  # DC implicitly significant
                    else:
                        enc.decision(HT.SIG_COEFF_FLAG + inc_ofs
                                     + inc_tbl[0], int(0 in here))
                    if 0 in here:
                        clist.append((0, abs(here[0]), here[0] < 0))
                if not clist:
                    break
                # greater1/2 schedule mirrors sig_coeff_greater
                ctxset = (2 if (colour == 0 and i != 0) else 0) + \
                    (greater1ctx == 0)
                g1ofs = ctxset * 4 + (0 if colour == 0 else 16)
                greater1ctx = 1
                remaining = []
                last_g1 = -1
                for j, (pos, lvl, neg) in enumerate(clist):
                    if j >= 8:
                        remaining.append((j, lvl - 1))
                        continue
                    g1 = lvl >= 2
                    enc.decision(HT.COEFF_ABS_LEVEL_GREATER1_FLAG
                                 + g1ofs + greater1ctx, int(g1))
                    if g1:
                        greater1ctx = 0
                        if last_g1 >= 0:
                            remaining.append((j, lvl - 2))
                        else:
                            last_g1 = j
                    elif ((greater1ctx - 1) & 0xFFFFFFFF) < 2:
                        greater1ctx += 1
                if last_g1 >= 0:
                    lvl = clist[last_g1][1]
                    g2 = lvl >= 3
                    enc.decision(HT.COEFF_ABS_LEVEL_GREATER2_FLAG
                                 + (ctxset if colour == 0 else ctxset + 4),
                                 int(g2))
                    if g2:
                        remaining.append((last_g1, lvl - 3))
                remaining.sort()
                hidden = int(sdh and 3 < clist[0][0] - clist[-1][0])
                if hidden:
                    # the last coeff's sign is parity-derived; force it
                    level_sum = sum(l for _, l, _ in clist)
                    p, l, _ = clist[-1]
                    clist[-1] = (p, l, bool(level_sum & 1))
                for pos, lvl, neg in clist[: len(clist) - hidden]:
                    enc.bypass(int(neg))
                rice = 0
                ri = 0
                for j, (pos, lvl, neg) in enumerate(clist):
                    if ri < len(remaining) and remaining[ri][0] == j:
                        rem = remaining[ri][1]
                        ri += 1
                        self._emit_remaining(enc, rem, rice)
                        rice = min(rice + ((3 << rice) < lvl), 4)
            num = 15
            i -= 1

    def _emit_remaining(self, enc, v, rice):
        if v < (4 << rice):
            pre = v >> rice
            for _ in range(pre):
                enc.bypass(1)
            enc.bypass(0)
            for b in range(rice - 1, -1, -1):
                enc.bypass((v >> b) & 1)
        else:
            base = v - (2 << rice)
            k = base.bit_length() - 1 - rice - 1
            pre = k + 4
            for _ in range(pre):
                enc.bypass(1)
            if pre < 20:
                enc.bypass(0)
            nbits = k + rice + 1
            rem = v - (1 << (k + rice + 1)) - (2 << rice)
            for b in range(nbits - 1, -1, -1):
                enc.bypass((rem >> b) & 1)

    def _emit_quad(self, enc, size_log2, unavail, valid_x, valid_y,
                   left, li, top, ti):
        if valid_x <= 0 or valid_y <= 0:
            return
        size = 1 << size_log2
        boundary = valid_x < size or valid_y < size
        if self.min_cb_log2 < size_log2:
            split = boundary or self.rng.random() < self.split_prob
            if not boundary:
                inc = ((6 < size_log2 + left[li]["depth"])
                       + (6 < size_log2 + top[ti]["depth"]))
                enc.decision(HT.SPLIT_CU_FLAG + inc, int(split))
            if split:
                sl = size_log2 - 1
                bl = 1 << sl
                info = 1 << (sl - 2)
                minu = lambda v, b: min(v & 0xFFFFFFFF, b)  # noqa: E731
                self._emit_quad(enc, sl, _AVAIL0[unavail], valid_x,
                                valid_y, left, li, top, ti)
                self._emit_quad(enc, sl, _AVAIL1[unavail], valid_x - bl,
                                minu(valid_y, bl), left, li, top,
                                ti + info)
                self._emit_quad(enc, sl, _AVAIL2[unavail],
                                minu(valid_x, bl * 2), valid_y - bl,
                                left, li + info, top, ti)
                self._emit_quad(enc, sl, 12, minu(valid_x - bl, bl),
                                minu(valid_y - bl, bl),
                                left, li + info, top, ti + info)
                return
        if self.slice_type < 2:
            self._emit_inter_cu(enc, size_log2, unavail, left, li,
                                top, ti)
        else:
            self._emit_cu(enc, size_log2, unavail, left, li, top, ti)

    def _slice(self, w, slice_type=2, poc=0, rps_idx=0, first=1, addr=0,
               end=None, dependent=0):
        self.slice_type = slice_type
        self._slice_header(w, slice_type, poc, rps_idx, first, addr,
                           dependent)
        idc = 0 if slice_type == 2 else 2 - slice_type
        enc = H265CabacEncoder(w, self.qp, idc)
        nn = 16
        left = [{"mode": 1, "depth": 0, "skip": 0}
                for _ in range(nn + 2)]
        top = [{"mode": 1, "depth": 0, "skip": 0}
               for _ in range(self.cols * nn)]
        n_ctu = self.cols * self.rows if end is None else end
        ctb = 1 << self.ctb_log2
        for i in range(addr, n_ctu):
            islice = i - addr  # idx_in_slice (availability is per-slice)
            py, px = divmod(i, self.cols)
            if self.sao:
                self._emit_sao(enc, px, py)
            valid_x = self.w - px * ctb
            valid_y = min(self.h - py * ctb, ctb)
            unavail = (((not py or islice < self.cols) * 10)
                       | ((not px or not islice) * 5) | 4)
            self._emit_quad(enc, self.ctb_log2, unavail, valid_x,
                            valid_y, left, 2, top, px * nn)
            # neighbour maintenance mirroring ctu_pos_increment
            if px == self.cols - 1:
                for nb in left[1:]:
                    nb["mode"], nb["depth"], nb["skip"] = 1, 0, 0
                nxt = 0
            else:
                left[1] = dict(left[0])
                nxt = px + 1
            left[0] = dict(top[((nxt + 1) << (self.ctb_log2 - 2)) - 1])
            base = nxt * nn
            for k in range(nn):
                top[base + k]["mode"] = 1
            if i != n_ctu - 1:
                enc.terminate(0)
        enc.terminate(1)
        w.byte_align(0)

    def header_bytes(self):
        """The SPS and PPS NALs that start every stream of this
        generator."""
        out = bytearray()
        self._nal(out, NAL_SPS, self._sps)
        self._nal(out, NAL_PPS, self._pps)
        return bytes(out)

    #: None, or coding-order index -> random.Random: each picture's own
    #: generator, so pictures can be made apart (``generate(only=)``)
    picture_rng = None

    def generate(self, pattern=1, only=None) -> bytes:
        """pattern: an int (that many IDR pictures) or a string like
        "IPP" (I = IDR, P = TRAIL_R P slice; POC = position). only: None,
        or a coding-order index: then that picture's NALs alone (no
        SPS/PPS)."""
        if isinstance(pattern, int):
            pattern = "I" * pattern
        out = bytearray()
        if only is None:
            self._nal(out, NAL_SPS, self._sps)
            self._nal(out, NAL_PPS, self._pps)
        # coding-order pattern with classic display reorder: each P
        # anchor jumps over the Bs that follow it (max one B deep)
        plan = []  # (type_char, poc, rps_idx)
        nextpoc = 0
        i = 0
        while i < len(pattern):
            c = pattern[i]
            if c == "I":
                plan.append(("I", 0, 0))
                nextpoc = 1
                i += 1
            else:
                nb = 0
                while i + 1 + nb < len(pattern) and \
                        pattern[i + 1 + nb] == "B":
                    nb += 1
                assert nb <= 1, "one-B-deep patterns only"
                anchor = nextpoc + nb
                plan.append(("P", anchor, 14 if nb else 0))
                for k in range(nb):
                    plan.append(("B", nextpoc + k, 15))
                nextpoc = anchor + 1
                i += 1 + nb
        # Row-aligned slice segments only: the reference computes a
        # mid-row segment's chroma base as luma_offset >> 1
        # (ctu_init, h265.cpp:4776-4786), planting chroma 8px left and
        # across row boundaries in linear NV12 memory — excluded as a
        # reference-bug domain (not representable on planar planes).
        n_ctu = self.cols * self.rows
        nslices = max(1, min(getattr(self, "slices_per_pic", 1),
                             self.rows))
        rb = [self.rows * k // nslices for k in range(nslices + 1)]
        bounds = [r * self.cols for r in rb]
        segs = [(bounds[k] == 0, bounds[k], bounds[k + 1])
                for k in range(nslices) if bounds[k] < bounds[k + 1]]
        for i, (ch, poc, rps) in enumerate(plan):
            if only is not None and only != i:
                continue
            if self.picture_rng is not None:
                self.rng = self.picture_rng(i)
            for first, addr, end in segs:
                dep = (0 if first or not self.dependent_slices
                       else int(self.rng.random() < 0.7))
                if ch == "I":
                    self._nal(out, NAL_IDR_W_RADL,
                              lambda w, f=first, a=addr, e=end, d=dep:
                              self._slice(w, 2, 0, 0, 1 if f else 0, a,
                                          e, d))
                else:
                    st = 0 if ch == "B" else 1
                    self._nal(out, NAL_TRAIL_R,
                              lambda w, s=st, p=poc, ri=rps, f=first,
                              a=addr, e=end, d=dep:
                              self._slice(w, s, p, ri, 1 if f else 0,
                                          a, e, d))
        return bytes(out)


_PREFIX_ADJ_VAL = (4, 6, 8, 12, 16, 24)


def _last_sig_prefix_of(val):
    """Inverse of last_sig_coeff_suffix_add: smallest prefix whose
    value range contains val."""
    if val < 4:
        return val
    p = 4
    while True:
        nbits = (p >> 1) - 1
        base = _PREFIX_ADJ_VAL[p - 4]
        if base <= val < base + (1 << nbits):
            return p
        p += 1


def _order_map(idx):
    idx = (idx - 6) & 31
    return ((idx & 15) <= 8) << (1 if idx <= 15 else 0)


def _inner_pos_to_xy(order_idx, pos):
    """inner scan pos -> (x, y) within the 4x4 subblock: invert
    INNER_INV (pos = INNER_INV[(y<<2)+x])."""
    inv = RT.INNER_INV[order_idx]
    for y in range(4):
        for x in range(4):
            if inv[(y << 2) + x] == pos:
                return x, y
    raise AssertionError


def _candidates(a, b):
    if a == b:
        if a <= 1:
            return [0, 1, 26]
        return [a, ((a - 3) & 31) + 2, ((a - 1) & 31) + 2]
    if a != 0 and b != 0:
        c = 0
    elif a != 1 and b != 1:
        c = 1
    else:
        c = 26
    return [a, b, c]
