"""H.265 NAL + parameter-set parsing (reference h265.cpp:231-720).

Covers VPS/SPS/PPS with profile_tier_level, sub-layer ordering info,
conformance window, and the short-term RPS (both nopred and
inter-RPS-predicted forms, h265.cpp:392-488). The CTU decode stages
raise NotImplementedError until the entropy/reconstruction phases land.
"""

from __future__ import annotations

import dataclasses

from m2dec_tpu_torch.bitstream import BitReader
from m2dec_tpu_torch.bitstream.reader import find_start_codes, unescape_nal
from m2dec_tpu_torch.runtime import trace

# nal_unit_type (spec Table 7-1)
NAL_TRAIL_N, NAL_TRAIL_R = 0, 1
NAL_IDR_W_RADL, NAL_IDR_N_LP = 19, 20
NAL_VPS, NAL_SPS, NAL_PPS = 32, 33, 34


@dataclasses.dataclass
class ProfileTierLevel:
    profile_first8: int = 0
    compat_flags: int = 0
    second48: bytes = b""
    level_idc: int = 0


@dataclasses.dataclass
class StRefPicSet:
    """One short-term RPS: negative/positive delta-POC lists with
    used_by_curr flags (h265d_short_term_ref_pic_set_t)."""

    neg: tuple = ()
    pos: tuple = ()
    used_neg: int = 0
    used_pos: int = 0
    total_curr: int = 0


@dataclasses.dataclass
class Vps:
    id: int = 0
    max_layer: int = 0
    max_sub_layers: int = 1
    temporal_id_nesting_flag: int = 0
    ptl: ProfileTierLevel = dataclasses.field(default_factory=ProfileTierLevel)


@dataclasses.dataclass
class Sps:
    id: int = 0
    vps_id: int = 0
    chroma_format_idc: int = 1
    pic_width: int = 0
    pic_height: int = 0
    cropping: tuple = (0, 0, 0, 0)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 4
    max_dec_pic_buffering: tuple = ()
    log2_min_cb: int = 3
    log2_ctb: int = 6
    log2_min_tb: int = 2
    log2_max_tb: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: int = 0
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    short_term_rps: tuple = ()
    long_term_ref_pics_present: int = 0
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 0
    ptl: ProfileTierLevel = dataclasses.field(default_factory=ProfileTierLevel)


@dataclasses.dataclass
class Pps:
    id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: int = 0
    output_flag_present: int = 0
    sign_data_hiding: int = 0
    cabac_init_present: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync_enabled: int = 0
    loop_filter_across_slices: int = 0
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_segment_header_extension_present: int = 0


def _profile_tier_level(r: BitReader, max_sub_layers_minus1: int):
    """profile_tier_level (h265.cpp:242-256)."""
    ptl = ProfileTierLevel()
    ptl.profile_first8 = r.get_bits(8)
    ptl.compat_flags = r.get_bits(32)
    ptl.second48 = bytes(r.get_bits(8) for _ in range(6))
    ptl.level_idc = r.get_bits(8)
    if max_sub_layers_minus1:
        present = r.get_bits(16)
        p = present
        for _ in range(max_sub_layers_minus1):
            if p & 0x8000:
                r.get_bits(8)
                r.get_bits(32)
                for _ in range(6):
                    r.get_bits(8)
            if p & 0x4000:
                r.get_bits(8)
            p = (p << 2) & 0xFFFF
    return ptl


def _st_rps_nopred(r: BitReader) -> StRefPicSet:
    """short_term_ref_pic_set_nopred (h265.cpp:392-421)."""
    s = StRefPicSet()
    n_neg = r.ue()
    n_pos = r.ue()
    val = 0
    neg, used_neg, cnt = [], 0, 0
    for i in range(n_neg):
        val -= r.ue() + 1
        neg.append(val)
        b = r.get_onebit()
        used_neg |= b << i
        cnt += b
    val = 0
    pos, used_pos = [], 0
    for i in range(n_pos):
        val += r.ue() + 1
        pos.append(val)
        b = r.get_onebit()
        used_pos |= b << i
        cnt += b
    s.neg, s.pos = tuple(neg), tuple(pos)
    s.used_neg, s.used_pos = used_neg, used_pos
    s.total_curr = cnt
    return s


def _st_rps_pred(r: BitReader, ref: StRefPicSet) -> StRefPicSet:
    """short_term_ref_pic_set_pred (h265.cpp:423-470): derive this RPS
    from the previous one via delta_rps + per-entry use flags."""
    sign = r.get_onebit()
    delta_rps = (r.ue() + 1) * (-1 if sign else 1)
    n_ref = len(ref.neg) + len(ref.pos)
    used_flag = 0
    use_delta = 0
    used_cnt = 0
    for j in range(n_ref + 1):
        bit = 1 << j
        if r.get_onebit():
            used_flag |= bit
            use_delta |= bit
            used_cnt += 1
        elif r.get_onebit():
            use_delta |= bit
    # ref delta list in flag order: neg[0..], pos[0..], then delta_rps
    ref_all = list(ref.neg) + list(ref.pos)
    out = StRefPicSet()
    for s0 in (0, 1):  # 0 = negative side, 1 = positive side
        lst, used = [], 0
        src = (list(ref.pos)[::-1] if s0 == 0 else list(ref.neg)[::-1])
        # iterate opposite-sign refs (farthest first) then same-sign
        seq = []
        if s0 == 0:
            for j in range(len(ref.pos) - 1, -1, -1):
                seq.append((ref.pos[j], len(ref.neg) + j))
        else:
            for j in range(len(ref.neg) - 1, -1, -1):
                seq.append((ref.neg[j], j))
        for dp, j in seq:
            v = dp + delta_rps
            if (v < 0 if s0 == 0 else v > 0) and (use_delta & (1 << j)):
                used |= (1 if used_flag & (1 << j) else 0) << len(lst)
                lst.append(v)
        if ((delta_rps < 0 if s0 == 0 else delta_rps > 0)
                and (use_delta & (1 << n_ref))):
            used |= (1 if used_flag & (1 << n_ref) else 0) << len(lst)
            lst.append(delta_rps)
        if s0 == 0:
            for j, dp in enumerate(ref.neg):
                v = dp + delta_rps
                if v < 0 and (use_delta & (1 << j)):
                    used |= (1 if used_flag & (1 << j) else 0) << len(lst)
                    lst.append(v)
            out.neg, out.used_neg = tuple(lst), used
        else:
            for j, dp in enumerate(ref.pos):
                v = dp + delta_rps
                if v > 0 and (use_delta & (1 << (len(ref.neg) + j))):
                    used |= (1 if used_flag
                             & (1 << (len(ref.neg) + j)) else 0) << len(lst)
                    lst.append(v)
            out.pos, out.used_pos = tuple(lst), used
    out.total_curr = used_cnt
    return out


def parse_vps(r: BitReader) -> Vps:
    """video_parameter_set (h265.cpp:283-304)."""
    v = Vps()
    v.id = r.get_bits(4)
    r.get_bits(2)
    v.max_layer = r.get_bits(6)
    msl = r.get_bits(3)
    v.max_sub_layers = msl + 1
    v.temporal_id_nesting_flag = r.get_onebit()
    r.get_bits(16)
    v.ptl = _profile_tier_level(r, msl)
    info_present = r.get_onebit()
    for _ in range((0 if info_present else msl), msl + 1):
        r.ue()
        r.ue()
        r.ue()
    r.get_bits(6)  # max_layer_id
    for _ in range(r.ue()):
        pass  # layer-set bits skipped with max_layer_id+1 each (unused)
    if r.get_onebit():  # timing info
        r.get_bits(32)
        r.get_bits(32)
        if r.get_onebit():
            r.ue()
        r.ue()
    return v


def parse_sps(r: BitReader) -> Sps:
    """seq_parameter_set (h265.cpp:498-625 shape)."""
    s = Sps()
    s.vps_id = r.get_bits(4)
    msl = r.get_bits(3)
    r.get_onebit()  # temporal_id_nesting
    s.ptl = _profile_tier_level(r, msl)
    s.id = r.ue()
    s.chroma_format_idc = r.ue()
    if s.chroma_format_idc == 3:
        r.get_onebit()
    s.pic_width = r.ue()
    s.pic_height = r.ue()
    if r.get_onebit():  # conformance window
        s.cropping = tuple(r.ue() for _ in range(4))
    s.bit_depth_luma = r.ue() + 8
    s.bit_depth_chroma = r.ue() + 8
    s.log2_max_poc_lsb = r.ue() + 4
    info_present = r.get_onebit()
    bufs = []
    for _ in range((0 if info_present else msl), msl + 1):
        bufs.append((r.ue(), r.ue(), r.ue()))
    s.max_dec_pic_buffering = tuple(bufs)
    s.log2_min_cb = r.ue() + 3
    s.log2_ctb = s.log2_min_cb + r.ue()
    s.log2_min_tb = r.ue() + 2
    s.log2_max_tb = s.log2_min_tb + r.ue()
    s.max_transform_hierarchy_depth_inter = r.ue()
    s.max_transform_hierarchy_depth_intra = r.ue()
    s.scaling_list_enabled = r.get_onebit()
    if s.scaling_list_enabled:
        raise NotImplementedError("SPS scaling lists (reference parity)")
    s.amp_enabled = r.get_onebit()
    s.sao_enabled = r.get_onebit()
    s.pcm_enabled = r.get_onebit()
    if s.pcm_enabled:
        raise NotImplementedError("PCM")
    n_rps = r.ue()
    # QUIRK: the reference parses rps[0] unconditionally, even when
    # num_short_term_ref_pic_sets == 0 (sps_short_term_ref_pic_set,
    # h265.cpp:487-495) — streams must carry a dummy nopred set
    rps = [_st_rps_nopred(r)]
    for i in range(1, n_rps):
        if r.get_onebit():
            rps.append(_st_rps_pred(r, rps[-1]))
        else:
            rps.append(_st_rps_nopred(r))
    s.short_term_rps = tuple(rps[: n_rps])
    s.long_term_ref_pics_present = r.get_onebit()
    if s.long_term_ref_pics_present:
        raise NotImplementedError("long-term ref pics")
    s.temporal_mvp_enabled = r.get_onebit()
    s.strong_intra_smoothing = r.get_onebit()
    # vui / extensions ignored
    return s


def parse_pps(r: BitReader) -> Pps:
    """pic_parameter_set (h265.cpp:627-720 shape)."""
    p = Pps()
    p.id = r.ue()
    p.sps_id = r.ue()
    p.dependent_slice_segments_enabled = r.get_onebit()
    p.output_flag_present = r.get_onebit()
    r.get_bits(3)  # num_extra_slice_header_bits
    p.sign_data_hiding = r.get_onebit()
    p.cabac_init_present = r.get_onebit()
    p.num_ref_idx_l0_default = r.ue() + 1
    p.num_ref_idx_l1_default = r.ue() + 1
    # QUIRK: the reference reads init_qp_minus26 as ue(v), not the
    # spec's se(v) (pic_parameter_set, h265.cpp:668) — replicated
    p.init_qp = r.ue() + 26
    p.constrained_intra_pred = r.get_onebit()
    p.transform_skip_enabled = r.get_onebit()
    p.cu_qp_delta_enabled = r.get_onebit()
    if p.cu_qp_delta_enabled:
        p.diff_cu_qp_delta_depth = r.ue()
    p.cb_qp_offset = r.se()
    p.cr_qp_offset = r.se()
    p.slice_chroma_qp_offsets_present = r.get_onebit()
    p.weighted_pred = r.get_onebit()
    p.weighted_bipred = r.get_onebit()
    p.transquant_bypass_enabled = r.get_onebit()
    p.tiles_enabled = r.get_onebit()
    p.entropy_coding_sync_enabled = r.get_onebit()
    if p.tiles_enabled:
        raise NotImplementedError("tiles (decoded sequentially by the "
                                  "reference; parse TBD)")
    p.loop_filter_across_slices = r.get_onebit()
    p.deblocking_filter_control_present = r.get_onebit()
    if p.deblocking_filter_control_present:
        p.deblocking_filter_override_enabled = r.get_onebit()
        p.deblocking_filter_disabled = r.get_onebit()
        if not p.deblocking_filter_disabled:
            p.beta_offset_div2 = r.se()
            p.tc_offset_div2 = r.se()
    if r.get_onebit():  # pps_scaling_list_data_present
        raise NotImplementedError("PPS scaling lists")
    p.lists_modification_present = r.get_onebit()
    p.log2_parallel_merge_level = r.ue() + 2
    p.slice_segment_header_extension_present = r.get_onebit()
    r.get_onebit()  # pps_extension_flag
    return p


@dataclasses.dataclass
class SliceHeader:
    """h265d_slice_header_body_t subset for the implemented profile."""

    nal_type: int = 19
    first_slice: int = 1
    slice_addr: int = 0
    pps_id: int = 0
    slice_type: int = 2
    slice_qpy: int = 26
    cabac_init_flag: int = 0
    poc: int = 0
    qpc_delta: tuple = (0, 0)
    deblocking_disabled: int = 1
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    num_ref_idx_minus1: list = dataclasses.field(
        default_factory=lambda: [0, 0])
    ref_list: list = dataclasses.field(
        default_factory=lambda: [[], []])  # [lx][i] = (poc, frame_idx)
    max_num_merge_cand: int = 5
    mvd_l1_zero: int = 0
    temporal_mvp: int = 0
    colocated_from_l0: int = 0
    collocated_ref_idx: int = 0


def parse_slice_header(r: BitReader, nal_type: int, dec,
                       sps_store, pps_store) -> SliceHeader:
    """slice_header (h265.cpp:913-938 + slice_header_body :858-911);
    ends with the reference's alignment skip (skip `not_aligned_bits`
    or a full byte when already aligned, h265.cpp:935-936)."""
    h = SliceHeader(nal_type=nal_type)
    h.ref_list = dec.ref_list_state  # persistent stale-entry storage
    h.first_slice = r.get_onebit()
    if 16 <= nal_type <= 23:
        r.get_onebit()  # no_output_of_prior_pics_flag
    h.pps_id = r.ue()
    pps = pps_store[h.pps_id]
    sps = sps_store[pps.sps_id]
    h.slice_addr = 0
    dependent = 0
    if not h.first_slice:
        # slice segment address (h265.cpp:910-917). Mid-row segment
        # starts are excluded: the reference derives the segment's
        # chroma base as luma_offset >> 1 (h265.cpp:4786), which lands
        # 8px left / across row boundaries in linear NV12 memory — not
        # representable on planar planes.
        if pps.dependent_slice_segments_enabled:
            dependent = r.get_onebit()
        log2 = sps.log2_ctb
        cols = (sps.pic_width + (1 << log2) - 1) >> log2
        rows = (sps.pic_height + (1 << log2) - 1) >> log2
        # the reference's "log2ceil" is floor(log2)+1 == bit_length
        # (h265.cpp:523-534)
        nbits = (cols * rows).bit_length()
        h.slice_addr = r.get_bits(nbits)
        if h.slice_addr % cols:
            raise NotImplementedError(
                "mid-row slice segment start (reference chroma-base bug)")
    if dependent:
        # dependent slice segment (h265.cpp:919): the header BODY is not
        # parsed — the previous segment's body stays in effect (stale
        # h265d_slice_header_body_t). Decode then restarts exactly like
        # an independent segment: slice_data runs the full ctu_init
        # (fresh CABAC engine+contexts, all neighbors reset,
        # idx_in_slice=0 — h265.cpp:4751-4799) at the new address.
        prev = dec.prev_hdr
        if prev is None:
            raise ValueError("dependent segment without a prior slice")
        h = dataclasses.replace(
            prev, nal_type=nal_type, first_slice=0,
            slice_addr=h.slice_addr, pps_id=h.pps_id)
        # alignment: skip to boundary, or a whole byte if aligned
        misalign = (-r._pos) % 8
        r.skip_bits(misalign if misalign else 8)
        dec.prev_hdr = h
        return h
    h.slice_type = r.ue()
    if pps.output_flag_present:
        r.get_onebit()
    if nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP):
        dec.poc_lsb = 0
        dec.poc_msb = 0
        h.poc = 0
        rps = None
    else:
        # slice_header_nonidr (h265.cpp:752-780) + POC update
        lsb = r.get_bits(sps.log2_max_poc_lsb)
        max_lsb_div2 = 1 << (sps.log2_max_poc_lsb - 1)
        prev = dec.poc_lsb
        if lsb < prev and max_lsb_div2 <= prev - lsb:
            dec.poc_msb += 1
        elif prev < lsb and max_lsb_div2 < lsb - prev:
            dec.poc_msb -= 1
        dec.poc_lsb = lsb
        h.poc = (dec.poc_msb << sps.log2_max_poc_lsb) + lsb
        if r.get_onebit():  # short_term_ref_pic_set_sps_flag
            idx = 0
            n = len(sps.short_term_rps)
            if n > 1:
                # QUIRK: the reference's log2ceil is bit-length
                # (h265.cpp:523-534): 16 sets -> 5 index bits
                idx = r.get_bits(n.bit_length())
            rps = sps.short_term_rps[idx]
        else:
            # slice-local RPS (slice_header_short_term_ref_pic_set,
            # h265.cpp:722-730): inter-predicted against an SPS set or
            # parsed standalone
            n = len(sps.short_term_rps)
            if r.get_onebit():  # inter_ref_pic_set_prediction_flag
                delta_idx_minus1 = r.ue()
                if delta_idx_minus1 >= n:
                    # the reference range-checks against ref_num
                    # INCLUSIVE (h265.cpp:725) — delta == ref_num
                    # indexes set[-1], out of bounds (UB domain)
                    raise NotImplementedError(
                        "slice RPS delta_idx out of range (reference "
                        "reads sps set[-1] — UB)")
                rps = _st_rps_pred(
                    r, sps.short_term_rps[n - delta_idx_minus1 - 1])
            else:
                rps = _st_rps_nopred(r)
        h.temporal_mvp = r.get_onebit() if sps.temporal_mvp_enabled else 0
    if sps.sao_enabled:
        h.sao_luma = r.get_onebit()
        h.sao_chroma = r.get_onebit()
    if h.slice_type != 2:
        # slice_header_nonintra (h265.cpp:826-857)
        if r.get_onebit():  # num_ref_idx override
            h.num_ref_idx_minus1[0] = r.ue()
            if h.slice_type == 0:
                h.num_ref_idx_minus1[1] = r.ue()
        else:
            h.num_ref_idx_minus1 = [pps.num_ref_idx_l0_default - 1,
                                    pps.num_ref_idx_l1_default - 1]
        if pps.lists_modification_present and rps.total_curr > 1:
            raise NotImplementedError("ref list modification")
        _init_ref_pic_list(h, rps, dec)
        if h.slice_type == 0:
            h.mvd_l1_zero = r.get_onebit()
        if pps.cabac_init_present:
            h.cabac_init_flag = r.get_onebit()
        if h.temporal_mvp:
            # colocated refs (h265.cpp:841-849)
            col_l0 = r.get_onebit() if h.slice_type == 0 else 1
            h.colocated_from_l0 = col_l0
            if col_l0 and h.num_ref_idx_minus1[0] > 0:
                h.collocated_ref_idx = r.ue()
            elif not col_l0 and h.num_ref_idx_minus1[1] > 0:
                h.collocated_ref_idx = r.ue()
        if (h.slice_type == 0 and pps.weighted_bipred) or \
                (h.slice_type == 1 and pps.weighted_pred):
            raise NotImplementedError("weighted prediction")
        h.max_num_merge_cand = 5 - r.ue()
    h.slice_qpy = pps.init_qp + r.se()
    cb_off, cr_off = 0, 0
    if pps.slice_chroma_qp_offsets_present:
        cb_off = r.se()
        cr_off = r.se()
    h.qpc_delta = (cb_off + pps.cb_qp_offset, cr_off + pps.cr_qp_offset)
    h.deblocking_disabled = pps.deblocking_filter_disabled
    # QUIRK: slice beta/tc offsets are only assigned in the override
    # branch (slice_header_body, h265.cpp:896-903) of the PERSISTENT
    # header struct; slices without an override (or whose override
    # disables the filter) inherit whatever an earlier slice set —
    # zero-initialized at start, never reset. The PPS offsets are
    # parsed but never reach the filter.
    if pps.deblocking_filter_override_enabled:
        if r.get_onebit():  # deblocking_filter_override_flag
            h.deblocking_disabled = r.get_onebit()
            if not h.deblocking_disabled:
                dec.stale_deblock_offsets = (r.se(), r.se())
    h.beta_offset_div2, h.tc_offset_div2 = dec.stale_deblock_offsets
    # slice_loop_filter_across_slices (h265.cpp:902-906): parsed but
    # never consumed by the reference's filters — parse-and-discard
    if pps.loop_filter_across_slices and (
            h.sao_luma or h.sao_chroma or not h.deblocking_disabled):
        r.get_onebit()
    # byte alignment: skip to boundary, or a whole byte if aligned
    misalign = (-r._pos) % 8
    r.skip_bits(misalign if misalign else 8)
    dec.prev_hdr = h
    return h


def _init_ref_pic_list(h, rps, dec):
    """init_ref_pic_list (h265.cpp:807-824).

    QUIRKS mirrored: the first per-iteration fill always writes from
    list offset 0 (`list[lx]`, not `list[lx] + idx`); entries whose
    used_by_curr bit is 0 are counted but never written, leaving the
    previous slice's values in place (persistent dec.ref_list_state)."""
    def find_frame_idx(poc):
        for p, fi, _ in dec.dpb:
            if p == poc:
                return fi
        return dec.dpb[0][1] if dec.dpb else 0

    sides = ((rps.neg, rps.used_neg), (rps.pos, rps.used_pos))
    for lx in (0, 1):
        num_tmp = max(h.num_ref_idx_minus1[lx] + 1, rps.total_curr)
        lst = dec.ref_list_state[lx]

        def fill(side, base, rest):
            deltas, used = sides[side]
            i = 0
            while i < len(deltas) and i < rest:
                if (used >> i) & 1:
                    poc = h.poc + deltas[i]
                    lst[base + i] = (poc, find_frame_idx(poc))
                i += 1
            return i

        idx = 0
        while idx < num_tmp:
            idx += fill(lx, 0, num_tmp - idx)
            idx += fill(lx ^ 1, idx, num_tmp - idx)
        h.ref_list[lx] = lst


class H265Decoder:
    """NAL walker + parameter sets + CTU decode (h265d_data_t parity).

    Implemented decode profile: single-slice IDR intra pictures, SAO and
    deblocking disabled; residual decode lands next (ctu.py)."""

    def __init__(self, device=None):
        #: where the torch backends run Phase B (None: the CUDA device,
        #: resolved at first use; tests pass "cpu")
        self.device = device
        self.vps = None
        self.sps_store = {}
        self.pps_store = {}
        self.pool = None  # 8-frame pool (H265D_MAX_FRAME_NUM)
        self._ctu = None  # persistent h265d_ctu_t equivalent
        self._cur = None
        self.lru = [0] * 8
        self.dpb = []  # (poc, frame_idx, is_idr), POC-sorted
        self.poc_lsb = 0
        self.poc_msb = 0
        # persistent h2d ref_list storage (stale-entry quirk)
        self.ref_list_state = [[(0, 0)] * 16, [(0, 0)] * 16]
        # last fully-parsed slice header (dependent segments inherit it)
        self.prev_hdr = None
        # persistent slice_beta/tc_offset_div2 (only assigned in the
        # override branch of the reference's long-lived header struct)
        self.stale_deblock_offsets = (0, 0)

    def set_data(self, data: bytes):
        self.data = bytes(data)
        self.offs = find_start_codes(self.data)

    def _nal_payloads(self):
        for k, off in enumerate(self.offs):
            start = int(off) + 3
            end = int(self.offs[k + 1]) if k + 1 < len(self.offs) \
                else len(self.data)
            nal_type = (self.data[start] >> 1) & 0x3F
            yield nal_type, unescape_nal(self.data[start + 2 : end])

    def parse_headers(self):
        """Walk NALs and ingest VPS/SPS/PPS; returns parsed-type list."""
        seen = []
        for nal_type, payload in self._nal_payloads():
            r = BitReader(payload)
            if nal_type == NAL_VPS:
                self.vps = parse_vps(r)
            elif nal_type == NAL_SPS:
                s = parse_sps(r)
                self.sps_store[s.id] = s
            elif nal_type == NAL_PPS:
                p = parse_pps(r)
                self.pps_store[p.id] = p
            seen.append(nal_type)
        return seen

    def _find_empty_frame(self):
        """find_empty_frame LRU (h265.cpp:180-204)."""
        in_dpb = {fi for _, fi, _ in self.dpb}
        for i in range(len(self.pool)):
            self.lru[i] = 0 if i in in_dpb else self.lru[i] + 1
        best = max(range(len(self.pool)), key=lambda i: (self.lru[i],
                                                         -i))
        self.lru[best] = 0
        return best

    def _insert_dpb(self, frame_idx, poc, is_idr, out, emit):
        """insert_dpb (h265.cpp:4931-4951): POC-sorted, max 16."""
        if 16 <= len(self.dpb):
            emit(self.dpb.pop(0)[1], out)
        import bisect

        pocs = [e[0] for e in self.dpb]
        self.dpb.insert(bisect.bisect_right(pocs, poc),
                        (poc, frame_idx, is_idr))

    # ---------------------------------------------------------------
    # incremental vtable API (m2d_func_table_t parity): begin_decode +
    # decode_picture + peek/get; decode_all below drives the same loop
    # ---------------------------------------------------------------

    def begin_decode(self, collect_plans=False, keep_oracle=False,
                     backend=None, defer_recon=False):
        """Arm the incremental decode (pull-mode vtable API). Must be
        called after set_data; decode_picture() then processes one slice
        NAL per call (the reference h265d_decode_picture returns per
        slice_layer, h265.cpp:4898-4920).

        defer_recon (backend="native" only): Phase A runs WITHOUT any
        reconstruction — plans accumulate and DPB output events record
        frame-pool indexes (pop_decoded_index) for an external batched
        Phase B (runtime/turbo.TurboH265Decoder)."""
        self._cfg_collect = collect_plans or backend == "torch"
        self._cfg_oracle = keep_oracle
        self._cfg_backend = backend
        self._cfg_defer = bool(defer_recon)
        self._idxq = []
        self._nal_list = []
        for k, off in enumerate(self.offs):
            start = int(off) + 3
            end = (int(self.offs[k + 1]) if k + 1 < len(self.offs)
                   else len(self.data))
            if end > start + 1:
                self._nal_list.append(
                    ((self.data[start] >> 1) & 0x3F, start, end))
        self.nal_i = 0
        self._outq = []
        # keep geometry across re-arms (checkpoint resume: the pool is
        # already allocated, so the first-slice geometry branch is
        # skipped)
        self._geom = getattr(self, "_geom", {})
        self.plans = []
        self._rec = None
        self._sess = getattr(self, "_sess", None)
        self._eos_done = False

    # -- deferred per-picture finalization (runs on the NEXT picture's
    # -- first slice, or at end of stream) ---------------------------
    def _finish_plan(self):
        import numpy as np

        if self._rec is None:
            return
        plan = self._rec.finalize()
        if self._cfg_oracle:
            f = self.pool[plan.cur_idx]
            plan.oracle = (f["y"].copy(), f["cb"].copy(), f["cr"].copy())
        if self._cfg_backend == "torch" and (
                not plan.multi_slice
                or (plan.slice_aligned and len(plan.slice_rows) > 1)):
            from m2dec_tpu_torch.codecs.h265 import reconstruct as _RC

            # Phase B needs the pool as it was at picture START: other
            # frames are untouched by this picture's Phase A, but
            # pool[cur] was reconstructed in place — substitute the
            # pre-picture snapshot (stale padding-domain reads depend
            # on it)
            py = np.stack([f["y"] for f in self.pool])
            pcb = np.stack([f["cb"] for f in self.pool])
            pcr = np.stack([f["cr"] for f in self.pool])
            f = self.pool[plan.cur_idx]
            py[plan.cur_idx] = self._pre_pic[0]
            pcb[plan.cur_idx] = self._pre_pic[1]
            pcr[plan.cur_idx] = self._pre_pic[2]
            y, cb, cr = _RC.recon_plan(plan, py, pcb, pcr,
                                       device=self.device)
            f["y"][:] = y.cpu().numpy()
            f["cb"][:] = cb.cpu().numpy()
            f["cr"][:] = cr.cpu().numpy()
        self.plans.append(plan)
        self._rec = None

    def _finish_native(self):
        import numpy as np

        if self._sess is None or self._sess.plan is None:
            return
        plan = self._sess.finish_picture()
        if getattr(self, "_cfg_defer", False):
            self.plans.append(plan)
            return
        from m2dec_tpu_torch.codecs.h265 import reconstruct as _RC

        py = np.stack([f["y"] for f in self.pool])
        pcb = np.stack([f["cb"] for f in self.pool])
        pcr = np.stack([f["cr"] for f in self.pool])
        y, cb, cr = _RC.recon_plan(plan, py, pcb, pcr, device=self.device)
        f = self.pool[plan.cur_idx]
        f["y"][:] = y.cpu().numpy()
        f["cb"][:] = cb.cpu().numpy()
        f["cr"][:] = cr.cpu().numpy()
        self.plans.append(plan)

    def _emit(self, frame_idx, out_list=None):
        from m2dec_tpu_torch.codecs.mpeg2.decoder import DecodedFrame

        f = self.pool[frame_idx]
        geom = self._geom
        if getattr(self, "_cfg_defer", False):
            # no pixel copies: the overlapped driver materializes from
            # its Phase-B batches; record the pool index alongside
            frm = DecodedFrame(
                y=None, cb=None, cr=None, width=geom["w"],
                height=geom["h"], crop=geom["crop"], cnt=f["poc"])
            if out_list is None:
                self._outq.append(frm)
                self._idxq.append(frame_idx)
            else:
                out_list.append(frm)
            return
        frm = DecodedFrame(
            y=f["y"].copy(), cb=f["cb"].copy(), cr=f["cr"].copy(),
            width=geom["w"], height=geom["h"], crop=geom["crop"],
            cnt=f["poc"])
        (self._outq if out_list is None else out_list).append(frm)

    def decode_picture(self):
        """Process NALs until one slice completes (1), or end of stream
        (-1, after which peek/get(is_end=True) drain the DPB)."""
        import numpy as np

        from m2dec_tpu_torch.bitstream.reader import BitstreamExhausted
        from m2dec_tpu_torch.codecs.h265.ctu import Ctu
        from m2dec_tpu_torch.codecs.h265.sao import sao_oneframe

        if not hasattr(self, "_nal_list"):
            self.begin_decode()
        backend = self._cfg_backend
        try:
            while self.nal_i < len(self._nal_list):
                nal_type, start, end = self._nal_list[self.nal_i]
                self.nal_i += 1
                payload = unescape_nal(self.data[start + 2 : end])
                r = BitReader(payload)
                if nal_type == NAL_VPS:
                    self.vps = parse_vps(r)
                elif nal_type == NAL_SPS:
                    s = parse_sps(r)
                    self.sps_store[s.id] = s
                elif nal_type == NAL_PPS:
                    p = parse_pps(r)
                    self.pps_store[p.id] = p
                elif nal_type in (NAL_TRAIL_N, NAL_TRAIL_R,
                                  NAL_IDR_W_RADL, NAL_IDR_N_LP):
                    self._decode_slice_nal(nal_type, r, np, Ctu,
                                           sao_oneframe)
                    return 1
        except BitstreamExhausted:
            # mid-slice truncation: the reference longjmps out of the
            # parse (setjmp at h265.cpp:4904) and abandons the picture
            return -2
        if not self._eos_done:
            self._finish_plan()
            self._finish_native()
            self._eos_done = True
        return -1

    def _decode_slice_nal(self, nal_type, r, np, Ctu, sao_oneframe):
        backend = self._cfg_backend
        hdr = parse_slice_header(r, nal_type, self, self.sps_store,
                                 self.pps_store)
        pps = self.pps_store[hdr.pps_id]
        sps = self.sps_store[pps.sps_id]
        log2 = sps.log2_ctb
        cols = (sps.pic_width + (1 << log2) - 1) >> log2
        rows = (sps.pic_height + (1 << log2) - 1) >> log2
        w, hgt = cols << log2, rows << log2
        if self.pool is None:
            from m2dec_tpu_torch.codecs.h265.colpics import make_colpic

            self.pool = [{
                "y": np.zeros((hgt, w), np.uint8),
                "cb": np.zeros((hgt >> 1, w >> 1), np.uint8),
                "cr": np.zeros((hgt >> 1, w >> 1), np.uint8),
                "poc": 0,
                "colpic": make_colpic(sps.pic_width, sps.pic_height),
                "fidx": [[0] * 16, [0] * 16],
            } for _ in range(8)]
            self._geom["w"], self._geom["h"] = w, hgt
            self._geom["crop"] = (
                sps.cropping[0],
                w - sps.pic_width + sps.cropping[1],
                sps.cropping[2],
                hgt - sps.pic_height + sps.cropping[3])
        is_idr = nal_type in (NAL_IDR_W_RADL, NAL_IDR_N_LP)
        if backend == "native":
            if hdr.first_slice or self._cur is None:
                self._finish_native()
                self._cur = self._find_empty_frame()
                if self._sess is None or self._sess.sps is not sps:
                    from m2dec_tpu_torch.codecs.h265.native_session import (
                        NativeH265Session,
                    )

                    self._sess = NativeH265Session(sps)
                self._sess.begin_picture(self._cur)
            cur = self._cur
            self.pool[cur]["poc"] = hdr.poc
            with trace.span("phase_a.slice"):
                self._sess.run_slice(hdr, pps, sps, r, self.pool, cur,
                                     hdr.first_slice)
            self._insert_dpb(cur, hdr.poc, is_idr, None, self._emit)
            return
        # find_empty_frame only on the first slice segment of a
        # picture (h265.cpp:4852-4854); later segments reuse it
        if hdr.first_slice or self._cur is None:
            self._finish_plan()
            self._cur = self._find_empty_frame()
            if backend == "torch":
                f0 = self.pool[self._cur]
                self._pre_pic = (f0["y"].copy(), f0["cb"].copy(),
                                 f0["cr"].copy())
        cur = self._cur
        frame = self.pool[cur]
        frame["poc"] = hdr.poc
        if self._ctu is None or self._ctu.sps is not sps:
            self._ctu = Ctu(sps, pps, hdr, frame)
        else:
            self._ctu.init_slice(pps, hdr, frame)
        ctu = self._ctu
        if self._cfg_collect:
            if self._rec is None:
                from m2dec_tpu_torch.codecs.h265.plan import PlanRecorder

                self._rec = PlanRecorder(ctu, cur)
                self._rec.plan.poc = hdr.poc
            else:
                self._rec.note_slice(hdr.first_slice, hdr.slice_addr)
                self._rec.ctu = ctu
            ctu.rec = self._rec
        else:
            ctu.rec = None
        ctu.ref_frames = self.pool
        from m2dec_tpu_torch.codecs.h265.colpics import Colpics

        ctu.colpics = Colpics(ctu, self.pool, cur)
        ctu.cb.init_engine(r)
        while True:
            ctu.decode_ctu(r)
            if ctu.pos_increment():
                break
            if ctu.cb.terminate(r):
                break
        sao_oneframe(ctu)
        self._insert_dpb(cur, hdr.poc, is_idr, None, self._emit)

    def peek_decoded_frame(self, is_end=False):
        """h265d_peek_decoded_frame parity: pending overflow emissions
        first; with is_end the POC-sorted DPB drains."""
        if self._outq:
            return 1, self._outq[0]
        if is_end and self.dpb:
            from m2dec_tpu_torch.codecs.mpeg2.decoder import DecodedFrame

            f = self.pool[self.dpb[0][1]]
            geom = self._geom
            return 1, DecodedFrame(
                y=f["y"].copy(), cb=f["cb"].copy(), cr=f["cr"].copy(),
                width=geom["w"], height=geom["h"], crop=geom["crop"],
                cnt=f["poc"])
        return 0, None

    def pop_decoded_index(self, is_end=False):
        """Defer-mode event pop: (frame_idx, DecodedFrame meta without
        pixels). -1 when nothing is ready."""
        from m2dec_tpu_torch.codecs.mpeg2.decoder import DecodedFrame

        if self._outq:
            frm = self._outq.pop(0)
            return self._idxq.pop(0), frm
        if is_end and self.dpb:
            poc, fi, _ = self.dpb.pop(0)
            geom = self._geom
            return fi, DecodedFrame(
                y=None, cb=None, cr=None, width=geom["w"],
                height=geom["h"], crop=geom["crop"],
                cnt=self.pool[fi]["poc"])
        return -1, None

    def get_decoded_frame(self, is_end=False):
        ready, frm = self.peek_decoded_frame(is_end)
        if ready:
            if self._outq:
                self._outq.pop(0)
            elif is_end and self.dpb:
                self.dpb.pop(0)
        return ready, frm

    # ------------------------------------------------- checkpoint ---
    def stream_pos(self) -> int:
        """Byte offset of the first undecoded start code (vtable
        stream_pos parity, m2d.h:69)."""
        if hasattr(self, "_nal_list") and self.nal_i < len(self._nal_list):
            return self._nal_list[self.nal_i][1] - 3
        return len(getattr(self, "data", b""))

    def __getstate__(self):
        """Picture-boundary checkpoint (SURVEY §5.4, default Python
        decode path): parameter sets, frame pool, DPB, POC state, the
        persistent CTU context (its sao/deblock/coeff caches carry
        reference stale-read quirks) — minus the input buffer and the
        native/plan transients."""
        d = self.__dict__.copy()
        for k in ("data", "offs", "_nal_list"):
            d.pop(k, None)
        d["nal_i"] = 0
        d["_sess"] = None
        d["_rec"] = None
        d["_outq"] = []
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)

    def decode_all(self, collect_plans=False, keep_oracle=False,
                   backend=None):
        """Decode every slice NAL; returns DecodedFrames in output order
        (DPB POC-sorted pops, h265.cpp:4953-5008).

        With ``collect_plans`` the Phase-A plan recorder taps the decode
        and the per-picture H265Plan list lands in ``self.plans``
        (decode order); ``keep_oracle`` additionally snapshots each
        picture's reconstructed planes for differential tests.

        ``backend="torch"``: every completed picture is reconstructed by
        the torch Phase B (codecs/h265/reconstruct.py, on the decoder's
        ``device``) from its plan and the frame pool, and the pool frame
        is replaced with the Phase-B product — the emitted output is the
        torch path's.
        Multi-slice pictures keep the Python reconstruction (the
        reference runs its whole-frame SAO pass once per slice
        segment).

        ``backend="native"``: the full two-phase engine — the C++ Phase
        A (native/h265parse.cpp) entropy-decodes each slice into plan
        tensors and the torch Phase B reconstructs; the Python CTU decoder
        never runs. Single-slice pictures only (Phase-B restriction)."""
        self.begin_decode(collect_plans, keep_oracle, backend)
        out = []
        while True:
            err = self.decode_picture()
            ready, frm = self.peek_decoded_frame()
            while ready:
                self.get_decoded_frame()
                out.append(frm)
                ready, frm = self.peek_decoded_frame()
            if err < 0:
                ready, frm = self.peek_decoded_frame(True)
                while ready:
                    self.get_decoded_frame(True)
                    out.append(frm)
                    ready, frm = self.peek_decoded_frame(True)
                return out
