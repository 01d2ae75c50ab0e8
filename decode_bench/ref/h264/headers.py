"""H.264 parameter-set and slice-header parsing.

Mirrors the reference parsers exactly (reference: src/lib/h264.cpp:307-363
SPS incl. the High-profile extension ordering, :408-442 PPS with the
more_rbsp_data-gated trailing fields, :1417-1581 slice header), including
its quirks:

* High-profile scaling lists are *parsed and discarded* (flat matrices are
  always used, h264.cpp:254-272 scaling_list stores nothing);
* the PPS `pic_scaling_list_present_flag` body is empty (h264.cpp:437-438) —
  streams with PPS scaling lists are unsupported by the reference;
* MPEG-style level->DPB sizing (max_dpb_mbs, h264.cpp:191-246).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from decode_bench.ref.bitstream import BitReader, BitstreamError

# NAL unit types (h264.h:54-66)
SLICE_NONIDR_NAL = 1
SLICE_IDR_NAL = 5
SEI_NAL = 6
SPS_NAL = 7
PPS_NAL = 8
AUDELIM_NAL = 9

P_SLICE, B_SLICE, I_SLICE, SP_SLICE, SI_SLICE = 0, 1, 2, 3, 4

_MAX_DPB_MBS = {
    10: 396, 11: 900, 12: 2376, 13: 2376, 20: 2376, 21: 4752,
    22: 8100, 30: 8100, 31: 18000, 32: 20480, 40: 32768, 41: 32768,
    42: 34816, 50: 110400, 51: 184320,
}

_HIGH_PROFILES = frozenset([44, 83, 86, 100, 110, 118, 128, 122, 244])


@dataclasses.dataclass
class Sps:
    profile_idc: int = 0
    level_idc: int = 0
    constraint_set_flag: int = 0
    is_high_profile: bool = False
    log2_max_frame_num: int = 4
    poc_type: int = 0
    log2_max_poc_lsb: int = 4
    delta_pic_order_always_zero_flag: int = 0
    offset_for_non_ref_pic: int = 0
    offset_for_top_to_bottom_field: int = 0
    num_ref_frames_in_pic_order_cnt_cycle: int = 0
    offset_for_ref_frame: tuple = ()
    num_ref_frames: int = 1
    gaps_in_frame_num_value_allowed_flag: int = 0
    pic_width: int = 0
    pic_height: int = 0
    max_dpb_in_mbs: int = 396
    frame_mbs_only_flag: int = 1
    mb_adaptive_frame_field_flag: int = 0
    direct_8x8_inference_flag: int = 0
    frame_cropping_flag: int = 0
    frame_crop: tuple = (0, 0, 0, 0)


@dataclasses.dataclass
class Pps:
    seq_parameter_set_id: int = 0
    entropy_coding_mode_flag: int = 0
    pic_order_present_flag: int = 0
    num_ref_idx_l0_active_minus1: int = 0
    num_ref_idx_l1_active_minus1: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_idc: int = 0
    pic_init_qp: int = 26
    pic_init_qs: int = 26
    chroma_qp_index: tuple = (0, 0)
    deblocking_filter_control_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    redundant_pic_cnt_present_flag: int = 0
    transform_8x8_mode_flag: int = 0


def _scaling_list(r: BitReader, size: int):
    """Parse-and-discard (reference h264.cpp:254-272)."""
    last, nxt = 8, 8
    for i in range(size):
        if nxt != 0:
            delta = r.se()
            if not -128 <= delta <= 127:
                raise BitstreamError("delta_scale out of range")
            nxt = (last + delta + 256) & 255
        last = last if nxt == 0 else nxt


def parse_sps(r: BitReader, sps_store: dict) -> int:
    """read_seq_parameter_set (h264.cpp:307-363). Returns sps_id."""
    profile_idc = r.get_bits(8)
    constraint = r.get_bits(8)
    level_idc = r.get_bits(8)
    sps_id = r.ue()
    if sps_id > 31:
        raise BitstreamError("sps_id out of range")
    sps = Sps(profile_idc=profile_idc, constraint_set_flag=constraint,
              level_idc=level_idc)
    sps.is_high_profile = profile_idc in _HIGH_PROFILES
    if sps.is_high_profile:
        # chroma_format etc (h264.cpp:274-305)
        chroma_idc = r.ue()
        if chroma_idc == 3:
            r.get_onebit()
        r.ue()  # bit_depth_luma_minus8
        r.ue()  # bit_depth_chroma_minus8
        r.get_onebit()  # qpprime_y_zero_transform_bypass
        if r.get_onebit():  # seq_scaling_matrix_present
            for _ in range(6):
                if r.get_onebit():
                    _scaling_list(r, 16)
            for _ in range(8 if chroma_idc != 3 else 12):
                if r.get_onebit():
                    _scaling_list(r, 64)
    sps.log2_max_frame_num = r.ue() + 4
    sps.poc_type = r.ue()
    if sps.poc_type == 0:
        sps.log2_max_poc_lsb = r.ue() + 4
    elif sps.poc_type == 1:
        sps.delta_pic_order_always_zero_flag = r.get_onebit()
        sps.offset_for_non_ref_pic = r.se()
        sps.offset_for_top_to_bottom_field = r.se()
        n = r.ue()
        sps.num_ref_frames_in_pic_order_cnt_cycle = n
        # cumulative offsets (h264.cpp:181-189)
        acc, offs = 0, []
        for _ in range(n):
            acc += r.se()
            offs.append(acc)
        sps.offset_for_ref_frame = tuple(offs) + (0,) * (256 - len(offs))
    sps.num_ref_frames = r.ue()
    sps.gaps_in_frame_num_value_allowed_flag = r.get_onebit()
    sps.pic_width = (r.ue() + 1) * 16
    sps.pic_height = (r.ue() + 1) * 16
    # int16 store (h264.h:151): levels >= 4.0 wrap negative, which the
    # reference's set_dpb_max then pushes through an int/uint32 division
    # (see Dpb.set_max); replicate the narrowing here.
    _m = _MAX_DPB_MBS.get(
        10 if (sps.level_idc == 9 and profile_idc == 100) else sps.level_idc, -1
    )
    sps.max_dpb_in_mbs = ((_m + 0x8000) & 0xFFFF) - 0x8000
    sps.frame_mbs_only_flag = r.get_onebit()
    if not sps.frame_mbs_only_flag:
        sps.mb_adaptive_frame_field_flag = r.get_onebit()
    sps.direct_8x8_inference_flag = r.get_onebit()
    sps.frame_cropping_flag = r.get_onebit()
    if sps.frame_cropping_flag:
        sps.frame_crop = tuple(r.ue() * 2 for _ in range(4))
    # vui_parameters: parse-and-skip is safe since NAL boundaries are found
    # by start-code scan (reference parses fully; nothing it stores affects
    # decoded samples)
    sps_store[sps_id] = sps
    return sps_id


def parse_pps(r: BitReader, pps_store: dict) -> int:
    """read_pic_parameter_set (h264.cpp:408-442)."""
    pps_id = r.ue()
    if pps_id > 255:
        raise BitstreamError("pps_id out of range")
    pps = Pps()
    pps.seq_parameter_set_id = r.ue()
    pps.entropy_coding_mode_flag = r.get_onebit()
    pps.pic_order_present_flag = r.get_onebit()
    if r.ue() != 0:
        raise BitstreamError("FMO not supported (reference parity)")
    pps.num_ref_idx_l0_active_minus1 = r.ue()
    pps.num_ref_idx_l1_active_minus1 = r.ue()
    pps.weighted_pred_flag = r.get_onebit()
    pps.weighted_bipred_idc = r.get_bits(2)
    pps.pic_init_qp = r.se() + 26
    pps.pic_init_qs = r.se() + 26
    qpc0 = r.se()
    pps.chroma_qp_index = (qpc0, qpc0)
    pps.deblocking_filter_control_present_flag = r.get_onebit()
    pps.constrained_intra_pred_flag = r.get_onebit()
    pps.redundant_pic_cnt_present_flag = r.get_onebit()
    if r.more_rbsp_data():
        pps.transform_8x8_mode_flag = r.get_onebit()
        if r.get_onebit():
            raise BitstreamError(
                "PPS scaling lists unsupported (reference parity, h264.cpp:437)"
            )
        pps.chroma_qp_index = (qpc0, r.se())
    pps_store[pps_id] = pps
    return pps_id
