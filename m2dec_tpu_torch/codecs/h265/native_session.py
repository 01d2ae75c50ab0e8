"""Native (C++) H.265 Phase-A session: drives native/h265parse.cpp.

The Python decoder keeps NAL walking, VPS/SPS/PPS/slice headers, POC,
RPS-derived ref lists and the DPB; this session owns the per-CTU slice
decode (CABAC, quad-tree, residual parse+dequant, merge/AMVP, deblock
edge recording, SAO parameter parse), filling H265Plan tensors directly
from C++ (zero-copy into the numpy buffers).  Pixels come from the torch
Phase B (reconstruct.py) — the native front end never reconstructs.
"""

from __future__ import annotations

import ctypes

import numpy as np

from m2dec_tpu_torch.codecs.h265.colpics import _scale
from m2dec_tpu_torch.codecs.h265.plan import H265Plan
from m2dec_tpu_torch.native import H265SliceParams, load_h265

_VOIDP = ctypes.c_void_p

#: native error codes -> the Python decoder's refusal domains
_ERRORS = {
    -3: "reference-indeterminate: P temporal merge candidate",
    -4: "reference-indeterminate: NxN inter (uninitialized lefttop)",
    -5: "cu_qp_delta",
    -10: "intra op capacity overflow",
}


class NativeH265Session:
    def __init__(self, sps):
        self.lib = load_h265()
        log2 = sps.log2_ctb
        self.cols = (sps.pic_width + (1 << log2) - 1) >> log2
        self.rows = (sps.pic_height + (1 << log2) - 1) >> log2
        self.ctb_log2 = log2
        self.sps = sps
        self.ctx = self.lib.h265p_new(self.cols, self.rows, log2,
                                      sps.pic_width, sps.pic_height)
        self.plan = None
        self._keep = None

    def __del__(self):
        if getattr(self, "ctx", None):
            self.lib.h265p_free(self.ctx)
            self.ctx = None

    # ------------------------------------------------------------------
    def begin_picture(self, cur_idx):
        plan = H265Plan(self.sps, self.cols, self.rows, self.ctb_log2)
        plan.cur_idx = cur_idx
        n_ctu = self.cols * self.rows
        capl = max(4, 1 << (2 * self.ctb_log2 - 4))
        capc = max(4, 1 << (2 * self.ctb_log2 - 6))
        self.opsl = np.zeros((n_ctu, capl, 7), np.int32)
        self.cntl = np.zeros(n_ctu, np.int32)
        self.opsc = np.zeros((n_ctu, capc, 7), np.int32)
        self.cntc = np.zeros(n_ctu, np.int32)
        arrays = [plan.coef_y, plan.coef_cb, plan.coef_cr, plan.tu_y,
                  plan.tu_cb, plan.tu_cr, plan.slot, plan.mv, self.opsl,
                  self.cntl, self.opsc, self.cntc, plan.dbv, plan.dbh,
                  plan.dbcv, plan.dbch]
        self._keep = arrays
        ptrs = (_VOIDP * len(arrays))(*[a.ctypes.data for a in arrays])
        self.lib.h265p_begin_picture(self.ctx, ptrs, capl, capc,
                                     cur_idx)
        self.plan = plan
        return plan

    # ------------------------------------------------------------------
    def run_slice(self, hdr, pps, sps, r, pool, cur_idx, first_slice):
        if not first_slice:
            p = self.plan
            p.multi_slice = True
            if hdr.slice_addr % p.columns:
                p.slice_aligned = False
            else:
                p.slice_rows.append(hdr.slice_addr // p.columns)
        sp = H265SliceParams()
        sp.slice_type = hdr.slice_type
        sp.slice_qpy = hdr.slice_qpy
        sp.cabac_init_flag = getattr(hdr, "cabac_init_flag", 0)
        sp.sao_luma = getattr(hdr, "sao_luma", 0)
        sp.sao_chroma = getattr(hdr, "sao_chroma", 0)
        sp.slice_addr = hdr.slice_addr
        sp.max_merge = getattr(hdr, "max_num_merge_cand", 5)
        sp.mvd_l1_zero = getattr(hdr, "mvd_l1_zero", 0)
        sp.temporal_mvp = getattr(hdr, "temporal_mvp", 0)
        sp.colocated_from_l0 = getattr(hdr, "colocated_from_l0", 1)
        sp.collocated_ref_idx = getattr(hdr, "collocated_ref_idx", 0)
        for lx in (0, 1):
            sp.num_ref_idx_minus1[lx] = hdr.num_ref_idx_minus1[lx]
        sp.deblock_disabled = int(hdr.deblocking_disabled)
        sp.beta_offset_div2 = hdr.beta_offset_div2
        sp.tc_offset_div2 = hdr.tc_offset_div2
        sp.qpc_delta[0] = hdr.qpc_delta[0]
        sp.qpc_delta[1] = hdr.qpc_delta[1]
        sp.sign_data_hiding = pps.sign_data_hiding
        sp.transform_skip = pps.transform_skip_enabled
        sp.cu_qp_delta = pps.cu_qp_delta_enabled
        sp.max_hier_intra = sps.max_transform_hierarchy_depth_intra
        sp.max_hier_inter = sps.max_transform_hierarchy_depth_inter
        sp.amp = sps.amp_enabled
        sp.log2_parallel_merge = pps.log2_parallel_merge_level
        sp.min_cb_log2 = sps.log2_min_cb
        sp.max_tb_log2 = sps.log2_max_tb
        sp.min_tb_log2 = sps.log2_min_tb
        sp.cb_qp_offset = pps.cb_qp_offset
        sp.cr_qp_offset = pps.cr_qp_offset
        sp.bit_offset = r.bitpos
        ref_list = getattr(hdr, "ref_list", [[(0, 0)] * 16] * 2)
        for lx in (0, 1):
            for i, (poc, fi) in enumerate(ref_list[lx][:16]):
                sp.ref_poc[lx * 16 + i] = poc
                sp.ref_fidx[lx * 16 + i] = fi
        # colpics scale tables (colpics.py Colpics.__init__, incl. the
        # register-curr-fidx-after-reading-colocated ordering quirk)
        col_l = sp.colocated_from_l0 ^ 1
        col_poc, col_frmidx = ref_list[col_l][sp.collocated_ref_idx]
        sp.col_page = col_frmidx & 7
        fidx_col = pool[col_frmidx & 7]["fidx"]
        for lx in (0, 1):
            for i in range(16):
                sp.fidx_col[lx * 16 + i] = fidx_col[lx][i] \
                    if i < len(fidx_col[lx]) else 0
        fidx_curr = [[e[1] & 7 for e in ref_list[lx]] for lx in (0, 1)]
        pool[cur_idx]["fidx"] = fidx_curr
        for lx in (0, 1):
            for i in range(16):
                sp.fidx_curr[lx * 16 + i] = fidx_curr[lx][i] \
                    if i < len(fidx_curr[lx]) else 0
        if hdr.slice_type < 2:
            poc = hdr.poc
            pocs = [pool[i]["poc"] for i in range(8)]
            for i in range(8):
                for j in range(8):
                    sp.colmv[i * 8 + j] = _scale(poc, pocs[i], col_poc,
                                                 pocs[j])
                    sp.tmv[i * 8 + j] = _scale(poc, pocs[i], poc,
                                               pocs[j])
            sp.lowdelay = int(all(p <= poc for p in pocs))
        payload = bytes(r.data)
        err = self.lib.h265p_slice(self.ctx, payload, len(payload),
                                   ctypes.byref(sp))
        if err == -2:
            # mid-slice truncation: reference refill-longjmp parity
            # (bitio.c:112-128) -> decode_picture returns -2
            from m2dec_tpu_torch.bitstream.reader import BitstreamExhausted

            raise BitstreamExhausted("native slice truncated")
        if err < 0:
            raise NotImplementedError(
                _ERRORS.get(err, f"native h265 slice error {err}"))
        self.plan.has_sao = bool(sp.sao_luma or sp.sao_chroma)

    # ------------------------------------------------------------------
    def finish_picture(self):
        plan = self.plan
        self.lib.h265p_finish(self.ctx, _p(plan.sao_idx),
                              _p(plan.sao_opt), _p(plan.sao_off))
        # pack z-ordered op lists (plan.py PlanRecorder.finalize):
        # stray-drop against the dense inter-cell mask, then bucket the
        # per-CTU capacity to a power of two
        inter_cell = (plan.slot[:, :, 0] >= 0) | (plan.slot[:, :, 1] >= 0)
        for ci in np.nonzero(self.cntl)[0]:
            ops = self.opsl[ci, : self.cntl[ci]]
            stray = (ops[:, 0] & 2) != 0
            if stray.any():
                sy = (ops[:, 1] + (1 << ops[:, 3])) >> 2
                sx = ops[:, 2] >> 2
                drop = stray & inter_cell[np.clip(sy, 0,
                                                  inter_cell.shape[0]
                                                  - 1), sx]
                ops[drop, 0] &= ~2
        plan.ops_l = _bucket(self.opsl, self.cntl)
        plan.ops_c = _bucket(self.opsc, self.cntc)
        self.plan = None
        return plan


def _p(a):
    return _VOIDP(a.ctypes.data)


def _bucket(ops, cnt):
    cap = max(1, int(cnt.max()))
    b = 1
    while b < cap:
        b *= 2
    out = np.zeros((ops.shape[0], b, 7), np.int32)
    for i in np.nonzero(cnt)[0]:
        out[i, : cnt[i]] = ops[i, : cnt[i]]
    return out
