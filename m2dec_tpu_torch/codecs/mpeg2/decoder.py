"""MPEG-1/2 decoder driver: start-code walk, header dispatch, frame
management, and display-order output.

The driver replaces the reference's callback/longjmp-driven incremental
loop (reference: src/lib/mpeg2.cpp:1598-1622 `m2d_decode_data`,
:662-695 `m2d_dispatch_one_nal`) with a vectorized start-code scan over the
whole elementary stream followed by offset-table iteration.

Frame rotation, LRU buffer choice, and the display-order `out_state`
machine replicate the reference exactly (mpeg2.cpp:130-194 update/LRU,
:1543-1587 peek/get state machine), so output frames and their order are
bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from m2dec_tpu_torch.bitstream import BitReader
from m2dec_tpu_torch.bitstream.reader import find_start_codes
from m2dec_tpu_torch.errors import StreamFeatureExcluded
from . import tables as T
from .entropy import (
    B_VOP,
    I_VOP,
    P_VOP,
    Mpeg2EntropyDecoder,
    PicturePlan,
    PicState,
    SeqState,
)
from .reconstruct import reconstruct_picture

MAX_FRAME_NUM = 16


@dataclasses.dataclass
class DecodedFrame:
    """Output frame descriptor (reference m2d_frame_t, m2d.h:35-42)."""

    y: np.ndarray  # uint8 [H, W] (padded)
    cb: np.ndarray  # uint8 [H/2, W/2]
    cr: np.ndarray  # uint8 [H/2, W/2]
    width: int  # padded width
    height: int  # padded height
    crop: tuple  # (left, right, top, bottom)
    cnt: int = 0  # temporal reference / POC
    raw_stride: int = 0  # FAST_DECODE: 16-aligned internal stride quirk

    def nv12(self):
        """Planar -> NV12 (luma plane + interleaved CbCr), the reference's
        in-memory format (m2d.h:35-42 chroma layout). Downloads
        device-resident planes on demand."""
        cb = np.asarray(self.cb)
        cr = np.asarray(self.cr)
        h2, w2 = cb.shape
        chroma = np.empty((h2, w2 * 2), np.uint8)
        chroma[:, 0::2] = cb
        chroma[:, 1::2] = cr
        return np.asarray(self.y), chroma


def _blank_frame(mb_w, mb_h, fast=False):
    ly, lc = (2, 1) if fast else (16, 8)
    return {
        "y": np.zeros((mb_h * ly, mb_w * ly), np.uint8),
        "cb": np.zeros((mb_h * lc, mb_w * lc), np.uint8),
        "cr": np.zeros((mb_h * lc, mb_w * lc), np.uint8),
        "cnt": 0,
    }


class FramePool:
    """LRU frame pool + reference rotation (mpeg2.cpp:130-194)."""

    def __init__(self, num, mb_w, mb_h, fast=False):
        self.num = num
        self.frames = [_blank_frame(mb_w, mb_h, fast) for _ in range(num)]
        self.lru = [0] * num
        self.idx_of_ref = [0, 0]
        self.index = -1

    def find_valid_frame(self):
        ref0, ref1 = self.idx_of_ref
        max_idx, max_val = -1, -1
        for i in range(self.num):
            if i != ref0 and i != ref1:
                val = self.lru[i]
                self.lru[i] = val + 1
                if max_val < val:
                    max_val, max_idx = val, i
        if max_idx < 0:
            max_idx = ref0
        self.lru[max_idx] = 0
        return max_idx


class Mpeg2Decoder:
    """MPEG-1/2 elementary-stream decoder (vtable parity with the
    reference's m2d_func_table_t: set_data / decode_data / peek / get)."""

    def __init__(self, device=None, num_frames=4, fast=False,
                 defer_recon=False):
        """device: where Phase B runs (default: the CUDA device; CPU
        callers pass "cpu"). fast=True: the DC-only 1/8-scale Phase B of
        the reference's FAST_DECODE mode (codecs/mpeg2/fast.py)."""
        #: FAST_DECODE analog: DC-only 1/8-scale Phase B
        self.fast = fast
        #: defer mode (runtime/turbo.TurboMpeg2Decoder): Phase A only —
        #: plans + (cur, ref0, ref1) slot triples accumulate in
        #: self.plans and DPB-style output events surface as pool
        #: indexes via pop_decoded_index
        self.defer_recon = bool(defer_recon)
        self.plans: list = []
        self.seq = SeqState()
        self.pic = PicState()
        self.num_frames = num_frames
        self.pool: FramePool | None = None
        self.out_state = 0
        self.ent: Mpeg2EntropyDecoder | None = None
        self.device = device
        self.data = b""
        self.codes = np.zeros(0, np.int64)
        self.code_i = 0
        self.reader: BitReader | None = None
        self.strict_coverage = True

    # -- input -----------------------------------------------------------
    def set_data(self, data: bytes):
        self.data = bytes(data)
        self.codes = find_start_codes(self.data)
        self.code_i = 0
        self.reader = BitReader(self.data)

    def _reader_at(self, byte_off):
        r = self.reader
        r._pos = 8 * byte_off
        return r

    # -- main loop -------------------------------------------------------
    def decode_data(self) -> int:
        """Decode until one picture completes. Returns 1 on picture
        completion, -1 at end of stream (reference m2d_decode_data,
        mpeg2.cpp:1598-1622)."""
        from m2dec_tpu_torch.bitstream.reader import BitstreamExhausted

        try:
            while self.code_i < len(self.codes):
                off = int(self.codes[self.code_i])
                self.code_i += 1
                code_type = self.data[off + 3]
                r = self._reader_at(off + 4)
                done = self._dispatch(code_type, r)
                if done:
                    return 1
        except BitstreamExhausted:
            # mid-slice truncation: the reference longjmps out of the
            # parse (setjmp at mpeg2.cpp:666) and abandons the picture
            return -2
        return -1

    def _dispatch(self, code_type, r) -> bool:
        if code_type == 0x00:
            self._read_picture_header(r)
        elif 0x01 <= code_type <= 0xAF:
            return self._read_slice(code_type, r)
        elif code_type == 0xB3:
            self._read_seq_header(r)
        elif code_type == 0xB5:
            self._read_extension(r)
        elif code_type == 0xB8:
            self._read_gop_header(r)
        # 0xb2 user data / 0xb7 sequence end / others: skip to next code
        return False

    # -- headers (mpeg2.cpp:320-623) --------------------------------------
    def _load_qmat(self, r, scan):
        qm = np.zeros(64, np.int32)
        for i in range(64):
            qm[scan[i]] = r.get_bits(8)
        return qm

    def _read_seq_header(self, r):
        seq = self.seq
        w = r.get_bits(12)
        h = r.get_bits(12)
        seq.aspect_ratio = r.get_bits(4)
        seq.frame_rate_code = r.get_bits(4)
        seq.bit_rate = r.get_bits(18)
        r.get_bits(1)  # marker
        seq.vbv_buffer_size = r.get_bits(10)
        r.get_bits(1)  # constrained_parameters_flag
        qmats = list(seq.qmat)
        if r.get_onebit():
            qmats[0] = self._load_qmat(r, T.SCAN[0])
        else:
            qmats[0] = np.array(T.QMAT_INTRA_DEFAULT, np.int32)
        if r.get_onebit():
            qmats[1] = self._load_qmat(r, T.SCAN[0])
        else:
            qmats[1] = np.array(T.QMAT_NONINTRA_DEFAULT, np.int32)
        seq.qmat = tuple(qmats)
        seq.set_size(w, h)
        if self.pool is None:
            self.pool = FramePool(self.num_frames, seq.mb_w, seq.mb_h,
                                  self.fast)

    def _read_extension(self, r):
        ext_id = r.get_bits(4)
        if ext_id == 1:  # sequence extension (mpeg2.cpp:358-379)
            seq = self.seq
            r.get_bits(8)  # profile_and_level
            seq.progressive_sequence = r.get_bits(1)
            r.get_bits(2)  # chroma_format
            w = seq.width | (r.get_bits(2) << 12)
            h = seq.height | (r.get_bits(2) << 12)
            seq.bit_rate |= r.get_bits(12) << 18
            r.get_bits(1)
            seq.vbv_buffer_size |= r.get_bits(8) << 10
            seq.set_size(w, h)
            seq.is_mpeg2 = True
        elif ext_id == 8:  # picture coding extension (mpeg2.cpp:457-504)
            pic = self.pic
            f = r.get_bits(16)
            pic.r_size[0][0] = (f >> 12) - 1
            pic.r_size[0][1] = ((f >> 8) & 15) - 1
            pic.r_size[1][0] = ((f >> 4) & 15) - 1
            pic.r_size[1][1] = (f & 15) - 1
            pic.intra_dc_precision = r.get_bits(2)
            pic.picture_structure = r.get_bits(2)
            pic.top_field_first = r.get_bits(1)
            pic.frame_pred_frame_dct = r.get_bits(1)
            pic.concealment_motion_vectors = r.get_bits(1)
            pic.q_scale_type = r.get_bits(1)
            pic.intra_vlc_format = r.get_bits(1)
            pic.alternate_scan = r.get_bits(1)
            r.get_bits(1)  # repeat_first_field
            r.get_bits(1)  # chroma_420_type
            pic.progressive_frame = r.get_bits(1)
            if r.get_bits(1):  # composite_display_flag
                r.get_bits(1 + 3 + 1 + 7 + 8)
        elif ext_id == 3:  # quant matrix extension (mpeg2.cpp:381-399)
            scan = T.SCAN[self.pic.alternate_scan]
            qmats = list(self.seq.qmat)
            for i in range(4):
                if r.get_onebit():
                    qmats[i] = self._load_qmat(r, scan)
            self.seq.qmat = tuple(qmats)
        # other extensions: ignored (display ext does not affect samples)

    def _read_gop_header(self, r):
        r.get_bits(27)  # time_code + closed_gop + broken_link

    def _read_picture_header(self, r):
        pic = self.pic
        pic.temporal_reference = r.get_bits(10)
        pic.coding_type = r.get_bits(3)
        r.get_bits(16)  # vbv_delay
        if pic.coding_type in (P_VOP, B_VOP):
            # MPEG-1 full_pel+f_code read as one 4-bit field, matching the
            # reference (mpeg2.cpp:608-617; full_pel must be 0)
            rs = r.get_bits(4) - 1
            pic.r_size[0][0] = rs
            pic.r_size[0][1] = rs
            if pic.coding_type == B_VOP:
                rs = r.get_bits(4) - 1
                pic.r_size[1][0] = rs
                pic.r_size[1][1] = rs
        while r.get_bits(1):
            r.get_bits(8)
        self.ent = None  # new picture: fresh entropy state at first slice

    # -- slices / picture completion --------------------------------------
    def _read_slice(self, code_type, r) -> bool:
        vertical_pos = (code_type & 255) - 1
        if self.pool is None or self.pic.coding_type == 0:
            return False
        if self.ent is None:
            done = self._try_native_picture()
            if done is not None:
                return done
            self.ent = Mpeg2EntropyDecoder(self.seq, self.pic)
        if vertical_pos == 0:
            self._update_frames()
        done = self.ent.decode_slice(r, vertical_pos)
        if done:
            self._finish_picture()
        return done

    def _try_native_picture(self):
        """Decode ALL of this picture's slices with the C++ Phase A
        (m2dec_tpu_torch/native/m2vparse.cpp). Returns True/False (picture
        done flag) or None to fall back to the Python Phase A."""
        import ctypes
        import types as _types

        from m2dec_tpu_torch import native as N

        lib = N.load_m2v()
        start = self.code_i - 1
        offs, lens, vpos = [], [], []
        j = start
        while j < len(self.codes):
            off = int(self.codes[j])
            ct = self.data[off + 3]
            if not (0x01 <= ct <= 0xAF):
                break
            end = int(self.codes[j + 1]) if j + 1 < len(self.codes) \
                else len(self.data)
            offs.append(off + 4)
            lens.append(end - (off + 4))
            vpos.append(ct - 1)
            j += 1
        if not offs:
            return None
        pic, seq = self.pic, self.seq
        pp = N.M2vPicParams()
        pp.mb_w, pp.mb_h = seq.mb_w, seq.mb_h
        pp.is_mpeg2 = int(seq.is_mpeg2)
        pp.coding_type = pic.coding_type
        for k in range(4):
            pp.r_size[k] = int(pic.r_size[k >> 1][k & 1])
        pp.intra_dc_precision = pic.intra_dc_precision
        pp.frame_pred_frame_dct = pic.frame_pred_frame_dct
        pp.concealment_motion_vectors = pic.concealment_motion_vectors
        pp.q_scale_type = pic.q_scale_type
        pp.intra_vlc_format = pic.intra_vlc_format
        pp.alternate_scan = pic.alternate_scan
        pp.picture_structure = pic.picture_structure
        for k in range(64):
            pp.qmat_intra[k] = int(seq.qmat[0][k])
            pp.qmat_nonintra[k] = int(seq.qmat[1][k])
        plan = PicturePlan.empty(pic.coding_type, pic.temporal_reference,
                                 seq.mb_w, seq.mb_h)
        n = len(offs)
        offs_c = (ctypes.c_int64 * n)(*offs)
        lens_c = (ctypes.c_int64 * n)(*lens)
        vpos_c = (ctypes.c_int32 * n)(*vpos)
        rc = lib.m2v_decode_picture(
            self.data, len(self.data), offs_c, lens_c, vpos_c, n,
            ctypes.byref(pp),
            plan.intra.ctypes.data_as(ctypes.c_void_p),
            plan.fwd.ctypes.data_as(ctypes.c_void_p),
            plan.bwd.ctypes.data_as(ctypes.c_void_p),
            plan.mvf.ctypes.data_as(ctypes.c_void_p),
            plan.mvb.ctypes.data_as(ctypes.c_void_p),
            plan.dct_type.ctypes.data_as(ctypes.c_void_p),
            plan.coef.ctypes.data_as(ctypes.c_void_p),
            plan.covered.ctypes.data_as(ctypes.c_void_p),
            plan.dc0.ctypes.data_as(ctypes.c_void_p),
            plan.mvf2.ctypes.data_as(ctypes.c_void_p),
            plan.mvb2.ctypes.data_as(ctypes.c_void_p),
            plan.fsel.ctypes.data_as(ctypes.c_void_p),
            plan.fieldmc.ctypes.data_as(ctypes.c_void_p),
        )
        if rc < 0:
            return None  # Python fallback (unsupported syntax)
        self.code_i = j
        if any(v == 0 for v in vpos):
            self._update_frames()
        self.ent = _types.SimpleNamespace(plan=plan)
        if rc == 1:
            self._finish_picture()
            return True
        return False

    def _update_frames(self):
        """m2d_update_frames (mpeg2.cpp:159-194)."""
        pool = self.pool
        ct = self.pic.coding_type
        if pool.index < 0:
            self.out_state = 2 if ct in (I_VOP, P_VOP) else 0
            pool.index = 0
            return
        curr = pool.find_valid_frame()
        if ct in (I_VOP, P_VOP):
            pool.idx_of_ref = [pool.idx_of_ref[1], curr]
            if self.out_state < 4:
                self.out_state += 2
        else:
            self.out_state |= 1
        pool.index = curr
        pool.frames[curr]["cnt"] = self.pic.temporal_reference

    def _finish_picture(self):
        plan = self.ent.plan
        pool = self.pool
        if self.strict_coverage and not plan.covered.all():
            raise NotImplementedError(
                "picture leaves macroblocks uncovered (stale-buffer content); "
                "not bit-reproducible in the plan-based decoder"
            )
        if self.defer_recon:
            if self.fast:
                raise StreamFeatureExcluded("defer_recon: full decode only")
            self.plans.append((plan, pool.index, pool.idx_of_ref[0],
                               pool.idx_of_ref[1]))
            self.ent = None
            return
        ref0 = pool.frames[pool.idx_of_ref[0]]
        ref1 = pool.frames[pool.idx_of_ref[1]]
        if self.fast:
            from .fast import reconstruct_picture_fast

            out = reconstruct_picture_fast(plan, ref0, ref1,
                                           device=self.device)
        else:
            out = reconstruct_picture(plan, ref0, ref1, device=self.device)
        cur = pool.frames[pool.index]
        cur["y"], cur["cb"], cur["cr"] = out["y"], out["cb"], out["cr"]
        self.ent = None

    # -- output (mpeg2.cpp:1543-1587) --------------------------------------
    def _frame_out(self, idx):
        f = self.pool.frames[idx]
        seq = self.seq
        if self.fast:
            # fast mode reports the full coarse frame, no sub-MB crop
            # (mpeg2.cpp:309-310 with MB_LEN=2)
            pw, ph = seq.mb_w * 2, seq.mb_h * 2
            return DecodedFrame(
                y=f["y"], cb=f["cb"], cr=f["cr"],
                width=pw, height=ph, crop=(0, 0, 0, 0), cnt=f["cnt"],
                raw_stride=(pw + 15) & ~15,
            )
        pw, ph = seq.mb_w * 16, seq.mb_h * 16
        return DecodedFrame(
            y=f["y"], cb=f["cb"], cr=f["cr"],
            width=pw, height=ph,
            crop=(0, pw - seq.width, 0, ph - seq.height),
            cnt=f["cnt"],
        )

    def peek_decoded_frame(self, is_end=False):
        """Returns (ready, DecodedFrame|None)."""
        pool = self.pool
        if pool is None:
            return 0, None
        if self.pic.coding_type == B_VOP:
            idx = pool.index
        elif is_end and 0 < self.out_state < 4:
            idx = pool.idx_of_ref[1]
        else:
            idx = pool.idx_of_ref[0]
        frame = self._frame_out(max(idx, 0))
        if self.pic.coding_type != B_VOP:
            state = self.out_state >> 1
            ready = 0 if state == 0 else (int(is_end) if state == 1 else 1)
        else:
            ready = self.out_state & 1
        return ready, frame

    def pop_decoded_index(self, is_end=False):
        """Defer-mode event pop: (pool_idx, DecodedFrame meta without
        pixels) following the out_state machine exactly
        (mpeg2.cpp:1543-1587); -1 when nothing is ready."""
        from dataclasses import replace

        ready, frame = self.peek_decoded_frame(is_end)
        if not ready:
            return -1, None
        if self.pic.coding_type == B_VOP:
            idx = self.pool.index
            self.out_state &= ~1
        else:
            if is_end and 0 < self.out_state < 4:
                idx = self.pool.idx_of_ref[1]
            else:
                idx = self.pool.idx_of_ref[0]
            self.out_state -= 2
        idx = max(idx, 0)
        return idx, replace(frame, y=None, cb=None, cr=None)

    def get_decoded_frame(self, is_end=False):
        ready, frame = self.peek_decoded_frame(is_end)
        if ready:
            if self.pic.coding_type == B_VOP:
                self.out_state &= ~1
            else:
                self.out_state -= 2
        return ready, frame

    # -- checkpoint/resume -------------------------------------------------
    def stream_pos(self) -> int:
        """Byte offset of the first undecoded start code (vtable
        stream_pos parity, m2d.h:69)."""
        if self.code_i < len(self.codes):
            return int(self.codes[self.code_i])
        return len(self.data)

    def __getstate__(self):
        """Picture-boundary checkpoint (SURVEY §5.4): sequence/picture
        state, frame pool, reorder machine — minus the input buffer and
        the per-slice entropy transients."""
        d = self.__dict__.copy()
        d["data"] = b""
        d["codes"] = np.zeros(0, np.int64)
        d["code_i"] = 0
        d["reader"] = None
        d["ent"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)

    # -- convenience -------------------------------------------------------
    def decode_all(self):
        """Full-stream decode -> frames in display order (the app decode
        loop of m2decoder.h:132-157 decode + decode_residual)."""
        frames = []
        while True:
            # drain available output first (decode() loop shape)
            ready, frm = self.peek_decoded_frame(False)
            while ready:
                self.get_decoded_frame(False)
                frames.append(frm)
                ready, frm = self.peek_decoded_frame(False)
            err = self.decode_data()
            if err < 0:
                ready, frm = self.peek_decoded_frame(True)
                while ready:
                    self.get_decoded_frame(True)
                    frames.append(frm)
                    ready, frm = self.peek_decoded_frame(True)
                return frames
