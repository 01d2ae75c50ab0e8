"""Native (C++) H.264 Phase-A session: drives native/h264parse.cpp.

The Python decoder keeps NAL walking, header parsing, POC, ref lists and
DPB; this session owns the per-MB slice decode, filling PicturePlan
tensors directly from C++ (zero-copy into the numpy buffers).
"""

from __future__ import annotations

import ctypes

import numpy as np

from m2dec_tpu_torch.bitstream.reader import BitstreamExhausted
from m2dec_tpu_torch.native import H264SliceParams, load_h264
from .plan import PicturePlan

_VOIDP = ctypes.c_void_p


def _ptr(a):
    return _VOIDP(a.ctypes.data)


class NativeH264Session:
    def __init__(self, max_x, max_y, plan_alloc="zeros"):
        """plan_alloc="empty" is the production fast path: plan buffers
        are np.empty and h264p_begin_picture(clear=1) memsets the
        densely-consumed fields in C; the coefficient planes stay
        uninitialized behind the per-MB coded map (h264pack consumes
        them sparsely)."""
        self.lib = load_h264()
        self.max_x, self.max_y = max_x, max_y
        self.plan_alloc = plan_alloc
        self.ctx = self.lib.h264p_new(max_x, max_y)
        self.plan = None
        self._keep = None
        import os
        import threading

        self._pool = None
        self._lock = threading.Lock()
        self._free_ctxs = []
        self._ctx_epoch = {}
        self._pic_epoch = 0
        self._pending = []
        self._async_keep = []
        self._slice_par = os.environ.get(
            "M2DEC_TPU_SLICE_THREADS") != "0"

    def _async_enabled(self):
        return self._slice_par

    def __del__(self):
        try:
            self._drain_async()
            if self._pool is not None:
                self._pool.shutdown(wait=True)
        except Exception:
            pass  # interpreter teardown
        try:
            for c in getattr(self, "_free_ctxs", []):
                self.lib.h264p_free(c)
            if getattr(self, "ctx", None):
                self.lib.h264p_free(self.ctx)
                self.ctx = None
        except Exception:
            pass

    # ------------------------------------------------------------------
    def begin_picture(self, dec):
        n = self.max_x * self.max_y
        fast = self.plan_alloc == "empty"
        alloc = np.empty if fast else np.zeros
        plan = PicturePlan(self.max_x, self.max_y, alloc=self.plan_alloc)
        plan.cur_idx = dec.cur_idx
        plan.coded = np.empty(n, np.uint32)  # always cleared in C
        # raw records for finalize_deblock — per-picture scratch, fully
        # consumed by finish_picture: allocate once and reuse (in fast
        # mode C clears the consumed ranges each picture)
        if getattr(self, "raw_idc", None) is None:
            self.raw_idc = alloc(n, np.int32)
            self.raw_qpy = alloc(n, np.int32)
            self.raw_qpc = alloc((n, 2), np.int32)
            self.raw_slicehdr = alloc((n, 2), np.int32)
            self.raw_str4 = alloc((n, 2), np.int32)
            self.raw_str = alloc((n, 2), np.int64)
            self.pcm_dense = np.empty((n, 384), np.uint8)  # kind==4 only
        elif not fast:
            for a in (self.raw_idc, self.raw_qpy, self.raw_qpc,
                      self.raw_slicehdr, self.raw_str4, self.raw_str):
                a[:] = 0
        cc = dec.curr_col
        arrays = [
            plan.kind, plan.t8x8, plan.coef_luma, plan.coef_chroma,
            plan.i4_modes, plan.i4_avail, plan.i8_modes, plan.i8_avail,
            plan.i16_mode, plan.chroma_mode, plan.mb_avail, plan.mv,
            plan.slot, plan.wp, self.pcm_dense,
            self.raw_idc, self.raw_qpy, self.raw_qpc, self.raw_slicehdr,
            self.raw_str4, self.raw_str,
            cc["type"], cc["ref"], cc["mv"],
            plan.coded,
        ]
        self._keep = arrays
        ptrs = (_VOIDP * len(arrays))(*[a.ctypes.data for a in arrays])
        self._ptrs = ptrs
        self._pic_epoch += 1
        self.lib.h264p_begin_picture(self.ctx, ptrs, 1 if fast else 0)
        self.plan = plan
        return plan

    def set_refs(self, dec):
        """Pack ref lists / colocated page / weights for the slice."""
        tables = self._build_refs(dec)
        self._slice_keep = tables
        self._install_refs(self.ctx, tables)

    def _build_refs(self, dec):
        refs = np.zeros((2, 16, 4), np.int32)
        for lx in range(2):
            for k, rf in enumerate(dec.refs[lx]):
                refs[lx, k] = (rf.frame_idx, rf.poc, rf.in_use, 0)
        page = dec.refs[1][0].col or dec.curr_col
        wtab = np.zeros((2, 32, 3, 2), np.int32)
        wshift = np.zeros(2, np.int32)
        implicit = np.full((32, 32, 2), 32, np.int32)
        if dec.weighted_mode == 1 and dec.weight_tab is not None:
            wshift[:] = dec.weight_shift
            for lx in range(2):
                tab = dec.weight_tab[lx]
                if tab is None:
                    continue
                for i, w in enumerate(tab[:32]):
                    for p in range(3):
                        wtab[lx, i, p] = w[p]
        elif dec.weighted_mode == 2:
            from .inter import _implicit_weights

            n0 = dec.hdr.num_ref_idx_active[0] + 1
            n1 = dec.hdr.num_ref_idx_active[1] + 1
            for i0 in range(min(n0, 32)):
                for i1 in range(min(n1, 32)):
                    implicit[i0, i1] = _implicit_weights(dec, i0, i1)
        mcl0, scale = self._temporal_tables(dec)
        return (refs, page, wtab, wshift, implicit, mcl0, scale)

    def _install_refs(self, ctx, tables):
        refs, page, wtab, wshift, implicit, mcl0, scale = tables
        self.lib.h264p_set_refs(
            ctx, _ptr(refs), _ptr(page["type"]), _ptr(page["ref"]),
            _ptr(page["mv"]), _ptr(page["map_col_frameidx"]),
            _ptr(mcl0), _ptr(scale), _ptr(wtab), _ptr(wshift),
            _ptr(implicit))

    def _temporal_tables(self, dec):
        """bdirect_map / bdirect_scale from create_map_col_to_list0."""
        mcl0 = np.full(16, -1, np.int32)
        scale = np.zeros(16, np.int32)
        if getattr(dec, "bdirect_map", None) is not None:
            mcl0[:] = dec.bdirect_map
            scale[:] = dec.bdirect_scale
        return mcl0, scale

    # ----------------------------------------------- slice parallelism --
    def _worker_pool(self):
        if self._pool is None:
            import os
            from concurrent.futures import ThreadPoolExecutor

            n = int(os.environ.get("M2DEC_TPU_SLICE_THREADS",
                                   str(min(4, os.cpu_count() or 1))))
            self._nworkers = max(1, n)
            self._pool = ThreadPoolExecutor(max_workers=self._nworkers)
            self._worker_ctxs = []
        return self._pool

    def _worker_ctx(self):
        """Per-task worker context from a free list (each holds its own
        CABAC/neighbor state; plan pointers are shared)."""
        with self._lock:
            if self._free_ctxs:
                return self._free_ctxs.pop()
        return self.lib.h264p_new(self.max_x, self.max_y)

    def _drain_async(self):
        if not self._pending:
            return
        pend, self._pending = self._pending, []
        err = None
        for fut in pend:
            try:
                fut.result()
            except Exception as e:  # noqa: PERF203
                err = err or e
        if err is not None:
            raise err

    def _run_slice_on(self, ctx, sp, payload, tables):
        self._install_refs(ctx, tables)
        out_state = (ctypes.c_int32 * 4)()
        err = self.lib.h264p_slice(ctx, payload, len(payload),
                                   ctypes.byref(sp), out_state)
        with self._lock:
            self._free_ctxs.append(ctx)
        if err == -2:
            # mid-slice truncation: the reference's refill longjmp
            # domain (bitio.c:112-128) -> decode_picture returns -2
            raise BitstreamExhausted("native slice truncated")
        if err < 0:
            raise RuntimeError(f"native h264 slice error {err}")

    # ------------------------------------------------------------------
    def run_slice(self, dec, r, allow_async=False):
        hdr = dec.hdr
        pps = dec.pps
        sp = H264SliceParams()
        sp.slice_type = hdr.slice_type
        sp.is_cabac = 1 if dec.is_cabac else 0
        sp.cabac_init_idc = (0 if hdr.slice_type == 2
                             else getattr(hdr, "cabac_init_idc", 0) + 1)
        sp.qp = dec.qp
        sp.first_mb = hdr.first_mb_in_slice
        sp.num_ref_idx[0] = hdr.num_ref_idx_active[0]
        sp.num_ref_idx[1] = hdr.num_ref_idx_active[1]
        sp.constrained_intra = pps.constrained_intra_pred_flag
        sp.t8x8_mode = pps.transform_8x8_mode_flag
        sp.chroma_qp_index[0] = pps.chroma_qp_index[0]
        sp.chroma_qp_index[1] = pps.chroma_qp_index[1]
        sp.direct_spatial = hdr.direct_spatial_mv_pred_flag
        sp.weighted_mode = dec.weighted_mode
        sp.deb_idc_plus1 = hdr.disable_deblocking_filter_idc + 1
        sp.alpha_ofs = hdr.alpha_c0_offset
        sp.beta_ofs = hdr.beta_offset
        sp.poc = hdr.poc
        sp.is_field = hdr.field_pic_flag
        sp.bit_offset = r.bitpos
        payload = r.data
        if allow_async and self._async_enabled():
            tables = self._build_refs(dec)
            ctx = self._worker_ctx()
            # every ctx (re)binds the shared plan pointers each picture
            if self._ctx_epoch.get(ctx) != self._pic_epoch:
                self.lib.h264p_begin_picture(ctx, self._ptrs, -1)
                self._ctx_epoch[ctx] = self._pic_epoch
            keep = (sp, payload, tables)
            self._async_keep.append(keep)
            self._pending.append(self._worker_pool().submit(
                self._run_slice_on, ctx, sp, payload, tables))
            return True
        self._drain_async()
        self.set_refs(dec)
        out_state = (ctypes.c_int32 * 4)()
        err = self.lib.h264p_slice(self.ctx, payload, len(payload),
                                   ctypes.byref(sp), out_state)
        if err == -2:
            raise BitstreamExhausted("native slice truncated")
        if err < 0:
            raise RuntimeError(f"native h264 slice error {err} "
                               f"(slice_type={hdr.slice_type}, "
                               f"cabac={dec.is_cabac})")
        dec.mb_pos = out_state[0]
        dec.mb_x = out_state[1]
        dec.mb_y = out_state[2]
        dec.firstline = out_state[3]
        return False

    # ------------------------------------------------------------------
    def finish_picture(self, dec):
        self._drain_async()
        self._async_keep = []
        plan = self.plan
        self.lib.h264p_finalize_deblock(
            self.ctx, dec.firstline, _ptr(plan.deb_str),
            _ptr(plan.deb_str4), _ptr(plan.deb_ab))
        kinds = np.nonzero(plan.kind == 4)[0]
        for mbpos in kinds:
            d = self.pcm_dense[mbpos]
            plan.pcm[int(mbpos)] = (
                d[:256].reshape(16, 16).copy(),
                d[256:320].reshape(8, 8).copy(),
                d[320:384].reshape(8, 8).copy(),
            )
        plan.poc = dec.hdr.poc
        # liveness for device-pool compaction (reconstruct._DevSlotMap):
        # host frame indexes that may still be referenced from here on —
        # the pre-marking reference set plus the current picture
        plan.live = sorted(
            {rf.frame_idx for lx in (0, 1) for rf in dec.refs[lx]
             if rf.in_use} | {plan.cur_idx})
        self.plan = None
        return plan
