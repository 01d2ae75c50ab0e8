"""Overlapped two-phase single-stream decode on torch tensors.

The twins of ``m2dec_tpu/runtime/turbo.py``'s TurboH264Decoder,
TurboH265Decoder and TurboMpeg2Decoder: the native C++ Phase A runs
ahead producing plans,
whole-GOP batches dispatch asynchronously to the port's batched Phase B
(frame pool resident on the device), and output events — captured at
exactly the points the serial decoder would emit frames — materialize
once their batch's tensors exist. Output frames, order and error
containment match the serial decoder; only the phase overlap differs.
"""

from __future__ import annotations

from collections import deque
from dataclasses import replace

import numpy as np

from ..codecs.h264.decoder import H264Decoder
from ..codecs.h264.plan_host import dev_pool_size
from ..codecs.h264.reconstruct import BatchedPhaseB
from ..codecs.h265.headers import H265Decoder
from ..codecs.h265.reconstruct import H265SeqPhaseB
from ..codecs.mpeg2.decoder import Mpeg2Decoder
from ..codecs.mpeg2.reconstruct import Mpeg2SeqPhaseB
from ..device import resolve_device


class TurboH264Decoder:
    """Overlapped Phase A / Phase B H.264 stream decoder.

    batch: pictures per device dispatch. device: where Phase B runs
    (default: the CUDA device; raises when there is none)."""

    def __init__(self, data: bytes, batch: int = 12, dpb_max: int = -1,
                 device=None):
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.dec = H264Decoder(native=True, plan_alloc="empty",
                                    dpb_max=dpb_max)
        self.dec.set_data(data)
        self.error = 0  # last decode_picture status (<0 at EOS)

    def frames(self):
        """Yield DecodedFrames with host numpy planes in output order."""
        for frm, outs, i in self.device_frames():
            if outs is None:
                yield frm
                continue
            yield replace(frm, y=outs[0][i].cpu().numpy(),
                          cb=outs[1][i].cpu().numpy(),
                          cr=outs[2][i].cpu().numpy())

    def device_frames(self):
        """Yield (frame-meta, outs, row) with planes left on the device:
        consumers index outs[0..2][row] and copy only what they need."""
        dec = self.dec
        batcher = None  # created lazily at first dispatch
        undisp: list = []  # plans awaiting dispatch (decode order)
        pool_sizes: dict = {}  # id(plan) -> frame-pool size at decode
        stores: dict = {}  # id(plan) -> (outs, row)
        last_plan: dict = {}  # pool slot -> plan that wrote it
        events: deque = deque()  # (DecodedFrame meta, plan)

        def dispatch():
            nonlocal batcher
            if not undisp:
                return
            # geometry of the plans being dispatched (on a mid-stream
            # change the decoder has already switched to the new shape)
            geom = (undisp[0].mb_w, undisp[0].mb_h,
                    pool_sizes[id(undisp[0])])
            for p in undisp:
                pool_sizes.pop(id(p), None)
            if batcher is None or (batcher.mb_w, batcher.mb_h,
                                   batcher.pool_size) != geom:
                batcher = BatchedPhaseB(*geom, device=self.device)
            outs = batcher.run_async(undisp)
            for i, p in enumerate(undisp):
                stores[id(p)] = (outs, i)
            undisp.clear()

        def capture(bypass=False):
            idx, frm = dec.pop_decoded_index(bypass)
            while idx >= 0:
                events.append((frm, last_plan.get(idx)))
                idx, frm = dec.pop_decoded_index(bypass)

        def emit_ready(flush=False):
            while events:
                frm, plan = events[0]
                ent = stores.get(id(plan)) if plan is not None else None
                if ent is None:
                    if plan in undisp and flush:
                        dispatch()
                        continue
                    if plan is None:
                        # a frame output before any picture completed a
                        # plan: emit the empty pool frame as the serial
                        # path would
                        events.popleft()
                        yield frm, None, None
                        continue
                    break
                events.popleft()
                outs, i = ent
                del stores[id(plan)]
                yield frm, outs, i

        while True:
            capture()
            yield from emit_ready()
            err = dec.decode_picture()
            self.error = err
            if err == 1:
                plan = dec.plans.pop()
                pool_sizes[id(plan)] = dev_pool_size(
                    dec.sps.num_ref_frames, len(dec.frames))
                last_plan[dec.cur_idx] = plan
                # split the pending batch on any geometry change: mb
                # dims or device-pool size
                if undisp and (
                        (undisp[0].mb_w, undisp[0].mb_h,
                         pool_sizes[id(undisp[0])]) !=
                        (plan.mb_w, plan.mb_h, pool_sizes[id(plan)])):
                    dispatch()
                undisp.append(plan)
                if len(undisp) >= self.batch:
                    dispatch()
                continue
            # EOS or truncation (err < 0): drain the DPB with bypass as
            # the serial path does; flush pending Phase-B work first
            dispatch()
            capture(bypass=True)
            yield from emit_ready(flush=True)
            return

    def decode_all(self):
        return list(self.frames())


class TurboH265Decoder:
    """Overlapped Phase A / Phase B H.265 stream decoder: native C++
    Phase A runs ahead collecting H265Plans, whole batches dispatch to
    H265SeqPhaseB (frame pool resident on the device), and DPB output
    events — recorded as pool indexes by the decoder's defer mode —
    materialize from the batch outputs. Output frames and order equal
    the serial decoder's.

    Row-aligned multi-slice pictures dispatch one at a time against the
    same device pool (their per-segment deblock + SAO replay); mid-row
    slice starts raise NotImplementedError, as in the JAX driver: they
    keep the serial Python path (a reference-bug domain, the chroma base
    derived as luma_offset >> 1). batch: pictures per device dispatch.
    device: where Phase B runs (default: the CUDA device; raises when
    there is none)."""

    def __init__(self, data: bytes, batch: int = 8, device=None):
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.dec = H265Decoder(device=self.device)
        self.dec.set_data(data)
        self.dec.begin_decode(backend="native", defer_recon=True)
        self.error = 0

    def frames(self):
        """Yield DecodedFrames with host numpy planes in output order."""
        for frm, outs, i in self.device_frames():
            if outs is None:
                yield frm
                continue
            yield replace(frm, y=outs[0][i].cpu().numpy(),
                          cb=outs[1][i].cpu().numpy(),
                          cr=outs[2][i].cpu().numpy())

    def device_frames(self):
        """Yield (frame-meta, outs, row) with planes left on the device;
        rows with outs=None carry their (zero) planes on the meta."""
        dec = self.dec
        batcher = None
        undisp: list = []
        stores: dict = {}     # id(plan) -> (outs, row)
        last_plan: dict = {}  # pool idx -> plan that wrote it
        events: deque = deque()
        # a multi-slice picture is inserted into the DPB once per slice
        # segment (reference slice_layer parity, h265.cpp:4849-4866), so
        # one plan backs several output events: its store entry lives
        # until the last one materializes
        refcnt: dict = {}     # id(plan) -> pending event count
        plans_seen = 0

        def ensure_batcher(p0):
            nonlocal batcher
            geom = (p0.H, p0.W, len(dec.pool))
            if batcher is None or (batcher.H, batcher.W,
                                   batcher.pool[0].shape[0]) != geom:
                batcher = H265SeqPhaseB(*geom, device=self.device)
            return batcher

        def dispatch():
            if not undisp:
                return
            outs = ensure_batcher(undisp[0]).run_async(undisp)
            for i, p in enumerate(undisp):
                stores[id(p)] = (outs, i)
            undisp.clear()

        def harvest_plans():
            nonlocal plans_seen
            while plans_seen < len(dec.plans):
                p = dec.plans[plans_seen]
                dec.plans[plans_seen] = None  # consumed: let it free
                plans_seen += 1
                last_plan[p.cur_idx] = p
                # the expected event count up front: the pops of one
                # picture may land in different capture rounds
                refcnt[id(p)] = (len(p.slice_rows)
                                 if p.multi_slice else 1)
                # mid-stream geometry change: dispatch the pending batch
                # before mixing shapes
                if undisp and (undisp[0].H, undisp[0].W) != (p.H, p.W):
                    dispatch()
                if p.multi_slice:
                    # pool-order dependency: flush pending pictures, then
                    # run this one's slice replay
                    dispatch()
                    stores[id(p)] = (ensure_batcher(p).run_async_one(p), 0)
                    continue
                undisp.append(p)
                if len(undisp) >= self.batch:
                    dispatch()

        def capture(is_end=False):
            # bind the plan at event time: the pool slot may be reused
            # by a later picture before this event materializes
            idx, frm = dec.pop_decoded_index(is_end)
            while idx >= 0:
                events.append((frm, last_plan.get(idx)))
                idx, frm = dec.pop_decoded_index(is_end)

        def emit_ready(flush=False):
            while events:
                frm, plan = events[0]
                ent = stores.get(id(plan)) if plan is not None else None
                if ent is None:
                    if plan is not None and any(
                            p is plan for p in undisp) and flush:
                        dispatch()
                        continue
                    if plan is None:
                        # a frame emitted before any plan wrote its slot
                        # (the empty pool frame): zero planes
                        events.popleft()
                        z = np.zeros((frm.height, frm.width), np.uint8)
                        zc = np.zeros((frm.height >> 1, frm.width >> 1),
                                      np.uint8)
                        yield replace(frm, y=z, cb=zc, cr=zc), None, None
                        continue
                    break
                events.popleft()
                outs, i = ent
                refcnt[id(plan)] -= 1
                if refcnt[id(plan)] <= 0:  # free outs once consumed
                    del stores[id(plan)]
                    del refcnt[id(plan)]
                yield frm, outs, i

        while True:
            err = dec.decode_picture()
            self.error = err
            harvest_plans()
            capture()
            yield from emit_ready()
            if err == 1:
                continue
            # EOS/truncation: the decoder's EOS path finalized the last
            # plan; flush and drain the DPB
            harvest_plans()
            dispatch()
            capture(is_end=True)
            yield from emit_ready(flush=True)
            return

    def decode_all(self):
        return list(self.frames())


class TurboMpeg2Decoder:
    """Overlapped Phase A / Phase B MPEG-1/2 stream decoder.

    Phase A (native C++, or the Python entropy decoder for syntax the
    native one refuses) runs ahead in the decoder's defer mode,
    collecting plans and (cur, ref0, ref1) frame-slot triples; whole-GOP
    batches dispatch to Mpeg2SeqPhaseB (pool resident on the device);
    out_state-ordered output events materialize from the batch outputs.
    batch: pictures per device dispatch. device: where Phase B runs
    (default: the CUDA device; raises when there is none)."""

    def __init__(self, data: bytes, batch: int = 12, num_frames=4,
                 device=None):
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.dec = Mpeg2Decoder(device=self.device, num_frames=num_frames,
                                defer_recon=True)
        self.dec.set_data(data)
        self.error = 0

    def frames(self):
        """Yield DecodedFrames with host numpy planes in output order."""
        for frm, outs, i in self.device_frames():
            if outs is None:
                yield frm
                continue
            yield replace(frm, y=outs[0][i].cpu().numpy(),
                          cb=outs[1][i].cpu().numpy(),
                          cr=outs[2][i].cpu().numpy())

    def device_frames(self):
        """Yield (frame-meta, outs, row) with planes left on the device:
        consumers index outs[0..2][row] and copy only what they need."""
        dec = self.dec
        batcher = None
        undisp: list = []     # (plan, cur, r0, r1)
        stores: dict = {}     # id(plan) -> (outs, row)
        last_plan: dict = {}  # pool slot -> plan
        events: deque = deque()
        seen = 0

        def dispatch():
            nonlocal batcher
            if not undisp:
                return
            if batcher is None:
                batcher = Mpeg2SeqPhaseB(dec.seq.mb_w, dec.seq.mb_h,
                                         len(dec.pool.frames),
                                         device=self.device)
            outs = batcher.run_async(undisp)
            for i, it in enumerate(undisp):
                stores[id(it[0])] = (outs, i)
            undisp.clear()

        def harvest():
            nonlocal seen
            while seen < len(dec.plans):
                it = dec.plans[seen]
                dec.plans[seen] = None  # consumed: let it free
                seen += 1
                last_plan[it[1]] = it[0]
                undisp.append(it)
                if len(undisp) >= self.batch:
                    dispatch()

        def capture(is_end=False):
            idx, frm = dec.pop_decoded_index(is_end)
            while idx >= 0:
                events.append((frm, last_plan.get(idx)))
                idx, frm = dec.pop_decoded_index(is_end)

        def emit_ready(flush=False):
            while events:
                frm, plan = events[0]
                ent = stores.get(id(plan)) if plan is not None else None
                if ent is None:
                    if plan is not None and any(
                            it[0] is plan for it in undisp) and flush:
                        dispatch()
                        continue
                    if plan is None:
                        events.popleft()
                        H = dec.seq.mb_h * 16
                        W = dec.seq.mb_w * 16
                        z = np.zeros((H, W), np.uint8)
                        zc = np.zeros((H >> 1, W >> 1), np.uint8)
                        yield replace(frm, y=z, cb=zc, cr=zc), None, None
                        continue
                    break
                events.popleft()
                outs, i = ent
                del stores[id(plan)]  # free batch outs once consumed
                yield frm, outs, i

        while True:
            capture()
            yield from emit_ready()
            err = dec.decode_data()
            self.error = err
            harvest()
            if err == 1:
                continue
            dispatch()
            capture(is_end=True)
            yield from emit_ready(flush=True)
            return

    def decode_all(self):
        return list(self.frames())
