"""Overlapped two-phase single-stream decode on torch tensors.

The twins of ``m2dec_tpu/runtime/turbo.py``'s TurboH264Decoder and
TurboMpeg2Decoder: the native C++ Phase A runs ahead producing plans,
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
