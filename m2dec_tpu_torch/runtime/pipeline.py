"""Threaded decode pipeline (reference threadplayer.cpp parity).

Three stages connected by bounded queues with backpressure, mirroring the
reference's FileReader -> Decoder -> display/write pipeline
(threadplayer.cpp:657-689, AsyncQueue :44-144):

  reader thread   — splits the input into per-picture work units
                    (container demux + start-code scan)
  decoder thread  — Phase A (native/host entropy) + Phase B dispatch
  writer thread   — drains decoded frames in output order to the sink

Each stage records a busy/idle timeline (the reference's rdtsc
RecordTime/LogDump profiler, unithread.h:58-147); `Pipeline.timeline_csv`
emits the same start,stop CSV rows its timingchart viewer consumes.

The port's copy of ``m2dec_tpu/runtime/pipeline.py``, with ``device=``:
every Phase B runs on the CUDA device unless the caller passes
``device="cpu"`` -- the Turbo drivers under ``two_phase=True``, and the
serial decoders otherwise (H.264: the native Phase A with the per-picture
torch Phase B; H.265: ``decode_all(backend="torch")``; MPEG-2). A Turbo
driver that refuses a stream feature with StreamFeatureExcluded hands the
stream to the serial decoder, on the same device, and counts one
``replays``; any other error -- a CUDA, build or launch fault, or a
NotImplementedError the serial decoder would raise too -- ends the run
with that error.
"""

from __future__ import annotations

import queue
import threading
import time


class StageTimer:
    """Busy-interval recorder (unithread.h RecordTime equivalent)."""

    def __init__(self, name):
        self.name = name
        self.spans = []  # (start_ns, stop_ns)

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.spans.append((self._t0, time.perf_counter_ns()))

    def busy_ns(self):
        return sum(b - a for a, b in self.spans)


_END = object()


class Pipeline:
    """decode pipeline: codec auto-detect, bounded queues, timing."""

    def __init__(self, data: bytes, codec: str | None = None,
                 queue_depth: int = 4, emptify: bool = False,
                 two_phase: bool = False, device=None):
        self.data = bytes(data)
        #: -e DPB emptify mode (m2decoder.h:149-150): drain every ready
        #: frame per decode call instead of one
        self.emptify = emptify
        #: two_phase: H.264 decodes through the overlapped Phase A /
        #: Phase B driver (runtime/turbo.py) — native entropy decode
        #: runs ahead of async batched device reconstruction
        self.two_phase = two_phase
        #: where the device Phase B runs (None: the CUDA device)
        self.device = device
        self.codec = codec or self._detect(self.data)
        self.qin: queue.Queue = queue.Queue(maxsize=queue_depth)
        self.qout: queue.Queue = queue.Queue(maxsize=queue_depth)
        self.timers = {
            "reader": StageTimer("reader"),
            "decoder": StageTimer("decoder"),
            "writer": StageTimer("writer"),
        }
        self.error = None
        from .metrics import Metrics

        #: decode-rate / drop counters (SURVEY §5.5): bytes_in,
        #: frames_decoded, frames_output, decode_errors, replays (serial
        #: replays after a Turbo driver's StreamFeatureExcluded) +
        #: *_per_s rates
        self.metrics = Metrics()

    # -- codec detection (m2decoder.h detect_file equivalent) -----------
    @staticmethod
    def _detect(data: bytes) -> str:
        i = data.find(b"\x00\x00\x01")
        if i < 0:
            raise ValueError("no start code")
        code = data[i + 3]
        if code in (0xBA, 0xB9):
            return "ps"
        if code == 0xB3:
            return "mpeg2"
        # H.265 NAL header: forbidden bit 0, 6-bit type; streams lead
        # with VPS (32) / SPS (33) -> first bytes 0x40/0x42
        if code in (0x40, 0x42, 0x44, 0x26, 0x02, 0x28):
            return "h265"
        if (code & 0x1F) in (7, 1, 5) and (code >> 5) <= 3 and code not in (
                0xB3, 0xB8):
            return "h264"
        return "mpeg2"

    # -- stages ----------------------------------------------------------
    def _reader(self):
        try:
            with self.timers["reader"]:
                data = self.data
                if self.codec == "ps":
                    from ..containers.ps import PsDemuxer

                    data = PsDemuxer(data).video_stream()
                    self.codec = self._detect(data)
            # hand the whole ES to the decoder in picture-sized units is
            # codec-dependent; the decoder stage pulls units itself, so
            # the reader just forwards the stream once demuxed.
            self.metrics.inc("bytes_in", len(data))
            self.qin.put(data)
            self.qin.put(_END)
        except Exception as e:  # pragma: no cover
            self.error = e
            self.qin.put(_END)

    def _decoder(self):
        try:
            data = self.qin.get()
            if data is _END:
                self.qout.put(_END)
                return
            # skip_n > 0 after a mid-stream turbo fallback: the serial
            # replay below re-decodes from the start of the (fully
            # in-memory) stream and suppresses the frames the turbo
            # driver already emitted — identical prefixes, so the
            # writer sees one continuous output sequence.
            skip_n = 0

            def put_frame(frm):
                nonlocal skip_n
                if skip_n > 0:
                    skip_n -= 1
                    return
                self.qout.put(frm)

            if self.two_phase and self.codec in ("h264", "h265",
                                                 "mpeg2"):
                # overlapped Phase A / batched device Phase B for all
                # three engines (runtime/turbo.py); falls back to the
                # serial decoder on streams the drivers exclude
                from ..errors import StreamFeatureExcluded
                from . import turbo as _turbo

                cls = {"h264": _turbo.TurboH264Decoder,
                       "h265": _turbo.TurboH265Decoder,
                       "mpeg2": _turbo.TurboMpeg2Decoder}[self.codec]
                emitted = 0
                try:
                    turbo = cls(data, device=self.device)
                    with self.timers["decoder"]:
                        for frm in turbo.frames():
                            self.metrics.inc("frames_decoded")
                            self.qout.put(frm)
                            emitted += 1
                    if turbo.error == -2:
                        self.metrics.inc("decode_errors")
                    self.qout.put(_END)
                    self.qin.get()
                    return
                except StreamFeatureExcluded:
                    # stream uses a feature the driver excludes (H.265
                    # mid-row slice starts, a native Phase A refusal):
                    # replay through the serial path below.  Frames the
                    # turbo driver already emitted are an exact prefix
                    # of the serial output (the drivers are
                    # output-identical up to the excluded picture), so
                    # the replay skips them.
                    self.metrics.inc("replays")
                    skip_n = emitted
                    if emitted:
                        self.metrics.inc("frames_decoded", -emitted)
            if self.codec == "h264":
                from ..codecs.h264.decoder import H264Decoder

                dec = H264Decoder(native=True, phase_b="torch",
                                  device=self.device)
            elif self.codec == "h265":
                from ..codecs.h265.headers import H265Decoder

                dec = H265Decoder(device=self.device)
            else:
                from ..codecs.mpeg2.decoder import Mpeg2Decoder

                dec = Mpeg2Decoder(device=self.device)
            dec.set_data(data)
            if self.codec == "h265":
                with self.timers["decoder"]:
                    for frm in dec.decode_all(backend="torch"):
                        self.metrics.inc("frames_decoded")
                        put_frame(frm)
                self.qout.put(_END)
                self.qin.get()
                return
            if self.codec == "h264":
                while True:
                    with self.timers["decoder"]:
                        ready, frm = dec.peek_decoded_frame()
                        while ready:
                            dec.get_decoded_frame()
                            put_frame(frm)
                            if not self.emptify:
                                break  # one frame per decode call
                            ready, frm = dec.peek_decoded_frame()
                        err = dec.decode_picture()
                    if err == 1:
                        self.metrics.inc("frames_decoded")
                    if err < 0:
                        if err == -2:
                            self.metrics.inc("decode_errors")
                        with self.timers["decoder"]:
                            ready, frm = dec.peek_decoded_frame(True)
                            while ready:
                                dec.get_decoded_frame(True)
                                put_frame(frm)
                                ready, frm = dec.peek_decoded_frame(True)
                        break
            else:
                while True:
                    with self.timers["decoder"]:
                        ready, frm = dec.peek_decoded_frame(False)
                        while ready:
                            dec.get_decoded_frame(False)
                            put_frame(frm)
                            if not self.emptify:
                                break  # one frame per decode call
                            ready, frm = dec.peek_decoded_frame(False)
                        err = dec.decode_data()
                    if err == 1:
                        self.metrics.inc("frames_decoded")
                    if err < 0:
                        if err == -2:
                            self.metrics.inc("decode_errors")
                        with self.timers["decoder"]:
                            ready, frm = dec.peek_decoded_frame(True)
                            while ready:
                                dec.get_decoded_frame(True)
                                put_frame(frm)
                                ready, frm = dec.peek_decoded_frame(True)
                        break
            self.qout.put(_END)
            self.qin.get()  # consume END
        except Exception as e:
            self.error = e
            self.qout.put(_END)

    def run(self, sink):
        """Run the pipeline; `sink(frame)` is called from the writer
        thread in output order. Returns frame count."""
        t_r = threading.Thread(target=self._reader, name="pipe-reader")
        t_d = threading.Thread(target=self._decoder, name="pipe-decoder")
        t_r.start()
        t_d.start()
        n = 0
        while True:
            frm = self.qout.get()
            if frm is _END:
                break
            with self.timers["writer"]:
                sink(frm)
            self.metrics.inc("frames_output")
            n += 1
        t_r.join()
        t_d.join()
        if self.error:
            raise self.error
        return n

    # -- profiling -------------------------------------------------------
    def timeline_csv(self) -> str:
        """unithread.h LogDump format: name,start,stop per busy span."""
        rows = []
        for t in self.timers.values():
            for a, b in t.spans:
                rows.append(f"{t.name},{a},{b}")
        return "\n".join(rows) + "\n"
