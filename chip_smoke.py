#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (m2dec_tpu_torch) on one GPU.

Drives the port's two main paths at 1920x1088, each on the bench's
12-picture GOP (IPBPBPBPBPBP, seed 42) with batch 12:

* H.264 through TurboH264Decoder: native C++ Phase A on the host,
  batched Phase B on the card with the four CUDA wavefront kernels;
* MPEG-2 through TurboMpeg2Decoder: native C++ Phase A, batched Phase B
  on the card with the CUDA 8x8 IDCT kernel;
* H.264 on 4 and 8 streams at once through MultiStreamPhaseB (the shape
  of bench.py's turbo_multi): native Phase A on a thread pool, then each
  picture step of all the streams with one launch per wavefront pass;
* H.265 through TurboH265Decoder on bench.py's 1080p H.265 stream
  (IPBPBP, batch 6): native C++ Phase A, Phase B as torch ops on the
  card with the intra wavefront on the CTU-tile schedule as one CUDA
  kernel launch per picture (it replaces an XLA scan: H.265 has no TPU
  kernel), held against the port's CPU Phase B on the level schedule,
  the kernel against its plain version, and four small streams against
  the Python decoder's oracle on both schedules;
* the multi-device steps of ``parallel.mesh`` (phase 11) on the plans
  above: the H.264 stream in 4 MB-row bands, the H.264, H.265 and
  MPEG-2 pictures as GOP shards, the DPB page exchange at 1920x1088, on
  shards in this process on the one card, and the GOP step once through
  a world-size-1 NCCL process group;
* plans without a coded map, as the Python decoder gives them (phase
  12): the 1080p H.264 plans above with their maps taken off through
  BatchedPhaseB and MultiStreamPhaseB, and the Python decoder's plans of
  four small streams against the numpy plan interpreter.

Then it holds each kernel against its plain PyTorch version on the card,
each path against its plain path, against a reference (the numpy plan
interpreter for H.264, the port's CPU path for MPEG-2) and the serial
decoder, every stream of the multi-stream runs against the single-stream
path, and times the kernels, the paths and the stages of Phase B.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

The test streams are made by the repository's test tooling
(``tests/streamgen``, which imports the JAX package's host modules) in
child processes and cached under build/chip_smoke/; this process
imports neither jax nor any module of the JAX package. Every phase
prints one line; a phase that fails raises and the script exits
non-zero. The last line is the JSON result. Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
W, H = 1920, 1088
PATTERN = "IPBPBPBPBPBP"
SEED = 42
#: the second 1080p H.264 stream of the multi-stream phase
SEED2 = 43
BATCH = len(PATTERN)
#: the H.265 stage of bench.py (bench.py:552-555, 596): its pattern and
#: TurboH265Decoder batch
H265_PATTERN = "IPBPBP"
H265_BATCH = 6
#: stream counts of the multi-stream phase (bench.py's sweep)
MULTI_STREAMS = (4, 8)
#: Phase A threads of the multi-stream phase (bench.py's default)
PHASE_A_THREADS = min(4, os.cpu_count() or 1)
CACHE = REPO / "build" / "chip_smoke"

#: cached stream -> (generator module, expression) run in a child process
STREAMS = {
    **{f"h264_{W}x{H}_s{seed}.264": (
        "h264_enc",
        f"H264BGen({W}, {H}, seed={seed}, num_ref_frames=2, "
        f"b_direct_prob=0.3, skip_prob=0.35, intra_prob=0.08, qp=30, "
        f"disable_deblock=False).generate({PATTERN!r})") for seed in (SEED,
                                                                   SEED2)},
    f"m2v_{W}x{H}_s{SEED}.m2v": (
        "mpeg2_enc",
        f"Mpeg2StreamGen({W}, {H}, seed={SEED}).generate({PATTERN!r})"),
    "h264_high_176x144.264": (
        "h264_enc",
        "H264HighGen(176, 144, seed=1, intra_prob=0.2, skip_prob=0.15, "
        "qp=29, disable_deblock=False).generate('IPPIP')"),
    "h264_ipcm_48x32.264": (
        "h264_enc", "H264StreamGen(48, 32, seed=1).generate('III')"),
    "m2v_fieldmc_80x48.m2v": (
        "mpeg2_enc", "Mpeg2FieldMcGen(80, 48, seed=9, field_prob=0.7)"
        ".generate('IPPBP')"),
    "m2v_fieldpic_80x48.m2v": (
        "mpeg2_enc", "Mpeg2FieldPicGen(80, 48, seed=5).generate('IIPPBBPP')"),
    # bench.py:552-555, the H.265 stage's stream
    f"h265_{W}x{H}_s{SEED}.265": (
        "h265_enc",
        f"H265StreamGen({W}, {H}, seed={SEED}, qp=32, cbf_prob=0.4, "
        f"modes=ALL_MODES, tmvp=1, deblock=1, sao=1, max_level=1)"
        f".generate({H265_PATTERN!r})"),
    "h265_ctb32_strong_96x64.265": (
        "h265_enc",
        "H265StreamGen(96, 64, seed=22, ctb_log2=5, qp=14, cbf_prob=0.3, "
        "modes=ALL_MODES, strong_smoothing=1, split_prob=0.3).generate(2)"),
    "h265_tskip_sdh_64x48.265": (
        "h265_enc",
        "H265StreamGen(64, 48, seed=32, qp=14, cbf_prob=0.7, "
        "modes=ALL_MODES, transform_skip=1, sign_data_hiding=1, "
        "split_prob=0.7, nxn_prob=0.8).generate(2)"),
    "h265_amp_64x48.265": (
        "h265_enc",
        "H265StreamGen(64, 48, seed=92, qp=14, cbf_prob=0.4, "
        "modes=ALL_MODES, tmvp=1, part_mode_prob=0.6, amp=1)"
        ".generate('IPB')"),
    # row-aligned 3-slice pictures (slices_per_pic is read by generate)
    "h265_slices3_64x96.265": (
        "h265_enc",
        "(lambda g: (setattr(g, 'slices_per_pic', 3), "
        "g.generate('IPBP'))[1])(H265StreamGen(64, 96, seed=203, qp=30, "
        "cbf_prob=0.5, modes=ALL_MODES, tmvp=1, deblock=1, sao=1, "
        "max_level=1))"),
}
(H264_STREAM, H264_STREAM2, M2V_STREAM, HIGH_STREAM, IPCM_STREAM,
 FIELDMC_STREAM, FIELDPIC_STREAM, H265_STREAM, *H265_COVER) = STREAMS
#: phase 12's 48x32 H.264 streams for the Python decoder's plans, in
#: pairs of one length (S = 2): tests/test_h264_plan.py's
#: test_batched_phase_b stream and tests/test_torch_multistream.py's
#: second mixed stream; a High stream with 8x8 transforms and a B stream
#: with IPCM MBs
PYPLAN_PAIRS = (
    {"h264_plan_48x32.264": (
        "h264_enc",
        "H264BGen(48, 32, seed=3, skip_prob=0.25, intra_prob=0.15, "
        "num_ref_frames=2, b_direct_prob=0.3, direct_spatial=1, qp=30)"
        ".generate('IPBPBB')"),
     "h264_mixed_48x32.264": (
        "h264_enc",
        "H264BGen(48, 32, seed=21, skip_prob=0.1, intra_prob=0.05, "
        "num_ref_frames=2, b_direct_prob=0.4, direct_spatial=1, qp=33)"
        ".generate('IPPBPB')")},
    {"h264_high8x8_48x32.264": (
        "h264_enc",
        "H264HighGen(48, 32, seed=1, intra_prob=0.2, skip_prob=0.15, "
        "qp=29, disable_deblock=False).generate('IPPI')"),
     "h264_ipcm_b_48x32.264": (
        "h264_enc",
        "H264BGen(48, 32, seed=5, skip_prob=0.2, intra_prob=0.3, "
        "ipcm_prob=0.5, num_ref_frames=2, b_direct_prob=0.2)"
        ".generate('IPBP')")},
)
for _pair in PYPLAN_PAIRS:
    STREAMS.update(_pair)

H264_SOURCE = "m2dec_tpu_torch/csrc/h264_wavefront.cu"
IDCT_SOURCE = "m2dec_tpu_torch/csrc/mpeg2_idct.cu"
H265_SOURCE = "m2dec_tpu_torch/csrc/h265_tile.cu"
#: what the H.265 tile kernel replaces: an XLA lax.scan, not a Pallas
#: kernel
H265_REPLACES = "m2dec_tpu/codecs/h265/reconstruct.py:1591"
#: kernel -> the Pallas kernel it replaces
REPLACES = {
    "intra_luma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:125",
    "intra_chroma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:157",
    "deblock_luma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:201",
    "deblock_chroma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:237",
    "idct8x8": "m2dec_tpu/kernels/pallas_idct.py:30",
}
#: the kernels that run a pass in one launch (one CTA per MB row, progress
#: flags): all four wavefront kernels
ROW_KERNELS = ("intra_luma", "intra_chroma", "deblock_luma",
               "deblock_chroma")
#: seconds after which the optional second reference picture is skipped
REF_PIC1_BUDGET_S = 500

#: NVIDIA H100 SXM published peaks: HBM bytes/s and float32 operations/s
#: outside the tensor cores (the nearest published rate for the kernels'
#: int32 arithmetic, whose own rate is not higher)
HBM_BYTES_S = 3.35e12
OPS_S = 67e12
#: integer operations of one 8x8 IDCT block, counted from idct8x8:
#: 8 rows x 54 (13 multiplies, 31 adds, 10 shifts) + 8 columns x 64
#: (13 multiplies, 35 adds, 16 shifts)
IDCT_OPS_PER_BLOCK = 8 * 54 + 8 * 64
#: a lower count of a wavefront pass's operations: one per sample of
#: the planes it writes (the prediction plus residual, or the filter)
WAVEFRONT_OPS_PER_SAMPLE = 1

#: a chain of dependent steps between the CTAs of one kernel: CTA b
#: waits until *flag == b, then sets it to b + 1. A spin gives up after
#: 2^31 cycles (about a second) and sets *err, so a fault ends the
#: kernel instead of hanging the card.
HANDOFF_CU = r"""
extern "C" {
__global__ void handoff_chain(int* flag, int* err) {
  if (threadIdx.x) return;
  volatile int* f = flag;
  const int b = blockIdx.x;
  const long long t0 = clock64();
  while (*f != b) {
    if (clock64() - t0 > (1LL << 31)) { atomicExch(err, 1); return; }
  }
  __threadfence();
  *f = b + 1;
}
int handoff_run(int* flag, int* err, int n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(flag, 0, sizeof(int), s);
  handoff_chain<<<n + 1, 32, 0, s>>>(flag, err);
  return (int)cudaGetLastError();
}
}
"""


def phase(n, text):
    print(f"phase {n} {text}", flush=True)


def start_streams():
    """Start one child process for each test stream not yet cached, all
    at once; returns {name: Popen}."""
    CACHE.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (module, expr) in STREAMS.items():
        out = CACHE / name
        if out.is_file():
            continue
        code = (f"import os, sys\nsys.path[:0] = [{str(REPO)!r}, "
                f"{str(REPO / 'tests')!r}]\n"
                f"from streamgen.{module} import *\n"
                f"data = {expr}\n"
                f"tmp = {str(out) + '.tmp'!r}\n"
                f"open(tmp, 'wb').write(data)\n"
                f"os.replace(tmp, {str(out)!r})\n")
        procs[name] = subprocess.Popen([sys.executable, "-c", code],
                                       cwd=REPO, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    return procs


def stream(name, procs):
    """Stream ``name``'s bytes, once its child process (if any) is done."""
    p = procs.pop(name, None)
    if p is not None:
        _, err = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"making {name} failed:\n{err}")
    return (CACHE / name).read_bytes()


def start_handoff_build(nvcc, flags, procs):
    """Start nvcc on HANDOFF_CU, as procs["handoff_probe"]."""
    src = CACHE / "handoff_probe.cu"
    src.write_text(HANDOFF_CU)
    procs["handoff_probe"] = subprocess.Popen(
        [nvcc, *flags, "-o", str(CACHE / "libhandoff_probe.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def handoff_step_ms(procs, n, dev):
    """Device time of one dependent step between two CTAs of one kernel
    (a flag in global memory, HANDOFF_CU): chains of n and 4n steps,
    median of 5 each, the difference over 3n, so that the launch is not
    counted."""
    import ctypes

    import torch

    proc = procs.pop("handoff_probe")
    _, err = proc.communicate(timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the handoff probe:\n{err}")
    lib = ctypes.CDLL(str(CACHE / "libhandoff_probe.so"))
    lib.handoff_run.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    fault = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def chain(steps):
        if lib.handoff_run(flag.data_ptr(), fault.data_ptr(), steps,
                           stream):
            raise RuntimeError("handoff probe launch failed")

    chain(n)  # warm-up
    ms = {}
    for steps in (n, 4 * n):
        ms[steps] = event_ms(chain, lambda: (steps,), 5)
        if int(fault.item()) or int(flag.item()) != steps + 1:
            raise RuntimeError(f"handoff chain of {steps} broke: flag "
                               f"{int(flag.item())}, fault "
                               f"{int(fault.item())}")
    return (ms[4 * n] - ms[n]) / (3 * n)


def launch_step_ms(n, dev):
    """Device time of one step of a chain of n dependent launches (a
    one-element add), replayed from a CUDA graph so that no host launch
    gap is counted: the floor of a design that launches once per
    dependent step."""
    import torch

    one = torch.zeros(1, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            one.add_(1)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            one.add_(1)
    return event_ms(graph.replay, lambda: (), 5) / n


def max_abs_err(a, b):
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def event_ms(fn, make_args, reps):
    """Median device time of fn(*make_args()) over reps calls (CUDA
    events around each call)."""
    import torch

    ev = []
    for _ in range(reps):
        args = make_args()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args)
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def tensor_bytes(ts):
    """Bytes of a sequence of tensors."""
    return sum(t.numel() * t.element_size() for t in ts)


def phase_a(pool, datas):
    """The native Phase A of each stream in ``datas`` on the thread pool
    (the C++ slice decode releases the GIL); returns the decoders."""
    from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder

    def one(data):
        dec = H264Decoder(native=True, plan_alloc="empty")
        dec.set_data(data)
        while dec.decode_picture() == 1:
            pass
        return dec

    return list(pool.map(one, datas))


def stage_split(ms, plans_per_stream, wavefront_fns):
    """One run of ``ms`` on the plans with a synchronize around every
    stage of Phase B; returns {stage: ms per picture step}. The stages:
    host pack, the H2D copy, unpack + residual, inter_pass, assembly (the
    rest of the per-picture core: the inter picture, the PCM select, the
    planes' layout), each of the four passes and the pool write."""
    import torch

    from m2dec_tpu_torch.codecs.h264 import reconstruct as R
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK

    secs = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    def wavefronts(y, cb, cr, P, has_i8, deblock, mb_w, mb_h):
        y = timed("intra_luma", WK.intra_luma)(y, P, has_i8, mb_w, mb_h)
        cb, cr = timed("intra_chroma", WK.intra_chroma)(cb, cr, P, mb_w,
                                                         mb_h)
        if deblock:
            y = timed("deblock_luma", WK.deblock_luma)(y, P, mb_w, mb_h)
            cb, cr = timed("deblock_chroma", WK.deblock_chroma)(
                cb, cr, P, mb_w, mb_h)
        return y, cb, cr

    patches = [(R.MultiStreamPhaseB, "_host_batch", "host pack"),
               (R.MultiStreamPhaseB, "_upload", "H2D copy"),
               (R, "_unpack_batch", "unpack + residual"),
               (R, "inter_pass", "inter_pass"), (R, "_recon_core", "core"),
               (R.MultiStreamPhaseB, "_store", "pool write")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, key in patches:
        setattr(obj, name, timed(key, getattr(obj, name)))
    ms.wavefronts, fns = wavefronts, ms.wavefronts
    try:
        ms.reset()
        t0 = time.perf_counter()
        ms.run(plans_per_stream)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        ms.wavefronts = fns
    steps = len(plans_per_stream[0])
    secs["assembly"] = (secs.pop("core") - secs["inter_pass"]
                        - sum(secs.get(k, 0.0) for k in wavefront_fns))
    secs["total"] = total
    return {k: round(1e3 * v / steps, 3) for k, v in secs.items()}


def multi_stream(dev, smi, procs, data, kern, geom):
    """Phase 8: H.264 on 4 and 8 1080p streams through MultiStreamPhaseB,
    the seed-42 and seed-43 streams in turn. Every stream's checksum is
    held against the single-stream kernel path (for seed 42, the picture
    stack that phase 3 verified) and each run must launch each wavefront
    kernel once per picture step, before anything is timed. Returns
    (launches per S, {kernel: [stacked ms at S = 4, one stream's ms]} on
    picture step 0, the seed-43 stream's plans, the per-stream checksums
    of the two sources)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.reconstruct import (
        BatchedPhaseB,
        MultiStreamPhaseB,
    )

    sync = torch.cuda.synchronize
    mb_w, mb_h, pool = geom
    sources = (data, stream(H264_STREAM2, procs))
    with ThreadPoolExecutor(PHASE_A_THREADS) as ex:
        # the single-stream kernel path of each source
        dec2 = phase_a(ex, sources[1:])[0]
        want = [MultiStreamPhaseB.checksums([kern])[0],
                MultiStreamPhaseB.checksums([BatchedPhaseB(
                    *geom, device=dev).run_async(dec2.plans)])[0]]
        if np.array_equal(want[0], want[1]):
            raise RuntimeError("the two sources decode to the same pictures")
        datas = {S: [sources[s % 2] for s in range(S)] for S in MULTI_STREAMS}

        # correctness first, for every S; the inputs of the passes on
        # picture steps 0 and 2 at S = 4
        captured = {}

        def capturing(y, cb, cr, P, has_i8, deblock, mbw, mbh):
            k = captured.setdefault("steps", 0)
            captured["steps"] = k + 1
            if k in (0, 2):
                captured[k] = (y.clone(), cb.clone(), cr.clone(),
                               {n: v.clone() for n, v in P.items()}, has_i8)
            return WK.run_wavefronts(y, cb, cr, P, has_i8, deblock, mbw,
                                     mbh)

        launches = {}
        for S in MULTI_STREAMS:
            plans = [d.plans for d in phase_a(ex, datas[S])]
            ms = MultiStreamPhaseB(
                S, *geom, device=dev,
                wavefronts=capturing if S == 4 else WK.run_wavefronts)
            WK.reset_launch_counts()
            cks = MultiStreamPhaseB.checksums(ms.run(plans))
            launches[S] = dict(WK.LAUNCHES)
            bad = [s for s in range(S) if not np.array_equal(cks[s],
                                                             want[s % 2])]
            if bad:
                raise RuntimeError(f"{S} streams: streams {bad} differ from "
                                   f"the single-stream kernel path")
            if launches[S] != {k: BATCH for k in ROW_KERNELS}:
                raise RuntimeError(f"{S} streams: wavefront launches "
                                   f"{launches[S]}, want {BATCH} each")
        phase(8, f"H.264 {W}x{H} on {' and '.join(map(str, MULTI_STREAMS))} "
                 f"streams (seeds {SEED} and {SEED2} in turn) through "
                 f"MultiStreamPhaseB: every stream's checksum equal to the "
                 f"single-stream kernel path (seed {SEED}: the stack phase 3 "
                 f"verified); wavefront launches per run "
                 + json.dumps({S: sum(v.values())
                               for S, v in launches.items()})
                 + f" for {BATCH} picture steps (4 per step, whatever S)")

        # timing: end to end as bench.py's turbo_multi (threaded Phase A,
        # Phase B, checksums), and Phase B alone; median of 3 warm runs
        for S in MULTI_STREAMS:
            ms = MultiStreamPhaseB(S, *geom, device=dev)
            e2e, pa, pb = [], [], []
            for _ in range(4):  # the first run warms up
                ms.reset()
                sync()
                t0 = time.perf_counter()
                plans = [d.plans for d in phase_a(ex, datas[S])]
                t1 = time.perf_counter()
                cks = MultiStreamPhaseB.checksums(ms.run(plans))
                e2e.append(time.perf_counter() - t0)
                pa.append(t1 - t0)
                if any(not np.array_equal(cks[s], want[s % 2])
                       for s in range(S)):
                    raise RuntimeError(f"{S} streams: a timed run differs")
                ms.reset()
                sync()
                t0 = time.perf_counter()
                ms.run(plans)
                sync()
                pb.append(time.perf_counter() - t0)
            e2e_s, pa_s, pb_s = (statistics.median(v[1:])
                                 for v in (e2e, pa, pb))
            pics = S * BATCH
            phase(8, f"{S} streams on {smi}: end to end {pics / e2e_s:.2f} "
                     f"fps per GPU ({1e3 * e2e_s / pics:.3f} ms/picture: "
                     f"Phase A on {PHASE_A_THREADS} threads, Phase B, "
                     f"checksums); Phase A {1e3 * pa_s / pics:.3f} "
                     f"ms/picture; Phase B {1e3 * pb_s / pics:.3f} "
                     f"ms/picture, {1e3 * pb_s / BATCH:.2f} ms per picture "
                     f"step of {S} streams; median of 3 warm runs each")

        # each pass stacked at S = 4 against the same pass on one stream
        # (stream 0), CUDA events, median of 20, picture steps 0 and 2
        S = 4
        n = mb_w * mb_h
        stacked_ms = {}
        for k in (0, 2):
            y, cb, cr, P, has_i8 = captured[k]
            iy = WK.intra_luma(y.clone(), P, has_i8, mb_w, mb_h)
            icb, icr = WK.intra_chroma(cb.clone(), cr.clone(), P, mb_w,
                                       mb_h)
            P1 = {name: v[:n] for name, v in P.items()}
            passes = {"intra_luma": (WK.intra_luma, (y,), (has_i8,)),
                      "intra_chroma": (WK.intra_chroma, (cb, cr), ()),
                      "deblock_luma": (WK.deblock_luma, (iy,), ()),
                      "deblock_chroma": (WK.deblock_chroma, (icb, icr),
                                         ())}
            for name, (fn, planes, extra) in passes.items():
                stacked_ms.setdefault(name, []).extend([
                    event_ms(fn, lambda: (*(t.clone() for t in planes), P,
                                          *extra, mb_w, mb_h), 20),
                    event_ms(fn, lambda: (*(t[0].clone() for t in planes),
                                          P1, *extra, mb_w, mb_h), 20)])
        phase(8, f"wavefront passes at {S} streams on {smi} [stacked "
                 f"picture step 0, one stream's picture 0, stacked step 2, "
                 f"one stream's picture 2] ms (CUDA events, median of 20): "
                 + json.dumps({k: [round(v, 4) for v in vs]
                               for k, vs in stacked_ms.items()}))

        # the Phase B split, one run each with a synchronize per stage
        for S in (1, 4):
            plans = [d.plans for d in phase_a(ex, datas[4][:S])]
            split = stage_split(MultiStreamPhaseB(S, *geom, device=dev),
                                plans, ROW_KERNELS)
            phase(8, f"Phase B split at {S} stream{'s' * (S > 1)} on {smi}, "
                     f"ms per picture step, a synchronize around each stage: "
                     + json.dumps(split))
    return launches, stacked_ms, dec2.plans, want


def h265_split(ph, plans):
    """One run of H265SeqPhaseB ``ph`` on the plans, each picture step
    eager, with a synchronize around every stage of Phase B; returns
    {stage: ms per picture}. The
    stages: host pack (plan stacking and the wavefront's host schedule:
    the z-slot words in tile mode, the level schedule in level mode),
    upload (the pinned fill and the one host->device copy), residual,
    MC, the intra wavefront (the tile kernel, or the luma and chroma
    levels), deblock, SAO, assembly (the rest of the per-picture work:
    the inter picture, the padded planes) and the pool write."""
    import torch

    from m2dec_tpu_torch.codecs.h265 import reconstruct as R
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK

    secs = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    patches = [(R, "stack_plans", "host pack"), (R, "_upload", "upload"),
               (R, "residual_plane", "residual"), (R, "inter_pass", "MC"),
               (TK, "tile_wavefront", "intra tile kernel"),
               (R, "_wavefront_luma", "luma levels"),
               (R, "_wavefront_chroma", "chroma levels"),
               (R, "deblock_frame", "deblock"), (R, "sao_plane", "SAO"),
               (R, "_recon_picture", "core"),
               (R.H265SeqPhaseB, "_store", "pool write")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, key in patches:
        setattr(obj, name, timed(key, getattr(obj, name)))
    # every step eager: a replayed CUDA graph has no stages to time
    saved.append((R.H265SeqPhaseB, "_step", R.H265SeqPhaseB._step))
    R.H265SeqPhaseB._step = lambda self, x, m: R._recon_picture(
        x, m, *self.pool, self.wf)
    try:
        for p in plans:  # the level schedule is cached per plan
            p.__dict__.pop("_levels", None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ph.run_async(plans)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    inner = ("residual", "MC", "intra tile kernel", "luma levels",
             "chroma levels", "deblock", "SAO")
    secs["assembly"] = secs.pop("core") - sum(secs.get(k, 0.0)
                                              for k in inner)
    secs["total"] = total
    return {k: round(1e3 * v / len(plans), 3) for k, v in secs.items()}


def tile_bounds(args, step_ms):
    """(bound ms, bound_by, dependency floor ms, intra samples) of the
    tile kernel on one picture's inputs ``args`` (tile_wavefront's). The
    bytes and operations this picture's ops need: each intra sample's
    residual read and the sample written (4 bytes each), the z-slot
    words read; one operation per intra sample. The dependency floor:
    the handoffs between CTAs on the critical path (a band waits on the
    band above: rows - 1 of them) x one flag handoff (step_ms)."""
    _, _, _, _, zl, zc, H, W, ctb_log2, _ = args
    samples = 0
    for words, planes in ((zl, 1), (zc, 2)):
        w = words.cpu().numpy()
        live = w[(w & 1) != 0]
        samples += planes * int((1 << (2 * (((live >> 2) & 3) + 2))).sum())
    moved = 8 * samples + tensor_bytes([zl, zc])
    bytes_ms = 1e3 * moved / HBM_BYTES_S
    ops_ms = 1e3 * WAVEFRONT_OPS_PER_SAMPLE * samples / OPS_S
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            ((H >> ctb_log2) - 1) * step_ms, samples)


def h265(dev, smi, procs, step_ms):
    """Phase 9: the H.265 main path, TurboH265Decoder on bench.py's 1080p
    stream (CTB 16: the CTU-tile schedule, one launch of the tile kernel
    per picture), then its checks (every frame against the port's CPU
    Phase B on the level schedule over the same plans; the tile kernel
    against its plain version on the card on pictures 0 (I) and 1 (P);
    four small streams against the Python decoder's oracle on both
    schedules) and its figures (Phase B on both schedules in turns).
    step_ms: one flag handoff between CTAs (phase 7's probe). Returns
    ((plans, (H, W, pool size), per-picture checksums of the verified
    batch), the tile kernel's entry of the kernels line)."""
    import ctypes

    import numpy as np
    import torch

    from m2dec_tpu_torch import _build
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h265 import reconstruct as R
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK
    from m2dec_tpu_torch.codecs.h265.headers import H265Decoder
    from m2dec_tpu_torch.kernels import idct_kernels as IK
    from m2dec_tpu_torch.runtime.golden import frame_checksums
    from m2dec_tpu_torch.runtime.turbo import TurboH265Decoder

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    data = stream(H265_STREAM, procs)
    wait_s = time.perf_counter() - t_phase

    def cks(planes):
        return sorted(tuple(c.flatten().tolist())
                      for c in frame_checksums(*planes).cpu())

    def turbo_run():
        """TurboH265Decoder on the stream: [(poc, crop, checksums)]."""
        out = []
        for frm, outs, i in TurboH265Decoder(data, batch=H265_BATCH,
                                             device=dev).device_frames():
            if outs is None:
                raise RuntimeError("an H.265 frame was output without a "
                                   "plan")
            out.append((frm.cnt, frm.crop, frame_checksums(
                outs[0][i:i + 1], outs[1][i:i + 1], outs[2][i:i + 1])))
        sync()
        return out

    # the main path, with the counts of every kernel at 0 before it
    WK.reset_launch_counts()
    IK.reset_launch_counts()
    TK.reset_launch_counts()
    t0 = time.perf_counter()
    frames = turbo_run()
    main_s = time.perf_counter() - t0
    launches = {**WK.LAUNCHES, **IK.LAUNCHES, **TK.LAUNCHES}
    if len(frames) != len(H265_PATTERN):
        raise RuntimeError(f"H.265 main path output {len(frames)} frames, "
                           f"want {len(H265_PATTERN)}")
    if [f[0] for f in frames] != sorted(f[0] for f in frames):
        raise RuntimeError("H.265 frames out of POC order")
    want = {k: len(frames) if k == "h265_tile" else 0 for k in launches}
    if launches != want:
        raise RuntimeError(f"H.265 main path launches {launches}, want "
                           f"{want}: the tile kernel once per picture")
    phase(9, f"H.265 main path on {smi}: TurboH265Decoder {W}x{H} "
             f"{H265_PATTERN} batch {H265_BATCH}: {len(frames)} frames in "
             f"{main_s:.2f} s, cold (stream {len(data)} B, waited "
             f"{wait_s:.1f} s for it); kernel launches "
             f"{json.dumps(launches)}: the tile kernel once per picture")

    # Phase A alone, and the plans of the checks
    def phase_a():
        dec = H265Decoder(device=dev)
        dec.set_data(data)
        dec.begin_decode(backend="native", defer_recon=True)
        t0 = time.perf_counter()
        while dec.decode_picture() == 1:
            pass
        return dec, time.perf_counter() - t0

    runs = [phase_a() for _ in range(3)]
    plans = runs[0][0].plans
    pool = len(runs[0][0].pool)
    pa_ms = 1e3 * statistics.median(s for _, s in runs) / len(plans)
    n = len(plans)
    if R.wf_mode_for(plans[0].size_log2) != "tile":
        raise RuntimeError("the bench stream's CTB does not take the tile "
                           "schedule")

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t, out

    geom = (plans[0].H, plans[0].W, pool)
    ph = R.H265SeqPhaseB(*geom, device=dev)  # the default: tile
    ph_level = R.H265SeqPhaseB(*geom, device=dev, wf_mode="level")
    # a tile run that keeps the kernel's inputs of pictures 0 and 1
    captured = []
    real = TK.tile_wavefront

    def capturing(*args):
        # a capture of a picture step records the launch, not its inputs
        if (len(captured) < 2
                and not torch.cuda.is_current_stream_capturing()):
            captured.append(tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args))
        return real(*args)

    TK.tile_wavefront = capturing
    try:
        card_s, card = timed(lambda: ph.run_async(plans))
    finally:
        TK.tile_wavefront = real
    level_s, level = timed(lambda: ph_level.run_async(plans))  # graphs
    cpu_s, cpu = timed(lambda: R.H265SeqPhaseB(
        *geom, device="cpu", wf_mode="level").run_async(plans))
    for i in range(n):
        for pl, a, b, c in zip(("y", "cb", "cr"), card, level, cpu):
            if not torch.equal(a[i].cpu(), c[i]):
                raise RuntimeError(f"H.265 picture {i} {pl}: the card's "
                                   f"Phase B != the port's CPU Phase B")
            if not torch.equal(a[i], b[i]):
                raise RuntimeError(f"H.265 picture {i} {pl}: the tile "
                                   f"schedule != the level schedule")
    if cks(card) != sorted(tuple(f[2].flatten().tolist()) for f in frames):
        raise RuntimeError("H.265 main-path frames differ from the batched "
                           "Phase B")

    # the tile kernel against its plain version on the card: pictures 0
    # (I) and 1 (P), each on its captured inputs (the kernel works in
    # place, so each call gets fresh copies of the planes)
    def tile_args(k):
        a = captured[k]
        return lambda: (a[0].clone(), a[1].clone(), *a[2:])

    tile_err, tile_ms, plain_ms = [], [], None
    for k in range(2):
        mk = tile_args(k)
        args = mk()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        want = R._wavefront_tile_plain(*args)
        e.record()
        sync()
        if k == 0:
            plain_ms = s.elapsed_time(e)
        got = TK.tile_wavefront(*mk())
        sync()
        tile_err.append(max(max_abs_err(g, w) for g, w in zip(got, want)))
        tile_ms.append(event_ms(TK.tile_wavefront, mk, 20))
    if any(tile_err):
        raise RuntimeError(f"the tile kernel differs from its plain version "
                           f"on pictures 0 and 1: max abs err {tile_err}")
    bounds = [tile_bounds(captured[k], step_ms) for k in range(2)]
    # the longest chain of ops of each picture (luma, chroma), which the
    # kernel's time follows; the grid and the build's resources
    chains = [[TK.op_chain(words, a[7] >> a[8], a[6] >> a[8])
               for words in a[4:6]] for a in captured]
    grid = ctypes.c_int(0)
    smem = _build.load_library("h265_tile").h265_tile_grid(
        plans[0].H, plans[0].W, plans[0].size_log2, ctypes.addressof(grid))
    ptxas = [ln.split(":", 1)[-1].strip() for ln in
             _build.LAST_BUILD.get("h265_tile", "").splitlines()
             if "registers" in ln or "spill" in ln]
    phase(9, f"H.265 tile kernel vs plain on {smi}: pictures 0 (I) and 1 "
             f"(P) byte-equal (max abs err {tile_err}); kernel "
             f"{tile_ms[0]:.4f} and {tile_ms[1]:.4f} ms (CUDA events, "
             f"median of 20), plain {plain_ms:.1f} ms on picture 0 (once); "
             f"intra samples {[b[3] for b in bounds]}; bound "
             f"{bounds[0][0]:.5f} and {bounds[1][0]:.5f} ms "
             f"({bounds[0][1]}); dependency floor {bounds[0][2]:.4f} ms "
             f"({(plans[0].H >> plans[0].size_log2) - 1} handoffs x "
             f"{1e3 * step_ms:.3f} us); longest chain of ops [luma, "
             f"chroma] {chains}, so {1e3 * tile_ms[0] / chains[0][0]:.3f} "
             f"and {1e3 * tile_ms[1] / chains[1][0]:.3f} us per luma chain "
             f"op; grid {grid.value} CTAs of two warps, {smem} bytes of "
             f"dynamic shared memory each; ptxas {ptxas or '(cached)'}")

    # the small streams on the card against the Python decoder's oracle,
    # on both schedules (tile forced at CTB 32), and TurboH265Decoder's
    # default
    cover = []
    for name in H265_COVER:
        s = stream(name, procs)
        dec = H265Decoder(device="cpu")
        dec.set_data(s)
        exp = dec.decode_all(collect_plans=True, keep_oracle=True)
        for mode in ("tile", "level"):
            n0 = TK.LAUNCHES["h265_tile"]
            outs = R.replay_plans(dec.plans, device=dev, wf_mode=mode)
            if TK.LAUNCHES["h265_tile"] - n0 != (
                    len(dec.plans) if mode == "tile" else 0):
                raise RuntimeError(f"{name}: tile launches in {mode} mode")
            for k, (p, planes) in enumerate(zip(dec.plans, outs)):
                for pl, a, b in zip(("y", "cb", "cr"), planes, p.oracle):
                    if not np.array_equal(a, b):
                        raise RuntimeError(
                            f"{name}: picture {k} {pl} on the {mode} "
                            f"schedule != the Python decoder's oracle")
        got = TurboH265Decoder(s, batch=2, device=dev).decode_all()
        if len(got) != len(exp):
            raise RuntimeError(f"{name}: {len(got)} frames, want "
                               f"{len(exp)}")
        for k, (g, e) in enumerate(zip(got, exp)):
            for pl in ("y", "cb", "cr"):
                if not np.array_equal(getattr(g, pl), getattr(e, pl)):
                    raise RuntimeError(f"{name}: frame {k} {pl} differs")
        multi = any(p.multi_slice for p in dec.plans)
        cover.append(f"{name} ({len(dec.plans)} pictures, CTB "
                     f"{1 << dec.plans[0].size_log2}"
                     f"{', multi-slice' if multi else ''})")
    phase(9, f"H.265 checks: {n} pictures of the card's Phase B (tile "
             f"schedule) equal to the port's CPU Phase B on the level "
             f"schedule byte for byte (the CPU of the host of {smi}: "
             f"{1e3 * cpu_s / n:.0f} ms/picture) and to the card's level "
             f"schedule, and the main path's frames to them by device "
             f"checksum; on the card, Phase B on both schedules and "
             f"TurboH265Decoder equal to the Python decoder's oracle on "
             + "; ".join(cover))

    # figures: Phase B on both schedules in turns (tile, level, level,
    # tile, ...), end to end, the split, the ops and levels per picture
    # and one tile batch under the profiler
    pb = {"tile": [], "level": []}
    for k in range(6):
        mode = ("tile", "level")[(k + k // 2) % 2]
        pb[mode].append(timed(lambda: (ph if mode == "tile" else ph_level)
                              .run_async(plans))[0])
    pb_ms = {m: 1e3 * statistics.median(v) / n for m, v in pb.items()}
    e2e_ms = 1e3 * statistics.median(
        timed(turbo_run)[0] for _ in range(3)) / len(frames)
    phase(9, f"H.265 timing on {smi}: {W}x{H} {H265_PATTERN}, Phase A "
             f"{pa_ms:.2f} ms/picture on the host (native, median of 3); "
             f"Phase B on the tile schedule {pb_ms['tile']:.2f} "
             f"ms/picture, on the level schedule {pb_ms['level']:.1f} "
             f"(warm, median of 3 x {n} each, run in turns; the first "
             f"runs {1e3 * card_s / n:.1f} (tile, with the kernel's "
             f"inputs copied) and {1e3 * level_s / n:.1f} (level, "
             f"capturing its CUDA graphs)); end to end (TurboH265Decoder "
             f"batch {H265_BATCH}, Phase A + B, tile, warm) {e2e_ms:.1f} "
             f"ms/picture ({1e3 / e2e_ms:.3f} fps, median of 3)")
    split = h265_split(ph, plans)
    phase(9, f"H.265 Phase B split on the tile schedule on {smi}, ms per "
             f"picture, a synchronize around each stage: "
             + json.dumps(split))
    ops = [[int((z & 1).astype(bool).sum()) for z in R._ctu_zslots(p)]
           for p in plans]
    levels = [[len(m.banks[0][1]), len(m.banks[2][1])]
              for m in (R._PicMeta(p, wf_mode="level") for p in plans)]
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_s = timed(lambda: ph.run_async(plans))[0]
    n_kern = n_copy = 0
    busy_ns = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ns += ev.duration_ns()
            if ev.name().startswith(("Memcpy", "Memset")):
                n_copy += 1
            else:
                n_kern += 1
    phase(9, f"H.265 intra ops per picture in decode order [luma, chroma "
             f"(each for cb and cr)]: {json.dumps(ops)}; level counts of "
             f"the level schedule [luma, chroma]: {json.dumps(levels)}; one "
             f"tile batch under torch.profiler on {smi}: "
             f"{n_kern / n:.0f} CUDA kernels and {n_copy / n:.1f} "
             f"copies/memsets per picture, {1e3 * prof_s / n:.1f} "
             f"ms/picture of wall time, {busy_ns / 1e6 / n:.2f} ms/picture "
             f"of device time (busy share {busy_ns / 1e9 / prof_s:.4f}); "
             f"profiling and reading the events took "
             f"{time.perf_counter() - t0:.1f} s")
    took = time.perf_counter() - t_phase
    phase(9, f"H.265 phase took {took:.1f} s on {smi}")
    verified = (plans, geom, frame_checksums(*card).cpu())
    return verified, {
        "name": "h265_tile", "route": "cuda", "source": H265_SOURCE,
        "replaces": H265_REPLACES, "launches": launches["h265_tile"],
        "max_abs_err": max(tile_err), "ms": tile_ms[0],
        "plain_ms": plain_ms, "bound_ms": bounds[0][0],
        "bound_by": bounds[0][1], "library_ms": None,
        "dependency_ms": bounds[0][2], "inter_ms": tile_ms[1],
        "chain_ops": chains, "multistream_launches": None,
        "stacked4_ms": None}


def make_ps(m2v_name):
    """An MPEG program stream wrap of cached stream ``m2v_name``, made
    by tests/streamgen/ps_mux.py in a child process and cached beside
    it; returns its path. Video PES packets of 2048 bytes (a 1080p
    picture passes the 16-bit PES length)."""
    src = CACHE / m2v_name
    out = src.with_suffix(".mpg")
    if not out.is_file():
        tmp = str(out) + ".tmp"
        code = (f"import os, sys\nsys.path.insert(0, "
                f"{str(REPO / 'tests')!r})\n"
                f"from streamgen.ps_mux import mux_ps\n"
                f"data = open({str(src)!r}, 'rb').read()\n"
                f"open({tmp!r}, 'wb').write(mux_ps(data, packet_size=2048))\n"
                f"os.replace({tmp!r}, {str(out)!r})\n")
        subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                       capture_output=True, timeout=300)
    return out


def entry_points(dev, smi, procs, data, m2data, h264_cks, m2_cks):
    """Phase 10: the port's command-line tools on the card, in-process
    through their main([...]) in a temporary directory: h264dec --turbo
    -O, -C and the flag-less -O (the default path: the per-picture
    native Phase A and torch Phase B, the JAX tool's --jax) on the 1080p
    H.264 stream; m2dec -O and h264dec -s -O on a program-stream wrap of
    the 1080p MPEG-2 stream; m2dec --fast -o on the MPEG-2 stream;
    thrplay -m, with and without --turbo, on a playlist of both and a
    small H.265 stream. Each output is held to frames verified before:
    the Turbo drivers' frames of phases 2 and 5 (their device checksums
    equal to those phases', in output order), the port's CPU fast path,
    and the Python H.265 decoder's frames. Every Pipeline of a thrplay
    run must finish with no serial replay (its ``replays`` counter), and
    the H.265 leg (CTB 16) must launch the tile kernel once per picture,
    so it ran through the Turbo driver or the serial decoder it was
    given, on the card.
    Returns ({kernel: {run: launches}}, seconds)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from m2dec_tpu_torch.apps import h264dec, m2dec, thrplay
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK
    from m2dec_tpu_torch.codecs.h265.headers import H265Decoder
    from m2dec_tpu_torch.codecs.mpeg2.decoder import Mpeg2Decoder
    from m2dec_tpu_torch.kernels import idct_kernels as IK
    from m2dec_tpu_torch.runtime.golden import host_checksum, host_cks_file
    from m2dec_tpu_torch.runtime.output import (
        cropped_nv12_bytes,
        frame_md5_line,
    )
    from m2dec_tpu_torch.runtime.pipeline import Pipeline
    from m2dec_tpu_torch.runtime.turbo import (
        TurboH264Decoder,
        TurboMpeg2Decoder,
    )

    t_phase = time.perf_counter()

    def verified(cls, stream, want, name):
        """The Turbo driver's host frames of ``stream``, each held to the
        device checksum of the same frame of an earlier phase."""
        frames = list(cls(stream, batch=BATCH, device=dev).frames())
        if len(frames) != len(want):
            raise RuntimeError(f"{name}: {len(frames)} frames, want "
                               f"{len(want)}")
        for k, (f, c) in enumerate(zip(frames, want)):
            if not np.array_equal(host_checksum(f.y, f.cb, f.cr),
                                  c[0].cpu().numpy()):
                raise RuntimeError(f"{name}: frame {k} differs from the "
                                   f"verified run")
        return frames

    h264_frames = verified(TurboH264Decoder, data, h264_cks, "H.264")
    m2_frames = verified(TurboMpeg2Decoder, m2data, m2_cks, "MPEG-2")
    h264_md5 = b"".join(frame_md5_line(f) for f in h264_frames)
    m2_md5 = b"".join(frame_md5_line(f) for f in m2_frames)
    f0 = h264_frames[0]
    h264_cks_text = host_cks_file(
        b"".join(cropped_nv12_bytes(f) for f in h264_frames),
        f0.width - f0.crop[0] - f0.crop[1],
        f0.height - f0.crop[2] - f0.crop[3])
    fast = Mpeg2Decoder(fast=True, device="cpu")
    fast.set_data(m2data)
    fast_raw = b"".join(cropped_nv12_bytes(f) for f in fast.decode_all())
    h265_name = H265_COVER[2]
    h265_data = stream(h265_name, procs)
    oracle = H265Decoder()
    oracle.set_data(h265_data)
    h265_md5 = b"".join(frame_md5_line(f) for f in oracle.decode_all())
    n265 = h265_md5.count(b"\r\n")
    ps_path = make_ps(M2V_STREAM)

    kernels = (*ROW_KERNELS, "idct8x8", "h265_tile")
    cli_launches = {k: {} for k in kernels}
    pipes = []  # (codec, replays) of each Pipeline run of a tool run
    pipeline_run = Pipeline.run

    def counted_run(self, sink):
        n = pipeline_run(self, sink)
        pipes.append((self.codec, self.metrics.count("replays")))
        return n

    Pipeline.run = counted_run
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        (td / "h264.264").write_bytes(data)
        (td / "m2v.m2v").write_bytes(m2data)
        (td / "m2v.mpg").write_bytes(ps_path.read_bytes())
        (td / "h265.265").write_bytes(h265_data)
        cwd = os.getcwd()
        os.chdir(td)
        try:
            def run(tool, argv, outputs, n_frames, want_launches,
                    want_pipes=()):
                """One tool run with the counts at 0 before it: checks
                its exit code, each output file against its expected
                bytes, the launches of each kernel and the (codec,
                replays) of each Pipeline; prints its line."""
                name = f"{tool.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}"
                for p in outputs:
                    (td / p).unlink(missing_ok=True)
                WK.reset_launch_counts()
                IK.reset_launch_counts()
                TK.reset_launch_counts()
                pipes.clear()
                err = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stderr(err):
                    code = tool.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {**WK.LAUNCHES, **IK.LAUNCHES, **TK.LAUNCHES}
                if code != 0:
                    raise RuntimeError(f"{name}: exit {code}: "
                                       f"{err.getvalue()}")
                for p, want in outputs.items():
                    if (td / p).read_bytes() != want:
                        raise RuntimeError(f"{name}: {p} differs from the "
                                           f"verified frames")
                bad = {k: got[k] for k in kernels
                       if (got[k] != want_launches.get(k, 0))}
                if bad:
                    raise RuntimeError(f"{name}: launches {bad}, want "
                                       f"{want_launches}")
                if pipes != list(want_pipes):
                    raise RuntimeError(f"{name}: pipelines (codec, "
                                       f"replays) {pipes}, want "
                                       f"{list(want_pipes)}")
                for k in kernels:
                    cli_launches[k][name] = got[k]
                phase(10, f"{name}: {n_frames} frames in {wall:.3f} s "
                          f"({n_frames / wall:.2f} fps, wall clock, cold "
                          f"tool run, outputs equal to the verified "
                          f"frames); launches "
                          f"{json.dumps({k: got[k] for k in kernels})}; "
                          f"pipelines (codec, replays) {pipes}; {smi}")

            n264, nm2 = len(h264_frames), len(m2_frames)
            per_pic = {k: n264 for k in ROW_KERNELS}
            run(h264dec, ["--turbo", "-O", "h264.264"],
                {"h264.out": h264_md5}, n264, per_pic)
            run(h264dec, ["-C", "h264.264"],
                {"h264.out": h264_cks_text.encode()}, n264, per_pic)
            # the default path: native Phase A, torch Phase B per picture
            run(h264dec, ["-O", "h264.264"],
                {"h264.out": h264_md5}, n264, per_pic)
            # the serial MPEG-2 decoder: one IDCT launch per picture
            run(m2dec, ["-O", "m2v.md5", "m2v.mpg"], {"m2v.md5": m2_md5},
                nm2, {"idct8x8": nm2})
            run(h264dec, ["-s", "-O", "m2v.mpg"], {"m2v.out": m2_md5}, nm2,
                {"idct8x8": nm2})
            run(m2dec, ["--fast", "-o", "fast.raw", "m2v.m2v"],
                {"fast.raw": fast_raw}, nm2, {})
            # the Turbo drivers, no serial replay: the H.264 passes and
            # the H.265 tile kernel once per picture, the IDCT once per
            # batch of the MPEG-2 stream
            playlist = {"h264.out": h264_md5, "m2v.out": m2_md5,
                        "h265.out": h265_md5}
            n_list = n264 + nm2 + n265
            no_replay = [("h264", 0), ("mpeg2", 0), ("h265", 0)]
            run(thrplay, ["--turbo", "-m", "h264.264", "m2v.mpg",
                          "h265.265"], playlist, n_list,
                {**per_pic, "idct8x8": -(-nm2 // BATCH),
                 "h265_tile": n265}, no_replay)
            # the Pipeline's serial decoders on the card: the H.264
            # passes, the IDCT and the tile kernel once per picture
            run(thrplay, ["-m", "h264.264", "m2v.mpg", "h265.265"],
                playlist, n_list, {**per_pic, "idct8x8": nm2,
                                   "h265_tile": n265}, no_replay)
        finally:
            os.chdir(cwd)
            Pipeline.run = pipeline_run
    took = time.perf_counter() - t_phase
    phase(10, f"entry points took {took:.1f} s on {smi}")
    return cli_launches, took


def dense_plan(plan):
    """A native Phase A plan as a plan object that the dense consumers
    (``reconstruct_plan_torch``, the mesh steps) take, and as the Python
    decoder gives its plans: its tensors (``_PLAN_KEYS``) with the
    coefficient blocks that its coded map marks as not written set to 0
    (``plan_host.coded_coefs``: ``plan_alloc="empty"`` leaves them
    uninitialised, since the wire packer reads only the coded ones), and
    no coded map (``coded=None``), which the packer then derives."""
    import types

    from m2dec_tpu_torch.codecs.h264.plan_host import _PLAN_KEYS, coded_coefs

    out = types.SimpleNamespace(
        **{k: getattr(plan, k) for k in _PLAN_KEYS}, mb_w=plan.mb_w,
        mb_h=plan.mb_h, n=plan.n, cur_idx=plan.cur_idx, pcm=plan.pcm,
        live=plan.live, used_slots=plan.used_slots, coded=None)
    out.coef_luma, out.coef_chroma = coded_coefs(plan)
    return out


def mesh_phase(dev, smi, h264, h265_verified, m2, t_start):
    """Phase 11: the port's multi-device decode (``parallel.mesh``) on the
    card, on the plans and verified checksums of the earlier phases: the
    1080p H.264 stream's 12 pictures as 4 MB-row bands; the two H.264
    streams of phase 8 as 4 GOPs on 2 shards; the 1080p H.265 GOP of
    phase 9 on 2 shards; phase 5's 12 MPEG-2 pictures on 2 shards; the
    DPB page exchange at 1920x1088 on 4 shards; and the GOP step once
    through a world-size-1 NCCL process group. The shards run in this
    process on the one card (``InProcessMesh``): NCCL refuses two ranks
    on one GPU. Each step's output must equal the earlier phases'
    single-device checksums, and each prints its ms/picture beside the
    single-device path's, in turns, and its launches (counts set to 0
    just before the checked run). Returns {kernel: {step: launches}}."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from m2dec_tpu_torch.codecs.h264 import plan_host as host
    from m2dec_tpu_torch.codecs.h264 import reconstruct as R
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.decoder import Frame
    from m2dec_tpu_torch.codecs.h264.plan import PicturePlan
    from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK
    from m2dec_tpu_torch.codecs.h265.reconstruct import H265SeqPhaseB
    from m2dec_tpu_torch.codecs.mpeg2.reconstruct import Mpeg2SeqPhaseB
    from m2dec_tpu_torch.kernels import idct_kernels as IK
    from m2dec_tpu_torch.parallel import mesh as M
    from m2dec_tpu_torch.runtime.golden import frame_checksums, host_checksum

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    plans, n_frames, geom, pic_cks, plans2, stream_cks = h264
    mb_w, mb_h, pool = geom
    kernels = (*ROW_KERNELS, "idct8x8", "h265_tile")
    launches = {k: {} for k in kernels}

    def mesh(n):
        return M.make_mesh(n, in_process=True, device=dev)

    def counted(name, fn, want):
        """fn() with every count at 0 just before it; its launches must be
        ``want`` ({kernel: n}, 0 for the others)."""
        WK.reset_launch_counts()
        IK.reset_launch_counts()
        TK.reset_launch_counts()
        out = fn()
        sync()
        got = {**WK.LAUNCHES, **IK.LAUNCHES, **TK.LAUNCHES}
        bad = {k: got[k] for k in kernels if got[k] != want.get(k, 0)}
        if bad:
            raise RuntimeError(f"{name}: launches {bad}, want {want}")
        for k in kernels:
            launches[k][name] = got[k]
        return out

    def turns(fns, reps=2):
        """Median seconds of each of the two fns, run in turns a b b a."""
        secs = ([], [])
        for k in range(2 * reps):
            j = (k + k // 2) % 2
            sync()
            t = time.perf_counter()
            fns[j]()
            sync()
            secs[j].append(time.perf_counter() - t)
        return [statistics.median(v) for v in secs]

    def same_cks(name, outs, want):
        got = frame_checksums(*outs).cpu()
        if not torch.equal(got, want):
            bad = [i for i in range(len(want))
                   if not torch.equal(got[i], want[i])]
            raise RuntimeError(f"{name}: pictures {bad} differ from the "
                               f"single-device checksums")

    def report(name, n, secs, single, extra):
        step_ms, one_ms = (1e3 * s / n for s in secs)
        used = {k: v[name] for k, v in launches.items() if v.get(name)}
        phase(11, f"{name} on {smi}: {step_ms:.3f} ms/picture, "
                  f"{single} {one_ms:.3f} ms/picture (median of 2 each, "
                  f"in turns, host clock to a synchronize); {extra}; "
                  f"launches {json.dumps(used)}")

    # -- the H.264 band step: 12 pictures as 4 MB-row bands --------------
    nb = 4
    steps = {i8: M.h264_tile_step(mesh(nb), mb_w, mb_h, has_i8=i8)
             for i8 in (False, True)}

    dplans = [dense_plan(p) for p in plans]

    def band_run(check=False):
        """The 12 pictures in decode order through the band step, each
        with the reference pictures compacted to its used slots (as
        reconstruct_plan_torch passes them); host frames as the pool."""
        frames = [Frame(mb_w * 16, mb_h * 16) for _ in range(n_frames)]
        for b, plan in enumerate(dplans):
            slots = plan.used_slots() or [0]
            remap = np.zeros(n_frames + 1, np.int32)
            remap[slots] = np.arange(len(slots))
            tiled = M.h264_tile_plan(plan, nb)
            tiled["slot"] = np.where(tiled["slot"] >= 0, remap[np.clip(
                tiled["slot"], 0, n_frames)], -1).astype(np.int32)
            refs = [np.stack([getattr(frames[s], k) for s in slots])
                    for k in ("y", "cb", "cr")]
            has_i8 = R._plan_flags(plan.kind, plan.t8x8, plan.deb_str,
                                   plan.deb_str4)[0]
            out = steps[has_i8](tiled, *refs)
            if check:
                same_cks(f"band step picture {b}", [o[None] for o in out],
                         pic_cks[b:b + 1])
            f = frames[plan.cur_idx]
            for pl, o in zip(("y", "cb", "cr"), out):
                getattr(f, pl)[:] = o.cpu().numpy()

    def single_run(check=False):
        """The same pictures through reconstruct_plan_torch."""
        frames = [Frame(mb_w * 16, mb_h * 16) for _ in range(n_frames)]
        for b, plan in enumerate(dplans):
            R.reconstruct_plan_torch(plan, frames, device=dev)
            f = frames[plan.cur_idx]
            if check and not np.array_equal(host_checksum(f.y, f.cb, f.cr),
                                            pic_cks[b].numpy()):
                raise RuntimeError(f"reconstruct_plan_torch picture {b} "
                                   f"differs from phase 3's checksum")

    single_run(check=True)

    counted("h264_tile_step", lambda: band_run(check=True),
            {k: nb * len(plans) for k in ROW_KERNELS})
    report("h264_tile_step", len(plans), turns((band_run, single_run)),
           "reconstruct_plan_torch",
           f"{len(plans)} pictures of {W}x{H} as {nb} bands of "
           f"{mb_h // nb} MB rows, each equal to phase 3's checksum")

    # the band step's time by stage: one run, a synchronize around each
    secs = {}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    patches = [(R, "_residuals", "residual"), (R, "inter_pass", "MC"),
               *((WK, k, k) for k in ROW_KERNELS),
               (M.InProcessMesh, "shift", "halo hops"),
               (M, "h264_tile_plan", "host plan split")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, key in patches:
        setattr(obj, name, timed(key, getattr(obj, name)))
    plain_steps, steps = steps, {k: timed("step", v)
                                 for k, v in steps.items()}
    try:
        sync()
        t0 = time.perf_counter()
        band_run()
        sync()
        total = time.perf_counter() - t0
    finally:
        steps = plain_steps
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    inner = sum(v for k, v in secs.items() if k not in ("step",
                                                         "host plan split"))
    secs["rest of the step"] = secs.pop("step") - inner
    secs["outside the step"] = (total - secs["rest of the step"] - inner
                                - secs["host plan split"])
    phase(11, f"h264_tile_step split on {smi}, ms per picture, a "
              f"synchronize around each stage (the four bands' sum; the "
              f"rest of the step: plan upload, assembly, halo rows; outside: "
              f"the references' compaction and the host pool): "
              + json.dumps({k: round(1e3 * v / len(plans), 3)
                            for k, v in secs.items()}))

    # -- the H.264 GOP step: phase 8's two streams as 4 GOPs, 2 shards ---
    gops = [plans, plans2, plans, plans2]
    G, N = len(gops), len(plans)
    dense = {id(p): d for p, d in zip(plans, dplans)}
    dense.update((id(p), dense_plan(p)) for p in plans2)
    stacked = {k: np.stack([np.stack([getattr(dense[id(p)], k) for p in g])
                            for g in gops]) for k in host._PLAN_KEYS}
    cur = np.zeros((G, N), np.int32)
    for g, gp in enumerate(gops):
        host._remap_batch(stacked["slot"][g], cur[g], gp,
                          host._DevSlotMap(pool))
    aux = host._derive_mc_aux([stacked["slot"][g] for g in range(G)], pool,
                              mb_w, mb_h)
    stacked["mc_used"] = np.stack([a[0] for a in aux])
    stacked["mc_bi"] = np.stack([a[1] for a in aux])
    pools = tuple(np.zeros((G, pool, h, w), np.uint8)
                  for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))

    def same_gops(name, outs):
        for g in range(G):
            got = R.MultiStreamPhaseB.checksums([tuple(o[g] for o in outs)])
            if not np.array_equal(got[0], stream_cks[g % 2]):
                raise RuntimeError(f"{name}: GOP {g} differs from phase 8's "
                                   f"checksum")

    gop_step = M.h264_gop_step(mesh(2), mb_w, mb_h)
    _, outs = counted("h264_gop_step",
                      lambda: gop_step(*pools, stacked, cur),
                      {k: 2 * N for k in ROW_KERNELS})
    same_gops("h264_gop_step", outs)
    multi = R.MultiStreamPhaseB(G, *geom, device=dev)

    def multi_run():
        multi.reset()
        multi.run(gops)

    report("h264_gop_step", G * N, turns((
        lambda: gop_step(*pools, stacked, cur), multi_run)),
        "MultiStreamPhaseB at S = 4",
        f"{G} GOPs of {N} pictures (seeds {SEED}, {SEED2}, {SEED}, "
        f"{SEED2}) on 2 shards, dense plan tensors with the dense-MC aux, "
        f"each GOP equal to phase 8's checksum")

    # -- the H.265 GOP step: phase 9's GOP on each of 2 shards -----------
    plans265, (H5, W5, pool5), cks265 = h265_verified
    cl2 = plans265[0].size_log2
    pools265 = tuple(np.zeros((2, pool5, h, w), np.uint8)
                     for h, w in ((H5, W5), (H5 // 2, W5 // 2),
                                  (H5 // 2, W5 // 2)))
    step265 = M.h265_gop_step(mesh(2), H5, W5, cl2)
    _, outs = counted("h265_gop_step",
                      lambda: step265(*pools265, [plans265, plans265]),
                      {"h265_tile": 2 * len(plans265)})
    for g in range(2):
        same_cks(f"h265_gop_step GOP {g}", [o[g] for o in outs], cks265)
    ph265 = H265SeqPhaseB(H5, W5, pool5, device=dev)
    report("h265_gop_step", 2 * len(plans265), turns((
        lambda: step265(*pools265, [plans265, plans265]),
        lambda: [ph265.run_async(plans265) for _ in range(2)])),
        "H265SeqPhaseB on the 2 GOPs in turn",
        f"phase 9's {W5}x{H5} GOP of {len(plans265)} pictures on each of 2 "
        f"shards, each equal to phase 9's checksums")

    # -- the MPEG-2 sharded step: phase 5's 12 pictures on 2 shards ------
    items, mgeom, m_kern, m_cks = m2
    mplans = [it[0] for it in items]
    if any(p.fieldmc is not None and p.fieldmc.any() for p in mplans):
        raise RuntimeError("the MPEG-2 stream has field MC, which the "
                           "sharded step does not take")
    # each picture's references: the verified output that last wrote the
    # slot before it (zeros for a slot no picture wrote)
    last, ref_idx = {}, []
    for b, (_, c, r0, r1) in enumerate(items):
        ref_idx.append((last.get(r0, len(items)), last.get(r1, len(items))))
        last[c] = b
    ext = [torch.cat([o, torch.zeros_like(o[:1])]) for o in m_kern]
    refs = [e[torch.tensor([ri[d] for ri in ref_idx], device=dev)]
            for d in (0, 1) for e in ext]
    margs = (*(np.stack([getattr(p, k) for p in mplans]) for k in (
        "intra", "fwd", "bwd", "mvf", "mvb", "dct_type", "coef")), *refs)
    m_step = M.sharded_decode_step(mesh(2), mgeom[0], mgeom[1])
    outs = counted("sharded_decode_step", lambda: m_step(*margs),
                   {"idct8x8": 2})
    same_cks("sharded_decode_step", outs, m_cks)
    m_seq = Mpeg2SeqPhaseB(*mgeom, device=dev)
    report("sharded_decode_step", len(items), turns((
        lambda: m_step(*margs), lambda: m_seq.run_async(items))),
        "Mpeg2SeqPhaseB", f"phase 5's {len(items)} MPEG-2 pictures on 2 "
        f"shards, each with its references from phase 5's verified "
        f"frames, equal to phase 5's checksums")

    # -- the DPB page exchange at 1920x1088 on 4 shards ------------------
    nx, psz = 4, 2
    rng = np.random.default_rng(SEED)
    xpools = tuple(rng.integers(0, 256, (nx, psz, h, w), dtype=np.uint8)
                   for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
    xplans = []
    for g in range(nx):
        for i in range(2):  # random MVs, then zero MVs, both from the page
            p = PicturePlan(mb_w, mb_h)
            p.kind[:] = 0
            p.slot[:, :, 0] = psz
            p.wp[:, :, :, 0] = 1
            if i == 0:
                p.mv[:] = rng.integers(-64, 64, p.mv.shape)
            xplans.append(p)
    xst = {k: np.stack([getattr(p, k) for p in xplans]).reshape(
        (nx, 2) + getattr(xplans[0], k).shape) for k in host._PLAN_KEYS}
    xcur = np.ones((nx, 2), np.int32)
    xstep = M.h264_gop_xchg_step(mesh(nx), mb_w, mb_h, psz, handoff_slot=0,
                                 has_i8=False, deblock=False)
    _, outs = counted("h264_gop_xchg_step",
                      lambda: xstep(*xpools, xst, xcur),
                      {"intra_luma": 2 * nx, "intra_chroma": 2 * nx})
    pages = [tuple(torch.as_tensor(p[g - 1, 0:1]).to(dev)[None] if g
                   else torch.zeros((1, 1) + p.shape[2:], dtype=torch.uint8,
                                    device=dev) for p in xpools)
             for g in range(nx)]

    def alone(gs):
        """Module 2 (``_recon_batch``) run alone on GOPs gs, with the
        pages the exchange step must have sent them."""
        return R._recon_batch(
            *(torch.as_tensor(p[gs]).to(dev) for p in xpools),
            {k: torch.as_tensor(v[gs]).to(dev, torch.int32)
             for k, v in xst.items()}, xcur[gs], mb_w=mb_w, mb_h=mb_h,
            has_i8=False, deblock=False,
            extra=[torch.cat([pages[g][j] for g in gs]) for j in range(3)])

    for g in range(nx):
        for o, page in zip(outs, pages[g]):
            if not torch.equal(o[g, 1], page[0, 0]):
                raise RuntimeError(f"exchange step: shard {g}'s zero-MV "
                                   f"picture != the previous shard's page")
        if g:
            want = alone([g])[1]
            if not all(torch.equal(o[g], w[0]) for o, w in zip(outs, want)):
                raise RuntimeError(f"exchange step: shard {g} != module 2 "
                                   f"alone with the same page")
    report("h264_gop_xchg_step", 2 * nx, turns((
        lambda: xstep(*xpools, xst, xcur), lambda: alone(list(range(nx))))),
        "_recon_batch of the 4 GOPs with their pages",
        f"{nx} shards of one {W}x{H} GOP of 2 pictures (random MVs, then "
        f"zero MVs) from the previous shard's page: shards 1-3 equal to "
        f"module 2 alone with the same page, every zero-MV picture equal "
        f"to the page it was sent (zeros on shard 0)")

    # -- the GOP step through a world-size-1 NCCL process group ----------
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(torch.cuda.current_device())
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        init_s = time.perf_counter() - t0
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"process group backend {dist.get_backend()}")
        nccl = M.make_mesh()
        nstep = M.h264_gop_step(nccl, mb_w, mb_h)
        t0 = time.perf_counter()
        outs = counted("h264_gop_step NCCL world 1", lambda: M.gather(
            nccl, nstep(*pools, stacked, cur)[1]), {k: N for k in ROW_KERNELS})
        nccl_s = time.perf_counter() - t0
        same_gops("h264_gop_step over NCCL", outs)
    finally:
        dist.destroy_process_group()
    phase(11, f"h264_gop_step through a world-size-1 NCCL process group on "
              f"{smi} (mesh device {nccl.device}, init {init_s:.2f} s): "
              f"{G} GOPs on one rank in {1e3 * nccl_s / (G * N):.3f} "
              f"ms/picture (one run, the gather included), every GOP equal "
              f"to phase 8's checksum; launches "
              + json.dumps({k: v["h264_gop_step NCCL world 1"]
                            for k, v in launches.items()
                            if v.get("h264_gop_step NCCL world 1")}))
    phase(11, "collectives between GPUs, and scaling with the number of "
              "GPUs, are not measured: this machine has one GPU, so the "
              "shards above share it")
    phase(11, f"multi-device phase took {time.perf_counter() - t_phase:.1f} "
              f"s; the script has run {time.perf_counter() - t_start:.1f} s")
    return launches


def python_plans_phase(dev, smi, procs, geom, plans42, plans43, want):
    """Phase 12: plans without a coded map (the Python decoder's) on the
    card, through the one wire packer, which derives their maps.

    * At full width: the 1080p plans of phases 3 (seed 42) and 8 (seed
      43) without their coded maps (``dense_plan``), through
      BatchedPhaseB (S = 1) and MultiStreamPhaseB (S = 4), each stream's
      checksum equal to phases 3 and 8; the host ms per batch of the
      packer on these plans and on the native ones, in turns.
    * The Python decoder's plans of four 48x32 streams, each alone and
      in pairs, against recon_ref.

    Every run launches each row kernel once per picture step (the
    deblock kernels not at all for a batch without deblocking). Returns
    {run: {kernel: launches}} of the 1080p runs."""
    import numpy as np
    import torch

    from m2dec_tpu_torch.codecs.h264 import reconstruct as R
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.decoder import Frame, H264Decoder
    from m2dec_tpu_torch.codecs.h264.native_pack import pack_batches
    from m2dec_tpu_torch.codecs.h264.recon_ref import reconstruct_plan_np

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    launches = {}

    def counted(name, run, steps, deblock=True):
        """run() with every launch count at 0 before it; checks one launch
        of each row kernel per picture step."""
        WK.reset_launch_counts()
        outs = run()
        sync()
        got = {k: WK.LAUNCHES[k] for k in ROW_KERNELS}
        wanted = {k: steps if deblock or k.startswith("intra") else 0
                  for k in ROW_KERNELS}
        if got != wanted:
            raise RuntimeError(f"{name}: row kernel launches {got}, want "
                               f"{wanted}")
        launches[name] = got
        return outs

    native = {1: [plans42], 4: [plans42, plans43] * 2}
    bare = {id(p): dense_plan(p) for p in (*plans42, *plans43)}
    python = {S: [[bare[id(p)] for p in pl] for pl in v]
              for S, v in native.items()}

    # -- 1080p plans without coded maps ----------------------------------
    for S, run in ((1, lambda: [R.BatchedPhaseB(*geom, device=dev)
                                .run_async(python[1][0])]),
                   (4, lambda: R.MultiStreamPhaseB(4, *geom, device=dev)
                   .run(python[4]))):
        cks = R.MultiStreamPhaseB.checksums(counted(f"S={S}", run, BATCH))
        bad = [s for s in range(S) if not np.array_equal(cks[s], want[s % 2])]
        if bad:
            raise RuntimeError(f"plans without coded maps, S = {S}: streams "
                               f"{bad} differ from phases 3 and 8")
    # the packer on both kinds of plan, in turns
    pack_ms = {}
    for S in (1, 4):
        ts = {"native": [], "no map": []}
        for kind in ("native", "no map", "no map", "native", "native",
                     "no map"):
            t0 = time.perf_counter()
            pack_batches((native if kind == "native" else python)[S])
            ts[kind].append(time.perf_counter() - t0)
        for kind, v in ts.items():
            pack_ms[f"{kind} S={S}"] = round(1e3 * statistics.median(v), 3)
    phase(12, f"{W}x{H} plans without coded maps (phases 3 and 8's, seeds "
              f"{SEED} and {SEED2}): BatchedPhaseB S = 1 and "
              f"MultiStreamPhaseB S = 4 equal to phases 3 and 8 by "
              f"checksum; row kernel launches per run "
              + json.dumps(launches) + f" for {BATCH} picture steps; "
              f"host pack ms per batch of {BATCH} pictures per stream on "
              f"{smi} (native plans, and the same without their maps, "
              f"which the packer derives; in turns, median of 3): "
              + json.dumps(pack_ms))

    # -- the Python decoder's plans of the 48x32 streams vs recon_ref ------
    checked = []
    for pair in PYPLAN_PAIRS:
        runs = []
        for name in pair:
            dec = H264Decoder(dpb_max=1, record_plans=True)
            dec.set_data(stream(name, procs))
            shadow, exp = None, []
            while dec.decode_picture() == 1:
                if shadow is None:
                    h, w = dec.frames[0].y.shape
                    shadow = [Frame(w, h) for _ in dec.frames]
                plan = dec.plans[-1]
                reconstruct_plan_np(plan, shadow)
                f = shadow[plan.cur_idx]
                exp.append((f.y.copy(), f.cb.copy(), f.cr.copy()))
            runs.append((dec, exp))
        d0 = runs[0][0]
        steps = len(runs[0][1])
        for idx in ([0], [1], [0, 1]):
            deblock = any(R._plan_flags(p.kind, p.t8x8, p.deb_str,
                                        p.deb_str4)[1]
                          for i in idx for p in runs[i][0].plans)
            ms = R.MultiStreamPhaseB(
                len(idx), d0.max_x, d0.max_y,
                max(len(d.frames) for d, _ in runs), device=dev)
            name = "+".join(list(pair)[i] for i in idx)
            outs = counted(name, lambda: ms.run(
                [runs[i][0].plans for i in idx]), steps, deblock)
            del launches[name]
            for s, i in enumerate(idx):
                for k, e in enumerate(runs[i][1]):
                    for pl, o, x in zip(("y", "cb", "cr"), outs[s], e):
                        if not np.array_equal(o[k].cpu().numpy(), x):
                            raise RuntimeError(
                                f"{name}: stream {i} picture {k} {pl} "
                                f"!= recon_ref")
            checked.append(name)
    phase(12, f"Python decoder plans of {sum(map(len, PYPLAN_PAIRS))} 48x32 "
              f"streams on the card: {len(checked)} runs (each stream alone "
              f"and in pairs) equal to recon_ref byte for byte, each row "
              f"kernel launched once per picture step")
    phase(12, f"plans without coded maps phase took "
              f"{time.perf_counter() - t_phase:.1f} s on {smi}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not ((REPO / "m2dec_tpu_torch").is_dir()
            and (REPO / "tests" / "streamgen").is_dir()):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    from m2dec_tpu_torch.device import cuda_device

    t_start = time.perf_counter()
    dev = cuda_device()
    procs = start_streams()
    try:
        return run(dev, procs, t_start)
    finally:
        for p in procs.values():
            p.kill()
            p.wait()


def run(dev, procs, t_start):
    """The phases, on device ``dev``; ``procs`` are the stream makers."""
    import torch

    from m2dec_tpu_torch import _build
    from m2dec_tpu_torch.codecs.h264 import wavefront as WF
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder
    from m2dec_tpu_torch.codecs.h264.plan_host import dev_pool_size
    from m2dec_tpu_torch.codecs.h264.recon_ref import reconstruct_plan_np
    from m2dec_tpu_torch.codecs.h264.reconstruct import BatchedPhaseB
    from m2dec_tpu_torch.codecs.mpeg2.decoder import Mpeg2Decoder
    from m2dec_tpu_torch.codecs.mpeg2.reconstruct import Mpeg2SeqPhaseB
    from m2dec_tpu_torch.kernels import idct_kernels as IK
    from m2dec_tpu_torch.runtime.golden import frame_checksums
    from m2dec_tpu_torch.runtime.turbo import (
        TurboH264Decoder,
        TurboMpeg2Decoder,
    )

    sync = torch.cuda.synchronize

    # -- phase 1: environment, kernel build, streams ----------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    start_handoff_build(_build.nvcc_path(), _build.NVCC_FLAGS, procs)
    _build.build_all()
    build_s = time.perf_counter() - t0
    data = stream(H264_STREAM, procs)
    phase(1, f"environment: {smi}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}; {nvcc}; kernel build {build_s:.2f} s "
             f"({len(_build.LIBRARIES)} libraries at once); H.264 stream "
             f"{len(data)} B ready after "
             f"{time.perf_counter() - t_start:.1f} s")

    # -- phase 2: the H.264 main path on the 1080p stream ----------------
    WK.reset_launch_counts()
    IK.reset_launch_counts()
    t0 = time.perf_counter()
    turbo = []
    for frm, outs, i in TurboH264Decoder(data, batch=BATCH,
                                         device=dev).device_frames():
        if outs is None:
            raise RuntimeError("a frame was output without a plan")
        turbo.append(frame_checksums(outs[0][i:i + 1], outs[1][i:i + 1],
                                     outs[2][i:i + 1]))
    sync()
    main_s = time.perf_counter() - t0
    launches = dict(WK.LAUNCHES)
    if len(turbo) != BATCH:
        raise RuntimeError(f"H.264 main path output {len(turbo)} frames, "
                           f"want {BATCH}")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the H.264 main path: "
                           f"{idle}")
    # the row-schedule kernels launch once per pass, one pass per picture
    not_once = {k: launches[k] for k in ROW_KERNELS
                if launches[k] != len(turbo)}
    if not_once:
        raise RuntimeError(f"row-schedule kernels launched {not_once} "
                           f"times for {len(turbo)} pictures, want once "
                           f"per picture")
    per_pic = sum(launches[k] for k in ROW_KERNELS) / len(turbo)
    phase(2, f"H.264 main path: TurboH264Decoder {W}x{H} {PATTERN} batch "
             f"{BATCH}: {len(turbo)} frames in {main_s:.2f} s; launches "
             f"{json.dumps(launches)}; {per_pic:g} wavefront launches per "
             f"picture")

    # -- phase 3: H.264 kernels vs plain at full size --------------------
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    t0 = time.perf_counter()
    while dec.decode_picture() == 1:
        pass
    phase_a_s = time.perf_counter() - t0
    plans = dec.plans
    geom = (dec.max_x, dec.max_y,
            dev_pool_size(dec.sps.num_ref_frames, len(dec.frames)))
    mb_w, mb_h = geom[0], geom[1]
    captured = {}

    def capturing(y, cb, cr, P, has_i8, deblock, mbw, mbh):
        # the passes get [1, H, W] stacks: BatchedPhaseB's one stream
        k = len(captured.setdefault("order", []))
        captured["order"].append(k)
        if k in (0, 2):
            captured[k] = (y[0].clone(), cb[0].clone(), cr[0].clone(),
                           {n: v.clone() for n, v in P.items()}, has_i8)
        return WK.run_wavefronts(y, cb, cr, P, has_i8, deblock, mbw, mbh)

    def plain_wavefronts(y, cb, cr, P, *args):
        return WK.per_stream(WF.run_wavefronts_plain, (y, cb, cr), P, *args)

    kern = BatchedPhaseB(*geom, device=dev,
                         wavefronts=capturing).run_async(plans)
    t0 = time.perf_counter()
    plain = BatchedPhaseB(*geom, device=dev,
                          wavefronts=plain_wavefronts).run_async(plans)
    sync()
    plain_s = time.perf_counter() - t0
    ck_k = frame_checksums(*kern).cpu()
    ck_p = frame_checksums(*plain).cpu()
    if not torch.equal(ck_k, ck_p):
        bad = [i for i in range(len(plans)) if not torch.equal(ck_k[i],
                                                               ck_p[i])]
        raise RuntimeError(f"H.264 kernel path != plain path on pictures "
                           f"{bad}")
    turbo_set = sorted(tuple(c.flatten().tolist()) for c in turbo)
    if turbo_set != sorted(tuple(c.flatten().tolist()) for c in ck_k):
        raise RuntimeError("H.264 main-path frames differ from the batched "
                           "run")

    # kernel wrappers vs plain versions on the main path's own inputs
    errs = {k: 0 for k in REPLACES}
    intra_out = {}
    for k in (0, 2):
        y, cb, cr, P, has_i8 = captured[k]
        want_y = WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
        got_y = WK.intra_luma(y.clone(), P, has_i8, mb_w, mb_h)
        errs["intra_luma"] = max(errs["intra_luma"],
                                 max_abs_err(got_y, want_y))
        want_c = WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)
        intra_out[k] = (want_y, want_c)
        got_c = WK.intra_chroma(cb.clone(), cr.clone(), P, mb_w, mb_h)
        errs["intra_chroma"] = max(errs["intra_chroma"],
                                   max_abs_err(got_c[0], want_c[0]),
                                   max_abs_err(got_c[1], want_c[1]))
        want_dy = WF.deblock_luma_plain(want_y, P, mb_w, mb_h)
        got_dy = WK.deblock_luma(want_y.clone(), P, mb_w, mb_h)
        errs["deblock_luma"] = max(errs["deblock_luma"],
                                   max_abs_err(got_dy, want_dy))
        want_dc = WF.deblock_chroma_plain(want_c[0], want_c[1], P, mb_w,
                                          mb_h)
        got_dc = WK.deblock_chroma(want_c[0].clone(), want_c[1].clone(), P,
                                   mb_w, mb_h)
        errs["deblock_chroma"] = max(
            errs["deblock_chroma"], max_abs_err(got_dc[0], want_dc[0]),
            max_abs_err(got_dc[1], want_dc[1]))
    sync()
    if any(errs.values()):
        raise RuntimeError(f"kernel vs plain max abs err {errs} (want 0)")

    # the numpy reference Phase B (recon_ref) on the first pictures
    ref = H264Decoder(native=True)
    ref.set_data(data)
    n_ref = 0
    for i in range(2):
        if i and time.perf_counter() - t_start > REF_PIC1_BUDGET_S:
            break
        if ref.decode_picture() != 1:
            raise RuntimeError("reference decode stopped early")
        reconstruct_plan_np(ref.plans[i], ref.frames)
        f = ref.frames[ref.plans[i].cur_idx]
        for pl, a in zip(("y", "cb", "cr"), kern):
            if not (a[i].cpu().numpy() == getattr(f, pl)).all():
                raise RuntimeError(f"H.264 picture {i} {pl} != recon_ref")
        n_ref += 1
    phase(3, f"H.264 kernels vs plain at full size: {len(plans)} pictures "
             f"equal by device checksum, per-kernel max abs err "
             f"{json.dumps({k: errs[k] for k in WK.LAUNCHES})} (tolerance "
             f"0) on pictures 0 and 2, pictures 0..{n_ref - 1} equal to "
             f"recon_ref byte for byte")

    # -- phase 4: H.264 coverage the 1080p stream lacks -------------------
    cover = (("High 8x8 + deblock 176x144", stream(HIGH_STREAM, procs)),
             ("IPCM 48x32", stream(IPCM_STREAM, procs)))
    deblocks = WK.LAUNCHES["deblock_luma"]
    for name, s in cover:
        serial = H264Decoder()
        serial.set_data(s)
        exp = serial.decode_all()
        got = TurboH264Decoder(s, batch=4, device=dev).decode_all()
        if len(got) != len(exp):
            raise RuntimeError(f"{name}: {len(got)} frames, want {len(exp)}")
        for k, (g, e) in enumerate(zip(got, exp)):
            for pl in ("y", "cb", "cr"):
                if not (getattr(g, pl) == getattr(e, pl)).all():
                    raise RuntimeError(f"{name}: frame {k} {pl} differs")
    if WK.LAUNCHES["deblock_luma"] <= deblocks:
        raise RuntimeError("coverage streams did not deblock")
    phase(4, "H.264 coverage: " + "; ".join(
        f"{name} equal to the serial decoder" for name, _ in cover))

    # -- phase 5: the MPEG-2 main path on the 1080p stream ---------------
    t0 = time.perf_counter()
    m2data = stream(M2V_STREAM, procs)
    m2_wait_s = time.perf_counter() - t0
    WK.reset_launch_counts()
    IK.reset_launch_counts()
    t0 = time.perf_counter()
    m2_turbo = []
    for frm, outs, i in TurboMpeg2Decoder(m2data, batch=BATCH,
                                          device=dev).device_frames():
        if outs is None:
            raise RuntimeError("an MPEG-2 frame was output without a plan")
        m2_turbo.append(frame_checksums(
            outs[0][i:i + 1], outs[1][i:i + 1], outs[2][i:i + 1]))
    sync()
    m2_main_s = time.perf_counter() - t0
    launches["idct8x8"] = IK.LAUNCHES["idct8x8"]
    if len(m2_turbo) != BATCH:
        raise RuntimeError(f"MPEG-2 main path output {len(m2_turbo)} "
                           f"frames, want {BATCH}")
    if launches["idct8x8"] <= 0:
        raise RuntimeError("the IDCT kernel was not launched on the MPEG-2 "
                           "main path")
    phase(5, f"MPEG-2 main path: TurboMpeg2Decoder {W}x{H} {PATTERN} "
             f"batch {BATCH}: {len(m2_turbo)} frames in {m2_main_s:.2f} s "
             f"(stream {len(m2data)} B, waited {m2_wait_s:.1f} s for it); "
             f"IDCT launches {launches['idct8x8']}")

    # -- phase 6: MPEG-2 kernel vs plain, and vs the port's CPU path -----
    mdec = Mpeg2Decoder(device=dev, defer_recon=True)
    mdec.set_data(m2data)
    t0 = time.perf_counter()
    while mdec.decode_data() == 1:
        pass
    m2_phase_a_s = time.perf_counter() - t0
    items = mdec.plans
    mgeom = (mdec.seq.mb_w, mdec.seq.mb_h, len(mdec.pool.frames))
    m_kern = Mpeg2SeqPhaseB(*mgeom, device=dev).run_async(items)
    m_plain = Mpeg2SeqPhaseB(*mgeom, device=dev,
                             idct=IK.idct8x8_blocks_plain).run_async(items)
    mk = frame_checksums(*m_kern).cpu()
    mp = frame_checksums(*m_plain).cpu()
    if not torch.equal(mk, mp):
        bad = [i for i in range(len(items)) if not torch.equal(mk[i], mp[i])]
        raise RuntimeError(f"MPEG-2 kernel path != plain path on pictures "
                           f"{bad}")
    if (sorted(tuple(c.flatten().tolist()) for c in m2_turbo)
            != sorted(tuple(c.flatten().tolist()) for c in mk)):
        raise RuntimeError("MPEG-2 main-path frames differ from the "
                           "batched run")
    cpu = Mpeg2SeqPhaseB(*mgeom, device="cpu").run_async(items[:2])
    for i in range(2):
        for pl, a, c in zip(("y", "cb", "cr"), m_kern, cpu):
            if not torch.equal(a[i].cpu(), c[i]):
                raise RuntimeError(f"MPEG-2 picture {i} {pl} != the port's "
                                   f"CPU path")
    # the kernel against its plain version: every block of picture 0,
    # the whole batch, and the int16-store wraparound case
    coef = torch.stack([torch.from_numpy(it[0].coef) for it in items]).to(
        dev)
    wrap = torch.zeros((4, 64), dtype=torch.int16)
    wrap[:, 0:8] = 2047
    wrap[:, 56:64] = -2048
    wrap = wrap.to(dev)
    for c in (coef[0], coef, wrap):
        errs["idct8x8"] = max(errs["idct8x8"], max_abs_err(
            IK.idct8x8_blocks(c), IK.idct8x8_blocks_plain(c)))
    sync()
    if errs["idct8x8"]:
        raise RuntimeError(f"IDCT kernel vs plain max abs err "
                           f"{errs['idct8x8']} (want 0)")
    # coverage the 1080p stream lacks: field MC and field DCT in frame
    # pictures, and field pictures
    m2_cover = (("field MC 80x48", stream(FIELDMC_STREAM, procs)),
                ("field pictures 80x48", stream(FIELDPIC_STREAM, procs)))
    for name, s in m2_cover:
        serial = Mpeg2Decoder(device="cpu")
        serial.set_data(s)
        exp = serial.decode_all()
        got = TurboMpeg2Decoder(s, batch=4, device=dev).decode_all()
        if len(got) != len(exp):
            raise RuntimeError(f"{name}: {len(got)} frames, want {len(exp)}")
        for k, (g, e) in enumerate(zip(got, exp)):
            for pl in ("y", "cb", "cr"):
                if not (getattr(g, pl) == getattr(e, pl)).all():
                    raise RuntimeError(f"{name}: frame {k} {pl} differs")
    phase(6, f"MPEG-2 kernel path vs plain path: {len(items)}/{BATCH} "
             f"pictures equal by device checksum; pictures 0..1 equal to "
             f"the port's CPU path byte for byte; IDCT kernel vs plain max "
             f"abs err {errs['idct8x8']} (tolerance 0) over picture 0's "
             f"{coef[0].numel() // 64} blocks, the batch's "
             f"{coef.numel() // 64} and the int16-wrap case; "
             + "; ".join(f"{name} on the card equal to the port's serial "
                         f"decoder on the CPU" for name, _ in m2_cover))

    # -- phase 7: timing ---------------------------------------------------
    def timed(fn):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t

    def run_h264(wavefronts):
        BatchedPhaseB(*geom, device=dev,
                      wavefronts=wavefronts).run_async(plans)

    def run_m2(idct):
        """(host enqueue s, total s) of one MPEG-2 batch."""
        sync()
        t = time.perf_counter()
        Mpeg2SeqPhaseB(*mgeom, device=dev, idct=idct).run_async(items)
        t_enq = time.perf_counter()
        sync()
        return t_enq - t, time.perf_counter() - t

    def turbo_run(cls, stream):
        n = sum(1 for _ in cls(stream, batch=BATCH,
                               device=dev).device_frames())
        if n != BATCH:
            raise RuntimeError(f"{cls.__name__} output {n} frames")

    kern_ms = 1e3 * statistics.median(
        timed(lambda: run_h264(WK.run_wavefronts)) for _ in range(3)
    ) / len(plans)
    plain_ms = 1e3 * plain_s / len(plans)
    e2e_ms = 1e3 * statistics.median(
        timed(lambda: turbo_run(TurboH264Decoder, data)) for _ in range(3)
    ) / BATCH
    # the two MPEG-2 paths differ by one IDCT per batch: time them in
    # turns (kernel, plain, plain, kernel, ...) so that host drift
    # spreads over both
    m2_runs = {IK.idct8x8_blocks: [], IK.idct8x8_blocks_plain: []}
    for k in range(10):
        idct = list(m2_runs)[(k + k // 2) % 2]
        m2_runs[idct].append(run_m2(idct))
    m2_kern_ms, m2_plain_ms = (
        1e3 * statistics.median(t for _, t in v) / len(items)
        for v in m2_runs.values())
    enqueue_share = [e / t for v in m2_runs.values() for e, t in v]
    # one kernel-path batch under the profiler: device time by kernel
    # and the device's busy share of the wall time
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prof_s = run_m2(IK.idct8x8_blocks)[1]
    dev_ms = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            key = ev.key[:60]
            dev_ms[key] = dev_ms.get(key, 0.0) + ev.device_time_total / 1e3
    busy_ms = sum(dev_ms.values())
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:4]
    m2_e2e_ms = 1e3 * statistics.median(
        timed(lambda: turbo_run(TurboMpeg2Decoder, m2data))
        for _ in range(3)) / BATCH

    def pass_inputs(k):
        """Each pass's kernel, plain version and inputs on captured
        picture k (the deblock passes on its intra output)."""
        y, cb, cr, P, has_i8 = captured[k]
        iy, (icb, icr) = intra_out[k]
        return {
            "intra_luma": ((WK.intra_luma, WF.intra_luma_plain),
                           lambda: (y.clone(), P, has_i8, mb_w, mb_h)),
            "intra_chroma": ((WK.intra_chroma, WF.intra_chroma_plain),
                             lambda: (cb.clone(), cr.clone(), P, mb_w,
                                      mb_h)),
            "deblock_luma": ((WK.deblock_luma, WF.deblock_luma_plain),
                             lambda: (iy.clone(), P, mb_w, mb_h)),
            "deblock_chroma": ((WK.deblock_chroma,
                                WF.deblock_chroma_plain),
                               lambda: (icb.clone(), icr.clone(), P, mb_w,
                                        mb_h)),
        }

    # picture 0 (I): kernel median of 20, plain once; picture 2 (inter, 5 %
    # intra MBs): kernel median of 20
    passes = pass_inputs(0)
    times = {k: (event_ms(fk, mk_, 20), event_ms(fp, mk_, 1))
             for k, ((fk, fp), mk_) in passes.items()}
    inter_ms = {k: event_ms(fk, mk_, 20)
                for k, ((fk, _), mk_) in pass_inputs(2).items()}
    inter_ms["idct8x8"] = None
    y, cb, cr, P, has_i8 = captured[0]
    times["idct8x8"] = (event_ms(IK.idct8x8_blocks, lambda: (coef,), 20),
                        event_ms(IK.idct8x8_blocks_plain, lambda: (coef,),
                                 20))

    # bounds: bytes each pass must move (its inputs read once, its planes
    # written once) over HBM, and its operations over the peak rate. A
    # wavefront has a third, its schedule's dependency floor: the
    # handoffs between CTAs on the schedule's critical path times the
    # least time of one (handoff_step_ms): the row-schedule kernels hand
    # off once per MB row after the first (mb_h - 1). Beside it, the floor
    # of the schedule they replaced, one launch per anti-diagonal
    # (launch_step_ms, nd dependent launches a pass)
    nd = mb_w + 2 * mb_h - 2
    handoffs = {k: mb_h - 1 for k in ROW_KERNELS}
    step_ms = handoff_step_ms(procs, nd, dev)
    launch_ms = launch_step_ms(nd, dev)
    keys = {"intra_luma": WF.INTRA_LUMA_KEYS + WF.I8_KEYS,
            "intra_chroma": WF.INTRA_CHROMA_KEYS,
            "deblock_luma": WF.DEB_KEYS, "deblock_chroma": WF.DEB_KEYS}
    planes = {"intra_luma": (y,), "intra_chroma": (cb, cr),
              "deblock_luma": (y,), "deblock_chroma": (cb, cr)}
    bounds = {}
    for k in passes:
        moved = (tensor_bytes([P[n] for n in keys[k]])
                 + 2 * tensor_bytes(planes[k]))
        bytes_ms = 1e3 * moved / HBM_BYTES_S
        ops_ms = (1e3 * WAVEFRONT_OPS_PER_SAMPLE
                  * sum(t.numel() for t in planes[k]) / OPS_S)
        bounds[k] = (max(bytes_ms, ops_ms),
                     "bytes" if bytes_ms >= ops_ms else "operations",
                     handoffs[k] * step_ms)
    nblk = coef.numel() // 64
    idct_bytes_ms = 1e3 * nblk * (128 + 256) / HBM_BYTES_S
    idct_ops_ms = 1e3 * nblk * IDCT_OPS_PER_BLOCK / OPS_S
    bounds["idct8x8"] = (max(idct_bytes_ms, idct_ops_ms),
                         "bytes" if idct_bytes_ms >= idct_ops_ms
                         else "operations", None)

    phase(7, f"timing on {smi}: H.264 {W}x{H} Phase B kernel path "
             f"{kern_ms:.2f} ms/picture ({1e3 / kern_ms:.2f} fps, median "
             f"of 3 x {len(plans)}), plain path {plain_ms:.1f} ms/picture "
             f"({1e3 / plain_ms:.3f} fps, one run); Phase A "
             f"{1e3 * phase_a_s / len(plans):.1f} ms/picture on the host; "
             f"end to end (TurboH264Decoder, Phase A + B, warm) "
             f"{e2e_ms:.2f} ms/picture ({1e3 / e2e_ms:.2f} fps, median of "
             f"3)")
    phase(7, f"timing on {smi}: MPEG-2 {W}x{H} Phase B kernel path "
             f"{m2_kern_ms:.2f} ms/picture ({1e3 / m2_kern_ms:.2f} fps), "
             f"plain path {m2_plain_ms:.2f} ms/picture "
             f"({1e3 / m2_plain_ms:.2f} fps), both median of 5 x "
             f"{len(items)} run in turns; host enqueue "
             f"{100 * min(enqueue_share):.1f}-"
             f"{100 * max(enqueue_share):.1f} % of each run's time; Phase A "
             f"{1e3 * m2_phase_a_s / len(items):.1f} ms/picture on the host; "
             f"end to end (TurboMpeg2Decoder, Phase A + B, warm) "
             f"{m2_e2e_ms:.2f} ms/picture ({1e3 / m2_e2e_ms:.2f} fps, median "
             f"of 3)")
    phase(7, f"MPEG-2 kernel-path batch under torch.profiler on {smi}: "
             f"{1e3 * prof_s / len(items):.3f} ms/picture of wall time, "
             f"{busy_ms / len(items):.3f} ms/picture of device time (busy "
             f"share {busy_ms / (1e3 * prof_s):.3f}); largest device items, "
             f"ms/picture: " + json.dumps(
                 {k: round(v / len(items), 4) for k, v in top}))
    phase(7, f"kernel ms [kernel on picture 0, kernel on picture 2, plain, "
             f"bound, bound_by, dependency floor] (CUDA events; wavefront "
             f"passes on H.264 pictures 0 (I) and 2 (inter), kernel median of "
             f"20, plain once on picture 0; IDCT over the batch's {nblk} "
             f"blocks, median of 20 each; dependency floor of each "
             f"schedule: its handoffs between CTAs on the critical path "
             f"({json.dumps(handoffs)}) x {1e3 * step_ms:.3f} us, one flag "
             f"handoff; one launch per diagonal, graph-replayed, "
             f"{1e3 * launch_ms:.3f} us, {nd * launch_ms:.4f} ms a pass): "
             + json.dumps(
                 {k: [round(times[k][0], 4),
                      None if inter_ms[k] is None else round(inter_ms[k], 4),
                      round(times[k][1], 3), round(bounds[k][0], 5),
                      bounds[k][1], None if bounds[k][2] is None
                      else round(bounds[k][2], 4)] for k in REPLACES}))

    # -- phase 8: H.264 on 4 and 8 streams (MultiStreamPhaseB) -----------
    multi_launches, stacked_ms, plans2, stream_cks = multi_stream(
        dev, smi, procs, data, kern, geom)

    # -- phase 9: H.265 (TurboH265Decoder, the tile kernel) --------------
    h265_verified, tile_entry = h265(dev, smi, procs, step_ms)

    # -- phase 10: the command-line tools on the card --------------------
    cli_launches, _ = entry_points(dev, smi, procs, data, m2data, turbo,
                                   m2_turbo)

    # -- phase 11: multi-device decode (parallel.mesh) on the card --------
    mesh_launches = mesh_phase(
        dev, smi, (plans, len(dec.frames), geom, ck_k, plans2, stream_cks),
        h265_verified, (items, mgeom, m_kern, mk), t_start)

    # -- phase 12: plans without coded maps (the Python decoder's) --------
    pyplan_launches = python_plans_phase(dev, smi, procs, geom, plans,
                                         plans2, stream_cks)

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "m2dec_tpu"))
    if bad:
        raise RuntimeError(f"the JAX package was imported: {bad}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": IDCT_SOURCE if k == "idct8x8" else H264_SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": times[k][0],
         "plain_ms": times[k][1], "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": None,
         "dependency_ms": bounds[k][2], "inter_ms": inter_ms[k],
         "multistream_launches": {S: v.get(k, 0)
                                  for S, v in multi_launches.items()},
         "stacked4_ms": stacked_ms.get(k),
         "cli_launches": cli_launches[k],
         "mesh_launches": mesh_launches[k],
         "pyplan_launches": {run: v.get(k, 0)
                             for run, v in pyplan_launches.items()}}
        for k in REPLACES] + [
        {**tile_entry, "cli_launches": cli_launches["h265_tile"],
         "mesh_launches": mesh_launches["h265_tile"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
