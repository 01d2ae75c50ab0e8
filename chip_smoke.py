#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (m2dec_tpu_torch) on one GPU.

Drives the port's H.264 main path at 1920x1088 (the bench stream:
12-picture GOP IPBPBPBPBPBP, seed 42) through TurboH264Decoder: native
C++ Phase A on the host, batched Phase B on the card with the four CUDA
wavefront kernels. Then it holds each kernel against its plain PyTorch
version on the card, the whole path against the plain path, the numpy
reference and the serial decoder, and times the kernel and plain paths.

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Every phase prints one line; a phase that fails raises and the script
exits non-zero. The last line is the JSON result. Without a CUDA device,
or outside a checkout of the repository, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
W, H = 1920, 1088
PATTERN = "IPBPBPBPBPBP"
SEED = 42
BATCH = len(PATTERN)
STREAM = REPO / "build" / "chip_smoke" / f"h264_{W}x{H}_s{SEED}.264"
SOURCE = "m2dec_tpu_torch/csrc/h264_wavefront.cu"
#: kernel -> the Pallas kernel it replaces
REPLACES = {
    "intra_luma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:125",
    "intra_chroma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:157",
    "deblock_luma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:201",
    "deblock_chroma": "m2dec_tpu/codecs/h264/pallas_wavefront.py:237",
}
#: seconds after which the optional second reference picture is skipped
REF_PIC1_BUDGET_S = 500


def phase(n, text):
    print(f"phase {n} {text}", flush=True)


def bench_stream():
    """The bench's 1080p stream, generated once and cached under build/."""
    if not STREAM.is_file():
        from streamgen.h264_enc import H264BGen

        gen = H264BGen(W, H, seed=SEED, num_ref_frames=2,
                       b_direct_prob=0.3, skip_prob=0.35, intra_prob=0.08,
                       qp=30, disable_deblock=False)
        STREAM.parent.mkdir(parents=True, exist_ok=True)
        tmp = STREAM.with_suffix(".tmp")
        tmp.write_bytes(gen.generate(PATTERN))
        tmp.replace(STREAM)
    return STREAM.read_bytes()


def max_abs_err(a, b):
    import torch

    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


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
    sys.path[:0] = [str(REPO), str(REPO / "tests")]

    from m2dec_tpu_torch import _build
    from m2dec_tpu_torch.codecs.h264 import host
    from m2dec_tpu_torch.codecs.h264 import wavefront as WF
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.reconstruct import (
        BatchedPhaseB,
        frame_checksums,
    )
    from m2dec_tpu_torch.device import cuda_device
    from m2dec_tpu_torch.runtime.turbo import TurboH264Decoder

    t_start = time.perf_counter()
    dev = cuda_device()
    sync = torch.cuda.synchronize

    # -- phase 1: environment and kernel build ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    phase(1, f"environment: {smi}; torch {torch.__version__} cuda "
             f"{torch.version.cuda}; {nvcc}; kernel build {build_s:.2f} s")

    # -- phase 2: the main path on the 1080p stream ----------------------
    t0 = time.perf_counter()
    data = bench_stream()
    gen_s = time.perf_counter() - t0
    WK.reset_launch_counts()
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
        raise RuntimeError(f"main path output {len(turbo)} frames, "
                           f"want {BATCH}")
    idle = [k for k, v in launches.items() if v <= 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the main path: {idle}")
    phase(2, f"main path: TurboH264Decoder {W}x{H} {PATTERN} batch "
             f"{BATCH}: {len(turbo)} frames in {main_s:.2f} s (stream "
             f"{len(data)} B, ready in {gen_s:.1f} s); launches "
             f"{json.dumps(launches)}")

    # -- phase 3: kernels vs plain at full size --------------------------
    dec = host.H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    t0 = time.perf_counter()
    while dec.decode_picture() == 1:
        pass
    phase_a_s = time.perf_counter() - t0
    plans = dec.plans
    geom = (dec.max_x, dec.max_y,
            host.dev_pool_size(dec.sps.num_ref_frames, len(dec.frames)))
    mb_w, mb_h = geom[0], geom[1]
    captured = {}

    def capturing(y, cb, cr, P, has_i8, deblock, mbw, mbh):
        k = len(captured.setdefault("order", []))
        captured["order"].append(k)
        if k in (0, 2):
            captured[k] = (y.clone(), cb.clone(), cr.clone(),
                           {n: v.clone() for n, v in P.items()}, has_i8)
        return WK.run_wavefronts(y, cb, cr, P, has_i8, deblock, mbw, mbh)

    kern = BatchedPhaseB(*geom, device=dev,
                         wavefronts=capturing).run_async(plans)
    t0 = time.perf_counter()
    plain = BatchedPhaseB(*geom, device=dev,
                          wavefronts=WF.run_wavefronts_plain).run_async(
                              plans)
    sync()
    plain_first_s = time.perf_counter() - t0
    ck_k = frame_checksums(*kern).cpu()
    ck_p = frame_checksums(*plain).cpu()
    if not torch.equal(ck_k, ck_p):
        bad = [i for i in range(len(plans)) if not torch.equal(ck_k[i],
                                                               ck_p[i])]
        raise RuntimeError(f"kernel path != plain path on pictures {bad}")
    turbo_set = sorted(tuple(c.flatten().tolist()) for c in turbo)
    if turbo_set != sorted(tuple(c.flatten().tolist()) for c in ck_k):
        raise RuntimeError("main-path frames differ from the batched run")

    # kernel wrappers vs plain versions on the main path's own inputs
    errs = {k: 0 for k in REPLACES}
    for k in (0, 2):
        y, cb, cr, P, has_i8 = captured[k]
        want_y = WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
        got_y = WK.intra_luma(y.clone(), P, has_i8, mb_w, mb_h)
        errs["intra_luma"] = max(errs["intra_luma"],
                                 max_abs_err(got_y, want_y))
        want_c = WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)
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

    # the numpy reference Phase B on the first pictures
    ref = host.H264Decoder(native=True, phase_b="np")
    ref.set_data(data)
    n_ref = 0
    for i in range(2):
        if i and time.perf_counter() - t_start > REF_PIC1_BUDGET_S:
            break
        if ref.decode_picture() != 1:
            raise RuntimeError("reference decode stopped early")
        f = ref.frames[ref.plans[i].cur_idx]
        for pl, a in zip(("y", "cb", "cr"), kern):
            if not (a[i].cpu().numpy() == getattr(f, pl)).all():
                raise RuntimeError(f"picture {i} {pl} != recon_ref")
        n_ref += 1
    phase(3, f"kernels vs plain at full size: {len(plans)} pictures equal "
             f"by device checksum, per-kernel max abs err "
             f"{json.dumps(errs)} (tolerance 0) on pictures 0 and 2, "
             f"pictures 0..{n_ref - 1} equal to recon_ref byte for byte")

    # -- phase 4: coverage the 1080p stream lacks -------------------------
    from streamgen.h264_enc import H264HighGen, H264StreamGen

    cover = (("High 8x8 + deblock 176x144",
              H264HighGen(176, 144, seed=1, intra_prob=0.2, skip_prob=0.15,
                          qp=29, disable_deblock=False).generate("IPPIP")),
             ("IPCM 48x32", H264StreamGen(48, 32, seed=1).generate("III")))
    WK.reset_launch_counts()
    for name, s in cover:
        serial = host.H264Decoder()
        serial.set_data(s)
        exp = serial.decode_all()
        got = TurboH264Decoder(s, batch=4, device=dev).decode_all()
        if len(got) != len(exp):
            raise RuntimeError(f"{name}: {len(got)} frames, want {len(exp)}")
        for k, (g, e) in enumerate(zip(got, exp)):
            for pl in ("y", "cb", "cr"):
                if not (getattr(g, pl) == getattr(e, pl)).all():
                    raise RuntimeError(f"{name}: frame {k} {pl} differs")
    if WK.LAUNCHES["deblock_luma"] <= 0:
        raise RuntimeError("coverage streams did not deblock")
    phase(4, "coverage: " + "; ".join(
        f"{name} equal to the serial decoder" for name, _ in cover))

    # -- phase 5: timing ---------------------------------------------------
    def run_path(wavefronts):
        sync()
        t = time.perf_counter()
        BatchedPhaseB(*geom, device=dev,
                      wavefronts=wavefronts).run_async(plans)
        sync()
        return time.perf_counter() - t

    def run_turbo():
        sync()
        t = time.perf_counter()
        n = sum(1 for _ in TurboH264Decoder(data, batch=BATCH,
                                            device=dev).device_frames())
        sync()
        if n != BATCH:
            raise RuntimeError(f"TurboH264Decoder output {n} frames")
        return time.perf_counter() - t

    kern_s = [run_path(WK.run_wavefronts) for _ in range(3)]
    plain_s = [plain_first_s, run_path(WF.run_wavefronts_plain)]
    kern_ms = 1e3 * statistics.median(kern_s) / len(plans)
    plain_ms = 1e3 * min(plain_s) / len(plans)
    e2e_ms = 1e3 * statistics.median([run_turbo() for _ in range(3)]) / BATCH

    def event_ms(fn, make_args, reps):
        ev = []
        for _ in range(reps):
            args = make_args()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(*args)
            e.record()
            ev.append((s, e))
        sync()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    y, cb, cr, P, has_i8 = captured[0]
    iy = WF.intra_luma_plain(y, P, has_i8, mb_w, mb_h)
    icb, icr = WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)
    passes = {
        "intra_luma": ((WK.intra_luma, WF.intra_luma_plain),
                       lambda: (y.clone(), P, has_i8, mb_w, mb_h)),
        "intra_chroma": ((WK.intra_chroma, WF.intra_chroma_plain),
                         lambda: (cb.clone(), cr.clone(), P, mb_w, mb_h)),
        "deblock_luma": ((WK.deblock_luma, WF.deblock_luma_plain),
                         lambda: (iy.clone(), P, mb_w, mb_h)),
        "deblock_chroma": ((WK.deblock_chroma, WF.deblock_chroma_plain),
                           lambda: (icb.clone(), icr.clone(), P, mb_w,
                                    mb_h)),
    }
    pass_ms = {k: (event_ms(fk, mk, 20), event_ms(fp, mk, 1))
               for k, ((fk, fp), mk) in passes.items()}
    phase(5, f"timing on {smi}: {W}x{H} Phase B kernel path "
             f"{kern_ms:.2f} ms/picture ({1e3 / kern_ms:.2f} fps, median "
             f"of 3 x {len(plans)}), plain path {plain_ms:.1f} ms/picture "
             f"({1e3 / plain_ms:.3f} fps, best of 2); Phase A "
             f"{1e3 * phase_a_s / len(plans):.1f} ms/picture on the host; "
             f"end to end (TurboH264Decoder, Phase A + B, warm) "
             f"{e2e_ms:.2f} ms/picture ({1e3 / e2e_ms:.2f} fps, median of "
             f"3); "
             f"per pass on picture 0 (CUDA events, kernel median of 20 / "
             f"plain 1) ms: " + json.dumps(
                 {k: [round(a, 3), round(b, 1)]
                  for k, (a, b) in pass_ms.items()}))

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": errs[k], "ms": pass_ms[k][0],
         "plain_ms": pass_ms[k][1]} for k in REPLACES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
