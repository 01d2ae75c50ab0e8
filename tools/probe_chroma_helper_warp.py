#!/usr/bin/env python3
"""Deblock chroma on the row schedule: the kernel in
m2dec_tpu_torch/csrc/h264_wavefront.cu (a compute warp and a helper
warp per CTA) against a variant with one warp per CTA, timed in turns
on one GPU.

The variant (VARIANT_CU below) runs everything in one warp: it stages
MB x + 1 into registers while it runs MB x, waits for the row above,
loads the strip above, filters, stores tile x - 1 and MB x's top strip,
fences and publishes. The kernel hands the staging, the stores, the
fence and the publication to its helper warp. The variant is compiled
from the device code of the kernel source plus VARIANT_CU into
build/probe_chroma/ and launched through ctypes.

Inputs: pictures 0 (I) and 2 (inter) of chip_smoke.py's 1080p H.264
stream (made and cached as chip_smoke.py does), after the intra passes.
Both designs are held against the plain version byte for byte (the
variant 20 times over), then timed with CUDA events, median of 20, in
four turns (kernel, variant, variant, kernel, ...). The last line is a
JSON object with the card, its power limit and the times in ms.

    python3 tools/probe_chroma_helper_warp.py   # from a checkout, one GPU
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "build" / "probe_chroma"

#: the one-warp variant, appended to the kernel source's device code
VARIANT_CU = r'''
namespace {

__global__ void __launch_bounds__(32)
deblock_chroma_one_warp_kernel(const DeblockChromaArgs a) {
  const int lane = threadIdx.x & 31;
  const int W = a.mb_w * 8, H = a.mb_h * 8;
  // a window per slot (MB x in slot x & 1) and plane, (r, c) <-> pixel
  // (y0 - 2 + r, x0 - 2 + c): rows 0..1 the top MB's last rows, columns
  // 0..1 the left MB's last columns (the corner r, c < 2 is never read),
  // rows 2..9 x columns 2..9 the MB's own tile; rows padded to 11
  __shared__ int Wc[2][2][10][11];
  __shared__ int sA[52], sB[52], sT[3 * 52];
  for (int i = lane; i < 52; i += 32) {
    sA[i] = __ldg(a.alpha + i);
    sB[i] = __ldg(a.beta + i);
  }
  for (int i = lane; i < 3 * 52; i += 32) sT[i] = __ldg(a.tc0 + i);
  __syncwarp();
  // lane: plane ci; its filter line k of edge 2 * e2 on each axis; its
  // word of the tile (row tr, columns 4 * th..4 * th + 3)
  const int ci = lane >> 4, e2 = (lane >> 3) & 1, k = lane & 7;
  const int tr = (lane >> 1) & 7, th = lane & 1;
  uint8_t* plane = ci ? a.cr : a.cb;

  for (int mby; (mby = take_row_warp(a.progress + a.mb_h, lane)) < a.mb_h;) {
    const int y0 = mby * 8;
    DebChromaStage cur, nxt;
    deblock_chroma_stage(cur, a, 0, mby, lane);
    int seen = 0;
    bool dirty = false, prev_act = false;
    for (int x = 0; x < a.mb_w; ++x) {
      const int sl = x & 1, x0 = x * 8;
      if (x + 1 < a.mb_w) deblock_chroma_stage(nxt, a, x + 1, mby, lane);
      EdgeParams ep[2];
      bool on = false;
      for (int axis = 0; axis < 2; ++axis) {
        ep[axis] = edge_params(cur.str[axis], cur.str4[axis], cur.ab[axis],
                               k, 1, sA, sB, sT);
        on |= ep[axis].s > 0;
      }
      const bool act = __any_sync(FULL, on);
      // the window: the tile, and the left columns from the previous slot
      // (0 left of the picture)
      int(*w)[11] = Wc[sl][ci];
      put_word(&w[2 + tr][2 + 4 * th], cur.px);
      w[2 + tr][th] = x > 0 ? Wc[sl ^ 1][ci][2 + tr][8 + th] : 0;
      if (act) {
        // the top strip, once tile x of the row above is stored
        if (mby > 0) wait_row(a.progress + mby - 1, x + 1, seen, lane);
        if (lane < 8) {
          const int p = lane >> 2, rr = (lane >> 1) & 1;
          put_word(&Wc[sl][p][rr][2 + 4 * th],
                   ld_word(p ? a.cr : a.cb, W, H, y0 - 2 + rr,
                           x0 + 4 * th));
        }
        __syncwarp();
        // vertical edges, then horizontal ones: lane takes line k of edge
        // 2 * e2 of its plane (a window row, then a window column); edges 0
        // and 2 of an axis touch disjoint samples
        for (int axis = 0; axis < 2; ++axis) {
          int* v[4];
          for (int j = 0; j < 4; ++j)
            v[j] = axis == 0 ? &w[2 + k][4 * e2 + j] : &w[4 * e2 + j][2 + k];
          filter_line_chroma(v, ep[axis]);
          __syncwarp();
        }
      }
      // tile x - 1 is final: its columns 6..7 back from this window, then
      // stored if this MB or the last one filtered; this MB's top strip
      // stored if it filtered (nothing above the picture is written)
      if (x > 0) {
        Wc[sl ^ 1][ci][2 + tr][8 + th] = w[2 + tr][th];
        __syncwarp();
        if (act || prev_act) {
          st_word(plane, W, y0 + tr, x0 - 8 + 4 * th,
                  &Wc[sl ^ 1][ci][2 + tr][2 + 4 * th]);
          dirty = true;
        }
      }
      if (act && mby > 0) {
        if (lane < 8) {
          const int p = lane >> 2, rr = (lane >> 1) & 1;
          st_word(p ? a.cr : a.cb, W, y0 - 2 + rr, x0 + 4 * th,
                  &Wc[sl][p][rr][2 + 4 * th]);
        }
        dirty = true;
      }
      if (x > 0)
        publish_if(a.progress + mby, x, dirty, lane);
      else
        __syncwarp();
      prev_act = act;
      cur = nxt;
    }
    // the last tile
    if (prev_act) {
      st_word(plane, W, y0 + tr, (a.mb_w - 1) * 8 + 4 * th,
              &Wc[(a.mb_w - 1) & 1][ci][2 + tr][2 + 4 * th]);
      dirty = true;
    }
    publish_if(a.progress + mby, a.mb_w, dirty, lane);
  }
}

}  // namespace

extern "C" int probe_deblock_chroma_one_warp(
    void* cb, void* cr, const void* deb_str, const void* deb_str4,
    const void* deb_ab, const void* alpha, const void* beta,
    const void* tc0, void* progress, int mb_w, int mb_h, void* stream) {
  const DeblockChromaArgs a = {
      (uint8_t*)cb, (uint8_t*)cr, (const int*)deb_str,
      (const int*)deb_str4, (const int*)deb_ab, (const int*)alpha,
      (const int*)beta, (const int*)tc0, (int*)progress, mb_w, mb_h};
  int grid = 0;
  const cudaError_t err =
      row_grid(deblock_chroma_one_warp_kernel, 32, mb_h, &grid);
  if (err != cudaSuccess) return (int)err;
  deblock_chroma_one_warp_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
'''


def build_variant():
    """The kernel source's device code + VARIANT_CU, compiled with the
    kernels' nvcc flags; returns (ctypes library, ptxas report)."""
    from m2dec_tpu_torch import _build

    src = (_build.CSRC / "h264_wavefront.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "variant.cu"
    cu.write_text(src[:src.index('extern "C" {')] + VARIANT_CU)
    so = OUT / "libvariant.so"
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.probe_deblock_chroma_one_warp
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    report = [line.strip() for line in (res.stdout + res.stderr).splitlines()
              if "Used" in line or "spill" in line]
    return fn, report


def capture_pictures(dev):
    """(cb, cr, P, mb_w, mb_h) before deblock chroma, for pictures 0 and
    2 of chip_smoke.py's 1080p H.264 stream (BatchedPhaseB hands the
    passes [1, H, W] stacks of its one stream)."""
    import chip_smoke as CS
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.decoder import H264Decoder
    from m2dec_tpu_torch.codecs.h264.plan_host import dev_pool_size
    from m2dec_tpu_torch.codecs.h264.reconstruct import BatchedPhaseB

    CS.STREAMS = {CS.H264_STREAM: CS.STREAMS[CS.H264_STREAM]}
    data = CS.stream(CS.H264_STREAM, CS.start_streams())
    dec = H264Decoder(native=True, plan_alloc="empty")
    dec.set_data(data)
    while dec.decode_picture() == 1:
        pass
    geom = (dec.max_x, dec.max_y,
            dev_pool_size(dec.sps.num_ref_frames, len(dec.frames)))
    pics = {}

    def capturing(y, cb, cr, P, has_i8, deblock, mbw, mbh):
        y = WK.intra_luma(y, P, has_i8, mbw, mbh)
        cb, cr = WK.intra_chroma(cb, cr, P, mbw, mbh)
        pics[len(pics)] = (cb[0].clone(), cr[0].clone(),
                           {n: v.clone() for n, v in P.items()}, mbw, mbh)
        if deblock:
            y = WK.deblock_luma(y, P, mbw, mbh)
            cb, cr = WK.deblock_chroma(cb, cr, P, mbw, mbh)
        return y, cb, cr

    BatchedPhaseB(*geom, device=dev, wavefronts=capturing).run_async(
        dec.plans)
    return pics[0], pics[2]


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(REPO)]
    import chip_smoke as CS
    from m2dec_tpu_torch.codecs.h264 import wavefront as WF
    from m2dec_tpu_torch.codecs.h264 import wavefront_kernels as WK
    from m2dec_tpu_torch.codecs.h264.state import device_tables

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    variant, report = build_variant()
    print("variant ptxas: " + "; ".join(report), flush=True)
    tabs = device_tables(dev)

    def one_warp(cb, cr, P, mb_w, mb_h):
        prog = torch.zeros(mb_h + 1, dtype=torch.int32, device=dev)
        meta = [P[k].contiguous() for k in WF.DEB_KEYS] + [
            tabs[k] for k in ("alpha", "beta", "tc0")]
        err = variant(cb.data_ptr(), cr.data_ptr(),
                      *(t.data_ptr() for t in meta), prog.data_ptr(), mb_w,
                      mb_h, torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"variant launch failed: {err}")
        return cb, cr

    result = {"card": smi, "ms": {}}
    for name, (cb, cr, P, mb_w, mb_h) in zip(("picture 0", "picture 2"),
                                             capture_pictures(dev)):
        want = WF.deblock_chroma_plain(cb, cr, P, mb_w, mb_h)
        outs = [WK.deblock_chroma(cb.clone(), cr.clone(), P, mb_w, mb_h)]
        outs += [one_warp(cb.clone(), cr.clone(), P, mb_w, mb_h)
                 for _ in range(20)]
        torch.cuda.synchronize()
        for got in outs:
            for g, w in zip(got, want):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{name}: a design differs from the "
                                       f"plain version")
        runs = {"helper_warp": [], "one_warp": []}
        fns = {"helper_warp": WK.deblock_chroma, "one_warp": one_warp}
        for t in range(8):
            key = list(runs)[(t + t // 2) % 2]
            runs[key].append(CS.event_ms(
                fns[key], lambda: (cb.clone(), cr.clone(), P, mb_w, mb_h),
                20))
        result["ms"][name] = {k: [round(v, 4) for v in vs]
                              for k, vs in runs.items()}
        print(f"{name} on {smi}: deblock chroma ms, median of 20 per turn, "
              f"in turns: " + json.dumps(result["ms"][name]), flush=True)
    result["median_ms"] = {
        p: {k: statistics.median(v) for k, v in d.items()}
        for p, d in result["ms"].items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
