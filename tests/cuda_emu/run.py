#!/usr/bin/env python3
"""Check the four row-schedule kernels of csrc/h264_wavefront.cu on the
CPU, without nvcc or a GPU.

The kernel source is compiled with g++ against ``cuda_runtime.h`` here,
which stubs the CUDA intrinsics the kernels use (shuffles, warp and
named barriers, ``__ldcg``, the acquire/relaxed flag accesses, clock64):
one CTA runs as threads (two warps, 64 threads; one warp for intra
chroma) and takes every MB row in turn, by ticket. Each launch is a
stack of 1, 2 or 3 streams with different plans (random, narrow,
all-intra, zero deblock strength); its output is held against the plain
versions (``codecs/h264/wavefront.py``) run on each stream alone, byte
for byte, and every row's progress flag of every stream must end at
mb_w. It checks the kernels' arithmetic, windows, the slot hand-over
between the two warps of a CTA, the window carried from MB to MB and the
per-stream addressing of a stacked launch; races between CTAs, the L1/L2
behaviour and the compiler for sm_90a show only on the card.

    python3 tests/cuda_emu/run.py        # from the root of a checkout
"""

import ctypes
import pathlib
import re
import subprocess
import sys

import torch

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

from torch_helpers import rand_planes, rand_wavefront_plan, torch_plan  # noqa: E402

from m2dec_tpu_torch.codecs.h264 import wavefront as WF  # noqa: E402
from m2dec_tpu_torch.codecs.h264.state import device_tables  # noqa: E402

SOURCE = REPO / "m2dec_tpu_torch" / "csrc" / "h264_wavefront.cu"
BUILD = REPO / "build" / "cuda_emu"

#: the host side: run a kernel on one CTA of n threads (64 or 32)
HARNESS = r'''
}  // namespace
thread_local dim3e threadIdx;
dim3e blockIdx, blockDim;
std::barrier<> *emu_wbar[2];
std::barrier<> *emu_nbar[16];
int emu_xch[2][32];
#include <thread>
#include <vector>
template <class A, class K> static void run1(K k, const A& a, int n = 64) {
  std::barrier<> w0(32), w1(32);
  emu_wbar[0] = &w0;
  emu_wbar[1] = &w1;
  std::vector<std::barrier<>*> nb;
  for (int i = 0; i < 16; ++i) {
    nb.push_back(new std::barrier<>(n));
    emu_nbar[i] = nb.back();
  }
  std::vector<std::thread> th;
  for (int l = 0; l < n; ++l)
    th.emplace_back([&, l] { threadIdx = {l, 0, 0}; k(a); });
  for (auto& t : th) t.join();
  for (auto* b : nb) delete b;
}
extern "C" {
void emu_intra_luma(void* y, const void* kind, const void* res_y,
    const void* i4m, const void* i4a, const void* i8m, const void* i8a,
    const void* i16, const void* mbav, const void* tab4, const void* tab8,
    void* progress, int has_i8, int mb_w, int mb_h, int n_streams) {
  IntraLumaArgs a = {(uint8_t*)y, (const int*)kind, (const int*)res_y,
    (const int*)i4m, (const int*)i4a, (const int*)i8m, (const int*)i8a,
    (const int*)i16, (const int*)mbav, (const int*)tab4, (const int*)tab8,
    (int*)progress, mb_w, mb_h, has_i8, n_streams};
  run1(intra_luma_kernel, a);
}
void emu_deblock_luma(void* y, const void* s, const void* s4,
    const void* ab, const void* al, const void* be, const void* tc,
    void* progress, int mb_w, int mb_h, int n_streams) {
  DeblockLumaArgs a = {(uint8_t*)y, (const int*)s, (const int*)s4,
    (const int*)ab, (const int*)al, (const int*)be, (const int*)tc,
    (int*)progress, mb_w, mb_h, n_streams};
  run1(deblock_luma_kernel, a);
}
void emu_intra_chroma(void* cb, void* cr, const void* kind,
    const void* res_c, const void* mode, const void* mbav, void* progress,
    int mb_w, int mb_h, int n_streams) {
  IntraChromaArgs a = {(uint8_t*)cb, (uint8_t*)cr, (const int*)kind,
    (const int*)res_c, (const int*)mode, (const int*)mbav, (int*)progress,
    mb_w, mb_h, n_streams};
  run1(intra_chroma_kernel, a, 32);
}
void emu_deblock_chroma(void* cb, void* cr, const void* s, const void* s4,
    const void* ab, const void* al, const void* be, const void* tc,
    void* progress, int mb_w, int mb_h, int n_streams) {
  DeblockChromaArgs a = {(uint8_t*)cb, (uint8_t*)cr, (const int*)s,
    (const int*)s4, (const int*)ab, (const int*)al, (const int*)be,
    (const int*)tc, (int*)progress, mb_w, mb_h, n_streams};
  run1(deblock_chroma_kernel, a);
}
}
'''

#: inline PTX -> the emulation's calls
PTX = [(r'asm volatile\("ld\.acquire.*?"memory"\);',
        'v = __atomic_load_n(p, __ATOMIC_ACQUIRE);'),
       (r'asm volatile\("st\.relaxed.*?"memory"\);',
        '__atomic_store_n(p, v, __ATOMIC_RELAXED);'),
       (r'asm volatile\("bar\.sync.*?"memory"\);', 'emu_bar_sync(id);'),
       (r'asm volatile\("bar\.arrive.*?"memory"\);', 'emu_bar_arrive(id);')]


def build():
    """The kernels (everything before the host launch code) + HARNESS,
    compiled with g++ into build/cuda_emu/; returns the library."""
    src = SOURCE.read_text()
    body = src[:src.index("// CTAs of a row-schedule launch")]
    for pat, repl in PTX:
        body, n = re.subn(pat, repl, body, flags=re.S)
        if n != 1:
            raise RuntimeError(f"{pat}: {n} matches, want 1")
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "emu.cpp").write_text(body + HARNESS)
    subprocess.run(["g++", "-std=c++20", "-O1", f"-I{HERE}", "-shared",
                    "-fPIC", "-o", str(BUILD / "libemu.so"),
                    str(BUILD / "emu.cpp"), "-lpthread"], check=True)
    lib = ctypes.CDLL(str(BUILD / "libemu.so"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.emu_intra_luma.argtypes = [vp] * 12 + [i] * 4
    lib.emu_deblock_luma.argtypes = [vp] * 8 + [i] * 3
    lib.emu_intra_chroma.argtypes = [vp] * 7 + [i] * 3
    lib.emu_deblock_chroma.argtypes = [vp] * 9 + [i] * 3
    return lib


def run_kernel(lib, tabs, name, planes, P, has_i8, mb_w, mb_h):
    """Kernel ``name`` on copies of ``planes`` ([S, H, W] stacks, P
    [S * n, ...]) in the emulation, one launch for the S streams; returns
    (the planes, the progress flags)."""
    got = [t.clone() for t in planes]
    S = planes[0].shape[0]
    prog = torch.zeros(S * mb_h + 1, dtype=torch.int32)
    ptrs = [t.data_ptr() for t in got]
    deb = [P[k] for k in ("deb_str", "deb_str4", "deb_ab")] + [
        tabs[k] for k in ("alpha", "beta", "tc0")]
    if name == "intra_luma":
        meta = [P[k] for k in (
            "kind", "res_y", "i4_modes", "i4_avail", "i8_modes",
            "i8_avail", "i16_mode", "mb_avail")]
        meta += [tabs["i4_tab"], tabs["i8_tab"], prog]
        lib.emu_intra_luma(*ptrs, *(t.data_ptr() for t in meta),
                           int(has_i8), mb_w, mb_h, S)
    elif name == "intra_chroma":
        meta = [P[k] for k in ("kind", "res_c", "chroma_mode",
                               "mb_avail")] + [prog]
        lib.emu_intra_chroma(*ptrs, *(t.data_ptr() for t in meta), mb_w,
                             mb_h, S)
    else:
        fn = getattr(lib, "emu_" + name)
        fn(*ptrs, *(t.data_ptr() for t in deb + [prog]), mb_w, mb_h, S)
    return got, prog


VARIANTS = ("wide", "narrow", "intra", "zero")


def stream_inputs(mb_w, mb_h, seed, variant):
    """One stream's plan (numpy) and planes (torch) for ``variant``."""
    Pn = rand_wavefront_plan(
        mb_w, mb_h, seed, wide=variant != "narrow",
        kinds=(1, 2, 3) if variant == "intra" else None)
    if variant == "zero":
        Pn["deb_str"][:] = 0
        Pn["deb_str4"][:] = 0
    return torch_plan(Pn), [torch.from_numpy(a)
                            for a in rand_planes(mb_w, mb_h, seed)]


def plain_runs(P, y, cb, cr, mb_w, mb_h):
    """(name, has_i8, planes, the plain versions' output) of every run."""
    runs = [("intra_luma", h, (y,), (WF.intra_luma_plain(
        y, P, h, mb_w, mb_h),)) for h in (True, False)]
    return runs + [
        ("deblock_luma", None, (y,),
         (WF.deblock_luma_plain(y, P, mb_w, mb_h),)),
        ("intra_chroma", None, (cb, cr),
         WF.intra_chroma_plain(cb, cr, P, mb_w, mb_h)),
        ("deblock_chroma", None, (cb, cr),
         WF.deblock_chroma_plain(cb, cr, P, mb_w, mb_h))]


def main():
    lib = build()
    tabs = device_tables("cpu")
    bad = 0
    for mb_w, mb_h in [(4, 2), (5, 3), (1, 9), (11, 9), (3, 20), (20, 12)]:
        for seed in (1, 2):
            for S in (1, 2, 3):
                # stream s: its own seed and variant
                variants = [VARIANTS[(seed + S + s) % 4] for s in range(S)]
                ins = [stream_inputs(mb_w, mb_h, 10 * seed + s, v)
                       for s, v in enumerate(variants)]
                P = {k: torch.cat([p[k] for p, _ in ins]) for k in ins[0][0]}
                y, cb, cr = (torch.stack(t) for t in zip(*(pl for _, pl in
                                                           ins)))
                per_stream = [plain_runs(p, *pl, mb_w, mb_h)
                              for p, pl in ins]
                for r, (name, has_i8, _, _) in enumerate(per_stream[0]):
                    planes = (y,) if name.endswith("luma") else (cb, cr)
                    want = [torch.stack([runs[r][3][i] for runs in
                                         per_stream])
                            for i in range(len(planes))]
                    got, prog = run_kernel(lib, tabs, name, planes, P,
                                           has_i8, mb_w, mb_h)
                    err = max((g.int() - w.int()).abs().max().item()
                              for g, w in zip(got, want))
                    done = prog[:S * mb_h].tolist() == [mb_w] * (S * mb_h)
                    if err or not done:
                        bad += 1
                        print(f"{name} {mb_w}x{mb_h} seed {seed} streams "
                              f"{variants} has_i8 {has_i8}: max abs err "
                              f"{err}, progress {prog.tolist()}")
    print(f"{bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
