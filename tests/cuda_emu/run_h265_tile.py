#!/usr/bin/env python3
"""Check the H.265 tile-wavefront kernel of csrc/h265_tile.cu on the CPU,
without nvcc or a GPU.

The kernel source is compiled with g++ against ``cuda_runtime.h`` here
(``__syncwarp``, the named barriers between the two warps, the warp
votes and sums, ``__ldcg``, ``__ldg``, the acquire/relaxed flag
accesses, ``cp.async`` groups applied only at the wait that covers
them, ``atomicAdd``, clock64): one CTA of two warps runs as 64 threads
and takes every (plane, CTU row) in turn by ticket, its shared memory
filled with garbage first. Its output
is held against the plain version (``reconstruct._wavefront_tile_plain``)
byte for byte, and every band's progress flag must end at the CTU
count of a row:

* on every picture of small streams (CTB 16 I/P/B with all modes, CTB 32
  with strong smoothing, transform skip with sign-data hiding, 3-slice
  pictures): each call of the tile wavefront in
  ``replay_plans(..., device="cpu", wf_mode="tile")`` runs the kernel
  too, and the replayed pictures must equal the Python decoder's oracle;
* on random op words (``torch_helpers.rand_tile_inputs``) at CTB 8, 16,
  32 and 64, and at CTB 16 with every op 4x4 and with every luma op a
  DC op carrying the stray pixel.

It checks the kernel's arithmetic, its slot table and its addressing; races
between CTAs, the L1/L2 behaviour and the compiler for sm_90a show only
on the card.

    python3 tests/cuda_emu/run_h265_tile.py   # from the root of a checkout
"""

import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

from streamgen.h265_enc import ALL_MODES, H265StreamGen  # noqa: E402
from torch_helpers import rand_tile_inputs  # noqa: E402

from m2dec_tpu_torch.codecs.h265 import reconstruct as R  # noqa: E402
from m2dec_tpu_torch.codecs.h265 import wavefront_kernels as TK  # noqa: E402
from m2dec_tpu_torch.codecs.h265.headers import H265Decoder  # noqa: E402

SOURCE = REPO / "m2dec_tpu_torch" / "csrc" / "h265_tile.cu"
BUILD = REPO / "build" / "cuda_emu"

#: the host side: the kernel on one CTA of THREADS threads (two warps),
#: its dynamic shared memory filled with garbage first
HARNESS = r'''
}  // namespace
thread_local dim3e threadIdx;
dim3e blockIdx, blockDim;
std::barrier<> *emu_wbar[2];
std::barrier<> *emu_nbar[16];
int emu_xch[2][32];
thread_local std::vector<std::pair<int*, const int*>> emu_cp_open;
thread_local std::deque<std::vector<std::pair<int*, const int*>>>
    emu_cp_groups;
int* emu_smem;
#include <thread>
extern "C" void emu_h265_tile(void* y, void* c, const void* ry,
    const void* rc, const void* zl, const void* zc, const void* ang,
    void* progress, int H, int W, int ctb_log2, int strong_en) {
  const TileArgs a = {(int*)y, (int*)c, (const int*)ry, (const int*)rc,
    (const int*)zl, (const int*)zc, (const int*)ang, (int*)progress, H, W,
    ctb_log2, strong_en};
  std::vector<int> smem(smem_ints(ctb_log2, W >> ctb_log2), 0x5a5a5a5a);
  emu_smem = smem.data();
  std::barrier<> w0(32), w1(32), cta(THREADS), ready(THREADS),
      done(THREADS);
  emu_wbar[0] = &w0;
  emu_wbar[1] = &w1;
  emu_nbar[0] = &cta;
  emu_nbar[BAR_READY] = &ready;
  emu_nbar[BAR_DONE] = &done;
  std::vector<std::thread> th;
  for (int l = 0; l < THREADS; ++l)
    th.emplace_back([&, l] { threadIdx = {l, 0, 0}; tile_kernel(a); });
  for (auto& t : th) t.join();
}
'''

#: inline PTX and the dynamic shared memory -> the emulation's calls
PTX = [(r'asm volatile\("ld\.relaxed.*?"memory"\);',
        'v = __atomic_load_n(p, __ATOMIC_RELAXED);'),
       (r'asm volatile\("fence\.acq_rel\.gpu;" ::: "memory"\);',
        'std::atomic_thread_fence(std::memory_order_acq_rel);'),
       (r'const unsigned d = \(unsigned\)__cvta_generic_to_shared\(dst\);'
        r'\s*asm volatile\("cp\.async\.cg.*?"memory"\);',
        'for (int q = 0; q < 4; ++q) emu_cp_async(dst + q, src + q);'),
       (r'asm volatile\("st\.relaxed.*?"memory"\);',
        '__atomic_store_n(p, v, __ATOMIC_RELAXED);'),
       (r'const unsigned d = \(unsigned\)__cvta_generic_to_shared\(dst\);'
        r'\s*asm volatile\("cp\.async\.ca.*?"memory"\);',
        'emu_cp_async(dst, src);'),
       (r'asm volatile\("cp\.async\.commit_group;" ::: "memory"\);',
        'emu_cp_commit();'),
       (r'asm volatile\("cp\.async\.wait_group 4;" ::: "memory"\);',
        'emu_cp_wait(4);'),
       (r'asm volatile\("cp\.async\.wait_group 0;" ::: "memory"\);',
        'emu_cp_wait(0);'),
       (r'asm volatile\("bar\.sync.*?"memory"\);', 'emu_bar_sync(id);'),
       (r'asm volatile\("bar\.arrive.*?"memory"\);', 'emu_bar_arrive(id);'),
       (r'extern __shared__ int smem\[\];', 'int* smem = emu_smem;')]

#: the streams: (generator keywords, size, pictures)
STREAMS = {
    "ctb16_ipb_96x64": (dict(seed=7, qp=30, cbf_prob=0.5, modes=ALL_MODES,
                             deblock=1, sao=1, max_level=1), (96, 64),
                        "IPB"),
    "ctb32_strong_96x64": (dict(seed=22, ctb_log2=5, qp=14, cbf_prob=0.3,
                                modes=ALL_MODES, strong_smoothing=1,
                                split_prob=0.3), (96, 64), 2),
    "tskip_sdh_64x48": (dict(seed=32, qp=14, cbf_prob=0.7, modes=ALL_MODES,
                             transform_skip=1, sign_data_hiding=1,
                             split_prob=0.7, nxn_prob=0.8), (64, 48), 2),
    "slices3_64x96": (dict(seed=203, qp=30, cbf_prob=0.5, modes=ALL_MODES,
                           tmvp=1, deblock=1, sao=1, max_level=1),
                      (64, 96), "IPBP"),
}

#: the random-word sets: (H, W, ctb_log2, strong_en, rand_tile_inputs
#: keywords)
RANDOM = [(64, 96, 4, False, {}), (48, 160, 4, False, {}),
          (96, 64, 5, True, {}), (64, 128, 5, False, {}),
          (32, 64, 3, False, {}), (48, 40, 3, False, {}),
          (128, 192, 6, True, {}), (64, 128, 6, False, {}),
          (64, 96, 4, False, dict(density=1.0, sl2_max=2)),
          (64, 96, 4, False, dict(modes=(1,), stray=1.0))]


def build():
    """The kernel (everything before the host launch code) + HARNESS,
    compiled with g++ into build/cuda_emu/; returns the library."""
    src = SOURCE.read_text()
    body = src[:src.index("// CTAs of a tile launch")]
    for pat, repl in PTX:
        body, n = re.subn(pat, repl, body, flags=re.S)
        if n != 1:
            raise RuntimeError(f"{pat}: {n} matches, want 1")
    BUILD.mkdir(parents=True, exist_ok=True)
    (BUILD / "emu_h265_tile.cpp").write_text(body + HARNESS)
    subprocess.run(["g++", "-std=c++20", "-O1", f"-I{HERE}", "-shared",
                    "-fPIC", "-o", str(BUILD / "libemu_h265_tile.so"),
                    str(BUILD / "emu_h265_tile.cpp"), "-lpthread"],
                   check=True)
    lib = ctypes.CDLL(str(BUILD / "libemu_h265_tile.so"))
    lib.emu_h265_tile.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
    return lib


class Checker:
    """The tile wavefront's plain version, with the emulated kernel run on
    copies of the same inputs and compared after it."""

    def __init__(self, lib):
        self.lib = lib
        self.ang = torch.from_numpy(TK._tile_table_np())
        self.calls = self.bad = 0

    def __call__(self, y, c, ry, rc, zl, zc, H, W, ctb_log2, strong_en):
        ky, kc = y.clone(), c.clone()
        rows, cols = H >> ctb_log2, W >> ctb_log2
        prog = torch.zeros(3 * rows + 1, dtype=torch.int32)
        args = [t.contiguous() for t in (ry, rc, zl, zc)]
        self.lib.emu_h265_tile(ky.data_ptr(), kc.data_ptr(),
                               *(t.data_ptr() for t in args),
                               self.ang.data_ptr(), prog.data_ptr(), H, W,
                               ctb_log2, int(bool(strong_en)))
        R._wavefront_tile_plain(y, c, ry, rc, zl, zc, H, W, ctb_log2,
                                strong_en)
        self.calls += 1
        err = max((ky - y).abs().max().item(), (kc - c).abs().max().item())
        done = prog[:3 * rows].tolist() == [cols] * (3 * rows)
        if err or not done:
            self.bad += 1
            print(f"  call {self.calls} ({W}x{H}, CTB {1 << ctb_log2}): "
                  f"max abs err {err}, progress {prog.tolist()}")
        return y, c


def main():
    check = Checker(build())
    bad = 0
    TK.tile_wavefront = check
    for name, (kw, size, pics) in STREAMS.items():
        gen = H265StreamGen(*size, **kw)
        if name.startswith("slices3"):
            gen.slices_per_pic = 3
        dec = H265Decoder()
        dec.set_data(gen.generate(pics))
        dec.decode_all(collect_plans=True, keep_oracle=True)
        n0 = check.calls
        outs = R.replay_plans(dec.plans, device="cpu", wf_mode="tile")
        wrong = sum(not np.array_equal(a, b) for p, planes in
                    zip(dec.plans, outs) for a, b in zip(planes, p.oracle))
        print(f"{name}: {check.calls - n0} pictures through the kernel, "
              f"{wrong} planes != oracle")
        bad += wrong
    for H, W, cl2, strong, kw in RANDOM:
        for seed in (1, 2):
            y, c, ry, rc, zl, zc = (torch.from_numpy(a) for a in
                                    rand_tile_inputs(H, W, cl2, seed, **kw))
            check(y, c, ry, rc, zl, zc, H, W, cl2, strong)
    print(f"random words: {check.calls} calls in all")
    bad += check.bad
    print(f"{bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
