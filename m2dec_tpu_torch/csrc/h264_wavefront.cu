// H.264 intra and deblocking wavefront kernels for Hopper (sm_90a).
//
// Four kernels, one per pass, replacing the four Pallas kernels of
// m2dec_tpu/codecs/h264/pallas_wavefront.py:
//   intra_luma_kernel     <- _intra_luma_kernel     (pallas_wavefront.py:125)
//   intra_chroma_kernel   <- _intra_chroma_kernel   (pallas_wavefront.py:157)
//   deblock_luma_kernel   <- _deblock_luma_kernel   (pallas_wavefront.py:201)
//   deblock_chroma_kernel <- _deblock_chroma_kernel (pallas_wavefront.py:237)
// They compute what the plain versions in codecs/h264/wavefront.py compute
// (the skewed XLA scans of the JAX package), bit for bit.
//
// Layout. The TPU kernels skew and transpose the planes so that Mosaic can
// slice 16-aligned slabs out of VMEM. A CUDA block addresses the RASTER
// plane directly: the kernels work in place on uint8 [H, W] planes (cb and
// cr separate), with per-MB metadata as int32 in raster MB order. Samples
// outside the picture read as 0 and are never written, which is what the
// skewed layout's zero margins and dead cells give the plain version.
//
// Dependencies. In the plain version's order, d = mbx + 2*mby, MB (mbx,
// mby) reads or writes only MBs on anti-diagonals d-1, d-2 and d-3 (left
// and top-right on d-1, top on d-2, top-left on d-3; deblock writes reach
// 3 px (luma) or 2 px (chroma) into the left and top MBs, and the
// top-right MB's left-edge filter writes columns that this MB's window
// reads).
//
// Streams. One launch runs a pass over S independent streams (pictures
// of one size): planes are contiguous [S, H, W] stacks (cb and cr [S, H/2,
// W/2]), per-MB metadata is [S * n, ...] in stream-major raster order, and
// the progress scratch is int32 [S * mb_h + 1]: progress[s * mb_h + y] for
// row y of stream s, then the ticket. for_stream() points a CTA at its
// stream's planes, metadata and flags; the rest of a kernel sees one
// stream. S = 1 is the single-picture case.
//
// Schedule (all four kernels): ONE launch per pass, one CTA per MB row at
// a time. A CTA takes rows by ticket (atomicAdd on progress[S * mb_h])
// until they run out: ticket t is row t / S of stream t % S, so the
// streams' rows interleave and row y - 1 of the same stream is ticket
// t - S. It walks its row left to right. Before MB x of row y reads or
// writes a pixel of the row above it waits (one lane spinning on an
// acquire load) until its stream's progress[y-1] reaches the count below;
// after its stores it publishes progress[y] (__syncwarp, then one lane's
// __threadfence and a strong store: a release). A CTA only waits on a row
// taken earlier (ticket t - S) by a CTA that is already running, so the
// scheme cannot deadlock whatever the residency; a spin that outlasts
// SPIN_LIMIT cycles traps, so a broken protocol ends the kernel with a
// CUDA error instead of hanging the card. An MB that touches no pixel
// (intra: kind 0 or 4; deblock: every edge of strength 0) only publishes,
// with no fence when the CTA stored nothing since its last one. The
// wrapper zeroes progress[0..S * mb_h] before each launch.
//
// What each kernel waits for:
// - intra luma, deblock luma: progress[y-1] >= min(x + 2, mb_w), i.e. the
//   top-right MB is done (progress counts MBs done). Intra luma reads the
//   top-right samples; deblock luma's top strip (rows y0-4..y0-1 of
//   columns x0..x0+15) is written by MB (x+1, y-1)'s left-edge filter.
// - deblock chroma: progress[y-1] >= x + 1, where progress counts TILES
//   STORED and a row stores tile x only once MB x + 1 has filtered (the
//   left-edge filter of MB x+1 writes tile x's columns 6..7). MB (x, y)
//   filters its top edge on rows y0-2..y0-1 of columns x0..x0+7, i.e.
//   tile x of row y-1, which MB (x, y-1) writes and MB (x+1, y-1)'s left
//   edge writes (column x0+7, reading x0+6). So "tile x of row y-1
//   stored" is exactly "MB (x+1, y-1) done" (or the row done, for the
//   last MB): the top-right rule of deblock luma, and what the plain
//   version's order d = x + 2y gives, since (x+1, y-1) lies on d-1. No
//   MB of row y-1 touches columns <= x0+7 after that store, and row y+1
//   writes into tile x of row y only after it is stored.
// - intra chroma: progress[y-1] >= x + 1 (MB x of the row above done).
//   Chroma intra prediction reads the corner (y0-1, x0-1), the 8 samples
//   above (y0-1, x0..x0+7) and the 8 to the left, and writes only its own
//   tile: no mode reads the top-right MB (the plain version's window is
//   [9, 9]: corner, top 8, left 8). The corner and the top belong to MBs
//   (x-1, y-1) and (x, y-1), done once progress[y-1] >= x + 1 (a row
//   publishes in order); the left is this CTA's previous MB. Nothing else
//   writes those samples, nor reads this tile before it is published
//   (MB (x, y+1) waits for x + 1, MB (x+1, y+1) for x + 2). The critical
//   path is then mb_w + mb_h - 1 MBs (187 at 1080p) instead of
//   mb_w + 2(mb_h - 1) (254).
//
// What bounds them: the chain of dependent small steps inside each MB
// times the critical path, plus mb_h - 1 handoffs between CTAs; not
// bytes. No row waits on another stream, so S streams share one stream's
// critical path (67 handoffs at 1080p, not 67 S) as long as the card holds
// the CTAs: S * mb_h rows run on min(S * mb_h, resident CTAs) CTAs, and
// past that the rows queue behind the tickets. The chain inside an MB is
// kept off global memory. Samples that another
// CTA wrote during this pass (the row above) are read through L2 (__ldcg:
// an L1 line cached earlier can hold stale bytes of a row another CTA
// wrote during this pass), after the acquire on the flag; an MB's own
// samples are staged ahead, since no other CTA writes them before it is
// done. Stores are 4-byte words. Sums (DC, plane) are warp shuffles.
// - Intra luma, deblock luma and deblock chroma use two warps per CTA.
//   The compute warp waits for the row above, reads the strip above
//   (intra luma: corner + 16 + 8 samples; deblock: 4 rows x 16 luma, 2
//   rows x 8 per chroma plane) and runs the MB's chain (16 sub-blocks of
//   I4x4, 4 of I8x8, 8 luma edges, or 2 chroma steps) in shared memory
//   and registers. The helper warp stages MB x + 2 (its metadata,
//   residual or edge parameters, and its own samples) into a free slot,
//   stores what MB x finished and publishes it, while the compute warp
//   runs MB x + 1; named barriers, one id per slot and direction, hand
//   the slots over. The left neighbour's columns come from the previous
//   MB's window; the tables (packed mode-index tables, alpha/beta/tc0)
//   sit in shared memory from CTA start. Deblock chroma keeps a ring of
//   four slots, since tile x - 1 is stored only after MB x has filtered.
//   A deblock-chroma step takes all 32 lanes: 2 planes x 8 lines x the
//   two edges of an axis, which touch disjoint samples. Handing the
//   stores, the fence and the publication to the helper warp took
//   deblock chroma from 0.421 to 0.317 ms a pass on a 1080p I picture
//   (NVIDIA H100 80GB HBM3, 700 W; tools/probe_chroma_helper_warp.py
//   keeps the one-warp design and times both).
// - Intra chroma uses one warp per CTA, both planes at once: one
//   prediction step per MB. The warp stages MB x + 1 into registers
//   while it runs MB x; each lane holds one 4-byte word of the MB's
//   samples (plane lane >> 4, row (lane >> 1) & 7, columns
//   4 * (lane & 1) + 0..3), the left column comes from the previous MB's
//   words by shuffle.
//
// Every entry point launches its kernel once and returns
// cudaGetLastError() (0 on success); nothing synchronises and nothing
// allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
// cycles a spin waits for the row above before it traps (about a
// second at the H100's clock; a pass takes milliseconds)
constexpr long long SPIN_LIMIT = 1LL << 31;

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int clip255(int v) { return clip3(v, 0, 255); }

// mode values outside 1..n-1 select mode 0 (the plain version's select)
__device__ __forceinline__ int sel_mode(int m, int n) {
  return (m >= 1 && m < n) ? m : 0;
}

__device__ __forceinline__ int dc_pred(int av1, int av2, int sl, int st,
                                       int both_r, int both_s, int one_r,
                                       int one_s) {
  if (av1 && av2) return (sl + st + both_r) >> both_s;
  if (av1) return (sl + one_r) >> one_s;
  if (av2) return (st + one_r) >> one_s;
  return 0x80;
}

// ---------------------------------------------------------------------
// the row schedule: tickets, progress flags, L2 pixel words
// ---------------------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// the next row for this CTA, for both its warps (row_s: shared)
__device__ __forceinline__ int take_row(int* ticket, int* row_s) {
  if (threadIdx.x == 32) *row_s = atomicAdd(ticket, 1);
  __syncthreads();
  const int row = *row_s;
  __syncthreads();
  return row;
}

// the named barriers between a row CTA's two warps (0 is
// __syncthreads): BAR_READY + slot, the helper warp has staged the
// slot's MB; BAR_DONE + slot, the compute warp is done with it. One
// warp arrives, the other waits; each slot has its own id, so that no
// barrier gets a second arrival before its wait
enum { BAR_READY = 1, BAR_DONE = 3 };

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;" :: "r"(id) : "memory");
}

// lane 0 spins until *flag >= need (seen: its last reading, kept across
// the row); then the warp may read what the row above published
__device__ __forceinline__ void wait_row(const int* flag, int need,
                                         int& seen, int lane) {
  if (lane == 0 && seen < need) {
    const long long t0 = clock64();
    while ((seen = ld_acquire(flag)) < need)
      if (clock64() - t0 > SPIN_LIMIT) __trap();
  }
  __syncwarp();
}

// after the warp's stores: *flag = v, visible after them device-wide.
// The fence then a strong store is PTX's release pattern (a st.release
// after the fence would fence twice)
__device__ __forceinline__ void publish(int* flag, int v, int lane) {
  __syncwarp();
  if (lane == 0) {
    __threadfence();
    st_relaxed(flag, v);
  }
}

// the next row for a one-warp CTA
__device__ __forceinline__ int take_row_warp(int* ticket, int lane) {
  int row = 0;
  if (lane == 0) row = atomicAdd(ticket, 1);
  return __shfl_sync(FULL, row, 0);
}

// publish, with the fence only when the warp stored samples since its
// last one (dirty, uniform across the warp): the store of the flag is
// ordered after every earlier fence all the same
__device__ __forceinline__ void publish_if(int* flag, int v, bool& dirty,
                                           int lane) {
  __syncwarp();
  if (lane == 0) {
    if (dirty) __threadfence();
    st_relaxed(flag, v);
  }
  dirty = false;
}

// 4 samples at (y, x) of a W-wide plane (x % 4 == 0) through L2, or 0
// where the word lies outside the picture
__device__ __forceinline__ unsigned ld_word(const uint8_t* p, int W, int H,
                                            int y, int x) {
  return (y >= 0 && y < H && x >= 0 && x < W)
             ? __ldcg(reinterpret_cast<const unsigned*>(p + (size_t)y * W +
                                                        x))
             : 0u;
}

// the word w, or the 4 samples s[0..3], at (y, x) of a W-wide plane
__device__ __forceinline__ void st_word_u(uint8_t* p, int W, int y, int x,
                                          unsigned w) {
  *reinterpret_cast<unsigned*>(p + (size_t)y * W + x) = w;
}

__device__ __forceinline__ void st_word(uint8_t* p, int W, int y, int x,
                                        const int* s) {
  st_word_u(p, W, y, x,
            (unsigned)s[0] | ((unsigned)s[1] << 8) | ((unsigned)s[2] << 16) |
                ((unsigned)s[3] << 24));
}

__device__ __forceinline__ void put_word(int* s, unsigned w) {
  s[0] = w & 255;
  s[1] = (w >> 8) & 255;
  s[2] = (w >> 16) & 255;
  s[3] = w >> 24;
}


// ---------------------------------------------------------------------
// intra luma: one MB row at a time, two warps per CTA
// ---------------------------------------------------------------------

struct IntraLumaArgs {
  uint8_t* y;
  const int *kind, *res_y, *i4_modes, *i4_avail, *i8_modes, *i8_avail,
      *i16_mode, *mb_avail, *tab4, *tab8;
  int* progress;  // [S * mb_h] rows done, then the row ticket (after
                  // for_stream: the stream's [mb_h])
  int mb_w, mb_h, has_i8, n_streams;
};

// stream s of a stacked launch: its plane, metadata and progress flags
__device__ __forceinline__ IntraLumaArgs for_stream(IntraLumaArgs a, int s) {
  const size_t n = (size_t)a.mb_w * a.mb_h * s;
  a.y += n * 256;
  a.kind += n;
  a.res_y += n * 256;
  a.i4_modes += n * 16;
  a.i4_avail += n * 16;
  a.i8_modes += n * 4;
  a.i8_avail += n * 4;
  a.i16_mode += n;
  a.mb_avail += n;
  a.progress += a.mb_h * s;
  return a;
}

// per-MB metadata slots: i4 modes, i4 avail, i8 modes, i8 avail, kind,
// i16 mode, mb avail
enum { M_I4M = 0, M_I4A = 16, M_I8M = 32, M_I8A = 36, M_KIND = 40,
       M_I16 = 41, M_AV = 42, M_N = 43 };


// what one lane loads of a staged MB: 3 of the 96 pixel words of its
// rows (the tile and the first 8 columns of the MB to its right, as the
// pass found them), 8 of its 256 residuals, 2 of its 43 metadata slots
struct IntraStage {
  unsigned px[3];
  int res[8], meta[2];
};

__device__ __forceinline__ void intra_stage(IntraStage& s,
                                            const IntraLumaArgs& a, int mbx,
                                            int mby, int lane) {
  const int W = a.mb_w * 16, H = a.mb_h * 16, mb = mby * a.mb_w + mbx;
  for (int j = 0; j < 3; ++j) {
    const int w = lane + 32 * j;
    s.px[j] = ld_word(a.y, W, H, mby * 16 + w / 6, mbx * 16 + 4 * (w % 6));
  }
  for (int j = 0; j < 8; ++j)
    s.res[j] = __ldg(a.res_y + mb * 256 + lane + 32 * j);
  // slot lane (i4 modes, i4 avail) and slot 32 + lane (the rest)
  s.meta[0] = __ldg(lane < 16 ? a.i4_modes + mb * 16 + lane
                              : a.i4_avail + mb * 16 + lane - 16);
  const int* rest = lane < 4   ? a.i8_modes + mb * 4 + lane
                    : lane < 8 ? a.i8_avail + mb * 4 + lane - 4
                    : lane == 8 ? a.kind + mb
                    : lane == 9 ? a.i16_mode + mb
                                : a.mb_avail + mb;
  s.meta[1] = lane + 32 < M_N ? __ldg(rest) : 0;
}

// line index (the plain version's line layout) held by each lane in the
// I4x4 step: 0..3 left, 5..8 top in lanes 4..7, corner in lane 8, 9..12
// top-right (DC mode, line 13, is computed apart)
__device__ __forceinline__ int i4_line_of_lane(int l) {
  return l < 4 ? l : l < 8 ? l + 1 : l == 8 ? 4 : l;
}
__device__ __forceinline__ int i4_lane_of_line(int i) {
  return i < 4 ? i : i == 4 ? 8 : i < 9 ? i - 1 : i;
}
// I8x8: 0..7 left, top run 0..7 (lines 9..16) in lanes 8..15, corner in
// lane 16, top run 8..15 in lanes 17..24, DC in lane 25
__device__ __forceinline__ int i8_line_of_lane(int l) {
  return l < 8 ? l : l < 16 ? l + 1 : l == 16 ? 8 : l;
}
__device__ __forceinline__ int i8_lane_of_line(int i) {
  return i < 8 ? i : i == 8 ? 16 : i < 17 ? i - 1 : i;
}

// the (IA, IB, IC, K3) index tables tab[4][9][P] of the plain version's
// _mk_tables4 / _mk_tables8 packed into one word per (mode, p): the
// lanes holding line[IA], line[IB], line[IC] and the K3 flag
__device__ __forceinline__ int pack_tab(const int* tab, int P, int o,
                                        bool i8) {
  const int ia = __ldg(tab + o), ib = __ldg(tab + 9 * P + o),
            ic = __ldg(tab + 18 * P + o);
  const int k3 = __ldg(tab + 27 * P + o) != 0;
  if (i8)
    return i8_lane_of_line(ia) | (i8_lane_of_line(ib) << 8) |
           (i8_lane_of_line(ic) << 16) | (k3 << 24);
  return i4_lane_of_line(ia) | (i4_lane_of_line(ib) << 8) |
         (i4_lane_of_line(ic) << 16) | (k3 << 24);
}

// fir3 (K3) or fir2 value of one predicted sample: line value v lives in
// the lanes of the packed word pk
__device__ __forceinline__ int eval_mode(int v, int pk) {
  const int la = __shfl_sync(FULL, v, pk & 255);
  const int lb = __shfl_sync(FULL, v, (pk >> 8) & 255);
  const int lc = __shfl_sync(FULL, v, (pk >> 16) & 255);
  if (pk >> 24) return (la + 2 * lb + lc + 2) >> 2;
  return (lb + lc + 1) >> 1;
}

// sum of v over aligned groups of n lanes (n a power of two <= 32)
__device__ __forceinline__ int group_sum(int v, int n) {
  for (int m = 1; m < n; m <<= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// the prediction plus residual of one intra MB (kind k: 1 I4x4, 2 I8x8,
// 3 I16x16) on window T, whose row 0 holds the row above
__device__ __forceinline__ void intra_mb(int k, int (*T)[25], const int* R,
                                         const int* M, const int* P4,
                                         const int* P8, int li4, int li8,
                                         int lane) {
  if (k == 1) {
    // Intra4x4: 16 sub-blocks in coding (z) order. Lane p < 16 is
    // pixel p of every sub-block; what a step needs besides the
    // window (mode word, residual, availability) is loaded first.
    const int p = lane & 15, pr = p >> 2, pc = p & 3;
    int pk[16], rs[16], avs[16], dcm[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int oy = ((b >> 1) & 1) * 4 + ((b >> 3) & 1) * 8;
      const int ox = (b & 1) * 4 + ((b >> 2) & 1) * 8;
      const int blk = (oy >> 2) * 4 + (ox >> 2);
      const int mode = sel_mode(M[M_I4M + blk], 9);
      pk[b] = P4[mode * 16 + p];
      rs[b] = R[(oy + pr) * 16 + ox + pc];
      avs[b] = M[M_I4A + blk];
      dcm[b] = mode == 2;
    }
    // the lane's line sample is T[oy + lr][ox + lc]: line [0..3]
    // left, [4] corner, [5..8] top, [9..12] top-right (or top[3]
    // repeated); lanes 9..12 pick their column by availability. In
    // DC mode every group of 8 lanes holds left 0..3 then top 0..3.
    const int t = li4;
    const int lr = t < 4 ? 1 + t : 0;
    const int lc = t < 5 ? 0 : t < 9 ? t - 4 : 4;
    const int lc4 = t < 9 ? lc : t - 4;
    const int* Tf = &T[0][0];
    const int line_off = lr * 25 + lc, line_off4 = lr * 25 + lc4;
    const int dc_off = (lane & 4) ? 1 + (lane & 3) : (1 + (lane & 3)) * 25;
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int oy = ((b >> 1) & 1) * 4 + ((b >> 3) & 1) * 8;
      const int ox = (b & 1) * 4 + ((b >> 2) & 1) * 8;
      const int av = avs[b];
      int pred;
      if (dcm[b]) {
        const int v = Tf[oy * 25 + ox + dc_off];
        int sl = (lane & 4) ? 0 : v, st = (lane & 4) ? v : 0;
#pragma unroll
        for (int m = 1; m < 8; m <<= 1) {
          sl += __shfl_xor_sync(FULL, sl, m);
          st += __shfl_xor_sync(FULL, st, m);
        }
        pred = dc_pred(av & 1, av & 2, sl, st, 4, 3, 2, 2);
      } else {
        const int v =
            Tf[oy * 25 + ox + ((av & 4) ? line_off4 : line_off)];
        pred = eval_mode(v, pk[b]);
      }
      if (lane < 16)
        T[1 + oy + pr][1 + ox + pc] = clip255(pred + rs[b]);
      __syncwarp();
    }
  } else if (k == 2) {
    // Intra8x8: 4 blocks with filtered reference samples; lane
    // holds pixels lane and lane + 32 of each, whose mode words and
    // residuals are loaded first
    int pk[4][2], rs[4][2], avs[4], dcm[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int oy = (b >> 1) * 8, ox = (b & 1) * 8;
      const int mode = sel_mode(M[M_I8M + b], 9);
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        pk[b][h] = P8[mode * 64 + p];
        rs[b][h] = R[(oy + (p >> 3)) * 16 + ox + (p & 7)];
      }
      avs[b] = M[M_I8A + b];
      dcm[b] = mode == 2;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int oy = (b >> 1) * 8, ox = (b & 1) * 8;
      const int av = avs[b];
      const int c = T[oy][ox];
      // line: [0..7] filtered left, [8] filtered corner, [9..24]
      // filtered top run, [25] DC
      const int t = li8;
      int v = 0;
      if (lane < 25) {
        if (t < 8) {
          const int i = t;
          const int li = T[1 + oy + i][ox];
          if (i < 7) {
            const int prev = i == 0 ? ((av & 8) ? c : T[1 + oy][ox])
                                    : T[oy + i][ox];
            v = (prev + 2 * li + T[2 + oy + i][ox] + 2) >> 2;
          } else {
            v = (T[oy + 7][ox] + 3 * li + 2) >> 2;
          }
        } else if (t == 8) {
          v = (T[1 + oy][ox] + 2 * c + T[oy][1 + ox] + 2) >> 2;
        } else {
          const int j = t - 9;  // 0..15 of the top run
          // full[i] = top (i < 8) then top-right (8..15)
          const int* row = &T[oy][1 + ox];
          if (j < 7) {
            const int prev = j == 0 ? ((av & 8) ? c : row[0])
                                    : row[j - 1];
            v = (prev + 2 * row[j] + row[j + 1] + 2) >> 2;
          } else if (av & 4) {
            v = (row[j - 1] + 2 * row[j] + row[min(j + 1, 15)] + 2) >>
                2;
          } else if (j == 7) {
            v = (row[6] + 3 * row[7] + 2) >> 2;
          } else {
            v = row[7];
          }
        }
      }
      if (dcm[b]) {
        const int sum = group_sum(lane < 16 ? v : 0, 8);
        const int sl = __shfl_sync(FULL, sum, 0);
        const int st = __shfl_sync(FULL, sum, 8);
        if (lane == 25) v = dc_pred(av & 1, av & 2, sl, st, 8, 4, 4, 3);
      }
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        const int pred = eval_mode(v, pk[b][h]);
        T[1 + oy + (p >> 3)][1 + ox + (p & 7)] = clip255(pred + rs[b][h]);
      }
      __syncwarp();
    }
  } else {
    // Intra16x16: vertical / horizontal / DC / plane
    const int mode = sel_mode(M[M_I16], 4);
    const int av = M[M_AV];
    const int c = T[0][0];
    // lanes 0..15 hold the left column, 16..31 the top row
    const int i = lane & 15;
    const int edge = lane < 16 ? T[1 + i][0] : T[0][1 + i];
    int dcs = 0, h = 0, vv = 0, pa = 0;
    if (mode == 2) {
      const int sum = group_sum(edge, 16);
      dcs = dc_pred(av & 1, av & 2, __shfl_sync(FULL, sum, 0),
                    __shfl_sync(FULL, sum, 16), 16, 5, 8, 4);
    } else if (mode == 3) {
      const int sum = group_sum(edge * (i - 7), 16);
      vv = -8 * c + __shfl_sync(FULL, sum, 0);
      h = -8 * c + __shfl_sync(FULL, sum, 16);
      h = (5 * h + 32) >> 6;
      vv = (5 * vv + 32) >> 6;
      pa = 16 * (T[16][0] + T[0][16]);
    }
    for (int q = 0; q < 8; ++q) {
      const int p = lane + 32 * q;
      const int r = p >> 4, cc = p & 15;
      int v;
      if (mode == 0) v = T[0][1 + cc];
      else if (mode == 1) v = T[1 + r][0];
      else if (mode == 2) v = dcs;
      else v = clip255((pa + (cc - 7) * h + (r - 7) * vv + 16) >> 5);
      T[1 + r][1 + cc] = clip255(v + R[p]);
    }
    __syncwarp();
  }
}

__device__ __forceinline__ void intra_commit(const IntraStage& s,
                                             int (*T)[25], int* R, int* M,
                                             int lane) {
  for (int j = 0; j < 3; ++j) {
    const int w = lane + 32 * j;
    put_word(&T[1 + w / 6][1 + 4 * (w % 6)], s.px[j]);
  }
  for (int j = 0; j < 8; ++j) R[lane + 32 * j] = s.res[j];
  M[lane] = s.meta[0];
  if (lane + 32 < M_N) M[lane + 32] = s.meta[1];
}

__global__ void __launch_bounds__(64)
intra_luma_kernel(const IntraLumaArgs sa) {
  const int lane = threadIdx.x & 31;
  const int W = sa.mb_w * 16, rows = sa.n_streams * sa.mb_h;
  // a window per slot (MB x in slot x & 1): row 0 = corner + top +
  // top-right, rows 1..16 = left + tile + the first 8 columns of the right
  // MB (the plain version's Ty)
  __shared__ int T[2][17][25];
  __shared__ int R[2][256];
  __shared__ int M[2][M_N];
  __shared__ int P4[9 * 16], P8[9 * 64];
  __shared__ int row_s;
  for (int o = threadIdx.x; o < 9 * 16; o += 64)
    P4[o] = pack_tab(sa.tab4, 16, o, 0);
  if (sa.has_i8)
    for (int o = threadIdx.x; o < 9 * 64; o += 64)
      P8[o] = pack_tab(sa.tab8, 64, o, 1);
  const int li4 = i4_line_of_lane(lane), li8 = i8_line_of_lane(lane);

  for (int t; (t = take_row(sa.progress + rows, &row_s)) < rows;) {
    const IntraLumaArgs a = for_stream(sa, t % sa.n_streams);
    const int mby = t / sa.n_streams, y0 = mby * 16;
    if (threadIdx.x >= 32) {
      // helper warp: stages MB x + 2 while MB x + 1 is computed, then
      // stores MB x and publishes it
      IntraStage s;
      for (int x = 0; x < min(2, a.mb_w); ++x) {
        intra_stage(s, a, x, mby, lane);
        intra_commit(s, T[x], R[x], M[x], lane);
        if (x == 0 && lane < 16) T[0][1 + lane][0] = 0;  // left of the picture
        __syncwarp();
        bar_arrive(BAR_READY + x);
      }
      for (int x = 0; x < a.mb_w; ++x) {
        const int sl = x & 1;
        if (x + 2 < a.mb_w) intra_stage(s, a, x + 2, mby, lane);
        bar_sync(BAR_DONE + sl);
        const int k = M[sl][M_KIND];
        if (k >= 1 && k <= 3)
          for (int j = 0; j < 2; ++j) {
            const int w = lane + 32 * j, r = w >> 2, c4 = w & 3;
            st_word(a.y, W, y0 + r, x * 16 + 4 * c4, &T[sl][1 + r][1 + 4 * c4]);
          }
        publish(a.progress + mby, x + 1, lane);
        if (x + 2 < a.mb_w) {
          intra_commit(s, T[sl], R[sl], M[sl], lane);
          __syncwarp();
          bar_arrive(BAR_READY + sl);
        }
      }
    } else {
      // compute warp: waits for the row above and predicts MB x
      int seen = 0;
      for (int x = 0; x < a.mb_w; ++x) {
        const int sl = x & 1, x0 = x * 16;
        bar_sync(BAR_READY + sl);
        int k = M[sl][M_KIND];
        if (k >= 1 && k <= 3) {  // inter / PCM MBs pass through
          if (k == 2 && !a.has_i8) k = 1;  // the plain version's has_i8 arm
          // row 0 from the row above, once its top-right MB is done
          if (mby > 0)
            wait_row(a.progress + mby - 1, min(x + 2, a.mb_w), seen, lane);
          if (lane == 0)
            T[sl][0][0] = (mby > 0 && x > 0)
                              ? __ldcg(a.y + (size_t)(y0 - 1) * W + x0 - 1)
                              : 0;
          else if (lane < 7)
            put_word(&T[sl][0][1 + 4 * (lane - 1)],
                     ld_word(a.y, W, a.mb_h * 16, y0 - 1,
                             x0 + 4 * (lane - 1)));
          __syncwarp();
          intra_mb(k, T[sl], R[sl], M[sl], P4, P8, li4, li8, lane);
        }
        // the next MB's left column: this MB's last column
        if (x + 1 < a.mb_w && lane < 16)
          T[sl ^ 1][1 + lane][0] = T[sl][1 + lane][16];
        __syncwarp();
        bar_arrive(BAR_DONE + sl);
      }
    }
  }
}

// ---------------------------------------------------------------------
// intra chroma: one MB row at a time, one warp per CTA
// ---------------------------------------------------------------------

struct IntraChromaArgs {
  uint8_t *cb, *cr;
  const int *kind, *res_c, *chroma_mode, *mb_avail;
  int* progress;  // [S * mb_h] rows done, then the row ticket
  int mb_w, mb_h, n_streams;
};

__device__ __forceinline__ IntraChromaArgs for_stream(IntraChromaArgs a,
                                                      int s) {
  const size_t n = (size_t)a.mb_w * a.mb_h * s;
  a.cb += n * 64;
  a.cr += n * 64;
  a.kind += n;
  a.res_c += n * 128;
  a.chroma_mode += n;
  a.mb_avail += n;
  a.progress += a.mb_h * s;
  return a;
}

// what one lane loads of a staged MB: its word of the MB's samples (as the
// pass found them), its 4 residuals, and the MB's kind, mode and
// availability
struct ChromaStage {
  unsigned px;
  int res[4], kind, mode, avail;
};

__device__ __forceinline__ void intra_chroma_stage(ChromaStage& s,
                                                   const IntraChromaArgs& a,
                                                   int mbx, int mby,
                                                   int lane) {
  const int W = a.mb_w * 8, H = a.mb_h * 8, mb = mby * a.mb_w + mbx;
  const int ci = lane >> 4, r = (lane >> 1) & 7, c0 = 4 * (lane & 1);
  s.px = ld_word(ci ? a.cr : a.cb, W, H, mby * 8 + r, mbx * 8 + c0);
  const int* res = a.res_c + mb * 128 + ci * 64 + r * 8 + c0;
  for (int j = 0; j < 4; ++j) s.res[j] = __ldg(res + j);
  s.kind = __ldg(a.kind + mb);
  s.mode = __ldg(a.chroma_mode + mb);
  s.avail = __ldg(a.mb_avail + mb);
}

__global__ void __launch_bounds__(32)
intra_chroma_kernel(const IntraChromaArgs sa) {
  const int lane = threadIdx.x & 31;
  const int W = sa.mb_w * 8, H = sa.mb_h * 8, rows = sa.n_streams * sa.mb_h;
  // lane: plane ci, its word (row r, columns c0..c0+3) and its edge
  // sample i of the plane's 16 (top 0..7, then left 0..7); g is the
  // plane's first lane
  const int ci = lane >> 4, i = lane & 15, g = lane & 16;
  const int r = (lane >> 1) & 7, c0 = 4 * (lane & 1);

  for (int t; (t = take_row_warp(sa.progress + rows, lane)) < rows;) {
    const IntraChromaArgs a = for_stream(sa, t % sa.n_streams);
    uint8_t* plane = ci ? a.cr : a.cb;
    const int mby = t / sa.n_streams, y0 = mby * 8;
    ChromaStage cur, nxt;
    intra_chroma_stage(cur, a, 0, mby, lane);
    unsigned prev = 0;  // the previous MB's word of this lane (0 at x = 0)
    int seen = 0;
    bool dirty = false;
    for (int x = 0; x < a.mb_w; ++x) {
      const int x0 = x * 8;
      if (x + 1 < a.mb_w) intra_chroma_stage(nxt, a, x + 1, mby, lane);
      unsigned out = cur.px;  // inter / PCM MBs pass through
      if (cur.kind >= 1 && cur.kind <= 3) {
        // left[j]: column 7 of the previous MB, byte 3 of its word (row j,
        // columns 4..7)
        const unsigned lw = __shfl_sync(FULL, prev, g + 2 * (i & 7) + 1);
        if (mby > 0) wait_row(a.progress + mby - 1, x + 1, seen, lane);
        // the row above: this lane's 4 columns, and the corner (byte 3 of
        // the word left of them); 0 outside the picture
        const unsigned vw = ld_word(plane, W, H, y0 - 1, x0 + c0);
        const int corner = ld_word(plane, W, H, y0 - 1, x0 - 4) >> 24;
        const unsigned tw = __shfl_sync(FULL, vw, g + ((i >> 2) & 1));
        const int e = i < 8 ? (tw >> (8 * (i & 3))) & 255 : lw >> 24;
        const int av1 = cur.avail & 1, av2 = cur.avail & 2;
        const int mode = sel_mode(cur.mode, 4);
        int pred[4];
        if (mode == 0) {
          // sums of top 0..3, top 4..7, left 0..3, left 4..7
          const int s4 = group_sum(e, 4);
          const int st0 = __shfl_sync(FULL, s4, g),
                    st4 = __shfl_sync(FULL, s4, g + 4),
                    sl0 = __shfl_sync(FULL, s4, g + 8),
                    sl4 = __shfl_sync(FULL, s4, g + 12);
          const int lower = r >= 4 ? 1 : 0, right = c0 >= 4 ? 1 : 0;
          int v;
          if (!lower && !right) {
            v = dc_pred(av1, av2, sl0, st0, 4, 3, 2, 2);
          } else if (!lower && right) {
            v = (av1 && av2) ? (st4 + 2) >> 2
                : av1        ? (sl0 + 2) >> 2
                : av2        ? (st4 + 2) >> 2
                             : 0x80;
          } else if (lower && !right) {
            v = (av1 && av2) ? (sl4 + 2) >> 2
                : av1        ? (sl4 + 2) >> 2
                : av2        ? (st0 + 2) >> 2
                             : 0x80;
          } else {
            v = dc_pred(av1, av2, sl4, st4, 4, 3, 2, 2);
          }
          for (int j = 0; j < 4; ++j) pred[j] = v;
        } else if (mode == 1) {
          const int v = __shfl_sync(FULL, e, g + 8 + r);
          for (int j = 0; j < 4; ++j) pred[j] = v;
        } else if (mode == 2) {
          for (int j = 0; j < 4; ++j) pred[j] = (vw >> (8 * j)) & 255;
        } else {
          // sum over i of top[i] * (i - 3) and of left[i] * (i - 3)
          const int ws = group_sum(e * ((i & 7) - 3), 8);
          int h = __shfl_sync(FULL, ws, g) - 4 * corner;
          int vv = __shfl_sync(FULL, ws, g + 8) - 4 * corner;
          h = (17 * h + 16) >> 5;
          vv = (17 * vv + 16) >> 5;
          const int pa = 16 * (__shfl_sync(FULL, e, g + 15) +
                               __shfl_sync(FULL, e, g + 7));
          for (int j = 0; j < 4; ++j)
            pred[j] =
                clip255((pa + (c0 + j - 3) * h + (r - 3) * vv + 16) >> 5);
        }
        out = 0;
        for (int j = 0; j < 4; ++j)
          out |= (unsigned)clip255(pred[j] + cur.res[j]) << (8 * j);
        st_word_u(plane, W, y0 + r, x0 + c0, out);
        dirty = true;
      }
      prev = out;
      publish_if(a.progress + mby, x + 1, dirty, lane);
      cur = nxt;
    }
  }
}

// ---------------------------------------------------------------------
// deblocking: per-edge parameters and the two line filters
// ---------------------------------------------------------------------

struct EdgeParams {
  int s, alpha, beta, tc0;
};

// _edge_params for line k of an edge: stbyte holds 2-bit strengths per
// group of (1 << shift) lines; str4 forces bS 4; a negative alpha index
// turns the edge off
__device__ __forceinline__ EdgeParams edge_params(
    int stbyte, int str4, const int* ab, int k, int shift,
    const int* alpha_t, const int* beta_t, const int* tc0_t) {
  EdgeParams e;
  int s = (stbyte >> (2 * (k >> shift))) & 3;
  if (str4 > 0) s = 4;
  const int aidx = ab[0];
  if (aidx < 0) s = 0;
  const int ai = clip3(aidx, -16, 35) + 16;
  const int bi = clip3(ab[1], -16, 35) + 16;
  e.s = s;
  e.alpha = alpha_t[ai];
  e.beta = beta_t[bi];
  e.tc0 = tc0_t[(s <= 1 ? 0 : s == 2 ? 1 : 2) * 52 + ai];
  return e;
}

// one luma line, 8 samples (q3 q2 q1 q0 | p0 p1 p2 p3) at v[i * st], in
// place
__device__ __forceinline__ void filter_line_luma(int* v, int st,
                                                 EdgeParams e) {
  const int q3 = v[0], q2 = v[st], q1 = v[2 * st], q0 = v[3 * st];
  const int p0 = v[4 * st], p1 = v[5 * st], p2 = v[6 * st], p3 = v[7 * st];
  const int alpha = e.alpha, beta = e.beta, tc0 = e.tc0, s = e.s;
  const bool m = abs(q1 - q0) < beta && abs(q0 - p0) < alpha &&
                 abs(p0 - p1) < beta && s > 0;
  if (!m) return;
  int nq2 = q2, nq1 = q1, nq0 = q0, np0 = p0, np1 = p1, np2 = p2;
  if (s == 4) {
    if (abs(q0 - p0) < ((alpha >> 2) + 2)) {
      const int tq = q0 + q1 + p0 + 2, tp = p0 + p1 + q0 + 2;
      if (abs(q0 - q2) < beta) {
        nq0 = (tq * 2 + p1 + q2) >> 3;
        nq1 = (tq + q2) >> 2;
        nq2 = (q3 * 2 + q2 * 3 + tq + 2) >> 3;
      } else {
        nq0 = (q1 * 2 + q0 + p1 + 2) >> 2;
      }
      if (abs(p0 - p2) < beta) {
        np0 = (tp * 2 + q1 + p2) >> 3;
        np1 = (tp + p2) >> 2;
        np2 = (p3 * 2 + p2 * 3 + tp + 2) >> 3;
      } else {
        np0 = (p1 * 2 + p0 + q1 + 2) >> 2;
      }
    } else {
      const int tw = q1 + p1 + 2;
      nq0 = (q1 + q0 + tw) >> 2;
      np0 = (p1 + p0 + tw) >> 2;
    }
  } else {
    const bool aq = abs(q2 - q0) < beta, ap = abs(p2 - p0) < beta;
    const int half = (p0 + q0 + 1) >> 1;
    if (tc0 > 0 && aq) nq1 = q1 + clip3((q2 + half - q1 * 2) >> 1, -tc0, tc0);
    if (tc0 > 0 && ap) np1 = p1 + clip3((p2 + half - p1 * 2) >> 1, -tc0, tc0);
    const int tc = tc0 + (aq ? 1 : 0) + (ap ? 1 : 0);
    if (tc > 0) {
      const int delta = clip3(((p0 - q0) * 4 + q1 - p1 + 4) >> 3, -tc, tc);
      nq0 = clip255(q0 + delta);
      np0 = clip255(p0 - delta);
    }
  }
  v[st] = clip255(nq2);
  v[2 * st] = clip255(nq1);
  v[3 * st] = clip255(nq0);
  v[4 * st] = clip255(np0);
  v[5 * st] = clip255(np1);
  v[6 * st] = clip255(np2);
}

// one chroma line, 4 samples (q1 q0 | p0 p1), in place
__device__ void filter_line_chroma(int* v[4], EdgeParams e) {
  const int q1 = *v[0], q0 = *v[1], p0 = *v[2], p1 = *v[3];
  const bool m = abs(q1 - q0) < e.beta && abs(q0 - p0) < e.alpha &&
                 abs(p0 - p1) < e.beta && e.s > 0;
  if (!m) return;
  int nq0, np0;
  if (e.s == 4) {
    const int t = q1 + p1 + 2;
    nq0 = (q1 + q0 + t) >> 2;
    np0 = (p1 + p0 + t) >> 2;
  } else {
    const int tc = e.tc0 + 1;
    const int delta = clip3(((p0 - q0) * 4 + q1 - p1 + 4) >> 3, -tc, tc);
    nq0 = q0 + delta;
    np0 = p0 - delta;
  }
  *v[1] = clip255(nq0);
  *v[2] = clip255(np0);
}

// ---------------------------------------------------------------------
// deblock luma: one MB row at a time, two warps per CTA
// ---------------------------------------------------------------------

struct DeblockLumaArgs {
  uint8_t* y;
  const int *deb_str, *deb_str4, *deb_ab, *alpha, *beta, *tc0;
  int* progress;  // [S * mb_h] rows done, then the row ticket
  int mb_w, mb_h, n_streams;
};

__device__ __forceinline__ DeblockLumaArgs for_stream(DeblockLumaArgs a,
                                                      int s) {
  const size_t n = (size_t)a.mb_w * a.mb_h * s;
  a.y += n * 256;
  a.deb_str += n * 8;
  a.deb_str4 += n * 2;
  a.deb_ab += n * 24;
  a.progress += a.mb_h * s;
  return a;
}

// per-MB metadata slots: deb_str [2][4], deb_str4 [2], deb_ab [2][6][2]
enum { D_STR = 0, D_STR4 = 8, D_AB = 10, D_N = 34 };

// what one lane loads of a staged MB: 2 of the 64 words of its own
// 16x16 samples (as the pass found them) and 2 of its 34 metadata slots
struct DeblockStage {
  unsigned px[2];
  int meta[2];
};

__device__ __forceinline__ void deblock_stage(DeblockStage& s,
                                              const DeblockLumaArgs& a,
                                              int mbx, int mby, int lane) {
  const int W = a.mb_w * 16, H = a.mb_h * 16, mb = mby * a.mb_w + mbx;
  for (int j = 0; j < 2; ++j) {
    const int w = lane + 32 * j;
    s.px[j] = ld_word(a.y, W, H, mby * 16 + (w >> 2), mbx * 16 + 4 * (w & 3));
  }
  // slot lane (deb_str, deb_str4, deb_ab[0..21]) and slot 32 + lane
  s.meta[0] = __ldg(lane < D_STR4 ? a.deb_str + mb * 8 + lane
                    : lane < D_AB ? a.deb_str4 + mb * 2 + lane - D_STR4
                                  : a.deb_ab + mb * 24 + lane - D_AB);
  s.meta[1] = lane + 32 < D_N ? __ldg(a.deb_ab + mb * 24 + lane + 32 - D_AB)
                              : 0;
}

// the staged MB into a slot: its own samples, metadata and the 8 edges'
// parameters (lane = (axis, line), 4 edges each); *act: some edge filters
__device__ __forceinline__ void deblock_commit(
    const DeblockStage& s, int (*Wy)[21], int* D, EdgeParams (*EP)[16],
    int* act, const int* sA, const int* sB, const int* sT, int lane) {
  for (int j = 0; j < 2; ++j) {
    const int w = lane + 32 * j;
    put_word(&Wy[4 + (w >> 2)][4 + 4 * (w & 3)], s.px[j]);
  }
  D[lane] = s.meta[0];
  if (lane + 32 < D_N) D[lane + 32] = s.meta[1];
  __syncwarp();
  const int axis = lane >> 4, line = lane & 15;
  bool on = false;
  for (int e = 0; e < 4; ++e) {
    const EdgeParams p = edge_params(
        D[D_STR + axis * 4 + e], e == 0 ? D[D_STR4 + axis] : 0,
        D + D_AB + axis * 12 + (e == 0 ? 0 : 6), line, 2, sA, sB, sT);
    EP[axis * 4 + e][line] = p;
    on |= p.s > 0;
  }
  on = __any_sync(FULL, on);
  if (lane == 0) *act = on;
  __syncwarp();
}

__global__ void __launch_bounds__(64)
deblock_luma_kernel(const DeblockLumaArgs sa) {
  const int lane = threadIdx.x & 31;
  const int W = sa.mb_w * 16, rows = sa.n_streams * sa.mb_h;
  // a window per slot (MB x in slot x & 1), (r, c) <-> pixel (y0 - 4 + r,
  // x0 - 4 + c): rows 0..3 the top MB's last rows, columns 0..3 the left
  // MB's last columns (the corner r, c < 4 is never read); rows padded
  // to 21 against bank conflicts
  __shared__ int Wy[2][20][21];
  __shared__ int D[2][D_N];
  __shared__ EdgeParams EP[2][8][16];  // [slot][axis * 4 + edge][line]
  __shared__ int act[2];
  __shared__ int sA[52], sB[52], sT[3 * 52];
  __shared__ int row_s;
  for (int i = threadIdx.x; i < 52; i += 64) {
    sA[i] = __ldg(sa.alpha + i);
    sB[i] = __ldg(sa.beta + i);
  }
  for (int i = threadIdx.x; i < 3 * 52; i += 64) sT[i] = __ldg(sa.tc0 + i);

  for (int t; (t = take_row(sa.progress + rows, &row_s)) < rows;) {
    const DeblockLumaArgs a = for_stream(sa, t % sa.n_streams);
    const int mby = t / sa.n_streams, y0 = mby * 16;
    if (threadIdx.x >= 32) {
      // helper warp: stages MB x + 2 while MB x + 1 is filtered, then
      // stores MB x and publishes it
      DeblockStage s;
      for (int x = 0; x < min(2, a.mb_w); ++x) {
        deblock_stage(s, a, x, mby, lane);
        if (x == 0 && lane < 16)  // left of the picture
          for (int c = 0; c < 4; ++c) Wy[0][4 + lane][c] = 0;
        deblock_commit(s, Wy[x], D[x], EP[x], &act[x], sA, sB, sT, lane);
        bar_arrive(BAR_READY + x);
      }
      for (int x = 0; x < a.mb_w; ++x) {
        const int sl = x & 1, x0 = x * 16;
        if (x + 2 < a.mb_w) deblock_stage(s, a, x + 2, mby, lane);
        bar_sync(BAR_DONE + sl);
        // store rows 1..3 of the top strip and rows 4..19 with the left
        // strip (row 0 and column 0 are never filtered; nothing left of
        // or above the picture is written)
        if (act[sl])
          for (int j = 0; j < 3; ++j) {
            const int w = lane + 32 * j;
            int r, wc;
            if (w < 12) {
              r = 1 + w / 4;
              wc = 1 + w % 4;
            } else {
              r = 4 + (w - 12) / 5;
              wc = (w - 12) % 5;
            }
            if (w < 92 && y0 - 4 + r >= 0 && x0 - 4 + 4 * wc >= 0)
              st_word(a.y, W, y0 - 4 + r, x0 - 4 + 4 * wc, &Wy[sl][r][4 * wc]);
          }
        publish(a.progress + mby, x + 1, lane);
        if (x + 2 < a.mb_w) {
          deblock_commit(s, Wy[sl], D[sl], EP[sl], &act[sl], sA, sB, sT, lane);
          bar_arrive(BAR_READY + sl);
        }
      }
    } else {
      // compute warp: waits for the row above and filters MB x
      int seen = 0;
      bar_sync(BAR_READY + 0);
      for (int x = 0; x < a.mb_w; ++x) {
        const int sl = x & 1, x0 = x * 16;
        if (act[sl]) {  // else no sample changes: skip
          // the top strip from the row above, once its top-right MB is done
          if (mby > 0)
            wait_row(a.progress + mby - 1, min(x + 2, a.mb_w), seen, lane);
          if (lane < 16)
            put_word(&Wy[sl][lane >> 2][4 + 4 * (lane & 3)],
                     ld_word(a.y, W, a.mb_h * 16, y0 - 4 + (lane >> 2),
                             x0 + 4 * (lane & 3)));
          __syncwarp();
          // the four vertical edges, then the four horizontal ones: lane
          // < 16 takes line 4 + lane (a window row, then a window column)
          // through an axis's edges in registers
          for (int axis = 0; axis < 2; ++axis) {
            if (lane < 16) {
              int* w = axis == 0 ? &Wy[sl][4 + lane][0] : &Wy[sl][0][4 + lane];
              const int st = axis == 0 ? 1 : 21;
              int px[20];
#pragma unroll
              for (int i = 0; i < 20; ++i) px[i] = w[i * st];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                filter_line_luma(px + 4 * e, 1, EP[sl][axis * 4 + e][lane]);
#pragma unroll
              for (int i = 1; i < 20; ++i) w[i * st] = px[i];
            }
            __syncwarp();
          }
        }
        if (x + 1 < a.mb_w) {
          // the next MB's left strip: this MB's last four columns, once
          // the helper has stored the slot's previous MB
          bar_sync(BAR_READY + (sl ^ 1));
          if (lane < 16)
            for (int c = 0; c < 4; ++c)
              Wy[sl ^ 1][4 + lane][c] = Wy[sl][4 + lane][16 + c];
          __syncwarp();
        }
        bar_arrive(BAR_DONE + sl);
      }
    }
  }
}

// ---------------------------------------------------------------------
// deblock chroma: one MB row at a time, two warps per CTA
// ---------------------------------------------------------------------

struct DeblockChromaArgs {
  uint8_t *cb, *cr;
  const int *deb_str, *deb_str4, *deb_ab, *alpha, *beta, *tc0;
  int* progress;  // [S * mb_h] tiles stored per row, then the row ticket
  int mb_w, mb_h, n_streams;
};

__device__ __forceinline__ DeblockChromaArgs for_stream(DeblockChromaArgs a,
                                                        int s) {
  const size_t n = (size_t)a.mb_w * a.mb_h * s;
  a.cb += n * 64;
  a.cr += n * 64;
  a.deb_str += n * 8;
  a.deb_str4 += n * 2;
  a.deb_ab += n * 24;
  a.progress += a.mb_h * s;
  return a;
}

// what one lane loads of a staged MB: its word of the MB's samples (as the
// pass found them) and, per axis, what edge_params takes for its edge
// (2 * ((lane >> 3) & 1)) and plane (lane >> 4): the strength byte, the
// bS-4 flag and the alpha/beta index pair
struct DebChromaStage {
  unsigned px;
  int str[2], str4[2], ab[2][2];
};

__device__ __forceinline__ void deblock_chroma_stage(
    DebChromaStage& s, const DeblockChromaArgs& a, int mbx, int mby,
    int lane) {
  const int W = a.mb_w * 8, H = a.mb_h * 8, mb = mby * a.mb_w + mbx;
  const int ci = lane >> 4, e = 2 * ((lane >> 3) & 1);
  s.px = ld_word(ci ? a.cr : a.cb, W, H, mby * 8 + ((lane >> 1) & 7),
                 mbx * 8 + 4 * (lane & 1));
  const int abrow = (e == 0 ? 1 : 4) + ci;
  for (int axis = 0; axis < 2; ++axis) {
    s.str[axis] = __ldg(a.deb_str + mb * 8 + axis * 4 + e);
    s.str4[axis] = e == 0 ? __ldg(a.deb_str4 + mb * 2 + axis) : 0;
    for (int j = 0; j < 2; ++j)
      s.ab[axis][j] = __ldg(a.deb_ab + mb * 24 + axis * 12 + 2 * abrow + j);
  }
}

// the named barriers of a deblock-chroma CTA: CB_READY + slot, the helper
// warp has staged the slot's MB; CB_DONE + slot, the compute warp is done
// with it (slots 0..3: one id per slot and direction, as in the luma
// kernels)
enum { CB_READY = 1, CB_DONE = 5 };

// the staged MB into a slot: its tile, the edge parameters of each lane
// and axis, and whether any edge filters
__device__ __forceinline__ void deb_chroma_commit(
    const DebChromaStage& s, int (*Wp)[10][11], EdgeParams (*EP)[32],
    int* act, const int* sA, const int* sB, const int* sT, int lane) {
  const int ci = lane >> 4, k = lane & 7;
  const int tr = (lane >> 1) & 7, th = lane & 1;
  put_word(&Wp[ci][2 + tr][2 + 4 * th], s.px);
  bool on = false;
  for (int axis = 0; axis < 2; ++axis) {
    const EdgeParams p = edge_params(s.str[axis], s.str4[axis], s.ab[axis],
                                     k, 1, sA, sB, sT);
    EP[axis][lane] = p;
    on |= p.s > 0;
  }
  on = __any_sync(FULL, on);
  if (lane == 0) *act = on;
  __syncwarp();
}

__global__ void __launch_bounds__(64)
deblock_chroma_kernel(const DeblockChromaArgs sa) {
  const int lane = threadIdx.x & 31;
  const int W = sa.mb_w * 8, rows = sa.n_streams * sa.mb_h;
  // a window per slot (MB x in slot x & 3) and plane, (r, c) <-> pixel
  // (y0 - 2 + r, x0 - 2 + c): rows 0..1 the top MB's last rows, columns
  // 0..1 the left MB's last columns (the corner r, c < 2 is never read),
  // rows 2..9 x columns 2..9 the MB's own tile; rows padded to 11
  __shared__ int Wc[4][2][10][11];
  __shared__ EdgeParams EP[4][2][32];  // [slot][axis][lane]
  __shared__ int act[4];               // [slot]: some edge filters
  __shared__ int sA[52], sB[52], sT[3 * 52];
  __shared__ int row_s;
  for (int i = threadIdx.x; i < 52; i += 64) {
    sA[i] = __ldg(sa.alpha + i);
    sB[i] = __ldg(sa.beta + i);
  }
  for (int i = threadIdx.x; i < 3 * 52; i += 64) sT[i] = __ldg(sa.tc0 + i);
  // lane: plane ci; its filter line k of edge 2 * e2 on each axis; its
  // word of the tile (row tr, columns 4 * th..4 * th + 3)
  const int ci = lane >> 4, e2 = (lane >> 3) & 1, k = lane & 7;
  const int tr = (lane >> 1) & 7, th = lane & 1;

  for (int t; (t = take_row(sa.progress + rows, &row_s)) < rows;) {
    const DeblockChromaArgs a = for_stream(sa, t % sa.n_streams);
    uint8_t* plane = ci ? a.cr : a.cb;
    const int mby = t / sa.n_streams, y0 = mby * 8;
    if (threadIdx.x >= 32) {
      // helper warp: stages MB x + 2 while MB x + 1 is filtered; once MB x
      // is, stores tile x - 1 (final now: MB x has filtered its columns
      // 6..7) if either MB filtered, and MB x's top strip if it filtered
      // (nothing above the picture is written), then publishes x tiles
      DebChromaStage s;
      for (int x = 0; x < min(2, a.mb_w); ++x) {
        deblock_chroma_stage(s, a, x, mby, lane);
        deb_chroma_commit(s, Wc[x], EP[x], &act[x], sA, sB, sT, lane);
        bar_arrive(CB_READY + x);
      }
      bool dirty = false;
      for (int x = 0; x < a.mb_w; ++x) {
        const int sl = x & 3, x0 = x * 8;
        if (x + 2 < a.mb_w) deblock_chroma_stage(s, a, x + 2, mby, lane);
        bar_sync(CB_DONE + sl);
        const bool on = act[sl], prev_on = x > 0 && act[(x - 1) & 3];
        if (x > 0 && (on || prev_on)) {
          st_word(plane, W, y0 + tr, x0 - 8 + 4 * th,
                  &Wc[(x - 1) & 3][ci][2 + tr][2 + 4 * th]);
          dirty = true;
        }
        if (on && mby > 0) {
          if (lane < 8) {
            const int p = lane >> 2, rr = (lane >> 1) & 1;
            st_word(p ? a.cr : a.cb, W, y0 - 2 + rr, x0 + 4 * th,
                    &Wc[sl][p][rr][2 + 4 * th]);
          }
          dirty = true;
        }
        if (x > 0) publish_if(a.progress + mby, x, dirty, lane);
        if (x + 2 < a.mb_w) {
          const int s2 = (x + 2) & 3;
          deb_chroma_commit(s, Wc[s2], EP[s2], &act[s2], sA, sB, sT, lane);
          bar_arrive(CB_READY + s2);
        }
      }
      if (act[(a.mb_w - 1) & 3]) {
        st_word(plane, W, y0 + tr, (a.mb_w - 1) * 8 + 4 * th,
                &Wc[(a.mb_w - 1) & 3][ci][2 + tr][2 + 4 * th]);
        dirty = true;
      }
      publish_if(a.progress + mby, a.mb_w, dirty, lane);
    } else {
      // compute warp: the left columns from the previous slot (0 left of
      // the picture); if some edge filters, the top strip once tile x of
      // the row above is stored, then the vertical edges and the
      // horizontal ones (lane: line k of edge 2 * e2 of its plane, a
      // window row, then a window column; the two edges of an axis touch
      // disjoint samples); then tile x - 1's columns 6..7 back into its
      // slot for the helper's store
      int seen = 0;
      for (int x = 0; x < a.mb_w; ++x) {
        const int sl = x & 3, x0 = x * 8;
        bar_sync(CB_READY + sl);
        int(*w)[11] = Wc[sl][ci];
        w[2 + tr][th] = x > 0 ? Wc[(x - 1) & 3][ci][2 + tr][8 + th] : 0;
        if (act[sl]) {
          if (mby > 0) wait_row(a.progress + mby - 1, x + 1, seen, lane);
          if (lane < 8) {
            const int p = lane >> 2, rr = (lane >> 1) & 1;
            put_word(&Wc[sl][p][rr][2 + 4 * th],
                     ld_word(p ? a.cr : a.cb, W, a.mb_h * 8, y0 - 2 + rr,
                             x0 + 4 * th));
          }
          __syncwarp();
          for (int axis = 0; axis < 2; ++axis) {
            int* v[4];
            for (int j = 0; j < 4; ++j)
              v[j] = axis == 0 ? &w[2 + k][4 * e2 + j]
                               : &w[4 * e2 + j][2 + k];
            filter_line_chroma(v, EP[sl][axis][lane]);
            __syncwarp();
          }
        }
        if (x > 0) Wc[(x - 1) & 3][ci][2 + tr][8 + th] = w[2 + tr][th];
        __syncwarp();
        bar_arrive(CB_DONE + sl);
      }
    }
  }
}

// CTAs of a row-schedule launch: one per MB row of all the streams, at
// most as many as can be resident (the ticket lets fewer CTAs take all the
// rows)
template <typename K>
cudaError_t row_grid(K kernel, int threads, int rows, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  if (err == cudaSuccess && sms * per_sm < 1)
    err = cudaErrorInvalidConfiguration;
  *grid = rows < sms * per_sm ? rows : sms * per_sm;
  return err;
}

}  // namespace

extern "C" {

// planes [S, ...], metadata [S * mb_w * mb_h, ...]; progress: int32
// [S * mb_h + 1], zero (the wrapper's scratch)
int h264_intra_luma(void* y, const void* kind, const void* res_y,
                    const void* i4_modes, const void* i4_avail,
                    const void* i8_modes, const void* i8_avail,
                    const void* i16_mode, const void* mb_avail,
                    const void* tab4, const void* tab8, void* progress,
                    int has_i8, int mb_w, int mb_h, int n_streams,
                    void* stream) {
  const IntraLumaArgs a = {
      (uint8_t*)y, (const int*)kind, (const int*)res_y,
      (const int*)i4_modes, (const int*)i4_avail, (const int*)i8_modes,
      (const int*)i8_avail, (const int*)i16_mode, (const int*)mb_avail,
      (const int*)tab4, (const int*)tab8, (int*)progress, mb_w, mb_h,
      has_i8, n_streams};
  int grid = 0;
  const cudaError_t err =
      row_grid(intra_luma_kernel, 64, n_streams * mb_h, &grid);
  if (err != cudaSuccess) return (int)err;
  intra_luma_kernel<<<grid, 64, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// planes [S, ...], metadata [S * mb_w * mb_h, ...]; progress: int32
// [S * mb_h + 1], zero (the wrapper's scratch)
int h264_intra_chroma(void* cb, void* cr, const void* kind,
                      const void* res_c, const void* chroma_mode,
                      const void* mb_avail, void* progress, int mb_w,
                      int mb_h, int n_streams, void* stream) {
  const IntraChromaArgs a = {
      (uint8_t*)cb, (uint8_t*)cr, (const int*)kind, (const int*)res_c,
      (const int*)chroma_mode, (const int*)mb_avail, (int*)progress, mb_w,
      mb_h, n_streams};
  int grid = 0;
  const cudaError_t err =
      row_grid(intra_chroma_kernel, 32, n_streams * mb_h, &grid);
  if (err != cudaSuccess) return (int)err;
  intra_chroma_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// planes [S, ...], metadata [S * mb_w * mb_h, ...]; progress: int32
// [S * mb_h + 1], zero (the wrapper's scratch)
int h264_deblock_luma(void* y, const void* deb_str, const void* deb_str4,
                      const void* deb_ab, const void* alpha,
                      const void* beta, const void* tc0, void* progress,
                      int mb_w, int mb_h, int n_streams, void* stream) {
  const DeblockLumaArgs a = {
      (uint8_t*)y, (const int*)deb_str, (const int*)deb_str4,
      (const int*)deb_ab, (const int*)alpha, (const int*)beta,
      (const int*)tc0, (int*)progress, mb_w, mb_h, n_streams};
  int grid = 0;
  const cudaError_t err =
      row_grid(deblock_luma_kernel, 64, n_streams * mb_h, &grid);
  if (err != cudaSuccess) return (int)err;
  deblock_luma_kernel<<<grid, 64, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// planes [S, ...], metadata [S * mb_w * mb_h, ...]; progress: int32
// [S * mb_h + 1], zero (the wrapper's scratch)
int h264_deblock_chroma(void* cb, void* cr, const void* deb_str,
                        const void* deb_str4, const void* deb_ab,
                        const void* alpha, const void* beta, const void* tc0,
                        void* progress, int mb_w, int mb_h, int n_streams,
                        void* stream) {
  const DeblockChromaArgs a = {
      (uint8_t*)cb, (uint8_t*)cr, (const int*)deb_str,
      (const int*)deb_str4, (const int*)deb_ab, (const int*)alpha,
      (const int*)beta, (const int*)tc0, (int*)progress, mb_w, mb_h,
      n_streams};
  int grid = 0;
  const cudaError_t err =
      row_grid(deblock_chroma_kernel, 64, n_streams * mb_h, &grid);
  if (err != cudaSuccess) return (int)err;
  deblock_chroma_kernel<<<grid, 64, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
