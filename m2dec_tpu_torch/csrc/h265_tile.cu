// H.265 intra reconstruction on the CTU-tile schedule, for Hopper (sm_90a).
//
// Replaces _wavefront_tile (m2dec_tpu/codecs/h265/reconstruct.py:1591), an
// XLA lax.scan over CTU anti-diagonals with the CTU's z-order unrolled;
// it is not a Pallas kernel. It computes what the plain version
// _wavefront_tile_plain (m2dec_tpu_torch/codecs/h265/reconstruct.py)
// computes, bit for bit: every intra op of the picture, luma, cb and cr,
// evaluated with _intra_core's integer arithmetic, its residual added,
// clipped and written in place.
//
// Layout. The planes are the padded int32 planes of _LevelRunner: luma
// [H + 33, W + 33], and cb over cr in one [2 * CR0, W/2 + 17] plane (CR0 =
// H/2 + 17, cr's first row); residuals in the same shapes. Ops come as
// packed z-slot words per CTU (_ctu_zslots): zl [n_ctu, SL] and zc [n_ctu,
// SC], word j = the op whose top-left 4x4 cell is z-cell j of the CTU (0:
// none), fields used(2) | sl2 - 2 (2) | mode(6) | vx(7) | vy(7). One
// chroma word serves cb and cr. The slot's (oy, ox, Smax) is derived from
// j as _zslot_table does. A word's op size must not exceed its slot's
// Smax: the decoder (_ctu_zslots) and rand_tile_inputs make no other. A
// larger one is outside the contract: the kernel cuts it to the slot,
// while the plain version predicts at the word's size, so the two differ.
//
// What bounds it: the chain of dependent ops, not bytes. A band's CTUs
// run one after another and a CTU's ops one after another, and a CTU
// waits for CTU cx + 1 of the band above. On the I picture of bench.py's
// 1080p H.265 stream (CTB 16) the longest chain through that dependency
// holds 1,874 luma ops (842 chroma) across 254 CTU steps, while the
// picture's bytes take about 0.01 ms and its dependency floor (67
// handoffs between CTAs) 0.047 ms. One warp runs a chain: its time is
// the latency of each op's dependent instructions and memory reads, and
// of each CTU step's L2 round trips. This kernel's first version (one CTA
// of 256 threads per band, two L2 round trips and two CTA barriers per
// op) took 5.44 ms on that picture and 2.28 ms on picture 1 (P, 620 luma
// ops on its chain), about 2.5 us per op on the chain. The design
// shortens each op and each CTU step:
//
// 1. The band's own samples live in shared memory, in a window of C + 1
//    rows (the line above the band, then the band's C rows) by K CTUs
//    of columns, each sample at its column modulo K C (K = 8, or 4 at
//    CTB 64): CTU cx - 1 (its last column is CTU cx's left neighbour),
//    the CTU being built, CTU cx + 1 (top lines reach into it) and the
//    CTUs fetched ahead. An op reads its neighbour lines from there, one
//    shared load per sample and no branch. The only L2 round trips of a
//    CTU are the line above (2C + 1 samples: CTUs cx and cx + 1 of the
//    band above and the corner) with the CTU's first row, read once after
//    the acquire on the flag (__ldcg: an L1 line cached earlier can hold
//    stale bytes of a sample another CTA wrote during the launch), and
//    the finished CTU written to the plane before its progress is
//    published (the band below and Phase B's later stages read it
//    there).
// 2. What no CTA writes during the launch is fetched ahead with cp.async
//    (4-byte copies from the padded planes: their rows are not 16-byte
//    aligned, so TMA and cp.async.bulk do not apply, and copying the
//    residuals into a CTU-major layout first would cost a launch and 13
//    MB of traffic per picture): the op words, the residual block and
//    the samples of CTUs cx + 2 .. cx + K - 2 are in flight while CTU cx
//    computes. Rows 1..C-1 of a CTU are written by no other CTA; its
//    first row, where the band above's stray pixels land, is read again
//    after the acquire (generic loads, not the async proxy).
// 3. Two warps per (plane, band), so that the ops' chain carries nothing
//    else. Warp 0 runs the ops, synchronised by __syncwarp only: an op
//    reads its two neighbour lines (2 size + 4 samples each), builds its
//    reference once into shared memory (the angular projection's 2 size
//    entries with the filter or strong smoothing applied, or the planar
//    edges, and the DC sums by one warp reduction; DC, horizontal and
//    vertical ops read the raw lines only), then each lane predicts,
//    adds the residual, clips and stores its samples, each reading two
//    reference entries; the angular table lives in shared memory (26 KB,
//    packed by the wrapper), and the CTA counts each CTU's ops when it
//    takes a band. Warp 1 moves the data: it issues the prefetches,
//    lists the next CTU's ops with their slot's offset and size, acquires
//    the band above and reads the line above for CTU cx + 1 while warp 0
//    runs CTU cx (when the band above is far enough ahead), then writes
//    CTU cx back and publishes it while warp 0 runs CTU cx + 1. The
//    warps hand over per CTU through two named barriers (inputs ready,
//    ops done).
// 4. A CTU with no op costs a store: warp 0 skips it, warp 1 fetches
//    nothing for it (its samples only when a neighbour has an op) and
//    publishes it without waiting for the band above, since it writes
//    nothing and is final already. A CTU publishes with one release: a
//    fence (if it wrote) and a strong store by lane 0 of warp 1.
// 5. The flag of the band above is polled with relaxed loads and
//    acquired with one fence once it is far enough.
//
// Correctness. The wait rule: before CTU cx of band cy with an op is
// handed to warp 0, lane 0 of warp 1 has seen progress[plane][cy - 1] >=
// min(cx + 2, cols) and acquired it, i.e. CTUs cx and cx + 1 of the
// band above done: the plain version's order d = cx + 2 * cy, since an
// op's valid neighbour reads reach at most 2C - 1 samples right of the
// CTU origin and never below the CTU row. Reads past an op's valid
// counts vx and vy are clamped to the plane as _intra_op_delta clamps
// them and never used; in the window such a read (below the band, or
// right of CTU cx + 1) lands on another entry. A spin that outlasts
// SPIN_LIMIT cycles traps, so a broken protocol ends the kernel with a
// CUDA error instead of hanging the card. Deadlock: a CTA takes a
// (plane, band) by ticket (atomicAdd on progress[3 * rows]): ticket t is
// CTU row t / 3 of plane t % 3, so the band above is ticket t - 3, taken
// earlier by a CTA that is running; whatever the residency, the band
// that holds the lowest open ticket waits on nobody, and inside a CTA
// warp 1 publishes CTU cx before it waits on the band above for CTU cx +
// 1. The wrapper zeroes progress[0..3 * rows] before each launch.
//
// The DC stray pixel: a luma DC op with used bit 1 writes dc1v at (y0 +
// size, x0), one row below its block. Inside the band it goes into the
// window (a later op of the CTU may overwrite it, as in the plain
// version); on the band below's first row it goes straight to the plane,
// before the ops-done barrier that precedes this CTU's publish. The band
// below reads its CTU cx's first row from the plane after its acquire saw
// CTU cx + 1 here done, so it sees the write, and writes that row back
// with its CTU. The stray pixel lands at a column x0 = 0 mod 4, and never
// on a neighbour line (columns x0 - 1 and rows y0 - 1 are 3 mod 4): no
// read of an op depends on it, and no other sample of the first row (the
// left neighbour column included) is written by another CTA.
//
// Measured (tools/probe_h265_tile_split.py, CUDA events, median of 20,
// two runs; NVIDIA H100 80GB HBM3, 700 W): 2.02-2.07 ms on picture 0 and
// 0.94-0.96 ms on picture 1, 1.08-1.10 and 1.52-1.55 us per luma op on
// the chain. Per op on its chain on one band: 0.55-0.91 us for 4x4 ops,
// 0.73-1.21 us for 8x8 and about 2.2 us for 16x16; a CTU step without
// an op about 0.6 us: the dependent instructions and shared-memory reads
// of an op on one warp.
//
// The entry point launches the kernel once and returns cudaGetLastError()
// (0 on success); nothing synchronises and nothing allocates.
//
// H265_TILE_PROBE (tools/probe_h265_tile_split.py) builds a variant in
// which lane 0 of each warp adds clock64() spans per (plane, band) to a
// buffer.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// two warps per (plane, band): warp 0 runs the ops, warp 1 moves data
constexpr int THREADS = 64;
// named barriers between the two warps: CTU cx's inputs are ready (warp 1
// arrives, warp 0 waits), CTU cx's ops are done (warp 0 arrives, warp 1
// waits); barrier 0 is __syncthreads
constexpr int BAR_READY = 1, BAR_DONE = 2;
// cycles a spin waits for the band above before it traps (about a second
// at the H100's clock; a picture takes milliseconds)
constexpr long long SPIN_LIMIT = 1LL << 31;
// the angular table as the wrapper packs it (wavefront_kernels
// ._tile_table): per (mode - 2, size) row of reconstruct._ANG_FUSED, 49
// int32: 64 uint16 (sel << 8 | pos + 1) of the reference entries, 32 uint16
// (r0 << 8 | c1) of the rows, then fixon | fixidx << 1 | fixpos << 8 |
// filtk << 16 | transp << 17; kept in shared memory for the launch
constexpr int TBL_W = 49, TBL_ROWS = 33 * 4, TBL_INTS = TBL_ROWS * TBL_W;
// the fused table's _REFCAP: reference entries the projection may index
constexpr int RC = 66;
// packed z-slot op fields (reconstruct._ZF_*)
constexpr int ZF_SL2 = 2, ZF_MODE = 4, ZF_VX = 10, ZF_VY = 17;
// neighbour line length of the largest op (size 32): 2 size + 4
constexpr int RAW_MAX = 2 * 32 + 4;
// reference entries of an op: 2 size (angular), or 2 (size + 1) (planar)
constexpr int REF_MAX = 2 * 33;

#ifdef H265_TILE_PROBE
// spans (SPAN_*: warp 0's, then warp 1's), then the band's ops, cycles,
// nanoseconds and start
constexpr int N_SPANS = 12, N_SPANS_OPS = 4;
constexpr int PROBE_N = N_SPANS + 4;
// warp 0: waiting for its inputs, neighbour lines, prediction and store,
// barriers; warp 1: issuing copies, waiting for them, listing ops,
// polling the band above, waiting on it, reading the line above, writing
// a CTU back, fence and flag
enum { SPAN_READY, SPAN_LINES, SPAN_PREDICT, SPAN_BARRIER,
       SPAN_FETCH, SPAN_COPIES, SPAN_LIST, SPAN_POLL, SPAN_WAIT, SPAN_ABOVE,
       SPAN_WRITE, SPAN_PUBLISH };
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// the clock, read in order with the memory operations around it
__device__ __forceinline__ long long probe_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}
// the clock of each warp's last arrival at a named barrier (BAR_READY:
// warp 1's, BAR_DONE: warp 0's), by lane 0, before the bar.arrive
__shared__ long long probe_arrived[2];
// lane 0 of each warp keeps its spans in registers until the band ends.
// A clock read right after a bar.sync (BAR.SYNC.DEFER_BLOCKING, then the
// clock read, in the machine code) runs before the barrier releases the
// warp, whose wait then shows at a later instruction (the neighbour-line
// reads). So a wait at a named barrier ends at the other warp's arrival,
// stamped before its bar.arrive: PROBE_WAITED books the time up to it
// into span k, PROBE_RELEASED drops it (warp 1 waiting on warp 0)
#define PROBE_MARK(k)                          \
  do {                                         \
    if ((threadIdx.x & 31) == 0) {             \
      const long long n_ = probe_clock();      \
      spans[k] += n_ - probe_t;                \
      probe_t = n_;                            \
    }                                          \
  } while (0)
#define PROBE_ARRIVE(id)                                         \
  do {                                                           \
    if ((threadIdx.x & 31) == 0) probe_arrived[(id) - 1] = probe_clock(); \
  } while (0)
#define PROBE_WAITED(id, k)                                      \
  do {                                                           \
    if ((threadIdx.x & 31) == 0) {                               \
      const long long r_ = max(probe_arrived[(id) - 1], probe_t); \
      spans[k] += r_ - probe_t;                                  \
      probe_t = r_;                                              \
    }                                                            \
  } while (0)
#define PROBE_RELEASED(id)                                       \
  do {                                                           \
    if ((threadIdx.x & 31) == 0)                                 \
      probe_t = max(probe_arrived[(id) - 1], probe_t);           \
  } while (0)
#define PROBE_ARGS , long long (&spans)[N_SPANS], long long &probe_t
#define PROBE_PASS , spans, probe_t
#else
#define PROBE_MARK(k) do {} while (0)
#define PROBE_ARRIVE(id) do {} while (0)
#define PROBE_WAITED(id, k) do {} while (0)
#define PROBE_RELEASED(id) do {} while (0)
#define PROBE_ARGS
#define PROBE_PASS
#endif

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// the flag of the band above is polled with relaxed loads and acquired
// with one fence once it is far enough (a strong read, then
// fence.acq_rel: PTX's acquire pattern)
__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(THREADS) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(THREADS) : "memory");
}

// one 4-byte asynchronous copy global -> shared (cp.async, L1-allocating)
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(d), "l"(src) : "memory");
}

// one 16-byte asynchronous copy global -> shared, past L1
__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// all but this lane's n latest groups of copies are done; a __syncwarp
// after it publishes them to the warp
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n >= 4)
    asm volatile("cp.async.wait_group 4;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// slot z of a CTB of 1 << cb_log2 samples: its offset (oy, ox) and the
// largest block its alignment admits (_zslot_table)
__device__ __forceinline__ void zslot(int z, int cb_log2, int& oy, int& ox,
                                      int& smax) {
  int r = 0, c = 0;
  for (int k = 0; k < cb_log2 - 2; ++k) {
    c |= ((z >> (2 * k)) & 1) << k;
    r |= ((z >> (2 * k + 1)) & 1) << k;
  }
  oy = r << 2;
  ox = c << 2;
  smax = 4;
  while (smax < 32 && smax < (1 << cb_log2) && oy % (smax * 2) == 0 &&
         ox % (smax * 2) == 0)
    smax *= 2;
}

// one neighbour line of an op (_side_arrays): raw[i] = src[i - 1] for i =
// 0..NV + 1, and the clamped, [1 2 1]-filtered and strong-smoothed values
// at the logical positions p = -1..NV - 1
struct Side {
  const int* raw;
  int omin, hi, lo_v, hi_v, cp, c1s, nv;

  __device__ __forceinline__ void init(const int* r, int om_min, int om,
                                       int corner_param, int NV) {
    raw = r;
    omin = om_min;
    hi = max(om - 1, omin);
    lo_v = omin == -1 ? r[0] : r[1];
    hi_v = r[hi + 1];
    cp = corner_param;
    c1s = r[min(hi, 63) + 1];
    nv = NV;
  }
  __device__ __forceinline__ int rawc(int p) const {
    return p < omin ? lo_v : (p > hi ? hi_v : raw[p + 1]);
  }
  __device__ __forceinline__ int filt(int p) const {
    const int prev = p == -1 ? (omin == -1 ? cp : rawc(-1)) : rawc(p - 1);
    return (prev + 2 * rawc(p) + rawc(min(p + 1, nv - 1)) + 2) >> 2;
  }
  __device__ __forceinline__ int strong(int p) const {
    return ((63 - p) * lo_v + (p + 1) * c1s + 32) >> 6;
  }
  // kind: 0 clamped raw, 1 filtered, 2 strong
  __device__ __forceinline__ int line(int p, int kind) const {
    return kind == 0 ? rawc(p) : (kind == 1 ? filt(p) : strong(p));
  }
};

// _extra_vals at one position of the side line raw (cap = NV + 1)
__device__ __forceinline__ int extra_val(const int* raw, int pos, int omin,
                                         int valid, int kind, int cap) {
  const int ix = min(max(pos + 1, 0), cap);
  const int c1 = raw[ix], prev = raw[max(ix - 1, 0)];
  const int nxt = raw[min(ix + 1, cap)];
  if (kind == 1) {
    if (pos <= omin) return (3 * c1 + nxt + 2) >> 2;
    if (pos >= valid - 1) return (prev + 3 * c1 + 2) >> 2;
    return (prev + 2 * c1 + nxt + 2) >> 2;
  }
  if (kind == 2) {
    const int c0 = omin == -1 ? raw[0] : raw[1];
    const int c1v = raw[min(min(max(valid - 1, 0), 63) + 1, cap)];
    return ((63 - pos) * c0 + (pos + 1) * c1v + 32) >> 6;
  }
  const int top = max(valid - 1, omin);
  return raw[min(max(min(max(pos, omin), top) + 1, 0), cap)];
}

// the DC edge sum of one side (_intra_core's edge_sum), by the warp
__device__ __forceinline__ int edge_sum(const int* raw, int vm, int vs,
                                        int fb, int size, int S) {
  const int n = min(size, max(vm, 0));
  const int lane = threadIdx.x & 31;
  const int s = __reduce_add_sync(~0u, lane < n ? raw[1 + lane] : 0);
  if (size <= vm) return s;
  if (vm > 0) return s + raw[1 + min(max(vm - 1, 0), S - 1)] * (size - vm);
  return vs > 0 ? fb * size : 128 * size;
}

// one component's plane: padded samples and residuals, the padded width,
// the rows neighbour reads clamp to and the content's last column
struct Plane {
  int* px;
  const int* res;
  int stride, ylo, yhi, xhi;
};

// CTUs of C = 1 << cl2 samples a band's window holds (a power of two):
// CTU cx - 1 (its last column is CTU cx's left neighbour), cx, cx + 1 (the
// top lines reach into it), and those fetched ahead
__host__ __device__ constexpr int window_ctus(int cl2) {
  return cl2 <= 5 ? 8 : 4;
}

// the shared memory of a band of CTB 1 << cl2 (in ints): the window of
// samples, C + 1 rows (the line above the band, then the band's rows) of
// window_ctus(cl2) * C columns, each sample at its column modulo that
// width (rows one int apart more, so that a column spreads over the
// banks); the residuals, C rows of the same columns; a ring of op words
// per CTU; the op lists and counts of two CTUs; an op's neighbour lines,
// reference and row table
__host__ __device__ constexpr int band_ints(int cl2) {
  return ((1 << cl2) + 1) * (window_ctus(cl2) * (1 << cl2) + 1) +
         (1 << cl2) * (window_ctus(cl2) * (1 << cl2) + 1) +
         (window_ctus(cl2) + 2) * (1 << (2 * (cl2 - 2))) + 2 +
         2 * RAW_MAX + REF_MAX + 2 * 32;
}

// a CTA's: the angular table, the larger of its luma and chroma bands',
// the op count of each CTU of the band (cols of them), then the ticket
__host__ __device__ constexpr int smem_ints(int ctb_log2, int cols) {
  return TBL_INTS +
         (band_ints(ctb_log2) > band_ints(ctb_log2 - 1)
              ? band_ints(ctb_log2)
              : band_ints(ctb_log2 - 1)) + cols + 1;
}

// a band's view of the shared memory, and the origin of its CTU cx
struct Band {
  Plane pl;
  int *win, *res, *words, *lists, *nops, *rawl, *rawt, *ref, *r0, *c1;
  int cl2, C, ns, K, wm, ws, Y0, X0;

  __device__ __forceinline__ void init(int* smem, int cl2_) {
    cl2 = cl2_;
    C = 1 << cl2;
    ns = 1 << (2 * (cl2 - 2));
    K = window_ctus(cl2);
    wm = K * C - 1;
    ws = K * C + 1;
    win = smem;
    res = win + (C + 1) * ws;
    words = res + C * ws;
    lists = words + K * ns;
    nops = lists + 2 * ns;
    rawl = nops + 2;
    rawt = rawl + RAW_MAX;
    ref = rawt + RAW_MAX;
    r0 = ref + REF_MAX;
    c1 = r0 + 32;
  }
  // the window's entry of sample (y, x) of the plane, for y >= Y0 - 1:
  // rows below the band and columns right of CTU cx + 1 land on other
  // entries, which only reads past an op's valid counts make
  __device__ __forceinline__ int at(int y, int x) const {
    return (min(y - Y0, C - 1) + 1) * ws + (x & wm);
  }
  __device__ __forceinline__ int sample(int y, int x) const {
    return win[at(y, x)];
  }
};

// CTU cx of the band into the ring and the window, asynchronously: its
// op words and residual (ops), its samples (samples)
__device__ __forceinline__ void prefetch(const Band& b, const int* words,
                                         int cols, int cy, int cx, bool ops,
                                         bool samples) {
  const int lane = threadIdx.x & 31, C = b.C;
  const int x0 = cx << b.cl2;
  const size_t o0 = (size_t)b.Y0 * b.pl.stride + x0;
  if (ops) {
    const int* w = words + (size_t)(cy * cols + cx) * b.ns;
    int* wd = b.words + (cx & (b.K - 1)) * b.ns;
    for (int i = lane; i < b.ns; i += 32) cp_async4(wd + i, w + i);
    for (int i = lane; i < C * C; i += 32) {
      const int r = i >> b.cl2, c = i & (C - 1);
      cp_async4(b.res + r * b.ws + ((x0 + c) & b.wm),
                b.pl.res + o0 + (size_t)r * b.pl.stride + c);
    }
  }
  if (samples)
    for (int i = lane; i < C * C; i += 32) {
      const int r = i >> b.cl2, c = i & (C - 1);
      cp_async4(b.win + (r + 1) * b.ws + ((x0 + c) & b.wm),
                b.pl.px + o0 + (size_t)r * b.pl.stride + c);
    }
}

// one intra op of CTU cx, by the warp: neighbour lines, reference,
// prediction, residual, clip, store into the window. f: its word; e: its
// slot's entry of the op list (offset and largest size)
__device__ __forceinline__ void apply_op(const Band& b, int f, int e,
                                         bool luma, bool strong_en,
                                         const int* __restrict__ tbl
                                             PROBE_ARGS) {
  const int lane = threadIdx.x & 31;
  const Plane& pl = b.pl;
  const int oy = (e >> 8) & 255, ox = (e >> 16) & 255, S = 1 << (e >> 24);
  const int y0 = b.Y0 + oy, x0 = b.X0 + ox;
  const int used = f & 3;
  const int sl2 = min(((f >> ZF_SL2) & 3) + 2, e >> 24);
  const int mode = (f >> ZF_MODE) & 63;
  const int vx = (f >> ZF_VX) & 127, vy = (f >> ZF_VY) & 127;
  const int NV = 2 * S + 2;
  const int size = 1 << sl2, two_sz = 2 * size;
  int* RAWL = b.rawl;
  int* RAWT = b.rawt;
  const int lx = min(max(x0 - 1, 0), pl.xhi);
  const int ty = min(max(y0 - 1, pl.ylo), pl.yhi);
  for (int i = lane; i < two_sz + 4; i += 32) {
    RAWL[i] = b.sample(min(max(y0 - 1 + i, pl.ylo), pl.yhi), lx);
    RAWT[i] = b.sample(ty, min(max(x0 - 1 + i, 0), pl.xhi));
  }
  PROBE_MARK(SPAN_LINES);
  __syncwarp();
  PROBE_MARK(SPAN_BARRIER);

  const int corner = RAWT[0], L0 = RAWL[1], T0 = RAWT[1];
  const int ominL = vx > 0 ? -1 : 0, ominT = vy > 0 ? -1 : 0;

  // strong-smoothing decision (S = 32 luma only)
  bool dflag = false;
  if (luma && strong_en && sl2 == 5 && S == 32) {
    auto onedir = [](int lt, const int* raw, int vl) {
      if (vl >= 64) {
        const int d = lt + raw[64] - 2 * raw[32];
        return d * d < 64;
      }
      if (vl >= 32) {
        const int d = lt - raw[32];
        return d * d < 64;
      }
      return true;
    };
    dflag = vx > 0 ? (vy > 0 ? onedir(corner, RAWT, vx) &&
                                   onedir(corner, RAWL, vy)
                             : onedir(T0, RAWT, vx))
                   : (vy > 0 ? onedir(L0, RAWL, vy) : false);
  }

  // DC value, also the stray pixel's
  int dc = 0, dc1v = 0;
  if (mode == 1 || (used & 2)) {
    const int st = edge_sum(RAWT, vx, vy, L0, size, S);
    const int sl = edge_sum(RAWL, vy, vx, T0, size, S);
    dc = (st + sl + size) >> (sl2 + 1);
    dc1v = (T0 + 3 * dc + 2) >> 2;
  }

  // the reference, built once: planar's edges (ref[0..size] left,
  // ref[size + 1..2 size + 1] top) or the angular projection's entries
  // from the (mode, size) row of the fused table
  int* REF = b.ref;
  const int mm = min(max(mode - 2, 0), 32);
  const int* row = tbl + (mm * 4 + (sl2 - 2)) * TBL_W;
  const unsigned short* sp = (const unsigned short*)row;
  const unsigned short* yrow = (const unsigned short*)(row + 32);
  const int scal = row[48];
  const int RCW = min(2 * S, RC);
  const bool angular = mode >= 2 && mode != 10 && mode != 26;
  const bool transp = angular && ((scal >> 17) & 1);
  // DC, horizontal and vertical read the raw lines only
  const bool reference = (mode == 0 && (vx > 0 || vy > 0)) || angular;
  Side SL, ST;
  if (reference) {
    SL.init(RAWL, ominL, min(two_sz, vy), T0, NV);
    ST.init(RAWT, ominT, min(two_sz, vx), L0, NV);
  }
  if (mode == 0 && (vx > 0 || vy > 0)) {
    const int kindP = (luma && sl2 >= 3) ? (dflag ? 2 : 1) : 0;
    for (int k = lane; k <= size; k += 32) {
      REF[k] = vy > 0 ? SL.line(k, kindP) : T0;
      REF[size + 1 + k] = vx > 0 ? ST.line(k, kindP) : L0;
    }
  } else if (angular) {
    const int kindA =
        luma ? (((scal >> 16) & 1) == 0 ? 0 : (dflag ? 2 : 1)) : 0;
    const bool horiz = mm < 16;
    const int vmain = horiz ? vy : vx, vsub = horiz ? vx : vy;
    const int omin_sub = horiz ? ominT : ominL;
    const Side M = horiz ? SL : ST;
    const int* subRAW = horiz ? RAWT : RAWL;
    const int sub_single = horiz ? L0 : T0;
    const bool fixon = (scal & 1) && vmain >= two_sz;
    const int fixidx = (scal >> 1) & 127;
    // the projection reads entries 0..2 size - 1 (the clamps to RCW - 1
    // never bind inside the block)
    for (int k = lane; k < min(RCW, two_sz); k += 32) {
      const int sel = sp[k] >> 8, pos = (sp[k] & 255) - 1;
      int v;
      if (sel == 1) {
        v = vsub > 0 ? extra_val(subRAW, pos, omin_sub, vsub, kindA,
                                 NV + 1)
                     : (vmain > 0 ? sub_single : 128);
      } else if (sel != 0) {
        v = 0;
      } else if (vmain <= 0) {
        v = vsub > 0 ? subRAW[1] : 128;
      } else if (fixon && k == fixidx) {
        v = M.rawc(min(((scal >> 8) & 255) + 1, NV) - 1);
      } else {
        v = M.line(min(max(pos + 1, 0), NV) - 1, kindA);
      }
      REF[k] = v;
    }
    for (int y = lane; y < size; y += 32) {
      b.r0[y] = yrow[y] >> 8;
      b.c1[y] = yrow[y] & 255;
    }
  }
  PROBE_MARK(SPAN_PREDICT);
  if (reference) __syncwarp();
  PROBE_MARK(SPAN_BARRIER);

  const bool filt_edge = luma && sl2 < 5;
  const int C = b.C;
  // the prediction of sample (gy, gx) of the block
  auto predict = [&](int gy, int gx) -> int {
    int v;
    if (mode == 0) {
      if (vx <= 0 && vy <= 0) {
        v = 128;
      } else {
        const int lv = REF[gy], lb = REF[size], rt = REF[2 * size + 1];
        v = ((lv << sl2) + (gy + 1) * lb + (gx + 1) * (rt - lv) +
             REF[size + 1 + gx] * (size - 1 - gy) + size) >> (sl2 + 1);
      }
    } else if (mode == 1) {
      v = dc;
      if (filt_edge && (vx > 0 || vy > 0)) {
        const bool both = vx > 0 && vy > 0, ton = vx > 0 && vy <= 0;
        if (gy == 0 && gx == 0)
          v = both ? (T0 + L0 + 2 * dc + 2) >> 2
                   : (ton ? (T0 + dc + 1) >> 1 : (L0 + dc + 1) >> 1);
        else if (gy == 0)
          v = (both || ton) ? (RAWT[1 + gx] + 3 * dc + 2) >> 2
                            : (L0 + 3 * dc + 2) >> 2;
        else if (gx == 0)
          v = ton ? dc1v : (RAWL[1 + gy] + 3 * dc + 2) >> 2;
      }
    } else if (mode == 10) {
      const int dcv = vx > 0 ? T0 : 128;
      v = vy > 0 ? RAWL[1 + gy] : dcv;
      if (filt_edge && vx > 0 && gy == 0) {
        const int c0 = vy > 0 ? corner : dcv, d0 = vy > 0 ? L0 : dcv;
        v = clip255(d0 + ((RAWT[1 + gx] - c0) >> 1));
      }
    } else if (mode == 26) {
      const int dcv = vy > 0 ? L0 : 128;
      v = vx > 0 ? RAWT[1 + gx] : dcv;
      if (filt_edge && vy > 0 && gx == 0) {
        const int c0 = vx > 0 ? corner : dcv, d0 = vx > 0 ? T0 : dcv;
        v = clip255(d0 + ((RAWL[1 + gy] - c0) >> 1));
      }
    } else {
      const int yy = transp ? gx : gy, xx = transp ? gy : gx;
      const int c1 = b.c1[yy];
      const int idx = min(max(b.r0[yy] + xx, 0), RCW - 1);
      v = (REF[idx] * (32 - c1) + REF[min(idx + 1, RCW - 1)] * c1 + 16) >> 5;
    }
    return v;
  };
  for (int pix = lane; pix < size * size; pix += 32) {
    const int gy = pix >> sl2, gx = pix & (size - 1);
    const int col = (x0 + gx) & b.wm;
    b.win[(oy + gy + 1) * b.ws + col] =
        clip255(predict(gy, gx) + b.res[(oy + gy) * b.ws + col]);
  }
  if (luma && (used & 2) && lane == 0) {
    if (oy + size < C)
      b.win[b.at(y0 + size, x0)] = dc1v;
    else
      pl.px[(size_t)(y0 + size) * pl.stride + x0] = dc1v;
  }
  PROBE_MARK(SPAN_PREDICT);
  __syncwarp();
  PROBE_MARK(SPAN_BARRIER);
}

struct TileArgs {
  int* y;          // [H + 33, W + 33]
  int* c;          // [2 * CR0, W / 2 + 17], cb over cr
  const int* ry;   // residuals, the same shapes
  const int* rc;
  const int* zl;   // [n_ctu, SL] luma z-slot words
  const int* zc;   // [n_ctu, SC] chroma z-slot words
  const int* ang;  // the packed angular table [TBL_ROWS, TBL_W]
  int* progress;   // [3 * rows] CTUs done per (plane, band), then ticket
  int H, W, ctb_log2, strong_en;
#ifdef H265_TILE_PROBE
  long long* probe;  // [3 * rows, PROBE_N]
#endif
};

// warp 1: CTU k's op list into the ring (the ops in z-order, each as its
// slot j | oy << 8 | ox << 16 | log2 Smax << 24; the count to b.nops[k &
// 1])
__device__ __forceinline__ void list_ops(const Band& b, int k) {
  const int lane = threadIdx.x & 31;
  const int* w = b.words + (k & (b.K - 1)) * b.ns;
  int* list = b.lists + (k & 1) * b.ns;
  int n = 0;
  for (int base = 0; base < b.ns; base += 32) {
    const int j = base + lane;
    const bool act = j < b.ns && (w[j] & 1);
    const unsigned m = __ballot_sync(~0u, act);
    if (act) {
      int oy, ox, smax;
      zslot(j, b.cl2, oy, ox, smax);
      list[n + __popc(m & ((1u << lane) - 1))] =
          j | oy << 8 | ox << 16 | (31 - __clz(smax)) << 24;
    }
    n += __popc(m);
  }
  if (lane == 0) b.nops[k & 1] = n;
}

// warp 1, after the acquire that saw CTU k + 1 of the band above done: the
// line above the band for CTU k (2C + 1 samples) and CTU k's first row,
// through L2
__device__ __forceinline__ void load_above(const Band& b, int k) {
  const int lane = threadIdx.x & 31, C = b.C, x0 = k << b.cl2;
  const int* pa = b.pl.px + (size_t)(b.Y0 - 1) * b.pl.stride;
  for (int i = lane; i <= 2 * C; i += 32) {
    const int x = min(max(x0 - 1 + i, 0), b.pl.xhi);
    b.win[x & b.wm] = __ldcg(pa + x);
  }
  for (int i = lane; i < C; i += 32)
    b.win[b.ws + ((x0 + i) & b.wm)] = __ldcg(pa + b.pl.stride + x0 + i);
}

// lane 0 of warp 1 spins until *flag >= need (seen: its last reading),
// then acquires
__device__ __forceinline__ void wait_above(const int* flag, int need,
                                           int& seen) {
  if ((threadIdx.x & 31) == 0 && seen < need) {
    const long long t0 = clock64();
    while ((seen = ld_relaxed(flag)) < need)
      if (clock64() - t0 > SPIN_LIMIT) __trap();
    fence_acq_rel();
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS) tile_kernel(TileArgs a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cols = a.W >> a.ctb_log2, rows = a.H >> a.ctb_log2;
  const int Hc = a.H >> 1, Wc = a.W >> 1, cr0 = Hc + 17;
  int* ticket = smem + smem_ints(a.ctb_log2, cols) - 1;
  int* cnt = ticket - cols;  // ops per CTU of the band
  // the angular table into shared memory, once per CTA
  for (int i = threadIdx.x; i < TBL_INTS / 4; i += THREADS)
    cp_async16(smem + 4 * i, a.ang + 4 * i);
  cp_async_commit();
  cp_async_wait(0);
  for (;;) {
    __syncthreads();  // both warps are done with the last band
    if (threadIdx.x == 0) *ticket = atomicAdd(a.progress + 3 * rows, 1);
    __syncthreads();
    const int t = *ticket;
    if (t >= 3 * rows) return;
    const int comp = t % 3, cy = t / 3;
    const bool luma = comp == 0;
    const int ylo = comp == 2 ? cr0 : 0;
    Band b;
    b.pl = luma ? Plane{a.y, a.ry, a.W + 33, 0, a.H - 1, a.W - 1}
                : Plane{a.c, a.rc, Wc + 17, ylo, ylo + Hc - 1, Wc - 1};
    b.init(smem + TBL_INTS, luma ? a.ctb_log2 : a.ctb_log2 - 1);
    b.Y0 = ylo + (cy << b.cl2);
    b.X0 = 0;
    // the band's op count per CTU, from its words: the CTUs without an
    // op are skipped by warp 0 and only published by warp 1
    {
      const int* w0 = (luma ? a.zl : a.zc) + (size_t)cy * cols * b.ns;
      for (int k = threadIdx.x; k < cols; k += THREADS) {
        int n = 0;
        if ((b.ns & 3) == 0) {
          const int4* w = (const int4*)(w0 + (size_t)k * b.ns);
#pragma unroll 4
          for (int i = 0; i < b.ns / 4; ++i) {
            const int4 v = __ldg(w + i);
            n += (v.x & 1) + (v.y & 1) + (v.z & 1) + (v.w & 1);
          }
        } else {
          for (int i = 0; i < b.ns; ++i) n += __ldg(w0 + k * b.ns + i) & 1;
        }
        cnt[k] = n;
      }
      __syncthreads();
    }
#ifdef H265_TILE_PROBE
    long long spans[N_SPANS] = {0};
    const long long band_c0 = clock64(), band_g0 = gtimer();
    long long probe_t = band_c0;
    int n_all = 0;
#endif
    if (warp == 0) {
      // the ops of each CTU that has any, once warp 1 says its inputs are
      // in
      const bool strong_en = luma && a.strong_en;
      for (int cx = 0; cx < cols; ++cx) {
        if (cnt[cx] == 0) continue;
        b.X0 = cx << b.cl2;
        bar_sync(BAR_READY);
        PROBE_WAITED(BAR_READY, SPAN_READY);
        const int n = b.nops[cx & 1];
        const int* list = b.lists + (cx & 1) * b.ns;
        const int* w = b.words + (cx & (b.K - 1)) * b.ns;
        for (int k = 0; k < n; ++k) {
          const int e = list[k];
          apply_op(b, w[e & 255], e, luma, strong_en, smem PROBE_PASS);
        }
        PROBE_ARRIVE(BAR_DONE);
        bar_arrive(BAR_DONE);
        PROBE_MARK(SPAN_BARRIER);
#ifdef H265_TILE_PROBE
        n_all += n;
#endif
      }
    } else {
      // the inputs of the next CTU with ops while warp 0 runs CTU cx, then
      // CTU cx into the plane and its progress published. Slots of the
      // window: CTUs cx - 1, cx, cx + 1 are warp 0's; CTUs cx + 2 .. cx +
      // K - 2 are in flight (all of them are done once CTU cx + 2 is, for
      // K = 4). A CTU's words and residual are fetched if it has an op,
      // its samples if it or a neighbour has one.
      const int* words = luma ? a.zl : a.zc;
      const int* above = a.progress + comp * rows + cy - 1;
      int* mine = a.progress + comp * rows + cy;
      const int ahead = b.K - 4;  // groups that may stay in flight
      auto fetch = [&](int k) {
        if (k < cols)
          prefetch(b, words, cols, cy, k, cnt[k] > 0,
                   cnt[k] > 0 || (k > 0 && cnt[k - 1] > 0) ||
                       (k + 1 < cols && cnt[k + 1] > 0));
        cp_async_commit();
      };
      int seen = 0;
      for (int k = 0; k < b.K - 2; ++k) fetch(k);
      if (cnt[0] > 0) {
        cp_async_wait(ahead);
        __syncwarp();
        PROBE_MARK(SPAN_COPIES);
        list_ops(b, 0);
        PROBE_MARK(SPAN_LIST);
        if (cy > 0) {
          wait_above(above, min(2, cols), seen);
          PROBE_MARK(SPAN_WAIT);
          load_above(b, 0);
        }
        __syncwarp();
        PROBE_MARK(SPAN_ABOVE);
        PROBE_ARRIVE(BAR_READY);
        bar_arrive(BAR_READY);
      }
      for (int cx = 0; cx < cols; ++cx) {
        const bool cur = cnt[cx] > 0;
        const bool next = cx + 1 < cols && cnt[cx + 1] > 0;
        fetch(cx + b.K - 2);
        PROBE_MARK(SPAN_FETCH);
        bool ready = true;
        int need = 0;
        if (next) {
          cp_async_wait(ahead);
          __syncwarp();
          PROBE_MARK(SPAN_COPIES);
          list_ops(b, cx + 1);
          PROBE_MARK(SPAN_LIST);
          if (cy > 0) {
            // CTU cx + 1 needs CTUs cx + 1 and cx + 2 above: if the band
            // above is there already, its loads overlap warp 0's work
            need = min(cx + 3, cols);
            if (lane == 0 && seen < need) {
              seen = ld_relaxed(above);
              if (seen >= need) fence_acq_rel();
            }
            ready = __shfl_sync(~0u, seen, 0) >= need;
            __syncwarp();  // lane 0's acquire before the lanes' loads
            PROBE_MARK(SPAN_POLL);
            if (ready) {
              load_above(b, cx + 1);
              PROBE_MARK(SPAN_ABOVE);
            }
          }
        }
        __syncwarp();
        if (cur) {
          bar_sync(BAR_DONE);
          PROBE_RELEASED(BAR_DONE);
        }
        if (next && ready) {
          PROBE_ARRIVE(BAR_READY);
          bar_arrive(BAR_READY);
        }
        if (cur) {
          // CTU cx into the plane, then its progress
          const int x0 = cx << b.cl2, C = b.C;
          int* dst = b.pl.px + (size_t)b.Y0 * b.pl.stride + x0;
          for (int i = lane; i < C * C; i += 32) {
            const int r = i >> b.cl2, c = i & (C - 1);
            dst[(size_t)r * b.pl.stride + c] =
                b.win[(r + 1) * b.ws + ((x0 + c) & b.wm)];
          }
        }
        __syncwarp();
        PROBE_MARK(SPAN_WRITE);
        if (lane == 0) {
          if (cur) __threadfence();
          st_relaxed(mine, cx + 1);
        }
        PROBE_MARK(SPAN_PUBLISH);
        if (!ready) {
          wait_above(above, need, seen);
          PROBE_MARK(SPAN_WAIT);
          load_above(b, cx + 1);
          __syncwarp();
          PROBE_MARK(SPAN_ABOVE);
          PROBE_ARRIVE(BAR_READY);
          bar_arrive(BAR_READY);
        }
      }
      cp_async_wait(0);
    }
#ifdef H265_TILE_PROBE
    if (lane == 0) {
      long long* prb = a.probe + (size_t)t * PROBE_N;
      for (int k = warp == 0 ? 0 : N_SPANS_OPS;
           k < (warp == 0 ? N_SPANS_OPS : N_SPANS); ++k)
        prb[k] = spans[k];
      if (warp == 0) {
        prb[N_SPANS] = n_all;
        prb[N_SPANS + 1] = clock64() - band_c0;
        prb[N_SPANS + 2] = gtimer() - band_g0;
        prb[N_SPANS + 3] = band_g0;
      }
    }
#endif
  }
}

// CTAs of a tile launch: one per (plane, band), at most as many as can be
// resident (the ticket lets fewer CTAs take all the bands), with the
// dynamic shared memory of CTB 1 << ctb_log2 and cols CTUs a band
cudaError_t tile_grid(int bands, int ctb_log2, int cols, int* grid) {
  const int smem = (int)sizeof(int) * smem_ints(ctb_log2, cols);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_kernel,
                                                        THREADS, smem);
  if (err == cudaSuccess && sms * per_sm < 1)
    err = cudaErrorInvalidConfiguration;
  *grid = bands < sms * per_sm ? bands : sms * per_sm;
  return err;
}

int launch(const TileArgs& a, void* stream) {
  int grid = 0;
  const cudaError_t err = tile_grid(3 * (a.H >> a.ctb_log2), a.ctb_log2,
                                    a.W >> a.ctb_log2, &grid);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<grid, THREADS,
                sizeof(int) * smem_ints(a.ctb_log2, a.W >> a.ctb_log2),
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// planes and residuals int32, padded as above; zl, zc int32 z-slot words;
// ang the packed angular table, int32 [132, 49], 16-byte aligned;
// progress int32 [3 * (H >> ctb_log2) + 1], zero (the wrapper's scratch)
int h265_tile_wavefront(void* y, void* c, const void* ry, const void* rc,
                        const void* zl, const void* zc, const void* ang,
                        void* progress, int H, int W, int ctb_log2,
                        int strong_en, void* stream) {
  const TileArgs a = {(int*)y,         (int*)c,          (const int*)ry,
                      (const int*)rc,  (const int*)zl,   (const int*)zc,
                      (const int*)ang, (int*)progress,   H,
                      W,               ctb_log2,         strong_en};
  return launch(a, stream);
}

// the grid a launch at height H takes (int out[1]) and the dynamic shared
// memory of a CTA in bytes (the return value), or -1 on an error
int h265_tile_grid(int H, int W, int ctb_log2, void* grid) {
  const int cols = W >> ctb_log2;
  if (tile_grid(3 * (H >> ctb_log2), ctb_log2, cols, (int*)grid) !=
      cudaSuccess)
    return -1;
  return (int)sizeof(int) * smem_ints(ctb_log2, cols);
}

#ifdef H265_TILE_PROBE
// the same launch with the probe's spans: probe int64 [3 * rows, PROBE_N]
// zeroed by the caller
int h265_tile_wavefront_probe(void* y, void* c, const void* ry,
                              const void* rc, const void* zl, const void* zc,
                              const void* ang, void* progress, void* probe,
                              int H, int W, int ctb_log2, int strong_en,
                              void* stream) {
  const TileArgs a = {(int*)y,         (int*)c,          (const int*)ry,
                      (const int*)rc,  (const int*)zl,   (const int*)zc,
                      (const int*)ang, (int*)progress,   H,
                      W,               ctb_log2,         strong_en,
                      (long long*)probe};
  return launch(a, stream);
}
#endif

}  // extern "C"
