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
// j as _zslot_table does.
//
// Schedule: ONE launch per picture for the three planes. A CTA takes a
// (plane, band) by ticket (atomicAdd on progress[3 * rows]): ticket t is
// CTU row t / 3 of plane t % 3, so band cy - 1 of the same plane is ticket
// t - 3. The CTA walks its band's CTUs left to right. Before CTU cx of
// band cy it waits (one thread spinning on an acquire load) until
// progress[plane][cy - 1] >= min(cx + 2, cols), i.e. CTUs cx and cx + 1
// of the band above are done: that is the plain version's order d = cx +
// 2 * cy, since an op's valid neighbour reads reach at most C + S - 1
// samples right of the CTU origin (the band above's CTU cx + 1) and never
// below the CTU row. Inside the CTU it runs the z-slots in order, each op
// as: the left and top neighbour lines (2S + 4 samples each, reads clamped
// to the plane as _intra_op_delta clamps them) into shared memory, a
// barrier, one thread per sample of the block computing the prediction,
// adding the residual, clipping and storing, and a barrier. After the CTU
// the CTA publishes progress[plane][cy] = cx + 1 (thread 0's
// __threadfence, after the barrier that ends the last op, then a strong
// store: a release). A CTA waits only on a ticket taken earlier by a CTA
// that is running, so the scheme cannot deadlock whatever the residency;
// a spin that outlasts SPIN_LIMIT cycles traps, so a broken protocol ends
// the kernel with a CUDA error instead of hanging the card. The wrapper
// zeroes progress[0..3 * rows] before each launch.
//
// The DC stray pixel: a luma DC op with used bit 1 writes dc1v at (y0 +
// size, x0), one row below its block, which may be the first row of the
// band below. That band reaches CTU cx only after this band's progress
// passed cx + 1, so it sees the write; none of its earlier CTUs reads or
// writes that sample (their left columns end left of CTU cx, their top
// rows are above the band's first row or inside it at rows >= 3).
//
// Reads: every sample is read through L2 (__ldcg), after the acquire on
// the flag for what the band above wrote: an L1 line cached earlier can
// hold stale bytes of a sample another CTA wrote during this launch.
// Positions past an op's valid counts vx and vy are read (clamped to the
// plane) but never used, as in _intra_core.
//
// What bounds it: the chain of dependent ops, not bytes. A band's CTUs
// run one after another and a CTU's ops one after another, two barriers
// each; the critical path is cols + 2 * (rows - 1) CTUs of the luma
// plane (254 at 1080p CTB 16) plus the rows - 1 handoffs between CTAs.
// The picture's bytes (planes and residuals, read and written once) take
// about 0.01 ms at 1080p. This first version gives each op the whole CTA
// (256 threads, a 32x32 block takes four samples a thread) and evaluates
// its neighbour lines per sample from the shared raw lines. On the I
// picture of bench.py's 1080p H.265 stream (CTB 16, 33,912 luma and
// 18,117 chroma ops) it takes 5.44 ms against a dependency floor of
// 0.047 ms (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 9): the
// chain of ops inside each CTU sets its time.
//
// The entry point launches the kernel once and returns cudaGetLastError()
// (0 on success); nothing synchronises and nothing allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// cycles a spin waits for the band above before it traps (about a second
// at the H100's clock; a picture takes milliseconds)
constexpr long long SPIN_LIMIT = 1LL << 31;
// the fused angular table (reconstruct._ANG_FUSED): _REFCAP, row width,
// base of the per-(mode, size) scalars
constexpr int RC = 66;
constexpr int TBL_W = 2 * RC + 64 + 5;
constexpr int B0 = 2 * RC + 64;
// packed z-slot op fields (reconstruct._ZF_*)
constexpr int ZF_SL2 = 2, ZF_MODE = 4, ZF_VX = 10, ZF_VY = 17;
// neighbour line length of the largest slot (S = 32): NV + 2, NV = 2S + 2
constexpr int RAW_MAX = 2 * 32 + 4;

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

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

// thread 0 spins until *flag >= need (seen: its last reading, kept across
// the band); then the CTA may read what the band above published
__device__ __forceinline__ void wait_band(const int* flag, int need,
                                          int& seen) {
  if (threadIdx.x == 0 && seen < need) {
    const long long t0 = clock64();
    while ((seen = ld_acquire(flag)) < need)
      if (clock64() - t0 > SPIN_LIMIT) __trap();
  }
  __syncthreads();
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

  __device__ void init(const int* r, int om_min, int om, int corner_param,
                       int NV) {
    raw = r;
    omin = om_min;
    hi = max(om - 1, omin);
    lo_v = omin == -1 ? r[0] : r[1];
    hi_v = r[hi + 1];
    cp = corner_param;
    c1s = r[min(hi, 63) + 1];
    nv = NV;
  }
  __device__ int rawc(int p) const {
    return p < omin ? lo_v : (p > hi ? hi_v : raw[p + 1]);
  }
  __device__ int filt(int p) const {
    const int prev = p == -1 ? (omin == -1 ? cp : rawc(-1)) : rawc(p - 1);
    return (prev + 2 * rawc(p) + rawc(min(p + 1, nv - 1)) + 2) >> 2;
  }
  __device__ int strong(int p) const {
    return ((63 - p) * lo_v + (p + 1) * c1s + 32) >> 6;
  }
  // kind: 0 clamped raw, 1 filtered, 2 strong
  __device__ int line(int p, int kind) const {
    return kind == 0 ? rawc(p) : (kind == 1 ? filt(p) : strong(p));
  }
};

// _extra_vals at one position of the side line raw (cap = NV + 1)
__device__ int extra_val(const int* raw, int pos, int omin, int valid,
                         int kind, int cap) {
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

// the DC edge sum of one side (_intra_core's edge_sum)
__device__ int edge_sum(const int* raw, int vm, int vs, int fb, int size,
                        int S) {
  const int n = min(size, max(vm, 0));
  int s = 0;
  for (int k = 0; k < n; ++k) s += raw[1 + k];
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

// one intra op at (y0, x0) of slot size S, by the whole CTA: neighbour
// lines, prediction, residual, clip, store; ends with a barrier
__device__ void apply_op(const Plane& pl, int f, int y0, int x0, int S,
                         bool luma, bool strong_en,
                         const int* __restrict__ ang, int* RAWL, int* RAWT) {
  const int tid = threadIdx.x;
  const int used = f & 3;
  const int sl2 = min(max(((f >> ZF_SL2) & 3) + 2, 2), 5);
  const int mode = (f >> ZF_MODE) & 63;
  const int vx = (f >> ZF_VX) & 127, vy = (f >> ZF_VY) & 127;
  const int NV = 2 * S + 2;
  const int lx = min(max(x0 - 1, 0), pl.xhi);
  const int ty = min(max(y0 - 1, pl.ylo), pl.yhi);
  for (int i = tid; i < NV + 2; i += THREADS) {
    RAWL[i] = __ldcg(pl.px + (size_t)min(max(y0 - 1 + i, pl.ylo), pl.yhi) *
                                 pl.stride + lx);
    RAWT[i] = __ldcg(pl.px + (size_t)ty * pl.stride +
                     min(max(x0 - 1 + i, 0), pl.xhi));
  }
  __syncthreads();

  const int size = 1 << sl2, two_sz = 2 * size;
  const int corner = RAWT[0], L0 = RAWL[1], T0 = RAWT[1];
  const int ominL = vx > 0 ? -1 : 0, ominT = vy > 0 ? -1 : 0;
  Side SL, ST;
  SL.init(RAWL, ominL, min(two_sz, vy), T0, NV);
  ST.init(RAWT, ominT, min(two_sz, vx), L0, NV);

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

  // planar: its lines, and the bottom-left / top-right samples
  const int kindP = (luma && sl2 >= 3) ? (dflag ? 2 : 1) : 0;
  auto left_bn = [&](int k) { return vy > 0 ? SL.line(k, kindP) : T0; };
  auto top_bn = [&](int k) { return vx > 0 ? ST.line(k, kindP) : L0; };
  int lb = 0, rt = 0;
  if (mode == 0) {
    lb = left_bn(size);
    rt = top_bn(size);
  }

  // angular: the (mode, size) row of the fused table and the main / side
  // lines of the projection
  const int mm = min(max(mode - 2, 0), 32);
  const int* row = ang + (mm * 4 + (sl2 - 2)) * TBL_W;
  const int RCW = min(2 * S, RC);
  const int kindA = luma ? (__ldg(row + B0 + 3) == 0 ? 0 : (dflag ? 2 : 1))
                         : 0;
  const bool horiz = mm < 16;
  const int vmain = horiz ? vy : vx, vsub = horiz ? vx : vy;
  const int omin_sub = horiz ? ominT : ominL;
  const Side& M = horiz ? SL : ST;
  const int* subRAW = horiz ? RAWT : RAWL;
  const int sub_single = horiz ? L0 : T0;
  const bool fixon = __ldg(row + B0) == 1 && vmain >= two_sz;
  const int fixidx = __ldg(row + B0 + 1);
  const int fixval = M.rawc(min(max(__ldg(row + B0 + 2) + 1, 0), NV) - 1);
  const bool transp = __ldg(row + B0 + 4) == 1;
  auto ref = [&](int k) -> int {
    const int sel = __ldg(row + k);
    if (sel == 1) {
      if (vsub > 0)
        return extra_val(subRAW, __ldg(row + RC + k), omin_sub, vsub, kindA,
                         NV + 1);
      return vmain > 0 ? sub_single : 128;
    }
    if (sel != 0) return 0;
    if (vmain <= 0) return vsub > 0 ? subRAW[1] : 128;
    if (fixon && k == fixidx) return fixval;
    return M.line(min(max(__ldg(row + RC + k) + 1, 0), NV) - 1, kindA);
  };

  const bool filt_edge = luma && sl2 < 5;
  for (int pix = tid; pix < size * size; pix += THREADS) {
    const int gy = pix >> sl2, gx = pix & (size - 1);
    int v;
    if (mode == 0) {
      if (vx <= 0 && vy <= 0) {
        v = 128;
      } else {
        const int lv = left_bn(gy);
        v = ((lv << sl2) + (gy + 1) * lb + (gx + 1) * (rt - lv) +
             top_bn(gx) * (size - 1 - gy) + size) >> (sl2 + 1);
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
      const int r0 = __ldg(row + 2 * RC + yy);
      const int c1 = __ldg(row + 2 * RC + 32 + yy);
      const int idx = min(max(r0 + xx, 0), RCW - 1);
      v = (ref(idx) * (32 - c1) + ref(min(idx + 1, RCW - 1)) * c1 + 16) >>
          5;
    }
    const size_t o = (size_t)(y0 + gy) * pl.stride + x0 + gx;
    pl.px[o] = clip255(v + __ldg(pl.res + o));
  }
  if (luma && (used & 2) && tid == 0)
    pl.px[(size_t)(y0 + size) * pl.stride + x0] = dc1v;
  __syncthreads();
}

struct TileArgs {
  int* y;          // [H + 33, W + 33]
  int* c;          // [2 * CR0, W / 2 + 17], cb over cr
  const int* ry;   // residuals, the same shapes
  const int* rc;
  const int* zl;   // [n_ctu, SL] luma z-slot words
  const int* zc;   // [n_ctu, SC] chroma z-slot words
  const int* ang;  // _ANG_FUSED [132, TBL_W]
  int* progress;   // [3 * rows] CTUs done per (plane, band), then ticket
  int H, W, ctb_log2, strong_en;
};

__global__ void __launch_bounds__(THREADS) tile_kernel(TileArgs a) {
  __shared__ int RAWL[RAW_MAX], RAWT[RAW_MAX];
  __shared__ int ticket_s;
  const int cols = a.W >> a.ctb_log2, rows = a.H >> a.ctb_log2;
  const int Hc = a.H >> 1, Wc = a.W >> 1, cr0 = Hc + 17;
  for (;;) {
    if (threadIdx.x == 0) ticket_s = atomicAdd(a.progress + 3 * rows, 1);
    __syncthreads();
    const int t = ticket_s;
    __syncthreads();
    if (t >= 3 * rows) return;
    const int comp = t % 3, cy = t / 3;
    const bool luma = comp == 0;
    const int ylo = comp == 2 ? cr0 : 0;
    const Plane pl = luma ? Plane{a.y, a.ry, a.W + 33, 0, a.H - 1, a.W - 1}
                          : Plane{a.c, a.rc, Wc + 17, ylo, ylo + Hc - 1,
                                  Wc - 1};
    const int cl2 = luma ? a.ctb_log2 : a.ctb_log2 - 1;
    const int n_slots = 1 << (2 * (cl2 - 2));
    const int* words = luma ? a.zl : a.zc;
    const int* above = a.progress + comp * rows + cy - 1;
    int* mine = a.progress + comp * rows + cy;
    int seen = 0;
    for (int cx = 0; cx < cols; ++cx) {
      if (cy > 0) wait_band(above, min(cx + 2, cols), seen);
      const int* w = words + (size_t)(cy * cols + cx) * n_slots;
      bool dirty = false;
      for (int j = 0; j < n_slots; ++j) {
        const int f = __ldg(w + j);
        if (!(f & 1)) continue;
        int oy, ox, S;
        zslot(j, cl2, oy, ox, S);
        apply_op(pl, f, ylo + (cy << cl2) + oy, (cx << cl2) + ox, S, luma,
                 luma && a.strong_en, a.ang, RAWL, RAWT);
        dirty = true;
      }
      // the last op's barrier ordered every thread's stores before this
      if (threadIdx.x == 0) {
        if (dirty) __threadfence();
        st_relaxed(mine, cx + 1);
      }
    }
  }
}

// CTAs of a tile launch: one per (plane, band), at most as many as can be
// resident (the ticket lets fewer CTAs take all the bands)
cudaError_t tile_grid(int bands, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_kernel,
                                                        THREADS, 0);
  if (err == cudaSuccess && sms * per_sm < 1)
    err = cudaErrorInvalidConfiguration;
  *grid = bands < sms * per_sm ? bands : sms * per_sm;
  return err;
}

}  // namespace

extern "C" {

// planes and residuals int32, padded as above; zl, zc int32 z-slot words;
// ang int32 [132, 201]; progress int32 [3 * (H >> ctb_log2) + 1], zero
// (the wrapper's scratch)
int h265_tile_wavefront(void* y, void* c, const void* ry, const void* rc,
                        const void* zl, const void* zc, const void* ang,
                        void* progress, int H, int W, int ctb_log2,
                        int strong_en, void* stream) {
  const TileArgs a = {(int*)y,         (int*)c,          (const int*)ry,
                      (const int*)rc,  (const int*)zl,   (const int*)zc,
                      (const int*)ang, (int*)progress,   H,
                      W,               ctb_log2,         strong_en};
  int grid = 0;
  const cudaError_t err = tile_grid(3 * (H >> ctb_log2), &grid);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
