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
// Schedule. MB (mbx, mby) reads or writes only MBs on anti-diagonals
// d-1, d-2 and d-3 of d = mbx + 2*mby (left and top-right on d-1, top on
// d-2, top-left on d-3; deblock writes reach 3 px into the left and top
// MBs), so all MBs of one diagonal are independent. Each C entry point
// launches its kernel once per diagonal, one thread block per MB:
// mby = mby_lo + blockIdx.x, mbx = d - 2*mby.
//
// What bounds them on this card: launch latency and dependency depth
// (nd = mb_w + 2*mb_h - 2 dependent launches per pass, 254 at 1080p, each
// with at most mb_h = 68 small blocks), not bytes: a pass touches each
// pixel a few times. This first design keeps each MB's window in shared
// memory and the per-MB work short; a persistent kernel with per-row
// progress flags or CUDA graphs over the launches are the later remedies.
//
// Every entry point returns the first cudaGetLastError() of its launches
// (0 on success); nothing synchronises and nothing allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clip3(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ int clip255(int v) { return clip3(v, 0, 255); }

__device__ __forceinline__ int load_px(const uint8_t* p, int W, int H, int y,
                                       int x) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? p[y * W + x] : 0;
}

// mode values outside 1..n-1 select mode 0 (the plain version's select)
__device__ __forceinline__ int sel_mode(int m, int n) {
  return (m >= 1 && m < n) ? m : 0;
}

// fir3 (K3) or fir2 value of one predicted sample from a reference line,
// with the (IA, IB, IC, K3) index tables tab[4][9][P] of the plain
// version's _mk_tables4 / _mk_tables8 (the mode matrices' integer form)
__device__ __forceinline__ int eval_mode(const int* line, const int* tab,
                                         int P, int mode, int p) {
  const int o = mode * P + p;
  const int ia = tab[o], ib = tab[9 * P + o], ic = tab[18 * P + o];
  if (tab[27 * P + o])
    return (line[ia] + 2 * line[ib] + line[ic] + 2) >> 2;
  return (line[ib] + line[ic] + 1) >> 1;
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
// intra luma: 256 threads, one per pixel of the MB
// ---------------------------------------------------------------------

__global__ void intra_luma_kernel(
    uint8_t* __restrict__ y, const int* __restrict__ kind,
    const int* __restrict__ res_y, const int* __restrict__ i4_modes,
    const int* __restrict__ i4_avail, const int* __restrict__ i8_modes,
    const int* __restrict__ i8_avail, const int* __restrict__ i16_mode,
    const int* __restrict__ mb_avail, const int* __restrict__ tab4,
    const int* __restrict__ tab8, int mb_w, int mb_h, int has_i8, int d,
    int mby_lo) {
  const int mby = mby_lo + blockIdx.x;
  const int mbx = d - 2 * mby;
  const int mb = mby * mb_w + mbx;
  int k = kind[mb];
  if (k < 1 || k > 3) return;  // inter / PCM pass through (block-uniform)
  if (k == 2 && !has_i8) k = 1;  // the plain version's static has_i8 arm

  const int W = mb_w * 16, H = mb_h * 16;
  const int x0 = mbx * 16, y0 = mby * 16;
  const int tid = threadIdx.x;
  // window: row 0 = corner + top + top-right, rows 1..16 = left + tile +
  // the first 8 columns of the right MB (the plain version's Ty)
  __shared__ int T[17][25];
  __shared__ int line[32];
  __shared__ int dcs;
  for (int i = tid; i < 17 * 25; i += blockDim.x) {
    const int r = i / 25, c = i % 25;
    T[r][c] = load_px(y, W, H, y0 - 1 + r, x0 - 1 + c);
  }
  __syncthreads();
  const int* res = res_y + mb * 256;

  if (k == 1) {
    // Intra4x4: 16 sub-blocks in coding (z) order
    for (int b = 0; b < 16; ++b) {
      const int oy = ((b >> 1) & 1) * 4 + ((b >> 3) & 1) * 8;
      const int ox = (b & 1) * 4 + ((b >> 2) & 1) * 8;
      const int blk = (oy >> 2) * 4 + (ox >> 2);
      const int av = i4_avail[mb * 16 + blk];
      // line: [0..3] left, [4] corner, [5..8] top, [9..12] top-right
      // (or top[3] repeated), [13] DC
      if (tid < 13) {
        int v;
        if (tid < 4) v = T[1 + oy + tid][ox];
        else if (tid == 4) v = T[oy][ox];
        else if (tid < 9) v = T[oy][1 + ox + (tid - 5)];
        else v = (av & 4) ? T[oy][5 + ox + (tid - 9)] : T[oy][4 + ox];
        line[tid] = v;
      }
      __syncthreads();
      if (tid == 0) {
        const int sl = line[0] + line[1] + line[2] + line[3];
        const int st = line[5] + line[6] + line[7] + line[8];
        line[13] = dc_pred(av & 1, av & 2, sl, st, 4, 3, 2, 2);
      }
      __syncthreads();
      if (tid < 16) {
        const int mode = sel_mode(i4_modes[mb * 16 + blk], 9);
        const int r = tid >> 2, c = tid & 3;
        const int v = eval_mode(line, tab4, 16, mode, tid);
        T[1 + oy + r][1 + ox + c] =
            clip255(v + res[(oy + r) * 16 + ox + c]);
      }
      __syncthreads();
    }
  } else if (k == 2) {
    // Intra8x8: 4 blocks with filtered reference samples
    for (int b = 0; b < 4; ++b) {
      const int oy = (b >> 1) * 8, ox = (b & 1) * 8;
      const int av = i8_avail[mb * 4 + b];
      const int c = T[oy][ox];
      // line: [0..7] filtered left, [8] filtered corner, [9..24] filtered
      // top run, [25] DC
      if (tid < 25) {
        int v;
        if (tid < 8) {
          const int i = tid;
          const int li = T[1 + oy + i][ox];
          if (i < 7) {
            const int prev = i == 0 ? ((av & 8) ? c : T[1 + oy][ox])
                                    : T[oy + i][ox];
            v = (prev + 2 * li + T[2 + oy + i][ox] + 2) >> 2;
          } else {
            v = (T[oy + 7][ox] + 3 * li + 2) >> 2;
          }
        } else if (tid == 8) {
          v = (T[1 + oy][ox] + 2 * c + T[oy][1 + ox] + 2) >> 2;
        } else {
          const int j = tid - 9;  // 0..15 of the top run
          // full[i] = top (i < 8) then top-right (8..15)
          const int* row = &T[oy][1 + ox];
          if (j < 7) {
            const int prev = j == 0 ? ((av & 8) ? c : row[0]) : row[j - 1];
            v = (prev + 2 * row[j] + row[j + 1] + 2) >> 2;
          } else if (av & 4) {
            v = (row[j - 1] + 2 * row[j] + row[min(j + 1, 15)] + 2) >> 2;
          } else if (j == 7) {
            v = (row[6] + 3 * row[7] + 2) >> 2;
          } else {
            v = row[7];
          }
        }
        line[tid] = v;
      }
      __syncthreads();
      if (tid == 0) {
        int sl = 0, st = 0;
        for (int i = 0; i < 8; ++i) {
          sl += line[i];
          st += line[9 + i];
        }
        line[25] = dc_pred(av & 1, av & 2, sl, st, 8, 4, 4, 3);
      }
      __syncthreads();
      if (tid < 64) {
        const int mode = sel_mode(i8_modes[mb * 4 + b], 9);
        const int r = tid >> 3, cc = tid & 7;
        const int v = eval_mode(line, tab8, 64, mode, tid);
        T[1 + oy + r][1 + ox + cc] =
            clip255(v + res[(oy + r) * 16 + ox + cc]);
      }
      __syncthreads();
    }
  } else {
    // Intra16x16: vertical / horizontal / DC / plane
    const int mode = sel_mode(i16_mode[mb], 4);
    const int av = mb_avail[mb];
    const int c = T[0][0];
    if (tid == 0) {
      int sl = 0, st = 0;
      for (int i = 0; i < 16; ++i) {
        sl += T[1 + i][0];
        st += T[0][1 + i];
      }
      dcs = dc_pred(av & 1, av & 2, sl, st, 16, 5, 8, 4);
    }
    __syncthreads();
    const int r = tid >> 4, cc = tid & 15;
    int v;
    if (mode == 0) {
      v = T[0][1 + cc];
    } else if (mode == 1) {
      v = T[1 + r][0];
    } else if (mode == 2) {
      v = dcs;
    } else {
      int h = -8 * c, vv = -8 * c;
      for (int i = 0; i < 16; ++i) {
        h += T[0][1 + i] * (i - 7);
        vv += T[1 + i][0] * (i - 7);
      }
      h = (5 * h + 32) >> 6;
      vv = (5 * vv + 32) >> 6;
      const int a = 16 * (T[16][0] + T[0][16]);
      v = clip255((a + (cc - 7) * h + (r - 7) * vv + 16) >> 5);
    }
    __syncthreads();
    T[1 + r][1 + cc] = clip255(v + res[r * 16 + cc]);
    __syncthreads();
  }

  const int r = tid >> 4, cc = tid & 15;
  y[(y0 + r) * W + x0 + cc] = (uint8_t)T[1 + r][1 + cc];
}

// ---------------------------------------------------------------------
// intra chroma: 128 threads = 2 planes x 64 pixels
// ---------------------------------------------------------------------

__global__ void intra_chroma_kernel(
    uint8_t* __restrict__ cb, uint8_t* __restrict__ cr,
    const int* __restrict__ kind, const int* __restrict__ res_c,
    const int* __restrict__ chroma_mode, const int* __restrict__ mb_avail,
    int mb_w, int mb_h, int d, int mby_lo) {
  const int mby = mby_lo + blockIdx.x;
  const int mbx = d - 2 * mby;
  const int mb = mby * mb_w + mbx;
  const int k = kind[mb];
  if (k < 1 || k > 3) return;

  const int W = mb_w * 8, H = mb_h * 8;
  const int x0 = mbx * 8, y0 = mby * 8;
  const int tid = threadIdx.x;
  const int ci = tid >> 6, p = tid & 63;
  const int r = p >> 3, c = p & 7;
  uint8_t* plane = ci ? cr : cb;
  __shared__ int T[2][9][9];  // row 0: corner + top; rows 1..8: left + tile
  for (int i = p; i < 81; i += 64)
    T[ci][i / 9][i % 9] = load_px(plane, W, H, y0 - 1 + i / 9, x0 - 1 + i % 9);
  __syncthreads();

  const int av = mb_avail[mb];
  const int av1 = av & 1, av2 = av & 2;
  const int mode = sel_mode(chroma_mode[mb], 4);
  const int (*t)[9] = T[ci];
  int v;
  if (mode == 0) {
    int sl0 = 0, sl4 = 0, st0 = 0, st4 = 0;
    for (int i = 0; i < 4; ++i) {
      sl0 += t[1 + i][0];
      sl4 += t[5 + i][0];
      st0 += t[0][1 + i];
      st4 += t[0][5 + i];
    }
    const int lower = r >= 4 ? 1 : 0, right = c >= 4 ? 1 : 0;
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
  } else if (mode == 1) {
    v = t[1 + r][0];
  } else if (mode == 2) {
    v = t[0][1 + c];
  } else {
    const int corner = t[0][0];
    int h = -4 * corner, vv = -4 * corner;
    for (int i = 0; i < 8; ++i) {
      h += t[0][1 + i] * (i - 3);
      vv += t[1 + i][0] * (i - 3);
    }
    h = (17 * h + 16) >> 5;
    vv = (17 * vv + 16) >> 5;
    const int a = 16 * (t[8][0] + t[0][8]);
    v = clip255((a + (c - 3) * h + (r - 3) * vv + 16) >> 5);
  }
  v = clip255(v + res_c[mb * 128 + ci * 64 + p]);
  plane[(y0 + r) * W + x0 + c] = (uint8_t)v;
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

// one luma line, 8 samples (q3 q2 q1 q0 | p0 p1 p2 p3), in place
__device__ void filter_line_luma(int* v[8], EdgeParams e) {
  const int q3 = *v[0], q2 = *v[1], q1 = *v[2], q0 = *v[3];
  const int p0 = *v[4], p1 = *v[5], p2 = *v[6], p3 = *v[7];
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
  *v[1] = clip255(nq2);
  *v[2] = clip255(nq1);
  *v[3] = clip255(nq0);
  *v[4] = clip255(np0);
  *v[5] = clip255(np1);
  *v[6] = clip255(np2);
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
// deblock luma: 16 threads, one per line of the current edge
// ---------------------------------------------------------------------

__global__ void deblock_luma_kernel(
    uint8_t* __restrict__ y, const int* __restrict__ deb_str,
    const int* __restrict__ deb_str4, const int* __restrict__ deb_ab,
    const int* __restrict__ alpha_t, const int* __restrict__ beta_t,
    const int* __restrict__ tc0_t, int mb_w, int mb_h, int d, int mby_lo) {
  const int mby = mby_lo + blockIdx.x;
  const int mbx = d - 2 * mby;
  const int mb = mby * mb_w + mbx;
  const int W = mb_w * 16, H = mb_h * 16;
  const int x0 = mbx * 16, y0 = mby * 16;
  const int tid = threadIdx.x;
  // window (r, c) <-> pixel (y0 - 4 + r, x0 - 4 + c): rows 0..3 the top
  // MB's last rows, columns 0..3 the left MB's last columns
  __shared__ int Wy[20][20];
  for (int i = tid; i < 400; i += blockDim.x)
    Wy[i / 20][i % 20] = load_px(y, W, H, y0 - 4 + i / 20, x0 - 4 + i % 20);
  __syncthreads();

  for (int axis = 0; axis < 2; ++axis) {
    const int* sb = deb_str + mb * 8 + axis * 4;
    const int* ab = deb_ab + mb * 24 + axis * 12;
    const int d4 = deb_str4[mb * 2 + axis];
    for (int e = 0; e < 4; ++e) {
      const EdgeParams p =
          edge_params(sb[e], e == 0 ? d4 : 0, ab + (e == 0 ? 0 : 6), tid, 2,
                      alpha_t, beta_t, tc0_t);
      const int c0 = 4 * e;
      int* v[8];
      for (int i = 0; i < 8; ++i)
        v[i] = axis == 0 ? &Wy[4 + tid][c0 + i] : &Wy[c0 + i][4 + tid];
      filter_line_luma(v, p);
      __syncthreads();
    }
  }

  for (int i = tid; i < 400; i += blockDim.x) {
    const int r = i / 20, c = i % 20;
    if (r < 4 && c < 4) continue;  // the corner is never filtered
    const int py = y0 - 4 + r, px = x0 - 4 + c;
    if (py >= 0 && px >= 0) y[py * W + px] = (uint8_t)Wy[r][c];
  }
}

// ---------------------------------------------------------------------
// deblock chroma: 16 threads = 2 planes x 8 lines
// ---------------------------------------------------------------------

__global__ void deblock_chroma_kernel(
    uint8_t* __restrict__ cb, uint8_t* __restrict__ cr,
    const int* __restrict__ deb_str, const int* __restrict__ deb_str4,
    const int* __restrict__ deb_ab, const int* __restrict__ alpha_t,
    const int* __restrict__ beta_t, const int* __restrict__ tc0_t, int mb_w,
    int mb_h, int d, int mby_lo) {
  const int mby = mby_lo + blockIdx.x;
  const int mbx = d - 2 * mby;
  const int mb = mby * mb_w + mbx;
  const int W = mb_w * 8, H = mb_h * 8;
  const int x0 = mbx * 8, y0 = mby * 8;
  const int tid = threadIdx.x;
  const int ci = tid >> 3, k = tid & 7;
  uint8_t* plane = ci ? cr : cb;
  // window (r, c) <-> pixel (y0 - 4 + r, x0 - 4 + c) (the plain
  // version's [12,12] window; only rows 2.. and columns 2.. are used)
  __shared__ int Wc[2][12][12];
  for (int i = k; i < 144; i += 8)
    Wc[ci][i / 12][i % 12] =
        load_px(plane, W, H, y0 - 4 + i / 12, x0 - 4 + i % 12);
  __syncthreads();

  for (int axis = 0; axis < 2; ++axis) {
    const int* sb = deb_str + mb * 8 + axis * 4;
    const int* ab = deb_ab + mb * 24 + axis * 12;
    const int d4 = deb_str4[mb * 2 + axis];
    for (int e = 0; e < 4; e += 2) {
      const int abrow = (e == 0 ? 1 : 4) + ci;
      const EdgeParams p = edge_params(sb[e], e == 0 ? d4 : 0,
                                       ab + 2 * abrow, k, 1, alpha_t,
                                       beta_t, tc0_t);
      const int cc0 = 2 + 4 * (e >> 1);
      int* v[4];
      for (int i = 0; i < 4; ++i)
        v[i] = axis == 0 ? &Wc[ci][4 + k][cc0 + i] : &Wc[ci][cc0 + i][4 + k];
      filter_line_chroma(v, p);
      __syncthreads();
    }
  }

  for (int i = k; i < 144; i += 8) {
    const int r = i / 12, c = i % 12;
    if (r < 2 || c < 2 || (r < 4 && c < 4)) continue;
    const int py = y0 - 4 + r, px = x0 - 4 + c;
    if (py >= 0 && px >= 0) plane[py * W + px] = (uint8_t)Wc[ci][r][c];
  }
}

// MBs of diagonal d: mby in [lo, hi]
__host__ inline void diag_range(int d, int mb_w, int mb_h, int* lo,
                                int* hi) {
  *lo = d - mb_w + 2 > 0 ? (d - mb_w + 2) / 2 : 0;
  *hi = d / 2 < mb_h - 1 ? d / 2 : mb_h - 1;
}

}  // namespace

extern "C" {

int h264_intra_luma(void* y, const void* kind, const void* res_y,
                    const void* i4_modes, const void* i4_avail,
                    const void* i8_modes, const void* i8_avail,
                    const void* i16_mode, const void* mb_avail,
                    const void* tab4, const void* tab8, int has_i8,
                    int mb_w, int mb_h, void* stream) {
  const int nd = mb_w + 2 * mb_h - 2;
  for (int d = 0; d < nd; ++d) {
    int lo, hi;
    diag_range(d, mb_w, mb_h, &lo, &hi);
    if (hi < lo) continue;
    intra_luma_kernel<<<hi - lo + 1, 256, 0, (cudaStream_t)stream>>>(
        (uint8_t*)y, (const int*)kind, (const int*)res_y,
        (const int*)i4_modes, (const int*)i4_avail, (const int*)i8_modes,
        (const int*)i8_avail, (const int*)i16_mode, (const int*)mb_avail,
        (const int*)tab4, (const int*)tab8, mb_w, mb_h, has_i8, d, lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int h264_intra_chroma(void* cb, void* cr, const void* kind,
                      const void* res_c, const void* chroma_mode,
                      const void* mb_avail, int mb_w, int mb_h,
                      void* stream) {
  const int nd = mb_w + 2 * mb_h - 2;
  for (int d = 0; d < nd; ++d) {
    int lo, hi;
    diag_range(d, mb_w, mb_h, &lo, &hi);
    if (hi < lo) continue;
    intra_chroma_kernel<<<hi - lo + 1, 128, 0, (cudaStream_t)stream>>>(
        (uint8_t*)cb, (uint8_t*)cr, (const int*)kind, (const int*)res_c,
        (const int*)chroma_mode, (const int*)mb_avail, mb_w, mb_h, d, lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int h264_deblock_luma(void* y, const void* deb_str, const void* deb_str4,
                      const void* deb_ab, const void* alpha,
                      const void* beta, const void* tc0, int mb_w,
                      int mb_h, void* stream) {
  const int nd = mb_w + 2 * mb_h - 2;
  for (int d = 0; d < nd; ++d) {
    int lo, hi;
    diag_range(d, mb_w, mb_h, &lo, &hi);
    if (hi < lo) continue;
    deblock_luma_kernel<<<hi - lo + 1, 16, 0, (cudaStream_t)stream>>>(
        (uint8_t*)y, (const int*)deb_str, (const int*)deb_str4,
        (const int*)deb_ab, (const int*)alpha, (const int*)beta,
        (const int*)tc0, mb_w, mb_h, d, lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int h264_deblock_chroma(void* cb, void* cr, const void* deb_str,
                        const void* deb_str4, const void* deb_ab,
                        const void* alpha, const void* beta, const void* tc0,
                        int mb_w, int mb_h, void* stream) {
  const int nd = mb_w + 2 * mb_h - 2;
  for (int d = 0; d < nd; ++d) {
    int lo, hi;
    diag_range(d, mb_w, mb_h, &lo, &hi);
    if (hi < lo) continue;
    deblock_chroma_kernel<<<hi - lo + 1, 16, 0, (cudaStream_t)stream>>>(
        (uint8_t*)cb, (uint8_t*)cr, (const int*)deb_str,
        (const int*)deb_str4, (const int*)deb_ab, (const int*)alpha,
        (const int*)beta, (const int*)tc0, mb_w, mb_h, d, lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
