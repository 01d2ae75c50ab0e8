// MPEG-2 exact-integer 8x8 inverse DCT for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _idct_kernel / idct8x8_pallas
// (m2dec_tpu/kernels/pallas_idct.py:30,35). Computes, bit for bit, the
// plain version m2dec_tpu_torch/kernels/mpeg2_idct.py::idct8x8: the
// reference's Wang-style fast IDCT (src/lib/idct.cpp:144-235 horizontal,
// :286-358 vertical) with C int32 arithmetic, arithmetic right shifts,
// and the int16 wraparound where the horizontal pass stores back into
// the int16 coefficient array. No clipping (the caller's store clips).
//
// Input: int16 blocks [n, 8, 8] raster order (the plan's [N, 6, 64]
// coefficients); output: int32 [n, 8, 8].
//
// What bounds it: bytes. Each block reads 128 B and writes 256 B and
// does about 500 integer operations, i.e. 1.3 operations per byte,
// far below what the card can do per byte of device memory. So the
// design only has to keep the loads and stores coalesced and wide:
// one CTA takes 32 blocks with 256 threads. Thread (b, r) loads row r
// of block b as one 16-byte load (neighbouring threads read
// neighbouring addresses), runs the horizontal pass and stores the
// row as int16 into shared memory, which is the wrap. After a barrier,
// thread (b, c) runs the vertical pass down column c and writes the
// column into an int32 shared tile; after a second barrier thread
// (b, r) writes row r of block b as two 16-byte stores.
//
// The TPU kernel's [tile, 8, 8] VMEM tiling does not carry over: a
// block is 128 B, so the only staging that matters is the transpose
// between the two passes, which shared memory does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W1 = 2841, W2 = 2676, W3 = 2408, W5 = 1609, W6 = 1108,
              W7 = 565;
constexpr int BLOCKS = 32;       // 8x8 blocks per CTA
constexpr int THREADS = BLOCKS * 8;
// per-block strides of the shared tiles, padded so that the column
// pass's accesses of the 4 blocks of a warp fall in different banks
constexpr int S16 = 72;          // int16 elements
constexpr int S32 = 72;          // int32 elements

// int32 arithmetic that wraps like the plain version's (two's
// complement), without signed-overflow undefined behaviour
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// (a * 181 + 128) >> 8, the sqrt(1/2) rotation
__device__ __forceinline__ int rot(int a) {
  return wadd(wmul(a, 181), 128) >> 8;
}

__global__ void __launch_bounds__(THREADS)
idct8x8_kernel(const int16_t* __restrict__ coef, int32_t* __restrict__ out,
               long long nblk) {
  __shared__ int16_t h16[BLOCKS * S16];
  __shared__ __align__(16) int32_t o32[BLOCKS * S32];
  const int t = threadIdx.x;
  const int b = t >> 3, r = t & 7;
  const long long blk = (long long)blockIdx.x * BLOCKS + b;
  const bool live = blk < nblk;

  // --- horizontal pass: thread (b, r) takes row r of block b ---------
  if (live) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(coef + blk * 64) +
                           r);
    const int16_t* q = reinterpret_cast<const int16_t*>(&raw);
    int s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = q[k];
    int x0 = wadd(wmul(s[0], 2048), 128);
    int x1 = wmul(s[4], 2048);
    int a = wsub(x0, x1), c = wadd(x0, x1);
    x0 = a;
    x1 = c;
    int tt = wmul(W7, wadd(s[1], s[7]));
    int x4 = wadd(tt, wmul(W1 - W7, s[1]));
    int x5 = wsub(tt, wmul(W1 + W7, s[7]));
    tt = wmul(W3, wadd(s[5], s[3]));
    int x6 = wsub(tt, wmul(W3 - W5, s[5]));
    int x7 = wsub(tt, wmul(W3 + W5, s[3]));
    a = wsub(x4, x6);
    c = wadd(x4, x6);
    x4 = a;
    x6 = c;
    a = wsub(x5, x7);
    c = wadd(x5, x7);
    x5 = a;
    x7 = c;
    a = rot(wadd(x4, x5));
    c = rot(wsub(x4, x5));
    x5 = a;
    x4 = c;
    tt = wmul(W6, wadd(s[2], s[6]));
    int x2 = wsub(tt, wmul(W2 + W6, s[6]));
    int x3 = wadd(tt, wmul(W2 - W6, s[2]));
    a = wsub(x0, x2);
    c = wadd(x0, x2);
    x0 = a;
    x2 = c;
    a = wsub(x1, x3);
    c = wadd(x1, x3);
    x1 = a;
    x3 = c;
    int16_t* h = h16 + b * S16 + r * 8;
    // the int16 stores are the reference's wraparound
    h[0] = (int16_t)(wadd(x3, x6) >> 8);
    h[1] = (int16_t)(wadd(x2, x5) >> 8);
    h[2] = (int16_t)(wadd(x0, x4) >> 8);
    h[3] = (int16_t)(wadd(x1, x7) >> 8);
    h[4] = (int16_t)(wsub(x1, x7) >> 8);
    h[5] = (int16_t)(wsub(x0, x4) >> 8);
    h[6] = (int16_t)(wsub(x2, x5) >> 8);
    h[7] = (int16_t)(wsub(x3, x6) >> 8);
  }
  __syncthreads();

  // --- vertical pass: thread (b, c) takes column c of block b --------
  if (live) {
    const int col = r;
    const int16_t* h = h16 + b * S16 + col;
    int v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = h[k * 8];
    int x8 = wadd(wmul(W3, wadd(v[5], v[3])), 4);
    int x6 = wsub(x8, wmul(W3 - W5, v[5])) >> 3;
    int x7 = wsub(x8, wmul(W3 + W5, v[3])) >> 3;
    x8 = wadd(wmul(W7, wadd(v[1], v[7])), 4);
    int x4 = wadd(x8, wmul(W1 - W7, v[1])) >> 3;
    int x5 = wsub(x8, wmul(W1 + W7, v[7])) >> 3;
    const int x1t = wadd(wmul(W6, wadd(v[2], v[6])), 4);
    int x2 = wsub(x1t, wmul(W2 + W6, v[6])) >> 3;
    int x3 = wadd(x1t, wmul(W2 - W6, v[2])) >> 3;
    int x1 = wadd(x4, x6);
    x4 = wsub(x4, x6);
    x6 = wadd(x5, x7);
    x5 = wsub(x5, x7);
    int x0 = wadd(wmul(v[0], 256), 8192);
    x7 = wmul(v[4], 256);
    x8 = wadd(x0, x7);
    x0 = wsub(x0, x7);
    x7 = wadd(x8, x3);
    x8 = wsub(x8, x3);
    x3 = wadd(x0, x2);
    x0 = wsub(x0, x2);
    x2 = rot(wadd(x4, x5));
    x4 = rot(wsub(x4, x5));
    int32_t* o = o32 + b * S32 + col;
    o[0 * 8] = wadd(x7, x1) >> 14;
    o[1 * 8] = wadd(x3, x2) >> 14;
    o[2 * 8] = wadd(x0, x4) >> 14;
    o[3 * 8] = wadd(x8, x6) >> 14;
    o[4 * 8] = wsub(x8, x6) >> 14;
    o[5 * 8] = wsub(x0, x4) >> 14;
    o[6 * 8] = wsub(x3, x2) >> 14;
    o[7 * 8] = wsub(x7, x1) >> 14;
  }
  __syncthreads();

  // --- coalesced store: thread (b, r) writes row r of block b ---------
  if (live) {
    const int4* src = reinterpret_cast<const int4*>(o32 + b * S32 + r * 8);
    int4* dst = reinterpret_cast<int4*>(out + blk * 64 + r * 8);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

}  // namespace

extern "C" {

// coef: int16 [nblk, 64], 16-byte aligned; out: int32 [nblk, 64].
// Returns 0 or the CUDA error of the launch.
int mpeg2_idct8x8(const void* coef, void* out, long long nblk,
                  void* stream) {
  if (nblk <= 0) return 0;
  const long long grid = (nblk + BLOCKS - 1) / BLOCKS;
  idct8x8_kernel<<<(unsigned)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (int32_t*)out, nblk);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : (int)err;
}

}  // extern "C"
