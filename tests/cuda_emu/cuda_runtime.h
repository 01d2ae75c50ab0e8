#pragma once
// CPU emulation of the CUDA surface that the row-schedule kernels of
// m2dec_tpu_torch/csrc/h264_wavefront.cu and the tile kernel of
// csrc/h265_tile.cu use, for checking their arithmetic without a GPU
// (see run.py and run_h265_tile.py): one CTA of 64 or 32 threads as
// std::threads in warps of 32, 16 named barriers; __shared__ is static
// (the tile kernel's dynamic shared memory is emu_smem), so one CTA runs
// at a time and a launch takes every row in turn by ticket. cp.async
// copies are deferred per thread until the cp.async.wait_group that
// covers their group, so a read before its wait sees the old bytes.
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstdlib>
#include <cstdio>
#include <cstddef>
#include <algorithm>
#include <deque>
#include <utility>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
using std::min; using std::max;
struct dim3e { int x, y, z; };
extern thread_local dim3e threadIdx;
extern dim3e blockIdx, blockDim;
extern std::barrier<> *emu_wbar[2];
extern std::barrier<> *emu_nbar[16];
extern int emu_xch[2][32];
inline std::barrier<>& wb() { return *emu_wbar[threadIdx.x >> 5]; }
inline void __syncwarp() { wb().arrive_and_wait(); }
inline void __syncthreads() { emu_nbar[0]->arrive_and_wait(); }
inline void emu_bar_sync(int id) { emu_nbar[id]->arrive_and_wait(); }
inline void emu_bar_arrive(int id) { (void)emu_nbar[id]->arrive(); }
inline int __shfl_sync(unsigned, int v, int src) {
  int* x = emu_xch[threadIdx.x >> 5];
  x[threadIdx.x & 31] = v; wb().arrive_and_wait();
  int r = x[src & 31]; wb().arrive_and_wait(); return r; }
inline int __shfl_xor_sync(unsigned m, int v, int l) {
  return __shfl_sync(m, v, (threadIdx.x & 31) ^ l); }
inline bool __any_sync(unsigned, bool p) {
  int* x = emu_xch[threadIdx.x >> 5];
  x[threadIdx.x & 31] = p; wb().arrive_and_wait();
  bool r = false; for (int i = 0; i < 32; ++i) r |= x[i] != 0;
  wb().arrive_and_wait(); return r; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
[[noreturn]] inline void __trap() { std::fprintf(stderr, "trap\n"); std::abort(); }
inline long long clock64() { return std::chrono::steady_clock::now().time_since_epoch().count(); }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
typedef int cudaError_t;
struct int4 { int x, y, z, w; };
inline unsigned __ballot_sync(unsigned, int p) {
  int* x = emu_xch[threadIdx.x >> 5];
  x[threadIdx.x & 31] = p != 0; wb().arrive_and_wait();
  unsigned r = 0; for (int i = 0; i < 32; ++i) r |= (x[i] ? 1u : 0u) << i;
  wb().arrive_and_wait(); return r; }
inline int __reduce_add_sync(unsigned, int v) {
  int* x = emu_xch[threadIdx.x >> 5];
  x[threadIdx.x & 31] = v; wb().arrive_and_wait();
  int r = 0; for (int i = 0; i < 32; ++i) r += x[i];
  wb().arrive_and_wait(); return r; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __clz(int v) { return v ? __builtin_clz((unsigned)v) : 32; }
// cp.async: copies queued per thread in groups; a wait applies every
// group but the n latest
extern thread_local std::vector<std::pair<int*, const int*>> emu_cp_open;
extern thread_local std::deque<std::vector<std::pair<int*, const int*>>>
    emu_cp_groups;
inline void emu_cp_async(int* dst, const int* src) {
  emu_cp_open.emplace_back(dst, src); }
inline void emu_cp_commit() {
  emu_cp_groups.push_back(std::move(emu_cp_open));
  emu_cp_open.clear(); }
inline void emu_cp_wait(size_t n) {
  while (emu_cp_groups.size() > n) {
    for (auto& [d, s] : emu_cp_groups.front()) *d = *s;
    emu_cp_groups.pop_front();
  } }
extern int* emu_smem;
