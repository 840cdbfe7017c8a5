// What the selective-scan kernels (selective_scan_fwd.cu, selective_scan_bwd.cu)
// share: the chunk geometry, fp32/bf16 conversions, reading a staged chunk
// row, cp.async staging of 16-byte units, and the launch's choice of the
// channels a block takes. Each kernel is its own library, so everything here
// sits in an anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kNItems = 8;                         // consecutive items per lane
constexpr int kChunk = 32 * kNItems;               // items per chunk (256)
constexpr int kPad = kChunk + kChunk / kNItems;    // padded shared row
constexpr int kMaxN = 16;                          // states: one warp each
constexpr unsigned kFull = 0xffffffffu;

// Rows padded by one word per 8, so the per-lane accesses of 8 consecutive
// items hit 32 distinct banks.
__device__ __forceinline__ int sidx(int e) { return e + e / kNItems; }
__host__ __device__ constexpr int pad4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// First position of the 8 contiguous positions that hold logical items
// e0 .. e0 + 7 of the chunk starting at `base`.
__device__ __forceinline__ int items_lo(int base, int e0, int reverse) {
  return reverse ? base + kChunk - kNItems - e0 : base + e0;
}

// 8 consecutive values from 16-byte-aligned q, in memory order, in fp32
// (fp32: two 16-byte loads; bf16: one)
__device__ __forceinline__ void load8(const float* q, float w[kNItems]) {
  const float4 x = reinterpret_cast<const float4*>(q)[0];
  const float4 y = reinterpret_cast<const float4*>(q)[1];
  w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  w[4] = y.x; w[5] = y.y; w[6] = y.z; w[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* q, float w[kNItems]) {
  const uint4 x = *reinterpret_cast<const uint4*>(q);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    w[2 * k] = f.x;
    w[2 * k + 1] = f.y;
  }
}

// Logical items e0 .. e0 + 7 of a staged chunk row (256 values in memory
// order, 16-byte aligned) into v.
template <typename T>
__device__ __forceinline__ void chunk_items(const T* row, int e0, int reverse,
                                            float v[kNItems]) {
  float w[kNItems];
  load8(row + items_lo(0, e0, reverse), w);
#pragma unroll
  for (int i = 0; i < kNItems; ++i) v[i] = reverse ? w[kNItems - 1 - i] : w[i];
}

// cp.async: 16 bytes from global to shared memory without passing through
// registers, the bytes past src_bytes zero-filled (src_bytes 0 reads nothing);
// 4 bytes; the commit and the wait of this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One 16-byte unit of a row of L elements, positions [p, p + 16 bytes), into
// dst, zero past L: an asynchronous copy where `vec` says the row is aligned
// for it, else plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_unit(T* dst, const T* __restrict__ row, int p, int L,
                                           int vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const int valid = min(max(L - p, 0), E);
    cp_async16(dst, valid ? row + p : row, valid * (int)sizeof(T));
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) dst[j] = p + j < L ? row[p + j] : from_f<T>(0.f);
  }
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int kMaxDevices = 64;
constexpr int kMaxTile = 6;

int sm_count(int dev, cudaError_t* err) {
  static int known[kMaxDevices];
  *err = cudaSuccess;
  if (dev < kMaxDevices && known[dev]) return known[dev];
  int sms = 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices && *err == cudaSuccess) known[dev] = sms;
  return sms;
}

// Lets `kernel` take up to `smem_max` bytes of dynamic shared memory and
// returns the blocks of it with `threads` threads and `smem` bytes that fit on
// one SM (0 on error, with the error in *err). The attribute belongs to the
// kernel, not to one N, so smem_max is what the largest N needs: a launch
// with N = 16 after a first use at N = 4 still gets its shared memory.
template <typename KernelFn>
int fit_blocks(KernelFn kernel, int threads, size_t smem, size_t smem_max, cudaError_t* err) {
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  int blocks = 0;
  if (*err == cudaSuccess) {
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  }
  return *err == cudaSuccess ? blocks : 0;
}

// Blocks of the T-channel kernel that fit on one SM. `Kernel::prepare(T, N,
// err)` lets that kernel take its dynamic shared memory and asks the
// occupancy; it runs once per device, N and T (the answer does not change),
// so that a launch costs the host no more than a lookup.
template <typename Kernel>
int blocks_per_sm(int dev, int T, int N, cudaError_t* err) {
  static int known[kMaxDevices][kMaxN + 1][kMaxTile + 1];  // blocks + 1; 0: not asked yet
  *err = cudaSuccess;
  int* k = dev < kMaxDevices ? &known[dev][N][T] : nullptr;
  if (k && *k) return *k - 1;
  const int blocks = Kernel::prepare(T, N, err);
  if (k && *err == cudaSuccess) *k = blocks + 1;
  return blocks;
}

// Channels per block, of `tiles` (each at most kMaxTile). Every
// block walks all of L, so a call costs about (waves of blocks) x T channel
// walks, a walk being cheaper the more channels share it; of the tiles that
// divide a group's channels, the one with the fewest channel walks per SM
// slot, the largest on a tie. With dim 192, one group, on 132 SMs with one
// block each: T = 6 at batch 4 (128 blocks, one wave), T = 2 at batch 1 (96).
template <typename Kernel, int NT>
int tile_channels(const int (&tiles)[NT], int batch, int dim, int groups, int N,
                  cudaError_t* err) {
  int dev = 0;
  *err = cudaGetDevice(&dev);
  const int sms = *err == cudaSuccess ? sm_count(dev, err) : 0;
  if (*err != cudaSuccess) return 0;
  const int per_group = dim / groups;
  int best = 0;
  long long best_walks = 0;
  for (int T : tiles) {
    if (per_group % T != 0) continue;
    const long long slots = (long long)sms * blocks_per_sm<Kernel>(dev, T, N, err);
    if (*err != cudaSuccess) return 0;
    if (slots == 0) continue;
    const long long blocks = (long long)batch * (dim / T);
    const long long walks = (blocks + slots - 1) / slots * T;
    if (best == 0 || walks <= best_walks) {
      best = T;
      best_walks = walks;
    }
  }
  if (best == 0) *err = cudaErrorInvalidConfiguration;  // no tile fits an SM
  return best;
}

}  // namespace
