// fp32 FMA-rate probe for NVIDIA Hopper (sm_90a), with a plain C interface
// for ctypes (focalnet_tpu_torch/ops/fma_passes.py).
//
// Replaces the TPU kernel benchmarks/vpu_probe.py::make_pass_kernel.<locals>.body,
// the VPU-ceiling probe: P = 8 * n_loop dependent passes over every element,
//     acc = x;  repeat n_loop times: for i in 0..7: acc = acc * c_i + x
// with c_i = fp32(1 + 1e-6 * (i + 1)), the double rounded once to float as
// JAX rounds its weak-typed Python floats. One pass is one FFMA here
// (fmaf: a single rounding); the plain version rounds the product and the
// sum apart, so the two agree to a tolerance, not bit for bit.
//
// What bounds it on an H100: 2 * P * E fp32 operations at 128 FMA lanes per
// SM per clock (66.9 TFLOP/s at 132 SMs and 1980 MHz) against 8 * E bytes
// moved once (x read, y written) at 3.35 TB/s: the bytes bound it up to
// P = 80, the operations from there on, whatever E. The point of the kernel
// is to reach the operations bound, so that the difference of two large P
// measures the card's FMA rate.
//
// Design: a flat grid over the E elements; each thread loads one float4
// (coalesced, 16 bytes a thread), runs the 8 * n_loop dependent FMAs on each
// of its 4 elements as 4 independent chains (ILP 4 against the FMA latency,
// with many warps an SM besides), and stores one float4. The TPU kernel's
// (1, 1, 64, 2048) blocks have no counterpart: the work is elementwise.
// n_loop is a runtime argument, so the compiler cannot fold the chain; with
// no fast-math flag it does not reassociate it either (a measured rate above
// the SMs' peak would show that it did). Pointers that are not 16-byte
// aligned, and the last E % 4 elements, take the same chain one float at a
// time.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// c_i = fp32(1 + 1e-6 * (i + 1)), i = 0..7: the double is formed as Python
// forms it and rounded to the nearest float once
constexpr float kC0 = static_cast<float>(1.0 + 1e-6 * 1);
constexpr float kC1 = static_cast<float>(1.0 + 1e-6 * 2);
constexpr float kC2 = static_cast<float>(1.0 + 1e-6 * 3);
constexpr float kC3 = static_cast<float>(1.0 + 1e-6 * 4);
constexpr float kC4 = static_cast<float>(1.0 + 1e-6 * 5);
constexpr float kC5 = static_cast<float>(1.0 + 1e-6 * 6);
constexpr float kC6 = static_cast<float>(1.0 + 1e-6 * 7);
constexpr float kC7 = static_cast<float>(1.0 + 1e-6 * 8);

// one pass: a = a * c + v, one FFMA per element
__device__ __forceinline__ void pass(float& a, float v, float c) { a = fmaf(a, c, v); }
__device__ __forceinline__ void pass(float4& a, const float4& v, float c) {
  a.x = fmaf(a.x, c, v.x);
  a.y = fmaf(a.y, c, v.y);
  a.z = fmaf(a.z, c, v.z);
  a.w = fmaf(a.w, c, v.w);
}

// the 8 * n_loop dependent passes; a float4 carries 4 independent chains
template <typename T>
__device__ __forceinline__ T chain(const T& v, int n_loop) {
  T a = v;
  for (int l = 0; l < n_loop; ++l) {
    pass(a, v, kC0);
    pass(a, v, kC1);
    pass(a, v, kC2);
    pass(a, v, kC3);
    pass(a, v, kC4);
    pass(a, v, kC5);
    pass(a, v, kC6);
    pass(a, v, kC7);
  }
  return a;
}

// one float4 per thread
__global__ void __launch_bounds__(kThreads)
fma_passes_vec4(const float4* __restrict__ x, float4* __restrict__ y,
                long long n_vec, int n_loop) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  y[i] = chain(x[i], n_loop);
}

// one float per thread, from element `start` on
__global__ void __launch_bounds__(kThreads)
fma_passes_scalar(const float* __restrict__ x, float* __restrict__ y,
                  long long start, long long n, int n_loop) {
  const long long i = start + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  y[i] = chain(x[i], n_loop);
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* focalnet_fma_passes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y = the 8 * n_loop passes over the n fp32 elements of x (x and y distinct,
// contiguous, on the current device). Launches on `stream`, writes the number
// of kernels launched (0, 1 or 2) to *launched and returns cudaGetLastError()
// (0 = launched).
int focalnet_fma_passes(const void* x, void* y, long long n, int n_loop, void* stream,
                        int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const long long n_vec = aligned ? n / 4 : 0;
  if (n_vec > 0) {
    fma_passes_vec4<<<blocks_for(n_vec), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<float4*>(y), n_vec, n_loop);
    ++*launched;
  }
  const long long rest = n - 4 * n_vec;
  if (rest > 0) {
    fma_passes_scalar<<<blocks_for(rest), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), 4 * n_vec, n, n_loop);
    ++*launched;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
