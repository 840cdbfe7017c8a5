// Selective-scan forward for NVIDIA Hopper (sm_90a), with a plain C interface
// for ctypes (focalnet_tpu_torch/ops/selective_scan_cuda.py).
//
// Replaces the TPU kernel focalnet_tpu/ops/pallas_scan.py::_fwd_kernel. Per
// (batch, channel d) and state n:
//     dt_l = softplus(delta_l + bias_d)            (softplus optional)
//     h_l  = exp(dt_l * A[d, n]) * h_{l-1} + dt_l * u_l * B[n, l]
//     y_l  = sum_n C[n, l] * h_l + D_d * u_l (+ y_accum_l)
// With `reverse` the recurrence runs right to left (h_l depends on h_{l+1}).
// The state and every sum are fp32; inputs are fp32 or bf16, y is fp32 or
// bf16. Operands are plain L-contiguous: u, delta, y, y_accum (batch, dim, L);
// A (dim, N); B, C (batch, G, N, L); D, bias (dim,). The TPU kernel's chunk
// interleave and VMEM tile sizing have no counterpart here. For training,
// the kernel also writes the fp32 state entering each 256-element chunk,
// hchk (batch, dim, n_chunks, N) (the TPU kernel's hchk_ref): the backward
// kernel (selective_scan_bwd.cu) rematerialises h from it. A NULL hchk
// (serving) writes nothing.
//
// What bounds it on an H100: the data moves once (u, delta, y, B, C: about
// 40 MB at L = 16384, dim = 192, N = 16 in fp32, ~12 us at 3.35 TB/s), and
// dim * N * L exponentials go through the special-function units (50 M at
// that shape, ~12 us at 16 per clock per SM). This design runs at about 25x
// that (PERF.md): it is bound by latency, with 3 block barriers per
// 256-element chunk and a dependent chain through each lane's items.
//
// Design: one block per (batch, channel), one warp per state n (N <= 16, so
// at most 512 threads), walking L in chunks of 32 lanes x 8 items = 256.
//   A. The block loads the chunk's u, delta and the N rows of B and C
//      coalesced into shared memory, forming dt and dt*u once per element.
//      Rows are padded by one word per 8, so the per-lane reads of 8
//      consecutive items hit 32 distinct banks.
//   B. Warp n: each lane scans its 8 consecutive items sequentially over the
//      monoid (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2), the warp scans the 32
//      lane aggregates with shuffles, the carry from the previous chunk (held
//      in a register, equal in every lane) enters as the warp's prefix, and a
//      second sequential pass writes C_n * h over C_n in shared memory.
//   C. The block sums the N rows per element, adds D*u and y_accum, casts
//      and stores coalesced.
// `reverse` maps logical item e of chunk c to position c*256 + 255 - e and
// walks the chunks from the last: the same code scans right to left. The
// ragged tail needs no padding: positions >= L get dt = 0 (a = 1, b = 0, the
// monoid's identity), load nothing and store nothing.
// Since warps scan different states, the card gets N warps per channel
// (3,072 warps for dim = 192); at most 64 registers a thread keep two blocks
// on an SM, so 192 channel blocks run in one wave. B and C are re-read by
// every channel of a group, from L2.
// (A first design with 16 items a lane, each lane loading its own B/C items
// strided from global memory, ran at 127 registers, one block per SM and
// about 1.5x the time; PERF.md has both.)
//
// Exponentials: expf and log1pf (not __expf): at most 2 ulp each, so the
// kernel agrees with the plain fp32 version far inside the fp32 tolerance
// used for it (rtol 6e-4, atol 2e-3); with fast-math __expf the relative
// error of exp(dt*A) grows with |dt*A| and would need its own bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kNItems = 8;                         // consecutive items per lane
constexpr int kChunk = 32 * kNItems;               // items per chunk (256)
constexpr int kPad = kChunk + kChunk / kNItems;    // padded shared row
constexpr int kMaxN = 16;                          // states: one warp each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int sidx(int e) { return e + e / kNItems; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(32 * kMaxN, 2)
selective_scan_fwd_kernel(const InT* __restrict__ u, const InT* __restrict__ delta,
                          const float* __restrict__ A, const InT* __restrict__ Bm,
                          const InT* __restrict__ Cm, const float* __restrict__ Dskip,
                          const float* __restrict__ bias, const OutT* __restrict__ yacc,
                          OutT* __restrict__ y, float* __restrict__ hchk, int dim,
                          int groups, int N, int L, int softplus, int reverse) {
  __shared__ float s_u[kPad];
  __shared__ float s_dt[kPad];
  __shared__ float s_du[kPad];
  __shared__ float s_B[kMaxN][kPad];
  __shared__ float s_C[kMaxN][kPad];  // C, then C * h

  const int d = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n = tid >> 5;  // warp index == state index
  const int lane = tid & 31;
  const int g = d / (dim / groups);

  const size_t row = ((size_t)b * dim + d) * (size_t)L;
  const InT* u_row = u + row;
  const InT* dl_row = delta + row;
  OutT* y_row = y + row;
  const OutT* yacc_row = yacc ? yacc + row : nullptr;
  const size_t bc_rows = ((size_t)b * groups + g) * N * (size_t)L;
  const InT* B_rows = Bm + bc_rows;  // N rows of L
  const InT* C_rows = Cm + bc_rows;

  const float A_dn = A[(size_t)d * N + n];
  const float bias_d = bias ? bias[d] : 0.f;
  const float D_d = Dskip ? Dskip[d] : 0.f;

  const int n_chunks = (L + kChunk - 1) / kChunk;
  float carry = 0.f;  // h_n entering the chunk, the same in every lane of warp n
  float* hchk_row = hchk ? hchk + ((size_t)b * dim + d) * n_chunks * N + n : nullptr;

  for (int it = 0; it < n_chunks; ++it) {
    const int c = reverse ? n_chunks - 1 - it : it;
    const int base = c * kChunk;
    if (hchk_row && lane == 0) hchk_row[(size_t)c * N] = carry;

    // A: u, dt, dt*u and the N rows of B and C of the chunk into shared memory
    for (int k = tid; k < N * kChunk; k += nthreads) {
      const int m = k / kChunk, e = k % kChunk;
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      const size_t off = (size_t)m * L + p;
      s_B[m][sidx(e)] = p < L ? to_f(B_rows[off]) : 0.f;
      s_C[m][sidx(e)] = p < L ? to_f(C_rows[off]) : 0.f;
    }
    for (int e = tid; e < kChunk; e += nthreads) {
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      float uv = 0.f, dt = 0.f;
      if (p < L) {
        uv = to_f(u_row[p]);
        dt = to_f(dl_row[p]) + bias_d;
        if (softplus) dt = dt <= 20.f ? log1pf(expf(dt)) : dt;
      }
      const int s = sidx(e);
      s_u[s] = uv;
      s_dt[s] = dt;
      s_du[s] = dt * uv;
    }
    __syncthreads();

    // B: warp n scans state n over the chunk
    float a[kNItems], bb[kNItems];
    const int e0 = lane * kNItems;
#pragma unroll
    for (int i = 0; i < kNItems; ++i) {
      const int s = sidx(e0 + i);
      a[i] = expf(s_dt[s] * A_dn);
      bb[i] = s_du[s] * s_B[n][s];
    }
    float ta = a[0], tb = bb[0];  // this lane's aggregate
#pragma unroll
    for (int i = 1; i < kNItems; ++i) {
      tb = a[i] * tb + bb[i];
      ta = a[i] * ta;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // inclusive scan over lanes
      const float ap = __shfl_up_sync(kFull, ta, off);
      const float bp = __shfl_up_sync(kFull, tb, off);
      if (lane >= off) {
        tb = ta * bp + tb;
        ta = ta * ap;
      }
    }
    float ea = __shfl_up_sync(kFull, ta, 1);  // exclusive prefix of this lane
    float eb = __shfl_up_sync(kFull, tb, 1);
    if (lane == 0) {
      ea = 1.f;
      eb = 0.f;
    }
    const float wa = __shfl_sync(kFull, ta, 31);  // the whole chunk
    const float wb = __shfl_sync(kFull, tb, 31);
    float h = ea * carry + eb;
#pragma unroll
    for (int i = 0; i < kNItems; ++i) {
      const int s = sidx(e0 + i);
      h = a[i] * h + bb[i];
      s_C[n][s] *= h;
    }
    carry = wa * carry + wb;
    __syncthreads();

    // C: y = sum_n C h + D u (+ y_accum), coalesced store
    for (int e = tid; e < kChunk; e += nthreads) {
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      if (p < L) {
        const int s = sidx(e);
        float acc = 0.f;
        for (int k = 0; k < N; ++k) acc += s_C[k][s];
        acc += D_d * s_u[s];
        if (yacc_row) acc += to_f(yacc_row[p]);
        y_row[p] = from_f<OutT>(acc);
      }
    }
    __syncthreads();  // shared rows are rewritten by the next chunk
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* u, const void* delta, const float* A, const void* B,
                   const void* C, const float* Dskip, const float* bias, const void* yacc,
                   void* y, float* hchk, int batch, int dim, int groups, int N, int L,
                   int softplus, int reverse, cudaStream_t stream) {
  const dim3 grid(dim, batch);
  const dim3 block(32 * N);
  selective_scan_fwd_kernel<InT, OutT><<<grid, block, 0, stream>>>(
      static_cast<const InT*>(u), static_cast<const InT*>(delta), A,
      static_cast<const InT*>(B), static_cast<const InT*>(C), Dskip, bias,
      static_cast<const OutT*>(yacc), static_cast<OutT*>(y), hchk, dim, groups, N, L,
      softplus, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int focalnet_selective_scan_max_dstate() { return kMaxN; }

const char* focalnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// Null Dskip / bias / yacc mean: no skip, no bias, nothing to accumulate;
// a null hchk: no chunk states.
int focalnet_selective_scan_fwd(const void* u, const void* delta, const void* A,
                                const void* B, const void* C, const void* Dskip,
                                const void* bias, const void* yacc, void* y, void* hchk,
                                int batch, int dim, int groups, int dstate, int L,
                                int softplus, int reverse, int in_bf16, int out_bf16,
                                void* stream) {
  if (batch < 1 || batch > 65535 || dim < 1 || groups < 1 || dim % groups != 0 ||
      dstate < 1 || dstate > kMaxN || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dskip);
  const float* bf = static_cast<const float*>(bias);
  float* hc = static_cast<float*>(hchk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(u, delta, Af, B, C, Df, bf, yacc, y, hc,
                                                          batch, dim, groups, dstate, L,
                                                          softplus, reverse, s)
                   : launch<__nv_bfloat16, float>(u, delta, Af, B, C, Df, bf, yacc, y, hc, batch,
                                                  dim, groups, dstate, L, softplus, reverse, s);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(u, delta, Af, B, C, Df, bf, yacc, y, hc, batch,
                                                  dim, groups, dstate, L, softplus, reverse, s)
                   : launch<float, float>(u, delta, Af, B, C, Df, bf, yacc, y, hc, batch, dim,
                                          groups, dstate, L, softplus, reverse, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
