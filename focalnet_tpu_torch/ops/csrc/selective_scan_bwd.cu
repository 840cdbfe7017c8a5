// Selective-scan backward for NVIDIA Hopper (sm_90a), with a plain C interface
// for ctypes (focalnet_tpu_torch/ops/selective_scan_cuda.py).
//
// Replaces the TPU kernel focalnet_tpu/ops/pallas_scan.py::_bwd_kernel. For
// the forward of selective_scan_fwd.cu, per (batch, channel d) and state n,
// with dt = softplus(delta + bias) and a_l = exp(dt_l A[d, n]), it runs the
// adjoint in the direction opposite to the scan:
//     G_l     = C[n, l] dy_l + a_{l+1} G_{l+1}        (l+1: the next item of the scan)
//     du_l    = dt_l sum_n G_l B[n, l] + D_d dy_l
//     ddt_l   = u_l sum_n G_l B[n, l] + sum_n G_l h_{l-1} a_l A[d, n]
//     ddelta  = ddt * sigmoid(delta + bias)           (ddt without softplus)
//     dA[d,n] = sum_{batch, l} G_l h_{l-1} a_l dt_l
//     dB[n,l] = sum_{d of the group} G_l dt_l u_l,   dC[n, l] = sum_{d of group} h_l dy_l
//     dD[d]   = sum_{batch, l} dy_l u_l,             dbias[d] = sum_{batch, l} ddelta_l
// du and ddelta are written in the input dtype; dA, dB, dC, dD, dbias are fp32
// sums into buffers the caller zeroes. Operands as in the forward kernel, plus
// dy (batch, dim, L) fp32 and hchk (batch, dim, n_chunks, N) fp32, the state
// entering each 256-element chunk that the forward kernel saved.
//
// What bounds it on an H100: the data moves once (u, delta, dy, du, ddelta,
// B, C, dB, dC: about 67 MB at L = 16384, dim = 192, N = 16 in fp32, ~20 us at
// 3.35 TB/s), and dim * N * L exponentials go through the special-function
// units (~12 us). This design is simple first and not near that (PERF.md):
// 5 block barriers per chunk, a dependent chain through each lane's items in
// both directions, and dB/dC summed with fp32 atomics by every channel block
// of a group into the same (N, L) plane (192 adds per element at the flagship
// widths), whose order varies from run to run.
//
// Design, mirroring the forward kernel: one block per (batch, channel), one
// warp per state n (N <= 16), chunks of 32 lanes x 8 items = 256 staged in
// shared memory, the adjoint carry in a register. The block walks the chunks
// opposite to the forward scan: last to first for a forward scan, first to
// last under `reverse`. Logical item e of chunk c is position c*256 + e, or
// c*256 + 255 - e under `reverse`, so in logical order the forward scan always
// runs left to right and the adjoint right to left. Per chunk:
//   A. The block loads u, dt, dt*u, dy, sigmoid(delta + bias) and the N rows
//      of B and C coalesced into shared memory. Positions >= L get dt = 0
//      (a = 1, b = 0: the monoid's identity) and dy = u = B = C = 0.
//   B. Warp n rematerialises h inside the chunk from the saved entry state
//      with the forward kernel's lane and shuffle scan, keeping h_{l-1} and
//      h_l per item. Then the adjoint: each lane composes its 8 items' affine
//      maps G_l = C_l dy_l + a_{l+1} G_{l+1} right to left, the warp scans
//      the 32 lane maps from the last lane down with shuffles, and the carry
//      a_first * G_first of the chunk processed before (the next one in scan
//      order) enters at the chunk's last item. Each lane then writes G B and
//      G h_{l-1} a A over the B and C rows (each warp touches only its row)
//      and sums G h_{l-1} a dt for dA in a register.
//   C. The block sums the N rows per element into du and ddelta, stores them
//      coalesced (nothing past L), and sums dy*u and ddelta per thread.
//   D. Warp n writes G dt u and h dy over its rows.
//   E. The block adds the N rows into dB and dC with coalesced atomics.
// At the end dA (one atomic per warp), dD and dbias (block-reduced, one
// atomic each) are added into their buffers; the atomics sum over the batch.
//
// Exponentials: expf and log1pf, as in the forward kernel, so that the
// rematerialised h matches the forward's to rounding.

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename InT>
__global__ void __launch_bounds__(32 * kMaxN, 2)
selective_scan_bwd_kernel(const InT* __restrict__ u, const InT* __restrict__ delta,
                          const float* __restrict__ A, const InT* __restrict__ Bm,
                          const InT* __restrict__ Cm, const float* __restrict__ Dskip,
                          const float* __restrict__ bias, const float* __restrict__ hchk,
                          const float* __restrict__ dy, InT* __restrict__ du,
                          InT* __restrict__ ddelta, float* __restrict__ dA,
                          float* __restrict__ dB, float* __restrict__ dC,
                          float* __restrict__ dD, float* __restrict__ dbias, int dim,
                          int groups, int N, int L, int softplus, int reverse) {
  __shared__ float s_u[kPad];
  __shared__ float s_dt[kPad];
  __shared__ float s_du[kPad];   // dt * u
  __shared__ float s_dy[kPad];
  __shared__ float s_sg[kPad];   // d dt / d delta
  __shared__ float s_B[kMaxN][kPad];  // B, then G B, then G dt u
  __shared__ float s_C[kMaxN][kPad];  // C, then G h_{l-1} a A, then h dy
  __shared__ float s_red[2][kMaxN];

  const int d = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n = tid >> 5;  // warp index == state index
  const int lane = tid & 31;
  const int g = d / (dim / groups);

  const size_t row = ((size_t)b * dim + d) * (size_t)L;
  const size_t bc_rows = ((size_t)b * groups + g) * N * (size_t)L;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const float* h_row = hchk + ((size_t)b * dim + d) * n_chunks * N + n;

  const float A_dn = A[(size_t)d * N + n];
  const float bias_d = bias ? bias[d] : 0.f;
  const float D_d = Dskip ? Dskip[d] : 0.f;

  float gcarry = 0.f;  // a_first * G_first of the chunk processed before
  float dA_acc = 0.f, dD_acc = 0.f, dbias_acc = 0.f;
  const int e0 = lane * kNItems;

  for (int it = n_chunks - 1; it >= 0; --it) {
    const int c = reverse ? n_chunks - 1 - it : it;
    const int base = c * kChunk;

    // A: the chunk's operands into shared memory
    for (int k = tid; k < N * kChunk; k += nthreads) {
      const int m = k / kChunk, e = k % kChunk;
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      const size_t off = bc_rows + (size_t)m * L + p;
      s_B[m][sidx(e)] = p < L ? to_f(Bm[off]) : 0.f;
      s_C[m][sidx(e)] = p < L ? to_f(Cm[off]) : 0.f;
    }
    for (int e = tid; e < kChunk; e += nthreads) {
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      float uv = 0.f, dt = 0.f, dyv = 0.f, sg = 0.f;
      if (p < L) {
        uv = to_f(u[row + p]);
        const float pre = to_f(delta[row + p]) + bias_d;
        dt = pre;
        sg = 1.f;
        if (softplus) {
          dt = pre <= 20.f ? log1pf(expf(pre)) : pre;
          sg = 1.f / (1.f + expf(-pre));
        }
        dyv = dy[row + p];
      }
      const int s = sidx(e);
      s_u[s] = uv;
      s_dt[s] = dt;
      s_du[s] = dt * uv;
      s_dy[s] = dyv;
      s_sg[s] = sg;
    }
    __syncthreads();

    // B: rematerialise h (forward scan of warp n over the chunk)
    float a[kNItems], hp[kNItems], h[kNItems];
#pragma unroll
    for (int i = 0; i < kNItems; ++i) {
      const int s = sidx(e0 + i);
      a[i] = expf(s_dt[s] * A_dn);
      h[i] = s_du[s] * s_B[n][s];  // b_i for now
    }
    float ta = a[0], tb = h[0];
#pragma unroll
    for (int i = 1; i < kNItems; ++i) {
      tb = a[i] * tb + h[i];
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
    float ea = __shfl_up_sync(kFull, ta, 1);
    float eb = __shfl_up_sync(kFull, tb, 1);
    if (lane == 0) {
      ea = 1.f;
      eb = 0.f;
    }
    float hv = ea * h_row[(size_t)c * N] + eb;  // h before this lane's first item
#pragma unroll
    for (int i = 0; i < kNItems; ++i) {
      hp[i] = hv;
      hv = a[i] * hv + h[i];
      h[i] = hv;
    }

    // B: the adjoint, right to left. This lane's map X -> G at its first item,
    // X being G at the next lane's first item (scaled by that item's a); the
    // last lane's X is the carry from the chunk processed before.
    const float a_next = __shfl_down_sync(kFull, a[0], 1);
    const float an = lane == 31 ? 1.f : a_next;
    float P = an;
    float Q = s_C[n][sidx(e0 + kNItems - 1)] * s_dy[sidx(e0 + kNItems - 1)];
#pragma unroll
    for (int i = kNItems - 2; i >= 0; --i) {
      const int s = sidx(e0 + i);
      Q = s_C[n][s] * s_dy[s] + a[i + 1] * Q;
      P = a[i + 1] * P;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // inclusive scan from the last lane
      const float Pn = __shfl_down_sync(kFull, P, off);
      const float Qn = __shfl_down_sync(kFull, Q, off);
      if (lane + off < 32) {
        Q = P * Qn + Q;
        P = P * Pn;
      }
    }
    const float Pl = __shfl_down_sync(kFull, P, 1);
    const float Ql = __shfl_down_sync(kFull, Q, 1);
    float G = lane == 31 ? gcarry : Pl * gcarry + Ql;  // X of this lane
    float Gs[kNItems];
#pragma unroll
    for (int i = kNItems - 1; i >= 0; --i) {
      const int s = sidx(e0 + i);
      G = s_C[n][s] * s_dy[s] + (i == kNItems - 1 ? an : a[i + 1]) * G;
      Gs[i] = G;
      const float gha = G * hp[i] * a[i];
      s_B[n][s] *= G;
      s_C[n][s] = gha * A_dn;
      dA_acc += gha * s_dt[s];
    }
    gcarry = __shfl_sync(kFull, a[0] * Gs[0], 0);
    __syncthreads();

    // C: du, ddelta per element; dD and dbias partial sums
    for (int e = tid; e < kChunk; e += nthreads) {
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      if (p < L) {
        const int s = sidx(e);
        float gb = 0.f, gaa = 0.f;
        for (int k = 0; k < N; ++k) {
          gb += s_B[k][s];
          gaa += s_C[k][s];
        }
        const float ddt = s_u[s] * gb + gaa;
        const float dd = ddt * s_sg[s];
        du[row + p] = from_f<InT>(s_dt[s] * gb + D_d * s_dy[s]);
        ddelta[row + p] = from_f<InT>(dd);
        dD_acc += s_dy[s] * s_u[s];
        dbias_acc += dd;
      }
    }
    __syncthreads();

    // D: this warp's dB and dC terms over its rows
#pragma unroll
    for (int i = 0; i < kNItems; ++i) {
      const int s = sidx(e0 + i);
      s_B[n][s] = Gs[i] * s_du[s];
      s_C[n][s] = h[i] * s_dy[s];
    }
    __syncthreads();

    // E: dB, dC summed over the group's channels
    for (int k = tid; k < N * kChunk; k += nthreads) {
      const int m = k / kChunk, e = k % kChunk;
      const int p = reverse ? base + kChunk - 1 - e : base + e;
      if (p < L) {
        const size_t off = bc_rows + (size_t)m * L + p;
        atomicAdd(dB + off, s_B[m][sidx(e)]);
        atomicAdd(dC + off, s_C[m][sidx(e)]);
      }
    }
    __syncthreads();  // shared rows are rewritten by the next chunk
  }

  dA_acc = warp_sum(dA_acc);
  if (lane == 0) atomicAdd(dA + (size_t)d * N + n, dA_acc);
  dD_acc = warp_sum(dD_acc);
  dbias_acc = warp_sum(dbias_acc);
  if (lane == 0) {
    s_red[0][n] = dD_acc;
    s_red[1][n] = dbias_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float sd = 0.f, sb = 0.f;
    for (int k = 0; k < N; ++k) {
      sd += s_red[0][k];
      sb += s_red[1][k];
    }
    if (dD) atomicAdd(dD + d, sd);
    if (dbias) atomicAdd(dbias + d, sb);
  }
}

template <typename InT>
cudaError_t launch(const void* u, const void* delta, const float* A, const void* B,
                   const void* C, const float* Dskip, const float* bias, const float* hchk,
                   const float* dy, void* du, void* ddelta, float* dA, float* dB, float* dC,
                   float* dD, float* dbias, int batch, int dim, int groups, int N, int L,
                   int softplus, int reverse, cudaStream_t stream) {
  const dim3 grid(dim, batch);
  const dim3 block(32 * N);
  selective_scan_bwd_kernel<InT><<<grid, block, 0, stream>>>(
      static_cast<const InT*>(u), static_cast<const InT*>(delta), A,
      static_cast<const InT*>(B), static_cast<const InT*>(C), Dskip, bias, hchk, dy,
      static_cast<InT*>(du), static_cast<InT*>(ddelta), dA, dB, dC, dD, dbias, dim, groups,
      N, L, softplus, reverse);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int focalnet_selective_scan_bwd_max_dstate() { return kMaxN; }

const char* focalnet_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// dA, dB, dC and the non-null dD, dbias must be zeroed by the caller: the
// kernel adds into them. Null Dskip / bias: no skip, no bias; null dD /
// dbias: that gradient is not summed.
int focalnet_selective_scan_bwd(const void* u, const void* delta, const void* A,
                                const void* B, const void* C, const void* Dskip,
                                const void* bias, const void* hchk, const void* dy, void* du,
                                void* ddelta, void* dA, void* dB, void* dC, void* dD,
                                void* dbias, int batch, int dim, int groups, int dstate,
                                int L, int softplus, int reverse, int in_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || dim < 1 || groups < 1 || dim % groups != 0 ||
      dstate < 1 || dstate > kMaxN || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dskip);
  const float* bf = static_cast<const float*>(bias);
  const float* hc = static_cast<const float*>(hchk);
  const float* dyf = static_cast<const float*>(dy);
  float* dAf = static_cast<float*>(dA);
  float* dBf = static_cast<float*>(dB);
  float* dCf = static_cast<float*>(dC);
  float* dDf = static_cast<float*>(dD);
  float* dbf = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      in_bf16 ? launch<__nv_bfloat16>(u, delta, Af, B, C, Df, bf, hc, dyf, du, ddelta, dAf,
                                      dBf, dCf, dDf, dbf, batch, dim, groups, dstate, L,
                                      softplus, reverse, s)
              : launch<float>(u, delta, Af, B, C, Df, bf, hc, dyf, du, ddelta, dAf, dBf, dCf,
                              dDf, dbf, batch, dim, groups, dstate, L, softplus, reverse, s);
  return static_cast<int>(err);
}

}  // extern "C"
