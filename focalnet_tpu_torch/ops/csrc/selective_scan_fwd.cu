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
// The segment API (the TPU kernel's with_state branch): a non-null h0
// (batch, dim, N) fp32 seeds the state instead of zeros, and so also the
// chunk states; a non-null h_last (batch, dim, N) fp32 receives the state
// after the last item in scan order (position L-1, or 0 under `reverse`).
// The ragged tail's items are the monoid's identity (see below), so the
// carry that leaves the last chunk is that state. The sequence-sharded scan
// (focalnet_tpu_torch/parallel/seq_scan.py) chains segments with it. Null
// h0 and h_last keep the plain scan's code path and results.
//
// What bounds it on an H100: the data moves once (u, delta, y, B, C: about
// 40 MB at L = 16384, dim = 192, N = 16 in fp32, ~12 us at 3.35 TB/s), and
// dim * N * L exponentials go through the special-function units (50 M at
// that shape, ~12 us at 16 per clock per SM): at batch 1 the larger of the
// two is 0.0120 ms, at batch 4 with chunk states 0.0485 ms. The first design
// (one block per (batch, channel), synchronous loads) ran at 21x and 16x
// that: 0.254-0.258 ms at batch 1, 0.761 ms at batch 4. Taking parts of its
// work out (PERF.md, K1's split) showed where the time went: B and C staged
// again by every channel, about a quarter of it (26-29%); the element-by-
// element loads of u and delta, 6-10%; the walk itself, with its 3 barriers
// per chunk and synchronous loads, the rest.
//
// Design: one block per (batch, tile of T channels of one group), one warp
// per state n (N <= 16), walking L in chunks of 32 lanes x 8 items = 256. A
// tile never straddles two groups. T is chosen at launch (scan_common.cuh,
// tile_channels) by waves of blocks on the card's SMs: T = 2 at batch 1
// (96 blocks), T = 6 at batch 4 (128 blocks, one wave), dim 192 on 132 SMs.
// Per chunk:
//   A. The chunk's operands have arrived in shared memory (copied during the
//      chunk before, see E): the block forms dt, dt*u and D*u + y_accum for
//      the tile's rows once per element, and warp n takes its lanes' 8 items
//      of row n of B and C into registers, once for the tile: B and C are
//      read once per T channels.
//   E. Every thread issues cp.async copies of the next chunk's u, delta,
//      y_accum rows and the group's B, C rows, 16 bytes each, which arrive
//      while B and C run: no step waits on global memory.
//   B. Warp n scans state n of the tile's T channels as T independent
//      chains: each lane scans its 8 consecutive items sequentially over the
//      monoid (a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2), the warp scans the
//      32 lane aggregates with shuffles, each channel's carry from the
//      previous chunk (a register, equal in every lane) enters as the warp's
//      prefix, and a second pass writes C_n * h into the warp's rows of a
//      shared (T, N, 256) block.
//   C. After one barrier, the block sums the N rows per element (all threads
//      take elements), adds D*u + y_accum, casts and stores coalesced
//      (nothing past L).
// So per chunk the block takes 3 barriers for T channels (the first design
// took 3 per channel) and reads B and C once. The T chains in flight hide
// the latency of each chain's shuffles where one block of 16 warps holds an
// SM; scanning the channels one after another, with the sum of one channel
// double-buffered against the scan of the next (T + 2 barriers, as the
// backward kernel does), was slower at batch 1 and 4 (PERF.md).
// `reverse` maps logical item e of chunk c to position c*256 + 255 - e and
// walks the chunks from the last: the same code scans right to left. The
// ragged tail needs no padding: positions >= L stage zeros and get dt = 0
// (a = 1, b = 0, the monoid's identity), and nothing is stored there. Rows
// whose length or base is not 16-byte aligned are copied with plain loads
// instead of cp.async.
//
// Exponentials: expf and log1pf (not __expf): at most 2 ulp each, so the
// kernel agrees with the plain fp32 version far inside the fp32 tolerance
// used for it (rtol 6e-4, atol 2e-3), and the backward kernel, which
// rematerialises h with the same operations, matches it to rounding.

#include "scan_common.cuh"

namespace {

// Rows of the 256 items of a chunk in shared memory are padded by 4 words
// per 32 (kPad words in all): a lane's 8 consecutive items are then two
// aligned float4 that the warp reads or writes without bank conflicts, and
// 32 consecutive items hit 32 distinct banks.
__device__ __forceinline__ int vidx(int e) { return e + (e >> 5) * 4; }
__device__ __forceinline__ void store8(float* q, const float v[kNItems]) {
  reinterpret_cast<float4*>(q)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(q)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename InT, typename OutT, int T>
__global__ void __launch_bounds__(32 * kMaxN, 1)
selective_scan_fwd_kernel(const InT* __restrict__ u, const InT* __restrict__ delta,
                          const float* __restrict__ A, const InT* __restrict__ Bm,
                          const InT* __restrict__ Cm, const float* __restrict__ Dskip,
                          const float* __restrict__ bias, const OutT* __restrict__ yacc,
                          OutT* __restrict__ y, float* __restrict__ hchk,
                          const float* __restrict__ h0, float* __restrict__ hlast, int dim,
                          int groups, int N, int L, int softplus, int reverse, int vec) {
  // dynamic, fp32: s_ch [T][N][kPad] (C h per channel and state), the
  // tile's rows s_dt, s_du, s_y [T][kPad] (dt, dt u, D u + y_accum); then the
  // next chunk's operands as they arrive from global memory: r_B, r_C
  // [N][256] and r_u, r_delta [T][256] (InT), r_yacc [T][256] (OutT)
  extern __shared__ __align__(16) float smem[];
  float* s_ch = smem;
  float* s_dt = s_ch + T * N * kPad;
  float* s_du = s_dt + T * kPad;
  float* s_y = s_du + T * kPad;
  InT* r_B = reinterpret_cast<InT*>(s_y + T * kPad);
  InT* r_C = r_B + N * kChunk;
  InT* r_u = r_C + N * kChunk;
  InT* r_delta = r_u + T * kChunk;
  OutT* r_yacc = reinterpret_cast<OutT*>(r_delta + T * kChunk);

  const int d0 = blockIdx.x * T;  // the tile's first channel
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n = tid >> 5;  // warp index == state index
  const int lane = tid & 31;
  const int g = d0 / (dim / groups);

  const size_t row0 = ((size_t)b * dim + d0) * (size_t)L;  // channel d0 + t: row0 + t L
  const size_t bc0 = ((size_t)b * groups + g) * N * (size_t)L;  // the group's B, C rows
  const int n_chunks = (L + kChunk - 1) / kChunk;
  float* h_tile = hchk ? hchk + ((size_t)b * dim + d0) * n_chunks * N : nullptr;

  // The operands of chunk c, asynchronously: the group's N rows of B and C,
  // the T channels' u, delta and y_accum rows, in 16-byte units spread over
  // all threads.
  constexpr int kUnitsIn = kChunk * sizeof(InT) / 16, kUnitsOut = kChunk * sizeof(OutT) / 16;
  auto prefetch = [&](int c) {
    const int base = c * kChunk;
    for (int k = tid; k < 2 * N * kUnitsIn; k += nthreads) {  // B, then C
      const int r = k / kUnitsIn, off = (k % kUnitsIn) * (16 / (int)sizeof(InT));
      const int m = r < N ? r : r - N;
      stage_unit((r < N ? r_B : r_C) + m * kChunk + off,
                 (r < N ? Bm : Cm) + bc0 + (size_t)m * L, base + off, L, vec);
    }
    for (int k = tid; k < 2 * T * kUnitsIn; k += nthreads) {  // u, then delta
      const int r = k / kUnitsIn, off = (k % kUnitsIn) * (16 / (int)sizeof(InT));
      const int t = r < T ? r : r - T;
      stage_unit((r < T ? r_u : r_delta) + t * kChunk + off,
                 (r < T ? u : delta) + row0 + (size_t)t * L, base + off, L, vec);
    }
    if (yacc) {
      for (int k = tid; k < T * kUnitsOut; k += nthreads) {
        const int t = k / kUnitsOut, off = (k % kUnitsOut) * (16 / (int)sizeof(OutT));
        stage_unit(r_yacc + t * kChunk + off, yacc + row0 + (size_t)t * L, base + off, L, vec);
      }
    }
    cp_async_commit();
  };

  float A_n[T], carry[T];  // carry: h_n entering the chunk, the same in every lane
  const size_t state0 = ((size_t)b * dim + d0) * N + n;  // channel d0 + t: state0 + t N
#pragma unroll
  for (int t = 0; t < T; ++t) {
    A_n[t] = A[(size_t)(d0 + t) * N + n];
    carry[t] = h0 ? h0[state0 + (size_t)t * N] : 0.f;
  }
  const int e0 = lane * kNItems;
  const int s0 = vidx(e0);  // this lane's items in a padded row

  prefetch(reverse ? n_chunks - 1 : 0);
  for (int it = 0; it < n_chunks; ++it) {
    const int c = reverse ? n_chunks - 1 - it : it;
    const int base = c * kChunk;

    // A: this chunk's operands have arrived (and the last chunk's step C is
    // done with the rows): dt, dt u and D u + y_accum into the rows, and this
    // warp's B, C items into registers
    cp_async_wait_all();
    __syncthreads();
    for (int k = tid; k < T * kChunk; k += nthreads) {
      const int t = k / kChunk, e = k % kChunk;
      const int q = reverse ? kChunk - 1 - e : e;  // memory order within the chunk
      float uv = 0.f, dt = 0.f, yv = 0.f;
      if (base + q < L) {
        uv = to_f(r_u[t * kChunk + q]);
        dt = to_f(r_delta[t * kChunk + q]) + (bias ? bias[d0 + t] : 0.f);
        if (softplus) dt = dt <= 20.f ? log1pf(expf(dt)) : dt;
        yv = (Dskip ? Dskip[d0 + t] : 0.f) * uv;
        if (yacc) yv += to_f(r_yacc[t * kChunk + q]);
      }
      const int s = t * kPad + vidx(e);
      s_dt[s] = dt;
      s_du[s] = dt * uv;
      s_y[s] = yv;
    }
    float Bv[kNItems], Cv[kNItems];
    chunk_items(r_B + n * kChunk, e0, reverse, Bv);
    chunk_items(r_C + n * kChunk, e0, reverse, Cv);
    __syncthreads();
    // E: the next chunk's operands arrive while this one is computed
    if (it + 1 < n_chunks) prefetch(reverse ? c - 1 : c + 1);
    if (h_tile && lane == 0) {
#pragma unroll
      for (int t = 0; t < T; ++t) h_tile[((size_t)t * n_chunks + c) * N + n] = carry[t];
    }

    // B: warp n scans state n of the T channels as T independent chains
    float a[T][kNItems], bb[T][kNItems], ta[T], tb[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float dtv[kNItems], duv[kNItems];
      load8(s_dt + t * kPad + s0, dtv);
      load8(s_du + t * kPad + s0, duv);
#pragma unroll
      for (int i = 0; i < kNItems; ++i) {
        a[t][i] = expf(dtv[i] * A_n[t]);
        bb[t][i] = duv[i] * Bv[i];
      }
      ta[t] = a[t][0];  // this lane's aggregate
      tb[t] = bb[t][0];
#pragma unroll
      for (int i = 1; i < kNItems; ++i) {
        tb[t] = a[t][i] * tb[t] + bb[t][i];
        ta[t] = a[t][i] * ta[t];
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {  // inclusive scan over lanes
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float ap = __shfl_up_sync(kFull, ta[t], off);
        const float bp = __shfl_up_sync(kFull, tb[t], off);
        if (lane >= off) {
          tb[t] = ta[t] * bp + tb[t];
          ta[t] = ta[t] * ap;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      float ea = __shfl_up_sync(kFull, ta[t], 1);  // exclusive prefix of this lane
      float eb = __shfl_up_sync(kFull, tb[t], 1);
      if (lane == 0) {
        ea = 1.f;
        eb = 0.f;
      }
      const float wa = __shfl_sync(kFull, ta[t], 31);  // the whole chunk
      const float wb = __shfl_sync(kFull, tb[t], 31);
      float h = ea * carry[t] + eb, ch_v[kNItems];
#pragma unroll
      for (int i = 0; i < kNItems; ++i) {
        h = a[t][i] * h + bb[t][i];
        ch_v[i] = Cv[i] * h;
      }
      store8(s_ch + (t * N + n) * kPad + s0, ch_v);
      carry[t] = wa * carry[t] + wb;
    }
    __syncthreads();

    // C: y of the T channels
    for (int k = tid; k < T * kChunk; k += nthreads) {
      const int t = k / kChunk, e = k % kChunk;
      const int q = reverse ? kChunk - 1 - e : e;
      if (base + q < L) {
        const int s = vidx(e);
        const float* rows = s_ch + t * N * kPad + s;
        float acc[2] = {0.f, 0.f};  // two chains of adds, even and odd states
#pragma unroll
        for (int m = 0; m < kMaxN; ++m) {
          if (m < N) acc[m & 1] += rows[m * kPad];
        }
        y[row0 + (size_t)t * L + base + q] = from_f<OutT>(acc[0] + acc[1] + s_y[t * kPad + s]);
      }
    }
  }
  if (hlast && lane == 0) {
#pragma unroll
    for (int t = 0; t < T; ++t) hlast[state0 + (size_t)t * N] = carry[t];
  }
}

template <typename InT, typename OutT>
size_t smem_bytes(int T, int N) {
  const size_t floats = (size_t)(T * N + 3 * T) * kPad;
  return floats * sizeof(float) + (size_t)(2 * N + 2 * T) * kChunk * sizeof(InT) +
         (size_t)T * kChunk * sizeof(OutT);
}

// Lets the kernel for T take its dynamic shared memory; returns the blocks
// of it that fit on one SM (0 on error, with the error in *err).
template <typename InT, typename OutT, int T>
int prepare_kernel(int N, cudaError_t* err) {
  return fit_blocks(selective_scan_fwd_kernel<InT, OutT, T>, 32 * N, smem_bytes<InT, OutT>(T, N),
                    smem_bytes<InT, OutT>(T, kMaxN), err);
}

constexpr int kFwdTiles[] = {1, 2, 3, 4, 6};  // channels per block that are built

// The tile rule's view of this kernel (scan_common.cuh, tile_channels)
template <typename InT, typename OutT>
struct FwdTiles {
  static int prepare(int T, int N, cudaError_t* err) {
    switch (T) {
      case 6: return prepare_kernel<InT, OutT, 6>(N, err);
      case 4: return prepare_kernel<InT, OutT, 4>(N, err);
      case 3: return prepare_kernel<InT, OutT, 3>(N, err);
      case 2: return prepare_kernel<InT, OutT, 2>(N, err);
      default: return prepare_kernel<InT, OutT, 1>(N, err);
    }
  }
};

int last_tile = 0;  // the tile of the last launch

template <typename InT, typename OutT, int T>
cudaError_t launch_tile(const void* u, const void* delta, const float* A, const void* B,
                        const void* C, const float* Dskip, const float* bias, const void* yacc,
                        void* y, float* hchk, const float* h0, float* hlast, int batch, int dim,
                        int groups, int N, int L, int softplus, int reverse,
                        cudaStream_t stream) {
  // 16-byte copies: rows of L elements stay aligned when L is a multiple of
  // the elements in 16 bytes, and the bases are
  const int vec = L % 8 == 0 && aligned16(u) && aligned16(delta) && aligned16(B) &&
                  aligned16(C) && aligned16(yacc);
  const dim3 grid(dim / T, batch);
  const dim3 block(32 * N);
  selective_scan_fwd_kernel<InT, OutT, T><<<grid, block, smem_bytes<InT, OutT>(T, N), stream>>>(
      static_cast<const InT*>(u), static_cast<const InT*>(delta), A,
      static_cast<const InT*>(B), static_cast<const InT*>(C), Dskip, bias,
      static_cast<const OutT*>(yacc), static_cast<OutT*>(y), hchk, h0, hlast, dim, groups, N,
      L, softplus, reverse, vec);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch(const void* u, const void* delta, const float* A, const void* B,
                   const void* C, const float* Dskip, const float* bias, const void* yacc,
                   void* y, float* hchk, const float* h0, float* hlast, int batch, int dim,
                   int groups, int N, int L, int softplus, int reverse, cudaStream_t stream) {
  cudaError_t err;
  const int T = tile_channels<FwdTiles<InT, OutT>>(kFwdTiles, batch, dim, groups, N, &err);
  if (err != cudaSuccess) return err;
  last_tile = T;
#define FOCALNET_LAUNCH_TILE(T)                                                         \
  launch_tile<InT, OutT, T>(u, delta, A, B, C, Dskip, bias, yacc, y, hchk, h0, hlast, \
                            batch, dim, groups, N, L, softplus, reverse, stream)
  switch (T) {
    case 6: return FOCALNET_LAUNCH_TILE(6);
    case 4: return FOCALNET_LAUNCH_TILE(4);
    case 3: return FOCALNET_LAUNCH_TILE(3);
    case 2: return FOCALNET_LAUNCH_TILE(2);
    default: return FOCALNET_LAUNCH_TILE(1);
  }
#undef FOCALNET_LAUNCH_TILE
}

}  // namespace

extern "C" {

int focalnet_selective_scan_max_dstate() { return kMaxN; }

const char* focalnet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The channels one block takes (T) for these operands on the current
// device, as a launch would choose them; a negative CUDA error code on error.
int focalnet_selective_scan_fwd_tile(int batch, int dim, int groups, int dstate, int in_bf16,
                                     int out_bf16) {
  if (batch < 1 || dim < 1 || groups < 1 || dim % groups != 0 || dstate < 1 ||
      dstate > kMaxN) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  int T;
  if (in_bf16) {
    T = out_bf16 ? tile_channels<FwdTiles<__nv_bfloat16, __nv_bfloat16>>(kFwdTiles, batch, dim,
                                                                          groups, dstate, &err)
                 : tile_channels<FwdTiles<__nv_bfloat16, float>>(kFwdTiles, batch, dim, groups,
                                                                  dstate, &err);
  } else {
    T = out_bf16 ? tile_channels<FwdTiles<float, __nv_bfloat16>>(kFwdTiles, batch, dim, groups,
                                                                  dstate, &err)
                 : tile_channels<FwdTiles<float, float>>(kFwdTiles, batch, dim, groups, dstate,
                                                          &err);
  }
  return err == cudaSuccess ? T : -static_cast<int>(err);
}

// The tile that the last launch from this library took (0 before any).
int focalnet_selective_scan_fwd_last_tile() { return last_tile; }

// Launches on `stream` and returns the first CUDA error of the launch (0 =
// launched). Null Dskip / bias / yacc mean: no skip, no bias, nothing to
// accumulate; a null hchk: no chunk states; null h0 / hlast: the state starts
// at zero / is not written.
int focalnet_selective_scan_fwd_state(const void* u, const void* delta, const void* A,
                                      const void* B, const void* C, const void* Dskip,
                                      const void* bias, const void* yacc, void* y, void* hchk,
                                      const void* h0, void* hlast, int batch, int dim,
                                      int groups, int dstate, int L, int softplus, int reverse,
                                      int in_bf16, int out_bf16, void* stream) {
  if (batch < 1 || batch > 65535 || dim < 1 || groups < 1 || dim % groups != 0 ||
      dstate < 1 || dstate > kMaxN || L < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(Dskip);
  const float* bf = static_cast<const float*>(bias);
  float* hc = static_cast<float*>(hchk);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(hlast);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(u, delta, Af, B, C, Df, bf, yacc, y, hc,
                                                          h0f, hl, batch, dim, groups, dstate, L,
                                                          softplus, reverse, s)
                   : launch<__nv_bfloat16, float>(u, delta, Af, B, C, Df, bf, yacc, y, hc, h0f,
                                                  hl, batch, dim, groups, dstate, L, softplus,
                                                  reverse, s);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(u, delta, Af, B, C, Df, bf, yacc, y, hc, h0f,
                                                  hl, batch, dim, groups, dstate, L, softplus,
                                                  reverse, s)
                   : launch<float, float>(u, delta, Af, B, C, Df, bf, yacc, y, hc, h0f, hl,
                                          batch, dim, groups, dstate, L, softplus, reverse, s);
  }
  return static_cast<int>(err);
}

// The plain scan: the launch above with no h0 and no hlast.
int focalnet_selective_scan_fwd(const void* u, const void* delta, const void* A,
                                const void* B, const void* C, const void* Dskip,
                                const void* bias, const void* yacc, void* y, void* hchk,
                                int batch, int dim, int groups, int dstate, int L,
                                int softplus, int reverse, int in_bf16, int out_bf16,
                                void* stream) {
  return focalnet_selective_scan_fwd_state(u, delta, A, B, C, Dskip, bias, yacc, y, hchk,
                                           nullptr, nullptr, batch, dim, groups, dstate, L,
                                           softplus, reverse, in_bf16, out_bf16, stream);
}

}  // extern "C"
