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
// The segment API (the TPU kernel's with_state branch): a non-null dh_last
// (batch, dim, N) fp32, the cotangent of the forward's h_last (the state
// after the last item in scan order), seeds the adjoint carry, since
// G_last = C dy + dh_last; a non-null dh0 (batch, dim, N) fp32 receives the
// carry left after the walk's last item, a_first G_first: the cotangent of
// the state h0 that seeded the forward (whose chunk states, hchk, start
// from it). The ragged tail's items have a = 1 and C dy = 0, so the seed
// passes them unchanged. Null dh_last and dh0 keep the plain adjoint's code
// path and results.
//
// What bounds it on an H100: the data moves once (u, delta, dy, du, ddelta,
// B, C, dB, dC: about 67 MB at L = 16384, dim = 192, N = 16 in fp32, ~20 us at
// 3.35 TB/s), and dim * N * L exponentials go through the special-function
// units (~12 us). The first design (one block per (batch, channel)) ran at
// 22x its arithmetic floor. Taking parts of its work out (PERF.md, K2's split)
// showed where the time went:
// - the fp32 atomics with which every channel block added its N x L dB and
//   dC rows into its group's one plane (192 adds per element): about a
//   fifth of the time;
// - B and C staged again by every channel: about a sixth;
// - the walk itself: the rest. Its synchronous loads, 5 block barriers and
//   ~23 shared-memory accesses per (state, element) held each chunk, with 16
//   warps of one dependent chain each per block.
//
// Design: one block per (batch, tile of T channels of one group), one warp
// per state n (N <= 16), chunks of 32 lanes x 8 items = 256. A tile never
// straddles two groups. T is chosen at launch (tile_channels): since every
// block walks all of L, a call costs about (waves of blocks) x T channel
// walks. A walk is cheaper the more channels share it. At the train step's
// B = 4 (dim 192, 132 SMs, one block each) T = 6 gives 128 blocks in one
// wave; at B = 1, T = 2 gives 96.
// The block walks the chunks opposite to the forward scan: last to first for
// a forward scan, first to last under `reverse`. Logical item e of chunk c is
// position c*256 + e, or c*256 + 255 - e under `reverse`, so in logical order
// the forward scan always runs left to right and the adjoint right to left.
// Per chunk:
//   A. The chunk's operands have arrived in shared memory (they were copied
//      during the chunk before, see E): the block forms dt and
//      sigmoid(delta + bias) for the T channels' rows, and warp n takes its
//      lanes' 8 items of row n of B and C into registers, once for the tile.
//      Positions >= L get dt = 0 (a = 1, b = 0: the monoid's identity) and
//      dy = u = B = C = 0.
//   E. Every thread issues cp.async copies of the next chunk's u, delta, dy
//      rows, entry states and B, C rows (into the other of two B/C buffers),
//      16 bytes each, which arrive while B-D run: no step waits on global
//      memory.
//   B. For each channel t of the tile, warp n rematerialises h inside the
//      chunk from the saved entry state with the forward kernel's lane and
//      shuffle scan, keeping h_{l-1} per item, then runs the adjoint: each
//      lane composes its 8 items' affine maps G_l = C_l dy_l + a_{l+1} G_{l+1}
//      right to left, the warp scans the 32 lane maps from the last lane down
//      with shuffles, and the channel's carry a_first * G_first of the chunk
//      processed before enters at the chunk's last item. The lane writes
//      G B and G h_{l-1} a A into its warp's row of a double-buffered
//      shared (N, 256) pair, sums G h_{l-1} a dt for dA in a register, and
//      adds G dt u and h dy into per-item registers: dB and dC summed over
//      the tile's channels on chip.
//   C. After one barrier per channel, the block sums the N rows per element
//      into du and ddelta, stores them coalesced (nothing past L), and sums
//      dy*u and ddelta per thread. The double buffer lets the warps that take
//      no element here start the next channel's step B.
//   D. Warp n adds its per-item dB and dC sums into row n of the group's
//      plane: one fp32 atomic per (n, l) per tile (as float4 vector atomics
//      when L is a multiple of 4), T times fewer than one per channel.
// So per chunk the block takes T + 2 barriers for T channels, reads B and C
// once, and issues 2 N x 256 atomics. At the end dA (one atomic per warp and
// channel), dD and dbias (block-reduced, one atomic each per channel) are
// added into their buffers; the atomics sum over the batch and the tiles, in
// an order that varies from run to run. Rows whose length or base is not
// 16-byte aligned are copied with plain loads instead of cp.async, and their
// dB, dC with scalar atomics.
//
// Exponentials: expf and log1pf, as in the forward kernel, so that the
// rematerialised h matches the forward's to rounding.

#include "scan_common.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Adds logical items e0 .. e0 + 7 of v into a fp32 row (nothing past L), with
// float4 atomics where `vec` says the row is aligned for them.
__device__ __forceinline__ void add_items(float* __restrict__ row, int base, int e0, int L,
                                          int reverse, int vec, const float v[kNItems]) {
  const int lo = items_lo(base, e0, reverse);
  if (vec && lo + kNItems <= L) {
    float4* q = reinterpret_cast<float4*>(row + lo);
    if (reverse) {
      atomicAdd(q, make_float4(v[7], v[6], v[5], v[4]));
      atomicAdd(q + 1, make_float4(v[3], v[2], v[1], v[0]));
    } else {
      atomicAdd(q, make_float4(v[0], v[1], v[2], v[3]));
      atomicAdd(q + 1, make_float4(v[4], v[5], v[6], v[7]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kNItems; ++i) {
      const int p = reverse ? lo + kNItems - 1 - i : lo + i;
      if (p < L) atomicAdd(row + p, v[i]);
    }
  }
}

template <typename InT, int T>
__global__ void __launch_bounds__(32 * kMaxN, 1)
selective_scan_bwd_kernel(const InT* __restrict__ u, const InT* __restrict__ delta,
                          const float* __restrict__ A, const InT* __restrict__ Bm,
                          const InT* __restrict__ Cm, const float* __restrict__ Dskip,
                          const float* __restrict__ bias, const float* __restrict__ hchk,
                          const float* __restrict__ dy, InT* __restrict__ du,
                          InT* __restrict__ ddelta, float* __restrict__ dA,
                          float* __restrict__ dB, float* __restrict__ dC,
                          float* __restrict__ dD, float* __restrict__ dbias,
                          const float* __restrict__ dhlast, float* __restrict__ dh0, int dim,
                          int groups, int N, int L, int softplus, int reverse, int vec_in,
                          int vec_dbc) {
  // dynamic, fp32: s_gb, s_gaa [2][N][kPad] (G B and G h_{l-1} a A per
  // state, two buffers), the tile's rows s_u, s_dt, s_dy, s_sg [T][kPad], the
  // chunk's entry states s_h0 [T][N], per-thread partial sums s_acc
  // [2][T][threads] of dD and dbias; then the next chunk's operands as they
  // arrive from global memory: r_u, r_delta (InT), r_dy [T][256], r_h0 [T][N]
  // and two buffers of B and C rows r_B, r_C [2][N][256] (InT)
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x;
  float* s_gb = smem;
  float* s_gaa = s_gb + 2 * N * kPad;
  float* s_u = s_gaa + 2 * N * kPad;
  float* s_dt = s_u + T * kPad;
  float* s_dy = s_dt + T * kPad;
  float* s_sg = s_dy + T * kPad;  // d dt / d delta
  float* s_h0 = s_sg + T * kPad;
  float* s_acc = s_h0 + pad4(T * N);
  float* r_dy = s_acc + 2 * T * nthreads;
  float* r_h0 = r_dy + T * kChunk;
  InT* r_u = reinterpret_cast<InT*>(r_h0 + pad4(T * N));
  InT* r_delta = r_u + T * kChunk;
  InT* r_B = r_delta + T * kChunk;
  InT* r_C = r_B + 2 * N * kChunk;

  const int d0 = blockIdx.x * T;  // the tile's first channel
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n = tid >> 5;  // warp index == state index
  const int lane = tid & 31;
  const int g = d0 / (dim / groups);

  const size_t row0 = ((size_t)b * dim + d0) * (size_t)L;  // channel d0 + t: row0 + t L
  const size_t bc0 = ((size_t)b * groups + g) * N * (size_t)L;  // the group's B, C rows
  const size_t bc_row = bc0 + n * (size_t)L;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const float* h_tile = hchk + ((size_t)b * dim + d0) * n_chunks * N;

  // The operands of chunk c, asynchronously: the T channels' u, delta, dy
  // rows, their entry states, and the group's N rows of B and C into buffer
  // `buf`, in 16-byte units spread over all threads.
  constexpr int kUnitsIn = kChunk * sizeof(InT) / 16, kUnitsF = kChunk / 4;
  auto prefetch = [&](int c, int buf) {
    const int base = c * kChunk;
    for (int k = tid; k < 2 * T * kUnitsIn; k += nthreads) {  // u, then delta
      const int r = k / kUnitsIn, p = base + (k % kUnitsIn) * (16 / (int)sizeof(InT));
      const int t = r < T ? r : r - T;
      stage_unit((r < T ? r_u : r_delta) + t * kChunk + (p - base),
                 (r < T ? u : delta) + row0 + (size_t)t * L, p, L, vec_in);
    }
    for (int k = tid; k < T * kUnitsF; k += nthreads) {  // dy
      const int t = k / kUnitsF, p = base + (k % kUnitsF) * 4;
      stage_unit(r_dy + t * kChunk + (p - base), dy + row0 + (size_t)t * L, p, L, vec_in);
    }
    for (int k = tid; k < 2 * N * kUnitsIn; k += nthreads) {  // B, then C
      const int r = k / kUnitsIn, p = base + (k % kUnitsIn) * (16 / (int)sizeof(InT));
      const int m = r < N ? r : r - N;
      stage_unit((r < N ? r_B : r_C) + (buf * N + m) * kChunk + (p - base),
                 (r < N ? Bm : Cm) + bc0 + (size_t)m * L, p, L, vec_in);
    }
    for (int k = tid; k < T * N; k += nthreads) {
      const int t = k / N, m = k % N;
      cp_async4(r_h0 + k, h_tile + ((size_t)t * n_chunks + c) * N + m);
    }
    cp_async_commit();
  };

  // gcarry: a_first * G_first of the chunk processed before (the same in
  // every lane); before the first chunk, the cotangent of the leaving state
  float gcarry[T], dA_acc[T];
  const size_t state0 = ((size_t)b * dim + d0) * N + n;  // channel d0 + t: state0 + t N
#pragma unroll
  for (int t = 0; t < T; ++t) {
    gcarry[t] = dhlast ? dhlast[state0 + (size_t)t * N] : 0.f;
    dA_acc[t] = 0.f;
  }
  for (int k = tid; k < 2 * T * nthreads; k += nthreads) s_acc[k] = 0.f;
  const int e0 = lane * kNItems;

  prefetch(reverse ? 0 : n_chunks - 1, 0);
  for (int it = n_chunks - 1; it >= 0; --it) {
    const int c = reverse ? n_chunks - 1 - it : it;
    const int base = c * kChunk;
    const int buf = (n_chunks - 1 - it) & 1;

    // A: this chunk's operands have arrived (and the last chunk's step C is
    // done with the rows): form dt and sigmoid(delta + bias) into the rows,
    // and this warp's B, C items into registers
    cp_async_wait_all();
    __syncthreads();
    for (int k = tid; k < T * kChunk; k += nthreads) {
      const int t = k / kChunk, e = k % kChunk;
      const int q = reverse ? kChunk - 1 - e : e;  // memory order within the chunk
      float uv = 0.f, dt = 0.f, dyv = 0.f, sg = 0.f;
      if (base + q < L) {
        uv = to_f(r_u[t * kChunk + q]);
        const float pre = to_f(r_delta[t * kChunk + q]) + (bias ? bias[d0 + t] : 0.f);
        dt = pre;
        sg = 1.f;
        if (softplus) {
          dt = pre <= 20.f ? log1pf(expf(pre)) : pre;
          sg = 1.f / (1.f + expf(-pre));
        }
        dyv = r_dy[t * kChunk + q];
      }
      const int s = t * kPad + sidx(e);
      s_u[s] = uv;
      s_dt[s] = dt;
      s_dy[s] = dyv;
      s_sg[s] = sg;
    }
    for (int k = tid; k < T * N; k += nthreads) s_h0[k] = r_h0[k];
    float Bv[kNItems], Cv[kNItems];
    chunk_items(r_B + (buf * N + n) * kChunk, e0, reverse, Bv);
    chunk_items(r_C + (buf * N + n) * kChunk, e0, reverse, Cv);
    __syncthreads();
    // E: the next chunk's operands arrive while this one is computed
    if (it > 0) prefetch(reverse ? c + 1 : c - 1, buf ^ 1);

    float dBr[kNItems], dCr[kNItems];  // dB, dC of this chunk, summed over the tile
#pragma unroll
    for (int i = 0; i < kNItems; ++i) dBr[i] = dCr[i] = 0.f;

#pragma unroll
    for (int t = 0; t < T; ++t) {
      float* gb = s_gb + ((t & 1) * N + n) * kPad;  // this warp's rows
      float* gaa = s_gaa + ((t & 1) * N + n) * kPad;
      const float A_dn = A[(size_t)(d0 + t) * N + n];

      // B: rematerialise h (forward scan of warp n over the chunk)
      float a[kNItems], hp[kNItems], dtv[kNItems], dtu[kNItems], dyv[kNItems];
#pragma unroll
      for (int i = 0; i < kNItems; ++i) {
        const int s = t * kPad + sidx(e0 + i);
        dtv[i] = s_dt[s];
        dtu[i] = dtv[i] * s_u[s];
        dyv[i] = s_dy[s];
        a[i] = expf(dtv[i] * A_dn);
      }
      float ta = a[0], tb = dtu[0] * Bv[0];
#pragma unroll
      for (int i = 1; i < kNItems; ++i) {
        tb = a[i] * tb + dtu[i] * Bv[i];
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
      float hv = ea * s_h0[t * N + n] + eb;  // h before this lane's first item
#pragma unroll
      for (int i = 0; i < kNItems; ++i) {
        hp[i] = hv;
        hv = a[i] * hv + dtu[i] * Bv[i];
        dCr[i] += hv * dyv[i];
      }

      // B: the adjoint, right to left. This lane's map X -> G at its first
      // item, X being G at the next lane's first item (scaled by that item's
      // a); the last lane's X is the carry from the chunk processed before.
      const float a_next = __shfl_down_sync(kFull, a[0], 1);
      const float an = lane == 31 ? 1.f : a_next;
      float P = an;
      float Q = Cv[kNItems - 1] * dyv[kNItems - 1];
#pragma unroll
      for (int i = kNItems - 2; i >= 0; --i) {
        Q = Cv[i] * dyv[i] + a[i + 1] * Q;
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
      float G = lane == 31 ? gcarry[t] : Pl * gcarry[t] + Ql;  // X of this lane
#pragma unroll
      for (int i = kNItems - 1; i >= 0; --i) {
        const int s = sidx(e0 + i);
        G = Cv[i] * dyv[i] + (i == kNItems - 1 ? an : a[i + 1]) * G;
        const float gha = G * hp[i] * a[i];
        gb[s] = G * Bv[i];
        gaa[s] = gha * A_dn;
        dA_acc[t] += gha * dtv[i];
        dBr[i] += G * dtu[i];
      }
      gcarry[t] = __shfl_sync(kFull, a[0] * G, 0);  // G is the first item's
      __syncthreads();

      // C: du, ddelta of channel t; dD and dbias partial sums. The double
      // buffer lets the warps that take no element here start the next
      // channel's step B.
      const float D_d = Dskip ? Dskip[d0 + t] : 0.f;
      const float* sum_gb = s_gb + (t & 1) * N * kPad;
      const float* sum_gaa = s_gaa + (t & 1) * N * kPad;
      float part_dD = 0.f, part_db = 0.f;
      for (int e = tid; e < kChunk; e += nthreads) {
        const int p = reverse ? base + kChunk - 1 - e : base + e;
        if (p < L) {
          const int s = sidx(e), r = t * kPad + s;
          float gbs = 0.f, gaas = 0.f;
#pragma unroll
          for (int k = 0; k < kMaxN; ++k) {
            if (k < N) {
              gbs += sum_gb[k * kPad + s];
              gaas += sum_gaa[k * kPad + s];
            }
          }
          const float uv = s_u[r], dyr = s_dy[r];
          const float dd = (uv * gbs + gaas) * s_sg[r];
          const size_t off = row0 + (size_t)t * L + p;
          du[off] = from_f<InT>(s_dt[r] * gbs + D_d * dyr);
          ddelta[off] = from_f<InT>(dd);
          part_dD += dyr * uv;
          part_db += dd;
        }
      }
      if (tid < kChunk) {
        s_acc[t * nthreads + tid] += part_dD;
        s_acc[(T + t) * nthreads + tid] += part_db;
      }
    }

    // D: dB, dC summed over the tile's channels into the group's plane
    add_items(dB + bc_row, base, e0, L, reverse, vec_dbc, dBr);
    add_items(dC + bc_row, base, e0, L, reverse, vec_dbc, dCr);
  }

#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float sa = warp_sum(dA_acc[t]);
    if (lane == 0) atomicAdd(dA + (size_t)(d0 + t) * N + n, sa);
    if (dh0 && lane == 0) dh0[state0 + (size_t)t * N] = gcarry[t];
  }
  __syncthreads();
  // dD, dbias: warp w sums rows w, w + N, ... of s_acc (row j: channel j % T,
  // dD for j < T, then dbias)
  for (int j = n; j < 2 * T; j += N) {
    const float* row = s_acc + j * nthreads;
    float v = 0.f;
    for (int k = lane; k < nthreads; k += 32) v += row[k];
    v = warp_sum(v);
    float* out = j < T ? dD : dbias;
    if (lane == 0 && out) atomicAdd(out + d0 + j % T, v);
  }
}

template <typename InT>
size_t smem_bytes(int T, int N) {
  const size_t floats = (size_t)(4 * N + 4 * T) * kPad + 2 * pad4(T * N) + 2 * T * 32 * N +
                        T * kChunk;
  return floats * sizeof(float) + (size_t)(2 * T + 4 * N) * kChunk * sizeof(InT);
}

// Lets the kernel for T take its dynamic shared memory; returns the blocks
// of it that fit on one SM (0 on error, with the error in *err).
template <typename InT, int T>
int prepare(int N, cudaError_t* err) {
  return fit_blocks(selective_scan_bwd_kernel<InT, T>, 32 * N, smem_bytes<InT>(T, N),
                    smem_bytes<InT>(T, kMaxN), err);
}

template <typename InT>
int prepare_tile(int T, int N, cudaError_t* err) {
  switch (T) {
    case 6: return prepare<InT, 6>(N, err);
    case 4: return prepare<InT, 4>(N, err);
    case 3: return prepare<InT, 3>(N, err);
    case 2: return prepare<InT, 2>(N, err);
    default: return prepare<InT, 1>(N, err);
  }
}

constexpr int kTiles[] = {1, 2, 3, 4, 6};  // channels per block that are built

// The tile rule's view of this kernel (scan_common.cuh, tile_channels)
template <typename InT>
struct BwdTiles {
  static int prepare(int T, int N, cudaError_t* err) { return prepare_tile<InT>(T, N, err); }
};

template <typename InT, int T>
cudaError_t launch_tile(const void* u, const void* delta, const float* A, const void* B,
                        const void* C, const float* Dskip, const float* bias,
                        const float* hchk, const float* dy, void* du, void* ddelta, float* dA,
                        float* dB, float* dC, float* dD, float* dbias, const float* dhlast,
                        float* dh0, int batch, int dim, int groups, int N, int L, int softplus,
                        int reverse, cudaStream_t stream) {
  // 16-byte copies and vector atomics: rows of L elements stay aligned when L
  // is a multiple of the elements in 16 bytes, and the bases are
  const int vec_in = L % 8 == 0 && aligned16(u) && aligned16(delta) && aligned16(dy) &&
                     aligned16(B) && aligned16(C);
  const int vec_dbc = L % 4 == 0 && aligned16(dB) && aligned16(dC);
  const dim3 grid(dim / T, batch);
  const dim3 block(32 * N);
  selective_scan_bwd_kernel<InT, T><<<grid, block, smem_bytes<InT>(T, N), stream>>>(
      static_cast<const InT*>(u), static_cast<const InT*>(delta), A,
      static_cast<const InT*>(B), static_cast<const InT*>(C), Dskip, bias, hchk, dy,
      static_cast<InT*>(du), static_cast<InT*>(ddelta), dA, dB, dC, dD, dbias, dhlast, dh0, dim,
      groups, N, L, softplus, reverse, vec_in, vec_dbc);
  return cudaGetLastError();
}

template <typename InT>
cudaError_t launch(const void* u, const void* delta, const float* A, const void* B,
                   const void* C, const float* Dskip, const float* bias, const float* hchk,
                   const float* dy, void* du, void* ddelta, float* dA, float* dB, float* dC,
                   float* dD, float* dbias, const float* dhlast, float* dh0, int batch, int dim,
                   int groups, int N, int L, int softplus, int reverse, cudaStream_t stream) {
  cudaError_t err;
  const int T = tile_channels<BwdTiles<InT>>(kTiles, batch, dim, groups, N, &err);
  if (err != cudaSuccess) return err;
#define FOCALNET_LAUNCH_TILE(T)                                                             \
  launch_tile<InT, T>(u, delta, A, B, C, Dskip, bias, hchk, dy, du, ddelta, dA, dB, dC, dD,   \
                      dbias, dhlast, dh0, batch, dim, groups, N, L, softplus, reverse, stream)
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

int focalnet_selective_scan_bwd_max_dstate() { return kMaxN; }

// The channels one block takes (T) for these operands on the current
// device, as a launch would choose them; a negative CUDA error code on error.
int focalnet_selective_scan_bwd_tile(int batch, int dim, int groups, int dstate, int in_bf16) {
  if (batch < 1 || dim < 1 || groups < 1 || dim % groups != 0 || dstate < 1 ||
      dstate > kMaxN) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  const int T = in_bf16
                    ? tile_channels<BwdTiles<__nv_bfloat16>>(kTiles, batch, dim, groups, dstate, &err)
                    : tile_channels<BwdTiles<float>>(kTiles, batch, dim, groups, dstate, &err);
  return err == cudaSuccess ? T : -static_cast<int>(err);
}

const char* focalnet_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches on `stream` and returns the first CUDA error of the launch (0 =
// launched). dA, dB, dC and the non-null dD, dbias must be zeroed by the
// caller: the kernel adds into them. Null Dskip / bias: no skip, no bias;
// null dD / dbias: that gradient is not summed; null dhlast: the adjoint
// starts at zero; null dh0: the final carry is not written.
int focalnet_selective_scan_bwd_state(const void* u, const void* delta, const void* A,
                                      const void* B, const void* C, const void* Dskip,
                                      const void* bias, const void* hchk, const void* dy,
                                      void* du, void* ddelta, void* dA, void* dB, void* dC,
                                      void* dD, void* dbias, const void* dhlast, void* dh0,
                                      int batch, int dim, int groups, int dstate, int L,
                                      int softplus, int reverse, int in_bf16, void* stream) {
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
  const float* dhl = static_cast<const float*>(dhlast);
  float* dh0f = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      in_bf16 ? launch<__nv_bfloat16>(u, delta, Af, B, C, Df, bf, hc, dyf, du, ddelta, dAf,
                                      dBf, dCf, dDf, dbf, dhl, dh0f, batch, dim, groups, dstate,
                                      L, softplus, reverse, s)
              : launch<float>(u, delta, Af, B, C, Df, bf, hc, dyf, du, ddelta, dAf, dBf, dCf,
                              dDf, dbf, dhl, dh0f, batch, dim, groups, dstate, L, softplus,
                              reverse, s);
  return static_cast<int>(err);
}

// The plain adjoint: the launch above with no dhlast and no dh0.
int focalnet_selective_scan_bwd(const void* u, const void* delta, const void* A,
                                const void* B, const void* C, const void* Dskip,
                                const void* bias, const void* hchk, const void* dy, void* du,
                                void* ddelta, void* dA, void* dB, void* dC, void* dD,
                                void* dbias, int batch, int dim, int groups, int dstate,
                                int L, int softplus, int reverse, int in_bf16, void* stream) {
  return focalnet_selective_scan_bwd_state(u, delta, A, B, C, Dskip, bias, hchk, dy, du, ddelta,
                                           dA, dB, dC, dD, dbias, nullptr, nullptr, batch, dim,
                                           groups, dstate, L, softplus, reverse, in_bf16, stream);
}

}  // extern "C"
