// The z-GEMM of full covariance past D = 16, shared by the Hopper kernels
// of csrc/composed.cu (bank_emission_wide_kernel, bank_moments_wide_kernel),
// csrc/fused_em.cu (em_emission_wide_kernel, em_moments_wide_kernel) and
// csrc/wide_log_b.cu (wide_log_b_kernel, the emission pass of the
// vocabulary scorer and the word-loop decoder):
// the staged record layout, the record slices streamed by cp.async, the
// register-blocked fp32 z = c + L^T x of 32 frames a warp (wide_q), and the
// moment contraction of the lower triangle of x x^T on the tensor cores in
// 3xTF32 (wide_contract).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace srhmm {

// Shared memory of a z-GEMM block starts with (floats, at register bound
// RB; pitch RB + 4, so that rows 4 floats apart in k fall on different
// banks):
//   features xs (kWideFrames, RB + 4): x_k at column k, zeros from D on,
//     1.0 at column RB and 0.0 at RB + 1 (the moments' lift reads them)
//   record slices, 2 x kWideSlice mixtures of wide_mix_floats(RB):
//     L^T rows d < RB at pitch RB + 4 (zero rows from D on), c = -L^T mu
//     (RB, zeros from D on), [bias, log w, 0, 0]
//   q of a slice, 2 x (kWideSlice, kWideFrames)
// (wide_emission_floats); the moments kernels add their own after it.
constexpr int kWideThreads = 256;                          // 8 warps
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideFrames = 128;                           // frames of a z-GEMM tile: 32 a warp
constexpr int kWideSlice = kWideWarps / (kWideFrames / 32);  // mixtures of a record slice: 2
constexpr int kWideGroup = 8;                              // mixtures of a moments block: one mma n tile
constexpr int kWideKS = kWideFrames + 4;                   // pitch of the weights (fragment loads hit 32 banks)

__host__ __device__ constexpr int wide_pitch(int rb) { return rb + 4; }
__host__ __device__ constexpr int wide_mix_floats(int rb) { return rb * wide_pitch(rb) + rb + 4; }
// rows of the moments' lift [x; lower triangle of x x^T; 1], and its m tiles
__host__ __device__ constexpr int wide_lift_rows(int D) { return D + D * (D + 1) / 2 + 1; }
__host__ __device__ constexpr int wide_m_tiles(int D) { return (wide_lift_rows(D) + 15) / 16; }

__host__ __device__ inline size_t wide_emission_floats(int rb) {
  return (size_t)kWideFrames * wide_pitch(rb) + 2 * kWideSlice * ((size_t)wide_mix_floats(rb) + kWideFrames);
}

// a z-GEMM block's dynamic shared memory (past the 48 KB default), and the
// largest carveout, so that as many blocks fit an SM as their registers and
// shared memory allow
inline cudaError_t wide_setup(const void* fn, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
}

// emission.cuh lse_push without its branch: the exponent of the smaller
// term is -|q - m| in both cases (m - q == -(q - m) in IEEE arithmetic), so
// one expf serves both and the running (m, e) are bitwise those of lse_push
__device__ __forceinline__ void lse_add(float q, float& m, float& e) {
  const float ex = expf(-fabsf(q - m));
  const bool up = q > m;
  e = up ? e * ex + 1.f : e + ex;
  m = up ? q : m;
}

// Start the copies of n mixtures' records (stride floats apart from rec,
// rows of L^T h >= RB floats apart, zeros past D) into the staged layout
// at dst, one wide_mix_floats(RB) block a mixture: the first RB floats of
// each row d < D of L^T, zero rows D <= d < RB (copies of no bytes), the
// first RB floats of c, and [bias, log w, 0, 0].  Every bound is a
// constant of RB, so the index arithmetic takes no division.
template <int RB>
__device__ __forceinline__ void copy_slice_async(float* dst, const float* rec, int stride, int h, int D, int n) {
  constexpr int P = wide_pitch(RB), MF = wide_mix_floats(RB), G4 = RB / 4;
  constexpr int rows = RB * G4, per = rows + G4 + 1;  // float4 copies a mixture
  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {
    const int g = i / per, u = i - g * per;
    const float* src = rec + (size_t)g * stride;
    float* d = dst + g * MF;
    if (u < rows) {
      const int row = u / G4, kk = u - row * G4;
      const bool ok = row < D;
      cp_async16(d + row * P + 4 * kk, ok ? src + row * h + 4 * kk : src, ok);
    } else if (u < rows + G4) {
      cp_async16(d + RB * P + 4 * (u - rows), src + D * h + 4 * (u - rows), true);
    } else {
      cp_async16(d + RB * P + RB, src + D * h + h, true);
    }
  }
}

// Start the copies of n mixtures' records that are already in the staged
// layout (ops/kernels/common.py wide_records: wide_mix_floats(RB) floats a
// mixture, back to back from rec) into dst: one contiguous run of 16-byte
// copies, no index arithmetic beyond the offset.
template <int RB>
__device__ __forceinline__ void copy_staged_async(float* dst, const float* rec, int n) {
  constexpr int MF = wide_mix_floats(RB);
  static_assert(MF % 4 == 0, "a staged record is a whole number of float4");
  for (int i = threadIdx.x; i < n * (MF / 4); i += blockDim.x) cp_async16(dst + 4 * i, rec + 4 * i);
}

// The z-GEMM, shared by the kernels: the weighted log-likelihood of one
// mixture (its staged records w) at the 32 frames of xs, one frame a lane.
// Lane 4 tau + t holds frames f * 8 + tau (f < 4) and the components
// d = 4 i + t (i < RB / 4) of z = c + L^T x, each z_d one fmaf chain from
// c_d over k ascending (full_q's), every float4 of L^T read from shared
// memory feeding 16 FMAs and every float4 of x up to RB.  L^T is upper
// triangular (embedded.pack_position_bank_full and
// fused_em.pack_lane_constants write the rows of the Cholesky factor's
// transpose), so component group i skips the k groups
// below i: their products are exact zeros, and fmaf(0, x, z) is z for a
// finite x, so each z_d is bitwise the whole chain's.  The squares are summed per
// lane in i order, then over the four lanes of the team in lane order by
// shuffles, so the four hold the same sum.  Returns q of frame
// wide_q_frame(lane): min(-sum / 2 + bias, log 1e20) + log w.  Four frames
// a lane: eight (80 accumulators at RB = 40) spill at two blocks an SM, and
// ran slower.
template <int RB>
__device__ __forceinline__ float wide_q(const float* xs, const float* w, int d4) {
  constexpr int TZ = RB / 4, P = wide_pitch(RB);
  const int lane = threadIdx.x & 31, tau = lane >> 2, t = lane & 3, team = lane & ~3;
  const float* c = w + RB * P;
  float z[4][TZ];
#pragma unroll
  for (int i = 0; i < TZ; ++i) {
    const float ci = c[4 * i + t];
#pragma unroll
    for (int f = 0; f < 4; ++f) z[f][i] = ci;
  }
#pragma unroll 2
  for (int kk = 0; kk < d4; ++kk) {
    float4 x[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) x[f] = *reinterpret_cast<const float4*>(xs + (f * 8 + tau) * P + 4 * kk);
#pragma unroll
    for (int i = 0; i < TZ; ++i) {
      if (i > kk) break;  // rows 4 i .. 4 i + 3 of L^T are zero left of column 4 i
      const float4 r = *reinterpret_cast<const float4*>(w + (4 * i + t) * P + 4 * kk);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        z[f][i] = fmaf(r.x, x[f].x, z[f][i]);
        z[f][i] = fmaf(r.y, x[f].y, z[f][i]);
        z[f][i] = fmaf(r.z, x[f].z, z[f][i]);
        z[f][i] = fmaf(r.w, x[f].w, z[f][i]);
      }
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < TZ; ++i) part = fmaf(z[f][i], z[f][i], part);
    float s = __shfl_sync(~0u, part, team);
    s += __shfl_sync(~0u, part, team + 1);
    s += __shfl_sync(~0u, part, team + 2);
    s += __shfl_sync(~0u, part, team + 3);
    mine = (f == t) ? s : mine;
  }
  return fminf(fmaf(-0.5f, mine, c[RB]), kLogGausClamp) + c[RB + 1];
}

// where wide_q's lane leaves its q among the 32 frames of its warp
__device__ __forceinline__ int wide_q_frame(int lane) { return (lane & 3) * 8 + (lane >> 2); }

// Row c of the moments' lift as (ia | ib << 16), the lift being x[ia] x[ib]
// of the staged features with x[RB] = 1 and x[RB + 1] = 0: rows c < D are
// x_c (ib = RB), then the lower triangle x_a x_b (a >= b) in row order,
// then the constant 1, then zero rows up to a whole m tile.
template <int RB>
__device__ __forceinline__ int wide_lift_entry(int c, int D) {
  const int tri = D * (D + 1) / 2;
  if (c < D) return c | RB << 16;
  if (c < D + tri) {
    const int r = c - D;
    int a = (int)((sqrtf(8.f * r + 1.f) - 1.f) * 0.5f);
    while (a * (a + 1) / 2 > r) --a;
    while ((a + 1) * (a + 2) / 2 <= r) ++a;
    return a | (r - a * (a + 1) / 2) << 16;
  }
  return c == D + tri ? (RB | RB << 16) : ((RB + 1) | (RB + 1) << 16);
}

// acc += lift w^T over ksteps * 8 staged frames, on the tensor cores in
// 3xTF32 (lo*hi + hi*lo + hi*hi into fp32): the moment rows on the mma's
// m (this warp's m tiles warp, warp + kWideWarps, ...), the block's
// kWideGroup mixtures on n (mixtures past nm enter as 0), the frames on k.
// The lift is formed from the features on the fly; each accumulator is
// summed over the frames in mma order, so the result is the same on every
// run (and, in the bank moments, for either gamma layout).
template <int RB, int MTW>
__device__ __forceinline__ void wide_contract(float (&acc)[MTW][4], const float* xs, const float* wq, const int* tab,
                                              int nm, int ksteps, int n_mt) {
  constexpr int P = wide_pitch(RB);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gid = lane >> 2, tig = lane & 3;
  const bool real = gid < nm;
  for (int kk = 0; kk < ksteps; ++kk) {
    const int k0 = kk * 8 + tig, k1 = k0 + 4;
    unsigned b0h, b0l, b1h, b1l;
    split_tf32(real ? wq[gid * kWideKS + k0] : 0.f, b0h, b0l);
    split_tf32(real ? wq[gid * kWideKS + k1] : 0.f, b1h, b1l);
    const float* x0 = xs + k0 * P;
    const float* x1 = xs + k1 * P;
#pragma unroll
    for (int u = 0; u < MTW; ++u) {
      const int mt = warp + kWideWarps * u;
      if (mt < n_mt) {
        const int e0 = tab[mt * 16 + gid], e1 = tab[mt * 16 + gid + 8];
        const float a[4] = {x0[e0 & 0xffff] * x0[e0 >> 16], x0[e1 & 0xffff] * x0[e1 >> 16],
                            x1[e0 & 0xffff] * x1[e0 >> 16], x1[e1 & 0xffff] * x1[e1 >> 16]};
        unsigned ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
        mma_tf32(acc[u], alo, b0h, b1h);
        mma_tf32(acc[u], ahi, b0l, b1l);
        mma_tf32(acc[u], ahi, b0h, b1h);
      }
    }
  }
}

}  // namespace srhmm
