// Fused diagonal-GMM emission and moment kernels for NVIDIA Hopper
// (sm_90a), single stream.
//
// Replace the TPU kernels of srhmm_tpu/ops/pallas/emission_pallas.py:
//   emission_log_b_kernel              <- :72 emission_log_b_pallas
//   emission_stats_kernel + sum_blocks <- :142 emission_stats_pallas
// The plain PyTorch twins (ops/kernels/emission.py emission_log_b_plain,
// emission_stats_plain) compute the same functions.
//
// The functions.  Frames x (N, D); per (state s, mixture m) the packed
// constants A_m = [mu k; -k/2] and the bias b_m (the Gaussian normalizer
// and log w_m folded in), laid out as csrc/emission.cuh's diagonal records
// (state-major, log w slot 0):
//   q_m = <[x, x^2], A_m> + b_m,   log b_s = logsumexp_m q_m   (no clamp)
//   moments[s, m] = sum_n g_nsm [x_n, x_n^2, 1],
//   g_nsm = gamma'_ns exp(min(q_m - log b_ns, 0)),
//   gamma'_ns = gamma_ns where log b_ns > -1e30, else 0.
// The log b the moments read is the caller's (the emission kernel's, in
// the E-step), not recomputed.
//
// Design.  Emission: a grid of about as many blocks as fit on the card at
// once, each staging the S * M records in shared memory once (or reading
// them from device memory, through L1, when they do not fit beside the
// tiles) and walking the tiles of TF = threads * NC frames j = blockIdx.x,
// + gridDim.x, ...: tile j+1's frames come into the other of two slots by
// 16-byte cp.async while tile j is computed; a thread takes NC frames side
// by side (their x in registers) and every state, each record read once for
// the NC frames as a warp-wide broadcast (emission.cuh state_log_b_cols:
// diag_state_log_b's fmaf order, so log b is bitwise that of one thread a
// frame), into a (TF, S) tile in shared memory, which goes out as
// coalesced 16-byte stores.  Moments: a grid of about as many resident
// blocks as fit walks tiles of TF frames (j = r, r + R, ...) with all the
// states, or a group of SG states where the states' accumulators and
// weights do not fit (the frames then read once a group); tile j+1's
// frames, posteriors and log b come in by 16-byte cp.async while tile j is
// computed.  Frames on threads form q_m (diag_mix_q, as the emission) and
// the weights g of each (state, mixture) into a (SG M, TF) tile beside the
// features (D, TF); then the warps contract them, acc (SG M, 2D+1) +=
// W [x; x^2; 1]^T, on the tensor cores in 3xTF32 (tile_mma.cuh
// contract_3xtf32, the weights scaled by 2^48: subnormal posteriors keep
// their bits), each accumulator owned by one warp and summed in mma order.
// Each block writes its own partial row, and a second pass sums the rows of
// each output in a fixed order (a warp an output, a lane the rows r = lane
// mod 32 ascending, then a butterfly): no atomics, so two runs are bitwise
// equal.  The records sit in shared memory or, where they do not fit, are
// read from device memory.  The emission's arithmetic is fp32 fmaf on the
// CUDA cores; the moments' products are 3xTF32, their sums fp32.

// What bounds it on the H100.  At the em_diag shape (N = 1,024,000 frames,
// D=9, S=8, M=3) the emission reads 36.9 MB of frames and writes 32.8 MB of
// log b (~0.021 ms of HBM time) for ~0.9 GFLOP (~0.014 ms of the fp32
// rate): bytes on paper, and with the frames and log b moved in whole
// 16-byte runs the kernel is the FMA chains' and the copies' latency over
// ~4 blocks an SM.  The moments read frames, gamma and log b (102 MB,
// ~0.031 ms) for ~1.4 GFLOP, once each with all the states in one group.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace {

using namespace srhmm;

constexpr int kStatsThreads = 256;      // moments: threads a block
constexpr int kReduceThreads = 256;     // the partial sums: 8 outputs a block, a warp each

__device__ __forceinline__ void stage(const float* src, int n_floats, float* dst) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < n_floats / 4; i += blockDim.x) d4[i] = s4[i];
}

constexpr int kEmitThreads = 256;  // emission: threads a block at most
// emission: the frames a thread takes side by side (their x in registers)
template <int DMAX>
constexpr int kEmitCols = DMAX <= 16 ? 2 : 1;

struct EmitParams {
  const float* frames;  // (N, D), 16-byte aligned
  const float* recs;    // (S * M, 2 DMAX + 4) records, state-major
  float* log_b;         // (N, S)
  long long N;
  int D, S, M;
  int recs_global;      // the records read from device memory, not shared memory
  int direct;           // log b stored straight to device memory, not through a shared tile
};

// Shared memory of an emission block of `threads` threads, in floats (the
// wrapper's ops/kernels/emission.py emission_smem_bytes mirrors it): the
// records (unless recs_global) | the frames, two slots of (TF, D) | log b
// (TF, S) (unless direct), with TF = threads * NC.
__host__ __device__ inline size_t emit_floats(int dmax, int cols, int threads, int D, int S, int M,
                                              int recs_global, int direct) {
  const size_t tf = (size_t)threads * cols;
  return (recs_global ? 0 : (size_t)S * M * (2 * dmax + 4)) + 2 * tf * D + (direct ? 0 : tf * S);
}

// tile j's frames [j TF, min(N, (j+1) TF)) into a slot: 16-byte copies, the
// last floats of a ragged tile 4 bytes each
__device__ __forceinline__ void stage_frames(const EmitParams& p, long long j, int tf, float* dst) {
  const long long n0 = j * tf;
  const int count = (int)min((long long)tf, p.N - n0) * p.D;
  const float* src = p.frames + n0 * p.D;
  const int n4 = count >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x) cp_async4(dst + i, src + i, true);
  cp_async_commit();
}

// A block walks the tiles j = blockIdx.x, + gridDim.x, ...: tile j+1's
// frames are staged while tile j is computed, and one barrier each closes
// the staging and the log b tile.
template <int DMAX>
__global__ void __launch_bounds__(kEmitThreads) emission_log_b_kernel(const __grid_constant__ EmitParams p) {
  constexpr int NC = kEmitCols<DMAX>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, nt = blockDim.x, tf = nt * NC, D = p.D, S = p.S, M = p.M;
  const int stride = record_stride<DMAX, false>(D);
  const float* recs = p.recs;
  float* xs = smem;
  if (!p.recs_global) {
    stage(p.recs, S * M * stride, smem);
    recs = smem;
    xs = smem + S * M * stride;
  }
  float* lbt = xs + 2 * (size_t)tf * D;
  const long long n_tiles = (p.N + tf - 1) / tf;
  long long j = blockIdx.x;
  if (j < n_tiles) stage_frames(p, j, tf, xs);
  for (int slot = 0; j < n_tiles; j += gridDim.x, slot ^= 1) {
    if (j + gridDim.x < n_tiles) {
      stage_frames(p, j + gridDim.x, tf, xs + (slot ^ 1) * (size_t)tf * D);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j's frames are in; the last tile's log b is out
    const long long n0 = j * tf;
    const int nf = (int)min((long long)tf, p.N - n0);
    const float* xt = xs + slot * (size_t)tf * D;
    float x[NC][DMAX];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int f = min(tid + c * nt, nf - 1);  // a frame past the tile repeats the last, not stored
#pragma unroll
      for (int d = 0; d < DMAX; ++d) x[c][d] = (d < D) ? xt[f * D + d] : 0.f;
    }
    // a (TF, S) tile too wide for shared memory (direct) goes out as it is
    // computed, S floats apart
    float* lbo = p.direct ? p.log_b + n0 * S : lbt;
    for (int s = 0; s < S; ++s) {
      float v[NC];
      state_log_b_cols<DMAX, false, NC>(recs + s * M * stride, M, D, x, v);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (tid + c * nt < nf) lbo[(size_t)(tid + c * nt) * S + s] = v[c];
    }
    __syncthreads();  // the tile's log b is complete
    if (p.direct) continue;
    // out: nf S consecutive floats, 16 bytes a store (n0 S is a multiple of 4)
    float* dst = p.log_b + n0 * S;
    const int count = nf * S, n4 = count >> 2;
    for (int i = tid; i < n4; i += nt) reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(lbt)[i];
    for (int i = 4 * n4 + tid; i < count; i += nt) dst[i] = lbt[i];
  }
}

struct StatsParams {
  const float* frames;  // (N, D), 16-byte aligned
  const float* gamma;   // (N, S), 16-byte aligned
  const float* log_b;   // (N, S), 16-byte aligned
  const float* recs;    // (S * M, 2 DMAX + 4) records, state-major
  float* partial;       // (R, S M Cm): block (group, r) writes row r's columns of its states
  long long N;
  int D, S, M;
  int SG, groups;       // states a block, and the groups of SG states
  int TF;               // frames a tile (a multiple of 8 dividing kStatsThreads)
  int R;                // blocks a group: block (group, r) walks tiles r, r + R, ...
  int recs_global;      // the records read from device memory, not shared memory
};

// Shared memory of a moments block, in floats (ops/kernels/emission.py
// stats_smem_bytes mirrors it): the group's records (unless recs_global) |
// two slots each of frames (TF, D), posteriors (TF, SG) and log b (TF, SG)
// | the weights (SG M, TF + 4) | the features (D, TF + 4) | the
// accumulators (SG M, 2D+1).
__host__ __device__ inline size_t stats_floats(int dmax, int D, int SG, int M, int TF, int recs_global) {
  const size_t ks = TF + 4, rows = (size_t)SG * M;
  return (recs_global ? 0 : rows * (2 * dmax + 4)) + 2 * (size_t)TF * D + 4 * (size_t)TF * SG + rows * ks + D * ks +
         rows * (2 * D + 1);
}

// count consecutive floats from src into dst: 16-byte copies (both
// addresses 16-byte aligned), the last count % 4 floats 4 bytes each
__device__ __forceinline__ void stage_run(float* dst, const float* src, int count) {
  const int n4 = count >> 2;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
  for (int i = 4 * n4 + threadIdx.x; i < count; i += blockDim.x) cp_async4(dst + i, src + i, true);
}

// tile j's frames, and its posteriors and log b of states [s0, s0 + sg), into
// a slot: (nf, D) and (nf, SG) row-major; one group (SG = S) copies whole
// runs, several copy 4 bytes a float
__device__ __forceinline__ void stage_stats_tile(const StatsParams& p, long long j, int s0, int sg, float* xs,
                                                 float* gs, float* ls) {
  const long long n0 = j * p.TF;
  const int nf = (int)min((long long)p.TF, p.N - n0);
  stage_run(xs, p.frames + n0 * p.D, nf * p.D);
  if (p.groups == 1) {
    stage_run(gs, p.gamma + n0 * p.S, nf * p.S);
    stage_run(ls, p.log_b + n0 * p.S, nf * p.S);
  } else {
    for (int i = threadIdx.x; i < nf * sg; i += blockDim.x) {
      const int k = i / sg, sl = i - k * sg;
      const size_t o = (size_t)(n0 + k) * p.S + s0 + sl;
      cp_async4(gs + k * p.SG + sl, p.gamma + o, true);
      cp_async4(ls + k * p.SG + sl, p.log_b + o, true);
    }
  }
  cp_async_commit();
}

// grid groups * R, kStatsThreads threads: block (group, r) = (blockIdx.x %
// groups, blockIdx.x / groups) takes states [group SG, + SG) and tiles r,
// r + R, ...  Per tile: frames on threads (frame k = tid % TF, states tid /
// TF + i kStatsThreads / TF) write the weights g of each (state, mixture),
// scaled by 2^48, and (first row of threads) the frame's features into
// (D, TF + 4); a barrier; the contraction by all the warps; the next
// tile's barrier.
template <int DMAX>
__global__ void __launch_bounds__(kStatsThreads) emission_stats_kernel(const __grid_constant__ StatsParams p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int stride = record_stride<DMAX, false>(p.D);
  const int D = p.D, M = p.M, Cm = 2 * D + 1, TF = p.TF, ks = TF + 4, tid = threadIdx.x;
  const int group = blockIdx.x % p.groups, r = blockIdx.x / p.groups;
  const int s0 = group * p.SG, sg = min(p.SG, p.S - s0), rows = sg * M;
  const float* recs = p.recs + (size_t)s0 * M * stride;
  float* xs = sh;
  if (!p.recs_global) {
    stage(recs, rows * stride, sh);
    recs = sh;
    xs = sh + (size_t)p.SG * M * stride;
  }
  float* gs = xs + 2 * (size_t)TF * D;       // two slots of (TF, SG)
  float* ls = gs + 2 * (size_t)TF * p.SG;    // two slots of (TF, SG)
  float* w_sh = ls + 2 * (size_t)TF * p.SG;  // (SG M, ks)
  float* x_sh = w_sh + (size_t)p.SG * M * ks;  // (D, ks)
  float* acc = x_sh + (size_t)D * ks;        // (SG M, Cm)
  const int warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int i = tid; i < rows * Cm; i += blockDim.x) acc[i] = 0.f;
  const long long n_tiles = (p.N + TF - 1) / TF;
  const int k = tid % TF, lanes_f = blockDim.x / TF;  // this thread's frame; threads a frame
  long long j = r;
  if (j < n_tiles) stage_stats_tile(p, j, s0, sg, xs, gs, ls);
  for (int slot = 0; j < n_tiles; j += p.R, slot ^= 1) {
    if (j + p.R < n_tiles) {
      stage_stats_tile(p, j + p.R, s0, sg, xs + (slot ^ 1) * (size_t)TF * D, gs + (slot ^ 1) * (size_t)TF * p.SG,
                       ls + (slot ^ 1) * (size_t)TF * p.SG);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j is in; the last tile's contraction is done
    const int nf = (int)min((long long)TF, p.N - j * TF);
    const bool on = k < nf;
    const float* xt = xs + slot * (size_t)TF * D;
    const float* gt = gs + slot * (size_t)TF * p.SG;
    const float* lt = ls + slot * (size_t)TF * p.SG;
    float x[DMAX], x2[DMAX];
#pragma unroll
    for (int e = 0; e < DMAX; ++e) {
      x[e] = (on && e < D) ? xt[k * D + e] : 0.f;
      x2[e] = x[e] * x[e];
    }
    if (tid < TF) {
#pragma unroll
      for (int e = 0; e < DMAX; ++e)
        if (e < D) x_sh[e * ks + k] = x[e];
    }
    for (int sl = tid / TF; sl < sg; sl += lanes_f) {
      const float lb = on ? lt[k * p.SG + sl] : kNegInf;
      const float g = (on && lb > kNegInf) ? gt[k * p.SG + sl] : 0.f;
      for (int mix = 0; mix < M; ++mix) {
        const float q = diag_mix_q<DMAX>(recs + (sl * M + mix) * stride, x, x2);
        w_sh[(sl * M + mix) * ks + k] = on ? (g * expf(fminf(q - lb, 0.f))) * kWeightScale : 0.f;
      }
    }
    __syncthreads();  // the tile's weights and features are complete
    contract_3xtf32<false>(acc, rows, Cm, w_sh, x_sh, ks, D, (nf + 7) / 8, warp, nwarps);
  }
  __syncthreads();
  float* out = p.partial + (size_t)r * p.S * M * Cm + (size_t)s0 * M * Cm;
  for (int i = tid; i < rows * Cm; i += blockDim.x) out[i] = acc[i] * kWeightUnscale;
}

// out[i] = sum over r of partial[r * n + i] in a fixed order: a warp an
// output, lane l summing the rows r = l, l + 32, ... ascending, then a
// butterfly over the lanes.
__global__ void __launch_bounds__(kReduceThreads)
    sum_blocks_kernel(const float* partial, float* out, int ranges, int n) {
  const int i = blockIdx.x * (kReduceThreads / 32) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (i >= n) return;
  float a = 0.f;
  for (int r = lane; r < ranges; r += 32) a += partial[(size_t)r * n + i];
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) a += __shfl_xor_sync(~0u, a, o);
  if (lane == 0) out[i] = a;
}

using EmitFn = void (*)(EmitParams);
using StatsFn = void (*)(StatsParams);

// nullptr for a bound that is not compiled
EmitFn emission_kernel_for(int dmax) {
  switch (dmax) {
    case 4: return emission_log_b_kernel<4>;
    case 8: return emission_log_b_kernel<8>;
    case 12: return emission_log_b_kernel<12>;
    case 16: return emission_log_b_kernel<16>;
    case 32: return emission_log_b_kernel<32>;
    case 64: return emission_log_b_kernel<64>;
    default: return nullptr;
  }
}

StatsFn stats_kernel_for(int dmax) {
  switch (dmax) {
    case 4: return emission_stats_kernel<4>;
    case 8: return emission_stats_kernel<8>;
    case 12: return emission_stats_kernel<12>;
    case 16: return emission_stats_kernel<16>;
    case 32: return emission_stats_kernel<32>;
    case 64: return emission_stats_kernel<64>;
    default: return nullptr;
  }
}

cudaError_t prepare(const void* fn, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The emission's grid: at most the blocks of `threads` threads and smem
// bytes that fit on the card at once, and no more than the tiles.
cudaError_t emission_grid(EmitFn fn, long long N, int cols, int threads, size_t smem, int device, long long* blocks) {
  cudaError_t err = prepare(reinterpret_cast<const void*>(fn), smem, device);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (N + (long long)threads * cols - 1) / ((long long)threads * cols);
  *blocks = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 = ok).
// frames (N, D), records (S * M, 2 * dmax + 4) float32 (state-major),
// device pointers.

// The emission: `threads` threads a block (a multiple of 32 up to 256; the
// wrapper's ops/kernels/emission.py emission_block picks it), the records
// in device memory (recs_global) or shared memory, log b through a shared
// tile or straight out (direct), the grid of emission_grid; frames and log
// b 16-byte aligned.
int srhmm_emission_log_b(const void* frames, const void* recs, void* log_b, long long N, int D,
                         int S, int M, int dmax, int threads, int recs_global, int direct, int device,
                         void* stream) {
  const EmitFn fn = emission_kernel_for(dmax);
  if (fn == nullptr || N < 1 || D < 1 || D > dmax || S < 1 || M < 1 || threads < 32 || threads > kEmitThreads ||
      threads % 32 != 0 || reinterpret_cast<uintptr_t>(frames) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(log_b) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cols = dmax <= 16 ? 2 : 1;  // kEmitCols
  const size_t smem = sizeof(float) * emit_floats(dmax, cols, threads, D, S, M, recs_global, direct);
  long long blocks = 0;
  const cudaError_t err = emission_grid(fn, N, cols, threads, smem, device, &blocks);
  if (err != cudaSuccess) return (int)err;
  EmitParams p{static_cast<const float*>(frames), static_cast<const float*>(recs), static_cast<float*>(log_b),
               N, D, S, M, recs_global, direct};
  fn<<<(unsigned)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The grid srhmm_emission_log_b launches for these arguments, into *blocks.
int srhmm_emission_log_b_grid(long long N, int D, int S, int M, int dmax, int threads, int recs_global, int direct,
                              int device, long long* blocks) {
  const EmitFn fn = emission_kernel_for(dmax);
  if (fn == nullptr || threads < 32 || threads > kEmitThreads) return (int)cudaErrorInvalidValue;
  const int cols = dmax <= 16 ? 2 : 1;
  const size_t smem = sizeof(float) * emit_floats(dmax, cols, threads, D, S, M, recs_global, direct);
  return (int)emission_grid(fn, N, cols, threads, smem, device, blocks);
}

// The moments: gamma, log_b (N, S) and frames 16-byte aligned; SG states a
// block in groups = ceil(S / SG), TF frames a tile, the records in device
// memory (recs_global) or shared memory, R blocks a group (ops/kernels/
// emission.py stats_block and stats_grid pick them); partial: scratch of R
// * S * M * (2D+1) floats; out (S, M, 2D+1).
int srhmm_emission_stats(const void* frames, const void* gamma, const void* log_b, const void* recs,
                         void* partial, void* out, long long N, int D, int S, int M, int dmax, int SG, int TF,
                         int R, int recs_global, int device, void* stream) {
  const StatsFn fn = stats_kernel_for(dmax);
  if (fn == nullptr || N < 1 || D < 1 || D > dmax || S < 1 || M < 1 || SG < 1 || SG > S || R < 1 || TF < 8 ||
      TF % 8 != 0 || kStatsThreads % TF != 0 || reinterpret_cast<uintptr_t>(frames) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gamma) % 16 != 0 || reinterpret_cast<uintptr_t>(log_b) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * stats_floats(dmax, D, SG, M, TF, recs_global);
  cudaError_t err = prepare(reinterpret_cast<const void*>(fn), smem, device);
  if (err != cudaSuccess) return (int)err;
  const int groups = (S + SG - 1) / SG;
  StatsParams p{static_cast<const float*>(frames), static_cast<const float*>(gamma),
                static_cast<const float*>(log_b), static_cast<const float*>(recs), static_cast<float*>(partial),
                N, D, S, M, SG, groups, TF, R, recs_global};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<(unsigned)((long long)groups * R), kStatsThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = S * M * (2 * D + 1), per = kReduceThreads / 32;
  sum_blocks_kernel<<<(n + per - 1) / per, kReduceThreads, 0, s>>>(static_cast<const float*>(partial),
                                                                   static_cast<float*>(out), R, n);
  return (int)cudaGetLastError();
}

// The moments blocks of these arguments one SM holds at once (the CUDA
// occupancy calculator), into *per_sm.
int srhmm_emission_stats_occupancy(int D, int M, int dmax, int SG, int TF, int recs_global, int device, int* per_sm) {
  const StatsFn fn = stats_kernel_for(dmax);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * stats_floats(dmax, D, SG, M, TF, recs_global);
  cudaError_t err = prepare(reinterpret_cast<const void*>(fn), smem, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kStatsThreads, smem);
  return (int)err;
}

}  // extern "C"
