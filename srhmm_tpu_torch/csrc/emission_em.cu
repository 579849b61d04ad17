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
// coalesced 16-byte stores.  Moments: a block takes one state and a range
// of kFramesPerBlock frames (block index s + S * range, so the S blocks of
// a range run together and share its frames through L2); per chunk of 128
// frames, frames on threads recompute q_m and write the weights g into a
// shared tile beside the frames, then columns on threads (m, c) sum the
// chunk's frames in ascending order into the block's accumulators.  Each
// block writes its own partial row, and a second pass sums the rows of a
// state over the ranges in range order: no atomics, so two runs are bitwise
// equal.  All arithmetic is fp32 fmaf on the CUDA cores (no TF32).
//
// What bounds it on the H100.  At the em_diag shape (N = 1,024,000 frames,
// D=9, S=8, M=3) the emission reads 36.9 MB of frames and writes 32.8 MB of
// log b (~0.021 ms of HBM time) for ~0.9 GFLOP (~0.014 ms of the fp32
// rate): bytes on paper, and with the frames and log b moved in whole
// 16-byte runs the kernel is the FMA chains' and the copies' latency over
// ~4 blocks an SM.  The moments read frames, gamma and log b (102 MB,
// ~0.031 ms) for ~1.4 GFLOP; that kernel reads the frames once per state (S
// blocks of a range, mostly from L2).  Later work: the moments kernel's
// redesign (TPU kernel #22), its contraction on tensor cores at fp32
// accuracy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace {

using namespace srhmm;

constexpr int kFrames = 128;            // threads a block; frames a chunk
constexpr int kChunksPerBlock = 16;     // moments: chunks a block walks
constexpr int kFramesPerBlock = kFrames * kChunksPerBlock;
constexpr int kReduceThreads = 256;

template <int DMAX>
__device__ __forceinline__ void load_frame(const float* frames, long long n, int D, bool on,
                                           float (&x)[DMAX], float (&x2)[DMAX]) {
  const float* f = frames + n * D;
#pragma unroll
  for (int e = 0; e < DMAX; ++e) {
    x[e] = (on && e < D) ? __ldg(f + e) : 0.f;
    x2[e] = x[e] * x[e];
  }
}

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
  const float* frames;  // (N, D)
  const float* gamma;   // (N, S)
  const float* log_b;   // (N, S)
  const float* recs;    // (S * M, stride) records, state-major
  float* partial;       // (ranges, S, M * Cm)
  long long N;
  int D, S, M, xstride;
};

// grid S * ranges, kFrames threads: block (s, range) = blockIdx.x % S,
// blockIdx.x / S.  Shared memory: the state's M records | weights g
// (M, kFrames + 1) | frames (kFrames, xstride) | accumulators (M * Cm).
template <int DMAX>
__global__ void __launch_bounds__(kFrames) emission_stats_kernel(const StatsParams p) {
  extern __shared__ float4 smem4[];
  const int stride = record_stride<DMAX, false>(p.D);
  const int S = p.S, M = p.M, D = p.D, Cm = 2 * D + 1, k = threadIdx.x;
  float* rec_sh = reinterpret_cast<float*>(smem4);
  float* g_sh = rec_sh + M * stride;
  float* xs_sh = g_sh + M * (kFrames + 1);
  float* acc_sh = xs_sh + kFrames * p.xstride;
  const int s = blockIdx.x % S;
  const long long range = blockIdx.x / S;
  stage(p.recs + (size_t)s * M * stride, M * stride, rec_sh);
  for (int i = k; i < M * Cm; i += kFrames) acc_sh[i] = 0.f;
  __syncthreads();
  const long long n0 = range * kFramesPerBlock;
  const long long n1 = min(p.N, n0 + kFramesPerBlock);
  for (long long c0 = n0; c0 < n1; c0 += kFrames) {
    const long long n = c0 + k;
    const bool on = n < n1;
    const int nf = (int)min((long long)kFrames, n1 - c0);
    float x[DMAX], x2[DMAX];
    load_frame<DMAX>(p.frames, n, D, on, x, x2);
#pragma unroll
    for (int e = 0; e < DMAX; ++e)
      if (e < D) xs_sh[k * p.xstride + e] = x[e];
    const float lb = on ? p.log_b[n * S + s] : kNegInf;
    const float g = (on && lb > kNegInf) ? p.gamma[n * S + s] : 0.f;
    for (int mix = 0; mix < M; ++mix) {
      const float q = diag_mix_q<DMAX>(rec_sh + mix * stride, x, x2);
      g_sh[mix * (kFrames + 1) + k] = on ? g * expf(fminf(q - lb, 0.f)) : 0.f;
    }
    __syncthreads();
    // columns on threads: each accumulator is owned by one thread and sums
    // the chunk's frames in ascending order
    for (int col = k; col < M * Cm; col += kFrames) {
      const int mix = col / Cm, c = col - mix * Cm;
      const float* gr = g_sh + mix * (kFrames + 1);
      float a = acc_sh[col];
      if (c == Cm - 1) {
        for (int kk = 0; kk < nf; ++kk) a += gr[kk];
      } else if (c < D) {
        for (int kk = 0; kk < nf; ++kk) a = fmaf(gr[kk], xs_sh[kk * p.xstride + c], a);
      } else {
        const int e = c - D;
        for (int kk = 0; kk < nf; ++kk) {
          const float v = xs_sh[kk * p.xstride + e];
          a = fmaf(gr[kk], v * v, a);
        }
      }
      acc_sh[col] = a;
    }
    __syncthreads();
  }
  float* out = p.partial + ((size_t)range * S + s) * M * Cm;
  for (int col = k; col < M * Cm; col += kFrames) out[col] = acc_sh[col];
}

// out[i] = sum over r of partial[r * n + i], r ascending.
__global__ void __launch_bounds__(kReduceThreads)
    sum_blocks_kernel(const float* partial, float* out, int ranges, int n) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int r = 0; r < ranges; ++r) a += partial[(size_t)r * n + i];
  out[i] = a;
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

// gamma, log_b (N, S); partial: scratch of ceil(N / frames_per_block) *
// S * M * (2D+1) floats, frames_per_block from
// srhmm_emission_frames_per_block(); out (S, M, 2D+1).
int srhmm_emission_stats(const void* frames, const void* gamma, const void* log_b, const void* recs,
                         void* partial, void* out, long long N, int D, int S, int M, int dmax,
                         int device, void* stream) {
  const StatsFn fn = stats_kernel_for(dmax);
  if (fn == nullptr || N < 1 || D < 1 || D > dmax || S < 1 || M < 1) return (int)cudaErrorInvalidValue;
  StatsParams p{};
  p.frames = static_cast<const float*>(frames);
  p.gamma = static_cast<const float*>(gamma);
  p.log_b = static_cast<const float*>(log_b);
  p.recs = static_cast<const float*>(recs);
  p.partial = static_cast<float*>(partial);
  p.N = N;
  p.D = D;
  p.S = S;
  p.M = M;
  p.xstride = D | 1;
  const int Cm = 2 * D + 1;
  const size_t smem = sizeof(float) * ((size_t)M * (2 * dmax + 4) + (size_t)M * (kFrames + 1) +
                                       (size_t)kFrames * p.xstride + (size_t)M * Cm);
  cudaError_t err = prepare(reinterpret_cast<const void*>(fn), smem, device);
  if (err != cudaSuccess) return (int)err;
  const long long ranges = (N + kFramesPerBlock - 1) / kFramesPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<(unsigned)(ranges * S), kFrames, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = S * M * Cm;
  sum_blocks_kernel<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), (int)ranges, n);
  return (int)cudaGetLastError();
}

int srhmm_emission_frames_per_block() { return kFramesPerBlock; }

}  // extern "C"
