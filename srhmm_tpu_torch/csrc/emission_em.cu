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
// Design.  Emission: one thread per frame, 128 frames a block, the S * M
// records of the model staged in shared memory once per block and read as
// float4 broadcasts; the mixtures of a state fold through the online
// logsumexp of emission.cuh.  Moments: a block takes one state and a range
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
// log b (~0.021 ms of HBM time) for ~0.9 GFLOP; the moments read frames,
// gamma and log b (102 MB, ~0.031 ms) for ~1.4 GFLOP: both are bounded by
// bytes on paper.  The moments kernel reads the frames once per state (S
// blocks of a range, mostly from L2).  Later work: a warp per frame tile
// with the records in registers, the moment contraction on tensor cores at
// fp32 accuracy.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

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

// grid ceil(N / kFrames); thread k takes frame blockIdx.x * kFrames + k.
template <int DMAX>
__global__ void __launch_bounds__(kFrames)
    emission_log_b_kernel(const float* frames, const float* recs, float* log_b, long long N, int D,
                          int S, int M) {
  extern __shared__ float4 smem4[];
  float* rec_sh = reinterpret_cast<float*>(smem4);
  const int stride = record_stride<DMAX, false>(D);
  stage(recs, S * M * stride, rec_sh);
  __syncthreads();
  const long long n = (long long)blockIdx.x * kFrames + threadIdx.x;
  if (n >= N) return;
  float x[DMAX], x2[DMAX];
  load_frame<DMAX>(frames, n, D, true, x, x2);
  for (int s = 0; s < S; ++s) log_b[n * S + s] = diag_state_log_b<DMAX>(rec_sh + s * M * stride, M, x, x2);
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

using EmitFn = void (*)(const float*, const float*, float*, long long, int, int, int);
using StatsFn = void (*)(StatsParams);

// which: 0 = emission, 1 = moments; nullptr for a bound that is not compiled
void* kernel_for(int which, int dmax) {
  switch (dmax) {
#define SRHMM_CASE(B)                                                                           \
  case B:                                                                                       \
    return which == 0 ? reinterpret_cast<void*>(static_cast<EmitFn>(emission_log_b_kernel<B>)) \
                      : reinterpret_cast<void*>(static_cast<StatsFn>(emission_stats_kernel<B>));
    SRHMM_CASE(4)
    SRHMM_CASE(8)
    SRHMM_CASE(12)
    SRHMM_CASE(16)
    SRHMM_CASE(32)
    SRHMM_CASE(64)
#undef SRHMM_CASE
    default:
      return nullptr;
  }
}

cudaError_t prepare(const void* fn, size_t smem, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 = ok).
// frames (N, D), records (S * M, 2 * dmax + 4) float32 (state-major),
// device pointers.

int srhmm_emission_log_b(const void* frames, const void* recs, void* log_b, long long N, int D,
                         int S, int M, int dmax, int device, void* stream) {
  void* fn = kernel_for(0, dmax);
  if (fn == nullptr || N < 1 || D < 1 || D > dmax || S < 1 || M < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)S * M * (2 * dmax + 4);
  cudaError_t err = prepare(fn, smem, device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (N + kFrames - 1) / kFrames;
  reinterpret_cast<EmitFn>(fn)<<<(unsigned)blocks, kFrames, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frames), static_cast<const float*>(recs), static_cast<float*>(log_b), N,
      D, S, M);
  return (int)cudaGetLastError();
}

// gamma, log_b (N, S); partial: scratch of ceil(N / frames_per_block) *
// S * M * (2D+1) floats, frames_per_block from
// srhmm_emission_frames_per_block(); out (S, M, 2D+1).
int srhmm_emission_stats(const void* frames, const void* gamma, const void* log_b, const void* recs,
                         void* partial, void* out, long long N, int D, int S, int M, int dmax,
                         int device, void* stream) {
  void* fn = kernel_for(1, dmax);
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
  cudaError_t err = prepare(fn, smem, device);
  if (err != cudaSuccess) return (int)err;
  const long long ranges = (N + kFramesPerBlock - 1) / kFramesPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  reinterpret_cast<StatsFn>(fn)<<<(unsigned)(ranges * S), kFrames, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = S * M * Cm;
  sum_blocks_kernel<<<(n + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), (int)ranges, n);
  return (int)cudaGetLastError();
}

int srhmm_emission_frames_per_block() { return kFramesPerBlock; }

}  // extern "C"
