// MFCC kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel srhmm_tpu/features/pallas_mfcc.py:39 mfcc_pallas
// (body _mfcc_kernel :29).  One launch turns a batch of waveforms, laid end
// to end, into their MFCC frames:
//
//   y[0] = x[0], y[n] = x[n] - p x[n-1]          pre-emphasis, per waveform
//   frame f = y[min(f*shift + n, N-1)], n < W     framing (indices clamp)
//   re, im = frame @ [window*cos, window*-sin]    (W, K = W/2+1)
//   power = re^2 + im^2
//   logmel = log(max(power @ mel, floor))         (K, n_mels)
//   out = logmel @ dct                            (n_mels, n_mfcc)
//   out[:, 0] = log(max(sum power, floor))        with include_energy
//
// The TPU kernel ignores include_energy; this one computes column 0 as
// features/frontend.py mfcc does, so kernel and twin agree in every
// configuration.  The TPU wrapper materializes the (F, W) frames in device
// memory (2.5x the waveform's bytes at W=400, shift=160); here a block
// builds its frames in shared memory from the raw samples.
//
// Design.  A block owns a tile of 32 frames of one waveform (grid = the
// tiles of every waveform; a block finds its waveform by a binary search
// over the tile offsets).  Shared memory holds the pre-emphasized frame
// tile transposed (W x 32, frame fastest, read as float4 broadcasts), the
// power tile (32 x K), the log-mel tile (32 x n_mels) and the energies:
// 80 KB at W=400, K=201, n_mels=26, so two blocks fit an SM; at most 213 KB
// (W=1024, n_mels=128).  Each thread owns DFT columns k (threads cover K in
// as few passes of <= 256 columns as possible) and accumulates re and im of
// all 32 frames in registers: per sample n two loads of the (W, K)
// constants, which are too big for shared memory (2 x 322 KB at W=400) and
// stay resident in the 50 MB L2, eight float4 shared loads and 64 FMAs.
// The mel product, the log floor and the DCT then run out of shared memory,
// one output element a thread.  Plain fp32 FMAs throughout: no tensor cores,
// no TF32.  Pre-emphasis and the power are rounded as the twin rounds them
// (a product, then a sum), so only the summation order of the products
// differs from the twin.
//
// What bounds it on the H100.  The function itself needs little: with the
// DFT taken as a real FFT (2.5 W log2 W, ~8.6 k operations a frame at
// W=400) plus the window, power, mel nonzeros, logs and DCT, about 11 k
// operations a frame against 640 new bytes of samples at shift=160, so
// moving the waveform is the bound.  This kernel runs the dense DFT
// instead, 4 W K = 321,600 scalar fp32 operations a frame (about 30x the
// function's), with the constants streamed from L2; an FFT stage or a
// 3xTF32 tensor-core product is the lever.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 32;       // frames per block
constexpr int kMaxThreads = 256;  // DFT columns a pass

struct Params {
  const float* samples;       // every waveform, end to end
  const int64_t* sample_off;  // (n+1) first sample of each waveform
  const int64_t* frame_off;   // (n+1) first output row of each waveform
  const int64_t* tile_off;    // (n+1) first tile (block) of each waveform
  int n_waves;
  const float* cosm;  // (W, K) window * cos
  const float* sinm;  // (W, K) window * -sin
  const float* mel;   // (K, n_mels)
  const float* dct;   // (n_mels, n_mfcc)
  float* out;         // (sum F, n_mfcc)
  int W, K, shift, n_mels, n_mfcc;
  float preemph, log_floor;
  int include_energy;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// re[f] += x[f] c, im[f] += x[f] s for the 32 frames of one sample row
__device__ __forceinline__ void dft_row(const float* __restrict__ row, float c, float s,
                                        float (&re)[kFrames], float (&im)[kFrames]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < kFrames / 4; ++q) {
    const float4 v = r4[q];
    re[4 * q + 0] = fmaf(v.x, c, re[4 * q + 0]);
    im[4 * q + 0] = fmaf(v.x, s, im[4 * q + 0]);
    re[4 * q + 1] = fmaf(v.y, c, re[4 * q + 1]);
    im[4 * q + 1] = fmaf(v.y, s, im[4 * q + 1]);
    re[4 * q + 2] = fmaf(v.z, c, re[4 * q + 2]);
    im[4 * q + 2] = fmaf(v.z, s, im[4 * q + 2]);
    re[4 * q + 3] = fmaf(v.w, c, re[4 * q + 3]);
    im[4 * q + 3] = fmaf(v.w, s, im[4 * q + 3]);
  }
}

__global__ void __launch_bounds__(kMaxThreads) mfcc_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // xs[n * kFrames + f]
  float* pw = xs + (size_t)p.W * kFrames;       // pw[f * K + k]
  float* lm = pw + (size_t)kFrames * p.K;       // lm[f * n_mels + m]
  float* en = lm + kFrames * p.n_mels;          // en[f]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t tile = blockIdx.x;

  // the waveform of this tile: the last w with tile_off[w] <= tile
  int lo = 0, hi = p.n_waves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.tile_off[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int w = lo;
  const int64_t base = p.sample_off[w];
  const int64_t N = p.sample_off[w + 1] - base;
  const int64_t F = p.frame_off[w + 1] - p.frame_off[w];
  const int64_t f0 = (tile - p.tile_off[w]) * kFrames;
  const int nf = (int)min64(kFrames, F - f0);
  const float* x = p.samples + base;

  // 1. pre-emphasis and framing into shared memory; frames past the
  //    waveform's last (f >= nf) are computed on clamped samples, not stored
  for (int i = tid; i < p.W * kFrames; i += nt) {
    const int f = i % kFrames;
    const int n = i / kFrames;
    const int64_t j = min64((f0 + f) * p.shift + n, N - 1);
    const float v = __ldg(x + j);
    xs[i] = (j == 0 || p.preemph == 0.f) ? v : __fsub_rn(v, __fmul_rn(p.preemph, __ldg(x + j - 1)));
  }
  __syncthreads();

  // 2. windowed DFT and power: thread tid owns columns k = k0 + tid
  for (int k0 = 0; k0 < p.K; k0 += nt) {
    const int k = k0 + tid;
    if (k < p.K) {
      float re[kFrames], im[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) re[f] = im[f] = 0.f;
      const float* cp = p.cosm + k;
      const float* sp = p.sinm + k;
      const size_t K = p.K;
      int n = 0;
      for (; n + 4 <= p.W; n += 4) {
        float c[4], s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          c[u] = __ldg(cp + (size_t)(n + u) * K);
          s[u] = __ldg(sp + (size_t)(n + u) * K);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) dft_row(xs + (n + u) * kFrames, c[u], s[u], re, im);
      }
      for (; n < p.W; ++n) dft_row(xs + n * kFrames, __ldg(cp + (size_t)n * K), __ldg(sp + (size_t)n * K), re, im);
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        pw[f * p.K + k] = __fadd_rn(__fmul_rn(re[f], re[f]), __fmul_rn(im[f], im[f]));
    }
  }
  __syncthreads();

  // 3. the log frame energy (include_energy): one thread a frame, k in order
  if (p.include_energy) {
    for (int f = tid; f < kFrames; f += nt) {
      float e = 0.f;
      for (int k = 0; k < p.K; ++k) e += pw[f * p.K + k];
      en[f] = logf(fmaxf(e, p.log_floor));
    }
  }
  // 4. mel filterbank and log floor: one (frame, mel) element a thread
  for (int o = tid; o < kFrames * p.n_mels; o += nt) {
    const int f = o / p.n_mels;
    const int m = o - f * p.n_mels;
    const float* prow = pw + f * p.K;
    float acc = 0.f;
    for (int k = 0; k < p.K; ++k) acc = fmaf(prow[k], __ldg(p.mel + (size_t)k * p.n_mels + m), acc);
    lm[o] = logf(fmaxf(acc, p.log_floor));
  }
  __syncthreads();

  // 5. DCT and the store of the tile's valid frames
  const int64_t row0 = p.frame_off[w] + f0;
  for (int o = tid; o < nf * p.n_mfcc; o += nt) {
    const int f = o / p.n_mfcc;
    const int c = o - f * p.n_mfcc;
    float acc = 0.f;
    if (c == 0 && p.include_energy) {
      acc = en[f];
    } else {
      const float* lrow = lm + f * p.n_mels;
      for (int m = 0; m < p.n_mels; ++m) acc = fmaf(lrow[m], __ldg(p.dct + m * p.n_mfcc + c), acc);
    }
    p.out[(row0 + f) * p.n_mfcc + c] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// index is a device (3, n_waves+1) int64 array: sample offsets, output-row
// offsets and tile offsets; n_tiles = index[2][n_waves].  Every pointer is a
// device pointer.
int srhmm_mfcc(const void* samples, const void* index, int n_waves, long long n_tiles,
               const void* cosm, const void* sinm, const void* mel, const void* dct, void* out,
               int W, int K, int shift, int n_mels, int n_mfcc, float preemph, float log_floor,
               int include_energy, int threads, int device, void* stream) {
  if (n_waves < 1 || n_tiles < 1 || n_tiles > 0x7fffffffLL || W < 1 || K != W / 2 + 1 ||
      shift < 1 || n_mels < 1 || n_mfcc < 1 || n_mfcc > n_mels || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  const int64_t* idx = static_cast<const int64_t*>(index);
  p.samples = static_cast<const float*>(samples);
  p.sample_off = idx;
  p.frame_off = idx + (n_waves + 1);
  p.tile_off = idx + 2 * (size_t)(n_waves + 1);
  p.n_waves = n_waves;
  p.cosm = static_cast<const float*>(cosm);
  p.sinm = static_cast<const float*>(sinm);
  p.mel = static_cast<const float*>(mel);
  p.dct = static_cast<const float*>(dct);
  p.out = static_cast<float*>(out);
  p.W = W;
  p.K = K;
  p.shift = shift;
  p.n_mels = n_mels;
  p.n_mfcc = n_mfcc;
  p.preemph = preemph;
  p.log_floor = log_floor;
  p.include_energy = include_energy;
  const size_t smem = sizeof(float) * (size_t)kFrames * ((size_t)W + K + n_mels + 1);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mfcc_kernel<<<(unsigned)n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
