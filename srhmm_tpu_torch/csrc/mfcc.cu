// MFCC kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel srhmm_tpu/features/pallas_mfcc.py:39 mfcc_pallas
// (body _mfcc_kernel :29).  One launch turns a batch of waveforms, laid end
// to end, into their MFCC frames:
//
//   y[0] = x[0], y[n] = x[n] - p x[n-1]          pre-emphasis, per waveform
//   frame f = y[min(f*shift + n, N-1)], n < W     framing (indices clamp)
//   X = DFT(frame * window), power = |X|^2        (K = W/2+1 bins)
//   logmel = log(max(power @ mel, floor))         (K, n_mels)
//   out = logmel @ dct                            (n_mels, n_mfcc)
//   out[:, 0] = log(max(sum power, floor))        with include_energy
//
// The TPU kernel ignores include_energy; this one computes column 0 as
// features/frontend.py mfcc does, so kernel and twin agree in every
// configuration.  The TPU wrapper materializes the (F, W) frames in device
// memory; here a block builds its frames in shared memory from the raw
// samples.
//
// Design.  The DFT is a mixed-radix FFT per frame in shared memory
// (ops/kernels/mfcc.py fft_plan / fft_layout): an even W is a W/2-point
// complex FFT of the sample pairs (x[2n], x[2n+1]) followed by the real
// split step, an odd W a W-point complex FFT of the real frame.  The FFT
// runs Stockham stages (out of place, ping and pong buffers, no bit
// reversal), radix 8, 4, 2, 5 and 3 as unrolled butterflies, any other
// prime factor as a generic stage (each output a sum over the R inputs
// with one root of unity each; a prime W is one such stage, a dense DFT of
// that length).  Every twiddle, root and the window come from one float32
// table built on the host in float64 and rounded once.  A block holds FB
// frames of one waveform (grid = the tiles of every waveform, found by a
// binary search over the tile offsets); its threads take every stage's
// butterflies of all FB frames, one barrier a stage.  The power is rounded
// as the twin rounds it (a product, then a sum); the mel product runs over
// each filter's nonzero bins in ascending order (a 0.0 weight adds nothing
// to a sum of non-negative terms; the weights staged in shared memory),
// then the log floor and the DCT, one output element a thread.  Plain fp32 arithmetic: no tensor cores, no
// TF32, no atomics.
//
// What bounds it on the H100.  About 11 k operations a frame at W=400 (an
// FFT's 2.5 W log2 W, the window, power, mel nonzeros, logs and DCT)
// against 640 new bytes of samples at shift=160: moving the waveform is
// the bound.  The FFT's stages go through shared memory; a block reads its
// samples once, coalesced, and stages the mel weights beside them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of a block
constexpr int kMaxStages = 10;

struct Params {
  const float* samples;       // every waveform, end to end
  const int64_t* sample_off;  // (n+1) first sample of each waveform
  const int64_t* frame_off;   // (n+1) first output row of each waveform
  const int64_t* tile_off;    // (n+1) first tile (block) of each waveform
  int n_waves;
  const float* table;    // FFT factors as (re, im) pairs, window, mel weights, DCT (n_mels, n_mfcc)
  const int* mel_range;  // (n_mels, 3): first bin, end bin, offset of the weights in table
  float* out;            // (sum F, n_mfcc)
  int W, K, N, shift, n_mels, n_mfcc, FB;
  float preemph, log_floor;
  int include_energy, split;
  int n_stages;
  int radix[kMaxStages], stride[kMaxStages], off[kMaxStages];  // off in floats
  int split_off, win_off, mel_off, n_weights, dct_off;         // floats
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float c, float2 a) { return make_float2(c * a.x, c * a.y); }
// -i a
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }

// The R-point DFT y[q] = sum_r u[r] w^(r q), w = exp(-2 pi i / R), of an
// unrolled radix; roots[a] = w^a from the table.
template <int R>
__device__ __forceinline__ void butterfly(float2 (&u)[R], const float2* roots) {
  if constexpr (R == 2) {
    const float2 a = u[0], b = u[1];
    u[0] = cadd(a, b);
    u[1] = csub(a, b);
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
    const float2 t2 = cadd(u[1], u[3]), t3 = mul_neg_i(csub(u[1], u[3]));
    u[0] = cadd(t0, t2);
    u[2] = csub(t0, t2);
    u[1] = cadd(t1, t3);
    u[3] = csub(t1, t3);
  } else if constexpr (R == 8) {
    // two 4-point DFTs of the even and the odd inputs, then w^q on the odd
    const float h = roots[1].x;  // sqrt(1/2)
    float2 e[4] = {u[0], u[2], u[4], u[6]}, o[4] = {u[1], u[3], u[5], u[7]};
    butterfly<4>(e, roots);
    butterfly<4>(o, roots);
    const float2 o1 = make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));  // w o1
    const float2 o2 = mul_neg_i(o[2]);                                             // w^2 o2
    const float2 o3 = make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));  // w^3 o3
    u[0] = cadd(e[0], o[0]);
    u[4] = csub(e[0], o[0]);
    u[1] = cadd(e[1], o1);
    u[5] = csub(e[1], o1);
    u[2] = cadd(e[2], o2);
    u[6] = csub(e[2], o2);
    u[3] = cadd(e[3], o3);
    u[7] = csub(e[3], o3);
  } else if constexpr (R == 3) {
    const float c = roots[1].x, s = -roots[1].y;  // -1/2, sin(2 pi / 3)
    const float2 t = cadd(u[1], u[2]), d = csub(u[1], u[2]);
    const float2 m = make_float2(u[0].x + c * t.x, u[0].y + c * t.y);
    u[0] = cadd(u[0], t);
    u[1] = make_float2(m.x + s * d.y, m.y - s * d.x);
    u[2] = make_float2(m.x - s * d.y, m.y + s * d.x);
  } else if constexpr (R == 5) {
    const float c1 = roots[1].x, s1 = -roots[1].y, c2 = roots[2].x, s2 = -roots[2].y;
    const float2 a1 = cadd(u[1], u[4]), b1 = csub(u[1], u[4]);
    const float2 a2 = cadd(u[2], u[3]), b2 = csub(u[2], u[3]);
    const float2 m1 = cadd(u[0], cadd(cscale(c1, a1), cscale(c2, a2)));
    const float2 m2 = cadd(u[0], cadd(cscale(c2, a1), cscale(c1, a2)));
    const float2 n1 = cadd(cscale(s1, b1), cscale(s2, b2));  // y1 = m1 - i n1, y4 = m1 + i n1
    const float2 n2 = csub(cscale(s2, b1), cscale(s1, b2));  // y2 = m2 - i n2, y3 = m2 + i n2
    u[0] = cadd(u[0], cadd(a1, a2));
    u[1] = cadd(m1, mul_neg_i(n1));
    u[4] = csub(m1, mul_neg_i(n1));
    u[2] = cadd(m2, mul_neg_i(n2));
    u[3] = csub(m2, mul_neg_i(n2));
  }
}

// One Stockham stage of an unrolled radix R over the FB frames of the
// block: butterfly i < m = N / R of a frame, k = i mod p, reads x[i + r m],
// scales input r >= 1 by its twiddle, writes y[(i - k) R + k + q p].
template <int R>
__device__ void stage_unrolled(const float2* src, float2* dst, const float2* tab, int N, int p, int FB) {
  const int m = N / R;
  const float2* roots = tab;
  const float2* tw = tab + R;
  for (int it = threadIdx.x; it < FB * m; it += blockDim.x) {
    const int f = it / m, i = it - f * m, k = i % p, j = (i - k) * R + k;
    const float2* x = src + (size_t)f * N;
    float2 u[R];
    u[0] = x[i];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2 w = __ldg(tw + (r - 1) * p + k);
      u[r] = cmul(x[i + r * m], w);
    }
    butterfly<R>(u, roots);
    float2* y = dst + (size_t)f * N;
#pragma unroll
    for (int q = 0; q < R; ++q) y[j + q * p] = u[q];
  }
}

// A generic stage of a prime R: output (k + q p) of butterfly i is
// sum_a x[i + a m] root[a (k + q p) mod p R], a ascending.
__device__ void stage_generic(const float2* src, float2* dst, const float2* root, int N, int R, int p, int FB) {
  const int m = N / R, pR = p * R;
  for (int it = threadIdx.x; it < FB * N; it += blockDim.x) {
    const int f = it / N, o = it - f * N, q = o / m, i = o - q * m, k = i % p, j = (i - k) * R + k;
    const float2* x = src + (size_t)f * N;
    const int step = k + q * p;
    float2 acc = make_float2(0.f, 0.f);
    int idx = 0;
    for (int a = 0; a < R; ++a) {
      const float2 v = x[i + a * m], w = __ldg(root + idx);
      acc.x = fmaf(v.x, w.x, fmaf(-v.y, w.y, acc.x));
      acc.y = fmaf(v.x, w.y, fmaf(v.y, w.x, acc.y));
      idx += step;
      if (idx >= pR) idx -= pR;
    }
    dst[(size_t)f * N + j + q * p] = acc;
  }
}

__global__ void __launch_bounds__(kThreads) mfcc_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  const int N = p.N, FB = p.FB, tid = threadIdx.x, nt = blockDim.x;
  float2* buf[2] = {reinterpret_cast<float2*>(smem4), reinterpret_cast<float2*>(smem4) + (size_t)FB * N};
  float* lm = reinterpret_cast<float*>(buf[1] + (size_t)FB * N);  // lm[f * n_mels + m]
  float* en = lm + FB * p.n_mels;                                 // en[f]
  float* wts = en + FB;                                           // the mel weights, table[mel_off:]
  const int64_t tile = blockIdx.x;

  // the waveform of this tile: the last w with tile_off[w] <= tile
  int lo = 0, hi = p.n_waves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.tile_off[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int w = lo;
  const int64_t base = p.sample_off[w];
  const int64_t Nw = p.sample_off[w + 1] - base;
  const int64_t F = p.frame_off[w + 1] - p.frame_off[w];
  const int64_t f0 = (tile - p.tile_off[w]) * FB;
  const int nf = (int)min64(FB, F - f0);
  const float* x = p.samples + base;
  const float* win = p.table + p.win_off;
  for (int i = tid; i < p.n_weights; i += nt) wts[i] = __ldg(p.table + p.mel_off + i);  // read in phase 4

  // 1. pre-emphasis, framing and the window into buffer 0: sample n of
  //    frame f is float n of the frame's pairs (even W) or the real part of
  //    point n (odd W).  Where the block's frames overlap (their samples
  //    fit buffer 1), the samples they span are read once, coalesced, and
  //    pre-emphasized into buffer 1 first.  Frames past the waveform's last
  //    (f >= nf) are computed on clamped samples, not stored.
  float* b0 = reinterpret_cast<float*>(buf[0]);
  auto put = [&](int f, int n, float v) {
    const float yw = __fmul_rn(v, __ldg(win + n));
    if (p.split) {
      b0[(size_t)f * 2 * N + n] = yw;
    } else {
      b0[(size_t)f * 2 * N + 2 * n] = yw;
      b0[(size_t)f * 2 * N + 2 * n + 1] = 0.f;
    }
  };
  // the samples stream through L2 only (ld.global.cg), so that they do
  // not evict the table from L1
  auto pre = [&](int64_t j) {
    const float v = __ldcg(x + j);
    return (j == 0 || p.preemph == 0.f) ? v : __fsub_rn(v, __fmul_rn(p.preemph, __ldcg(x + j - 1)));
  };
  const int span = (FB - 1) * p.shift + p.W;
  if (span <= FB * 2 * N) {
    float* ys = reinterpret_cast<float*>(buf[1]);
    const int64_t s0 = f0 * p.shift;
    // four samples a thread at a time, their loads issued together
    for (int i0 = tid; i0 < span; i0 += 4 * nt) {
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = pre(min64(s0 + i0 + r * nt, Nw - 1));
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r * nt < span) ys[i0 + r * nt] = v[r];
    }
    __syncthreads();
    // (f, n) of element tid + r nt, stepped without a division
    int f = tid / p.W, n = tid - f * p.W;
    for (; f < FB;) {
      put(f, n, ys[f * p.shift + n]);
      for (n += nt; n >= p.W && f < FB; ++f) n -= p.W;
    }
  } else {
    for (int i = tid; i < FB * p.W; i += nt) {
      const int f = i / p.W, n = i - f * p.W;
      put(f, n, pre(min64((f0 + f) * p.shift + n, Nw - 1)));
    }
  }
  __syncthreads();

  // 2. the FFT's stages, buffer s & 1 to buffer (s + 1) & 1
  for (int s = 0; s < p.n_stages; ++s) {
    const float2* src = buf[s & 1];
    float2* dst = buf[(s + 1) & 1];
    const float2* tab = reinterpret_cast<const float2*>(p.table + p.off[s]);
    switch (p.radix[s]) {
      case 8: stage_unrolled<8>(src, dst, tab, N, p.stride[s], FB); break;
      case 4: stage_unrolled<4>(src, dst, tab, N, p.stride[s], FB); break;
      case 2: stage_unrolled<2>(src, dst, tab, N, p.stride[s], FB); break;
      case 5: stage_unrolled<5>(src, dst, tab, N, p.stride[s], FB); break;
      case 3: stage_unrolled<3>(src, dst, tab, N, p.stride[s], FB); break;
      default: stage_generic(src, dst, tab, N, p.radix[s], p.stride[s], FB); break;
    }
    __syncthreads();
  }

  // 3. the power of bins k < K into the other buffer: the split step
  //    X[k] = (Z[k] + conj Z[N-k]) / 2 + e^(-2 pi i k / W) (Z[k] - conj Z[N-k]) / 2i
  //    (indices mod N) for an even W, X[k] = Z[k] for an odd one
  const float2* Z = buf[p.n_stages & 1];
  float* pw = reinterpret_cast<float*>(buf[(p.n_stages + 1) & 1]);  // pw[f * 2N + k]
  const float2* split_w = reinterpret_cast<const float2*>(p.table + p.split_off);
  for (int f = tid / p.K, k = tid - f * p.K; f < FB;) {
    const float2* z = Z + (size_t)f * N;
    float2 X;
    if (p.split) {
      const float2 a = z[k < N ? k : 0], b = z[k > 0 ? N - k : 0];
      const float2 fe = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      const float2 fo = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
      X = cadd(fe, cmul(__ldg(split_w + k), fo));
    } else {
      X = z[k];
    }
    pw[(size_t)f * 2 * N + k] = __fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y));
    for (k += nt; k >= p.K && f < FB; ++f) k -= p.K;
  }
  __syncthreads();

  // 4. the log frame energy (include_energy): one thread a frame, k in
  //    order; the mel filters over their nonzero bins, the log floor: one
  //    (frame, mel) element a thread
  if (p.include_energy) {
    for (int f = tid; f < FB; f += nt) {
      float e = 0.f;
      for (int k = 0; k < p.K; ++k) e += pw[(size_t)f * 2 * N + k];
      en[f] = logf(fmaxf(e, p.log_floor));
    }
  }
  for (int o = tid; o < FB * p.n_mels; o += nt) {
    const int f = o / p.n_mels, m = o - f * p.n_mels;
    const int k_lo = __ldg(p.mel_range + 3 * m), k_hi = __ldg(p.mel_range + 3 * m + 1);
    const float* wt = wts + (__ldg(p.mel_range + 3 * m + 2) - p.mel_off) - k_lo;
    const float* prow = pw + (size_t)f * 2 * N;
    float acc = 0.f;
#pragma unroll 4
    for (int k = k_lo; k < k_hi; ++k) acc = fmaf(prow[k], wt[k], acc);
    lm[o] = logf(fmaxf(acc, p.log_floor));
  }
  __syncthreads();

  // 5. DCT and the store of the tile's valid frames
  const float* dct = p.table + p.dct_off;
  const int64_t row0 = p.frame_off[w] + f0;
  for (int o = tid; o < nf * p.n_mfcc; o += nt) {
    const int f = o / p.n_mfcc, c = o - f * p.n_mfcc;
    float acc = 0.f;
    if (c == 0 && p.include_energy) {
      acc = en[f];
    } else {
      const float* lrow = lm + f * p.n_mels;
      for (int m = 0; m < p.n_mels; ++m) acc = fmaf(lrow[m], __ldg(dct + m * p.n_mfcc + c), acc);
    }
    p.out[(row0 + f) * p.n_mfcc + c] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// index is a device (3, n_waves+1) int64 array: sample offsets, output-row
// offsets and tile offsets (tiles of FB frames); n_tiles = index[2][n_waves].
// table / mel_range are ops/kernels/mfcc.py _constants; radix / stride /
// off are host arrays of n_stages entries (off, split_off, win_off,
// mel_off, dct_off in floats; the n_weights mel weights start at mel_off).
// Every other pointer is a device pointer.
int srhmm_mfcc(const void* samples, const void* index, int n_waves, long long n_tiles, const void* table,
               const void* mel_range, void* out, int W, int shift, int n_mels, int n_mfcc, int include_energy,
               float preemph, float log_floor, int n_stages, const int* radix, const int* stride, const int* off,
               int split_off, int win_off, int mel_off, int n_weights, int dct_off, int FB, int threads, int smem,
               int device, void* stream) {
  if (n_waves < 1 || n_tiles < 1 || n_tiles > 0x7fffffffLL || W < 1 || shift < 1 || n_mels < 1 || n_mfcc < 1 ||
      n_mfcc > n_mels || n_stages < 0 || n_stages > kMaxStages || FB < 1 || threads < 32 || threads > kThreads ||
      threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p = {};
  p.split = W % 2 == 0;
  p.N = p.split ? W / 2 : W;
  int prod = 1;
  for (int s = 0; s < n_stages; ++s) {
    if (radix[s] < 2 || stride[s] != prod) return (int)cudaErrorInvalidValue;
    p.radix[s] = radix[s];
    p.stride[s] = stride[s];
    p.off[s] = off[s];
    prod *= radix[s];
  }
  if (prod != p.N || n_weights < 0 || smem < (int)sizeof(float) * (FB * (4 * p.N + n_mels + 1) + n_weights))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t* idx = static_cast<const int64_t*>(index);
  p.samples = static_cast<const float*>(samples);
  p.sample_off = idx;
  p.frame_off = idx + (n_waves + 1);
  p.tile_off = idx + 2 * (size_t)(n_waves + 1);
  p.n_waves = n_waves;
  p.table = static_cast<const float*>(table);
  p.mel_range = static_cast<const int*>(mel_range);
  p.out = static_cast<float*>(out);
  p.W = W;
  p.K = W / 2 + 1;
  p.shift = shift;
  p.n_mels = n_mels;
  p.n_mfcc = n_mfcc;
  p.FB = FB;
  p.preemph = preemph;
  p.log_floor = log_floor;
  p.include_energy = include_energy;
  p.n_stages = n_stages;
  p.split_off = split_off;
  p.win_off = win_off;
  p.mel_off = mel_off;
  p.n_weights = n_weights;
  p.dct_off = dct_off;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mfcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  mfcc_kernel<<<(unsigned)n_tiles, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
