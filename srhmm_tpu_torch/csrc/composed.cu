// Composed-lattice E-step kernels of embedded and tied-state training for
// NVIDIA Hopper (sm_90a): bank emission, composed forward, composed
// backward-stats and bank moments, for P in [1, 6] parameter streams.
//
// Replace the TPU kernels of srhmm_tpu/ops/pallas/composed_pallas.py:
//   bank_emission_kernel           <- :218 bank_emission_pallas
//   composed_forward_kernel        <- :348 composed_forward_pallas
//   composed_backward_stats_kernel <- :474 composed_backward_stats_pallas
//   bank_moments_kernel + segment_rows_kernel
//                                  <- :707 bank_moments_lattice_pallas (gamma
//                                     (T, LS, B)) and :792 bank_moments_pallas
//                                     (gamma (B, LS, T)): one kernel, the
//                                     gamma strides are arguments
// The plain PyTorch twins (ops/kernels/composed.py *_plain) compute the same
// functions.
//
// The model.  Every utterance b composes its transcript's L units of S
// states into one left-to-right chain of LS = L*S rows; row j of utterance b
// emits from bank row ids[b, j] (unit*S + state for embedded training, the
// senone id for tied training), and its transitions are per utterance:
// band+1 diagonals of the (LS, LS) chain matrix, diag[d][j, b] =
// log a_b[j-d, j] (column form, forward) or log a_b[j, j+d] (row form,
// backward), NEG_INF where there is no arc.
//
// bank_emission: log_b[t, j, b] = max(sum_p logsumexp_m q_pm, NEG_INF) with
// the per-mixture weighted log-likelihoods of csrc/emission.cuh (diagonal
// lift, or the full-covariance Cholesky z with the 1e20 clamp before the
// weight), for every frame t < T.  Layout (T, LS, B).
// composed_forward: log-alpha (T, LS, B); frame 0 starts in row 0 and always
// initializes the carry; frames t >= length repeat the last valid row.
// composed_backward_stats: log-beta from the final row LS-1 (rows
// t >= length-1 take the init row), gamma (T, LS, B) masked by t < length
// and vmask, per-diagonal xi sums (row form, t < length-1), den_trans and
// den_mix (LS, B); every exponent clamped at 0 (the TPU kernel's
// min(., 0)).
// bank_moments: per (utterance, row) the gamma-weighted moments
// sum_t gamma[t, j, b] post_m(t) [x; x^2 or vec(x x^T); 1] with the
// posteriors recomputed from the staged records and each stream's OWN
// mixture logsumexp (0 where it is <= NEG_INF/2); then the rows of all
// (utterance, row) pairs that share a bank row are summed in the order of a
// stable sort of the ids.
//
// What bounds it on the H100, and what the design does about it.
// * The TPU kept the whole parameter bank resident in 48 MB of VMEM; a
//   Hopper block has 227 KB of shared memory, and the bank is 0.4 MB
//   (40 units x 3 states x 32 mixtures, D=13) to 10.1 MB (2000 senones x
//   16 mixtures, D=39).  So the emission and moment kernels put FRAMES on
//   threads (time was the TPU's lane axis too) and walk the utterance's
//   rows, staging one row's mixture records at a time in shared memory from
//   device memory / L2 (4.6-8.4 KB a row).  The emission is fp32 fmaf on
//   the CUDA cores (no TF32): ~16 GFLOP (emb_c4) to ~24 GFLOP (tied_c5) a
//   pass, so both are bounded by operations; the records are read once per
//   (128-frame chunk, row), from L2.
// * The lattice kernels are the fused_em.cu recursion structure without
//   the emission: one thread per (row, utterance), the whole time loop in
//   the kernel, one value per thread exchanged through a double-buffered
//   shared row each frame.  They move 2-4 (T, LS, B) float lattices and do
//   ~10 operations per element: bound by bytes, and in practice by the
//   serial chain of T frames per thread.
// * The moments scatter.  The TPU's sequential grid made its read-modify-
//   write into bank rows race-free; Hopper blocks run in parallel, and fp32
//   atomics would sum in a different order on every run.  So pass 1 writes
//   per-(utterance, row) moment rows (64 MB at emb_c4, 155 MB at tied_c5),
//   each summed over frames in ascending order inside one block (frames on
//   threads, then columns on threads over a shared-memory tile of posterior
//   weights and features), and pass 2 reduces them per bank row in a fixed
//   order (the stable sort of the ids), one thread per (bank row, column):
//   two runs are bitwise equal.
// Later work: several utterances per block sharing staged records, tensor
// cores for the moment contraction at fp32 accuracy, fusing emission into
// the forward pass.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

namespace {

using namespace srhmm;

constexpr int kFrames = 128;                // frames (threads) per bank-kernel block
constexpr int kMaxBand = 15;                // diagonals - 1 of the composed chain
constexpr int kMaxLatticeThreads = 1024;    // LS * U threads per lattice block
constexpr int kReduceThreads = 256;

struct BankParams {
  const int* ids;                     // (B, LS) bank row of every composed row
  const float* banks[kMaxStreams];    // per stream: (NB, M_p, stride_p) records
  int mixes[kMaxStreams];             // M_p
  int strides[kMaxStreams];           // floats per record
  int rec_offs[kMaxStreams];          // offset of stream p's staged records in shared memory
  int n_streams;
  int rec_floats;                     // sum_p M_p * stride_p
  int NB;
  const float* feats;                 // (B, T, D), shared by the streams
  int B, T, D, LS;
};

struct MomParams {
  const float* gamma;                 // gamma[t * g_st + j * g_sj + b * g_sb]
  long long g_st, g_sj, g_sb;
  const int* lengths;                 // (B,)
  float* mom_pos[kMaxStreams];        // per stream: (B * LS, M_p * Cm)
  int acc_offs[kMaxStreams];          // offset of stream p's accumulators in shared memory
  int acc_floats;                     // sum_p M_p * Cm
  int max_mix;
  int xstride;                        // shared-memory row of one frame's features (odd)
};

struct LatticeParams {
  const float* log_b;      // (T, LS, B)
  const float* la;         // (T, LS, B) (backward)
  const float* diag;       // (nd, LS, B): column form (forward), row form (backward)
  const int* lengths;      // (B,)
  const float* safe_z;     // (B,) (backward)
  const float* vmask;      // (B,) (backward)
  float* la_out;           // (T, LS, B) (forward)
  float* gamma;            // (T, LS, B) (backward)
  float* xi;               // (nd, LS, B) (backward)
  float* den_trans;        // (LS, B) (backward)
  float* den_mix;          // (LS, B) (backward)
  int T, LS, B, nd, U;     // U utterances per block: LS * U threads
};

// Stage the records of bank row `row` of every stream into shared memory.
// Records are whole float4s (the strides are multiples of 4 floats).
__device__ __forceinline__ void stage_records(const BankParams& p, int row, float* rec_sh) {
  for (int q = 0; q < p.n_streams; ++q) {
    const int n4 = p.mixes[q] * p.strides[q] / 4;
    const float4* src =
        reinterpret_cast<const float4*>(p.banks[q] + (size_t)row * p.mixes[q] * p.strides[q]);
    float4* dst = reinterpret_cast<float4*>(rec_sh + p.rec_offs[q]);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
  }
}

template <int DMAX>
__device__ __forceinline__ void load_x(const BankParams& p, int b, int t, bool on, float (&x)[DMAX]) {
  const float* f = p.feats + ((size_t)b * p.T + t) * p.D;
#pragma unroll
  for (int e = 0; e < DMAX; ++e) x[e] = (on && e < p.D) ? __ldg(f + e) : 0.f;
}

template <int DMAX, bool FULL>
__device__ __forceinline__ float mix_q(const float* rec, int D, const float (&x)[DMAX],
                                       const float (&x2)[DMAX]) {
  if constexpr (FULL) {
    return full_mix_q<DMAX>(rec, D, x);
  } else {
    return diag_mix_q<DMAX>(rec, x, x2);
  }
}

// grid (ceil(T / kFrames), B), kFrames threads: thread k takes frame
// blockIdx.x * kFrames + k of utterance blockIdx.y and walks the LS rows.
template <int DMAX, bool FULL>
__global__ void __launch_bounds__(kFrames) bank_emission_kernel(const BankParams p, float* log_b) {
  extern __shared__ float4 smem4[];
  float* rec_sh = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t = blockIdx.x * kFrames + threadIdx.x;
  const bool on = t < p.T;
  float x[DMAX], x2[DMAX];
  load_x<DMAX>(p, b, t, on, x);
#pragma unroll
  for (int e = 0; e < DMAX; ++e) x2[e] = x[e] * x[e];
  for (int j = 0; j < p.LS; ++j) {
    const int row = p.ids[(size_t)b * p.LS + j];
    const bool ok = row >= 0 && row < p.NB;
    __syncthreads();  // the previous row's records are no longer read
    if (ok) stage_records(p, row, rec_sh);
    __syncthreads();
    if (!on) continue;
    float lb = 0.f;
    for (int q = 0; q < p.n_streams; ++q) {
      const int M = p.mixes[q], stride = p.strides[q];
      const float* rec = rec_sh + p.rec_offs[q];
      float m = kNegInf, e = 0.f;
      for (int mix = 0; mix < M; ++mix) lse_push(mix_q<DMAX, FULL>(rec + mix * stride, p.D, x, x2), m, e);
      const float v = lse_value(m, e);
      lb = (q == 0) ? v : lb + v;
    }
    // an id outside the bank poisons its row instead of reading stray memory
    log_b[((size_t)t * p.LS + j) * p.B + b] = ok ? fmaxf(lb, kNegInf) : __int_as_float(0x7fc00000);
  }
}

// One thread per (row j, utterance b): thread j * U + u, b = blockIdx.x * U + u.
__global__ void __launch_bounds__(kMaxLatticeThreads) composed_forward_kernel(const LatticeParams p) {
  extern __shared__ float sh[];
  const int LS = p.LS, U = p.U, nt = LS * U, tid = threadIdx.x;
  const int j = tid / U, u = tid - j * U;
  const int b = blockIdx.x * U + u;
  const bool live = b < p.B;
  float dcol[kMaxBand + 1];
#pragma unroll
  for (int d = 0; d <= kMaxBand; ++d)
    dcol[d] = (live && d < p.nd) ? p.diag[((size_t)d * LS + j) * p.B + b] : kNegInf;
  const int len = live ? p.lengths[b] : 0;
  float carry = kNegInf;
  for (int t = 0; t < p.T; ++t) {
    const size_t o = ((size_t)t * LS + j) * p.B + b;
    const float lb = live ? p.log_b[o] : kNegInf;
    const float* prev = sh + ((t + 1) & 1) * nt;
    if (t == 0) {
      carry = fmaxf((j == 0 ? 0.f : kNegInf) + lb, kNegInf);
    } else if (t < len) {
      // sources j - d below row 0 only add exp(-2e30 - m) = 0: skipped
      float m = kNegInf;
#pragma unroll
      for (int d = 0; d <= kMaxBand; ++d)
        if (d < p.nd && j - d >= 0) m = fmaxf(m, prev[(j - d) * U + u] + dcol[d]);
      float e = 0.f;
#pragma unroll
      for (int d = 0; d <= kMaxBand; ++d)
        if (d < p.nd && j - d >= 0) e += expf(prev[(j - d) * U + u] + dcol[d] - m);
      const float upd = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
      carry = fmaxf(upd + lb, kNegInf);
    }
    sh[(t & 1) * nt + tid] = carry;
    if (live) p.la_out[o] = carry;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kMaxLatticeThreads)
    composed_backward_stats_kernel(const LatticeParams p) {
  extern __shared__ float sh[];
  const int LS = p.LS, U = p.U, nt = LS * U, tid = threadIdx.x;
  const int j = tid / U, u = tid - j * U;
  const int b = blockIdx.x * U + u;
  const bool live = b < p.B;
  float drow[kMaxBand + 1], xi[kMaxBand + 1];
#pragma unroll
  for (int d = 0; d <= kMaxBand; ++d) {
    drow[d] = (live && d < p.nd) ? p.diag[((size_t)d * LS + j) * p.B + b] : kNegInf;
    xi[d] = 0.f;
  }
  const int len = live ? p.lengths[b] : 0;
  const float z = live ? p.safe_z[b] : 0.f;
  const bool valid = live && p.vmask[b] > 0.f;
  const float beta_init = (j == LS - 1) ? 0.f : kNegInf;  // the unpadded final row
  float beta = beta_init;  // log-beta at t+1 until this frame's update
  float dt = 0.f, dm = 0.f;
  for (int t = p.T - 1; t >= 0; --t) {
    const size_t o = ((size_t)t * LS + j) * p.B + b;
    const float la_t = live ? p.la[o] : kNegInf;
    // log_b[t+1]: at t = T-1 every use is masked (t < length-1 is impossible)
    const float lbn = (live && t + 1 < p.T) ? p.log_b[o + (size_t)LS * p.B] : kNegInf;
    const float inner = fmaxf(lbn + beta, kNegInf);
    float* ib = sh + (t & 1) * nt;
    ib[tid] = inner;
    __syncthreads();
    const bool stepping = len - 1 > t;  // t < length-1; else the init row
    const bool m_xi = stepping && valid;
    // destinations j + d past the last row add exp(min(-2e30, 0)) = 0: skipped
    if (m_xi) {
#pragma unroll
      for (int d = 0; d <= kMaxBand; ++d)
        if (d < p.nd && j + d < LS) xi[d] += expf(fminf(la_t + drow[d] + ib[(j + d) * U + u] - z, 0.f));
    }
    if (stepping) {
      float m = kNegInf;
#pragma unroll
      for (int d = 0; d <= kMaxBand; ++d)
        if (d < p.nd && j + d < LS) m = fmaxf(m, ib[(j + d) * U + u] + drow[d]);
      float e = 0.f;
#pragma unroll
      for (int d = 0; d <= kMaxBand; ++d)
        if (d < p.nd && j + d < LS) e += expf(ib[(j + d) * U + u] + drow[d] - m);
      beta = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
    } else {
      beta = beta_init;
    }
    if (live) {
      const float g = (valid && t < len) ? expf(fminf(la_t + beta - z, 0.f)) : 0.f;
      p.gamma[o] = g;
      dm += g;
      if (m_xi) dt += g;
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d <= kMaxBand; ++d)
      if (d < p.nd) p.xi[((size_t)d * LS + j) * p.B + b] = xi[d];
    p.den_trans[(size_t)j * p.B + b] = dt;
    p.den_mix[(size_t)j * p.B + b] = dm;
  }
}

// Pass 1 of the moments: grid (LS, B), kFrames threads; block (j, b) writes
// the moment rows of composed row j of utterance b.  Shared memory: the
// row's records | posterior weights gm (max_mix, kFrames + 1) | features
// (kFrames, xstride) | accumulators (sum_p M_p * Cm).
template <int DMAX, bool FULL>
__global__ void __launch_bounds__(kFrames) bank_moments_kernel(const BankParams p, const MomParams m) {
  extern __shared__ float4 smem4[];
  float* rec_sh = reinterpret_cast<float*>(smem4);
  float* gm_sh = rec_sh + p.rec_floats;
  float* xs_sh = gm_sh + (size_t)m.max_mix * (kFrames + 1);
  float* acc_sh = xs_sh + (size_t)kFrames * m.xstride;
  const int j = blockIdx.x, b = blockIdx.y, k = threadIdx.x;
  const int D = p.D;
  const int Cm = FULL ? D + D * D + 1 : 2 * D + 1;
  const int row = p.ids[(size_t)b * p.LS + j];
  const bool ok = row >= 0 && row < p.NB;
  if (ok) stage_records(p, row, rec_sh);
  for (int i = k; i < m.acc_floats; i += kFrames) acc_sh[i] = 0.f;
  __syncthreads();
  // frames t >= length carry gamma = 0 (the backward kernel's mask): skipped
  const int len = ok ? min(m.lengths[b], p.T) : 0;
  for (int t0 = 0; t0 < len; t0 += kFrames) {
    const int t = t0 + k, nf = min(kFrames, len - t0);
    const bool on = t < len;
    float x[DMAX], x2[DMAX];
    load_x<DMAX>(p, b, t, on, x);
#pragma unroll
    for (int e = 0; e < DMAX; ++e) x2[e] = x[e] * x[e];
#pragma unroll
    for (int e = 0; e < DMAX; ++e)
      if (e < D) xs_sh[k * m.xstride + e] = x[e];
    const float g = on ? m.gamma[t * m.g_st + j * m.g_sj + b * m.g_sb] : 0.f;
    for (int q = 0; q < p.n_streams; ++q) {
      const int M = p.mixes[q], stride = p.strides[q];
      const float* rec = rec_sh + p.rec_offs[q];
      float mx = kNegInf, ex = 0.f;
      for (int mix = 0; mix < M; ++mix) {
        const float qv = mix_q<DMAX, FULL>(rec + mix * stride, D, x, x2);
        gm_sh[mix * (kFrames + 1) + k] = qv;
        lse_push(qv, mx, ex);
      }
      const float lbp = lse_value(mx, ex);  // this stream's own log b
      for (int mix = 0; mix < M; ++mix) {
        float* gq = gm_sh + mix * (kFrames + 1) + k;
        const float post = (lbp > 0.5f * kNegInf) ? expf(fminf(*gq - lbp, 0.f)) : 0.f;
        *gq = on ? g * post : 0.f;
      }
      __syncthreads();
      // columns on threads: each accumulator is owned by one thread and sums
      // the chunk's frames in ascending order
      float* acc = acc_sh + m.acc_offs[q];
      for (int col = k; col < M * Cm; col += kFrames) {
        const int mix = col / Cm, c = col - mix * Cm;
        const float* gr = gm_sh + mix * (kFrames + 1);
        float a = acc[col];
        if (c == Cm - 1) {
          for (int kk = 0; kk < nf; ++kk) a += gr[kk];
        } else if (c < D) {
          for (int kk = 0; kk < nf; ++kk) a = fmaf(gr[kk], xs_sh[kk * m.xstride + c], a);
        } else if (!FULL) {
          const int e = c - D;
          for (int kk = 0; kk < nf; ++kk) {
            const float v = xs_sh[kk * m.xstride + e];
            a = fmaf(gr[kk], v * v, a);
          }
        } else {
          const int r = c - D, d = r / D, e = r - d * D;  // block d of the lift holds x * x[d]
          for (int kk = 0; kk < nf; ++kk)
            a = fmaf(gr[kk], xs_sh[kk * m.xstride + e] * xs_sh[kk * m.xstride + d], a);
        }
        acc[col] = a;
      }
      __syncthreads();
    }
  }
  const float nan = __int_as_float(0x7fc00000);
  for (int q = 0; q < p.n_streams; ++q) {
    const int n = p.mixes[q] * Cm;
    float* out = m.mom_pos[q] + ((size_t)b * p.LS + j) * n;
    for (int col = k; col < n; col += kFrames) out[col] = ok ? acc_sh[m.acc_offs[q] + col] : nan;
  }
}

// Pass 2: out[r, col] = sum over k in [offsets[r], offsets[r+1]) of
// rows[order[k], col], in that order.  grid (NB, ceil(cols / kReduceThreads)).
__global__ void __launch_bounds__(kReduceThreads)
    segment_rows_kernel(const float* rows, const int* order, const int* offsets, float* out, int cols) {
  const int r = blockIdx.x;
  const int col = blockIdx.y * kReduceThreads + threadIdx.x;
  if (col >= cols) return;
  float a = 0.f;
  for (int k = offsets[r]; k < offsets[r + 1]; ++k) a += rows[(size_t)order[k] * cols + col];
  out[(size_t)r * cols + col] = a;
}

using EmitFn = void (*)(BankParams, float*);
using MomFn = void (*)(BankParams, MomParams);

template <int DMAX, bool FULL>
void pick(int which, void** fn) {
  if (which == 0) {
    *fn = reinterpret_cast<void*>(static_cast<EmitFn>(bank_emission_kernel<DMAX, FULL>));
  } else {
    *fn = reinterpret_cast<void*>(static_cast<MomFn>(bank_moments_kernel<DMAX, FULL>));
  }
}

// which: 0 = emission, 1 = moments; nullptr for a bound that is not
// compiled (full covariance: D <= 16)
void* bank_kernel_for(int which, int dmax, int full) {
  void* fn = nullptr;
  if (full) {
    switch (dmax) {
      case 4: pick<4, true>(which, &fn); break;
      case 8: pick<8, true>(which, &fn); break;
      case 12: pick<12, true>(which, &fn); break;
      case 16: pick<16, true>(which, &fn); break;
      default: break;
    }
    return fn;
  }
  switch (dmax) {
    case 4: pick<4, false>(which, &fn); break;
    case 8: pick<8, false>(which, &fn); break;
    case 12: pick<12, false>(which, &fn); break;
    case 16: pick<16, false>(which, &fn); break;
    case 32: pick<32, false>(which, &fn); break;
    case 64: pick<64, false>(which, &fn); break;
    default: break;
  }
  return fn;
}

int fill_bank(BankParams& p, const void* ids, const void* const* banks, const int* mixes,
              const int* strides, int n_streams, int NB, const void* feats, int B, int T, int D,
              int LS) {
  if (n_streams < 1 || n_streams > kMaxStreams || B < 1 || T < 1 || D < 1 || LS < 1 || NB < 1) {
    return (int)cudaErrorInvalidValue;
  }
  p = BankParams{};
  int off = 0;
  for (int q = 0; q < n_streams; ++q) {
    if (mixes[q] < 1 || strides[q] < 4 || strides[q] % 4 != 0) return (int)cudaErrorInvalidValue;
    p.banks[q] = static_cast<const float*>(banks[q]);
    p.mixes[q] = mixes[q];
    p.strides[q] = strides[q];
    p.rec_offs[q] = off;
    off += mixes[q] * strides[q];
  }
  p.ids = static_cast<const int*>(ids);
  p.n_streams = n_streams;
  p.rec_floats = off;
  p.NB = NB;
  p.feats = static_cast<const float*>(feats);
  p.B = B;
  p.T = T;
  p.D = D;
  p.LS = LS;
  return 0;
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int lattice_launch(bool backward, const LatticeParams& p, int device, void* stream) {
  if (p.T < 1 || p.LS < 1 || p.B < 1 || p.U < 1 || p.nd < 1 || p.nd > kMaxBand + 1 ||
      p.LS * p.U > kMaxLatticeThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * 2 * (size_t)p.LS * p.U;
  const void* fn = backward ? reinterpret_cast<const void*>(composed_backward_stats_kernel)
                            : reinterpret_cast<const void*>(composed_forward_kernel);
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.U - 1) / p.U;
  if (backward) {
    composed_backward_stats_kernel<<<blocks, p.LS * p.U, smem, static_cast<cudaStream_t>(stream)>>>(p);
  } else {
    composed_forward_kernel<<<blocks, p.LS * p.U, smem, static_cast<cudaStream_t>(stream)>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every launcher runs on `stream` and returns cudaGetLastError() (0 = ok).
// Host arrays (banks, mixes, strides, mom_pos, mom) hold n_streams entries;
// the pointers they hold and every other pointer are device pointers.

int srhmm_bank_emission(const void* ids, const void* const* banks, const int* mixes,
                        const int* strides, int n_streams, int NB, const void* feats, void* log_b,
                        int B, int T, int D, int LS, int full, int dmax, int device, void* stream) {
  BankParams p;
  int bad = fill_bank(p, ids, banks, mixes, strides, n_streams, NB, feats, B, T, D, LS);
  if (bad) return bad;
  void* fn = bank_kernel_for(0, dmax, full);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)p.rec_floats;
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  reinterpret_cast<EmitFn>(fn)<<<grid, kFrames, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(log_b));
  return (int)cudaGetLastError();
}

int srhmm_composed_forward(const void* log_b, const void* diag_col, const void* lengths, void* la,
                           int T, int LS, int B, int nd, int U, int device, void* stream) {
  LatticeParams p{};
  p.log_b = static_cast<const float*>(log_b);
  p.diag = static_cast<const float*>(diag_col);
  p.lengths = static_cast<const int*>(lengths);
  p.la_out = static_cast<float*>(la);
  p.T = T;
  p.LS = LS;
  p.B = B;
  p.nd = nd;
  p.U = U;
  return lattice_launch(false, p, device, stream);
}

int srhmm_composed_backward_stats(const void* log_b, const void* la, const void* diag_row,
                                  const void* lengths, const void* safe_z, const void* vmask,
                                  void* gamma, void* xi, void* den_trans, void* den_mix, int T,
                                  int LS, int B, int nd, int U, int device, void* stream) {
  LatticeParams p{};
  p.log_b = static_cast<const float*>(log_b);
  p.la = static_cast<const float*>(la);
  p.diag = static_cast<const float*>(diag_row);
  p.lengths = static_cast<const int*>(lengths);
  p.safe_z = static_cast<const float*>(safe_z);
  p.vmask = static_cast<const float*>(vmask);
  p.gamma = static_cast<float*>(gamma);
  p.xi = static_cast<float*>(xi);
  p.den_trans = static_cast<float*>(den_trans);
  p.den_mix = static_cast<float*>(den_mix);
  p.T = T;
  p.LS = LS;
  p.B = B;
  p.nd = nd;
  p.U = U;
  return lattice_launch(true, p, device, stream);
}

// Both passes of the moments: pass 1 writes mom_pos[p] (B * LS, M_p * Cm),
// pass 2 sums its rows into mom[p] (NB, M_p * Cm) over the stable order of
// the flattened ids (order (B * LS,), offsets (NB + 1,), int32).
int srhmm_bank_moments(const void* ids, const void* const* banks, const int* mixes,
                       const int* strides, int n_streams, int NB, const void* feats,
                       const void* gamma, long long g_st, long long g_sj, long long g_sb,
                       const void* lengths, void* const* mom_pos, const void* order,
                       const void* offsets, void* const* mom, int B, int T, int D, int LS, int full,
                       int dmax, int device, void* stream) {
  BankParams p;
  int bad = fill_bank(p, ids, banks, mixes, strides, n_streams, NB, feats, B, T, D, LS);
  if (bad) return bad;
  MomParams m{};
  m.gamma = static_cast<const float*>(gamma);
  m.g_st = g_st;
  m.g_sj = g_sj;
  m.g_sb = g_sb;
  m.lengths = static_cast<const int*>(lengths);
  const int Cm = full ? D + D * D + 1 : 2 * D + 1;
  int off = 0, max_mix = 1;
  for (int q = 0; q < n_streams; ++q) {
    m.mom_pos[q] = static_cast<float*>(mom_pos[q]);
    m.acc_offs[q] = off;
    off += mixes[q] * Cm;
    max_mix = mixes[q] > max_mix ? mixes[q] : max_mix;
  }
  m.acc_floats = off;
  m.max_mix = max_mix;
  m.xstride = D | 1;
  void* fn = bank_kernel_for(1, dmax, full);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * ((size_t)p.rec_floats + (size_t)max_mix * (kFrames + 1) +
                                       (size_t)kFrames * m.xstride + (size_t)m.acc_floats);
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  reinterpret_cast<MomFn>(fn)<<<dim3(LS, B), kFrames, smem, s>>>(p, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int q = 0; q < n_streams; ++q) {
    const int cols = mixes[q] * Cm;
    const dim3 grid(NB, (cols + kReduceThreads - 1) / kReduceThreads);
    segment_rows_kernel<<<grid, kReduceThreads, 0, s>>>(
        static_cast<const float*>(mom_pos[q]), static_cast<const int*>(order),
        static_cast<const int*>(offsets), static_cast<float*>(mom[q]), cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
