// Baum-Welch E-step kernels for NVIDIA Hopper (sm_90a): emit-forward (K1)
// and backward-stats (K2), for P in [1, 6] parameter streams.
//
// Replace the TPU kernels of srhmm_tpu/ops/pallas/fused_em_pallas.py:
//   emit_forward_kernel   <- :350 emit_forward_pallas, :946 emit_forward_pallas_multi
//   backward_stats_kernel <- :612 backward_stats_pallas, :1034 backward_stats_pallas_multi
// The plain PyTorch twins (ops/kernels/fused_em.py emit_forward_plain,
// backward_stats_plain) compute the same function.
//
// K1, per frame: each stream's weighted mixture log-likelihoods at the
// shifted origin x = feats - origin (csrc/emission.cuh: diagonal lift dot
// product, or the full-covariance Cholesky z with the 1e20 clamp before the
// weight), the per-state mixture logsumexp (max seeded at NEG_INF, 1e-38
// guard), the sum over streams clamped at NEG_INF = log b; then the
// log-domain forward step over the band+1 diagonals of a left-right model
// (or all S sources when dense).  Frame 0 starts in state 0 and always
// initializes the carry, even for zero-length rows; frames t >= length
// repeat the last valid row; every value is clamped at -1e30.
// Writes log_b and log_alpha, (T, S, B).
//
// K2, per frame in descending time: the log-domain backward step with
// final-state init (rows t >= length-1 take the init row); exact xi for
// every allowed (source, destination) pair,
//   xi[i -> j] += exp(min(alpha[t,i] + lt[i,j] + log_b[t+1,j] + beta[t+1,j] - z, 0))
// for t < length-1; gamma = exp(min(alpha + beta - z, 0)) masked by
// t < length and vmask; den_trans (t < length-1) and den_mix; and the GMM
// moments mom += gamma * post_m * [lift; 1] with lift [y; y^2] (diagonal)
// or [y; vec(y y^T)] (full), post_m = exp(min(q_m - log b_p, 0)) from the
// stream's OWN mixture logsumexp (0 where log b_p <= NEG_INF/2).
// Writes per-utterance xi (nslots, S, B), den_trans / den_mix (S, B), and
// per-block moment partials (blocks, sum_p M_p S (L_p + 1)).
//
// Design.  The TPU grid walked time blocks in order and carried the
// recursion in VMEM scratch; here the whole time loop runs inside the
// kernel, one launch per pass, and K2 reads log_b[t+1] straight from device
// memory.  A block holds U utterances x S states, one thread per (state,
// utterance) (thread s * U + u): each thread computes its own state's
// emission, so emission work is spread over S times more threads than one
// thread per utterance would give, and the band recursion exchanges one
// value per thread through a double-buffered shared-memory row (one
// __syncthreads per frame).  Per-thread accumulators (xi slots, moments)
// live in shared-memory columns (index k * blockDim + tid: conflict-free,
// no thread writes another's column).  The cross-utterance moment
// reduction has no atomics: each block sums its U columns in a fixed order
// into its own partial, and the caller sums the partials over blocks, so
// two runs of an E-step are bitwise equal.  Every product is an fp32 fmaf.
//
// What bounds it on the H100.  Parallelism: B * S threads (16 k at the
// B=2048, S=8 EM headline), i.e. ~4 warps per SM, so each thread's serial
// chain over T frames (per frame: M * 2D FMAs or M * D^2 for the emission,
// band+1 exps, in K2 also M * (L+1) shared-memory moment updates) sets the
// time, not the FMA rate or the bandwidth.  K1 writes 2 T S B floats
// (65 MB at the headline) and K2 reads them back once, well under a
// millisecond of HBM time.  Later work: spread the mixtures over more
// threads, tensor-core emission at fp32 precision, CUDA-graph capture of
// whole EM iterations.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxThreads = 256;  // S * U threads per block

struct EmParams {
  const float* feats[kMaxStreams];  // per stream: (T, D_p, B)
  int dims[kMaxStreams];            // D_p
  int mixes[kMaxStreams];           // M_p
  int offs[kMaxStreams];            // float offset of stream p's records in consts
  int origin_offs[kMaxStreams];     // float offset of stream p's (D_p,) origin in consts
  int mom_offs[kMaxStreams];        // per-thread moment offset: sum_{r<p} M_r (L_r + 1)
  int n_streams;
  const float* consts;  // (C,) records, origins, then the (S, S) log transitions
  int C;                // floats, a multiple of 4
  int lt_off;           // offset of the log transitions, row-major (from, to)
  const int* lengths;   // (B,)
  const float* safe_z;  // (B,) final-state log-prob, 0 where invalid (K2)
  const float* vmask;   // (B,) 1 for valid utterances (K2)
  float* log_b;         // (T, S, B): K1 writes, K2 reads
  float* la;            // (T, S, B): K1 writes, K2 reads
  float* xi;            // (nslots, S, B) (K2)
  float* den_trans;     // (S, B) (K2)
  float* den_mix;       // (S, B) (K2)
  float* mom;           // (gridDim.x, S * mom_thread) per-block moment partials (K2)
  int mom_thread;       // moment floats per thread: sum_p M_p (L_p + 1)
  int max_mix;          // max_p M_p
  int T, B, S, band;    // band < 0: dense transitions
  int U;                // utterances per block
};

// Transition slots: a banded model has band+1 (slot k = diagonal k), a
// dense one S (slot k = state k).  Source of destination j at slot k, and
// destination of source i at slot k; -1 / >= S when outside the model.
__device__ __forceinline__ int slot_src(bool banded, int j, int k) { return banded ? j - k : k; }
__device__ __forceinline__ int slot_dst(bool banded, int i, int k) { return banded ? i + k : k; }

template <int DMAX>
__device__ __forceinline__ void load_frame(const float* f, const float* o, int D, int B,
                                           float (&x)[DMAX]) {
#pragma unroll
  for (int e = 0; e < DMAX; ++e) x[e] = (e < D) ? __ldg(f + (size_t)e * B) - o[e] : 0.f;
}

__device__ __forceinline__ void stage_constants(const EmParams& p, float4* smem4, int tid, int nt) {
  const float4* src = reinterpret_cast<const float4*>(p.consts);
  for (int i = tid; i < p.C / 4; i += nt) smem4[i] = src[i];
}

template <int DMAX, bool FULL>
__global__ void __launch_bounds__(kMaxThreads) emit_forward_kernel(const EmParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, nt = S * U, tid = threadIdx.x;
  const int s = tid / U, u = tid - s * U;
  const int b = blockIdx.x * U + u;
  const bool live = b < p.B;
  stage_constants(p, smem4, tid, nt);
  float* alpha = smem + p.C;  // two (S, U) rows: frame t writes row t & 1
  __syncthreads();
  const float* lt = smem + p.lt_off;
  const bool banded = p.band >= 0;
  const int nslots = banded ? p.band + 1 : S;
  const int len = live ? p.lengths[b] : 0;

  float carry = kNegInf;
  for (int t = 0; t < p.T; ++t) {
    float lb = 0.f;
    if (live) {
      for (int q = 0; q < p.n_streams; ++q) {
        const int D = p.dims[q], M = p.mixes[q];
        float x[DMAX];
        load_frame<DMAX>(p.feats[q] + (size_t)t * D * p.B + b, smem + p.origin_offs[q], D, p.B, x);
        const float* rec = smem + p.offs[q] + s * M * record_stride<DMAX, FULL>(D);
        float v;
        if constexpr (FULL) {
          v = full_state_log_b<DMAX>(rec, M, D, x);
        } else {
          float x2[DMAX];
#pragma unroll
          for (int e = 0; e < DMAX; ++e) x2[e] = x[e] * x[e];
          v = diag_state_log_b<DMAX>(rec, M, x, x2);
        }
        lb = (q == 0) ? v : lb + v;
      }
      lb = fmaxf(lb, kNegInf);
    }
    const float* prev = alpha + ((t + 1) & 1) * nt;
    if (t == 0) {
      carry = fmaxf((s == 0 ? 0.f : kNegInf) + lb, kNegInf);
    } else if (t < len) {
      float m = kNegInf;
      for (int k = 0; k < nslots; ++k) {
        const int i = slot_src(banded, s, k);
        if (i >= 0) m = fmaxf(m, prev[i * U + u] + lt[i * S + s]);
      }
      float e = 0.f;
      for (int k = 0; k < nslots; ++k) {
        const int i = slot_src(banded, s, k);
        if (i >= 0) e += expf(prev[i * U + u] + lt[i * S + s] - m);
      }
      const float upd = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
      carry = fmaxf(upd + lb, kNegInf);
    }
    alpha[(t & 1) * nt + tid] = carry;
    if (live) {
      const size_t o = ((size_t)t * S + s) * p.B + b;
      p.log_b[o] = lb;
      p.la[o] = carry;
    }
    __syncthreads();
  }
}

template <int DMAX, bool FULL>
__global__ void __launch_bounds__(kMaxThreads) backward_stats_kernel(const EmParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, nt = S * U, tid = threadIdx.x;
  const int s = tid / U, u = tid - s * U;
  const int b = blockIdx.x * U + u;
  const bool live = b < p.B;
  const bool banded = p.band >= 0;
  const int nslots = banded ? p.band + 1 : S;
  stage_constants(p, smem4, tid, nt);
  float* inner_sh = smem + p.C;            // two (S, U) rows: frame t writes row t & 1
  float* q_sh = inner_sh + 2 * nt;         // (max_mix, S*U) per-mixture q of this frame
  float* xi_sh = q_sh + p.max_mix * nt;    // (nslots, S*U) xi accumulators
  float* mom_sh = xi_sh + nslots * nt;     // (mom_thread, S*U) moment accumulators
  for (int k = 0; k < nslots; ++k) xi_sh[k * nt + tid] = 0.f;
  for (int k = 0; k < p.mom_thread; ++k) mom_sh[k * nt + tid] = 0.f;
  __syncthreads();
  const float* lt = smem + p.lt_off;
  const int len = live ? p.lengths[b] : 0;
  const float z = live ? p.safe_z[b] : 0.f;
  const bool valid = live && p.vmask[b] > 0.f;
  const float beta_init = (s == S - 1) ? 0.f : kNegInf;

  float beta = beta_init;  // log-beta at t+1 until this frame's update
  float dt = 0.f, dm = 0.f;
  for (int t = p.T - 1; t >= 0; --t) {
    const float* la_row = p.la + (size_t)t * S * p.B + b;  // la[t, i, b] = la_row[i * B]
    const float la_t = live ? la_row[(size_t)s * p.B] : kNegInf;
    // log_b[t+1]: masked everywhere at t = T-1 (t < length-1 is impossible)
    const float lbn =
        (live && t + 1 < p.T) ? p.log_b[((size_t)(t + 1) * S + s) * p.B + b] : kNegInf;
    const float inner = fmaxf(lbn + beta, kNegInf);
    float* ib = inner_sh + (t & 1) * nt;
    ib[tid] = inner;
    __syncthreads();

    const bool stepping = len - 1 > t;  // t < length-1; else the init row
    if (stepping && valid) {            // exact xi, destination j = s
      const float lnz = inner - z;
      for (int k = 0; k < nslots; ++k) {
        const int i = slot_src(banded, s, k);
        if (i >= 0) {
          const float term = la_row[(size_t)i * p.B] + lt[i * S + s] + lnz;
          xi_sh[k * nt + tid] += expf(fminf(term, 0.f));
        }
      }
    }
    if (stepping) {  // backward step, source i = s
      float m = kNegInf;
      for (int k = 0; k < nslots; ++k) {
        const int j = slot_dst(banded, s, k);
        if (j < S) m = fmaxf(m, lt[s * S + j] + ib[j * U + u]);
      }
      float e = 0.f;
      for (int k = 0; k < nslots; ++k) {
        const int j = slot_dst(banded, s, k);
        if (j < S) e += expf(lt[s * S + j] + ib[j * U + u] - m);
      }
      beta = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
    } else {
      beta = beta_init;
    }

    if (valid && t < len) {
      const float gamma = expf(fminf(la_t + beta - z, 0.f));
      dm += gamma;
      if (stepping) dt += gamma;
      for (int q = 0; q < p.n_streams; ++q) {
        const int D = p.dims[q], M = p.mixes[q];
        const int L1 = FULL ? D + D * D + 1 : 2 * D + 1;
        float x[DMAX], x2[DMAX];
        load_frame<DMAX>(p.feats[q] + (size_t)t * D * p.B + b, smem + p.origin_offs[q], D, p.B, x);
#pragma unroll
        for (int e = 0; e < DMAX; ++e) x2[e] = x[e] * x[e];
        const int stride = record_stride<DMAX, FULL>(D);
        const float* rec = smem + p.offs[q] + s * M * stride;
        float mx = kNegInf, ex = 0.f;
        for (int mix = 0; mix < M; ++mix) {
          float qv;
          if constexpr (FULL) {
            qv = full_mix_q<DMAX>(rec + mix * stride, D, x);
          } else {
            qv = diag_mix_q<DMAX>(rec + mix * stride, x, x2);
          }
          q_sh[mix * nt + tid] = qv;
          lse_push(qv, mx, ex);
        }
        const float lbp = lse_value(mx, ex);  // this stream's own log b
        float* acc = mom_sh + (size_t)p.mom_offs[q] * nt + tid;
        for (int mix = 0; mix < M; ++mix, acc += (size_t)L1 * nt) {
          const float post =
              (lbp > 0.5f * kNegInf) ? expf(fminf(q_sh[mix * nt + tid] - lbp, 0.f)) : 0.f;
          const float gm = gamma * post;
#pragma unroll
          for (int e = 0; e < DMAX; ++e) {
            if (e < D) acc[e * nt] = fmaf(gm, x[e], acc[e * nt]);
          }
          if constexpr (FULL) {
#pragma unroll
            for (int d = 0; d < DMAX; ++d) {
#pragma unroll
              for (int e = 0; e < DMAX; ++e) {
                if (d < D && e < D) {
                  float* a = acc + (size_t)(D + d * D + e) * nt;
                  *a = fmaf(gm, x[e] * x[d], *a);
                }
              }
            }
          } else {
#pragma unroll
            for (int e = 0; e < DMAX; ++e) {
              if (e < D) acc[(D + e) * nt] = fmaf(gm, x2[e], acc[(D + e) * nt]);
            }
          }
          acc[(L1 - 1) * nt] += gm;
        }
      }
    }
  }

  if (live) {
    for (int k = 0; k < nslots; ++k) p.xi[((size_t)k * S + s) * p.B + b] = xi_sh[k * nt + tid];
    p.den_trans[(size_t)s * p.B + b] = dt;
    p.den_mix[(size_t)s * p.B + b] = dm;
  }
  __syncthreads();
  // this block's moment partial: per stream an (M*S, L+1) block with row
  // m*S + s, each entry the sum over the block's U utterances in order
  float* out = p.mom + (size_t)blockIdx.x * S * p.mom_thread;
  for (int q = 0; q < p.n_streams; ++q) {
    const int D = p.dims[q], M = p.mixes[q];
    const int L1 = FULL ? D + D * D + 1 : 2 * D + 1;
    for (int r = tid; r < M * S * L1; r += nt) {
      const int row = r / L1, l = r - row * L1;
      const int mix = row / S, s2 = row - mix * S;
      const float* col = mom_sh + (size_t)(p.mom_offs[q] + mix * L1 + l) * nt + s2 * U;
      float acc = 0.f;
      for (int k = 0; k < U; ++k) acc += col[k];
      out[(size_t)S * p.mom_offs[q] + r] = acc;
    }
  }
}

using KernelFn = void (*)(EmParams);

// which: 0 = emit-forward, 1 = backward-stats
template <int DMAX, bool FULL>
KernelFn pick(int which) {
  return which == 0 ? emit_forward_kernel<DMAX, FULL> : backward_stats_kernel<DMAX, FULL>;
}

// nullptr for a bound that is not compiled: full covariance carries D^2
// moments per mixture, and bounds above 16 would not fit a block's shared
// memory
KernelFn kernel_for(int which, int dmax, int full) {
  if (full) {
    switch (dmax) {
      case 4: return pick<4, true>(which);
      case 8: return pick<8, true>(which);
      case 12: return pick<12, true>(which);
      case 16: return pick<16, true>(which);
      default: return nullptr;
    }
  }
  switch (dmax) {
    case 4: return pick<4, false>(which);
    case 8: return pick<8, false>(which);
    case 12: return pick<12, false>(which);
    case 16: return pick<16, false>(which);
    case 32: return pick<32, false>(which);
    case 64: return pick<64, false>(which);
    default: return nullptr;
  }
}

size_t smem_bytes(int which, const EmParams& p) {
  const size_t nt = (size_t)p.S * p.U;
  const size_t nslots = p.band >= 0 ? (size_t)p.band + 1 : (size_t)p.S;
  if (which == 0) return sizeof(float) * ((size_t)p.C + 2 * nt);
  return sizeof(float) * ((size_t)p.C + (2 + p.max_mix + nslots + p.mom_thread) * nt);
}

int fill_params(EmParams& p, const void* const* feats, const int* dims, const int* mixes,
                const int* offs, const int* origin_offs, int n_streams, const void* consts, int C,
                int lt_off, const void* lengths, int T, int B, int S, int band, int full, int U) {
  if (n_streams < 1 || n_streams > kMaxStreams || C % 4 != 0 || T < 1 || B < 1 || S < 1 ||
      U < 1 || S * U > kMaxThreads || band >= S) {
    return (int)cudaErrorInvalidValue;
  }
  p = EmParams{};
  int mom = 0, max_mix = 1;
  for (int i = 0; i < n_streams; ++i) {
    const int D = dims[i], M = mixes[i];
    if (D < 1 || M < 1) return (int)cudaErrorInvalidValue;
    p.feats[i] = static_cast<const float*>(feats[i]);
    p.dims[i] = D;
    p.mixes[i] = M;
    p.offs[i] = offs[i];
    p.origin_offs[i] = origin_offs[i];
    p.mom_offs[i] = mom;
    mom += M * ((full ? D + D * D : 2 * D) + 1);
    max_mix = M > max_mix ? M : max_mix;
  }
  p.n_streams = n_streams;
  p.consts = static_cast<const float*>(consts);
  p.C = C;
  p.lt_off = lt_off;
  p.lengths = static_cast<const int*>(lengths);
  p.mom_thread = mom;
  p.max_mix = max_mix;
  p.T = T;
  p.B = B;
  p.S = S;
  p.band = band;
  p.U = U;
  return 0;
}

int run(int which, const EmParams& p, int dmax, int full, int device, void* stream) {
  const KernelFn kernel = kernel_for(which, dmax, full);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(which, p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (p.B + p.U - 1) / p.U;
  kernel<<<blocks, p.S * p.U, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 = ok).
// feats/dims/mixes/offs/origin_offs are host arrays of n_streams entries;
// the pointers they hold and every other pointer are device pointers.
// band < 0 selects dense transitions.  U = utterances per block (S*U threads).
int srhmm_emit_forward(const void* const* feats, const int* dims, const int* mixes,
                       const int* offs, const int* origin_offs, int n_streams, const void* consts,
                       int C, int lt_off, const void* lengths, void* log_b, void* la, int T, int B,
                       int S, int band, int full, int dmax, int U, int device, void* stream) {
  EmParams p;
  const int bad = fill_params(p, feats, dims, mixes, offs, origin_offs, n_streams, consts, C,
                              lt_off, lengths, T, B, S, band, full, U);
  if (bad) return bad;
  p.log_b = static_cast<float*>(log_b);
  p.la = static_cast<float*>(la);
  return run(0, p, dmax, full, device, stream);
}

int srhmm_backward_stats(const void* const* feats, const int* dims, const int* mixes,
                         const int* offs, const int* origin_offs, int n_streams,
                         const void* consts, int C, int lt_off, const void* lengths,
                         const void* safe_z, const void* vmask, const void* log_b, const void* la,
                         void* xi, void* den_trans, void* den_mix, void* mom, int T, int B, int S,
                         int band, int full, int dmax, int U, int device, void* stream) {
  EmParams p;
  const int bad = fill_params(p, feats, dims, mixes, offs, origin_offs, n_streams, consts, C,
                              lt_off, lengths, T, B, S, band, full, U);
  if (bad) return bad;
  p.safe_z = static_cast<const float*>(safe_z);
  p.vmask = static_cast<const float*>(vmask);
  p.log_b = const_cast<float*>(static_cast<const float*>(log_b));
  p.la = const_cast<float*>(static_cast<const float*>(la));
  p.xi = static_cast<float*>(xi);
  p.den_trans = static_cast<float*>(den_trans);
  p.den_mix = static_cast<float*>(den_mix);
  p.mom = static_cast<float*>(mom);
  return run(1, p, dmax, full, device, stream);
}

// Resident blocks per SM for a launch of `threads` threads and `smem`
// bytes of dynamic shared memory (which: 0 = emit-forward, 1 = backward-
// stats); written to *blocks.  Returns a CUDA error code (0 = ok).
int srhmm_em_occupancy(int which, int dmax, int full, int threads, int smem, int* blocks) {
  const KernelFn kernel = kernel_for(which, dmax, full);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, (size_t)smem);
}

}  // extern "C"
