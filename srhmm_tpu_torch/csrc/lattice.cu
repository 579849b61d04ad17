// Dense log-domain lattice kernels for NVIDIA Hopper (sm_90a): forward
// (lattice or last row), backward (lattice) and Viterbi.
//
// Replace the TPU kernels of srhmm_tpu/ops/pallas/:
//   lattice_forward_kernel  <- lattice_pallas.py:102 forward_lattice_pallas,
//                              :302 forward_lattice_pallas_blocked (lattice
//                              mode, (T, S, B)), and forward_pallas.py:70
//                              log_forward_batch_pallas (last-row mode,
//                              (B, T, S), shared or per-row transitions)
//   lattice_backward_kernel <- lattice_pallas.py:134 backward_lattice_pallas,
//                              :253 backward_lattice_pallas_blocked
//   viterbi_kernel          <- forward_pallas.py:137 viterbi_batch_pallas
// The blocked TPU kernels compute the same functions as the unblocked ones:
// k_block was the TPU's time tiling.  The plain PyTorch twins
// (ops/kernels/lattice.py, ops/kernels/forward.py *_plain) compute the same
// functions.
//
// The functions, per utterance b with lengths[b] = len, log b and the log
// transitions clamped at NEG_INF = -1e30 on load:
// forward: alpha[0] = log_b[0] + (0 in state 0, NEG_INF elsewhere) (frame 0
//   always initializes the carry, unclamped); for t >= 1 while t < len:
//   alpha[t, j] = max(m + log sum_i exp(alpha[t-1, i] + lt[i, j] - m)
//   + log_b[t, j], NEG_INF), m = max(max_i (alpha[t-1, i] + lt[i, j]),
//   NEG_INF); rows t >= len repeat the last valid row.
// backward: beta[T-1] = (0 in state S-1, NEG_INF elsewhere); for t < T-1:
//   while t + 1 < len, beta[t, i] = max(m + log sum_j exp(lt[i, j] +
//   log_b[t+1, j] + beta[t+1, j] - m), NEG_INF), else the init row.
// viterbi: the forward recursion with max for the logsumexp, the source
//   chosen by a strict > from source 0 (ties to the lowest source, as
//   lax.argmax); backpointer rows 0 and t >= len are the identity.
//
// Layouts.  log b (and the lattice output, the backpointers) are read with
// element strides (st, ss, sb) for (t, s, b): (T, S, B) lattices and the
// (B, T, S) inputs of log_forward_batch / viterbi_batch are both read in
// place, with no transpose.  Transitions are one (S, S) matrix or one per
// utterance, (B, S, S).
//
// Design.  One thread per (state, utterance), U utterances a block (S * U
// threads), the whole time loop inside the kernel: each frame a thread
// computes its own state's new value from the S values of the previous
// frame, which the block exchanges through a double-buffered shared-memory
// row (one __syncthreads per frame).  The transitions (the block's U
// matrices when per row) are staged in shared memory.  Threads are laid out
// state-major (thread j * U + u) where b is the unit-stride axis, and
// utterance-major (thread u * S + j) where s is, so that a warp's reads of a
// frame's log b are contiguous in both layouts.
//
// What bounds it on the H100.  Each lattice function moves 2 T S B floats
// (65.5 MB at the em_diag shape B=2048, T=500, S=8: ~0.02 ms of HBM time)
// and does ~6 S^2 operations per (frame, utterance): bytes bound it on
// paper.  In practice the serial chain of T frames per thread sets the
// time: B * S threads (16 k at em_diag: 128 blocks of 128 threads, one
// block, four warps, per SM) each walk T frames of 2 S shared-memory reads,
// S exps and a barrier.  Later work: more utterances per SM (several
// blocks an SM at small S), the carries of a warp's utterances in
// registers with shuffles instead of a barrier.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxStates = 64;
constexpr int kMaxLatticeThreads = 1024;

enum Kind { kForward = 0, kBackward = 1, kViterbi = 2 };

struct Args {
  const float* log_b;      // element (t, s, b) at t * st + s * ss + b * sb
  long long st, ss, sb;
  const float* lt;         // (S, S), or (B, S, S) when per_row
  int per_row;
  const int* lengths;      // (B,)
  float* out;              // lattice (same strides as log_b) or last row / scores (B, S)
  int last_only;           // forward: write only the final carry, (B, S)
  int* bptr;               // viterbi: backpointers, same strides as log_b
  int T, S, B, U;
  int state_minor;         // thread u * S + j (else j * U + u)
};

// This thread's (state j, utterance slot u), and the shared-memory row
// index of state i of slot u: base + i * step.
struct Slot {
  int j, u, base, step;
};

__device__ __forceinline__ Slot thread_slot(const Args& p) {
  Slot s;
  if (p.state_minor) {
    s.u = threadIdx.x / p.S;
    s.j = threadIdx.x - s.u * p.S;
    s.base = s.u * p.S;
    s.step = 1;
  } else {
    s.j = threadIdx.x / p.U;
    s.u = threadIdx.x - s.j * p.U;
    s.base = s.u;
    s.step = p.U;
  }
  return s;
}

// Stage the transitions clamped at NEG_INF: one (S, S) matrix, or the
// block's U per-utterance matrices (zero-padded past B with NEG_INF).
__device__ __forceinline__ void stage_trans(const Args& p, float* lt_sh) {
  const int SS = p.S * p.S;
  if (!p.per_row) {
    for (int i = threadIdx.x; i < SS; i += blockDim.x) lt_sh[i] = fmaxf(p.lt[i], kNegInf);
    return;
  }
  const int b0 = blockIdx.x * p.U;
  for (int i = threadIdx.x; i < p.U * SS; i += blockDim.x) {
    const int b = b0 + i / SS;
    lt_sh[i] = b < p.B ? fmaxf(p.lt[(size_t)b0 * SS + i], kNegInf) : kNegInf;
  }
}

__global__ void __launch_bounds__(kMaxLatticeThreads) lattice_forward_kernel(const Args p) {
  extern __shared__ float sh[];
  const int S = p.S, nt = S * p.U;
  float* row = sh;            // 2 * nt: the carries of frames t-1 and t
  float* lt_sh = sh + 2 * nt;
  stage_trans(p, lt_sh);
  const Slot q = thread_slot(p);
  const int j = q.j;
  const int b = blockIdx.x * p.U + q.u;
  const bool live = b < p.B;
  const int len = live ? p.lengths[b] : 0;
  const float* lt = lt_sh + (p.per_row ? q.u * S * S : 0);
  const size_t o = live ? (size_t)b * p.sb + (size_t)j * p.ss : 0;
  float carry = kNegInf;
  __syncthreads();
  for (int t = 0; t < p.T; ++t) {
    const size_t ot = o + (size_t)t * p.st;
    const float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;
    if (t == 0) {
      carry = (j == 0 ? 0.f : kNegInf) + lb;
    } else if (t < len) {
      const float* prev = row + ((t + 1) & 1) * nt + q.base;
      float m = kNegInf;
      for (int i = 0; i < S; ++i) m = fmaxf(m, prev[i * q.step] + lt[i * S + j]);
      float e = 0.f;
      for (int i = 0; i < S; ++i) e += expf(prev[i * q.step] + lt[i * S + j] - m);
      carry = fmaxf(m + logf(e) + lb, kNegInf);
    }
    row[(t & 1) * nt + threadIdx.x] = carry;
    if (live && !p.last_only) p.out[ot] = carry;
    __syncthreads();
  }
  if (live && p.last_only) p.out[(size_t)b * S + j] = carry;
}

__global__ void __launch_bounds__(kMaxLatticeThreads) lattice_backward_kernel(const Args p) {
  extern __shared__ float sh[];
  const int S = p.S, nt = S * p.U;
  float* row = sh;            // 2 * nt: log_b[t+1] + beta[t+1], double-buffered
  float* lt_sh = sh + 2 * nt;
  stage_trans(p, lt_sh);
  const Slot q = thread_slot(p);
  const int i = q.j;          // this thread's source state
  const int b = blockIdx.x * p.U + q.u;
  const bool live = b < p.B;
  const int len = live ? p.lengths[b] : 0;
  const float* lt = lt_sh + (p.per_row ? q.u * S * S : 0) + i * S;
  const size_t o = live ? (size_t)b * p.sb + (size_t)i * p.ss : 0;
  const float beta_init = (i == S - 1) ? 0.f : kNegInf;
  float beta = beta_init;
  if (live) p.out[o + (size_t)(p.T - 1) * p.st] = beta;
  __syncthreads();
  for (int t = p.T - 2; t >= 0; --t) {
    const float lbn = live ? fmaxf(p.log_b[o + (size_t)(t + 1) * p.st], kNegInf) : kNegInf;
    float* inner = row + (t & 1) * nt;
    inner[threadIdx.x] = lbn + beta;
    __syncthreads();
    if (t + 1 < len) {
      const float* in = inner + q.base;
      float m = kNegInf;
      for (int k = 0; k < S; ++k) m = fmaxf(m, lt[k] + in[k * q.step]);
      float e = 0.f;
      for (int k = 0; k < S; ++k) e += expf(lt[k] + in[k * q.step] - m);
      beta = fmaxf(m + logf(e), kNegInf);
    } else {
      beta = beta_init;
    }
    if (live) p.out[o + (size_t)t * p.st] = beta;
  }
}

__global__ void __launch_bounds__(kMaxLatticeThreads) viterbi_kernel(const Args p) {
  extern __shared__ float sh[];
  const int S = p.S, nt = S * p.U;
  float* row = sh;
  float* lt_sh = sh + 2 * nt;
  stage_trans(p, lt_sh);
  const Slot q = thread_slot(p);
  const int j = q.j;
  const int b = blockIdx.x * p.U + q.u;
  const bool live = b < p.B;
  const int len = live ? p.lengths[b] : 0;
  const float* lt = lt_sh + (p.per_row ? q.u * S * S : 0);
  const size_t o = live ? (size_t)b * p.sb + (size_t)j * p.ss : 0;
  float carry = kNegInf;
  __syncthreads();
  for (int t = 0; t < p.T; ++t) {
    const size_t ot = o + (size_t)t * p.st;
    const float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;
    int arg = j;  // the identity on row 0 and past the length
    if (t == 0) {
      carry = (j == 0 ? 0.f : kNegInf) + lb;
    } else if (t < len) {
      const float* prev = row + ((t + 1) & 1) * nt + q.base;
      float best = prev[0] + lt[j];
      arg = 0;
      for (int i = 1; i < S; ++i) {
        const float c = prev[i * q.step] + lt[i * S + j];
        if (c > best) {
          best = c;
          arg = i;
        }
      }
      carry = fmaxf(best + lb, kNegInf);
    }
    row[(t & 1) * nt + threadIdx.x] = carry;
    if (live) p.bptr[ot] = arg;
    __syncthreads();
  }
  if (live) p.out[(size_t)b * S + j] = carry;
}

int launch(Kind kind, const Args& p, int device, void* stream) {
  if (p.T < 1 || p.S < 1 || p.S > kMaxStates || p.B < 1 || p.U < 1 ||
      p.S * p.U > kMaxLatticeThreads || (kind == kBackward && p.last_only)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (2 * (size_t)p.S * p.U + (size_t)(p.per_row ? p.U : 1) * p.S * p.S);
  const void* fn = kind == kForward    ? reinterpret_cast<const void*>(lattice_forward_kernel)
                   : kind == kBackward ? reinterpret_cast<const void*>(lattice_backward_kernel)
                                       : reinterpret_cast<const void*>(viterbi_kernel);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (p.B + p.U - 1) / p.U;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kForward: lattice_forward_kernel<<<blocks, p.S * p.U, smem, s>>>(p); break;
    case kBackward: lattice_backward_kernel<<<blocks, p.S * p.U, smem, s>>>(p); break;
    case kViterbi: viterbi_kernel<<<blocks, p.S * p.U, smem, s>>>(p); break;
  }
  return (int)cudaGetLastError();
}

Args make_args(const void* log_b, long long st, long long ss, long long sb, const void* lt,
               int per_row, const void* lengths, int T, int S, int B, int U, int state_minor) {
  Args p{};
  p.log_b = static_cast<const float*>(log_b);
  p.st = st;
  p.ss = ss;
  p.sb = sb;
  p.lt = static_cast<const float*>(lt);
  p.per_row = per_row;
  p.lengths = static_cast<const int*>(lengths);
  p.T = T;
  p.S = S;
  p.B = B;
  p.U = U;
  p.state_minor = state_minor;
  return p;
}

}  // namespace

extern "C" {

// Every launcher runs on `stream` and returns cudaGetLastError() (0 = ok).
// Pointers are device pointers; log b is float32 with element strides
// (st, ss, sb) for (t, s, b), lengths int32 (B,), lt float32 (S, S) or,
// with per_row, (B, S, S).

// out: the (T, S, B)-strided lattice (same strides as log b), or with
// last_only the final carries (B, S).
int srhmm_lattice_forward(const void* log_b, long long st, long long ss, long long sb,
                          const void* lt, int per_row, const void* lengths, void* out,
                          int last_only, int T, int S, int B, int U, int state_minor, int device,
                          void* stream) {
  Args p = make_args(log_b, st, ss, sb, lt, per_row, lengths, T, S, B, U, state_minor);
  p.out = static_cast<float*>(out);
  p.last_only = last_only;
  return launch(kForward, p, device, stream);
}

int srhmm_lattice_backward(const void* log_b, long long st, long long ss, long long sb,
                           const void* lt, int per_row, const void* lengths, void* out, int T,
                           int S, int B, int U, int state_minor, int device, void* stream) {
  Args p = make_args(log_b, st, ss, sb, lt, per_row, lengths, T, S, B, U, state_minor);
  p.out = static_cast<float*>(out);
  return launch(kBackward, p, device, stream);
}

// scores (B, S); bptr int32 with the strides of log b.
int srhmm_viterbi(const void* log_b, long long st, long long ss, long long sb, const void* lt,
                  int per_row, const void* lengths, void* scores, void* bptr, int T, int S, int B,
                  int U, int state_minor, int device, void* stream) {
  Args p = make_args(log_b, st, ss, sb, lt, per_row, lengths, T, S, B, U, state_minor);
  p.out = static_cast<float*>(scores);
  p.bptr = static_cast<int*>(bptr);
  return launch(kViterbi, p, device, stream);
}

}  // extern "C"
