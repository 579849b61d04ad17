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
// Forward design (lattice_forward_kernel).  The S states of an utterance
// sit on adjacent lanes of a warp, G = 32 / S utterances a warp (S <= 32;
// for 32 < S <= 64 one utterance a warp, lane l holding states l and l +
// 32), U = 4 G utterances a block of four recursion warps and one memory
// warp.  Per frame a lane takes the S sources of its state from the lanes
// of its utterance by __shfl_sync (forward_sources), its column of the
// transitions kept in registers (in shared memory at 32 < S), and runs
// the log-sum-exp unrolled to NS = 4, 8, 16, 32 or 64 compiled slots, a
// slot past S entering the max as -inf and the sum as expf(-inf) = 0.0f,
// which change no bit (forward_update): nothing but shuffles and math is
// on the serial chain, no barrier and no load.  The block walks tiles of TT
// frames: while the recursion warps run tile k out of shared memory (log b
// read a frame ahead), the memory warp copies tile k+1's log b in by
// 16-byte cp.async (stage_forward_tile: rows of U utterances along B of a
// (T, S, B) tensor, or one run of TT S floats an utterance of a (B, T, S)
// tensor) and writes the (T, S, B) lattice of tile k-1 out in rows of U
// consecutive floats (store_forward_tile); one barrier closes a tile.  In
// last-row mode a block stops at its longest utterance and writes only the
// final carries.  The terms keep the single-thread kernel's order (max over
// the sources, the sum of expf ascending, m + logf(e) + lb), so the lattice
// and the last row are bitwise those of one thread a (state, utterance)
// summing over the sources in a loop.
//
// Backward and Viterbi design.  One thread per (state, utterance), U
// utterances a block (S * U threads), the whole time loop inside the
// kernel: each frame a thread computes its own state's new value from the
// S values of the next (backward) or previous (Viterbi) frame, which the
// block exchanges through a double-buffered shared-memory row (one
// __syncthreads per frame).  The transitions (the block's U matrices when
// per row) are staged in shared memory.  Threads are laid out state-major
// (thread j * U + u) where b is the unit-stride axis, and utterance-major
// (thread u * S + j) where s is, so that a warp's reads of a frame's log b
// are contiguous in both layouts.
//
// What bounds it on the H100.  Each lattice function moves 2 T S B floats
// (65.5 MB at the em_diag shape B=2048, T=500, S=8: ~0.02 ms of HBM time)
// and does ~6 S^2 operations per (frame, utterance): bytes bound it on
// paper.  In practice the serial chain of T frames per utterance sets the
// time: the forward kernel's chain is the shuffles, the S-term
// log-sum-exp and one logf a frame, with 4 warps an SM at em_diag (512
// warps); the backward and Viterbi kernels' chain is a shared-memory
// exchange and a barrier a frame (later work: the forward's lanes and
// staging, forward_sources / stage_forward_tile).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxStates = 64;
constexpr int kMaxLatticeThreads = 1024;
constexpr size_t kSmemLimit = 232448;  // bytes a block may use (ops/kernels/common.py SMEM_LIMIT)

enum Kind { kBackward = 1, kViterbi = 2 };

struct Args {
  const float* log_b;      // element (t, s, b) at t * st + s * ss + b * sb
  long long st, ss, sb;
  const float* lt;         // (S, S), or (B, S, S) when per_row
  int per_row;
  const int* lengths;      // (B,)
  float* out;              // lattice (same strides as log_b) or scores (B, S)
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

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdRecWarps = 4;                       // recursion warps a block
constexpr int kFwdThreads = 32 * (kFwdRecWarps + 1);  // and one memory warp

struct FwdParams {
  const float* log_b;  // (T, S, B) (layout 0) or (B, T, S) (layout 1), contiguous
  const float* lt;     // (S, S), or (B, S, S) when per_row
  const int* lengths;  // (B,)
  float* out;          // layout 0: the (T, S, B) lattice; layout 1: the final carries (B, S)
  int per_row, layout;
  int T, S, B;
  int G, U, TT;        // utterances a warp and a block, frames a tile
  int vec;             // 16-byte copies and stores
};

// (B, T, S) tiles: an utterance's TT S floats at a pitch rounded up to 4,
// + 4
__host__ __device__ inline int forward_run_pitch(int S, int TT) { return (TT * S + 3) / 4 * 4 + 4; }

__host__ __device__ inline size_t forward_tile_floats(int S, int U, int TT, int layout) {
  return layout ? (size_t)U * forward_run_pitch(S, TT) : (size_t)TT * S * U;
}

// Shared memory of a forward block, in floats (ops/kernels/lattice.py
// forward_smem_bytes mirrors it): log b in two slots; the lattice out in
// two slots of (TT, S, U) (layout 0); the transitions at 32 < S (R = 2),
// one matrix or the block's U.
__host__ __device__ inline size_t forward_floats(int S, int U, int TT, int layout, int per_row) {
  return 2 * forward_tile_floats(S, U, TT, layout) + (layout ? 0 : 2 * (size_t)TT * S * U) +
         (S > 32 ? (size_t)(per_row ? U : 1) * S * S : 0);
}

// Copies log b of frames [t0, t0 + n) of utterances b0 .. b0 + U into a
// tile: from a (T, S, B) tensor float (t0 + tt, s, b0 + u) goes to
// dst[(tt S + s) U + u] (rows of U floats along B), from a (B, T, S) tensor
// float (b0 + u, t0 + tt, s) to dst[u Q + tt S + s] (a run of n S floats an
// utterance, Q = forward_run_pitch).  Utterances past B read nothing and
// give 0.0f.  Threads i in [0, count) copy, 16 bytes a copy where vec (U,
// B, or T S and TT S, multiples of 4 and the tensor 16-byte aligned), else
// 4.  The caller commits.
__device__ __forceinline__ void stage_forward_tile(float* dst, const float* src, int layout, int t0, int n, int T,
                                                   int S, int B, int b0, int U, int Q, int vec, int i, int count) {
  const int w = vec ? 4 : 1;
  if (layout == 0) {
    const int per = U / w, total = n * S * per;
    for (int c = i; c < total; c += count) {
      const int row = c / per, v = c - row * per, b = b0 + v * w;  // row = tt S + s
      const bool ok = b < B;
      const float* s = ok ? src + ((size_t)t0 * S + row) * B + b : src;
      float* d = dst + (size_t)row * U + v * w;
      if (vec) {
        cp_async16(d, s, ok);
      } else {
        cp_async4(d, s, ok);
      }
    }
  } else {
    // a run's last 16-byte copy stays inside the utterance: T S and t0 S
    // are multiples of 4 where vec
    const int per = (n * S + w - 1) / w, total = U * per;
    for (int c = i; c < total; c += count) {
      const int u = c / per, v = c - u * per;
      const bool ok = b0 + u < B;
      const float* s = ok ? src + ((size_t)(b0 + u) * T + t0) * S + v * w : src;
      float* d = dst + (size_t)u * Q + v * w;
      if (vec) {
        cp_async16(d, s, ok);
      } else {
        cp_async4(d, s, ok);
      }
    }
  }
}

// The way back for a (T, S, B) lattice: tile[(tt S + s) U + u] goes to
// dst[((t0 + tt) S + s) B + b0 + u] for tt < n, b0 + u < B; threads i in
// [0, count), 16-byte stores where vec.
__device__ __forceinline__ void store_forward_tile(float* dst, const float* tile, int t0, int n, int S, int B, int b0,
                                                   int U, int vec, int i, int count) {
  const int w = vec ? 4 : 1, per = U / w, total = n * S * per;
  for (int c = i; c < total; c += count) {
    const int row = c / per, v = c - row * per, b = b0 + v * w;
    if (b >= B) continue;
    float* d = dst + ((size_t)t0 * S + row) * B + b;
    const float* s = tile + (size_t)row * U + v * w;
    if (vec) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else {
      *d = *s;
    }
  }
}

// The NS sources of a lane's state, S <= 32: v[i] = carry of state i of the
// lane's utterance (lanes src0 .. src0 + S - 1) plus the transition i -> j
// (lt[i]); a slot i >= S is -inf.  Every lane of the warp takes part.
template <int NS>
__device__ __forceinline__ void forward_sources(float carry, int src0, int S, const float (&lt)[NS], float (&v)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float x = __shfl_sync(~0u, carry, (src0 + i) & 31);
    v[i] = (i < S) ? x + lt[i] : -INFINITY;
  }
}

// The forward update from NS sources, bitwise the loop over the S real
// ones: m = max(NEG_INF, max_i v[i]) (max is exact in any order, so a tree),
// e = sum of expf(v[i] - m) over i ascending (a -inf slot adds 0.0f),
// max(m + logf(e) + lb, NEG_INF).
template <int NS>
__device__ __forceinline__ float forward_update(const float (&v)[NS], float lb) {
  float mm[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) mm[i] = v[i];
#pragma unroll
  for (int w = NS / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) mm[i] = fmaxf(mm[i], mm[i + w]);
  }
  const float m = fmaxf(kNegInf, mm[0]);
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) e += expf(v[i] - m);
  return fmaxf(m + logf(e) + lb, kNegInf);
}

// R = 2 (32 < S <= 64): lane l holds states l and l + 32 (c[0], c[1]); the
// sources of state j come by shuffle, the transitions from shared memory
// (lt_col[i S] = lt[i -> j]), the update as forward_update.
__device__ __forceinline__ float forward_update_wide(const float (&x)[64], const float* lt_col, int S, float lb) {
  float mm[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mm[i] = (i < S) ? x[i] + lt_col[i * S] : -INFINITY;
#pragma unroll
  for (int w = 32; w >= 1; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) mm[i] = fmaxf(mm[i], mm[i + w]);
  }
  const float m = fmaxf(kNegInf, mm[0]);
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) e += expf(((i < S) ? x[i] + lt_col[i * S] : -INFINITY) - m);
  return fmaxf(m + logf(e) + lb, kNegInf);
}

// Recursion warps: lane l of warp w holds state j = l mod S of utterance u
// = w G + l / S (R = 1; the lanes past G S mirror the warp's last utterance
// and write nothing), or states l and l + 32 of utterance w (R = 2).  Frame
// 0 always initializes the carry (unclamped); frames t >= length keep it.
template <int NS, int R>
__global__ void __launch_bounds__(kFwdThreads) lattice_forward_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, TT = p.TT, tid = threadIdx.x, layout = p.layout;
  const int Q = forward_run_pitch(S, TT);
  const size_t tile = forward_tile_floats(S, U, TT, layout), otile = (size_t)TT * S * U;
  float* lb_slots = sh;                                  // slot k & 1 holds tile k
  float* out_slots = sh + 2 * tile;                      // layout 0
  float* lt_sh = out_slots + (layout ? 0 : 2 * otile);   // R = 2
  const int b0 = blockIdx.x * U, n_rec = 32 * kFwdRecWarps;
  // the block's frames: all T for the lattice; the last row stops at the
  // block's longest utterance (frame 0 always)
  int t_blk = p.T;
  if (layout) {
    t_blk = 1;
    for (int u = 0; u < U && b0 + u < p.B; ++u) t_blk = max(t_blk, min(p.lengths[b0 + u], p.T));
  }
  const int n_tiles = (t_blk + TT - 1) / TT;
  if (R == 2) {  // the transitions clamped at NEG_INF (NEG_INF past B)
    const int SS = S * S, n = (p.per_row ? U : 1) * SS;
    for (int i = tid; i < n; i += blockDim.x) {
      const int b = b0 + i / SS;
      lt_sh[i] = !p.per_row ? fmaxf(p.lt[i], kNegInf) : (b < p.B ? fmaxf(p.lt[(size_t)b0 * SS + i], kNegInf) : kNegInf);
    }
  }
  if (tid >= n_rec) {
    // ---- the memory warp ----
    const int i = tid - n_rec, count = blockDim.x - n_rec;
    auto stage = [&](int k) {
      stage_forward_tile(lb_slots + (k & 1) * tile, p.log_b, layout, k * TT, min(TT, t_blk - k * TT), p.T, S, p.B,
                         b0, U, Q, p.vec, i, count);
      cp_async_commit();
    };
    stage(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = 0; k < n_tiles; ++k) {
      // tile k+1 goes into the slot of tile k-1, read before the last barrier
      if (k + 1 < n_tiles) stage(k + 1);
      if (!layout && k >= 1)
        store_forward_tile(p.out, out_slots + ((k - 1) & 1) * otile, (k - 1) * TT, TT, S, p.B, b0, U, p.vec, i, count);
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!layout) {
      const int k = n_tiles - 1;
      store_forward_tile(p.out, out_slots + (k & 1) * otile, k * TT, t_blk - k * TT, S, p.B, b0, U, p.vec, i, count);
    }
    return;
  }
  // ---- the recursion warps ----
  const int lane = tid & 31, wid = tid >> 5;
  const int gl = (R == 1) ? lane / S : 0;              // the lane's utterance in the warp
  const int g = min(gl, p.G - 1);
  const int u = wid * p.G + g, b = b0 + u;
  const int len = b < p.B ? p.lengths[b] : 0;
  int j[R];
  bool wr[R];  // the lane writes state j[r]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    j[r] = (R == 1) ? lane - gl * S : lane + 32 * r;
    wr[r] = gl < p.G && j[r] < S;
  }
  const int src0 = g * S;
  // a state's offset in a log b tile (a state past S reads state S - 1) and
  // the tile's stride a frame
  int off[R];
#pragma unroll
  for (int r = 0; r < R; ++r) off[r] = layout ? u * Q + min(j[r], S - 1) : min(j[r], S - 1) * U + u;
  const int fs = layout ? S : S * U;
  float ltc[R == 1 ? NS : 1];
  if (R == 1) {
    const float* ltp = p.lt + (p.per_row ? (size_t)min(b, p.B - 1) * S * S : 0);
#pragma unroll
    for (int i = 0; i < (R == 1 ? NS : 1); ++i) ltc[i] = (i < S) ? fmaxf(ltp[i * S + j[0]], kNegInf) : -INFINITY;
  }
  const float* lt_col = lt_sh + (p.per_row ? (size_t)u * S * S : 0);
  float carry[R];
#pragma unroll
  for (int r = 0; r < R; ++r) carry[r] = kNegInf;
  __syncthreads();  // tile 0 (and the transitions) are in
  for (int k = 0; k < n_tiles; ++k) {
    const int t_lo = k * TT, t_hi = min(t_blk, t_lo + TT);
    const float* lbt = lb_slots + (k & 1) * tile;
    float* ot = out_slots + (k & 1) * otile;
    float lbn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lbn[r] = lbt[off[r]];
    for (int t = t_lo; t < t_hi; ++t) {
      const int tt = t - t_lo;
      float lb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lb[r] = fmaxf(lbn[r], kNegInf);
        if (t + 1 < t_hi) lbn[r] = lbt[(size_t)(tt + 1) * fs + off[r]];
      }
      float next[R];
      if constexpr (R == 1) {
        float v[NS];
        forward_sources<NS>(carry[0], src0, S, ltc, v);
        next[0] = forward_update<NS>(v, lb[0]);
      } else {
        float x[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) x[i] = __shfl_sync(~0u, carry[i >> 5], i & 31);
#pragma unroll
        for (int r = 0; r < R; ++r) next[r] = forward_update_wide(x, lt_col + min(j[r], S - 1), S, lb[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        carry[r] = (t == 0) ? (j[r] == 0 ? 0.f : kNegInf) + lb[r] : (t < len ? next[r] : carry[r]);
        if (!layout && wr[r]) ot[(size_t)tt * S * U + j[r] * U + u] = carry[r];
      }
    }
    __syncthreads();
  }
  if (layout && b < p.B) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (wr[r]) p.out[(size_t)b * S + j[r]] = carry[r];
  }
}

using ForwardFn = void (*)(FwdParams);

// the instantiation for S states: NS slots, R states a lane
ForwardFn forward_kernel_for(int S) {
  if (S <= 4) return lattice_forward_kernel<4, 1>;
  if (S <= 8) return lattice_forward_kernel<8, 1>;
  if (S <= 16) return lattice_forward_kernel<16, 1>;
  if (S <= 32) return lattice_forward_kernel<32, 1>;
  return lattice_forward_kernel<64, 2>;
}

// ---------------------------------------------------------------------------
// backward and Viterbi
// ---------------------------------------------------------------------------

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
  if (p.T < 1 || p.S < 1 || p.S > kMaxStates || p.B < 1 || p.U < 1 || p.S * p.U > kMaxLatticeThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * (2 * (size_t)p.S * p.U + (size_t)(p.per_row ? p.U : 1) * p.S * p.S);
  const void* fn = kind == kBackward ? reinterpret_cast<const void*>(lattice_backward_kernel)
                                     : reinterpret_cast<const void*>(viterbi_kernel);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (p.B + p.U - 1) / p.U;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == kBackward) {
    lattice_backward_kernel<<<blocks, p.S * p.U, smem, s>>>(p);
  } else {
    viterbi_kernel<<<blocks, p.S * p.U, smem, s>>>(p);
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
// Pointers are device pointers; lengths int32 (B,), lt float32 (S, S) or,
// with per_row, (B, S, S).

// The forward kernel.  layout 0: log b (T, S, B) contiguous, out the (T,
// S, B) lattice; layout 1: log b (B, T, S) contiguous, out the final
// carries (B, S).  G utterances a warp, U = 4 G a block and TT frames a
// tile from ops/kernels/lattice.py forward_block; vec: 16-byte copies (U
// and B, or T S and TT S, multiples of 4, log b and out 16-byte aligned).
int srhmm_lattice_forward(const void* log_b, const void* lt, int per_row, const void* lengths, void* out,
                          int layout, int T, int S, int B, int G, int U, int TT, int vec, int device,
                          void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(log_b) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vec_ok = layout ? (T * S % 4 == 0 && TT * S % 4 == 0) : (U % 4 == 0 && B % 4 == 0);
  if (T < 1 || S < 1 || S > kMaxStates || B < 1 || TT < 1 || (layout != 0 && layout != 1) ||
      G != (S > 32 ? 1 : 32 / S) || U != G * kFwdRecWarps || (vec && !(aligned && vec_ok))) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * forward_floats(S, U, TT, layout, per_row);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ForwardFn fn = forward_kernel_for(S);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  FwdParams p{static_cast<const float*>(log_b), static_cast<const float*>(lt), static_cast<const int*>(lengths),
              static_cast<float*>(out), per_row, layout, T, S, B, G, U, TT, vec};
  fn<<<(B + U - 1) / U, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The backward and Viterbi kernels read log b with element strides (st,
// ss, sb) for (t, s, b).

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
