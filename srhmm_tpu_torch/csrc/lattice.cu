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
//   lattice_group_kernel    <- the three past 64 states (the group mode
//                              below; the Viterbi its kViterbiKind)
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
// Layouts.  The lattices and the backward's log b are (T, S, B) contiguous
// (layout 0); log_forward_batch's and viterbi_batch's log b and the
// backpointers are (B, T, S) (layout 1): all are read and written in place,
// with no transpose.  Transitions are one (S, S) matrix, or for
// log_forward_batch also one per utterance, (B, S, S).
//
// Design, the same in the three kernels.  The S states of an utterance sit
// on adjacent lanes of a warp, G = 32 / S utterances a warp (S <= 32; for
// 32 < S <= 64 one utterance a warp, lane l holding states l and l + 32),
// U = 4 G utterances a block of four recursion warps and one memory warp
// (two for the Viterbi).  Per frame a lane takes the S values of its utterance's states by
// __shfl_sync (forward_sources) with its column (forward, Viterbi) or row
// (backward) of the transitions in registers (in shared memory at 32 < S),
// and runs its update unrolled to NS = 4, 8, 16, 32 or 64 compiled slots, a
// slot past S entering as -inf, which changes no bit: the log-sum-exp
// (forward_update; the backward's without the emission term) or the best
// source (viterbi_best).  Nothing but shuffles and math is on the serial
// chain, no barrier and no load from device memory.  The block walks tiles
// of TT frames: while the recursion warps run tile k out of shared memory
// (log b read a frame ahead into registers), the memory warp copies the
// next tile's log b in by 16-byte cp.async (stage_forward_tile: rows of U
// utterances along B of a (T, S, B) tensor, or one run of TT S floats an
// utterance of a (B, T, S) tensor) and writes tile k-1's output: the (T,
// S, B) lattice in rows of U consecutive floats (store_forward_tile), the
// (B, T, S) backpointers in runs of TT S int32 an utterance
// (store_run_tile); one barrier closes a tile.  The forward's last-row mode
// stops at the block's longest utterance and writes only the final carries;
// the backward walks its tiles down in time, the tile of rows [t_lo, t_hi)
// holding log b of frames [t_lo + 1, t_hi + 1).  The terms keep the order
// of one thread a (state, utterance) looping over the sources (the max,
// exact in any order, as a tree; the sum of expf ascending; m + logf(e) +
// lb; the best source by a strict > from source 0, as a tree that keeps its
// lower half on a tie), so every lattice, last row, score and backpointer
// is bitwise that loop's.
//
// What bounds it on the H100.  The forward and backward lattices move 2 T
// S B floats (65.5 MB at the em_diag shape B=2048, T=500, S=8: ~0.02 ms of
// HBM time), the Viterbi as many bytes (log b in, int32 backpointers out),
// and each does ~3-6 S^2 operations a (frame, utterance): bytes bound them
// on paper.  In practice the serial chain of T frames an utterance sets the
// time: the shuffles, the S-term update and one logf a frame (forward,
// backward) or the compare-and-select tree (Viterbi), with four recursion
// warps an SM at em_diag (512 warps on 132 SMs), too few to hide one warp's
// latency behind another's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxStates = 64;  // the lane path; the group mode takes up to kMaxBlockStates
constexpr int kMaxBlockStates = 4096;  // the group mode's states at most
constexpr size_t kSmemLimit = 232448;  // bytes a block may use (ops/kernels/common.py SMEM_LIMIT)

// ---------------------------------------------------------------------------
// the lanes and the memory warp, shared by the three kernels; the forward
// ---------------------------------------------------------------------------

constexpr int kFwdRecWarps = 4;                       // recursion warps a block
constexpr int kFwdThreads = 32 * (kFwdRecWarps + 1);  // and one memory warp
// The Viterbi's chain is short enough that one memory warp cannot copy and
// store a tile while the recursion warps run one: two.
constexpr int kVitThreads = 32 * (kFwdRecWarps + 2);

struct Params {
  const float* log_b;  // (T, S, B) (layout 0) or (B, T, S) (layout 1), contiguous
  const float* lt;     // (S, S), or (B, S, S) when per_row (the forward's last row)
  const int* lengths;  // (B,)
  float* out;          // the (T, S, B) lattice (forward layout 0, backward); the final carries (forward
                       // layout 1) or scores (Viterbi), (B, S)
  int per_row, layout;
  int T, S, B;
  int G, U, TT;        // utterances a warp and a block, frames a tile
  int vec;             // 16-byte copies and stores
  int* bptr;           // Viterbi: the (B, T, S) backpointers
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
// max(m + logf(e) + lb, NEG_INF); the backward's (kEmit false) max(m +
// logf(e), NEG_INF), with no term added (+ 0.0f would turn a -0.0f into
// +0.0f).
template <int NS, bool kEmit = true>
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
  if constexpr (!kEmit) return fmaxf(m + logf(e), kNegInf);
  return fmaxf(m + logf(e) + lb, kNegInf);
}

// R = 2 (32 < S <= 64): lane l holds states l and l + 32 (c[0], c[1]); the
// sources of state j come by shuffle, the transitions from shared memory
// (lt_col[i S] = lt[i -> j]; for the backward a transposed matrix), the
// update as forward_update.
template <bool kEmit = true>
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
  if constexpr (!kEmit) return fmaxf(m + logf(e), kNegInf);
  return fmaxf(m + logf(e) + lb, kNegInf);
}

// Recursion warps: lane l of warp w holds state j = l mod S of utterance u
// = w G + l / S (R = 1; the lanes past G S mirror the warp's last utterance
// and write nothing), or states l and l + 32 of utterance w (R = 2).  Frame
// 0 always initializes the carry (unclamped); frames t >= length keep it.
template <int NS, int R>
__global__ void __launch_bounds__(kFwdThreads) lattice_forward_kernel(const __grid_constant__ Params p) {
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

using KernelFn = void (*)(Params);

// the instantiation for S states: NS slots, R states a lane
KernelFn forward_kernel_for(int S) {
  if (S <= 4) return lattice_forward_kernel<4, 1>;
  if (S <= 8) return lattice_forward_kernel<8, 1>;
  if (S <= 16) return lattice_forward_kernel<16, 1>;
  if (S <= 32) return lattice_forward_kernel<32, 1>;
  return lattice_forward_kernel<64, 2>;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Tile k of the backward holds rows [t_lo, t_hi), t_hi = T - k TT, t_lo =
// max(t_hi - TT, 0): the block walks down in time.
__device__ __forceinline__ void backward_rows(int k, int T, int TT, int& t_lo, int& t_hi) {
  t_hi = T - k * TT;
  t_lo = max(t_hi - TT, 0);
}

// Recursion warps: the forward's lanes (lane l of warp w holds state i = l
// mod S of utterance u = w G + l / S, or states l and l + 32 of utterance w
// at R = 2), holding beta[t+1, i].  Row T-1 is the initialization (0 in
// state S-1, NEG_INF elsewhere); row t < T-1 is the recursion where t + 1 <
// length, else the initialization.  A lane first forms its own inner =
// max(log_b[t+1, i], NEG_INF) + beta[t+1, i]; forward_sources brings the S
// inner values of its utterance with row i of the transitions (in shared
// memory, transposed, at R = 2).  Row t's log b (frame t + 1) sits at tile
// row t - t_lo: the memory warp stages frames [t_lo + 1, min(t_hi + 1, T)).
template <int NS, int R>
__global__ void __launch_bounds__(kFwdThreads) lattice_backward_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, TT = p.TT, T = p.T, tid = threadIdx.x;
  const size_t tile = (size_t)TT * S * U;
  float* lb_slots = sh;               // slot k & 1 holds tile k
  float* out_slots = sh + 2 * tile;
  float* lt_sh = out_slots + 2 * tile;  // R = 2: lt_sh[k S + i] = lt[i -> k]
  const int b0 = blockIdx.x * U, n_rec = 32 * kFwdRecWarps;
  const int n_tiles = (T + TT - 1) / TT;
  if (R == 2) {
    for (int n = tid; n < S * S; n += blockDim.x) lt_sh[n] = fmaxf(p.lt[(n % S) * S + n / S], kNegInf);
  }
  if (tid >= n_rec) {
    // ---- the memory warp ----
    const int i = tid - n_rec, count = blockDim.x - n_rec;
    auto stage = [&](int k) {
      int t_lo, t_hi;
      backward_rows(k, T, TT, t_lo, t_hi);
      stage_forward_tile(lb_slots + (k & 1) * tile, p.log_b, 0, t_lo + 1, min(t_hi + 1, T) - t_lo - 1, T, S, p.B, b0,
                         U, 0, p.vec, i, count);
      cp_async_commit();
    };
    auto store = [&](int k) {
      int t_lo, t_hi;
      backward_rows(k, T, TT, t_lo, t_hi);
      store_forward_tile(p.out, out_slots + (k & 1) * tile, t_lo, t_hi - t_lo, S, p.B, b0, U, p.vec, i, count);
    };
    stage(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = 0; k < n_tiles; ++k) {
      // tile k+1 goes into the slot of tile k-1, read before the last barrier
      if (k + 1 < n_tiles) stage(k + 1);
      if (k >= 1) store(k - 1);
      cp_async_wait<0>();
      __syncthreads();
    }
    store(n_tiles - 1);
    return;
  }
  // ---- the recursion warps ----
  const int lane = tid & 31, wid = tid >> 5;
  const int gl = (R == 1) ? lane / S : 0;
  const int g = min(gl, p.G - 1);
  const int u = wid * p.G + g, b = b0 + u;
  const int len = b < p.B ? p.lengths[b] : 0;
  int st[R];
  bool wr[R];
  int off[R];
  float beta[R], init[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st[r] = (R == 1) ? lane - gl * S : lane + 32 * r;
    wr[r] = gl < p.G && st[r] < S;
    off[r] = min(st[r], S - 1) * U + u;
    init[r] = (st[r] == S - 1) ? 0.f : kNegInf;
    beta[r] = init[r];
  }
  const int src0 = g * S, fs = S * U;
  float ltr[R == 1 ? NS : 1];
  if (R == 1) {
#pragma unroll
    for (int k = 0; k < (R == 1 ? NS : 1); ++k) ltr[k] = (k < S) ? fmaxf(p.lt[st[0] * S + k], kNegInf) : -INFINITY;
  }
  __syncthreads();  // tile 0 (and the transitions) are in
  for (int k = 0; k < n_tiles; ++k) {
    int t_lo, t_hi;
    backward_rows(k, T, TT, t_lo, t_hi);
    const float* lbt = lb_slots + (k & 1) * tile;
    float* ot = out_slots + (k & 1) * tile;
    float lbn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lbn[r] = lbt[(size_t)(t_hi - 1 - t_lo) * fs + off[r]];
    for (int t = t_hi - 1; t >= t_lo; --t) {
      const int tt = t - t_lo;
      float lb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lb[r] = fmaxf(lbn[r], kNegInf);
        if (t > t_lo) lbn[r] = lbt[(size_t)(tt - 1) * fs + off[r]];
      }
      if (t < T - 1) {  // row T-1 keeps the initialization
        float inner[R], next[R];
#pragma unroll
        for (int r = 0; r < R; ++r) inner[r] = lb[r] + beta[r];
        if constexpr (R == 1) {
          float v[NS];
          forward_sources<NS>(inner[0], src0, S, ltr, v);
          next[0] = forward_update<NS, false>(v, 0.f);
        } else {
          float x[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) x[i] = __shfl_sync(~0u, inner[i >> 5], i & 31);
#pragma unroll
          for (int r = 0; r < R; ++r) next[r] = forward_update_wide<false>(x, lt_sh + min(st[r], S - 1), S, 0.f);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) beta[r] = (t + 1 < len) ? next[r] : init[r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (wr[r]) ot[(size_t)tt * fs + st[r] * U + u] = beta[r];
    }
    __syncthreads();
  }
}

KernelFn backward_kernel_for(int S) {
  if (S <= 4) return lattice_backward_kernel<4, 1>;
  if (S <= 8) return lattice_backward_kernel<8, 1>;
  if (S <= 16) return lattice_backward_kernel<16, 1>;
  if (S <= 32) return lattice_backward_kernel<32, 1>;
  return lattice_backward_kernel<64, 2>;
}

// ---------------------------------------------------------------------------
// Viterbi
// ---------------------------------------------------------------------------

// Shared memory of a Viterbi block, in floats (ops/kernels/lattice.py
// viterbi_smem_bytes mirrors it): log b in two slots of U runs of TT S
// floats, the backpointers out in two slots of the same shape; the
// transitions at 32 < S (R = 2).
__host__ __device__ inline size_t viterbi_floats(int S, int U, int TT) {
  return 4 * forward_tile_floats(S, U, TT, 1) + (S > 32 ? (size_t)S * S : 0);
}

// The way back for (B, T, S) backpointers: tile[u Q + tt S + s] goes to
// dst[((b0 + u) T + t0 + tt) S + s] for tt < n, b0 + u < B, a run of n S
// int32 an utterance; threads i in [0, count), 16-byte stores where vec (T
// S and TT S multiples of 4, dst 16-byte aligned).
__device__ __forceinline__ void store_run_tile(int* dst, const int* tile, int t0, int n, int T, int S, int B, int b0,
                                               int U, int Q, int vec, int i, int count) {
  const int w = vec ? 4 : 1, per = (n * S + w - 1) / w, total = U * per;
  for (int c = i; c < total; c += count) {
    const int u = c / per, v = c - u * per;
    if (b0 + u >= B) continue;
    int* d = dst + ((size_t)(b0 + u) * T + t0) * S + v * w;
    const int* s = tile + (size_t)u * Q + v * w;
    if (vec) {
      *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(s);
    } else {
      *d = *s;
    }
  }
}

// The best of NS candidates and its source: a tree whose every node keeps
// its lower half unless the upper is strictly greater, so the lowest source
// of the maximum wins, as a strict > from source 0 (lax.argmax) does; a -inf
// slot past S never wins.
template <int NS>
__device__ __forceinline__ float viterbi_best(const float (&v)[NS], int& arg) {
  float bv[NS];
  int bi[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) bv[i] = v[i], bi[i] = i;
#pragma unroll
  for (int w = 1; w < NS; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < NS; i += 2 * w) {
      const bool up = bv[i + w] > bv[i];
      bi[i] = up ? bi[i + w] : bi[i];
      bv[i] = up ? bv[i + w] : bv[i];
    }
  }
  arg = bi[0];
  return bv[0];
}

// R = 2: the best source of state j from the 64 shuffled scores and column
// j of the transitions in shared memory (lt_col[i S] = lt[i -> j]), by a
// strict > from source 0.
__device__ __forceinline__ float viterbi_best_wide(const float (&x)[64], const float* lt_col, int S, int& arg) {
  float best = x[0] + lt_col[0];
  arg = 0;
#pragma unroll
  for (int i = 1; i < 64; ++i) {
    const float c = (i < S) ? x[i] + lt_col[i * S] : -INFINITY;
    if (c > best) {
      best = c;
      arg = i;
    }
  }
  return best;
}

// Recursion warps: the forward's lanes and staging on (B, T, S) log b,
// holding the score of state j.  Frame 0 initializes the score (0 in state
// 0, NEG_INF elsewhere, + log b, unclamped); frames 1 <= t < length take
// the best source's score + log b, clamped at NEG_INF; frames t >= length
// keep it.  A backpointer row holds the best source where the score
// stepped, the identity j on row 0 and past the length; the rows go out a
// tile behind, the scores (B, S) at the end.
template <int NS, int R>
__global__ void __launch_bounds__(kVitThreads) viterbi_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, TT = p.TT, T = p.T, tid = threadIdx.x;
  const int Q = forward_run_pitch(S, TT);
  const size_t tile = forward_tile_floats(S, U, TT, 1);
  float* lb_slots = sh;                                 // slot k & 1 holds tile k
  int* bp_slots = reinterpret_cast<int*>(sh + 2 * tile);
  float* lt_sh = sh + 4 * tile;                         // R = 2
  const int b0 = blockIdx.x * U, n_rec = 32 * kFwdRecWarps;
  const int n_tiles = (T + TT - 1) / TT;
  if (R == 2) {
    for (int n = tid; n < S * S; n += blockDim.x) lt_sh[n] = fmaxf(p.lt[n], kNegInf);
  }
  if (tid >= n_rec) {
    // ---- the memory warp ----
    const int i = tid - n_rec, count = blockDim.x - n_rec;
    auto stage = [&](int k) {
      stage_forward_tile(lb_slots + (k & 1) * tile, p.log_b, 1, k * TT, min(TT, T - k * TT), T, S, p.B, b0, U, Q,
                         p.vec, i, count);
      cp_async_commit();
    };
    auto store = [&](int k) {
      store_run_tile(p.bptr, bp_slots + (k & 1) * tile, k * TT, min(TT, T - k * TT), T, S, p.B, b0, U, Q, p.vec, i,
                     count);
    };
    stage(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = 0; k < n_tiles; ++k) {
      // tile k+1 goes into the slot of tile k-1, read before the last barrier
      if (k + 1 < n_tiles) stage(k + 1);
      if (k >= 1) store(k - 1);
      cp_async_wait<0>();
      __syncthreads();
    }
    store(n_tiles - 1);
    return;
  }
  // ---- the recursion warps ----
  const int lane = tid & 31, wid = tid >> 5;
  const int gl = (R == 1) ? lane / S : 0;
  const int g = min(gl, p.G - 1);
  const int u = wid * p.G + g, b = b0 + u;
  const int len = b < p.B ? p.lengths[b] : 0;
  int j[R];
  bool wr[R];
  int off[R];
  float score[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    j[r] = (R == 1) ? lane - gl * S : lane + 32 * r;
    wr[r] = gl < p.G && j[r] < S;
    off[r] = u * Q + min(j[r], S - 1);
    score[r] = kNegInf;
  }
  const int src0 = g * S;
  float ltc[R == 1 ? NS : 1];
  if (R == 1) {
#pragma unroll
    for (int i = 0; i < (R == 1 ? NS : 1); ++i) ltc[i] = (i < S) ? fmaxf(p.lt[i * S + j[0]], kNegInf) : -INFINITY;
  }
  __syncthreads();  // tile 0 (and the transitions) are in
  for (int k = 0; k < n_tiles; ++k) {
    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);
    const float* lbt = lb_slots + (k & 1) * tile;
    int* bpt = bp_slots + (k & 1) * tile;
    float lbn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lbn[r] = lbt[off[r]];
    for (int t = t_lo; t < t_hi; ++t) {
      const int tt = t - t_lo;
      float lb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lb[r] = fmaxf(lbn[r], kNegInf);
        if (t + 1 < t_hi) lbn[r] = lbt[(tt + 1) * S + off[r]];
      }
      float best[R];
      int arg[R];
      if constexpr (R == 1) {
        float v[NS];
        forward_sources<NS>(score[0], src0, S, ltc, v);
        best[0] = viterbi_best<NS>(v, arg[0]);
      } else {
        float x[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) x[i] = __shfl_sync(~0u, score[i >> 5], i & 31);
#pragma unroll
        for (int r = 0; r < R; ++r) best[r] = viterbi_best_wide(x, lt_sh + min(j[r], S - 1), S, arg[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool step = t >= 1 && t < len;
        score[r] = (t == 0) ? (j[r] == 0 ? 0.f : kNegInf) + lb[r] : (step ? fmaxf(best[r] + lb[r], kNegInf) : score[r]);
        if (wr[r]) bpt[u * Q + tt * S + j[r]] = step ? arg[r] : j[r];
      }
    }
    __syncthreads();
  }
  if (b < p.B) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (wr[r]) p.out[(size_t)b * S + j[r]] = score[r];
  }
}

KernelFn viterbi_kernel_for(int S) {
  if (S <= 4) return viterbi_kernel<4, 1>;
  if (S <= 8) return viterbi_kernel<8, 1>;
  if (S <= 16) return viterbi_kernel<16, 1>;
  if (S <= 32) return viterbi_kernel<32, 1>;
  return viterbi_kernel<64, 2>;
}

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// ---------------------------------------------------------------------------
// the group mode: the forward and backward lattices and the Viterbi past
// kMaxStates
// ---------------------------------------------------------------------------
enum { kForwardKind = 0, kBackwardKind = 1, kViterbiKind = 2 };
//
// The forward and the backward compute, for every key k of a row (the
// forward's destination, the backward's source), a log-sum-exp over the
// previous row x (log-alpha; the backward's inner terms log b + log-beta)
// plus a column of the log transitions g[o S + k] (the backward is given the
// transposed matrix).  Past 64 states one such row is S^2 exponentials, and
// the matrix (4 MB at S = 1024) does not fit a block.
//
// A cluster of C blocks takes a group of G consecutive utterances (one
// where the transitions are per utterance: nothing is shared then), and
// each block owns a slice of Db keys [rank Db, rank Db + Db) for all G of
// them.  Every block holds the group's whole previous row, double-buffered
// (2 G rows of RP floats); after a frame each
// block writes its slice of the new row into every peer's buffer through
// distributed shared memory, and one cluster barrier (arrive.release /
// wait.acquire) a frame orders the cluster: a frame reads one slot and the
// peers write the other.  Each transition a block loads serves its G
// utterances, and each element of the row several keys.
//
// Two routes for the transitions, chosen by the cluster at its start from
// the widest range W of sources above NEG_INF over its keys (the same in
// every block): "packed", where W Db floats fit lt_cap: the ranges' entries
// of the block's keys sit in shared memory and an owner thread of a
// (utterance, key) pair runs the max and the sum of expf over its range as
// the plain twin does (a banded chain's two or three terms, or a small
// dense matrix); "streamed" otherwise: tiles of KT sources x Db keys stream
// from device memory (through L2) by 16-byte cp.async into kGroupStages
// slots, and a thread takes a register tile of UT utterances x 4 keys over
// its share of SP sources of each tile (KS shares a tile), keeping
// an online log-sum-exp: a pair's sum is taken against a reference m, a
// running max that is raised lazily: each chunk of kGroupChunk sources runs
// as straight-line code (v = x + a, ex2.approx of v log2(e) - m log2(e) by
// one fma, the add), and only where a chunk's sum passes kGroupLazy (a
// source more than ~44 nats above m, or m still at the floor) is the chunk
// taken again against its max (the sum rescaled, the difference v - m in
// natural units); m + log(sum) is exact whatever m is.  The KS partial
// (reference, sum) pairs of a key are combined by its owner in a fixed
// order.  Every (source, key) pair gets its own exponential: no term leaves
// the log domain, so a key whose sources all sit far below the row's
// maximum keeps its mass.
//
// log b: an owner copies the values of its pairs kGroupRing - 1 frames
// ahead into a ring of its own (4-byte cp.async, one commit group a frame).
// Outputs: the owners write the (T, S, B) lattice or, for (B, T, S) log b,
// the final carries.  A group runs to its
// longest member; rows past each member's length follow the lane path's
// rules (the forward repeats the last valid row, the backward keeps the
// initialization), and the rows past the group's longest are written
// without a recursion.  Sums run in a fixed order, so two runs are bitwise
// equal.
//
// What bounds it on the H100: one exponential per (source, key, frame) on
// the SFU (16 a clock an SM): a dense S = 1024 lattice at B = 64 needs 2.1e10;
// beside each one the streamed route issues an add (v = x + a), an fma (the
// exponent) and the add of the sum.
//
// The Viterbi (kViterbiKind; TPU kernel forward_pallas.py:137
// viterbi_batch_pallas past 64 states) is the forward's recursion on (B, T,
// S) log b in the (max, +) semiring, each key's best source taken by a
// strict > from source 0.  Max-plus rounds once a candidate (x + a) and max
// is exact, so any order of the sources gives the same best, and a fixed
// lowest-on-a-tie rule the same source: the kernel is bitwise the plain
// twin's loop.  Streamed, a thread keeps (best, source) of each pair of its
// register tile over its share's sources, ascending (an add, a compare, two
// selects: no SFU work; the transitions clamped at NEG_INF in registers),
// and the owner takes the KS partial pairs' largest value, the lowest
// source among equal ones (share_best).  Packed, the owner walks its key's
// range; where that range's best sits at or below NEG_INF (a state not yet
// reachable), sources outside it (transition NEG_INF) may tie, so it walks
// all S (range_best).  The owners write the backpointers of their pairs
// (keys fastest: a warp's stores coalesce), the identity at frame 0 and past
// a member's length, whose carry stays; rows past the group's longest
// member are the identity, the final carries the scores.  Bound: 4
// instructions a (source, key, utterance, frame) at the issue rate (128
// lanes a clock an SM), 2.1e10 such steps at S = 1024 dense, B = 64.
constexpr int kGroupRing = 8;        // frames of log b an owner keeps in flight
constexpr int kGroupStages = 2;      // transition tiles in flight (the streamed route)
constexpr int kGroupChunk = 8;       // sources of one max-then-exponentials step (SP a multiple)
constexpr int kGroupMaxThreads = 1024;
constexpr int kGroupStreamThreads = 640;  // the instance whose registers suit the streamed route
constexpr int kGroupMaxOwned = 16;   // (utterance, key) pairs a thread owns at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kGroupLazy = 0x1p64f;  // a chunk's sum of exponentials past which it is taken again

struct GroupParams {
  const float* log_b;  // (T, S, B) (layout 0) or (B, T, S) (layout 1), contiguous
  const float* lt;     // (S, S) key k's terms column k; (B, S, S) per utterance where per_row (G = 1)
  const int* lengths;  // (B,)
  float* out;          // the (T, S, B) lattice (layout 0) or the final carries (B, S) (layout 1, forward; the
                       // Viterbi's scores)
  int* bptr;           // the Viterbi's (B, T, S) int32 backpointers
  int per_row, layout, T, S, B;
  int G, C, NT, KS;    // utterances a group, blocks a cluster, threads a block, source shares a tile
  int SP;              // sources a share (a multiple of kGroupChunk)
  int lt_cap, vec;     // floats of the transitions' region; 16-byte tile copies (S % 4 == 0, lt aligned)
};

// The shape of a group-mode block, in floats (ops/kernels/lattice.py
// group_regions mirrors it): keys a block Db (ceil(S / C) rounded up to
// 4), sources a tile KT, row pitches; the regions: two rows of G
// utterances | the log b ring | the owners' carries | the partial (max,
// sum) pairs, KS a pair | lo, cnt of Db ints, the width and the G lengths |
// the transitions, lt_cap floats (the packed ranges, or kGroupStages tiles
// of KT x Db).
struct GroupLayout {
  int Db, KT, rp_stream, rp_packed, PO;
  size_t rows, ring, carry, part, ints, tiles;
};

__host__ __device__ inline GroupLayout group_layout(int S, int G, int C, int NT, int KS, int SP) {
  GroupLayout L;
  L.Db = ((S + C - 1) / C + 3) / 4 * 4;
  L.KT = SP * KS;
  L.rp_stream = (S + L.KT - 1) / L.KT * L.KT;  // float4 rows, -inf past S
  L.rp_packed = S | 1;                         // an odd pitch: utterances on other banks
  L.PO = (G * L.Db + NT - 1) / NT;
  L.rows = round4(2 * (size_t)G * max(L.rp_stream, L.rp_packed));
  L.ring = (size_t)kGroupRing * L.PO * NT;
  L.carry = (size_t)L.PO * NT;
  L.part = 2 * (size_t)KS * G * L.Db;
  L.ints = round4(2 * (size_t)L.Db + 1 + G);
  L.tiles = (size_t)kGroupStages * L.KT * L.Db;
  return L;
}

__host__ __device__ inline size_t group_floats(const GroupLayout& L, int lt_cap) {
  return L.rows + L.ring + L.carry + L.part + L.ints + (size_t)lt_cap;
}

__device__ __forceinline__ float lane4(const float4& a, int c) {
  return c == 0 ? a.x : (c == 1 ? a.y : (c == 2 ? a.z : a.w));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The max and the sum of exponentials of one key over its packed range, as
// the plain twin takes them: x the row from the range's first source, a the
// key's clamped entries at a stride of Db; m = max(NEG_INF, max v), the sum
// of expf(v - m) ascending.
__device__ __forceinline__ float2 range_lse(const float* x, const float* a, int Db, int n) {
  float m = kNegInf;
  for (int e = 0; e < n; ++e) m = fmaxf(m, x[e] + a[(size_t)e * Db]);
  float sum = 0.f;
  for (int e = 0; e < n; ++e) sum += expf(x[e] + a[(size_t)e * Db] - m);
  return make_float2(m, sum);
}

// The Viterbi's best source of one key over its packed range [l0, l0 + n)
// (x the group row, a the key's clamped entries at a stride of Db) by a
// strict > from the range's first source; where that best is at or below
// NEG_INF, sources outside the range (transition NEG_INF) may tie with it,
// so the walk runs over all S sources from source 0.
__device__ __forceinline__ float range_best(const float* x, const float* a, int Db, int l0, int n, int S, int& arg) {
  float best = -INFINITY;
  arg = 0;
  for (int e = 0; e < n; ++e) {
    const float c = x[l0 + e] + a[(size_t)e * Db];
    if (e == 0 || c > best) {
      best = c;
      arg = l0 + e;
    }
  }
  if (n > 0 && best > kNegInf) return best;
  for (int i = 0; i < S; ++i) {
    const float c = x[i] + (i >= l0 && i < l0 + n ? a[(size_t)(i - l0) * Db] : kNegInf);
    if (i == 0 || c > best) {
      best = c;
      arg = i;
    }
  }
  return best;
}

// The Viterbi's best of the KS partial (best, source) pairs of owner pair q
// (values at [r GD + q], sources after them at [KS GD + r GD + q]): the
// largest value and, among equal values, the lowest source (each share
// holds the lowest of its own sources; a later share may hold a lower
// source of a later tile).
__device__ __forceinline__ float share_best(const float* part, int GD, int KS, int q, int& arg) {
  const int* src = reinterpret_cast<const int*>(part) + (size_t)KS * GD;
  float best = part[q];
  arg = src[q];
  for (int r = 1; r < KS; ++r) {
    const float c = part[(size_t)r * GD + q];
    const int a = src[(size_t)r * GD + q];
    if (c > best || (c == best && a < arg)) {
      best = c;
      arg = a;
    }
  }
  return best;
}

// The owner pairs of thread tid: pair index q = tid + i NT < G Db, the
// utterance fastest (ufast) where a group is one block with the (T, S, B)
// lattice out (G consecutive floats a key), else the key fastest: a warp's
// new row then goes into a peer's shared memory in consecutive floats, and
// (B, T, S) log b is read along its keys.
__device__ __forceinline__ void owner_pair(int q, int G, int Db, bool ufast, int& u, int& kk) {
  if (ufast) {
    u = q % G;
    kk = q / G;
  } else {
    kk = q % Db;
    u = q / Db;
  }
}

template <int KIND, int UT, int MAXT>
__global__ void __launch_bounds__(MAXT) lattice_group_kernel(const __grid_constant__ GroupParams p) {
  namespace cg = cooperative_groups;
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = p.S, T = p.T, B = p.B, G = p.G, C = p.C, NT = p.NT, KS = p.KS, tid = threadIdx.x;
  const int layout = KIND == kViterbiKind ? 1 : (KIND == kForwardKind ? p.layout : 0);
  const bool ufast = layout == 0 && C == 1;
  const GroupLayout L = group_layout(S, G, C, NT, KS, p.SP);
  const int Db = L.Db, KT = L.KT, PO = L.PO, GD = G * Db, SP = p.SP;
  const int rank = (int)cluster.block_rank(), d0 = rank * Db, b0 = (blockIdx.x / C) * G;
  float* rows = sh;
  float* ring = rows + L.rows;
  float* carry = ring + L.ring;  // the forward's carries, the backward's log-beta: [i NT + tid]
  float* part = carry + L.carry;  // max at [s GD + q], sum at [KS GD + s GD + q] (the Viterbi: best, source)
  int* lo = reinterpret_cast<int*>(part + L.part);
  int* cnt = lo + Db;
  int* width = cnt + Db;
  int* glen = width + 1;
  float* ltr = reinterpret_cast<float*>(lo) + L.ints;
  const float* g = p.lt + (p.per_row ? (size_t)b0 * S * S : 0);

  // the group's lengths and frames: the forward and the Viterbi take frame 0 always
  int tg = 0;
  for (int u = 0; u < G; ++u) {
    const int n = b0 + u < B ? min(p.lengths[b0 + u], T) : 0;
    tg = max(tg, KIND != kBackwardKind ? max(1, n) : n);
    if (tid == 0) glen[u] = b0 + u < B ? p.lengths[b0 + u] : 0;
  }
  const int n_steps = tg;  // step s: the forward's frame s; the backward's row tg - 1 - s

  // the ranges of the block's keys: entries above NEG_INF of column k
  if (tid == 0) *width = 0;
  __syncthreads();
  for (int kk = tid; kk < Db; kk += NT) {
    const int k = d0 + kk;
    int first = S, last = -1;
    if (k < S) {
#pragma unroll 8
      for (int e = 0; e < S; ++e) {
        if (g[(size_t)e * S + k] > kNegInf) {
          first = min(first, e);
          last = e;
        }
      }
    }
    lo[kk] = first <= last ? first : 0;
    cnt[kk] = first <= last ? last - first + 1 : 0;
    atomicMax(width, cnt[kk]);
  }
  cluster.sync();  // every block's width is in (and every block has started)
  int W = 0;
  for (int r = 0; r < C; ++r) W = max(W, *cluster.map_shared_rank(width, r));
  const bool packed = (size_t)W * Db <= (size_t)p.lt_cap;
  const int RP = packed ? L.rp_packed : L.rp_stream;
  if (packed) {
    for (int kk = tid; kk < Db; kk += NT)
      for (int e = 0; e < cnt[kk]; ++e)
        ltr[(size_t)e * Db + kk] = fmaxf(g[(size_t)(lo[kk] + e) * S + d0 + kk], kNegInf);
  } else if (RP > S) {
    for (int i = tid; i < 2 * G * (RP - S); i += NT) rows[(size_t)(i / (RP - S)) * RP + S + i % (RP - S)] = -INFINITY;
  }
  cluster.sync();  // the peers have read this block's width; the transitions are in

  auto frame_of = [&](int s) { return KIND == kBackwardKind ? tg - 1 - s : s; };
  auto lb_addr = [&](int t, int u, int k) {
    return layout == 0 ? p.log_b + ((size_t)t * S + k) * B + b0 + u : p.log_b + ((size_t)(b0 + u) * T + t) * S + k;
  };
  // step s's log b into ring slot s % kGroupRing (one commit group a step, empty past the last)
  auto issue_lb = [&](int s) {
    if (s < n_steps) {
      const int t = frame_of(s);
      for (int i = 0; i < PO; ++i) {
        const int q = tid + i * NT;
        if (q >= GD) break;
        int u, kk;
        owner_pair(q, G, Db, ufast, u, kk);
        const bool ok = b0 + u < B && d0 + kk < S;
        cp_async4(ring + ((size_t)(s % kGroupRing) * PO + i) * NT + tid, ok ? lb_addr(t, u, d0 + kk) : p.log_b, ok);
      }
    }
    cp_async_commit();
  };
  // the streamed route's tiles: sources [j KT, j KT + KT) x the block's keys into slot j % kGroupStages
  const int n_tiles = (S + KT - 1) / KT;
  auto issue_tile = [&](int j) {
    float* st = ltr + (size_t)(j % kGroupStages) * KT * Db;
    const int i0 = j * KT;
    if (p.vec) {
      const int per = Db / 4;
      for (int c = tid; c < KT * per; c += NT) {
        const int r = c / per, q = c - r * per;
        const bool ok = i0 + r < S && d0 + 4 * q < S;
        cp_async16(st + (size_t)r * Db + 4 * q, ok ? g + (size_t)(i0 + r) * S + d0 + 4 * q : g, ok);
      }
    } else {
      for (int c = tid; c < KT * Db; c += NT) {
        const int r = c / Db, q = c - r * Db;
        const bool ok = i0 + r < S && d0 + q < S;
        cp_async4(st + c, ok ? g + (size_t)(i0 + r) * S + d0 + q : g, ok);
      }
    }
    cp_async_commit();
  };
  // this thread's register tile: utterances ut UT .., keys 4 kg .., the share ks of each tile
  const int kgs = Db / 4, units = (G / UT) * kgs;
  const bool unit = tid < units * KS;
  const int kg = tid % kgs, ut = (tid / kgs) % (G / UT), ks = tid / units;

  for (int s = 0; s + 1 < kGroupRing; ++s) issue_lb(s);

  for (int s = 0; s < n_steps; ++s) {
    issue_lb(s + kGroupRing - 1);
    const int t = frame_of(s);
    const float* x = rows + (size_t)((s + 1) & 1) * G * RP;  // the row step s - 1 wrote
    float* xn = rows + (size_t)(s & 1) * G * RP;
    if constexpr (KIND == kViterbiKind) {
      if (s >= 1 && !packed) {
        // the register tile's (best, source) over the share's sources of
        // every tile, ascending, by a strict >
        float best[UT][4];
        int arg[UT][4];
#pragma unroll
        for (int a = 0; a < UT; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) best[a][c] = -INFINITY, arg[a][c] = 0;
        for (int j = 0; j + 1 < kGroupStages && j < n_tiles; ++j) issue_tile(j);
        for (int j = 0; j < n_tiles; ++j) {
          if (j + 1 < n_tiles) {
            cp_async_wait<kGroupStages - 2>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();  // tile j is in; tile j - 1's slot is free
          if (j + kGroupStages - 1 < n_tiles) issue_tile(j + kGroupStages - 1);
          if (!unit) continue;
          for (int ch = 0; ch < SP; ch += kGroupChunk) {
            const int r0 = ks * SP + ch, i0 = j * KT + r0;  // the chunk's first source in the tile and in the row
            const float* st = ltr + (size_t)(j % kGroupStages) * KT * Db + (size_t)r0 * Db + 4 * kg;
            float4 a[kGroupChunk];
#pragma unroll
            for (int q = 0; q < kGroupChunk; ++q) {
              const float4 w = *reinterpret_cast<const float4*>(st + (size_t)q * Db);
              a[q] = make_float4(fmaxf(w.x, kNegInf), fmaxf(w.y, kNegInf), fmaxf(w.z, kNegInf), fmaxf(w.w, kNegInf));
            }
            float xs[UT][kGroupChunk];
#pragma unroll
            for (int uu = 0; uu < UT; ++uu) {
              const float* xr = x + (size_t)(ut * UT + uu) * RP + i0;
              const float4 x0 = *reinterpret_cast<const float4*>(xr), x1 = *reinterpret_cast<const float4*>(xr + 4);
              xs[uu][0] = x0.x, xs[uu][1] = x0.y, xs[uu][2] = x0.z, xs[uu][3] = x0.w;
              xs[uu][4] = x1.x, xs[uu][5] = x1.y, xs[uu][6] = x1.z, xs[uu][7] = x1.w;
            }
#pragma unroll
            for (int q = 0; q < kGroupChunk; ++q)
#pragma unroll
              for (int uu = 0; uu < UT; ++uu)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const float v = xs[uu][q] + lane4(a[q], c);
                  const bool up = v > best[uu][c];
                  best[uu][c] = up ? v : best[uu][c];
                  arg[uu][c] = up ? i0 + q : arg[uu][c];
                }
          }
        }
        if (unit) {
          int* part_src = reinterpret_cast<int*>(part) + (size_t)KS * GD;
#pragma unroll
          for (int uu = 0; uu < UT; ++uu)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int q = (ut * UT + uu) * Db + 4 * kg + c;
              part[(size_t)ks * GD + q] = best[uu][c];
              part_src[(size_t)ks * GD + q] = arg[uu][c];
            }
        }
        __syncthreads();  // the partial pairs are in
      } else {
        cp_async_wait<kGroupRing - 1>();  // this thread's log b of step s
      }
    } else if (s >= 1 && !packed) {
      float m[UT][4], acc[UT][4];
#pragma unroll
      for (int a = 0; a < UT; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) m[a][c] = kNegInf, acc[a][c] = 0.f;
      for (int j = 0; j + 1 < kGroupStages && j < n_tiles; ++j) issue_tile(j);
      for (int j = 0; j < n_tiles; ++j) {
        if (j + 1 < n_tiles) {
          cp_async_wait<kGroupStages - 2>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // tile j is in for every thread; tile j - 1's slot is free
        if (j + kGroupStages - 1 < n_tiles) issue_tile(j + kGroupStages - 1);
        if (!unit) continue;
        for (int ch = 0; ch < SP; ch += kGroupChunk) {
          const int r0 = ks * SP + ch;  // the chunk's first source in the tile
          const float* st = ltr + (size_t)(j % kGroupStages) * KT * Db + (size_t)r0 * Db + 4 * kg;
          float4 a[kGroupChunk];
#pragma unroll
          for (int q = 0; q < kGroupChunk; ++q) a[q] = *reinterpret_cast<const float4*>(st + (size_t)q * Db);
          float xs[UT][kGroupChunk];
#pragma unroll
          for (int uu = 0; uu < UT; ++uu) {
            const float* xr = x + (size_t)(ut * UT + uu) * RP + j * KT + r0;
            const float4 x0 = *reinterpret_cast<const float4*>(xr), x1 = *reinterpret_cast<const float4*>(xr + 4);
            xs[uu][0] = x0.x, xs[uu][1] = x0.y, xs[uu][2] = x0.z, xs[uu][3] = x0.w;
            xs[uu][4] = x1.x, xs[uu][5] = x1.y, xs[uu][6] = x1.z, xs[uu][7] = x1.w;
          }
          // the exponentials against each pair's reference m as straight-line
          // code; where a sum reaches kGroupLazy (a source above m by ~44
          // nats, or m still the floor) the chunk is taken again against its
          // max, the sum rescaled (one branch for the rare cases)
          float e[UT][4];
          bool again = false;
#pragma unroll
          for (int uu = 0; uu < UT; ++uu)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float mref = m[uu][c] * kLog2e;
              float sum = 0.f;
#pragma unroll
              for (int q = 0; q < kGroupChunk; ++q)
                sum += fast_exp2(fmaf(xs[uu][q] + lane4(a[q], c), kLog2e, -mref));
              e[uu][c] = sum;
              again |= !(sum < kGroupLazy);
            }
          if (again) {
#pragma unroll
            for (int uu = 0; uu < UT; ++uu)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (e[uu][c] < kGroupLazy) continue;
                float mx = -INFINITY;
#pragma unroll
                for (int q = 0; q < kGroupChunk; ++q) mx = fmaxf(mx, xs[uu][q] + lane4(a[q], c));
                if (mx > m[uu][c]) {  // the running max rises: rescale the sum
                  acc[uu][c] *= fast_exp2((m[uu][c] - mx) * kLog2e);
                  m[uu][c] = mx;
                }
                float sum = 0.f;
#pragma unroll
                for (int q = 0; q < kGroupChunk; ++q) sum += fast_exp2((xs[uu][q] + lane4(a[q], c) - m[uu][c]) * kLog2e);
                e[uu][c] = sum;
              }
          }
#pragma unroll
          for (int uu = 0; uu < UT; ++uu)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[uu][c] += e[uu][c];
        }
      }
      if (unit) {
#pragma unroll
        for (int uu = 0; uu < UT; ++uu)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int u = ut * UT + uu, kk = 4 * kg + c;
            const int q = ufast ? kk * G + u : u * Db + kk;
            part[(size_t)ks * GD + q] = m[uu][c];
            part[(size_t)(KS + ks) * GD + q] = acc[uu][c];
          }
      }
      __syncthreads();  // the partial pairs are in
    } else {
      cp_async_wait<kGroupRing - 1>();  // this thread's log b of step s
    }

    // ---- the owners: the new values, the output, the new row into every peer ----
    for (int i = 0; i < PO; ++i) {
      const int q = tid + i * NT;
      if (q >= GD) break;
      int u, kk;
      owner_pair(q, G, Db, ufast, u, kk);
      const int k = d0 + kk, b = b0 + u;
      if (k >= S) continue;
      const float lb = fmaxf(ring[((size_t)(s % kGroupRing) * PO + i) * NT + tid], kNegInf);
      const int len = glen[u];
      float v;
      int bp = k;  // the Viterbi's backpointer: the identity at frame 0 and past the length
      if (s == 0) {
        v = KIND != kBackwardKind ? (k == 0 ? 0.f : kNegInf) + lb : (k == S - 1 ? 0.f : kNegInf);
      } else if constexpr (KIND == kViterbiKind) {
        int arg;
        const float best = packed ? range_best(x + (size_t)u * RP, ltr + kk, Db, lo[kk], cnt[kk], S, arg)
                                  : share_best(part, GD, KS, q, arg);
        v = t < len ? fmaxf(best + lb, kNegInf) : carry[i * NT + tid];
        bp = t < len ? arg : k;
      } else {
        float2 ms;
        if (packed) {
          ms = range_lse(x + (size_t)u * RP + lo[kk], ltr + kk, Db, cnt[kk]);
        } else {
          float mx = kNegInf;
          for (int r = 0; r < KS; ++r) mx = fmaxf(mx, part[(size_t)r * GD + q]);
          float sum = 0.f;
          for (int r = 0; r < KS; ++r)
            sum += part[(size_t)(KS + r) * GD + q] * fast_exp2((part[(size_t)r * GD + q] - mx) * kLog2e);
          ms = make_float2(mx, sum);
        }
        if constexpr (KIND == kForwardKind) {
          v = t < len ? fmaxf(ms.x + logf(ms.y) + lb, kNegInf) : carry[i * NT + tid];
        } else {
          v = t + 1 < len ? fmaxf(ms.x + logf(ms.y), kNegInf) : (k == S - 1 ? 0.f : kNegInf);
        }
      }
      carry[i * NT + tid] = v;
      if (layout == 0 && b < B) p.out[((size_t)t * S + k) * B + b] = v;
      if (KIND == kViterbiKind && b < B) p.bptr[((size_t)b * T + t) * S + k] = bp;
      if (s + 1 < n_steps) {
        const float xv = KIND != kBackwardKind ? v : lb + v;
        float* dst = xn + (size_t)u * RP + k;
        if (C == 1) {
          *dst = xv;
        } else {
          for (int r = 0; r < C; ++r) *cluster.map_shared_rank(dst, r) = xv;
        }
      }
    }
    if (C == 1) {
      __syncthreads();  // one block: the new row is in, the old one read
    } else {
      cluster.sync();  // the new row is in every block; the old one is read
    }
  }

  // the rows past the group's longest member (the forward repeats its last
  // row, the backward keeps the initialization, the Viterbi's backpointers
  // are the identity), or the final carries
  for (int i = 0; i < PO; ++i) {
    const int q = tid + i * NT;
    if (q >= GD) break;
    int u, kk;
    owner_pair(q, G, Db, ufast, u, kk);
    const int k = d0 + kk, b = b0 + u;
    if (k >= S || b >= B) continue;
    if (layout == 1) {
      p.out[(size_t)b * S + k] = carry[i * NT + tid];
      if (KIND == kViterbiKind) {
        for (int t = tg; t < T; ++t) p.bptr[((size_t)b * T + t) * S + k] = k;
      }
      continue;
    }
    const float v = KIND == kForwardKind ? carry[i * NT + tid] : (k == S - 1 ? 0.f : kNegInf);
    for (int t = tg; t < T; ++t) p.out[((size_t)t * S + k) * B + b] = v;
  }
}

using GroupFn = void (*)(GroupParams);

// The instance for UT and NT threads: up to kGroupStreamThreads the one
// whose register budget keeps the streamed route's tiles in registers (the
// shapes of clusters past one block), past them up to kGroupMaxThreads (one
// block a group, the packed route: a thread owns fewer pairs).
template <int KIND>
GroupFn group_kernel_for(int UT, int NT) {
  if (NT > kGroupStreamThreads) {
    return UT == 2 ? lattice_group_kernel<KIND, 2, kGroupMaxThreads> : lattice_group_kernel<KIND, 1, kGroupMaxThreads>;
  }
  return UT == 2 ? lattice_group_kernel<KIND, 2, kGroupStreamThreads>
                 : lattice_group_kernel<KIND, 1, kGroupStreamThreads>;
}

// The register tile's utterances: 2 where G is even, else 1.
inline int group_utt_tile(int G) { return G % 2 == 0 ? 2 : 1; }

// The checked launch shape of the group mode (ops/kernels/lattice.py
// group_block): the kernel, its shared memory and threads; false where the
// shape is not one the kernel takes.
bool group_shape(int kind, const GroupParams& p, GroupFn& fn, size_t& smem) {
  const int S = p.S, G = p.G, C = p.C, KS = p.KS;
  if (p.T < 1 || S <= kMaxStates || S > kMaxBlockStates || p.B < 1 || G < 1 || (p.per_row && G != 1) ||
      (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) || KS < 1 || KS > 64 || (KS & (KS - 1)) != 0 ||
      p.SP < kGroupChunk || p.SP > 64 || p.SP % kGroupChunk != 0) {
    return false;
  }
  const GroupLayout L = group_layout(S, G, C, p.NT, KS, p.SP);
  const int UT = group_utt_tile(G), units = (G / UT) * (L.Db / 4);
  smem = sizeof(float) * group_floats(L, p.lt_cap);
  fn = kind == kForwardKind    ? group_kernel_for<kForwardKind>(UT, p.NT)
       : kind == kBackwardKind ? group_kernel_for<kBackwardKind>(UT, p.NT)
                               : group_kernel_for<kViterbiKind>(UT, p.NT);
  return (C - 1) * L.Db < S && p.NT % 32 == 0 && units * KS <= p.NT && p.NT <= kGroupMaxThreads &&
         L.PO <= kGroupMaxOwned && p.lt_cap % 4 == 0 && (size_t)p.lt_cap >= L.tiles && smem <= kSmemLimit;
}

// The group mode's launch: ceil(B / G) clusters of C blocks (a non-portable
// cluster size past 8); 0 or a CUDA error code.
int launch_group(int kind, const GroupParams& p, int device, void* stream) {
  GroupFn fn;
  size_t smem;
  if (!group_shape(kind, p, fn, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (p.C > 8) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((p.B + p.G - 1) / p.G * p.C));
  cfg.blockDim = dim3((unsigned)p.NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Checks the launch shape (ops/kernels/lattice.py forward_block /
// backward_block / viterbi_block) and launches fn on (B + U - 1) / U blocks
// of `threads` threads; 0 or a CUDA error code.
int launch_lanes(KernelFn fn, int threads, const Params& p, size_t floats, bool vec_ok, int device, void* stream) {
  const int S = p.S;
  if (p.T < 1 || S < 1 || S > kMaxStates || p.B < 1 || p.TT < 1 || p.G != (S > 32 ? 1 : 32 / S) ||
      p.U != p.G * kFwdRecWarps || (p.vec && !vec_ok) || sizeof(float) * floats > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<(p.B + p.U - 1) / p.U, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

}  // namespace

extern "C" {

// Every launcher runs on `stream` and returns cudaGetLastError() (0 = ok).
// Pointers are device pointers; lengths int32 (B,), lt float32 (S, S) or,
// for the forward with per_row, (B, S, S).  G utterances a warp, U = 4 G a
// block and TT frames a tile from ops/kernels/lattice.py forward_block /
// backward_block / viterbi_block (up to kMaxStates states).  Past
// kMaxStates the forward and backward take srhmm_lattice_group, the Viterbi
// the same group mode through srhmm_viterbi.

// The forward kernel, up to kMaxStates states.  layout 0: log b (T, S, B)
// contiguous, out the (T, S, B) lattice; layout 1: log b (B, T, S)
// contiguous, out the final carries (B, S).  vec: 16-byte copies (U and
// B, or T S and TT S, multiples of 4, log b and out 16-byte aligned).
int srhmm_lattice_forward(const void* log_b, const void* lt, int per_row, const void* lengths, void* out,
                          int layout, int T, int S, int B, int G, int U, int TT, int vec, int device, void* stream) {
  if (layout != 0 && layout != 1) return (int)cudaErrorInvalidValue;
  const bool vec_ok = aligned16(log_b, out) && (layout ? (T * S % 4 == 0 && TT * S % 4 == 0) : (U % 4 == 0 && B % 4 == 0));
  const Params p{static_cast<const float*>(log_b), static_cast<const float*>(lt), static_cast<const int*>(lengths),
                 static_cast<float*>(out), per_row, layout, T, S, B, G, U, TT, vec, nullptr};
  if (S < 1 || S > kMaxStates || (p.vec && !vec_ok)) return (int)cudaErrorInvalidValue;
  return launch_lanes(forward_kernel_for(S), kFwdThreads, p, forward_floats(S, U, TT, layout, per_row), vec_ok, device, stream);
}

// The backward kernel, up to kMaxStates states: log b (T, S, B)
// contiguous, out the (T, S, B) lattice; vec: 16-byte copies and stores (U
// and B multiples of 4, log b and out 16-byte aligned).
int srhmm_lattice_backward(const void* log_b, const void* lt, const void* lengths, void* out, int T, int S, int B,
                           int G, int U, int TT, int vec, int device, void* stream) {
  const bool vec_ok = aligned16(log_b, out) && U % 4 == 0 && B % 4 == 0;
  const Params p{static_cast<const float*>(log_b), static_cast<const float*>(lt), static_cast<const int*>(lengths),
                 static_cast<float*>(out), 0, 0, T, S, B, G, U, TT, vec, nullptr};
  if (S < 1 || S > kMaxStates || (p.vec && !vec_ok)) return (int)cudaErrorInvalidValue;
  return launch_lanes(backward_kernel_for(S), kFwdThreads, p, forward_floats(S, U, TT, 0, 0), vec_ok, device, stream);
}

// The forward (kind 0: layout 0 the (T, S, B) lattice, layout 1 the final
// carries of (B, T, S) log b, per_row transitions (B, S, S) with G = 1) or
// the backward (kind 1: the (T, S, B) lattice; lt the transposed matrix,
// lt[j S + i] = log a(i -> j)) past kMaxStates, the group mode: G
// utterances a cluster of C blocks of NT threads, KS source shares of SP a
// tile, lt_cap floats of transitions (ops/kernels/lattice.py group_block).
int srhmm_lattice_group(int kind, const void* log_b, const void* lt, int per_row, const void* lengths, void* out,
                        int layout, int T, int S, int B, int G, int C, int NT, int KS, int SP, int lt_cap,
                        int device, void* stream) {
  if ((kind != kForwardKind && kind != kBackwardKind) || (layout != 0 && layout != 1) ||
      (kind == kBackwardKind && (layout != 0 || per_row))) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(lt) % 16 == 0;
  const GroupParams p{static_cast<const float*>(log_b), static_cast<const float*>(lt), static_cast<const int*>(lengths),
                      static_cast<float*>(out), nullptr, per_row, layout, T, S, B, G, C, NT, KS, SP, lt_cap, vec};
  return launch_group(kind, p, device, stream);
}

// Clusters of the group mode's shape (kind 0 the forward, 1 the backward,
// 2 the Viterbi) that the card runs at once (cudaOccupancyMaxActiveClusters)
// into *clusters; 0 or a CUDA error code.
int srhmm_lattice_group_clusters(int kind, int S, int B, int G, int C, int NT, int KS, int SP, int lt_cap, int device,
                                 int* clusters) {
  if (kind != kForwardKind && kind != kBackwardKind && kind != kViterbiKind) return (int)cudaErrorInvalidValue;
  const GroupParams p{nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 1, S, B, G, C, NT, KS, SP, lt_cap, 0};
  GroupFn fn;
  size_t smem;
  if (!group_shape(kind, p, fn, smem)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((B + G - 1) / G * C));
  cfg.blockDim = dim3((unsigned)NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(fn), &cfg);
}

// The Viterbi: log b (B, T, S) contiguous, scores (B, S), bptr int32 (B,
// T, S).  Up to kMaxStates states the lane kernel: G, U, TT and vec (16-byte
// copies and stores: T S and TT S multiples of 4, log b and bptr 16-byte
// aligned), C, NT, KS, SP and lt_cap 0.  Past them, up to kMaxBlockStates,
// the group mode's kViterbiKind: G utterances a cluster of C blocks of NT
// threads, KS source shares of SP a tile, lt_cap floats of transitions
// (ops/kernels/lattice.py viterbi_block), U, TT and vec 0.
int srhmm_viterbi(const void* log_b, const void* lt, const void* lengths, void* scores, void* bptr, int T, int S,
                  int B, int G, int U, int TT, int vec, int C, int NT, int KS, int SP, int lt_cap, int device,
                  void* stream) {
  if (S < 1 || S > kMaxBlockStates) return (int)cudaErrorInvalidValue;
  if (S > kMaxStates) {
    if (U != 0 || TT != 0 || vec != 0) return (int)cudaErrorInvalidValue;
    const int lt_vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(lt) % 16 == 0;
    const GroupParams p{static_cast<const float*>(log_b), static_cast<const float*>(lt),
                        static_cast<const int*>(lengths), static_cast<float*>(scores), static_cast<int*>(bptr),
                        0, 1, T, S, B, G, C, NT, KS, SP, lt_cap, lt_vec};
    return launch_group(kViterbiKind, p, device, stream);
  }
  const bool vec_ok = aligned16(log_b, bptr) && T * S % 4 == 0 && TT * S % 4 == 0;
  const Params p{static_cast<const float*>(log_b), static_cast<const float*>(lt), static_cast<const int*>(lengths),
                 static_cast<float*>(scores), 0, 1, T, S, B, G, U, TT, vec, static_cast<int*>(bptr)};
  if (C != 0 || NT != 0 || KS != 0 || SP != 0 || lt_cap != 0 || (p.vec && !vec_ok)) return (int)cudaErrorInvalidValue;
  return launch_lanes(viterbi_kernel_for(S), kVitThreads, p, viterbi_floats(S, U, TT), vec_ok, device, stream);
}

}  // extern "C"
