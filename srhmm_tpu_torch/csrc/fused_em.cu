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
// kernel, one launch per pass, and each block splits a pass between kinds
// of warp one tile of frames apart, so that only the recursion's own step
// is on its serial chain.  K1 (see emit_forward_kernel): emission warps
// compute a tile's log_b (two columns a thread, two mixtures side by side)
// while recursion warps run the previous tile (a lane a (state,
// utterance), the band's sources by warp shuffles, a branch-free
// log-sum-exp unrolled to 2, 4 or 8 slots) and memory warps stage the
// features of the tile after by cp.async and write the tile before out.
// K2 stages tiles of TT frames (log-alpha, log_b[t+1], the features) into
// shared memory by cp.async a tile ahead,
// so its frame loop reads no device memory, and splits each tile's work
// between two kinds of thread one tile apart (see backward_stats_kernel):
// the recursion, one thread per (state, utterance) exchanging one value
// through a double-buffered shared-memory row (gamma into shared memory;
// xi, den_trans, den_mix in registers, summed in time order) and, on
// statistics warps in parallel over the tile's (frame, utterance) columns
// whose gamma are not all 0.0f, the emission (fp32 FMAs in emission.cuh's
// order, never TF32) and posteriors, and the moment contraction W (S M x
// columns) . [y; y^2 or vec(y y^T); 1] on the tensor cores in 3xTF32
// (tile_mma.cuh).  No atomics: each block sums its columns in a fixed
// order into its own partial, and the caller sums the partials over
// blocks, so two runs of an E-step are bitwise equal.
//
// What bounds it on the H100.  Parallelism: B * S (state, utterance)
// chains (16 k at the B=2048, S=8 EM headline), each a serial recursion
// over T frames, so the chain's latency a frame sets K1's floor and K2's,
// not the FMA rate or the bandwidth; K1's emission warps (15 a block at
// em_diag) and K2's statistics warps (12) keep pace beside it.  K1 writes
// 2 T S B floats (65 MB at the headline) and K2 reads them back once, well
// under a millisecond of HBM time.  Later work: CUDA-graph capture of
// whole EM iterations.
//
// Full covariance past D = 16 is bound instead by the z = L^T x FMAs, D^2 / 2
// a mixture and column (em_full39: 24 mixtures of D = 39 at 2048 x 256
// columns), which a column a thread ran as serial chains with a load per
// 4 FMAs, and K2 computed twice and contracted over the full D^2 square
// with its accumulators in device memory.  There each wrapper launches a
// z-GEMM block of csrc/wide_gemm.cuh beside its recursion:
// em_emission_wide_kernel writes log_b (and, where the caller stores it,
// every mixture's q) before K1's recursion, which then reads log_b; K2's
// recursion writes gamma out, and em_moments_wide_kernel contracts the
// columns whose gamma are not all 0.0f over the lower triangle of x x^T,
// its accumulators in registers for a whole range of utterances, from the
// stored q or from its own z-GEMM.  Two launches a pass keep the time loop
// inside the recursion kernels.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"
#include "tile_mma.cuh"
#include "wide_gemm.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxStates = 256;  // S, and S * U of a block at most
constexpr int kXiRegs = 8;        // backward-stats xi slots a thread keeps in registers
constexpr int kMaxBackwardThreads = 512;  // recursion threads (<= 256) + statistics warps
constexpr int kEmitThreads = 672;  // emit-forward: recursion + emission + memory warps
// emit-forward: the feature columns an emission thread takes side by side
// (their x in registers)
template <int DMAX>
constexpr int kEmitCols = DMAX <= 16 ? 2 : 1;

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
  int TT;               // frames a staged tile
  int rec_warps, em_warps;  // K1: recursion and emission warps (the rest of the block stores)
  int consts_global;    // K1: the constants read from device memory, not shared memory
  int stat_warps;       // K2: statistics warps a block
  int acc_global;       // K2: the moment accumulators in the block's row of mom, not shared memory
  int sum_dims, max_dim;  // sum_p D_p, max_p D_p
  int wide;             // full covariance past D = 16: K1 reads log_b (em_emission_wide_kernel wrote it), K2 writes
                        // gamma and em_moments_wide_kernel takes the moments; neither stages features
  float* gamma;         // (T, S, B) (K2, wide)
  int ranges;           // utterance ranges of the moments, one partial row each (K2, wide)
  float* qbuf[kMaxStreams];  // per stream (T, M_p S, B), rows m S + s, or null (wide): the per-mixture q that
                             // em_emission_wide_kernel writes and em_moments_wide_kernel reads in place of its own
};

// Transition slots: a banded model has band+1 (slot k = diagonal k), a
// dense one S (slot k = state k).  Source of destination j at slot k, and
// destination of source i at slot k; -1 / >= S when outside the model.
__device__ __forceinline__ int slot_src(bool banded, int j, int k) { return banded ? j - k : k; }
__device__ __forceinline__ int slot_dst(bool banded, int i, int k) { return banded ? i + k : k; }

__device__ __forceinline__ void stage_constants(const EmParams& p, float4* smem4, int tid, int nt) {
  const float4* src = reinterpret_cast<const float4*>(p.consts);
  for (int i = tid; i < p.C / 4; i += nt) smem4[i] = src[i];
}

// Shared memory of one emit-forward block, in floats (the wrapper's
// ops/kernels/fused_em.py emit_smem_bytes mirrors it): the constants C
// (unless consts_global: then they are read from device memory) | the
// features, two slots of (TT, sum_p D_p, U) (none when wide) | log_b, two
// slots of (TT, S, U) | log-alpha, two slots of (TT, S, U); slot k & 1
// holds tile k.
__host__ __device__ inline size_t emit_floats(const EmParams& p) {
  return (p.consts_global ? 0 : (size_t)p.C) + 2 * (size_t)p.TT * p.U * ((p.wide ? 0 : p.sum_dims) + 2 * p.S);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Three kinds of warp, one tile of TT frames apart; the block walks the
// tiles up in time and one barrier closes each step (two more open the
// first):
// * emission warps (p.em_warps) compute log_b of tile k+1 while the
//   recursion runs tile k: a warp takes one state and 32 NC of the tile's
//   columns (frame, utterance), a thread NC = kEmitCols of them side by side
//   (their features in registers, each record read once for the NC: the
//   records broadcast across the warp); each stream's features from the
//   tile the memory warps staged a step earlier, the state's mixture
//   logsumexp by emission.cuh's state_log_b_cols (fp32 FMAs in its order,
//   two mixtures of the NC columns side by side), summed over the
//   streams and clamped at NEG_INF; log_b goes to the tile for the
//   recursion and out to device memory (runs of U floats along B), for
//   every frame < T;
// * recursion warps (p.rec_warps) run tile k: lane l holds (state s,
//   utterance u): 32 / S utterances of S consecutive lanes a warp for S <=
//   32, else W = ceil(S / 32) warps an utterance with state 32 w + l.  The
//   sources s - kk of a band step (NSL > 0 slots, unrolled) come from the
//   lanes below by __shfl_up_sync; a source in the previous warp of the
//   utterance from the log-alpha tile after a named barrier of the
//   recursion warps (W > 1 only).  A slot off the chain (s - kk < 0, or
//   kk > band) enters the max as -inf and the sum as expf(-inf) = 0.0f,
//   which change no bit of a sum that skips it.  Dense transitions and
//   bands past the compiled slot counts (NSL = 0) take every source from
//   the tile after a barrier of the recursion warps each frame, in the
//   slot order of the one-thread-a-state loop.  Frame 0 starts in state 0
//   and always sets the carry, even for a zero-length row; frames t >=
//   length repeat the carry; log-alpha goes to the tile;
// * memory warps stage tile k+2's features by 16-byte cp.async and write
//   log-alpha of tile k-1 out, runs of U floats along B.
// Nothing but the band step and the tile's log_b read is on the serial
// chain: log_b and log-alpha are bitwise those of one thread per (state,
// utterance) computing its emission and step in that order.  Full
// covariance past D = 16 (kWide): em_emission_wide_kernel has written log_b
// before this launch, the emission warps copy each tile of it from device
// memory, and no features are staged.
template <int DMAX, bool FULL, int NSL>
__global__ void __launch_bounds__(kEmitThreads) emit_forward_kernel(const EmParams p) {
  constexpr bool kWide = FULL && DMAX > 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, TT = p.TT, T = p.T, tid = threadIdx.x;
  const int n_rec = 32 * p.rec_warps, n_em = 32 * p.em_warps;
  const int b0 = blockIdx.x * U;
  if (!p.consts_global) stage_constants(p, smem4, tid, blockDim.x);
  const float* cst = p.consts_global ? p.consts : smem;
  const size_t x_tile = kWide ? 0 : (size_t)TT * p.sum_dims * U, s_tile = (size_t)TT * S * U;
  float* xs = smem + (p.consts_global ? 0 : p.C);  // features
  float* lbs = xs + 2 * x_tile;                    // log_b
  float* las = lbs + 2 * s_tile;                   // log-alpha
  const int n_tiles = (T + TT - 1) / TT;
  __syncthreads();

  // the features of tile k into slot k & 1 (the memory warps' copies)
  auto stage = [&](int k) {
    if constexpr (!kWide) {
      const int t0 = k * TT;
      float* f = xs + (k & 1) * x_tile;
      for (int q = 0; q < p.n_streams; ++q) {
        stage_rows_async(f, p.dims[q] * U, U, p.feats[q], t0, min(TT, T - t0), p.dims[q], T, p.B, b0, U, n_rec + n_em,
                         blockDim.x - n_rec - n_em);
        f += (size_t)TT * p.dims[q] * U;
      }
    }
    cp_async_commit();
  };

  if (tid >= n_rec + n_em) {
    // ---- the memory warps ----
    const int i = tid - n_rec - n_em, n_mem = blockDim.x - n_rec - n_em;
    stage(0);
    if (n_tiles > 1) {
      stage(1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile 0's features are in
    cp_async_wait<0>();
    __syncthreads();  // tile 0's log_b and tile 1's features are in
    for (int k = 0; k < n_tiles; ++k) {
      // tile k+2 goes into the slot of tile k, read last step
      if (k + 2 < n_tiles) stage(k + 2);
      if (k >= 1) store_rows_from_tile(p.la, las + ((k - 1) & 1) * s_tile, S * U, (k - 1) * TT, TT, S, p.B, b0, U, i, n_mem);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int k = n_tiles - 1;
    store_rows_from_tile(p.la, las + (k & 1) * s_tile, S * U, k * TT, T - k * TT, S, p.B, b0, U, i, n_mem);
    return;
  }

  if (tid >= n_rec) {
    // ---- the emission warps ----
    const int e = tid - n_rec;
    // a warp task: one state's columns g 32 NC + lane + 32 j (j < NC) of
    // tile k, a thread its NC columns side by side
    constexpr int NC = kEmitCols<DMAX>;
    const int lane = e & 31, lg_u = 31 - __clz(U);  // U is a power of 2
    auto emit_tile = [&](int k) {
      const int t0 = k * TT, n = min(TT, T - t0), ncol = n * U;
      if constexpr (kWide) {
        // the tile's log_b from device memory: a thread a (state, column), runs of U floats along B
        float* lbt = lbs + (k & 1) * s_tile;
        for (int i = e; i < S * ncol; i += n_em) {
          const int s = i / ncol, c = i - s * ncol, tt = c >> lg_u, u = c & (U - 1);
          lbt[((size_t)tt * S + s) * U + u] = (b0 + u < p.B) ? p.log_b[((size_t)(t0 + tt) * S + s) * p.B + b0 + u] : 0.f;
        }
      } else {
        const int groups = (ncol + 32 * NC - 1) / (32 * NC);
        const float* f = xs + (k & 1) * x_tile;
        float* lbt = lbs + (k & 1) * s_tile;
        // task w + r n_w of the warp is (state s, group g), stepped without a division
        int s = 0, g = e >> 5;
        while (g >= groups) g -= groups, ++s;
        for (; s < S; g += n_em >> 5) {
          while (g >= groups && s < S) g -= groups, ++s;
          if (s >= S) break;
          const int c0 = g * 32 * NC + lane;
          int tt[NC], u[NC];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            const int c = min(c0 + 32 * j, ncol - 1);  // a column past the tile repeats the last, not stored
            tt[j] = c >> lg_u;
            u[j] = c & (U - 1);
          }
          float lb[NC];
          const float* fq = f;
          for (int q = 0; q < p.n_streams; ++q) {
            const int D = p.dims[q], M = p.mixes[q];
            const float* o = cst + p.origin_offs[q];
            float x[NC][DMAX];
#pragma unroll
            for (int j = 0; j < NC; ++j)
#pragma unroll
              for (int d = 0; d < DMAX; ++d) x[j][d] = (d < D) ? fq[(tt[j] * D + d) * U + u[j]] - o[d] : 0.f;
            const float* rec = cst + p.offs[q] + s * M * record_stride<DMAX, FULL>(D);
            float v[NC];
            state_log_b_cols<DMAX, FULL, NC>(rec, M, D, x, v);
#pragma unroll
            for (int j = 0; j < NC; ++j) lb[j] = (q == 0) ? v[j] : lb[j] + v[j];
            fq += (size_t)TT * D * U;
          }
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            if (c0 + 32 * j >= ncol) continue;
            const float l = fmaxf(lb[j], kNegInf);
            lbt[((size_t)tt[j] * S + s) * U + u[j]] = l;
            if (b0 + u[j] < p.B) p.log_b[((size_t)(t0 + tt[j]) * S + s) * p.B + b0 + u[j]] = l;
          }
        }
      }
    };
    __syncthreads();  // tile 0's features are in
    emit_tile(0);
    __syncthreads();
    for (int k = 0; k < n_tiles; ++k) {
      if (k + 1 < n_tiles) emit_tile(k + 1);
      __syncthreads();
    }
    return;
  }

  // ---- the recursion warps ----
  const int lane = tid & 31, wid = tid >> 5, W = (S + 31) >> 5;
  int u, s;
  bool th;  // the lane holds a (state, utterance) of the block
  if (S <= 32) {
    const int G = 32 / S, ul = lane / S;
    u = wid * G + ul;
    s = lane - ul * S;
    th = ul < G && u < U;
  } else {
    u = wid / W;
    s = (wid - u * W) * 32 + lane;
    th = s < S && u < U;
  }
  const int uc = min(u, U - 1), sc = min(s, S - 1);  // where a lane without one reads
  const int b = b0 + u;
  const bool live = th && b < p.B;
  const int len = live ? p.lengths[b] : 0;
  const float* lt = cst + p.lt_off;
  const bool banded = p.band >= 0;
  const int nslots = banded ? p.band + 1 : S;
  // slot kk: source s - kk and its log transition, in registers
  float lt_in[NSL > 0 ? NSL : 1];
  unsigned ok = 0;
#pragma unroll
  for (int kk = 0; kk < NSL; ++kk) {
    const bool on = th && kk < nslots && s - kk >= 0;
    lt_in[kk] = on ? lt[(s - kk) * S + s] : 0.f;
    ok |= on ? 1u << kk : 0u;
  }
  __syncthreads();  // tile 0's features are in
  __syncthreads();  // tile 0's log_b is in
  float carry = kNegInf;
  for (int k = 0; k < n_tiles; ++k) {
    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);
    const float* lbt = lbs + (k & 1) * s_tile;
    float* lat = las + (k & 1) * s_tile;
    const int off = sc * U + uc;
    float lbn = lbt[off];
    for (int t = t_lo; t < t_hi; ++t) {
      const int tt = t - t_lo;
      const float lb = lbn;
      if (t + 1 < t_hi) lbn = lbt[(size_t)(tt + 1) * S * U + off];
      // log-alpha of frame t-1, (S, U): this tile's row tt-1 or the last row of the previous tile
      const float* prev = (tt > 0) ? lat + (size_t)(tt - 1) * S * U : las + ((k + 1) & 1) * s_tile + (size_t)(TT - 1) * S * U;
      if constexpr (NSL > 0) {
        float v[NSL];
        v[0] = (ok & 1u) ? carry + lt_in[0] : -INFINITY;
#pragma unroll
        for (int kk = 1; kk < NSL; ++kk) {
          float x = __shfl_up_sync(~0u, carry, kk);
          if (W > 1 && lane < kk && s - kk >= 0) x = prev[(s - kk) * U + uc];
          v[kk] = (ok >> kk & 1u) ? x + lt_in[kk] : -INFINITY;
        }
        const float next = fmaxf(slots_lse<NSL>(v) + lb, kNegInf);
        carry = (t == 0) ? fmaxf((s == 0 ? 0.f : kNegInf) + lb, kNegInf) : (t < len ? next : carry);
      } else {
        if (t == 0) {
          carry = fmaxf((s == 0 ? 0.f : kNegInf) + lb, kNegInf);
        } else if (t < len) {
          float m = kNegInf;
          for (int kk = 0; kk < nslots; ++kk) {
            const int i = slot_src(banded, s, kk);
            if (i >= 0) m = fmaxf(m, prev[i * U + u] + lt[i * S + s]);
          }
          float e = 0.f;
          for (int kk = 0; kk < nslots; ++kk) {
            const int i = slot_src(banded, s, kk);
            if (i >= 0) e += expf(prev[i * U + u] + lt[i * S + s] - m);
          }
          const float upd = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
          carry = fmaxf(upd + lb, kNegInf);
        }
      }
      if (th) lat[(size_t)tt * S * U + s * U + u] = carry;
      if (NSL == 0 || W > 1) named_barrier(1, n_rec);  // frame t's log-alpha, for the next frame's sources
    }
    __syncthreads();
  }
}

// Shared memory of one backward-stats block, in floats then ints (the
// wrapper's ops/kernels/fused_em.py backward_smem_bytes mirrors it):
//   constants C (unless consts_global: then they are read from device
//   memory, as full-covariance records past D = 16 need) | a ring of three tiles of TT frames, each log-alpha
//   (TT, S, U), log_b of the next frames (TT, S, U) and every stream's
//   features (TT, D_p, U) | two gamma tiles (TT, S, U) | two exchange rows
//   (2, S U) | xi sums of the slots past kXiRegs (nslots - kXiRegs, S U) |
//   posterior weights (S max M, KS) | features (max D, KS) |
//   accumulators (S sum_p M_p (L_p + 1)), unless they are kept in the
//   block's own row of the moment partials (acc_global) | ints: the kept
//   columns (TT U) and the statistics warps' counts of them (stat_warps)
// with KS = TT U rounded up to 8, + 4 past 8 columns (the fragment loads
// then hit 32 banks).  A wide block (full covariance past D = 16) keeps the
// ring without features, the gamma tiles, the exchange rows and the xi
// sums, and nothing of the statistics.
__host__ __device__ inline int backward_ks(int TT, int U) {
  const int c = TT * U;
  return (c + 7) / 8 * 8 + (c > 8 ? 4 : 0);
}

__host__ __device__ inline size_t backward_floats(const EmParams& p, int TT) {
  const size_t nt = (size_t)p.S * p.U;
  const int nslots = p.band >= 0 ? p.band + 1 : p.S;
  const size_t ks = backward_ks(TT, p.U);
  const size_t recursion = (p.consts_global ? 0 : (size_t)p.C) + 3 * (size_t)TT * p.U * (2 * p.S + (p.wide ? 0 : p.sum_dims)) +
                           2 * (size_t)TT * nt + 2 * nt + (size_t)(nslots > kXiRegs ? nslots - kXiRegs : 0) * nt;
  if (p.wide) return recursion;
  return recursion + ((size_t)p.S * p.max_mix + p.max_dim) * ks + (p.acc_global ? 0 : (size_t)p.S * p.mom_thread);
}

__host__ __device__ inline size_t backward_ints(const EmParams& p, int TT) {
  return p.wide ? 0 : (size_t)TT * p.U + p.stat_warps;
}

// Two kinds of thread, one tile of TT frames apart (the block walks the
// tiles down in time; one barrier closes each step):
// * recursion threads, one per (state, utterance) (thread s * U + u, S U
//   rounded up to whole warps), run tile k and start the copies of tile
//   k+1 (cp.async), so no frame loop reads device memory: log-alpha,
//   log_b[t+1] and the xi sources la[t, i] come from the staged tile; the
//   band step goes through the double-buffered exchange row (a barrier of
//   the recursion threads a frame); the sources, destinations and log
//   transitions of the first NSL slots (NSL = 2 for a band of 0 or 1, else
//   kXiRegs) sit in registers, and a slot outside the model enters the max
//   as NEG_INF and the sum as 0.0f, which change no bit; xi, den_trans and
//   den_mix stay in registers (slots past NSL in shared columns), summed in
//   time order; gamma goes to the tile's gamma (TT, S, U);
// * statistics warps (p.stat_warps) run tile k-1: they list the columns
//   (frame, utterance) with a gamma that is not exactly 0.0f (ballots, in
//   column order; the others add nothing, x finite); a thread a (kept
//   column, state) computes the state's mixture log-likelihoods
//   (emission.cuh, fp32 FMAs in its order, two mixtures side by side), the
//   posteriors against the stream's own logsumexp and the weights
//   W[(m S + s), col] = gamma * post * 2^48; then the warps add W lift over
//   the kept columns into the accumulators (contract_3xtf32: mma.sync in
//   3xTF32, the states folded onto the rows since every state of a column
//   sees the same features).  The block's accumulators, scaled back by
//   2^-48, are its moment partial.
// Full covariance past D = 16 (kWide): the statistics warps write each
// gamma tile out to device memory instead, em_moments_wide_kernel takes the
// moments, and no features are staged.
template <int DMAX, bool FULL, int NSL>
__global__ void __launch_bounds__(kMaxBackwardThreads) backward_stats_kernel(const EmParams p) {
  constexpr bool kWide = FULL && DMAX > 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, nt = S * U, tid = threadIdx.x, TT = p.TT, T = p.T;
  const int n_rec = (nt + 31) / 32 * 32, n_stat = blockDim.x - n_rec;
  const bool stats = tid >= n_rec;
  const int ks = backward_ks(TT, U);
  const int b0 = blockIdx.x * U;
  const bool banded = p.band >= 0;
  const int nslots = banded ? p.band + 1 : S;
  if (!p.consts_global) stage_constants(p, smem4, tid, blockDim.x);
  const float* cst = p.consts_global ? p.consts : smem;
  const size_t frame_tile = (size_t)TT * U * (2 * S + (kWide ? 0 : p.sum_dims));  // floats of one tile
  float* ring = smem + (p.consts_global ? 0 : p.C);
  float* gam = ring + 3 * frame_tile;                  // two (TT, S, U) tiles
  float* inner_sh = gam + 2 * (size_t)TT * nt;         // two (S, U) rows: frame t writes row t & 1
  float* xi_sh = inner_sh + 2 * nt;                    // (nslots - NSL, S*U)
  float* w_sh = xi_sh + (size_t)(nslots > kXiRegs ? nslots - kXiRegs : 0) * nt;  // (S max M, ks)
  float* x_sh = w_sh + (size_t)S * p.max_mix * ks;     // (max D, ks)
  float* acc_sh = x_sh + (size_t)p.max_dim * ks;       // (S sum_p M_p (L_p + 1))
  // this block's moment partial: per stream an (M*S, L+1) block with row
  // m*S + s, each entry summed over the block's kept columns in order
  float* out = p.mom + (size_t)blockIdx.x * S * p.mom_thread;
  float* acc = p.acc_global ? out : acc_sh;
  int* cols = reinterpret_cast<int*>(acc_sh + (p.acc_global ? 0 : (size_t)S * p.mom_thread));
  int* warp_kept = cols + TT * U;  // (stat_warps) kept columns of each statistics warp
  const int n_tiles = (T + TT - 1) / TT;
  // tile k (ring slot k % 3) holds frames [max(T - (k+1) TT, 0), T - k TT):
  // their log-alpha and features, and log_b of the frames after them
  auto stage = [&](int k) {  // recursion threads only
    const int hi = T - k * TT, lo = max(hi - TT, 0), n = hi - lo, cnt = n_rec / U * U;
    float* buf = ring + (k % 3) * frame_tile;
    stage_rows_async(buf, nt, U, p.la, lo, n, S, T, p.B, b0, U, 0, cnt);
    stage_rows_async(buf + (size_t)TT * nt, nt, U, p.log_b, lo + 1, n, S, T, p.B, b0, U, 0, cnt);
    if constexpr (!kWide) {
      float* f = buf + 2 * (size_t)TT * nt;
      for (int q = 0; q < p.n_streams; ++q) {
        stage_rows_async(f, p.dims[q] * U, U, p.feats[q], lo, n, p.dims[q], T, p.B, b0, U, 0, cnt);
        f += (size_t)TT * p.dims[q] * U;
      }
    }
    cp_async_commit();
  };
  if (stats) {
    if constexpr (!kWide)
      for (int k = tid - n_rec; k < S * p.mom_thread; k += n_stat) acc[k] = 0.f;
  } else {
    for (int k = tid; k < (nslots - NSL) * nt; k += n_rec) xi_sh[k] = 0.f;
    stage(0);
    cp_async_wait<0>();
  }
  __syncthreads();

  if (!stats) {
    // ---- the recursion: tiles 0 .. n_tiles-1, one a step ----
    const int s = tid / U, u = tid - s * U;
    const bool th = tid < nt;  // a (state, utterance) thread
    const int b = b0 + u;
    const bool live = th && b < p.B;
    const float* lt = cst + p.lt_off;
    const int len = live ? p.lengths[b] : 0;
    const float z = live ? p.safe_z[b] : 0.f;
    const bool valid = live && p.vmask[b] > 0.f;
    const float beta_init = (s == S - 1) ? 0.f : kNegInf;
    float beta = beta_init;  // log-beta at t+1 until this frame's update
    float dt = 0.f, dm = 0.f;
    // the first NSL slots' sources i and destinations j of state s and
    // their log transitions, in registers (a slot outside the model: index
    // clamped, ok flag off)
    float xi[NSL], lt_in[NSL], lt_out[NSL];
    int src[NSL], dst[NSL];
    unsigned src_ok = 0, dst_ok = 0;
#pragma unroll
    for (int k2 = 0; k2 < NSL; ++k2) {
      xi[k2] = 0.f;
      const int i = slot_src(banded, s, k2), j = slot_dst(banded, s, k2);
      const bool in = th && k2 < nslots && i >= 0, out = th && k2 < nslots && j < S;
      src[k2] = in ? i : 0;
      dst[k2] = out ? j : 0;
      lt_in[k2] = in ? lt[i * S + s] : 0.f;
      lt_out[k2] = out ? lt[s * S + j] : 0.f;
      src_ok |= in ? 1u << k2 : 0u;
      dst_ok |= out ? 1u << k2 : 0u;
    }
    for (int k = 0; k <= n_tiles; ++k) {
      // tile k+1 goes into the slot of tile k-2, done with last step
      if (k + 1 < n_tiles) stage(k + 1);
      if (k < n_tiles) {
        const int t_hi = T - k * TT, t_lo = max(t_hi - TT, 0);
        const float* buf = ring + (k % 3) * frame_tile;
        float* g_tile = gam + (size_t)(k & 1) * TT * nt;
        for (int t = t_hi - 1; t >= t_lo; --t) {
          const int tt = t - t_lo;
          const float* la_row = buf + (size_t)tt * nt + u;  // la[t, i, b] = la_row[i * U]
          float inner = kNegInf, la_t = kNegInf;
          float la_src[NSL];
          if (th) {
            la_t = live ? la_row[s * U] : kNegInf;
            // log_b[t+1]: masked everywhere at t = T-1 (t < length-1 is impossible)
            const float lbn = (live && t + 1 < T) ? buf[(size_t)(TT + tt) * nt + tid] : kNegInf;
            inner = fmaxf(lbn + beta, kNegInf);
            inner_sh[(t & 1) * nt + tid] = inner;
#pragma unroll
            for (int k2 = 0; k2 < NSL; ++k2) la_src[k2] = la_row[src[k2] * U];
          }
          named_barrier(1, n_rec);
          if (!th) continue;
          const float* ib = inner_sh + (t & 1) * nt;
          const bool stepping = len - 1 > t;  // t < length-1; else the init row
          const bool m_xi = stepping && valid;
          // exact xi, destination j = s (off the recursion's chain)
          const float lnz = inner - z;
          if (m_xi) {
#pragma unroll
            for (int k2 = 0; k2 < NSL; ++k2)
              if (src_ok >> k2 & 1u) xi[k2] += expf(fminf(la_src[k2] + lt_in[k2] + lnz, 0.f));
            for (int k2 = NSL; k2 < nslots; ++k2) {
              const int i = slot_src(banded, s, k2);
              if (i >= 0) xi_sh[(k2 - NSL) * nt + tid] += expf(fminf(la_row[i * U] + lt[i * S + s] + lnz, 0.f));
            }
          }
          // backward step, source i = s; a slot outside the model is left
          // out: a NEG_INF term in the max and a 0.0f in the sum change no bit
          float nb[NSL];
#pragma unroll
          for (int k2 = 0; k2 < NSL; ++k2) nb[k2] = ib[dst[k2] * U + u];
          float m = kNegInf;
#pragma unroll
          for (int k2 = 0; k2 < NSL; ++k2) m = fmaxf(m, (dst_ok >> k2 & 1u) ? lt_out[k2] + nb[k2] : kNegInf);
          for (int k2 = NSL; k2 < nslots; ++k2) {
            const int j = slot_dst(banded, s, k2);
            if (j < S) m = fmaxf(m, lt[s * S + j] + ib[j * U + u]);
          }
          float e = 0.f;
#pragma unroll
          for (int k2 = 0; k2 < NSL; ++k2) {
            const float x = expf(lt_out[k2] + nb[k2] - m);
            e += (dst_ok >> k2 & 1u) ? x : 0.f;
          }
          for (int k2 = NSL; k2 < nslots; ++k2) {
            const int j = slot_dst(banded, s, k2);
            if (j < S) e += expf(lt[s * S + j] + ib[j * U + u] - m);
          }
          beta = stepping ? fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf) : beta_init;
          const bool on = valid && t < len;
          const float gamma = on ? expf(fminf(la_t + beta - z, 0.f)) : 0.f;
          dm += gamma;
          dt += (on && stepping) ? gamma : 0.f;
          g_tile[(size_t)tt * nt + tid] = gamma;
        }
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int k2 = 0; k2 < NSL; ++k2)
        if (k2 < nslots) p.xi[((size_t)k2 * S + s) * p.B + b] = xi[k2];
      for (int k2 = NSL; k2 < nslots; ++k2)
        p.xi[((size_t)k2 * S + s) * p.B + b] = xi_sh[(k2 - NSL) * nt + tid];
      p.den_trans[(size_t)s * p.B + b] = dt;
      p.den_mix[(size_t)s * p.B + b] = dm;
    }
    return;
  }

  if constexpr (kWide) {
    // ---- gamma of tile k-1 out to device memory, runs of U floats along B ----
    for (int k = 0; k <= n_tiles; ++k) {
      if (k >= 1) {
        const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0);
        const float* g_tile = gam + (size_t)((k - 1) & 1) * TT * nt;
        for (int i = tid - n_rec; i < (t_hi - t_lo) * nt; i += n_stat) {
          const int tt = i / nt, r = i - tt * nt, s = r / U, u = r - s * U;
          if (b0 + u < p.B) p.gamma[((size_t)(t_lo + tt) * S + s) * p.B + b0 + u] = g_tile[i];
        }
      }
      __syncthreads();
    }
    return;
  }

  // ---- the statistics: tiles -1 .. n_tiles-1, one a step behind ----
  const int st = tid - n_rec, swarp = st >> 5;
  for (int k = 0; k <= n_tiles; ++k) {
    if (k >= 1) {
      const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0), n = t_hi - t_lo;
      const float* buf = ring + ((k - 1) % 3) * frame_tile;
      const float* g_tile = gam + (size_t)((k - 1) & 1) * TT * nt;
      // the kept columns c = tt * U + u, in column order: a thread a column,
      // ballots a warp, the warps' counts summed in warp order
      const int ncol = n * U;
      int count = 0;
      for (int c0 = 0; c0 < ncol; c0 += n_stat) {
        const int c = c0 + st;
        int nonzero = 0;
        if (c < ncol) {
          const float* g = g_tile + (size_t)(c / U) * nt + c % U;
          for (int s2 = 0; s2 < S; ++s2) nonzero += g[s2 * U] != 0.f;
        }
        const bool keep = nonzero > 0;
        const unsigned vote = __ballot_sync(~0u, keep);
        if ((st & 31) == 0) warp_kept[swarp] = __popc(vote);
        named_barrier(2, n_stat);
        int before = count;
        for (int w2 = 0; w2 < (n_stat >> 5); ++w2) {
          before += (w2 < swarp) ? warp_kept[w2] : 0;
          count += warp_kept[w2];
        }
        if (keep) cols[before + __popc(vote & ((1u << (st & 31)) - 1))] = c;
        named_barrier(2, n_stat);
      }
      const int nk = count, k8 = (nk + 7) / 8 * 8;
      const float* fq = buf + 2 * (size_t)TT * nt;  // stream q's features (TT, D_q, U)
      for (int q = 0; q < p.n_streams; ++q) {
        const int D = p.dims[q], M = p.mixes[q];
        const int L1 = FULL ? D + D * D + 1 : 2 * D + 1;
        const int stride = record_stride<DMAX, FULL>(D);
        float origin[DMAX];
#pragma unroll
        for (int e = 0; e < DMAX; ++e) origin[e] = (e < D) ? cst[p.origin_offs[q] + e] : 0.f;
        // a thread an item (kept column kc, state s2), the columns fastest
        for (int it = st; it < k8 * S; it += n_stat) {
          const int s2 = it / k8, kc = it - s2 * k8;
          if (kc >= nk) {  // padding to whole k-steps of 8 columns
            for (int mix = 0; mix < M; ++mix) w_sh[(mix * S + s2) * ks + kc] = 0.f;
            if (s2 == 0)
              for (int e = 0; e < D; ++e) x_sh[e * ks + kc] = 0.f;
            continue;
          }
          const int c = cols[kc], tt = c / U, uu = c - tt * U;
          float x[DMAX], x2[DMAX];
#pragma unroll
          for (int e = 0; e < DMAX; ++e) x[e] = (e < D) ? fq[(tt * D + e) * U + uu] - origin[e] : 0.f;
#pragma unroll
          for (int e = 0; e < DMAX; ++e) {
            x2[e] = x[e] * x[e];
            if (s2 == 0 && e < D) x_sh[e * ks + kc] = x[e];
          }
          const float* rec = cst + p.offs[q] + s2 * M * stride;
          float mx = kNegInf, ex = 0.f;
          // two mixtures' FMA chains side by side, pushed in mixture order
          int mix = 0;
          for (; mix + 2 <= M; mix += 2) {
            float qa, qb;
            if constexpr (FULL) {
              qa = full_mix_q<DMAX>(rec + mix * stride, D, x);
              qb = full_mix_q<DMAX>(rec + (mix + 1) * stride, D, x);
            } else {
              qa = diag_mix_q<DMAX>(rec + mix * stride, x, x2);
              qb = diag_mix_q<DMAX>(rec + (mix + 1) * stride, x, x2);
            }
            w_sh[(mix * S + s2) * ks + kc] = qa;
            w_sh[((mix + 1) * S + s2) * ks + kc] = qb;
            lse_push(qa, mx, ex);
            lse_push(qb, mx, ex);
          }
          if (mix < M) {
            float qv;
            if constexpr (FULL) {
              qv = full_mix_q<DMAX>(rec + mix * stride, D, x);
            } else {
              qv = diag_mix_q<DMAX>(rec + mix * stride, x, x2);
            }
            w_sh[(mix * S + s2) * ks + kc] = qv;
            lse_push(qv, mx, ex);
          }
          const float lbp = lse_value(mx, ex);  // this stream's own log b
          const float g = g_tile[(size_t)tt * nt + s2 * U + uu];
          for (mix = 0; mix < M; ++mix) {
            float* wq = w_sh + (mix * S + s2) * ks + kc;
            const float post = (lbp > 0.5f * kNegInf) ? expf(fminf(*wq - lbp, 0.f)) : 0.f;
            *wq = (g * post) * kWeightScale;
          }
        }
        named_barrier(2, n_stat);
        contract_3xtf32<FULL>(acc + (size_t)S * p.mom_offs[q], S * M, L1, w_sh, x_sh, ks, D, k8 / 8, swarp,
                              n_stat >> 5);
        named_barrier(2, n_stat);  // the weights and features are free again
        fq += (size_t)TT * D * U;
      }
    }
    __syncthreads();
  }
  for (int i = st; i < S * p.mom_thread; i += n_stat) out[i] = acc[i] * kWeightUnscale;
}

// ---------------------------------------------------------------------------
// full covariance past D = 16: the emission and the moments as z-GEMM blocks
// ---------------------------------------------------------------------------

// The moments block's shared memory past wide_emission_floats(RB) (the
// wrapper's ops/kernels/fused_em.py wide_smem_bytes mirrors it): the
// weights of its n tile (kWideGroup, kWideKS) and the gamma of its states
// at the batch's columns (kWideGroup, kWideFrames); ints: the lift table (16
// a m tile at the bound RB), the queue of kept columns (kEmQcap) and the
// warps' vote counts (2, kWideWarps).
constexpr int kEmQcap = kWideFrames + kWideThreads;  // fewer than a batch queued, and one scan step

__host__ __device__ inline size_t em_moments_floats(int rb) {
  return wide_emission_floats(rb) + (size_t)kWideGroup * kWideKS + (size_t)kWideGroup * kWideFrames;
}

__host__ __device__ inline size_t em_moments_ints(int rb) {
  return 16 * (size_t)wide_m_tiles(rb) + kEmQcap + 2 * kWideWarps;
}

// The moments' row groups of a stream of M mixtures over S states, one mma
// n tile (kWideGroup rows of W) each: kWideGroup / M whole states a group
// for M <= kWideGroup, else kWideGroup mixtures of one state.
__host__ __device__ inline int em_groups(int S, int M) {
  return M <= kWideGroup ? (S + kWideGroup / M - 1) / (kWideGroup / M) : S * ((M + kWideGroup - 1) / kWideGroup);
}

// The emission of K1 at full covariance past D = 16 (a z-GEMM of the
// columns' lift [x; 1] against [L^T | c] of every mixture).  grid T *
// ceil(B / kWideFrames), kWideThreads threads: block (t, x) takes the
// kWideFrames columns (t, b) with b from x kWideFrames on, stages each
// stream's features x = feats - origin there, and walks the stream's S M
// mixtures (state-major) in slices of kWideSlice streamed through two
// cp.async buffers, the next one copied while the block computes this one:
// one barrier a slice; warp w computes mixture w / 4 of the slice at the 32
// columns from 32 (w % 4) on (wide_q).  After that barrier thread c <
// kWideFrames pushes the previous slice's q of column c into its running
// logsumexp in mixture order, closes a state's at its last mixture (the
// stream's own log b, 1e-38 guard), and adds it to log_b[t, s, b], which
// it wrote itself for the streams before; the last stream's sum is clamped
// at NEG_INF.  Only the sum of squares of z differs in order from
// emission.cuh's full_mix_q.  Where the stream's qbuf is given, every
// mixture's q goes there too, (t, m S + s, b), for the moments to read.
template <int RB>
__global__ void __launch_bounds__(kWideThreads, 2) em_emission_wide_kernel(const EmParams p) {
  constexpr int P = wide_pitch(RB), MF = wide_mix_floats(RB), G = kWideSlice;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* slices = xs + kWideFrames * P;
  float* qs = slices + 2 * G * MF;
  const int nbx = (p.B + kWideFrames - 1) / kWideFrames;
  const int t = blockIdx.x / nbx, b0 = (blockIdx.x - t * nbx) * kWideFrames;
  const int S = p.S, tid = threadIdx.x, lane = tid & 31, b = b0 + tid;  // b: the column thread tid pushes
  const int gw = (tid >> 5) / (kWideFrames / 32), fg = (tid >> 5) % (kWideFrames / 32);
  int n_st = 0;  // stages: per stream, slices of its S M mixtures
  for (int q = 0; q < p.n_streams; ++q) n_st += (S * p.mixes[q] + G - 1) / G;
  struct Stage {
    int q, mix0, n;
  };
  auto stage_at = [&](int q, int mix0) { return Stage{q, mix0, min(G, S * p.mixes[q] - mix0)}; };
  auto start_copy = [&](int i, const Stage& s) {  // the copies of stage i's slice
    const int D = p.dims[s.q], stride = record_stride(RB, D, true);
    copy_slice_async<RB>(slices + (i & 1) * G * MF, p.consts + p.offs[s.q] + (size_t)s.mix0 * stride, stride, RB, D,
                         s.n);
    cp_async_commit();
  };
  auto stage_x = [&](int q) {  // stream q's features at the block's columns, zeros past D and B
    const int D = p.dims[q];
    const float* f = p.feats[q] + (size_t)t * D * p.B;
    const float* o = p.consts + p.origin_offs[q];
    for (int i = tid; i < RB * kWideFrames; i += kWideThreads) {
      const int k = i / kWideFrames, c = i - k * kWideFrames;
      xs[c * P + k] = (k < D && b0 + c < p.B) ? __ldg(f + (size_t)k * p.B + b0 + c) - __ldg(o + k) : 0.f;
    }
  };
  Stage cur = stage_at(0, 0), prev = cur;
  start_copy(0, cur);
  stage_x(0);
  float mr = kNegInf, er = 0.f;
  for (int i = 0; i <= n_st; ++i) {
    cp_async_wait<0>();  // stage i's slice has landed
    __syncthreads();     // visible to all; stage i-1's q complete, its slice buffer free
    Stage next = cur;
    if (i + 1 < n_st) {
      next = cur.mix0 + G < S * p.mixes[cur.q] ? stage_at(cur.q, cur.mix0 + G) : stage_at(cur.q + 1, 0);
      start_copy(i + 1, next);
    }
    if (i > 0 && tid < kWideFrames) {
      const int M = p.mixes[prev.q];
      const float* qv = qs + ((i - 1) & 1) * G * kWideFrames + tid;
      float* qout = p.qbuf[prev.q];
      for (int g = 0; g < prev.n; ++g) {
        lse_add(qv[g * kWideFrames], mr, er);
        const int mi = prev.mix0 + g;
        if (qout != nullptr && b < p.B)
          qout[((size_t)t * S * M + (mi % M) * S + mi / M) * p.B + b] = qv[g * kWideFrames];
        if ((mi + 1) % M == 0) {  // the state's last mixture
          const float v = lse_value(mr, er);
          mr = kNegInf;
          er = 0.f;
          if (b < p.B) {
            float* o = p.log_b + ((size_t)t * S + mi / M) * p.B + b;
            const float lb = (prev.q == 0) ? v : *o + v;
            *o = (prev.q == p.n_streams - 1) ? fmaxf(lb, kNegInf) : lb;
          }
        }
      }
    }
    if (i < n_st) {
      if (i > 0 && cur.q != prev.q) {  // a new stream: every warp is done with stage i-1's features
        stage_x(cur.q);
        __syncthreads();
      }
      if (gw < cur.n) {
        const float qv = wide_q<RB>(xs + fg * 32 * P, slices + (i & 1) * G * MF + gw * MF, (p.dims[cur.q] + 3) / 4);
        qs[(i & 1) * G * kWideFrames + gw * kWideFrames + fg * 32 + wide_q_frame(lane)] = qv;
      }
    }
    prev = cur;
    cur = next;
  }
}

// The moments of K2 at full covariance past D = 16.  grid (ranges, the row
// groups of every stream (em_groups)), kWideThreads threads: block (r, g)
// takes stream q's group g (states [s_lo, s_lo + n_states), the
// mixtures [lo, hi) of their logsumexps, the rows keep .. keep + nm - 1 on
// the mma's n) over the utterances of range r.  Every thread scans a
// candidate column (t, b) a step, b fastest; a column whose gamma at the
// group's states are all exactly 0.0f adds nothing (x finite) and is
// dropped, the others queue up in scan order (ballots, the warps' counts
// summed in warp order).  Each batch of up to kWideFrames queued columns
// stages their features (x = feats - origin) and gamma, streams the
// group's records through the two slice buffers (wide_q) or, where the
// stream's qbuf holds them, reads the q em_emission_wide_kernel wrote
// (bitwise the same values), pushes each column's q into its state's
// logsumexp in mixture order (thread c < kWideFrames for column c), turns
// the kept rows' q into weights gamma * post * 2^48 at the state's last
// mixture, and adds lift w^T into accumulators that stay in registers for
// the whole range (wide_contract: the lower triangle of x x^T on m,
// 3xTF32).  The partial row of range r
// gets each accumulator at its column and its mirror, in the JAX layout
// (rows m S + s, columns [x | vec(x x^T) | 1]); the wrapper sums the rows
// over the ranges in order.  No atomics: two runs are bitwise equal.
template <int RB>
__global__ void __launch_bounds__(kWideThreads, RB <= 40 ? 2 : 1) em_moments_wide_kernel(const EmParams p) {
  constexpr int P = wide_pitch(RB), MF = wide_mix_floats(RB);
  constexpr int MTW = (wide_m_tiles(RB) + kWideWarps - 1) / kWideWarps;  // m tiles a warp, at most
  extern __shared__ float4 smem4[];
  const int S = p.S, r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gw = warp / (kWideFrames / 32), fg = warp % (kWideFrames / 32);
  int q = 0, g = blockIdx.y;  // the block's stream and its group there
  while (g >= em_groups(S, p.mixes[q])) g -= em_groups(S, p.mixes[q]), ++q;
  const int M = p.mixes[q], D = p.dims[q], d4 = (D + 3) / 4, stride = record_stride(RB, D, true);
  const int Cm = D + D * D + 1, n_mt = wide_m_tiles(D);
  int lo, hi, keep, nm;
  if (M <= kWideGroup) {
    const int per = kWideGroup / M;
    lo = g * per * M;
    hi = min(S, (g + 1) * per) * M;
    keep = lo;
    nm = hi - lo;
  } else {
    const int mg = (M + kWideGroup - 1) / kWideGroup, s = g / mg;
    lo = s * M;
    hi = lo + M;
    keep = lo + (g - s * mg) * kWideGroup;
    nm = min(kWideGroup, hi - keep);
  }
  const int s_lo = lo / M, n_states = (hi - lo) / M, ns = (hi - lo + kWideSlice - 1) / kWideSlice;
  const int per_range = (p.B + p.ranges - 1) / p.ranges, b_lo = min(p.B, r * per_range);
  const int nbr = min(p.B, b_lo + per_range) - b_lo, ctot = p.T * nbr;  // candidate columns (t, b)
  float* xs = reinterpret_cast<float*>(smem4);
  float* slices = xs + kWideFrames * P;
  float* qs = slices + 2 * kWideSlice * MF;
  float* wq = qs + 2 * kWideSlice * kWideFrames;
  float* gq = wq + kWideGroup * kWideKS;
  int* tab = reinterpret_cast<int*>(gq + kWideGroup * kWideFrames);
  int* queue = tab + 16 * wide_m_tiles(RB);
  int* vote = queue + kEmQcap;
  const bool stored = p.qbuf[q] != nullptr;  // the q em_emission_wide_kernel stored, else recomputed here
  // (the stream's pointers are read from the parameters where used: fewer registers live across wide_q)
  auto start_copy = [&](int st, int s) {  // the copies of slice s into buffer st & 1
    copy_slice_async<RB>(slices + (st & 1) * kWideSlice * MF,
                         p.consts + p.offs[q] + (size_t)(lo + s * kWideSlice) * stride, stride, RB, D,
                         min(kWideSlice, hi - lo - s * kWideSlice));
    cp_async_commit();
  };

  for (int c = tid; c < 16 * n_mt; c += kWideThreads) tab[c] = wide_lift_entry<RB>(c, D);
  for (int f = tid; f < kWideFrames; f += kWideThreads) {
    xs[f * P + RB] = 1.f;
    xs[f * P + RB + 1] = 0.f;
  }
  float acc[MTW][4];
#pragma unroll
  for (int u = 0; u < MTW; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
  int head = 0, count = 0, base = 0, step = 0, st = 0;
  for (;;) {
    if (count < kWideFrames && base < ctot) {
      // scan one candidate a thread, queue the kept ones in candidate order
      const int c = base + tid;
      bool kept = false;
      if (c < ctot) {
        const int t = c / nbr, b = b_lo + c - t * nbr;
        const float* gm = p.gamma + ((size_t)t * S + s_lo) * p.B + b;
        for (int j = 0; j < n_states; ++j) kept |= gm[(size_t)j * p.B] != 0.f;
      }
      const unsigned ballot = __ballot_sync(~0u, kept);
      int* vt = vote + (step & 1) * kWideWarps;
      if (lane == 0) vt[warp] = __popc(ballot);
      __syncthreads();
      int rank = 0, added = 0;
      for (int w = 0; w < kWideWarps; ++w) {
        rank += (w < warp) ? vt[w] : 0;
        added += vt[w];
      }
      if (kept) queue[(head + count + rank + __popc(ballot & ((1u << lane) - 1))) % kEmQcap] = c;
      count += added;
      base += kWideThreads;
      ++step;
      continue;
    }
    if (count == 0) break;
    // one batch of nb queued columns: column f of the batch is entry head + f
    const int nb = min(count, kWideFrames);
    __syncthreads();  // the queue entries are written; xs, wq and gq are free
    if (!stored) start_copy(st, 0);
    for (int i = tid; i < RB * kWideFrames; i += kWideThreads) {
      const int k = i / kWideFrames, f = i - k * kWideFrames;
      float v = 0.f;
      if (f < nb && k < D) {
        const int c = queue[(head + f) % kEmQcap], t = c / nbr, b = b_lo + c - t * nbr;
        v = __ldg(p.feats[q] + ((size_t)t * D + k) * p.B + b) - __ldg(p.consts + p.origin_offs[q] + k);
      }
      xs[f * P + k] = v;
    }
    for (int i = tid; i < n_states * kWideFrames; i += kWideThreads) {
      const int j = i / kWideFrames, f = i - j * kWideFrames;
      float v = 0.f;
      if (f < nb) {
        const int c = queue[(head + f) % kEmQcap], t = c / nbr, b = b_lo + c - t * nbr;
        v = p.gamma[((size_t)t * S + s_lo + j) * p.B + b];
      }
      gq[j * kWideFrames + f] = v;
    }
    const bool pusher = tid < kWideFrames, on = tid < nb;
    float mr = kNegInf, er = 0.f;
    auto push = [&](int mi, float v) {  // mixture mi's q at the pusher's column, in mixture order
      lse_add(v, mr, er);
      if (mi >= keep && mi < keep + nm) wq[(mi - keep) * kWideKS + tid] = v;
      if ((mi + 1) % M == 0) {  // the state's last mixture: its kept rows' weights
        const float lbp = lse_value(mr, er);  // this stream's own log b
        const float gam = gq[(mi / M - s_lo) * kWideFrames + tid];
        for (int j = max(mi + 1 - M, keep) - keep; j < min(mi + 1, keep + nm) - keep; ++j) {
          float* wv = wq + j * kWideKS + tid;
          const float post = (lbp > 0.5f * kNegInf) ? expf(fminf(*wv - lbp, 0.f)) : 0.f;
          *wv = on ? (gam * post) * kWeightScale : 0.f;
        }
        mr = kNegInf;
        er = 0.f;
      }
    };
    if (stored) {
      __syncthreads();  // the staged gamma
      if (pusher) {
        size_t col = 0;
        if (on) {
          const int c = queue[(head + tid) % kEmQcap], t = c / nbr;
          col = (size_t)t * S * M * p.B + b_lo + c - t * nbr;
        }
        for (int mi = lo; mi < hi; ++mi) push(mi, on ? p.qbuf[q][col + (size_t)((mi % M) * S + mi / M) * p.B] : 0.f);
      }
    } else {
      for (int s = 0; s <= ns; ++s) {
        cp_async_wait<0>();  // slice s has landed
        __syncthreads();     // visible to all; slice s-1's q complete, its buffer free
        if (s + 1 < ns) start_copy(st + s + 1, s + 1);
        if (s > 0 && pusher) {
          const int mix0 = lo + (s - 1) * kWideSlice, n = min(kWideSlice, hi - mix0);
          const float* qv = qs + ((st + s - 1) & 1) * kWideSlice * kWideFrames + tid;
          for (int gg = 0; gg < n; ++gg) push(mix0 + gg, qv[gg * kWideFrames]);
        }
        if (s < ns && gw < min(kWideSlice, hi - lo - s * kWideSlice) && fg * 32 < nb) {
          const float qv = wide_q<RB>(xs + fg * 32 * P, slices + ((st + s) & 1) * kWideSlice * MF + gw * MF, d4);
          qs[((st + s) & 1) * kWideSlice * kWideFrames + gw * kWideFrames + fg * 32 + wide_q_frame(lane)] = qv;
        }
      }
      st += ns;
    }
    __syncthreads();  // the weights are complete
    wide_contract<RB, MTW>(acc, xs, wq, tab, nm, (nb + 7) / 8, n_mt);
    head = (head + nb) % kEmQcap;
    count -= nb;
  }

  // range r's partial row: each accumulator to its column and its mirror
  const int lc = wide_lift_rows(D), gid = lane >> 2, tig = lane & 3;
  float* out = p.mom + ((size_t)r * p.mom_thread + p.mom_offs[q]) * S;
#pragma unroll
  for (int u = 0; u < MTW; ++u) {
    const int mt = warp + kWideWarps * u;
    if (mt >= n_mt) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = mt * 16 + gid + ((i & 2) ? 8 : 0), n = 2 * tig + (i & 1);
      if (n >= nm || c >= lc) continue;
      const float v = acc[u][i] * kWeightUnscale;
      const int mi = keep + n, s = mi / M, e = tab[c], ia = e & 0xffff, ib = e >> 16;
      float* o = out + ((size_t)(mi - s * M) * S + s) * Cm;
      if (ib == RB) {
        o[ia == RB ? Cm - 1 : ia] = v;  // x_ia, or the constant
      } else {
        o[D + ia * D + ib] = v;
        o[D + ib * D + ia] = v;  // the mirror (the same column where ia == ib)
      }
    }
  }
}

using KernelFn = void (*)(EmParams);

// variant: 0-3 emit-forward with NSL = 0 (the generic loop), 2, 4, 8
// transition slots unrolled; 4 backward-stats with up to 2 transition slots
// (band 0 or 1) in registers, 5 with up to kXiRegs; full covariance past
// D = 16 only: 6 the z-GEMM emission, 7 the z-GEMM moments
template <int DMAX, bool FULL>
KernelFn pick(int variant) {
  switch (variant) {
    case 0: return emit_forward_kernel<DMAX, FULL, 0>;
    case 1: return emit_forward_kernel<DMAX, FULL, 2>;
    case 2: return emit_forward_kernel<DMAX, FULL, 4>;
    case 3: return emit_forward_kernel<DMAX, FULL, 8>;
    case 4: return backward_stats_kernel<DMAX, FULL, 2>;
    case 5: return backward_stats_kernel<DMAX, FULL, kXiRegs>;
    case 6:
    case 7:
      if constexpr (FULL && DMAX > 16) return variant == 6 ? em_emission_wide_kernel<DMAX> : em_moments_wide_kernel<DMAX>;
      return nullptr;
    default: return nullptr;
  }
}

// nullptr for a bound that is not compiled.  Full covariance: 4, 8, 12,
// 16, then 32, 40 and 64 (ops/kernels/fused_em.py FULL_DMAX_BOUNDS: 40
// keeps D = 39's records and features in fewer registers than 64); past 16
// the records (D DMAX floats a mixture) and the D + D^2 + 1 moments a
// mixture outgrow shared memory: the emission and the moments take the
// z-GEMM blocks (records streamed in slices, accumulators in registers) and
// the recursions read the log transitions from device memory.
KernelFn kernel_for(int variant, int dmax, int full) {
  if (full) {
    switch (dmax) {
      case 4: return pick<4, true>(variant);
      case 8: return pick<8, true>(variant);
      case 12: return pick<12, true>(variant);
      case 16: return pick<16, true>(variant);
      case 32: return pick<32, true>(variant);
      case 40: return pick<40, true>(variant);
      case 64: return pick<64, true>(variant);
      default: return nullptr;
    }
  }
  switch (dmax) {
    case 4: return pick<4, false>(variant);
    case 8: return pick<8, false>(variant);
    case 12: return pick<12, false>(variant);
    case 16: return pick<16, false>(variant);
    case 32: return pick<32, false>(variant);
    case 64: return pick<64, false>(variant);
    default: return nullptr;
  }
}

size_t smem_bytes(int which, const EmParams& p) {
  if (which == 0) return sizeof(float) * emit_floats(p);
  return sizeof(float) * backward_floats(p, p.TT) + sizeof(int) * backward_ints(p, p.TT);
}

// threads of a block: emit-forward its recursion, emission and memory
// warps (kEmitThreads); backward-stats S * U rounded up to whole warps (the
// contraction takes whole warps) and its statistics warps
int block_threads(int which, const EmParams& p) {
  if (which == 0) return kEmitThreads;
  return (p.S * p.U + 31) / 32 * 32 + 32 * p.stat_warps;
}

int fill_params(EmParams& p, const void* const* feats, const int* dims, const int* mixes,
                const int* offs, const int* origin_offs, int n_streams, const void* consts, int C,
                int lt_off, const void* lengths, int T, int B, int S, int band, int full, int U) {
  if (n_streams < 1 || n_streams > kMaxStreams || C % 4 != 0 || T < 1 || B < 1 || S < 1 ||
      U < 1 || S > kMaxStates || S * U > kMaxStates || band >= S) {
    return (int)cudaErrorInvalidValue;
  }
  p = EmParams{};
  int mom = 0, max_mix = 1, sum_dims = 0, max_dim = 1;
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
    sum_dims += D;
    max_dim = D > max_dim ? D : max_dim;
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
  p.TT = 1;
  p.sum_dims = sum_dims;
  p.max_dim = max_dim;
  return 0;
}

// the kernel_for variant of a backward-stats launch, by its transition
// slots (band + 1, or S dense)
int backward_variant(const EmParams& p) {
  const int nslots = p.band >= 0 ? p.band + 1 : p.S;
  return nslots <= 2 ? 4 : 5;
}

// the kernel_for variant of an emit-forward launch unrolled to nsl slots
// (0 = the generic loop); -1 for a count that is not compiled
int emit_variant(int nsl) {
  switch (nsl) {
    case 0: return 0;
    case 2: return 1;
    case 4: return 2;
    case 8: return 3;
    default: return -1;
  }
}

cudaError_t allow_smem(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// a z-GEMM block (variant 6 or 7) of kWideThreads threads
int run_wide(int variant, const EmParams& p, int dmax, dim3 grid, size_t smem, int device, void* stream) {
  const KernelFn kernel = kernel_for(variant, dmax, 1);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = wide_setup(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

size_t wide_smem(int variant, int dmax) {
  return variant == 6 ? sizeof(float) * wide_emission_floats(dmax)
                      : sizeof(float) * em_moments_floats(dmax) + sizeof(int) * em_moments_ints(dmax);
}

int run(int which, int variant, const EmParams& p, int dmax, int full, int device, void* stream) {
  const KernelFn kernel = kernel_for(variant, dmax, full);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(which, p);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.U - 1) / p.U;
  kernel<<<blocks, block_threads(which, p), smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers run on `stream` and return cudaGetLastError() (0 = ok).
// feats/dims/mixes/offs/origin_offs are host arrays of n_streams entries;
// the pointers they hold and every other pointer are device pointers.
// band < 0 selects dense transitions.  U = utterances per block.
// Emit-forward: kEmitThreads threads, rec_warps recursion warps, em_warps
// emission warps and the rest memory warps; TT frames a tile, the constants
// in device memory (consts_global) or shared memory, nsl transition slots
// unrolled (2, 4, 8; 0 = the generic loop); shared memory emit_floats.
// Backward-stats: S*U threads rounded up to whole warps plus stat_warps
// statistics warps; TT = frames a tile stages, acc_global = its moment
// accumulators in mom rather than shared memory and consts_global = its
// constants read from device memory (shared memory backward_floats +
// backward_ints); mom holds one partial row per block.  Full covariance
// past D = 16 (dmax > 16) launches two kernels each: emit-forward
// em_emission_wide_kernel into log_b, then the recursion; backward-stats
// the recursion, writing gamma (T, S, B) scratch, then
// em_moments_wide_kernel over `ranges` ranges of utterances, mom holding
// one partial row per range.  qbuf (null, or a host array of n_streams
// device pointers, full covariance past D = 16 only): the per-mixture q
// (T, M_p S, B) that emit-forward writes and backward-stats' moments read
// instead of recomputing it.
int srhmm_emit_forward(const void* const* feats, const int* dims, const int* mixes,
                       const int* offs, const int* origin_offs, int n_streams, const void* consts,
                       int C, int lt_off, const void* lengths, void* log_b, void* la, void* const* qbuf, int T, int B,
                       int S, int band, int full, int dmax, int U, int TT, int rec_warps, int em_warps,
                       int consts_global, int nsl, int device, void* stream) {
  EmParams p;
  const int bad = fill_params(p, feats, dims, mixes, offs, origin_offs, n_streams, consts, C,
                              lt_off, lengths, T, B, S, band, full, U);
  if (bad) return bad;
  // the recursion warps hold the block's U utterances: 32 / S of them a
  // warp for S <= 32, else ceil(S / 32) warps each; U divides a warp (the
  // staging and store helpers take whole runs of U floats)
  const int need = S <= 32 ? (U + 32 / S - 1) / (32 / S) : U * ((S + 31) / 32);
  const int variant = emit_variant(nsl);
  if (32 % U != 0 || TT < 1 || rec_warps != need || em_warps < 1 || 32 * (rec_warps + em_warps) >= kEmitThreads ||
      variant < 0 || (nsl > 0 && (band < 0 || band >= nsl))) {
    return (int)cudaErrorInvalidValue;
  }
  p.TT = TT;
  p.rec_warps = rec_warps;
  p.em_warps = em_warps;
  p.consts_global = consts_global;
  p.wide = full && dmax > 16;
  p.log_b = static_cast<float*>(log_b);
  p.la = static_cast<float*>(la);
  if (qbuf != nullptr) {
    if (!p.wide) return (int)cudaErrorInvalidValue;
    for (int q = 0; q < n_streams; ++q) p.qbuf[q] = static_cast<float*>(qbuf[q]);
  }
  if (p.wide) {
    const size_t blocks = (size_t)((B + kWideFrames - 1) / kWideFrames) * T;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int err = run_wide(6, p, dmax, dim3((unsigned)blocks), wide_smem(6, dmax), device, stream);
    if (err != 0) return err;
  }
  return run(0, variant, p, dmax, full, device, stream);
}

int srhmm_backward_stats(const void* const* feats, const int* dims, const int* mixes,
                         const int* offs, const int* origin_offs, int n_streams,
                         const void* consts, int C, int lt_off, const void* lengths,
                         const void* safe_z, const void* vmask, const void* log_b, const void* la,
                         void* xi, void* den_trans, void* den_mix, void* mom, void* gamma, int ranges,
                         void* const* qbuf, int T, int B, int S, int band, int full, int dmax, int U, int TT,
                         int stat_warps, int acc_global, int consts_global, int device, void* stream) {
  EmParams p;
  const int bad = fill_params(p, feats, dims, mixes, offs, origin_offs, n_streams, consts, C,
                              lt_off, lengths, T, B, S, band, full, U);
  if (bad) return bad;
  p.TT = TT;
  p.stat_warps = stat_warps;
  p.acc_global = acc_global;
  p.consts_global = consts_global;
  p.wide = full && dmax > 16;
  p.gamma = static_cast<float*>(gamma);
  p.ranges = ranges;
  if (TT < 1 || stat_warps < 1 || block_threads(1, p) > kMaxBackwardThreads ||
      (p.wide && (gamma == nullptr || ranges < 1 || ranges > B)) || (qbuf != nullptr && !p.wide)) {
    return (int)cudaErrorInvalidValue;
  }
  if (qbuf != nullptr)
    for (int q = 0; q < n_streams; ++q) p.qbuf[q] = static_cast<float*>(qbuf[q]);
  p.safe_z = static_cast<const float*>(safe_z);
  p.vmask = static_cast<const float*>(vmask);
  p.log_b = const_cast<float*>(static_cast<const float*>(log_b));
  p.la = const_cast<float*>(static_cast<const float*>(la));
  p.xi = static_cast<float*>(xi);
  p.den_trans = static_cast<float*>(den_trans);
  p.den_mix = static_cast<float*>(den_mix);
  p.mom = static_cast<float*>(mom);
  const int err = run(1, backward_variant(p), p, dmax, full, device, stream);
  if (err != 0 || !p.wide) return err;
  int groups = 0;
  for (int q = 0; q < n_streams; ++q) groups += em_groups(S, p.mixes[q]);
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  return run_wide(7, p, dmax, dim3(ranges, groups), wide_smem(7, dmax), device, stream);
}

// Resident blocks per SM for a launch of `threads` threads and `smem`
// bytes of dynamic shared memory of kernel_for variant `variant` (0-3
// emit-forward unrolled to 0 (generic), 2, 4, 8 slots; 4, 5 backward-stats
// with 2 or kXiRegs slots in registers; 6, 7 the z-GEMM emission and
// moments of full covariance past D = 16, at their own threads and shared
// memory whatever `threads` and `smem` say); written to *blocks.  Returns a
// CUDA error code (0 = ok).
int srhmm_em_occupancy(int variant, int dmax, int full, int threads, int smem, int* blocks) {
  const KernelFn kernel = kernel_for(variant, dmax, full);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (variant >= 6) {
    threads = kWideThreads;
    smem = (int)wide_smem(variant, dmax);
  }
  const cudaError_t err = variant >= 6 ? wide_setup(reinterpret_cast<const void*>(kernel), (size_t)smem)
                                       : allow_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, (size_t)smem);
}

}  // extern "C"
