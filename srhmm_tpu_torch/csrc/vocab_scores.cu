// Vocabulary scoring kernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel srhmm_tpu/ops/pallas/scoring_pallas.py:301
// vocab_scores_pallas (body _score_kernel :210, emission _stream_log_b :157).
// It scores every utterance of a padded batch against every word of a
// stacked vocabulary in one launch and writes only the final log-alpha
// (W*S, B) of every word at every utterance's last valid frame.
//
// Per frame and (utterance, word): per-stream mixture log-likelihoods
// (diagonal covariance: the lifted [x, x^2] dot product with the mixture
// log-weight folded into the bias, no density clamp; full covariance: the
// Cholesky z = L^T x - L^T mu, quad = sum z^2, clamp
// min(-quad/2 + bias, log 1e20) BEFORE + log w), a per-state mixture
// logsumexp with the max seeded at NEG_INF and the 1e-38 guard, the sum over
// streams, then the banded left-right forward step under (logsumexp, +) or
// Viterbi (max, +), everything clamped at NEG_INF.  Frame 0 starts in
// state 0 and is always taken; frames t >= length keep the carry.
//
// Design.  A block takes WB words x U utterances ("pairs", a pair one
// (word, utterance) chain) and walks the tiles of TT frames up to its
// utterances' longest length with three kinds of warp one tile apart, the
// shape of fused_em.cu's emit_forward_kernel:
// * recursion warps run tile k: lane = (state, pair), 32 / S pairs of S
//   consecutive lanes a warp for S <= 32, else ceil(S / 32) warps a pair.
//   The band's sources come from the lanes below by __shfl_up_sync and enter
//   a branch-free log-sum-exp (or max) unrolled to 2, 4 or 8 slots
//   (emission.cuh slots_lse / slots_max); a source in another warp of the
//   pair, and every source of a band past 8 slots (the generic loop), from
//   a double-buffered log-alpha row in shared memory after a barrier of the
//   recursion warps.  Only the final log-alpha is written;
// * emission warps compute tile k+1's log b meanwhile: a warp task is one
//   (word, state) and 32 NC of the tile's (frame, utterance) columns, a
//   thread NC columns side by side with their features in registers and
//   each record read once for the NC (emission.cuh state_log_b_cols, each
//   column's fmaf chain in diag_mix_q / full_mix_q order), summed over the
//   streams;
// * a memory warp stages tile k+2's features by 16-byte cp.async
//   (tile_mma.cuh stage_rows_async).
// The words' constant blocks sit in shared memory, or are read from device
// memory (through L1) when they do not fit beside the tiles.  The final
// log-alpha is bitwise that of one thread per (utterance, word) computing
// its emission and its step in 7ca66a2's order.  All arithmetic is fp32 on
// the CUDA cores (no TF32).
//
// What bounds it on the H100.  Operations: per stepped frame, word and
// state the emission's ~S M (2 DMAX) FMAs (diagonal) or M (D DMAX + D)
// (full), a few MUFU ops of the step; at the recognizer's shapes that is
// ~0.2 ms of the card's fp32 rate against ~0.02 ms of bytes (the features,
// read once per word block, mostly from L2).  The recursion's chain (a
// shuffle, two exp and a log a frame) is latency, hidden by the pairs in
// flight: one 640-thread block an SM (the emission's registers) holds up to
// 8 recursion warps.  Later work: registers rebalanced between the kinds of
// warp (setmaxnreg).
//
// Full covariance past D = 16 (the instances FULL at DMAX 32 and 64,
// kWide).  There the emission, M (D (D + 1) / 2 + D) FMAs a row and frame,
// is the whole bound, and one column an emission thread ran it as serial
// chains over all DMAX columns of L^T with a load per 4 FMAs, its records
// (246 KB a word at D = 39) from device memory.  So csrc/wide_log_b.cu
// computes log b first, as z-GEMM blocks, into a buffer laid out (ceil(B /
// U), frames, W S, U) (ops/kernels/scoring.py _vocab_scores_wide), and
// these instances read it: the emission warps copy each tile's runs of nw S
// U floats by cp.async (copy_tile), the memory warp stages nothing, the
// constant blocks hold the diagonals only.  The recursion is the same code
// on the same log b.  A launch steps the frames [t0, t1): a call whose log
// b passes common.WIDE_LOG_B_BYTES is split over launches (utterances, or
// frames, the carry kept in out between them).

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace {

using namespace srhmm;

constexpr int kThreads = 640;   // recursion + emission + memory warps: 5 a scheduler, 96 registers a thread
constexpr int kMaxStates = 256;
// the feature columns an emission thread takes side by side
template <int DMAX>
constexpr int kCols = DMAX <= 16 ? 2 : 1;

struct Params {
  const float* feats[kMaxStreams];  // per stream: (T, D_p, B)
  int dims[kMaxStreams];            // D_p
  int mixes[kMaxStreams];           // M_p
  int offs[kMaxStreams];            // float offset of stream p's records in a word block
  int n_streams;
  const float* consts;  // (W, C) per-word constant blocks
  int C;                // floats per word block, a multiple of 4
  int diag_off;         // offset of the (band+1, S) log-transition diagonals
  const int* lengths;   // (B,)
  float* out;           // (W*S, B)
  int T, B, W, S, band;
  int U, WB, TT;        // utterances and words a block, frames a tile
  int u_blocks;         // ceil(B / U): block x = word block * u_blocks + utterance block
  int rec_warps, em_warps;
  int consts_global;    // the constants read from device memory, not shared memory
  int viterbi;          // the (max, +) semiring, not (logsumexp, +)
  int sum_dims;         // sum_p D_p (0 at full covariance past D = 16: no features staged)
  int ldo;              // floats between two rows of out
  // full covariance past D = 16 (kWide): csrc/wide_log_b.cu's log b,
  // (ceil(B / U), lb_frames, W S, U) from frame t0, and the frames [t0, t1)
  // this launch steps, the carry read from out where t0 > 0
  const float* lb;
  int lb_frames, t0, t1;
};

// The records of a word block follow csrc/emission.cuh (log w folded into
// the diagonal bias), then the (band+1, S) log-transition diagonals
// diag[d * S + j] = log a[j-d, j].
//
// Shared memory of a block, in floats (the wrapper's ops/kernels/scoring.py
// vocab_smem_bytes mirrors it): the WB words' constant blocks (unless
// consts_global) | the features, two slots of (TT, sum_p D_p, U) | log b,
// two slots of (TT, WB, S, U) | log-alpha, two rows of (S, WB U) | the
// block's frame count (one int, padded to 4); slot k & 1 holds tile k.
__host__ __device__ inline size_t vocab_floats(const Params& p) {
  const size_t P = (size_t)p.U * p.WB;
  return (p.consts_global ? 0 : (size_t)p.WB * p.C) + 2 * (size_t)p.TT * p.U * p.sum_dims +
         2 * (size_t)p.TT * p.S * P + 2 * (size_t)p.S * P + 4;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Full covariance past D = 16: tile k's log b (n frames from t_lo) copied
// from the emission pass's buffer into lbt, one run of nw S U floats a
// frame (the tile's (WB, S, U) layout), by 4-byte cp.async; copy thread e
// of n_em.
__device__ __forceinline__ void copy_tile(const Params& p, float* lbt, int t_lo, int n, int ub, int w0, int nw,
                                          int e, int n_em) {
  const int run = nw * p.S * p.U;
  const size_t fs = (size_t)p.W * p.S * p.U, row = (size_t)p.S * p.U * p.WB;  // floats a frame: buffer, tile
  const float* src = p.lb + ((size_t)ub * p.lb_frames + (t_lo - p.t0)) * fs + (size_t)w0 * p.S * p.U;
  for (int i = e; i < n * run; i += n_em) {
    const int f = i / run, j = i - f * run;
    cp_async4(lbt + f * row + j, src + f * fs + j, true);
  }
  cp_async_commit();
}

// log b of one tile (n frames) for the block's nw words: emission thread e
// of n_em takes the warp tasks (word wl, state s, column group g) round
// robin, g fastest; a thread's NC columns g 32 NC + lane + 32 j of the
// tile's n U (frame, utterance) columns.  cst: the block's first word's
// constant block (shared or device memory), f: the tile's features (per
// stream (TT, D_p, U)), lbt: its log b (TT, WB, S, U).
template <int DMAX, bool FULL>
__device__ __forceinline__ void emission_tile(const Params& p, const float* cst, const float* f, float* lbt, int n,
                                              int nw, int e, int n_em) {
  constexpr int NC = kCols<DMAX>;
  const int U = p.U, S = p.S, lane = e & 31, lg_u = 31 - __clz(U);
  const int ncol = n * U, groups = (ncol + 32 * NC - 1) / (32 * NC), step = n_em >> 5;
  int g = e >> 5, s = 0, wl = 0;
  for (;;) {
    while (g >= groups && wl < nw) {
      g -= groups;
      if (++s == S) s = 0, ++wl;
    }
    if (wl >= nw) return;
    const int c0 = g * 32 * NC + lane;
    int tt[NC], u[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = min(c0 + 32 * j, ncol - 1);  // a column past the tile repeats the last, not stored
      tt[j] = c >> lg_u;
      u[j] = c & (U - 1);
    }
    const float* cw = cst + (size_t)wl * p.C;
    const float* fq = f;
    float lb[NC];
    for (int q = 0; q < p.n_streams; ++q) {
      const int D = p.dims[q], M = p.mixes[q];
      float x[NC][DMAX];
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int d = 0; d < DMAX; ++d) x[j][d] = (d < D) ? fq[(tt[j] * D + d) * U + u[j]] : 0.f;
      float v[NC];
      state_log_b_cols<DMAX, FULL, NC>(cw + p.offs[q] + s * M * record_stride<DMAX, FULL>(D), M, D, x, v);
#pragma unroll
      for (int j = 0; j < NC; ++j) lb[j] = (q == 0) ? v[j] : lb[j] + v[j];
      fq += (size_t)p.TT * D * U;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (c0 + 32 * j < ncol) lbt[(((size_t)tt[j] * p.WB + wl) * S + s) * U + u[j]] = lb[j];
    g += step;
  }
}

// The block's three kinds of warp (see the note at the top); the tiles go
// up in time, one barrier closes each step and two open the first.  At
// full covariance past D = 16 (kWide) csrc/wide_log_b.cu has written log b
// before the launch: the emission warps copy its tiles (copy_tile), the
// memory warp stages nothing, and the launch steps the frames [t0, t1).
template <int DMAX, bool FULL, int NSL>
__global__ void __launch_bounds__(kThreads) vocab_scores_kernel(const __grid_constant__ Params p) {
  constexpr bool kWide = FULL && DMAX > 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = p.S, U = p.U, TT = p.TT, P = U * p.WB, tid = threadIdx.x;
  const int n_rec = 32 * p.rec_warps, n_em = 32 * p.em_warps;
  const int ub = blockIdx.x % p.u_blocks, w0 = blockIdx.x / p.u_blocks * p.WB;
  const int b0 = ub * U, nw = min(p.WB, p.W - w0);
  const size_t x_tile = (size_t)TT * p.sum_dims * U, s_tile = (size_t)TT * S * P, row = (size_t)S * P;
  float* xs = smem + (p.consts_global ? 0 : (size_t)p.WB * p.C);  // features
  float* lbs = xs + 2 * x_tile;                                   // log b
  float* rows = lbs + 2 * s_tile;                                 // log-alpha rows
  int* t_blk = reinterpret_cast<int*>(rows + 2 * row);
  const float* cst = p.consts + (size_t)w0 * p.C;
  if (!p.consts_global) {
    const float4* src = reinterpret_cast<const float4*>(cst);
    for (int i = tid; i < nw * p.C / 4; i += blockDim.x) smem4[i] = src[i];
    cst = smem;
  }
  if (tid == 0) {  // the block's frames: its longest utterance (frame 0 always)
    int m = 1;
    for (int u = 0; u < U && b0 + u < p.B; ++u) m = max(m, min(max(p.lengths[b0 + u], 1), p.T));
    *t_blk = m;
  }
  __syncthreads();
  const int t_first = kWide ? p.t0 : 0;
  const int T = kWide ? min(*t_blk, p.t1) : *t_blk, n_tiles = (T - t_first + TT - 1) / TT;
  if (kWide && n_tiles <= 0) return;  // the block's utterances end before t0: out holds their carry

  if constexpr (kWide) {
    if (tid >= n_rec + n_em) {
      for (int k = 0; k < n_tiles + 2; ++k) __syncthreads();  // no features: the block's barriers only
      return;
    }
    if (tid >= n_rec) {
      // ---- the copy warps: tile k+1's log b while the recursion runs tile k ----
      const int e = tid - n_rec;
      __syncthreads();
      copy_tile(p, lbs, t_first, min(TT, T - t_first), ub, w0, nw, e, n_em);
      cp_async_wait<0>();
      __syncthreads();
      for (int k = 0; k < n_tiles; ++k) {
        const int t_lo = t_first + (k + 1) * TT;
        if (k + 1 < n_tiles) {
          copy_tile(p, lbs + ((k + 1) & 1) * s_tile, t_lo, min(TT, T - t_lo), ub, w0, nw, e, n_em);
          cp_async_wait<0>();
        }
        __syncthreads();
      }
      return;
    }
  } else {
    if (tid >= n_rec + n_em) {
      // ---- the memory warp(s): tile k's features into slot k & 1 ----
      const int n_mem = blockDim.x - n_rec - n_em;
      auto stage = [&](int k) {
        const int t0 = k * TT;
        float* f = xs + (k & 1) * x_tile;
        for (int q = 0; q < p.n_streams; ++q) {
          stage_rows_async(f, p.dims[q] * U, U, p.feats[q], t0, min(TT, T - t0), p.dims[q], p.T, p.B, b0, U,
                           n_rec + n_em, n_mem);
          f += (size_t)TT * p.dims[q] * U;
        }
        cp_async_commit();
      };
      stage(0);
      if (n_tiles > 1) {
        stage(1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile 0's features are in
      cp_async_wait<0>();
      __syncthreads();  // tile 0's log b and tile 1's features are in
      for (int k = 0; k < n_tiles; ++k) {
        // tile k+2 goes into the slot of tile k, read last step
        if (k + 2 < n_tiles) stage(k + 2);
        cp_async_wait<0>();
        __syncthreads();
      }
      return;
    }
    if (tid >= n_rec) {
      // ---- the emission warps: tile k+1's log b while the recursion runs tile k ----
      const int e = tid - n_rec;
      __syncthreads();  // tile 0's features are in
      emission_tile<DMAX, FULL>(p, cst, xs, lbs, min(TT, T), nw, e, n_em);
      __syncthreads();
      for (int k = 0; k < n_tiles; ++k) {
        if (k + 1 < n_tiles)
          emission_tile<DMAX, FULL>(p, cst, xs + ((k + 1) & 1) * x_tile, lbs + ((k + 1) & 1) * s_tile,
                                    min(TT, T - (k + 1) * TT), nw, e, n_em);
        __syncthreads();
      }
      return;
    }
  }

  // ---- the recursion warps ----
  const int lane = tid & 31, wid = tid >> 5, Wn = (S + 31) >> 5;
  int pr, s;
  bool slot;  // the lane holds a (state, pair) of the block
  if (S <= 32) {
    const int G = 32 / S, ul = lane / S;
    pr = wid * G + ul;
    s = lane - ul * S;
    slot = ul < G && pr < P;
  } else {
    pr = wid / Wn;
    s = (wid - pr * Wn) * 32 + lane;
    slot = s < S && pr < P;
  }
  const int prc = min(pr, P - 1), sc = min(s, S - 1);  // where a lane without one reads
  const int lg_u = 31 - __clz(U), wl = prc >> lg_u, u = prc & (U - 1), b = b0 + u;
  const bool th = slot && wl < nw;  // ... of a word of the vocabulary
  const bool live = th && b < p.B;
  const int len = live ? p.lengths[b] : 0;
  const float* diag = cst + (size_t)wl * p.C + p.diag_off;
  // slot kk: source s - kk and its log transition, in registers
  float lt_in[NSL > 0 ? NSL : 1];
  unsigned ok = 0;
#pragma unroll
  for (int kk = 0; kk < NSL; ++kk) {
    const bool on = th && kk <= p.band && s - kk >= 0;
    lt_in[kk] = on ? diag[kk * S + s] : 0.f;
    ok |= on ? 1u << kk : 0u;
  }
  float carry = kNegInf;
  if (kWide && t_first > 0) {  // a later launch of one call: the carry from out
    if (live) carry = p.out[((size_t)(w0 + wl) * S + s) * p.ldo + b];
    if ((NSL == 0 || Wn > 1) && th) rows[((t_first - 1) & 1) * row + (size_t)s * P + pr] = carry;
  }
  __syncthreads();  // tile 0's features are in
  __syncthreads();  // tile 0's log b is in
  const int off = (wl * S + sc) * U + u;
  for (int k = 0; k < n_tiles; ++k) {
    const int t_lo = t_first + k * TT, t_hi = min(T, t_lo + TT);
    const float* lbt = lbs + (k & 1) * s_tile;
    float lbn = lbt[off];
    for (int t = t_lo; t < t_hi; ++t) {
      const float lb = lbn;
      if (t + 1 < t_hi) lbn = lbt[(size_t)(t + 1 - t_lo) * row + off];
      const float* prev = rows + ((t + 1) & 1) * row;  // log-alpha of frame t-1, (S, P)
      if constexpr (NSL > 0) {
        float v[NSL];
        v[0] = (ok & 1u) ? carry + lt_in[0] : -INFINITY;
#pragma unroll
        for (int kk = 1; kk < NSL; ++kk) {
          float x = __shfl_up_sync(~0u, carry, kk);
          if (Wn > 1 && lane < kk && s - kk >= 0) x = prev[(s - kk) * P + prc];
          v[kk] = (ok >> kk & 1u) ? x + lt_in[kk] : -INFINITY;
        }
        float upd;
        if (p.viterbi) {
          upd = slots_max<NSL>(v);
        } else {
          upd = slots_lse<NSL>(v);
        }
        const float next = fmaxf(upd + lb, kNegInf);
        carry = (t == 0) ? fmaxf((s == 0 ? 0.f : kNegInf) + lb, kNegInf) : (t < len ? next : carry);
      } else {
        if (t == 0) {
          carry = fmaxf((s == 0 ? 0.f : kNegInf) + lb, kNegInf);
        } else if (t < len) {
          const int dj = min(p.band, s);  // shifts that would cross a word start are skipped
          float m = kNegInf;
          for (int d = 0; d <= dj; ++d) m = fmaxf(m, prev[(s - d) * P + prc] + diag[d * S + s]);
          float upd = m;
          if (!p.viterbi) {
            float e = 0.f;
            for (int d = 0; d <= dj; ++d) e += expf(prev[(s - d) * P + prc] + diag[d * S + s] - m);
            upd = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
          }
          carry = fmaxf(upd + lb, kNegInf);
        }
      }
      if (NSL == 0 || Wn > 1) {  // frame t's log-alpha, for the next frame's sources
        if (th) rows[(t & 1) * row + (size_t)s * P + pr] = carry;
        named_barrier(1, n_rec);
      }
    }
    __syncthreads();
  }
  if (live) p.out[((size_t)(w0 + wl) * S + s) * p.ldo + b] = carry;
}

using KernelFn = void (*)(Params);

template <int DMAX, bool FULL>
KernelFn pick_slots(int nsl) {
  switch (nsl) {
    case 0: return vocab_scores_kernel<DMAX, FULL, 0>;
    case 2: return vocab_scores_kernel<DMAX, FULL, 2>;
    case 4: return vocab_scores_kernel<DMAX, FULL, 4>;
    case 8: return vocab_scores_kernel<DMAX, FULL, 8>;
    default: return nullptr;
  }
}

template <int DMAX>
KernelFn pick(int full, int nsl) {
  return full ? pick_slots<DMAX, true>(nsl) : pick_slots<DMAX, false>(nsl);
}

// nsl: transition slots unrolled (2, 4, 8; 0 = the generic loop); nullptr
// for a bound or a slot count that is not compiled
KernelFn kernel_for(int dmax, int full, int nsl) {
  switch (dmax) {
    case 4: return pick<4>(full, nsl);
    case 8: return pick<8>(full, nsl);
    case 12: return pick<12>(full, nsl);
    case 16: return pick<16>(full, nsl);
    case 32: return pick<32>(full, nsl);
    case 64: return pick<64>(full, nsl);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// feats/dims/mixes/offs are host arrays of n_streams entries; the pointers
// they hold, consts, lengths and out are device pointers.  The launch
// shape (ops/kernels/scoring.py vocab_block): U utterances (a power of 2 up
// to 32) and WB words a block, TT frames a tile, rec_warps recursion warps
// (32 / S pairs a warp for S <= 32, else ceil(S / 32) warps a pair),
// em_warps emission warps and the rest of kThreads memory warps, the
// constants in device memory (consts_global) or shared memory, nsl
// transition slots unrolled (2, 4, 8 > band; 0 = the generic loop).  out
// has rows of ldo floats (>= B).  Full covariance at dmax 32 or 64 (the
// kernel's wide instances): lb is csrc/wide_log_b.cu's log b, (ceil(B / U),
// t1 - t0, W S, U), the launch steps the frames [t0, t1) and reads the carry
// from out where t0 > 0; consts holds the diagonals only, no features are
// read.  Otherwise lb is null, t0 = 0 and t1 = T.
int srhmm_vocab_scores(const void* const* feats, const int* dims, const int* mixes,
                       const int* offs, int n_streams, const void* consts, int C,
                       int diag_off, const void* lengths, void* out, int T, int B, int W, int S,
                       int band, int full, int viterbi, int dmax, int U, int WB, int TT, int rec_warps,
                       int em_warps, int consts_global, int nsl, const void* lb, int t0, int t1, int ldo,
                       int device, void* stream) {
  const bool wide = full && dmax > 16;
  const int P = U * WB;
  const int need = S <= 32 ? (P + 32 / S - 1) / (32 / S) : P * ((S + 31) / 32);
  const long long blocks = (long long)((B + U - 1) / max(U, 1)) * ((W + WB - 1) / max(WB, 1));
  if (n_streams < 1 || n_streams > kMaxStreams || C % 4 != 0 || W < 1 || B < 1 || T < 1 || S < 1 ||
      S > kMaxStates || band < 0 || U < 1 || 32 % U != 0 || WB < 1 || TT < 1 || rec_warps != need ||
      em_warps < 1 || 32 * (rec_warps + em_warps) >= kThreads || (nsl > 0 && band >= nsl) ||
      blocks > 0x7fffffffLL || ldo < B || (wide != (lb != nullptr)) || t0 < 0 || t1 <= t0 || t1 > T ||
      (!wide && (t0 != 0 || t1 != T))) {
    return (int)cudaErrorInvalidValue;
  }
  const KernelFn kernel = kernel_for(dmax, full, nsl);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  int sum_dims = 0;
  for (int i = 0; i < n_streams; ++i) {
    if (dims[i] < 1 || dims[i] > dmax || mixes[i] < 1) return (int)cudaErrorInvalidValue;
    p.feats[i] = static_cast<const float*>(feats[i]);
    p.dims[i] = dims[i];
    p.mixes[i] = mixes[i];
    p.offs[i] = offs[i];
    sum_dims += dims[i];
  }
  p.n_streams = n_streams;
  p.consts = static_cast<const float*>(consts);
  p.C = C;
  p.diag_off = diag_off;
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.B = B;
  p.W = W;
  p.S = S;
  p.band = band;
  p.U = U;
  p.WB = WB;
  p.TT = TT;
  p.u_blocks = (B + U - 1) / U;
  p.rec_warps = rec_warps;
  p.em_warps = em_warps;
  p.consts_global = consts_global;
  p.viterbi = viterbi;
  p.sum_dims = wide ? 0 : sum_dims;
  p.ldo = ldo;
  p.lb = static_cast<const float*>(lb);
  p.lb_frames = t1 - t0;
  p.t0 = t0;
  p.t1 = t1;
  const size_t smem = sizeof(float) * vocab_floats(p);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* srhmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
