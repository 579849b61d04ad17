// Word-loop Viterbi decode kernel for NVIDIA Hopper (sm_90a): 1-best, 2-best
// and K-best (K <= 4) over a stacked vocabulary, unigram or bigram arcs,
// P in [1, 6] parameter streams, diagonal or full covariance.
//
// Replaces the TPU kernels of srhmm_tpu/ops/pallas/decode_pallas.py:
//   K = 1   <- :352 word_loop_decode_pallas    (body _decode_kernel :224)
//   K = 2   <- :718 word_loop_decode_k2_pallas (body _decode_k2_kernel :508)
//   K >= 3  <- :1050 word_loop_decode_kn_pallas (body _decode_kn_kernel :841)
// The plain PyTorch twin (ops/kernels/decode.py word_loop_decode_plain)
// computes the same function, tie-breaks included.
//
// Per frame t of utterance b (frames t >= length keep the carry and write
// identity pointers; frame 0 is taken even for a zero-length row):
//  * log b of every row (word, state): per stream the mixture log-likelihoods
//    (csrc/emission.cuh records: diagonal lift dot product with log w folded
//    into the bias; full covariance Cholesky z with the log 1e20 clamp before
//    log w), the online mixture logsumexp, the sum over streams;
//  * frame 0: plane 0 = max(entry + log b, NEG_INF), the other planes
//    NEG_INF, identity pointers;
//  * within-word candidates carry[k][row-d] + diag[d][row] (row-d in the
//    same word, else NEG_INF + diag), folded in the order d ascending, then
//    plane ascending, with strict > (the shortest jump, then the lower
//    plane, wins a tie);
//  * cross-word candidates, folded after them with strict > (within-word
//    wins a tie).  Unigram: the best exit tokens of the whole utterance
//    (lowest row, then lowest plane, on ties) plus the destination's arc.
//    Bigram: per destination v the top K of {e_w[k][u] + arc[u][v]} with
//    e_w[k][u] the max over word u's rows of carry[k] + exit_col, lowest
//    source word then lowest plane first.  K = 2 reproduces the 2-best
//    kernel's selection rules exactly (its second candidate is the better
//    of the best token's own second plane and the runner-up's first, the
//    runner-up winning a tie);
//  * new = max(best + log b, NEG_INF); K = 1 writes source rows, K >= 2
//    flat src*K + k pointers.
//
// Design.  The recursion couples every word of an utterance each frame (the
// cross-word max over all exits, the W x W bigram contraction), so one
// block holds one utterance, threads over rows (row = tid + i * blockDim).
// The (K, N) carry is double-buffered in shared memory: a frame reads
// buffer (t-1)&1 and writes t&1, with one __syncthreads for the unigram
// cross-word phase (one per reduction round at K >= 2), two for the bigram
// one, and one at the end of the frame.  The time loop runs inside the
// kernel: one launch per batch.  Every product is an fp32 fmaf on the CUDA
// cores (no TF32, no tensor cores).
//  * Emission, per chunk of up to 16 frames: a thread takes its rows one at
//    a time and a row's mixtures two at a time.  The diagonal records come
//    row-minor (ops/kernels/decode.py decode_records), so the rows of a warp
//    read neighbouring 16-byte words from L2 (bypassing L1: a block streams
//    every record of the vocabulary each chunk), each group of 4 dimensions
//    once a chunk, applied to every frame of the chunk, whose sums sit in
//    registers; x comes from shared memory as a 16-byte broadcast and x² is
//    formed in registers (the value the 03f5319 kernel staged).  The loops
//    end at the feature dim D: the padded entries are zero and would only
//    turn a -0.0 sum into +0.0, as the + log w (+0.0) does anyway.  Each
//    mixture's FMAs run in csrc/emission.cuh's order, its logsumexp in
//    mixture order (with selects in place of lse_push's branch, the same
//    operations): log b is bitwise that of a kernel with one mixture at a
//    time.
//  * Frame step: a thread takes its rows two at a time, every load of the
//    two before any store; the insertions into the K slots are selects.
//  * Unigram argmax: warp shuffles, one shared slot a warp, then the lanes
//    reduce the slots by shuffles (the order is total, so any grouping
//    gives the same pair).
//  * Bigram merge (bigram_cross): the per-word exit tokens and the block's
//    top K sources by plane 0 bound every destination's K-th candidate from
//    below, so only the sources whose best candidate can reach that bound
//    are merged (all of them while the exit tokens tie at NEG_INF); thread
//    i serves destination i / G (G the largest power of two with G W <=
//    threads, at most 32) and every G-th of those sources, neighbouring
//    lanes reading neighbouring arcs arc[u][v], and the G lanes of a
//    destination merge their top-K lists by shuffles in (value desc, source
//    asc, plane asc) order.  The order is total, so the result is the
//    03f5319 kernel's serial selection over every source.
//
// What bounds it on the H100.  The emission's FMAs (2 D M per row and
// frame: 4.3e10 flops at the main shape, W=200, S=8, M=4, D=13), the
// serial chain of each frame's phases and barriers (one utterance a block:
// nothing else on the SM hides their latency), and the backpointer writes,
// T K N B int32 (0.82 GB at K = 1, 2.46 GB at K = 3), coalesced because an
// utterance's frame is contiguous in the kernel's (B, T, N, K) layout.
// B = 128 utterances give 128 blocks on 132 SMs: one wave.
//
// Full covariance past D = 16 (the WIDE instances).  The emission is then
// M (D (D + 1) / 2 + D) FMAs a row and frame (dec_w200_full39: ~1.1e12
// flops), which one row a thread ran over all dmax columns of L^T with
// uncoalesced record loads, every block re-reading the vocabulary's records
// (65.6 MB at W = 200, S = 8, M = 4, D = 39, past the 50 MB L2) each chunk.
// There csrc/wide_log_b.cu computes log b of every stepped (utterance,
// frame) first, as z-GEMM blocks, into a (B, T, N) buffer, and each chunk's
// emission becomes a copy of one contiguous run of it into lbs.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kFramesMax = 16;  // frames whose emissions are computed together
constexpr int kMaxK = 4;
constexpr int kRowBlock = 2;  // rows a thread steps at once, loads before stores
constexpr int kMergeBatch = 16;  // arcs a bigram merge lane loads at once
// two parities x two simultaneous reductions x kMaxWarps x (value, index)
constexpr int kRedWords = 2 * 2 * kMaxWarps * 2;

struct DecodeParams {
  const float* feats[kMaxStreams];  // per stream: element (t, d, b) at t*st[0] + d*st[1] + b*st[2]
  long long fst[kMaxStreams][3];
  int dims[kMaxStreams];  // D_p
  int mixes[kMaxStreams];  // M_p
  int offs[kMaxStreams];   // float offset of stream p's records (row-major (row, mixture))
  int n_streams, dmax;
  const float* consts;   // mixture records, csrc/emission.cuh layout
  const float* diag;     // (band+1, N): diag[d][row] = log a[row-d -> row], NEG_INF outside
  const float* arc;      // (N,) per-destination arc at entry rows (unigram) or (W, W) (bigram)
  const float* entry;    // (N,) frame-0 scores
  const float* exitc;    // (N,) 0 at each word's exit row, NEG_INF elsewhere
  const int* exit_row;   // (W,) global exit row of each word (bigram)
  const float* arc_range;  // bigram: the (W, W) arcs' min and max
  const int* lengths;    // (B,)
  float* final_out;      // (B, K, N)
  int* bp;               // (B, T, N, K)
  int T, B, N, S, W, band, bigram, frames;
  int groups;            // bigram: threads a destination (source groups), a power of two <= 32
  // full covariance past D = 16 (WIDE): csrc/wide_log_b.cu's log b, (B,
  // t_end - t_begin, N) from frame t_begin, and the frames [t_begin, t_end)
  // this launch steps, the carry read from final_out where t_begin > 0
  const float* lb;
  int t_begin, t_end;
};

__host__ __device__ inline int r4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory of a block, in floats (ops/kernels/decode.py
// smem_bytes): no features where the emission pass wrote log b (wide).
__host__ __device__ inline size_t smem_floats(int N, int W, int K, int P, int dmax, int bigram,
                                              int F, bool wide) {
  return (size_t)r4(2 * K * N) + r4(F * N) + (wide ? 0 : (size_t)F * P * dmax) + kRedWords +
         (bigram ? (size_t)3 * K * W : 0);
}

struct Arg {
  float v;
  int i;
};

// larger value, then lower index
__device__ __forceinline__ bool better(float v, int i, float w, int j) { return v > w || (v == w && i < j); }

__device__ __forceinline__ void arg_better(Arg& a, float v, int i) {
  if (better(v, i, a.v, a.i)) {
    a.v = v;
    a.i = i;
  }
}

__device__ __forceinline__ Arg arg_init() { return {-INFINITY, INT_MAX}; }

// Block-wide argmax of NR (value, index) pairs at once; every thread gets
// the results.  red: kRedWords floats; parity alternates between calls so
// no second barrier is needed before the slots are reused.
template <int NR>
__device__ __forceinline__ void block_argmax(Arg (&a)[NR], float* red, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, a[r].v, off);
      const int i = __shfl_xor_sync(0xffffffffu, a[r].i, off);
      arg_better(a[r], v, i);
    }
  }
  float* base = red + parity * (2 * kMaxWarps * 2);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      base[(r * kMaxWarps + warp) * 2] = a[r].v;
      base[(r * kMaxWarps + warp) * 2 + 1] = __int_as_float(a[r].i);
    }
  }
  __syncthreads();
  // lane l takes warp l % nw's result, then the lanes reduce by shuffles
  // (the order is total, so any grouping gives the same pair)
  const int src = lane % nw;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    a[r] = {base[(r * kMaxWarps + src) * 2], __float_as_int(base[(r * kMaxWarps + src) * 2 + 1])};
#pragma unroll
    for (int off = kMaxWarps / 2; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, a[r].v, off);
      const int i = __shfl_xor_sync(0xffffffffu, a[r].i, off);
      arg_better(a[r], v, i);
    }
  }
}

// K-slot insertion into descending slots; strict > keeps the first-seen
// candidate on ties (decode_pallas.py _topk_insert / _top2_fold).
template <int K>
__device__ __forceinline__ void slot_insert(float (&vals)[K], int (&ids)[K], float v, int i) {
#pragma unroll
  for (int k = 0; k < K; ++k) {  // selects, not branches: lanes take different slots
    const bool take = v > vals[k];
    const float tv = vals[k];
    const int ti = ids[k];
    vals[k] = take ? v : tv;
    ids[k] = take ? i : ti;
    v = take ? tv : v;
    i = take ? ti : i;
  }
}

// Insertion of (v, i) into a list sorted by (value desc, index asc): the
// lists of the bigram merge, whose indices are unique, so the order is total.
template <int K>
__device__ __forceinline__ void list_insert(float (&vals)[K], int (&ids)[K], float v, int i) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (better(v, i, vals[k], ids[k])) {
      const float tv = vals[k];
      const int ti = ids[k];
      vals[k] = v;
      ids[k] = i;
      v = tv;
      i = ti;
    }
  }
}

// The x and x² halves of one float4 group folded into a mixture's sum, C
// dimensions (csrc/emission.cuh's order: the x terms, then the x² terms;
// x² formed here, the value the 03f5319 kernel staged).
template <int C>
__device__ __forceinline__ void fold_group(float& a, const float4& l, const float4& k, const float4& x) {
  const float xs[4] = {x.x, x.y, x.z, x.w}, ls[4] = {l.x, l.y, l.z, l.w}, ks[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int i = 0; i < C; ++i) a = fmaf(ls[i], xs[i], a);
#pragma unroll
  for (int i = 0; i < C; ++i) a = fmaf(ks[i], xs[i] * xs[i], a);
}

// the last group of a feature dim off the multiples of 4: c in 1..3
__device__ __forceinline__ void fold_tail(float& a, const float4& l, const float4& k, const float4& x, int c) {
  if (c == 1) {
    fold_group<1>(a, l, k, x);
  } else if (c == 2) {
    fold_group<2>(a, l, k, x);
  } else {
    fold_group<3>(a, l, k, x);
  }
}

// One stream's mixture log-likelihoods of `row` for the nf frames of a
// chunk, folded into each frame's online logsumexp (mx, ev) in mixture
// order.  xs holds the chunk's features: frame f, stream q at (f * P + q) *
// dmax, zero-padded to dmax.  Diagonal: two mixtures at a time (the last
// one twice for an odd M, pushed once), x² formed in registers.
template <bool FULL>
__device__ __forceinline__ void stream_log_b(const DecodeParams& p, int q, int row, const float* xs, int nf,
                                             float (&mx)[kFramesMax], float (&ev)[kFramesMax]) {
  const int D = p.dims[q], M = p.mixes[q], dmax = p.dmax, P = p.n_streams;
  const float* xq = xs + q * dmax;
  const int fs = P * dmax;  // floats between two frames of xs
  if constexpr (FULL) {
    // csrc/emission.cuh's records, row-major (row, mixture)
    const int stride = record_stride(dmax, D, true);
    const float* rec = p.consts + p.offs[q] + (size_t)row * M * stride;
    for (int m = 0; m < M; ++m, rec += stride) {
      const float* bg = rec + D * dmax;
      float quad[kFramesMax], acc[kFramesMax];
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f) quad[f] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float g = __ldcg(bg + d);
#pragma unroll
        for (int f = 0; f < kFramesMax; ++f) acc[f] = g;
        for (int e0 = 0; e0 < dmax; e0 += 4) {
          const float4 l = __ldcg(reinterpret_cast<const float4*>(rec + d * dmax + e0));
#pragma unroll
          for (int f = 0; f < kFramesMax; ++f) {
            if (f < nf) {
              const float4 x = *reinterpret_cast<const float4*>(xq + f * fs + e0);
              acc[f] = fmaf(l.x, x.x, acc[f]);
              acc[f] = fmaf(l.y, x.y, acc[f]);
              acc[f] = fmaf(l.z, x.z, acc[f]);
              acc[f] = fmaf(l.w, x.w, acc[f]);
            }
          }
        }
#pragma unroll
        for (int f = 0; f < kFramesMax; ++f) quad[f] = fmaf(acc[f], acc[f], quad[f]);
      }
      const float bias = __ldcg(bg + dmax), lw = __ldcg(bg + dmax + 1);
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f)
        if (f < nf) lse_push(fminf(fmaf(-0.5f, quad[f], bias), kLogGausClamp) + lw, mx[f], ev[f]);
    }
  } else {
    // the diagonal records in row-minor order (ops/kernels/decode.py
    // decode_records): float4 group g of mixture m's x and x² halves at
    // vec[((m G4 + g) 2 + h) N + row], its bias and log w at sc[(2 m + h)
    // N + row], so the rows of a warp read neighbouring 16-byte words
    const int G4 = dmax / 4;
    const float4* vec = reinterpret_cast<const float4*>(p.consts + p.offs[q]);
    const float* sc = p.consts + p.offs[q] + (size_t)M * G4 * 8 * p.N;
    const size_t N = p.N;
    for (int m = 0; m < M; m += 2) {
      const bool two = m + 1 < M;
      const int m1 = two ? m + 1 : m;
      float a0[kFramesMax], a1[kFramesMax];
      const float b0 = __ldcg(sc + 2 * m * N + row), b1 = __ldcg(sc + 2 * m1 * N + row);
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f) {
        a0[f] = b0;
        a1[f] = b1;
      }
      // groups 0 .. D/4 - 1 whole, then D % 4 dimensions of the next: the
      // padded entries (zero weight, zero x) would only turn a -0.0 sum
      // into +0.0, which the + log w (+0.0) below does anyway
      for (int g = 0; 4 * g < D; ++g) {
        const int c = min(D - 4 * g, 4);
        const float4 l0 = __ldcg(vec + ((size_t)(m * G4 + g) * 2) * N + row);
        const float4 k0 = __ldcg(vec + ((size_t)(m * G4 + g) * 2 + 1) * N + row);
        const float4 l1 = __ldcg(vec + ((size_t)(m1 * G4 + g) * 2) * N + row);
        const float4 k1 = __ldcg(vec + ((size_t)(m1 * G4 + g) * 2 + 1) * N + row);
        if (c == 4) {
#pragma unroll
          for (int f = 0; f < kFramesMax; ++f) {
            if (f < nf) {
              const float4 x = *reinterpret_cast<const float4*>(xq + f * fs + 4 * g);
              fold_group<4>(a0[f], l0, k0, x);
              fold_group<4>(a1[f], l1, k1, x);
            }
          }
        } else {
#pragma unroll
          for (int f = 0; f < kFramesMax; ++f) {
            if (f < nf) {
              const float4 x = *reinterpret_cast<const float4*>(xq + f * fs + 4 * g);
              fold_tail(a0[f], l0, k0, x, c);
              fold_tail(a1[f], l1, k1, x, c);
            }
          }
        }
      }
      // 0: log w is folded into the bias
      const float w0 = __ldcg(sc + (2 * m + 1) * N + row), w1 = __ldcg(sc + (2 * m1 + 1) * N + row);
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f) {
        if (f < nf) {
          lse_push_select(a0[f] + w0, mx[f], ev[f]);
          if (two) lse_push_select(a1[f] + w1, mx[f], ev[f]);
        }
      }
    }
  }
}

__device__ __forceinline__ bool is_exit(const DecodeParams& p, int row) {
  return __ldg(p.exitc + row) > -1.f;
}

// The candidate of row r in the unigram exit scans: its token if it is an
// exit row, else NEG_INF.
__device__ __forceinline__ float exit_token(const DecodeParams& p, const float* plane, int r) {
  return is_exit(p, r) ? plane[r] : kNegInf;
}

// The K cross-word candidates of a unigram frame, the same for every
// destination: values xv (before the arc) and pointers xbp.  Rows are
// scanned kRowBlock at a time, their loads first.
template <int K>
__device__ __forceinline__ void unigram_cross(const DecodeParams& p, const float* prev, float* red,
                                              int& round, float (&xv)[K], int (&xbp)[K]) {
  const int N = p.N, nt = blockDim.x;
  if constexpr (K == 1) {
    Arg a[1] = {arg_init()};
    for (int r0 = threadIdx.x; r0 < N; r0 += kRowBlock * nt) {
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        const int r = r0 + i * nt;
        if (r < N) arg_better(a[0], exit_token(p, prev, r), r);
      }
    }
    block_argmax<1>(a, red, round++ & 1);
    xv[0] = a[0].v;
    xbp[0] = a[0].i;
  } else if constexpr (K == 2) {
    // the 2-best kernel: best of plane 0; then plane 1's best against
    // plane 0's runner-up (its best row excluded), plane 1 winning a tie.
    // Plane 1 <= plane 0 row by row, so plane 0 always holds the best.
    Arg a0[1] = {arg_init()};
    for (int r0 = threadIdx.x; r0 < N; r0 += kRowBlock * nt) {
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        const int r = r0 + i * nt;
        if (r < N) arg_better(a0[0], exit_token(p, prev, r), r);
      }
    }
    block_argmax<1>(a0, red, round++ & 1);
    const int am0 = a0[0].i;
    Arg a1[2] = {arg_init(), arg_init()};
    for (int r0 = threadIdx.x; r0 < N; r0 += kRowBlock * nt) {
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        const int r = r0 + i * nt;
        if (r < N) {
          const bool ex = is_exit(p, r);
          arg_better(a1[0], ex ? prev[N + r] : kNegInf, r);
          arg_better(a1[1], (ex && r != am0) ? prev[r] : kNegInf, r);
        }
      }
    }
    block_argmax<2>(a1, red, round++ & 1);
    xv[0] = a0[0].v;
    xbp[0] = am0 * 2;
    if (a1[0].v >= a1[1].v) {
      xv[1] = a1[0].v;
      xbp[1] = a1[0].i * 2 + 1;
    } else {
      xv[1] = a1[1].v;
      xbp[1] = a1[1].i * 2;
    }
  } else {
    // take counters: round tt takes the best head token (a row's next
    // plane), lowest row first
    int taken[K];
#pragma unroll
    for (int j = 0; j < K; ++j) taken[j] = -1;
#pragma unroll
    for (int tt = 0; tt < K; ++tt) {
      Arg a[1] = {arg_init()};
      for (int r = threadIdx.x; r < N; r += nt) {
        int h = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) h += (j < tt && taken[j] == r) ? 1 : 0;
        arg_better(a[0], (h < K && is_exit(p, r)) ? prev[h * N + r] : kNegInf, r);
      }
      block_argmax<1>(a, red, round++ & 1);
      int sel = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) sel += (j < tt && taken[j] == a[0].i) ? 1 : 0;
      taken[tt] = a[0].i;
      xv[tt] = a[0].v;
      xbp[tt] = a[0].i * K + sel;
    }
  }
}

// The list (vals, ids), sorted by (value desc, index asc), merged with the
// lists of the lanes `off`, 2 off, ... below 32 / 2 away: every lane of a
// group of 2 `top` lanes ends with their merged list.
template <int K>
__device__ __forceinline__ void lanes_merge(float (&vals)[K], int (&ids)[K], int top) {
  for (int off = top / 2; off > 0; off >>= 1) {
    float ov[K];
    int oi[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ov[k] = __shfl_xor_sync(0xffffffffu, vals[k], off);
      oi[k] = __shfl_xor_sync(0xffffffffu, ids[k], off);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) list_insert<K>(vals, ids, ov[k], oi[k]);
  }
}

// Bigram cross-word candidates: per destination word v, K values and
// pointers into xvw / xbpw ((K, W) each).  ew: (K, W) scratch; red: the
// warps' top-K source lists; survivors: W + 1 ints of scratch (the frame's
// new carry buffer, written only after this).
//  * Exits: ew[k][u] = max over word u's rows of carry[k] + exit_col, and
//    the block's top K sources u_1..u_K by ew[0] (value desc, source asc).
//  * Pruning: every destination v has the K candidates ew[0][u_j] +
//    arc[u_j][v] >= L = ew[0][u_K] + min arc (rounding is monotonic), so
//    its K-th best is >= L; a source u with ew[0][u] + max arc < L has
//    every candidate (any plane: planes are sorted) strictly below L and
//    enters no destination's top K.  Warp 0 lists the other sources in
//    ascending order (at least u_1..u_K).
//  * Merge: thread i serves destination i / G and every G-th listed source
//    from i % G; each lane keeps its own top K, and the G lanes of a
//    destination merge them by shuffles.  The order is total, so the result
//    is the 03f5319 kernel's serial selection over every source.
template <int K>
__device__ __forceinline__ void bigram_cross(const DecodeParams& p, const float* prev, float* ew, float* red,
                                             int* survivors, float* xvw, int* xbpw) {
  const int N = p.N, S = p.S, W = p.W, nt = blockDim.x, G = p.groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = nt >> 5;
  float tv[K];
  int ti[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    tv[k] = -INFINITY;
    ti[k] = INT_MAX;
  }
  for (int i = threadIdx.x; i < K * W; i += nt) {
    const int kk = i / W, u = i - kk * W;
    const float* c = prev + kk * N + u * S;
    const float* ec = p.exitc + u * S;
    float e = c[0] + __ldg(ec);
    for (int s0 = 1; s0 < S; s0 += 8) {
#pragma unroll
      for (int s = s0; s < s0 + 8; ++s)
        if (s < S) e = fmaxf(e, c[s] + __ldg(ec + s));
    }
    ew[i] = e;
    if (kk == 0) list_insert<K>(tv, ti, e, u);
  }
  lanes_merge<K>(tv, ti, 32);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      red[(warp * K + k) * 2] = tv[k];
      red[(warp * K + k) * 2 + 1] = __int_as_float(ti[k]);
    }
  }
  __syncthreads();
  if (warp == 0) {
    // lane l takes warp l's list (a list must not enter twice); the
    // block's top K sources
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tv[k] = (lane < nw) ? red[(lane * K + k) * 2] : -INFINITY;
      ti[k] = (lane < nw) ? __float_as_int(red[(lane * K + k) * 2 + 1]) : INT_MAX;
    }
    lanes_merge<K>(tv, ti, 32);
    const float L = (ti[K - 1] != INT_MAX) ? tv[K - 1] + __ldg(p.arc_range) : -INFINITY;
    const float hi = __ldg(p.arc_range + 1);
    int n = 0;
    for (int c0 = 0; c0 < W; c0 += 32) {
      const int u = c0 + lane;
      const bool keep = u < W && !(ew[u] + hi < L);
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) survivors[n + __popc(m & ((1u << lane) - 1u))] = u;
      n += __popc(m);
    }
    if (lane == 0) survivors[W] = n;
  }
  __syncthreads();
  const int ns = survivors[W];
  // thread i: destination v = i / G, listed sources g, g + G, ... with g = i
  // % G; the G lanes of a destination are neighbours, and a warp's lanes all
  // run the loop the same number of times (span and nt are multiples of 32)
  const int span = (W * G + 31) / 32 * 32;
  for (int i = threadIdx.x; i < span; i += nt) {
    const int g = i % G, v = min(i / G, W - 1);
    const float* arc = p.arc + v;  // arc[u * W]: source u, this destination
    // K <= 2: the top K of plane 0 by (value desc, source asc); K >= 3: the
    // top K of every (source, plane) by (value desc, source asc, plane asc),
    // index u * K + kk.  A source's planes are sorted, so its later planes
    // cannot enter once one fails
    float lv[K];
    int li[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      lv[k] = -INFINITY;
      li[k] = INT_MAX;
    }
    // the arcs come from L2 (past L1, which keeps the per-row constants of
    // the frame step) kMergeBatch sources at a time
    for (int j0 = g; j0 < ns; j0 += kMergeBatch * G) {
      int us[kMergeBatch];
      float a[kMergeBatch];
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int jj = j0 + j * G;
        us[j] = (jj < ns) ? survivors[jj] : -1;
        a[j] = (us[j] >= 0) ? __ldcg(arc + (size_t)us[j] * W) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kMergeBatch; ++j) {
        const int u = us[j];
        // a lane visits its candidates in ascending index, so strict > on
        // the value alone keeps its list in (value desc, index asc) order
        if (u >= 0) {
          if constexpr (K <= 2) {
            slot_insert<K>(lv, li, ew[u] + a[j], u);
          } else {
#pragma unroll
            for (int kk = 0; kk < K; ++kk) {
              const float c = ew[kk * W + u] + a[j];
              if (!(c > lv[K - 1])) break;
              slot_insert<K>(lv, li, c, u * K + kk);
            }
          }
        }
      }
    }
    lanes_merge<K>(lv, li, G);
    if (g != 0 || i >= W * G) continue;
    if constexpr (K == 1) {
      xvw[v] = lv[0];
      xbpw[v] = __ldg(p.exit_row + li[0]);
    } else if constexpr (K == 2) {
      // the runner-up: the best source but the best one, against the best
      // source masked to NEG_INF (the 03f5319 kernel's serial search
      // started from source 0 with the best one masked, strict >), then
      // against the best source's own plane 1, the runner-up winning a tie
      const int ub = li[0];
      float s1x = lv[1];
      int asr = li[1];
      if (better(kNegInf, ub, s1x, asr)) {
        s1x = kNegInf;
        asr = ub;
      }
      float c2b = ew[W + ub] + __ldcg(arc + (size_t)ub * W);
      if (W > 1) c2b = fmaxf(c2b, kNegInf);
      xvw[v] = lv[0];
      xbpw[v] = __ldg(p.exit_row + ub) * 2;
      if (s1x >= c2b) {
        xvw[W + v] = s1x;
        xbpw[W + v] = __ldg(p.exit_row + asr) * 2;
      } else {
        xvw[W + v] = c2b;
        xbpw[W + v] = __ldg(p.exit_row + ub) * 2 + 1;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xvw[k * W + v] = lv[k];
        xbpw[k * W + v] = __ldg(p.exit_row + li[k] / K) * K + li[k] % K;
      }
    }
  }
  __syncthreads();
}

// Row r of a frame t >= 1: its K new tokens and pointers from the carry
// prev, log b lbr and the frame's cross-word candidates.
template <int K>
__device__ __forceinline__ void row_step(const DecodeParams& p, int r, const float* prev, float lbr,
                                         const float (&xv)[K], const int (&xbp)[K], const float* xvw,
                                         const int* xbpw, float (&nv)[K], int (&nbp)[K]) {
  const int N = p.N, S = p.S, W = p.W, band = p.band;
  const int w = r / S, rin = r - w * S;
  if constexpr (K == 1) {
    float best = prev[r] + __ldg(p.diag + r);
    int bp = r;
    for (int d = 1; d <= band; ++d) {
      const float sh = (rin >= d) ? prev[r - d] : kNegInf;
      const float c = sh + __ldg(p.diag + (size_t)d * N + r);
      if (c > best) {
        best = c;
        bp = r - d;
      }
    }
    float cross;
    int bpx;
    if (p.bigram) {
      cross = (rin == 0) ? xvw[w] : kNegInf;
      bpx = xbpw[w];
    } else {
      cross = xv[0] + __ldg(p.arc + r);  // NEG_INF arc off the entry rows
      bpx = xbp[0];
    }
    if (cross > best) {
      best = cross;
      bp = bpx;
    }
    nv[0] = fmaxf(best + lbr, kNegInf);
    nbp[0] = bp;
  } else {
    float vals[K];
    int ids[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      vals[k] = kNegInf;
      ids[k] = 0;
    }
    for (int d = 0; d <= band; ++d) {
      const float dg = __ldg(p.diag + (size_t)d * N + r);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float sh = (d == 0) ? prev[kk * N + r] : ((rin >= d) ? prev[kk * N + r - d] : kNegInf);
        const float v = sh + dg;
        if (K == 2 && d == 0 && kk == 0) {
          vals[0] = v;  // the 2-best kernel seeds its best slot with the first candidate
        } else {
          slot_insert<K>(vals, ids, v, d * K + kk);
        }
      }
    }
    const int nw = (band + 1) * K;
    const float arc_r = p.bigram ? 0.f : __ldg(p.arc + r);
#pragma unroll
    for (int tt = 0; tt < K; ++tt) {
      float v;
      if (p.bigram) {
        v = (rin == 0) ? xvw[tt * W + w] : kNegInf;
      } else {
        v = (arc_r > kNegInf) ? xv[tt] + arc_r : kNegInf;
      }
      slot_insert<K>(vals, ids, v, nw + tt);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      nv[k] = fmaxf(vals[k] + lbr, kNegInf);
      const int pid = ids[k];
      int bp = 0;
      if (pid < nw) {
        bp = (r - pid / K) * K + pid % K;
      } else {
#pragma unroll
        for (int tt = 0; tt < K; ++tt)
          if (pid == nw + tt) bp = p.bigram ? xbpw[tt * W + w] : xbp[tt];
      }
      nbp[k] = bp;
    }
  }
}

// One frame t >= 1 of utterance b: reads carry buffer prev, writes cur and
// the frame's pointers bpt (N * K ints).
template <int K>
__device__ __forceinline__ void decode_step(const DecodeParams& p, const float* prev, float* cur,
                                            const float* lb, int* bpt, float* red, int& round,
                                            float* ew, float* xvw, int* xbpw) {
  const int N = p.N, nt = blockDim.x;
  float xv[K];
  int xbp[K];
  if (p.bigram) {
    bigram_cross<K>(p, prev, ew, red, reinterpret_cast<int*>(cur), xvw, xbpw);
  } else {
    unigram_cross<K>(p, prev, red, round, xv, xbp);
  }
  for (int r0 = threadIdx.x; r0 < N; r0 += kRowBlock * nt) {
    float nv[kRowBlock][K];
    int nbp[kRowBlock][K];
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) {
      const int r = r0 + i * nt;
      if (r < N) row_step<K>(p, r, prev, lb[r], xv, xbp, xvw, xbpw, nv[i], nbp[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) {
      const int r = r0 + i * nt;
      if (r < N) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cur[k * N + r] = nv[i][k];
          bpt[r * K + k] = nbp[i][k];
        }
      }
    }
  }
  __syncthreads();
}

// WIDE (full covariance past D = 16): csrc/wide_log_b.cu has written log b
// before the launch, each chunk's (nf, N) of it is one contiguous run that
// the block copies into lbs in place of the emission, no features are
// staged, and the launch steps the frames [t_begin, t_end) of the call
// (ops/kernels/decode.py splits a call whose log b passes
// common.WIDE_LOG_B_BYTES), the carry read back from final_out where
// t_begin > 0.  The recursion, the cross-word merges and the pointers are
// the same code on the same log b.
template <int K, bool FULL, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads) word_loop_decode_kernel(const DecodeParams p) {
  static_assert(FULL || !WIDE, "the emission pass is full covariance only");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, W = p.W, P = p.n_streams, dmax = p.dmax, F = p.frames;
  const int nt = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  float* carry = smem;               // [2][K][N]
  float* lbs = carry + r4(2 * K * N);  // [F][N] log b of the chunk's frames
  float* xs = lbs + r4(F * N);        // [F][P][dmax] features (none when WIDE)
  float* red = xs + (WIDE ? 0 : F * P * dmax);  // kRedWords
  float* ew = red + kRedWords;        // bigram: [K][W] exit tokens per word
  float* xvw = ew + K * W;            // bigram: [K][W] cross values
  int* xbpw = reinterpret_cast<int*>(xvw + K * W);  // bigram: [K][W] cross pointers

  const int tend = min(max(p.lengths[b], 1), p.T);  // frames stepped; frame 0 always
  int* bpb = p.bp + (size_t)b * p.T * N * K;
  int round = 0;
  const int t_first = WIDE ? p.t_begin : 0, t_stop = WIDE ? min(tend, p.t_end) : tend;
  if (WIDE && t_first > 0 && t_first < t_stop) {  // a later launch of one call: the carry from final_out
    for (int i = tid; i < K * N; i += nt) carry[((t_first - 1) & 1) * K * N + i] = p.final_out[(size_t)b * K * N + i];
  }
  for (int t0 = t_first; t0 < t_stop; t0 += F) {
    const int nf = min(F, t_stop - t0);
    if constexpr (WIDE) {
      // the chunk's log b, one run of nf N floats; the previous chunk's
      // frames have read lbs: every thread passed a frame's barrier since
      const float* src = p.lb + ((size_t)b * (p.t_end - p.t_begin) + (t0 - p.t_begin)) * N;
      if ((N & 3) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(lbs);
        for (int i = tid; i < nf * N / 4; i += nt) d4[i] = __ldcs(s4 + i);
      } else {
        for (int i = tid; i < nf * N; i += nt) lbs[i] = __ldcs(src + i);
      }
      __syncthreads();
    } else {
      // the previous chunk's emission has read xs: every thread passed a frame's barrier since
      for (int i = tid; i < nf * P * dmax; i += nt) {
        const int e = i % dmax, fq = i / dmax, q = fq % P, f = fq / P;
        float x = 0.f;
        if (e < p.dims[q])
          x = __ldg(p.feats[q] + (t0 + f) * p.fst[q][0] + e * p.fst[q][1] + b * p.fst[q][2]);
        xs[i] = x;
      }
      __syncthreads();
      // log b = ((0 + s_0) + s_1) + ... over the streams; 0 + s_0 is s_0 (a
      // logsumexp is never -0.0), so stream 0 is stored as it is
      for (int r = tid; r < N; r += nt) {
        for (int q = 0; q < P; ++q) {
          float mx[kFramesMax], ev[kFramesMax];
#pragma unroll
          for (int f = 0; f < kFramesMax; ++f) {
            mx[f] = kNegInf;
            ev[f] = 0.f;
          }
          stream_log_b<FULL>(p, q, r, xs, nf, mx, ev);
#pragma unroll
          for (int f = 0; f < kFramesMax; ++f) {
            if (f < nf) {
              const float s = lse_value(mx[f], ev[f]);
              lbs[f * N + r] = (q == 0) ? s : lbs[f * N + r] + s;
            }
          }
        }
      }
      __syncthreads();
    }
    for (int f = 0; f < nf; ++f) {
      const int t = t0 + f;
      float* cur = carry + (t & 1) * K * N;
      int* bpt = bpb + (size_t)t * N * K;
      if (t == 0) {
        for (int r = tid; r < N; r += nt) {
          cur[r] = fmaxf(__ldg(p.entry + r) + lbs[r], kNegInf);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (k > 0) cur[k * N + r] = kNegInf;
            bpt[r * K + k] = r * K + k;
          }
        }
        __syncthreads();
        continue;
      }
      decode_step<K>(p, carry + ((t - 1) & 1) * K * N, cur, lbs + f * N, bpt, red, round, ew, xvw,
                     xbpw);
    }
  }
  // frames past the length: identity pointers, the carry kept
  const int fk = N * K;
  const int id_lo = WIDE ? max(tend, t_first) : tend, id_hi = WIDE ? p.t_end : p.T;
  for (size_t i = (size_t)id_lo * fk + tid; i < (size_t)id_hi * fk; i += nt) bpb[i] = (int)(i % fk);
  if (WIDE && t_first >= t_stop) return;  // no frame stepped: final_out holds the carry
  const float* last = carry + ((t_stop - 1) & 1) * K * N;
  for (int i = tid; i < K * N; i += nt) p.final_out[(size_t)b * K * N + i] = last[i];
}

template <int K, bool FULL, bool WIDE>
cudaError_t launch(const DecodeParams& p, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = word_loop_decode_kernel<K, FULL, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.B, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool FULL, bool WIDE>
cudaError_t dispatch(const DecodeParams& p, int K, int threads, size_t smem, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<1, FULL, WIDE>(p, threads, smem, stream);
    case 2: return launch<2, FULL, WIDE>(p, threads, smem, stream);
    case 3: return launch<3, FULL, WIDE>(p, threads, smem, stream);
    case 4: return launch<4, FULL, WIDE>(p, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// feats / fstrides (3 per stream: t, d, b, in floats) / dims / mixes / offs
// are host arrays of n_streams entries; every pointer they hold and every
// other pointer argument is a device pointer.  groups: threads a bigram
// destination, a power of two <= 32 with groups * W <= threads (1 for a
// unigram).  Full covariance at dmax 32 or 64 (the WIDE instances): lb is
// csrc/wide_log_b.cu's log b, (B, t_end - t_begin, N), the launch steps the
// frames [t_begin, t_end) and reads the carry from final_out where t_begin
// > 0, consts and the features are not read.  Otherwise lb is null,
// t_begin = 0 and t_end = T.
int srhmm_word_loop_decode(const void* const* feats, const long long* fstrides, const int* dims,
                           const int* mixes, const int* offs, int n_streams, int dmax,
                           const void* consts, const void* diag, const void* arc, const void* entry,
                           const void* exitc, const void* exit_row, const void* arc_range, const void* lengths,
                           void* final_out, void* bp, int T, int B, int N, int S, int band,
                           int bigram, int K, int full, int frames, int threads, int groups, const void* lb,
                           int t_begin, int t_end, int device, void* stream) {
  const bool wide = full && dmax > 16;
  if (n_streams < 1 || n_streams > kMaxStreams || threads < 32 || threads > kMaxThreads || (bigram && S < 2) ||
      threads % 32 != 0 || K < 1 || K > kMaxK || frames < 1 || frames > kFramesMax ||
      dmax < 4 || dmax % 4 != 0 || B < 1 || T < 1 || S < 1 || N < S || N % S != 0 || band < 0 ||
      groups < 1 || groups > 32 || (groups & (groups - 1)) != 0 || (groups > 1 && groups * (N / S) > threads) ||
      wide != (lb != nullptr) || t_begin < 0 || t_end <= t_begin || t_end > T ||
      (!wide && (t_begin != 0 || t_end != T))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  DecodeParams p = {};
  for (int i = 0; i < n_streams; ++i) {
    p.feats[i] = static_cast<const float*>(feats[i]);
    for (int j = 0; j < 3; ++j) p.fst[i][j] = fstrides[3 * i + j];
    p.dims[i] = dims[i];
    p.mixes[i] = mixes[i];
    p.offs[i] = offs[i];
    if (dims[i] < 1 || dims[i] > dmax || mixes[i] < 1) return (int)cudaErrorInvalidValue;
  }
  p.n_streams = n_streams;
  p.dmax = dmax;
  p.consts = static_cast<const float*>(consts);
  p.diag = static_cast<const float*>(diag);
  p.arc = static_cast<const float*>(arc);
  p.entry = static_cast<const float*>(entry);
  p.exitc = static_cast<const float*>(exitc);
  p.exit_row = static_cast<const int*>(exit_row);
  p.arc_range = static_cast<const float*>(arc_range);
  p.lengths = static_cast<const int*>(lengths);
  p.final_out = static_cast<float*>(final_out);
  p.bp = static_cast<int*>(bp);
  p.T = T;
  p.B = B;
  p.N = N;
  p.S = S;
  p.W = N / S;
  p.band = band;
  p.bigram = bigram;
  p.frames = frames;
  p.groups = groups;
  p.lb = static_cast<const float*>(lb);
  p.t_begin = t_begin;
  p.t_end = t_end;
  const size_t smem = sizeof(float) * smem_floats(N, p.W, K, n_streams, dmax, bigram, frames, wide);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) return (int)dispatch<true, true>(p, K, threads, smem, st);
  return (int)(full ? dispatch<true, false>(p, K, threads, smem, st) : dispatch<false, false>(p, K, threads, smem, st));
}

}  // extern "C"
