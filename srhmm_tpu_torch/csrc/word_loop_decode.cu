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
// buffer (t-1)&1 and writes t&1, with one __syncthreads for the cross-word
// phase and one at the end of the frame (unigram K-best adds one per
// reduction round).  The cross-word selections are block-wide
// (value desc, row asc) argmax reductions: warp shuffles, then per-warp
// results in double-buffered shared slots, reduced by every thread, so the
// selection is the same in every thread without a second barrier.  Bigram:
// per-word exit tokens in shared memory, then one thread per destination
// merges its K best over all sources, reading the (W, W) arc from L2.  The
// time loop runs inside the kernel: one launch per batch.  Every product is
// an fp32 fmaf on the CUDA cores (no TF32, no tensor cores).
//
// What bounds it on the H100.  The mixture records do not fit shared memory
// at the main shape (W=200, S=8, M=4, D=13: 6,400 records, 0.87 MB) and are
// read from L2, once per block and CHUNK of up to 8 frames: the emissions
// of a chunk are computed together (each record is loaded once into
// registers and applied to every frame of the chunk) into shared memory,
// then the chunk's frames are stepped.  Per frame that is ~110 KB of L2
// reads per block instead of 0.87 MB.  What is left: the emission FMAs
// (2 D M per row and frame: 4.3e10 flops at the main shape), the serial
// per-frame barriers, and the backpointer writes, T K N B int32 (0.82 GB
// at K = 1, 2.46 GB at K = 3), coalesced because an utterance's frame is
// contiguous in the kernel's (B, T, N, K) layout.  B = 128 utterances give
// 128 blocks on 132 SMs: one wave.  Later work: several utterances per
// block sharing the record reads, arcs in shared memory, tensor-core
// emission at fp32 precision.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kFramesMax = 8;  // frames whose emissions are computed together
constexpr int kMaxK = 4;
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
  const int* lengths;    // (B,)
  float* final_out;      // (B, K, N)
  int* bp;               // (B, T, N, K)
  int T, B, N, S, W, band, bigram, frames;
};

__host__ __device__ inline int r4(int x) { return (x + 3) & ~3; }

// Dynamic shared memory of a block, in floats (ops/kernels/decode.py smem_bytes).
__host__ __device__ inline size_t smem_floats(int N, int W, int K, int P, int dmax, int bigram,
                                              int F) {
  return (size_t)r4(2 * K * N) + r4(F * N) + (size_t)F * P * 2 * dmax + kRedWords +
         (bigram ? (size_t)3 * K * W : 0);
}

struct Arg {
  float v;
  int i;
};

// larger value, then lower index
__device__ __forceinline__ void arg_better(Arg& a, float v, int i) {
  if (v > a.v || (v == a.v && i < a.i)) {
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
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    Arg acc = arg_init();
    for (int w = 0; w < nw; ++w)
      arg_better(acc, base[(r * kMaxWarps + w) * 2], __float_as_int(base[(r * kMaxWarps + w) * 2 + 1]));
    a[r] = acc;
  }
}

// K-slot insertion into descending slots; strict > keeps the first-seen
// candidate on ties (decode_pallas.py _topk_insert / _top2_fold).
template <int K>
__device__ __forceinline__ void slot_insert(float (&vals)[K], int (&ids)[K], float v, int i) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (v > vals[k]) {
      const float tv = vals[k];
      const int ti = ids[k];
      vals[k] = v;
      ids[k] = i;
      v = tv;
      i = ti;
    }
  }
}

// One stream's per-state mixture logsumexp for the nf frames of a chunk,
// added into lbv.  xs holds the chunk's features: frame f, stream q at
// (f * P + q) * 2 * dmax, x then x^2, zero-padded to dmax.
template <bool FULL>
__device__ __forceinline__ void stream_log_b(const DecodeParams& p, int q, int row, const float* xs,
                                             int nf, float (&lbv)[kFramesMax]) {
  const int D = p.dims[q], M = p.mixes[q], dmax = p.dmax, P = p.n_streams;
  const int stride = record_stride(dmax, D, FULL);
  const float* rec = p.consts + p.offs[q] + (size_t)row * M * stride;
  float mx[kFramesMax], ev[kFramesMax], acc[kFramesMax];
#pragma unroll
  for (int f = 0; f < kFramesMax; ++f) {
    mx[f] = kNegInf;
    ev[f] = 0.f;
  }
  for (int m = 0; m < M; ++m, rec += stride) {
    if constexpr (FULL) {
      const float* bg = rec + D * dmax;
      float quad[kFramesMax];
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f) quad[f] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float g = __ldg(bg + d);
#pragma unroll
        for (int f = 0; f < kFramesMax; ++f) acc[f] = g;
        for (int e0 = 0; e0 < dmax; e0 += 4) {
          const float4 l = __ldg(reinterpret_cast<const float4*>(rec + d * dmax + e0));
#pragma unroll
          for (int f = 0; f < kFramesMax; ++f) {
            if (f < nf) {
              const float4 x = *reinterpret_cast<const float4*>(xs + (f * P + q) * 2 * dmax + e0);
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
      const float bias = __ldg(bg + dmax), lw = __ldg(bg + dmax + 1);
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f)
        if (f < nf) lse_push(fminf(fmaf(-0.5f, quad[f], bias), kLogGausClamp) + lw, mx[f], ev[f]);
    } else {
      const float bias = __ldg(rec + 2 * dmax);
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f) acc[f] = bias;
      for (int e0 = 0; e0 < dmax; e0 += 4) {
        const float4 l = __ldg(reinterpret_cast<const float4*>(rec + e0));
        const float4 k = __ldg(reinterpret_cast<const float4*>(rec + dmax + e0));
#pragma unroll
        for (int f = 0; f < kFramesMax; ++f) {
          if (f < nf) {
            const float* xf = xs + (f * P + q) * 2 * dmax;
            const float4 x = *reinterpret_cast<const float4*>(xf + e0);
            const float4 x2 = *reinterpret_cast<const float4*>(xf + dmax + e0);
            acc[f] = fmaf(l.x, x.x, acc[f]);
            acc[f] = fmaf(l.y, x.y, acc[f]);
            acc[f] = fmaf(l.z, x.z, acc[f]);
            acc[f] = fmaf(l.w, x.w, acc[f]);
            acc[f] = fmaf(k.x, x2.x, acc[f]);
            acc[f] = fmaf(k.y, x2.y, acc[f]);
            acc[f] = fmaf(k.z, x2.z, acc[f]);
            acc[f] = fmaf(k.w, x2.w, acc[f]);
          }
        }
      }
      const float lw = __ldg(rec + 2 * dmax + 1);  // 0: log w is folded into the bias
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f)
        if (f < nf) lse_push(acc[f] + lw, mx[f], ev[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < kFramesMax; ++f)
    if (f < nf) lbv[f] += lse_value(mx[f], ev[f]);
}

__device__ __forceinline__ bool is_exit(const DecodeParams& p, int row) {
  return __ldg(p.exitc + row) > -1.f;
}

// The K cross-word candidates of a unigram frame, the same for every
// destination: values xv (before the arc) and pointers xbp.
template <int K>
__device__ __forceinline__ void unigram_cross(const DecodeParams& p, const float* prev, float* red,
                                              int& round, float (&xv)[K], int (&xbp)[K]) {
  const int N = p.N, nt = blockDim.x;
  if constexpr (K == 1) {
    Arg a[1] = {arg_init()};
    for (int r = threadIdx.x; r < N; r += nt) arg_better(a[0], is_exit(p, r) ? prev[r] : kNegInf, r);
    block_argmax<1>(a, red, round++ & 1);
    xv[0] = a[0].v;
    xbp[0] = a[0].i;
  } else if constexpr (K == 2) {
    // the 2-best kernel: best of plane 0; then plane 1's best against
    // plane 0's runner-up (its best row excluded), plane 1 winning a tie.
    // Plane 1 <= plane 0 row by row, so plane 0 always holds the best.
    Arg a0[1] = {arg_init()};
    for (int r = threadIdx.x; r < N; r += nt) arg_better(a0[0], is_exit(p, r) ? prev[r] : kNegInf, r);
    block_argmax<1>(a0, red, round++ & 1);
    const int am0 = a0[0].i;
    Arg a1[2] = {arg_init(), arg_init()};
    for (int r = threadIdx.x; r < N; r += nt) {
      const bool ex = is_exit(p, r);
      arg_better(a1[0], ex ? prev[N + r] : kNegInf, r);
      arg_better(a1[1], (ex && r != am0) ? prev[r] : kNegInf, r);
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

// Bigram cross-word candidates: per destination word v, K values and
// pointers into xvw / xbpw ((K, W) each).  ew: (K, W) scratch.
template <int K>
__device__ __forceinline__ void bigram_cross(const DecodeParams& p, const float* prev, float* ew,
                                             float* xvw, int* xbpw) {
  const int N = p.N, S = p.S, W = p.W, nt = blockDim.x;
  for (int i = threadIdx.x; i < K * W; i += nt) {
    const int kk = i / W, u = i - kk * W;
    const float* c = prev + kk * N + u * S;
    const float* ec = p.exitc + u * S;
    float e = c[0] + __ldg(ec);
    for (int s = 1; s < S; ++s) e = fmaxf(e, c[s] + __ldg(ec + s));
    ew[i] = e;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < W; v += nt) {
    const float* arc = p.arc + v;  // arc[u * W]: source u, this destination
    if constexpr (K == 1 || K == 2) {
      float best = ew[0] + __ldg(arc);
      int ub = 0;
      for (int u = 1; u < W; ++u) {
        const float c = ew[u] + __ldg(arc + (size_t)u * W);
        if (c > best) {
          best = c;
          ub = u;
        }
      }
      if constexpr (K == 1) {
        xvw[v] = best;
        xbpw[v] = __ldg(p.exit_row + ub);
      } else {
        // runner-up source's plane 0 (best source masked to NEG_INF) against
        // the best source's own plane 1, the runner-up winning a tie
        float s1x = (ub == 0) ? kNegInf : ew[0] + __ldg(arc);
        int asr = 0;
        for (int u = 1; u < W; ++u) {
          const float c = (u == ub) ? kNegInf : ew[u] + __ldg(arc + (size_t)u * W);
          if (c > s1x) {
            s1x = c;
            asr = u;
          }
        }
        float c2b = ew[W + ub] + __ldg(arc + (size_t)ub * W);
        if (W > 1) c2b = fmaxf(c2b, kNegInf);
        xvw[v] = best;
        xbpw[v] = __ldg(p.exit_row + ub) * 2;
        if (s1x >= c2b) {
          xvw[W + v] = s1x;
          xbpw[W + v] = __ldg(p.exit_row + asr) * 2;
        } else {
          xvw[W + v] = c2b;
          xbpw[W + v] = __ldg(p.exit_row + ub) * 2 + 1;
        }
      }
    } else {
      // the K best of all (source, plane) pairs, lowest source then lowest
      // plane on ties (the take counters' order): a stable insertion that
      // shifts the tokens below the new one down, so tokens that tie keep
      // their order (slot_insert's bubble would not).  A source's planes are
      // sorted, so its later planes cannot enter once one fails
      float lv[K];
      int lc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        lv[k] = -INFINITY;
        lc[k] = 0;
      }
      for (int u = 0; u < W; ++u) {
        const float a = __ldg(arc + (size_t)u * W);
        const int base = __ldg(p.exit_row + u) * K;
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
          const float c = ew[kk * W + u] + a;
          if (!(c > lv[K - 1])) break;
#pragma unroll
          for (int k = K - 1; k >= 0; --k) {
            if (k > 0 && c > lv[k - 1]) {
              lv[k] = lv[k - 1];
              lc[k] = lc[k - 1];
            } else if (c > lv[k]) {
              lv[k] = c;
              lc[k] = base + kk;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        xvw[k * W + v] = lv[k];
        xbpw[k * W + v] = lc[k];
      }
    }
  }
  __syncthreads();
}

// One frame t >= 1 of utterance b: reads carry buffer prev, writes cur and
// the frame's pointers bpt (N * K ints).
template <int K>
__device__ __forceinline__ void decode_step(const DecodeParams& p, const float* prev, float* cur,
                                            const float* lb, int* bpt, float* red, int& round,
                                            float* ew, float* xvw, int* xbpw) {
  const int N = p.N, S = p.S, W = p.W, band = p.band, nt = blockDim.x;
  float xv[K];
  int xbp[K];
  if (p.bigram) {
    bigram_cross<K>(p, prev, ew, xvw, xbpw);
  } else {
    unigram_cross<K>(p, prev, red, round, xv, xbp);
  }
  for (int r = threadIdx.x; r < N; r += nt) {
    const int w = r / S, rin = r - w * S;
    const float lbr = lb[r];
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
      cur[r] = fmaxf(best + lbr, kNegInf);
      bpt[r] = bp;
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
        cur[k * N + r] = fmaxf(vals[k] + lbr, kNegInf);
        const int pid = ids[k];
        int bp = 0;
        if (pid < nw) {
          bp = (r - pid / K) * K + pid % K;
        } else {
#pragma unroll
          for (int tt = 0; tt < K; ++tt)
            if (pid == nw + tt) bp = p.bigram ? xbpw[tt * W + w] : xbp[tt];
        }
        bpt[r * K + k] = bp;
      }
    }
  }
  __syncthreads();
}

template <int K, bool FULL>
__global__ void __launch_bounds__(kMaxThreads) word_loop_decode_kernel(const DecodeParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int N = p.N, W = p.W, P = p.n_streams, dmax = p.dmax, F = p.frames;
  const int nt = blockDim.x, tid = threadIdx.x, b = blockIdx.x;
  float* carry = smem;               // [2][K][N]
  float* lbs = carry + r4(2 * K * N);  // [F][N] log b of the chunk's frames
  float* xs = lbs + r4(F * N);        // [F][P][2 * dmax] features: x, x^2
  float* red = xs + F * P * 2 * dmax;  // kRedWords
  float* ew = red + kRedWords;        // bigram: [K][W] exit tokens per word
  float* xvw = ew + K * W;            // bigram: [K][W] cross values
  int* xbpw = reinterpret_cast<int*>(xvw + K * W);  // bigram: [K][W] cross pointers

  const int tend = min(max(p.lengths[b], 1), p.T);  // frames stepped; frame 0 always
  int* bpb = p.bp + (size_t)b * p.T * N * K;
  int round = 0;
  for (int t0 = 0; t0 < tend; t0 += F) {
    const int nf = min(F, tend - t0);
    for (int i = tid; i < nf * P * dmax; i += nt) {
      const int e = i % dmax, fq = i / dmax, q = fq % P, f = fq / P;
      float x = 0.f;
      if (e < p.dims[q])
        x = __ldg(p.feats[q] + (t0 + f) * p.fst[q][0] + e * p.fst[q][1] + b * p.fst[q][2]);
      xs[fq * 2 * dmax + e] = x;
      xs[fq * 2 * dmax + dmax + e] = x * x;
    }
    __syncthreads();
    for (int r = tid; r < N; r += nt) {
      float lbv[kFramesMax];
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f) lbv[f] = 0.f;
      for (int q = 0; q < P; ++q) stream_log_b<FULL>(p, q, r, xs, nf, lbv);
#pragma unroll
      for (int f = 0; f < kFramesMax; ++f)
        if (f < nf) lbs[f * N + r] = lbv[f];
    }
    __syncthreads();
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
  for (size_t i = (size_t)tend * fk + tid; i < (size_t)p.T * fk; i += nt) bpb[i] = (int)(i % fk);
  const float* last = carry + ((tend - 1) & 1) * K * N;
  for (int i = tid; i < K * N; i += nt) p.final_out[(size_t)b * K * N + i] = last[i];
}

template <int K, bool FULL>
cudaError_t launch(const DecodeParams& p, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = word_loop_decode_kernel<K, FULL>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<p.B, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool FULL>
cudaError_t dispatch(const DecodeParams& p, int K, int threads, size_t smem, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<1, FULL>(p, threads, smem, stream);
    case 2: return launch<2, FULL>(p, threads, smem, stream);
    case 3: return launch<3, FULL>(p, threads, smem, stream);
    case 4: return launch<4, FULL>(p, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// feats / fstrides (3 per stream: t, d, b, in floats) / dims / mixes / offs
// are host arrays of n_streams entries; every pointer they hold and every
// other pointer argument is a device pointer.
int srhmm_word_loop_decode(const void* const* feats, const long long* fstrides, const int* dims,
                           const int* mixes, const int* offs, int n_streams, int dmax,
                           const void* consts, const void* diag, const void* arc, const void* entry,
                           const void* exitc, const void* exit_row, const void* lengths,
                           void* final_out, void* bp, int T, int B, int N, int S, int band,
                           int bigram, int K, int full, int frames, int threads, int device,
                           void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || K < 1 || K > kMaxK || frames < 1 || frames > kFramesMax ||
      dmax < 4 || dmax % 4 != 0 || B < 1 || T < 1 || S < 1 || N < S || N % S != 0 || band < 0) {
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
  const size_t smem = sizeof(float) * smem_floats(N, p.W, K, n_streams, dmax, bigram, frames);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(full ? dispatch<true>(p, K, threads, smem, st) : dispatch<false>(p, K, threads, smem, st));
}

}  // extern "C"
