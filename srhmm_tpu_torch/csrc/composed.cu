// Composed-lattice E-step kernels of embedded and tied-state training for
// NVIDIA Hopper (sm_90a): bank emission, composed forward, composed
// backward-stats and bank moments, for P in [1, 6] parameter streams.
//
// Replace the TPU kernels of srhmm_tpu/ops/pallas/composed_pallas.py:
//   bank_emission_kernel           <- :218 bank_emission_pallas
//   composed_forward_kernel        <- :348 composed_forward_pallas
//   composed_backward_stats_kernel <- :474 composed_backward_stats_pallas
//   bank_moments_kernel + sum_chunks_kernel
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
// bank_moments: per bank row the gamma-weighted moments
// sum_t gamma[t, j, b] post_m(t) [x; x^2 or vec(x x^T); 1] over the
// (utterance b, row j) pairs that map to it, with the posteriors recomputed
// from the records and each stream's OWN mixture logsumexp (0 where it is
// <= NEG_INF/2).
//
// What bounds it on the H100, and what the design does about it.
// * The TPU kept the whole parameter bank resident in 48 MB of VMEM; a
//   Hopper block has 227 KB of shared memory, and the bank is 0.4 MB
//   (40 units x 3 states x 32 mixtures, D=13) to 10.1 MB (2000 senones x
//   16 mixtures, D=39).  Records keep the packed layout of emission.cuh
//   (stride from the DMAX bound), but every loop runs to D rounded up to 4
//   (the padded entries are zero, so the result is bitwise that of a loop
//   to DMAX) and the register arrays are sized by the bound just above it:
//   40 floats at D=39 instead of 64.  Emission arithmetic stays fp32 fmaf
//   on the CUDA cores, never TF32.
// * bank_emission (bounded by fp32 operations, ~16-24 GFLOP a pass): frames
//   on threads (two a thread for D <= 16, one above), one block per (frame
//   chunk, utterance) walking its LS rows.  A row's records (4.6-8.4 KB)
//   come from L2 into a ring of up to three shared-memory buffers by
//   cp.async, two rows ahead of the row being computed: one barrier a row,
//   and the copies overlap the arithmetic.  Each FMA chain is serial (the
//   order of emission.cuh is kept, so log_b is bitwise its diag_mix_q's), so
//   a thread runs two mixtures' chains side by side for each of its frames,
//   and the logsumexp step takes one expf and no branch (lse_add).
// * bank_moments (bounded by the emission of the frames whose gamma is not
//   zero, and the contraction): one block per (chunk of up to 16
//   (utterance, row) pairs that map to one bank row, stream), the pairs
//   taken in the stable sort order of the ids, the row's records staged
//   once.  Warps scan the pairs in tiles of 32 frames (one frame a lane)
//   and a warp vote drops every tile whose gamma are all exactly 0.0f
//   (a left-to-right chain occupies a row for a few frames of hundreds;
//   adding 0 * post * x to a sum changes no bit, x finite); the kept tiles
//   queue up, and each batch of one tile a warp computes the emission and
//   posteriors per frame (fp32; a diagonal q's linear and quadratic
//   halves in two chains, as the twin sums them) into shared memory, then
//   the contraction W^T [x; x^2 or x x^T; 1] on the tensor cores with
//   mma.sync m16n8k8 in 3xTF32 (hi = cvt.rna.tf32, lo = the rest rounded
//   the same way; lo*hi + hi*lo + hi*hi into fp32), the accumulators in
//   shared memory.
//   The weights enter the split times 2^48 (exact), so a subnormal gamma
//   keeps its bits.  Pass 1 writes one partial row per chunk; pass 2
//   (sum_chunks_kernel) sums each bank row's partials in chunk order.  No
//   atomics: every sum is taken in a fixed order, so two runs, and the two
//   gamma layouts, are bitwise equal.
// * composed_forward (bound by bytes: 2 lattices and ~10 operations an
//   element; in practice by the serial chain of T frames of log-sum-exp per
//   row): #11's structure, with store warps in place of the statistics
//   warps.  A warp per utterance with the rows on lanes and the sources by
//   shuffles, so the chain has no block barrier and reads no device memory;
//   log_b comes into shared memory a tile of frames ahead (cp.async) and
//   log-alpha leaves it a tile behind, both moved by warps of their own
//   (see the kernel).
// * composed_backward_stats (bound by bytes: 4 lattices; in practice by the
//   serial chain of T frames of log-sum-exp per row): a warp per utterance
//   with the rows on lanes, the neighbours by shuffles, so the chain has no
//   block barrier and reads no device memory; the lattices come into shared
//   memory a tile of 16 frames ahead (cp.async), and warps of their own add
//   the statistics of the tile before (see the kernel).

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"
#include "tile_mma.cuh"

namespace {

using namespace srhmm;

constexpr int kFrames = 128;                // threads of a bank-emission block
constexpr int kTile = 32;                   // frames of a moments tile: one a lane
constexpr int kChunk = 16;                  // (utterance, row) pairs a moments block (<= 32: one a lane)
constexpr int kMaxSlots = 4;                // tiles a moments batch (= warps a block)
constexpr int kScan = 4;                    // candidate tiles a warp checks a scan step
constexpr int kMaxRing = 3;                 // record buffers of a bank-emission block
constexpr int kMaxBand = 15;                // diagonals - 1 of the composed chain
constexpr int kForwardThreads = 512;       // threads of a forward block, at most
constexpr int kBackwardThreads = 512;       // threads of a backward-stats block, at most
constexpr int kReduceThreads = 256;
constexpr int kTableThreads = 1024;

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
  const long long* order;             // (B * LS,) stable sort of the flattened ids
  const int* offsets;                 // (NB + 1,) first position of each bank row in order
  const int* chunk_cum;               // (NB + 1,) first chunk of each bank row
  float* partial[kMaxStreams];        // per stream: (n_chunks, M_p * Cm), one row a chunk
  float* mom[kMaxStreams];            // per stream: (NB, M_p * Cm)
  int cols[kMaxStreams];              // M_p * Cm
  int slots;                          // tiles a batch = warps a block (<= kMaxSlots)
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
  int T, LS, B, nd, U;     // U utterances per block
  int W, TT;               // warps an utterance, frames a tile
};

// frames a bank-emission thread takes: two where the features fit in few
// registers (D <= 16), else one
__host__ __device__ constexpr int emission_frames(int rb) { return rb <= 16 ? 2 : 1; }

// float4 groups the emission loops run over: D rounded up to 4
__host__ __device__ __forceinline__ int groups_of(int D) { return (D + 3) / 4; }

// the DMAX of a record of `stride` floats (emission.cuh record_stride)
__device__ __forceinline__ int record_dmax(int stride, int D, bool full) {
  return full ? (stride - 4) / (D + 1) : (stride - 4) / 2;
}

// x (F frames, RB registers each) of utterance b from frame t0 on, every
// `step` frames; entries e >= D and frames past T are 0
template <int RB, int F>
__device__ __forceinline__ void load_frames(const BankParams& p, int b, int t0, int step, float (&x)[F][RB],
                                            float (&x2)[F][RB]) {
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int t = t0 + f * step;
    const float* src = p.feats + ((size_t)b * p.T + t) * p.D;
#pragma unroll
    for (int e = 0; e < RB; ++e) {
      x[f][e] = (t < p.T && e < p.D) ? __ldg(src + e) : 0.f;
      x2[f][e] = x[f][e] * x[f][e];
    }
  }
}

// Weighted diagonal mixture log-likelihoods of F frames against G
// consecutive records (stride floats apart) [mu*k (h) | -k/2 (h) | bias |
// log w | 0 | 0], over the first d4 float4 groups only; the G x F
// chains are independent.  TWO = false: emission.cuh diag_mix_q's
// operations in its order (one chain).  TWO = true: the linear half (from
// the bias) and the quadratic half in two chains, added at the end, as the
// plain twin's two products: at |q| ~ 1000 (D=64) one chain of 2D terms
// rounds the posteriors ~3x further from float64 than the twin does.
template <int RB, int F, int G, bool TWO>
__device__ __forceinline__ void diag_q(const float* rec, int stride, int h, int d4, const float (&x)[F][RB],
                                       const float (&x2)[F][RB], float (&q)[G][F]) {
  float acc[G][F], acs[G][F];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[g][f] = rec[g * stride + 2 * h];
      acs[g][f] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < RB / 4; ++i) {
    if (i < d4) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 l = reinterpret_cast<const float4*>(rec + g * stride)[i];
        const float4 s = reinterpret_cast<const float4*>(rec + g * stride + h)[i];
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float& a2 = TWO ? acs[g][f] : acc[g][f];
          acc[g][f] = fmaf(l.x, x[f][4 * i + 0], acc[g][f]);
          acc[g][f] = fmaf(l.y, x[f][4 * i + 1], acc[g][f]);
          acc[g][f] = fmaf(l.z, x[f][4 * i + 2], acc[g][f]);
          acc[g][f] = fmaf(l.w, x[f][4 * i + 3], acc[g][f]);
          a2 = fmaf(s.x, x2[f][4 * i + 0], a2);
          a2 = fmaf(s.y, x2[f][4 * i + 1], a2);
          a2 = fmaf(s.z, x2[f][4 * i + 2], a2);
          a2 = fmaf(s.w, x2[f][4 * i + 3], a2);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int f = 0; f < F; ++f) q[g][f] = (TWO ? acc[g][f] + acs[g][f] : acc[g][f]) + rec[g * stride + 2 * h + 1];
}

// Full-covariance mixture log-likelihoods through the Cholesky factor
// (emission.cuh full_mix_q's operations) of F frames against G records:
// rows d of L^T at d * h, then [-L^T mu (h) | bias | log w | 0 | 0].
template <int RB, int F, int G>
__device__ __forceinline__ void full_q(const float* rec, int stride, int D, int h, int d4,
                                       const float (&x)[F][RB], float (&q)[G][F]) {
  float quad[G][F];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int f = 0; f < F; ++f) quad[g][f] = 0.f;
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4* row = reinterpret_cast<const float4*>(rec + g * stride + d * h);
      float z[F];
#pragma unroll
      for (int f = 0; f < F; ++f) z[f] = rec[g * stride + D * h + d];
#pragma unroll
      for (int i = 0; i < RB / 4; ++i) {
        if (i < d4) {
          const float4 r = row[i];
#pragma unroll
          for (int f = 0; f < F; ++f) {
            z[f] = fmaf(r.x, x[f][4 * i + 0], z[f]);
            z[f] = fmaf(r.y, x[f][4 * i + 1], z[f]);
            z[f] = fmaf(r.z, x[f][4 * i + 2], z[f]);
            z[f] = fmaf(r.w, x[f][4 * i + 3], z[f]);
          }
        }
      }
#pragma unroll
      for (int f = 0; f < F; ++f) quad[g][f] = fmaf(z[f], z[f], quad[g][f]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float* bg = rec + g * stride + D * h;
#pragma unroll
    for (int f = 0; f < F; ++f) q[g][f] = fminf(fmaf(-0.5f, quad[g][f], bg[h]), kLogGausClamp) + bg[h + 1];
  }
}

template <int RB, int F, int G, bool FULL, bool TWO>
__device__ __forceinline__ void mix_q(const float* rec, int stride, int D, int h, int d4, const float (&x)[F][RB],
                                      const float (&x2)[F][RB], float (&q)[G][F]) {
  if constexpr (FULL) {
    full_q<RB, F, G>(rec, stride, D, h, d4, x, q);
  } else {
    diag_q<RB, F, G, TWO>(rec, stride, h, d4, x, x2, q);
  }
}

// emission.cuh lse_push without its branch: the exponent of the smaller
// term is -|q - m| in both cases (m - q == -(q - m) in IEEE arithmetic), so
// one expf serves both and the running (m, e) are bitwise those of lse_push
__device__ __forceinline__ void lse_add(float q, float& m, float& e) {
  const float ex = expf(-fabsf(q - m));
  const bool up = q > m;
  e = up ? e * ex + 1.f : e + ex;
  m = up ? q : m;
}

// Start the copies of bank row `row`'s records (every stream) into dst;
// nothing for a row outside the bank.  Records are whole float4s.
__device__ __forceinline__ void copy_records_async(const BankParams& p, int row, float* dst) {
  if (row < 0 || row >= p.NB) return;
  for (int q = 0; q < p.n_streams; ++q) {
    const int n4 = p.mixes[q] * p.strides[q] / 4;
    const float* src = p.banks[q] + (size_t)row * p.mixes[q] * p.strides[q];
    float* d = dst + p.rec_offs[q];
    for (int i = threadIdx.x; i < n4; i += blockDim.x) cp_async16(d + 4 * i, src + 4 * i, true);
  }
}

// grid (ceil(T / (kFrames * F)), B), kFrames threads: thread k takes frames
// blockIdx.x * kFrames * F + k + f * kFrames of utterance blockIdx.y and
// walks the LS rows; the records of rows j+1 .. j+nbuf-1 are in flight in
// the ring while row j computes (nbuf = 1: copy, wait, compute).  The
// mixtures go two at a time (G independent FMA chains a frame), pushed into
// the logsumexp in mixture order: log_b is bitwise that of one mixture at a
// time.
template <int RB, bool FULL>
__global__ void __launch_bounds__(kFrames) bank_emission_kernel(const BankParams p, float* log_b, int nbuf) {
  constexpr int F = emission_frames(RB), G = 2;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames * F + threadIdx.x;
  const int D = p.D, d4 = groups_of(D);
  const int* ids = p.ids + (size_t)b * p.LS;
  float x[F][RB], x2[F][RB];
  load_frames<RB, F>(p, b, t0, kFrames, x, x2);
  for (int r = 0; r + 1 < nbuf; ++r) {  // exactly nbuf - 1 groups in flight
    if (r < p.LS) copy_records_async(p, ids[r], ring + (size_t)r * p.rec_floats);
    cp_async_commit();
  }
  for (int j = 0; j < p.LS; ++j) {
    const float* buf = ring + (size_t)(j % nbuf) * p.rec_floats;
    if (nbuf == 1) {
      __syncthreads();  // the previous row's records are no longer read
      copy_records_async(p, ids[j], ring);
      cp_async_commit();
    }
    if (nbuf >= 3) {
      cp_async_wait<1>();  // row j's group is complete; row j+1's may still fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // row j visible to all; row j-1's buffer free
    if (nbuf > 1) {
      const int r = j + nbuf - 1;
      if (r < p.LS) copy_records_async(p, ids[r], ring + (size_t)(r % nbuf) * p.rec_floats);
      cp_async_commit();
    }
    const int row = ids[j];
    const bool ok = row >= 0 && row < p.NB;
    float lb[F];
    for (int q = 0; q < p.n_streams; ++q) {
      const int M = p.mixes[q], stride = p.strides[q];
      const int h = record_dmax(stride, D, FULL);
      const float* rec = buf + p.rec_offs[q];
      float m[F], e[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        m[f] = kNegInf;
        e[f] = 0.f;
      }
      int mix = 0;
      for (; mix + G <= M; mix += G) {  // G independent chains, pushed in mixture order
        float qv[G][F];
        mix_q<RB, F, G, FULL, false>(rec + mix * stride, stride, D, h, d4, x, x2, qv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int f = 0; f < F; ++f) lse_add(qv[g][f], m[f], e[f]);
      }
      for (; mix < M; ++mix) {
        float qv[1][F];
        mix_q<RB, F, 1, FULL, false>(rec + mix * stride, stride, D, h, d4, x, x2, qv);
#pragma unroll
        for (int f = 0; f < F; ++f) lse_add(qv[0][f], m[f], e[f]);
      }
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float v = lse_value(m[f], e[f]);
        lb[f] = (q == 0) ? v : lb[f] + v;
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const int t = t0 + f * kFrames;
      // an id outside the bank poisons its row instead of reading stray memory
      if (t < p.T) log_b[((size_t)t * p.LS + j) * p.B + b] = ok ? fmaxf(lb[f], kNegInf) : __int_as_float(0x7fc00000);
    }
  }
}

// Shared memory of one backward-stats block, in floats (the wrapper's
// ops/kernels/composed.py backward_smem_bytes mirrors it), for tiles of TT
// frames: log-alpha in three ring slots and log_b of the next frames in
// two, each (TT, LS, U) as the copies land (U consecutive floats along B a
// row; gamma takes log-alpha's place), a tile's pitch AP = LS U rounded up
// to 4; then the recursion's inner terms and log-beta in two slots each,
// (TT, U, LP) with the row pitch LP = 32 R W + 4 (the rows of a lane
// adjacent, so a lane moves its R rows as one vector; + 4 spreads the
// utterances over the banks).
__host__ __device__ inline int backward_pitch(int R, int W) { return 32 * R * W + 4; }

__host__ __device__ inline int tile_pitch(int LS, int U) { return (LS * U + 3) / 4 * 4; }

// Shared memory of one forward block, in floats (ops/kernels/composed.py
// forward_smem_bytes mirrors it): log_b in two slots and log-alpha in two,
// each (TT, LS, U) with the tile pitch of the backward's slots.
__host__ __device__ inline size_t forward_floats(int U, int TT, int LS) { return 4 * (size_t)TT * tile_pitch(LS, U); }

__host__ __device__ inline size_t backward_floats(int R, int W, int U, int TT, int LS) {
  return 5 * (size_t)TT * tile_pitch(LS, U) + 4 * (size_t)TT * U * backward_pitch(R, W);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void load_rows(const float* src, float (&v)[R]) {
  if constexpr (R == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (R == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = src[0];
  }
}

template <int R>
__device__ __forceinline__ void store_rows(float* dst, const float (&v)[R]) {
  if constexpr (R == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
    dst[0] = v[0];
  }
}

// Two kinds of warp, W per utterance each (W > 1 when LS > 128), U
// utterances a block.  Recursion warps: lane l of warp w of an utterance
// holds rows j0 = (32 w + l) R .. j0 + R - 1 in registers, with their NDB
// >= nd column-form diagonals (NDB = 2, 3, 4, 8 or 16, so that the loops
// over the diagonals unroll without a branch).  The block walks tiles of TT
// frames up in time: while the recursion warps run tile k out of shared
// memory, the store warps write log-alpha of tile k-1 out (U consecutive
// floats along B a row, 16-byte stores where U and B are multiples of 4)
// and start the 16-byte cp.async copies of tile k+1's log_b; one barrier
// closes a tile.
// Per frame a recursion lane takes its rows' log_b from the tile (read a
// frame ahead) and the sources j - d (0 < d < nd) of its rows from the
// lanes below by __shfl_up_sync: row j0 - s lives in lane l - ceil(s / R),
// register (-s) mod R, so NDB - 1 shuffles serve every row of the lane; a
// row in the previous warp is read from the log-alpha tile after a barrier
// of the recursion warps (W > 1 only).  Nothing else is on the serial
// chain.  A source off the chain (j - d < 0, or d >= nd) enters the max as
// -inf and the sum as expf(-inf) = 0.0f, which change no bit of a sum that
// skips it: log-alpha is bitwise that of a kernel with one thread a row
// summing over d ascending.  Frame 0 starts in row 0 even for a
// zero-length row; frames t >= length repeat the carry.
template <int R, int NDB>
__global__ void __launch_bounds__(kForwardThreads) composed_forward_kernel(const LatticeParams p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int LS = p.LS, U = p.U, W = p.W, TT = p.TT, nd = p.nd, T = p.T;
  const int AP = tile_pitch(LS, U), tid = threadIdx.x;
  const int role_threads = 32 * W * U;
  const int b0 = blockIdx.x * U;
  const size_t tile = (size_t)TT * AP;  // floats of one (TT, LS, U) slot
  float* lb_slots = sh;                 // 2 slots; slot k & 1 holds tile k
  float* la_slots = sh + 2 * tile;      // 2 slots
  const int n_tiles = (T + TT - 1) / TT;
  if (tid >= role_threads) {
    // ---- the store warps ----
    const int st = tid - role_threads;
    auto stage = [&](int k) {  // log_b of frames [k TT, k TT + TT)
      stage_rows_async(lb_slots + (k & 1) * tile, AP, U, p.log_b, k * TT, min(TT, T - k * TT), LS, T, p.B, b0, U,
                       role_threads, role_threads);
      cp_async_commit();
    };
    stage(0);
    cp_async_wait<0>();
    __syncthreads();
    for (int k = 0; k < n_tiles; ++k) {
      // tile k+1 goes into the slot of tile k-1, read before the last barrier
      if (k + 1 < n_tiles) stage(k + 1);
      if (k >= 1)
        store_rows_from_tile(p.la_out, la_slots + ((k - 1) & 1) * tile, AP, (k - 1) * TT, TT, LS, p.B, b0, U, st,
                             role_threads);
      cp_async_wait<0>();
      __syncthreads();
    }
    const int k = n_tiles - 1;
    store_rows_from_tile(p.la_out, la_slots + (k & 1) * tile, AP, k * TT, T - k * TT, LS, p.B, b0, U, st, role_threads);
    return;
  }
  // ---- the recursion warps ----
  const int lane = tid & 31, wid = tid >> 5;
  const int u = wid / W, w = wid - u * W, b = b0 + u;
  const bool live = b < p.B;
  const int j0 = (w * 32 + lane) * R;
  float dcol[R][NDB];
  int lim[R];  // the sources d < lim[r] of row j0 + r are on its chain
  int off[R];  // row j0 + r in a tile (rows past LS read row LS - 1: never stored)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lim[r] = min(nd, j0 + r + 1);
    off[r] = min(j0 + r, LS - 1) * U + u;
#pragma unroll
    for (int d = 0; d < NDB; ++d)
      dcol[r][d] = (live && d < nd && j0 + r < LS) ? p.diag[((size_t)d * LS + j0 + r) * p.B + b] : kNegInf;
  }
  const int len = live ? p.lengths[b] : 0;
  __syncthreads();
  float carry[R];
  for (int k = 0; k < n_tiles; ++k) {
    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);
    const float* lb_tile = lb_slots + (k & 1) * tile;
    float* la_tile = la_slots + (k & 1) * tile;
    float lbn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) lbn[r] = lb_tile[off[r]];
    for (int t = t_lo; t < t_hi; ++t) {
      const int tt = t - t_lo;
      float lb[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        lb[r] = lbn[r];
        if (t + 1 < t_hi) lbn[r] = lb_tile[(size_t)(tt + 1) * AP + off[r]];
      }
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) carry[r] = fmaxf((j0 + r == 0 ? 0.f : kNegInf) + lb[r], kNegInf);
      } else if (t < len) {
        // nb[s] = log-alpha[t-1] of row j0 - s (s >= 1); a row in the
        // previous warp comes from the tile of frame t-1
        const float* prev_row = (tt > 0) ? la_tile + (size_t)(tt - 1) * AP
                                         : la_slots + ((k - 1) & 1) * tile + (size_t)(TT - 1) * AP;
        float nb[NDB];
#pragma unroll
        for (int s = 1; s < NDB; ++s) {
          const int o = (s + R - 1) / R;
          float x = __shfl_up_sync(~0u, carry[(R - s % R) % R], o);
          if (W > 1 && lane < o && j0 - s >= 0) x = prev_row[(j0 - s) * U + u];
          nb[s] = x;
        }
        float next[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v[NDB];
#pragma unroll
          for (int d = 0; d < NDB; ++d) v[d] = (d < lim[r]) ? (d <= r ? carry[r - d] : nb[d - r]) + dcol[r][d] : -INFINITY;
          float m = kNegInf;
#pragma unroll
          for (int d = 0; d < NDB; ++d) m = fmaxf(m, v[d]);
          float e = 0.f;
#pragma unroll
          for (int d = 0; d < NDB; ++d) e += expf(v[d] - m);
          const float upd = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
          next[r] = fmaxf(upd + lb[r], kNegInf);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) carry[r] = next[r];
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j0 + r < LS) la_tile[(size_t)tt * AP + (j0 + r) * U + u] = carry[r];
      if (W > 1) named_barrier(1, role_threads);  // the rows of frame t, for the next warp's sources
    }
    __syncthreads();
  }
}

// Two kinds of warp, W per utterance each (W > 1 when LS > 128), U
// utterances a block; lane l of warp w of an utterance holds rows j0 =
// (32 w + l) R .. j0 + R - 1 in registers, with their NDB >= nd row-form
// diagonals (NDB = 2, 3, 4, 8 or 16, so that the loops over the diagonals
// unroll without a branch).  The block walks tiles of TT frames down in
// time, one tile apart: while the recursion warps run tile k (and start
// the copies of tile k+1 by cp.async), the statistics warps run tile k-1;
// one barrier closes each step.
// * Recursion: per frame a lane reads its rows' log_b[t+1] from the tile
//   (a frame ahead), forms inner = log_b[t+1] + beta[t+1] and stores it;
//   the neighbours j + d (d < nd) of its rows come from the lanes above by
//   __shfl_down_sync (row j0 + q lives in lane l + q / R, register q % R,
//   so NDB - 1 shuffles serve every row of the lane; a row in the next warp
//   is read from the tile after a barrier of the recursion warps, W > 1
//   only); the log-sum-exp gives log-beta[t], stored in the tile.  A term
//   outside the chain enters the max as NEG_INF and the sum as 0.0f, which
//   change no bit.  Nothing else is on this serial chain.
// * Statistics: per frame a lane reads log-alpha, log-beta and the
//   neighbours' inner terms from the tile and adds xi, gamma, den_trans
//   and den_mix of its rows in time order (frames independent but for
//   those sums), gamma in log-alpha's place; then the tile's gamma goes
//   out, U consecutive floats along B a row (16-byte stores where U and B
//   are multiples of 4).
// The arithmetic is that of a kernel with one thread a row, in its
// order, so every output is bitwise that kernel's.
template <int R, int NDB>
__global__ void __launch_bounds__(kBackwardThreads) composed_backward_stats_kernel(const LatticeParams p) {
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);
  const int LS = p.LS, U = p.U, W = p.W, TT = p.TT, nd = p.nd, T = p.T;
  const int LP = backward_pitch(R, W), AP = tile_pitch(LS, U);
  const int tid = threadIdx.x, lane = tid & 31;
  const int role_threads = 32 * W * U;
  const bool stats = tid >= role_threads;  // else a recursion thread
  const int wid = (tid - (stats ? role_threads : 0)) >> 5;
  const int u = wid / W, w = wid - u * W;
  const int b0 = blockIdx.x * U, b = b0 + u;
  const bool live = b < p.B;
  const int j0 = (w * 32 + lane) * R;
  const size_t tile = (size_t)TT * AP;        // floats of one (TT, LS, U) slot
  const size_t rec = (size_t)TT * U * LP;     // floats of one (TT, U, LP) slot
  float* la_slots = sh;                       // 3 slots; slot k % 3 holds tile k
  float* lb_slots = sh + 3 * tile;            // 2 slots; slot k & 1 holds tile k
  float* inner_slots = sh + 5 * tile;         // 2 slots
  float* beta_slots = inner_slots + 2 * rec;  // 2 slots
  float drow[R][NDB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < NDB; ++d)
      drow[r][d] = (live && d < nd && j0 + r < LS) ? p.diag[((size_t)d * LS + j0 + r) * p.B + b] : kNegInf;
  const int len = live ? p.lengths[b] : 0;
  const float z = live ? p.safe_z[b] : 0.f;
  const bool valid = live && p.vmask[b] > 0.f;
  const int n_tiles = (T + TT - 1) / TT;
  // tile k holds frames [max(T - (k+1) TT, 0), T - k TT): their log-alpha
  // and log_b of the frames after them
  auto stage = [&](int k) {  // recursion threads only
    const int hi = T - k * TT, lo = max(hi - TT, 0);
    stage_rows_async(la_slots + (k % 3) * tile, AP, U, p.la, lo, hi - lo, LS, T, p.B, b0, U, 0, role_threads);
    stage_rows_async(lb_slots + (k & 1) * tile, AP, U, p.log_b, lo + 1, hi - lo, LS, T, p.B, b0, U, 0,
                     role_threads);
    cp_async_commit();
  };
  if (!stats) {
    stage(0);
    cp_async_wait<0>();
  }
  __syncthreads();

  if (!stats) {
    // ---- the recursion: tiles 0 .. n_tiles-1, one a step ----
    float beta[R], beta_init[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      beta_init[r] = (j0 + r == LS - 1) ? 0.f : kNegInf;  // the unpadded final row
      beta[r] = beta_init[r];  // log-beta at t+1 until this frame's update
    }
    for (int k = 0; k <= n_tiles; ++k) {
      // tile k+1 goes into the slots of tiles k-2 (log-alpha, written out
      // last step) and k-1 (log_b, read by last step's recursion)
      if (k + 1 < n_tiles) stage(k + 1);
      if (k < n_tiles) {
        const int t_hi = T - k * TT, t_lo = max(t_hi - TT, 0);
        const float* lb_tile = lb_slots + (k & 1) * tile;
        float* inner_tile = inner_slots + (k & 1) * rec;
        float* beta_tile = beta_slots + (k & 1) * rec;
        // log_b[t+1, j] = lb_tile[tt * AP + j * U + u], read a frame ahead
        // (rows past LS read row LS-1: never used)
        int lb_off[R];
#pragma unroll
        for (int r = 0; r < R; ++r) lb_off[r] = min(j0 + r, LS - 1) * U + u;
        float lbn[R];
#pragma unroll
        for (int r = 0; r < R; ++r) lbn[r] = lb_tile[(size_t)(t_hi - 1 - t_lo) * AP + lb_off[r]];
        for (int t = t_hi - 1; t >= t_lo; --t) {
          const int tt = t - t_lo;
          float* in_row = inner_tile + ((size_t)tt * U + u) * LP;
          // log_b[t+1]: at t = T-1 every use is masked (t < length-1 is impossible)
          const bool next = live && t + 1 < T;
          float inner[R];
#pragma unroll
          for (int r = 0; r < R; ++r) inner[r] = fmaxf((next ? lbn[r] : kNegInf) + beta[r], kNegInf);
          if (t > t_lo) {
#pragma unroll
            for (int r = 0; r < R; ++r) lbn[r] = lb_tile[(size_t)(tt - 1) * AP + lb_off[r]];
          }
          store_rows<R>(in_row + j0, inner);
          if (W > 1) named_barrier(1, role_threads);
          // v[q] = inner of row j0 + q: row j0 + q lives in lane + q / R,
          // register q % R (a row in the next warp is read from the tile)
          float v[R + NDB - 1];
#pragma unroll
          for (int q = 0; q < R; ++q) v[q] = inner[q];
#pragma unroll
          for (int q = R; q < R + NDB - 1; ++q) {
            float x = __shfl_down_sync(~0u, inner[q % R], q / R);
            if (W > 1 && lane + q / R >= 32 && j0 + q < LS) x = in_row[j0 + q];
            v[q] = x;
          }
          const bool stepping = len - 1 > t;  // t < length-1; else the init row
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int j = j0 + r;
            // destinations j + d past the last row (or d >= nd) add
            // exp(min(-2e30, 0)) = 0 and are left out: a NEG_INF term in
            // the max and a 0.0f in the sum change no bit
            float m = kNegInf;
#pragma unroll
            for (int d = 0; d < NDB; ++d) m = fmaxf(m, (d < nd && j + d < LS) ? v[r + d] + drow[r][d] : kNegInf);
            float e = 0.f;
#pragma unroll
            for (int d = 0; d < NDB; ++d) {
              const float x = expf(v[r + d] + drow[r][d] - m);
              e += (d < nd && j + d < LS) ? x : 0.f;
            }
            beta[r] = stepping ? fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf) : beta_init[r];
          }
          store_rows<R>(beta_tile + ((size_t)tt * U + u) * LP + j0, beta);
        }
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    return;
  }

  // ---- the statistics: tiles -1 .. n_tiles-1, one a step behind ----
  float xi[R][NDB], dt[R], dm[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dt[r] = 0.f;
    dm[r] = 0.f;
#pragma unroll
    for (int d = 0; d < NDB; ++d) xi[r][d] = 0.f;
  }
  const int st = tid - role_threads;
  for (int k = 0; k <= n_tiles; ++k) {
    if (k >= 1) {
      const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0);
      float* la_tile = la_slots + ((k - 1) % 3) * tile;
      const float* inner_tile = inner_slots + ((k - 1) & 1) * rec;
      const float* beta_tile = beta_slots + ((k - 1) & 1) * rec;
#pragma unroll 2
      for (int t = t_hi - 1; t >= t_lo; --t) {
        const int tt = t - t_lo;
        float* la_row = la_tile + (size_t)tt * AP + u;  // log-alpha[t, j] = la_row[j * U]
        const float* in_row = inner_tile + ((size_t)tt * U + u) * LP;
        float beta[R];
        load_rows<R>(beta_tile + ((size_t)tt * U + u) * LP + j0, beta);
        const bool stepping = len - 1 > t;
        const bool m_xi = stepping && valid;
        const bool on = valid && t < len;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = min(j0 + r, LS - 1);  // rows past LS: computed, never stored
          const float la_t = live ? la_row[j * U] : kNegInf;
          // a term left out adds 0.0f: no bit of the sum changes
#pragma unroll
          for (int d = 0; d < NDB; ++d) {
            const float x = expf(fminf(la_t + drow[r][d] + in_row[min(j + d, LS - 1)] - z, 0.f));
            xi[r][d] += (m_xi && d < nd && j0 + r + d < LS) ? x : 0.f;
          }
          const float g = on ? expf(fminf(la_t + beta[r] - z, 0.f)) : 0.f;
          dm[r] += g;
          dt[r] += m_xi ? g : 0.f;
          if (j0 + r < LS) la_row[j * U] = g;  // gamma takes log-alpha's place in the tile
        }
      }
      named_barrier(2, role_threads);  // the tile's gamma is complete
      // gamma out, as it sits in the tile
      store_rows_from_tile(p.gamma, la_tile, AP, t_lo, t_hi - t_lo, LS, p.B, b0, U, st, role_threads);
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = j0 + r;
      if (j >= LS) continue;
#pragma unroll
      for (int d = 0; d < NDB; ++d)
        if (d < nd) p.xi[((size_t)d * LS + j) * p.B + b] = xi[r][d];
      p.den_trans[(size_t)j * p.B + b] = dt[r];
      p.den_mix[(size_t)j * p.B + b] = dm[r];
    }
  }
}

// ---------------------------------------------------------------------------
// bank moments
// ---------------------------------------------------------------------------

// Shared memory of one moments block, in floats then ints (the wrapper's
// ops/kernels/composed.py moments_smem_bytes mirrors it):
//   records M * stride | posterior weights w (M, ks) | features x (D, ks) |
//   accumulators (M, Cm) | queued gamma (qcap, 32) |
//   ints: queued pair (qcap) | queued tile (qcap) | vote masks (2, slots) |
//   pair b, j, length (3 kChunk) | first tile of each pair (kChunk + 1)
// with qcap = (kScan + 1) * slots (fewer than slots left over, and up to
// kScan * slots found a step)
// with ks = 32 * slots + 4 (a padded row: the fragment loads hit 32 banks).
struct MomLayout {
  float *rec, *w, *x, *acc, *gq;
  int *qpair, *qtile, *vote, *pb, *pj, *plen, *pfirst;
  int ks, qcap;
};

__host__ __device__ inline size_t moments_floats(int M, int stride, int D, int Cm, int slots) {
  const int ks = kTile * slots + 4;
  return (size_t)M * stride + (size_t)(M + D) * ks + (size_t)M * Cm + (size_t)(kScan + 1) * slots * kTile;
}

__host__ __device__ inline size_t moments_ints(int slots) {
  return (size_t)(2 * (kScan + 1) + 2) * slots + 4 * (size_t)kChunk + 1;
}

__device__ __forceinline__ MomLayout moments_layout(float* base, int M, int stride, int D, int Cm, int slots) {
  MomLayout L;
  L.ks = kTile * slots + 4;
  L.qcap = (kScan + 1) * slots;
  L.rec = base;
  L.w = L.rec + (size_t)M * stride;
  L.x = L.w + (size_t)M * L.ks;
  L.acc = L.x + (size_t)D * L.ks;
  L.gq = L.acc + (size_t)M * Cm;
  L.qpair = reinterpret_cast<int*>(L.gq + (size_t)L.qcap * kTile);
  L.qtile = L.qpair + L.qcap;
  L.vote = L.qtile + L.qcap;
  L.pb = L.vote + 2 * slots;
  L.pj = L.pb + kChunk;
  L.plen = L.pj + kChunk;
  L.pfirst = L.plen + kChunk;
  return L;
}

// One batch of nb queued tiles (queue entries head .. head+nb-1): thread
// k = 32 s + lane takes frame 32 * tile + lane of entry s, computes its
// mixture log-likelihoods and posteriors (fp32, this stream's own
// logsumexp) into w[:, k] = gamma * post * 2^48 and its features into x[:, k];
// then the warps add W^T lift over the batch's frames into the
// accumulators on the tensor cores (3xTF32), each accumulator owned by one
// warp and summed over the frames in mma order.  Ends on a barrier.
template <int RB, bool FULL>
__device__ void moments_batch(const BankParams& p, const MomLayout& L, int M, int stride, int Cm, int head,
                              int nb) {
  const float* rec = L.rec;
  const int D = p.D, d4 = groups_of(D), h = record_dmax(stride, D, FULL);
  const int k = threadIdx.x, s = k >> 5, lane = k & 31, warp = s;
  const int slots = blockDim.x >> 5;
  __syncthreads();  // the queue entries are written
  if (s < nb) {
    const int e = (head + s) % L.qcap;
    const int pi = L.qpair[e];
    const int t = L.qtile[e] * kTile + lane;
    const bool on = t < L.plen[pi];
    const float g = L.gq[e * kTile + lane];
    float x[1][RB], x2[1][RB];
    load_frames<RB, 1>(p, L.pb[pi], on ? t : p.T, 0, x, x2);
#pragma unroll
    for (int i = 0; i < RB; ++i)
      if (i < D) L.x[i * L.ks + k] = x[0][i];
    float mx = kNegInf, ex = 0.f;
    int mix = 0;
    for (; mix + 2 <= M; mix += 2) {  // two independent chains, pushed in order
      float qv[2][1];
      mix_q<RB, 1, 2, FULL, true>(rec + mix * stride, stride, D, h, d4, x, x2, qv);
      L.w[mix * L.ks + k] = qv[0][0];
      L.w[(mix + 1) * L.ks + k] = qv[1][0];
      lse_add(qv[0][0], mx, ex);
      lse_add(qv[1][0], mx, ex);
    }
    if (mix < M) {
      float qv[1][1];
      mix_q<RB, 1, 1, FULL, true>(rec + mix * stride, stride, D, h, d4, x, x2, qv);
      L.w[mix * L.ks + k] = qv[0][0];
      lse_add(qv[0][0], mx, ex);
    }
    const float lbp = lse_value(mx, ex);  // this stream's own log b
    for (mix = 0; mix < M; ++mix) {
      float* wq = L.w + mix * L.ks + k;
      const float post = (lbp > 0.5f * kNegInf) ? expf(fminf(*wq - lbp, 0.f)) : 0.f;
      *wq = on ? (g * post) * kWeightScale : 0.f;
    }
  }
  __syncthreads();
  // the contraction: units of (16 mixtures) x (2 x 8 columns), one warp each
  contract_3xtf32<FULL>(L.acc, M, Cm, L.w, L.x, L.ks, D, nb * (kTile / 8), warp, slots);
  __syncthreads();  // w, x and the processed queue entries are free again
}

// Pass 0, one block: the chunk table from the ids sorted stably (sorted,
// n entries; an id below 0 counts to bank row 0, one at or above NB to row
// NB-1).  offsets[r] = the first position of row r (offsets[NB] = n);
// chunk_cum[r] = the first chunk of row r, ceil(count / kChunk) chunks a row
// (chunk_cum[NB] = the number of chunks).
__global__ void __launch_bounds__(kTableThreads)
    chunk_table_kernel(const int* sorted, int n, int NB, int* offsets, int* chunk_cum) {
  __shared__ int part[kTableThreads];
  const int tid = threadIdx.x;
  // rows (row of position i-1, row of position i] start at position i
  for (int i = tid; i <= n; i += kTableThreads) {
    const int prev = i > 0 ? min(max(sorted[i - 1], 0), NB - 1) : -1;
    const int cur = i < n ? min(max(sorted[i], 0), NB - 1) : NB;
    for (int r = prev + 1; r <= cur; ++r) offsets[r] = i;
  }
  __syncthreads();
  const int per = (NB + kTableThreads - 1) / kTableThreads;
  const int r0 = min(NB, tid * per), r1 = min(NB, r0 + per);
  int local = 0;
  for (int r = r0; r < r1; ++r) local += (offsets[r + 1] - offsets[r] + kChunk - 1) / kChunk;
  part[tid] = local;
  __syncthreads();
  for (int o = 1; o < kTableThreads; o <<= 1) {  // inclusive scan
    const int v = tid >= o ? part[tid - o] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - local;
  for (int r = r0; r < r1; ++r) {
    chunk_cum[r] = run;
    run += (offsets[r + 1] - offsets[r] + kChunk - 1) / kChunk;
  }
  if (tid == kTableThreads - 1) chunk_cum[NB] = part[tid];
}

// Pass 1: grid (n_chunks, P), 32 * slots threads.  Block (g, q) takes chunk
// g: up to kChunk (utterance, row) pairs of one bank row r, consecutive in
// the stable sort of the ids, and stream q; it writes the chunk's moments
// partial[q][g] (NaN when a pair's id is outside [0, NB)).
template <int RB, bool FULL>
__global__ void __launch_bounds__(kTile * kMaxSlots) bank_moments_kernel(const BankParams p, const MomParams m) {
  extern __shared__ float4 smem4[];
  const int g = blockIdx.x, q = blockIdx.y;
  if (g >= m.chunk_cum[p.NB]) return;  // past the last chunk
  int lo = 0, hi = p.NB;               // chunk_cum[lo] <= g < chunk_cum[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (m.chunk_cum[mid] <= g) lo = mid; else hi = mid;
  }
  const int r = lo;
  const int s0 = m.offsets[r] + (g - m.chunk_cum[r]) * kChunk;
  const int np = min(kChunk, m.offsets[r + 1] - s0);
  const int M = p.mixes[q], stride = p.strides[q], D = p.D;
  const int Cm = FULL ? D + D * D + 1 : 2 * D + 1;
  const int slots = m.slots;
  const MomLayout L = moments_layout(reinterpret_cast<float*>(smem4), M, stride, D, Cm, slots);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the row's records, once for every pair; zeroed accumulators
  {
    const int n4 = M * stride / 4;
    const float4* src = reinterpret_cast<const float4*>(p.banks[q] + (size_t)r * M * stride);
    float4* dst = reinterpret_cast<float4*>(L.rec);
    for (int i = tid; i < n4; i += blockDim.x) dst[i] = src[i];
  }
  for (int i = tid; i < M * Cm; i += blockDim.x) L.acc[i] = 0.f;
  // the pairs, and the first tile of each (a prefix sum over warp 0)
  bool bad = false;
  if (warp == 0) {
    int tiles = 0;
    if (lane < np) {
      const int pair = (int)m.order[s0 + lane];
      const int b = pair / p.LS;
      bad = p.ids[pair] != r;  // an id outside the bank sorts into row 0 or NB-1
      const int len = min(max(m.lengths[b], 0), p.T);
      L.pb[lane] = b;
      L.pj[lane] = pair - b * p.LS;
      L.plen[lane] = len;
      tiles = (len + kTile - 1) / kTile;
    }
    int incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane < np) L.pfirst[lane + 1] = incl;
    if (lane == 0) L.pfirst[0] = 0;
  }
  bad = __syncthreads_or(bad);
  const int ctot = bad ? 0 : L.pfirst[np];

  // scan the candidate tiles, kScan a warp a step (their loads in flight
  // together); queue the non-zero ones in candidate order
  int head = 0, count = 0, step = 0;
  for (int base = 0; base < ctot; base += slots * kScan, ++step) {
    float gv[kScan];
    int pi[kScan], u[kScan];
    unsigned mask = 0;
#pragma unroll
    for (int v = 0; v < kScan; ++v) {
      const int c = base + warp * kScan + v;
      gv[v] = 0.f;
      pi[v] = 0;
      u[v] = 0;
      if (c < ctot) {  // uniform over the warp
        const unsigned le = __ballot_sync(~0u, lane < np && L.pfirst[lane] <= c);
        pi[v] = 31 - __clz(le);
        u[v] = c - L.pfirst[pi[v]];
        const int t = u[v] * kTile + lane;
        if (t < L.plen[pi[v]]) gv[v] = m.gamma[t * m.g_st + L.pj[pi[v]] * m.g_sj + L.pb[pi[v]] * m.g_sb];
      }
    }
#pragma unroll
    for (int v = 0; v < kScan; ++v) mask |= __any_sync(~0u, gv[v] != 0.f) ? 1u << v : 0u;
    int* vote = L.vote + (step & 1) * slots;
    if (lane == 0) vote[warp] = (int)mask;
    __syncthreads();
    int rank = 0, added = 0;
    for (int w = 0; w < slots; ++w) {
      const int n = __popc(vote[w]);
      rank += (w < warp) ? n : 0;
      added += n;
    }
#pragma unroll
    for (int v = 0; v < kScan; ++v) {
      if (mask & (1u << v)) {
        const int e = (head + count + rank) % L.qcap;
        L.gq[e * kTile + lane] = gv[v];
        if (lane == 0) {
          L.qpair[e] = pi[v];
          L.qtile[e] = u[v];
        }
        ++rank;
      }
    }
    count += added;
    while (count >= slots) {
      moments_batch<RB, FULL>(p, L, M, stride, Cm, head, slots);
      head = (head + slots) % L.qcap;
      count -= slots;
    }
  }
  if (count > 0) moments_batch<RB, FULL>(p, L, M, stride, Cm, head, count);

  const float nan = __int_as_float(0x7fc00000);
  const int cols = M * Cm;
  float* out = m.partial[q] + (size_t)g * cols;
  for (int i = tid; i < cols; i += blockDim.x) out[i] = bad ? nan : L.acc[i] * kWeightUnscale;
}

// Pass 2: mom[q][r, col] = sum of partial[q][g, col] over bank row r's
// chunks g in [chunk_cum[r], chunk_cum[r+1]), in that order (0 for a row
// no pair maps to).  grid (NB, ceil(max cols / kReduceThreads), P).
__global__ void __launch_bounds__(kReduceThreads) sum_chunks_kernel(const MomParams m) {
  const int r = blockIdx.x, q = blockIdx.z;
  const int cols = m.cols[q];
  const int col = blockIdx.y * kReduceThreads + threadIdx.x;
  if (col >= cols) return;
  float a = 0.f;
  for (int g = m.chunk_cum[r]; g < m.chunk_cum[r + 1]; ++g) a += m.partial[q][(size_t)g * cols + col];
  m.mom[q][(size_t)r * cols + col] = a;
}

using EmitFn = void (*)(BankParams, float*, int);
using MomFn = void (*)(BankParams, MomParams);

template <int RB, bool FULL>
void pick(int which, void** fn) {
  if (which == 0) {
    *fn = reinterpret_cast<void*>(static_cast<EmitFn>(bank_emission_kernel<RB, FULL>));
  } else {
    *fn = reinterpret_cast<void*>(static_cast<MomFn>(bank_moments_kernel<RB, FULL>));
  }
}

// The register bound of a bank kernel: the smallest compiled bound >= D
// rounded up to 4 (diagonal 8, 16, 24, 32, 40, 48, 64; full 4, 8, 12, 16);
// 0 when there is none.
int register_bound(int D, bool full) {
  static const int kDiag[] = {8, 16, 24, 32, 40, 48, 64};
  static const int kFull[] = {4, 8, 12, 16};
  const int need = 4 * groups_of(D);
  if (full) {
    for (int rb : kFull)
      if (rb >= need) return rb;
    return 0;
  }
  for (int rb : kDiag)
    if (rb >= need) return rb;
  return 0;
}

// which: 0 = emission, 1 = moments; nullptr for a bound that is not compiled
void* bank_kernel_for(int which, int rb, bool full) {
  void* fn = nullptr;
  if (full) {
    switch (rb) {
      case 4: pick<4, true>(which, &fn); break;
      case 8: pick<8, true>(which, &fn); break;
      case 12: pick<12, true>(which, &fn); break;
      case 16: pick<16, true>(which, &fn); break;
      default: break;
    }
    return fn;
  }
  switch (rb) {
    case 8: pick<8, false>(which, &fn); break;
    case 16: pick<16, false>(which, &fn); break;
    case 24: pick<24, false>(which, &fn); break;
    case 32: pick<32, false>(which, &fn); break;
    case 40: pick<40, false>(which, &fn); break;
    case 48: pick<48, false>(which, &fn); break;
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

using LatticeFn = void (*)(LatticeParams);

// the lattice kernel for R rows a lane and nd diagonals: the smallest
// compiled NDB >= nd (2, 3, 4, 8, 16); nullptr for an R that is not compiled
template <int R, bool FORWARD>
LatticeFn lattice_for_rows(int nd) {
  if (nd <= 2) return FORWARD ? composed_forward_kernel<R, 2> : composed_backward_stats_kernel<R, 2>;
  if (nd <= 3) return FORWARD ? composed_forward_kernel<R, 3> : composed_backward_stats_kernel<R, 3>;
  if (nd <= 4) return FORWARD ? composed_forward_kernel<R, 4> : composed_backward_stats_kernel<R, 4>;
  if (nd <= 8) return FORWARD ? composed_forward_kernel<R, 8> : composed_backward_stats_kernel<R, 8>;
  return FORWARD ? composed_forward_kernel<R, 16> : composed_backward_stats_kernel<R, 16>;
}

template <bool FORWARD>
LatticeFn lattice_kernel_for(int R, int nd) {
  switch (R) {
    case 1: return lattice_for_rows<1, FORWARD>(nd);
    case 2: return lattice_for_rows<2, FORWARD>(nd);
    case 4: return lattice_for_rows<4, FORWARD>(nd);
    default: return nullptr;
  }
}

int forward_launch(const LatticeParams& p, int R, int device, void* stream) {
  const LatticeFn fn = lattice_kernel_for<true>(R, p.nd);
  if (fn == nullptr || p.T < 1 || p.LS < 1 || p.B < 1 || p.U < 1 || p.W < 1 || p.TT < 1 || p.nd < 1 ||
      p.nd > kMaxBand + 1 || 32 * R * p.W < p.LS || 64 * p.W * p.U > kForwardThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * forward_floats(p.U, p.TT, p.LS);
  err = allow_smem(reinterpret_cast<const void*>(fn), smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.U - 1) / p.U;
  fn<<<blocks, 64 * p.W * p.U, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int backward_launch(const LatticeParams& p, int R, int device, void* stream) {
  const LatticeFn fn = lattice_kernel_for<false>(R, p.nd);
  if (fn == nullptr || p.T < 1 || p.LS < 1 || p.B < 1 || p.U < 1 || p.W < 1 || p.TT < 1 || p.nd < 1 ||
      p.nd > kMaxBand + 1 || 32 * R * p.W < p.LS || 64 * p.W * p.U > kBackwardThreads) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * backward_floats(R, p.W, p.U, p.TT, p.LS);
  err = allow_smem(reinterpret_cast<const void*>(fn), smem);
  if (err != cudaSuccess) return (int)err;
  // the largest shared-memory carveout, so that as many blocks fit an SM as
  // the shared memory allows
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(fn), cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.U - 1) / p.U;
  fn<<<blocks, 64 * p.W * p.U, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every launcher runs on `stream` and returns cudaGetLastError() (0 = ok).
// Host arrays (banks, mixes, strides, partial, mom) hold n_streams entries;
// the pointers they hold and every other pointer are device pointers.

// nbuf: record buffers in the ring, 1 to 3 (shared memory nbuf * the
// records of one bank row of every stream)
int srhmm_bank_emission(const void* ids, const void* const* banks, const int* mixes,
                        const int* strides, int n_streams, int NB, const void* feats, void* log_b,
                        int B, int T, int D, int LS, int full, int nbuf, int device, void* stream) {
  BankParams p;
  int bad = fill_bank(p, ids, banks, mixes, strides, n_streams, NB, feats, B, T, D, LS);
  if (bad) return bad;
  if (nbuf < 1 || nbuf > kMaxRing) return (int)cudaErrorInvalidValue;
  const int rb = register_bound(D, full != 0);
  void* fn = bank_kernel_for(0, rb, full != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)nbuf * p.rec_floats;
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kFrames * emission_frames(rb);
  const dim3 grid((T + per_block - 1) / per_block, B);
  reinterpret_cast<EmitFn>(fn)<<<grid, kFrames, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<float*>(log_b), nbuf);
  return (int)cudaGetLastError();
}

// R rows a lane (1, 2 or 4), W warps an utterance of each kind (32 R W >=
// LS), U utterances a block (64 W U <= 512 threads), TT frames a tile;
// shared memory forward_floats(U, TT, LS) floats
int srhmm_composed_forward(const void* log_b, const void* diag_col, const void* lengths, void* la,
                           int T, int LS, int B, int nd, int R, int W, int U, int TT, int device, void* stream) {
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
  p.W = W;
  p.TT = TT;
  return forward_launch(p, R, device, stream);
}

// R rows a lane (1, 2 or 4), W warps an utterance of each kind (32 R W >=
// LS), U utterances a block (64 W U <= 512 threads), TT frames a tile;
// shared memory backward_floats(R, W, U, TT) floats
int srhmm_composed_backward_stats(const void* log_b, const void* la, const void* diag_row,
                                  const void* lengths, const void* safe_z, const void* vmask,
                                  void* gamma, void* xi, void* den_trans, void* den_mix, int T,
                                  int LS, int B, int nd, int R, int W, int U, int TT, int device,
                                  void* stream) {
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
  p.W = W;
  p.TT = TT;
  return backward_launch(p, R, device, stream);
}

// The moments.  sorted (B * LS,) int32 and order (B * LS,) int64 are the
// flattened ids sorted stably and the sort's permutation; table (2 (NB + 1),)
// int32 is workspace for the chunk table; partial[q] holds n_chunks rows of
// M_q * Cm floats, n_chunks >= ceil(B LS / kChunk) + min(NB, B LS).  Pass 0
// builds the chunk table, pass 1 writes the chunks' partials, pass 2 sums
// them into mom[q] (NB, M_q * Cm).
int srhmm_bank_moments(const void* ids, const void* const* banks, const int* mixes,
                       const int* strides, int n_streams, int NB, const void* feats,
                       const void* gamma, long long g_st, long long g_sj, long long g_sb,
                       const void* lengths, const void* sorted, const void* order, void* table,
                       void* const* partial, int n_chunks, int slots,
                       void* const* mom, int B, int T, int D, int LS, int full, int device,
                       void* stream) {
  BankParams p;
  int bad = fill_bank(p, ids, banks, mixes, strides, n_streams, NB, feats, B, T, D, LS);
  if (bad) return bad;
  if (slots < 1 || slots > kMaxSlots || n_chunks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  MomParams m{};
  m.gamma = static_cast<const float*>(gamma);
  m.g_st = g_st;
  m.g_sj = g_sj;
  m.g_sb = g_sb;
  m.lengths = static_cast<const int*>(lengths);
  m.order = static_cast<const long long*>(order);
  int* offsets = static_cast<int*>(table);
  int* chunk_cum = offsets + NB + 1;
  m.offsets = offsets;
  m.chunk_cum = chunk_cum;
  m.slots = slots;
  const int Cm = full ? D + D * D + 1 : 2 * D + 1;
  size_t floats = 0;
  int max_cols = 0;
  for (int q = 0; q < n_streams; ++q) {
    m.partial[q] = static_cast<float*>(partial[q]);
    m.mom[q] = static_cast<float*>(mom[q]);
    m.cols[q] = mixes[q] * Cm;
    max_cols = m.cols[q] > max_cols ? m.cols[q] : max_cols;
    const size_t f = moments_floats(mixes[q], strides[q], D, Cm, slots);
    floats = f > floats ? f : floats;
  }
  void* fn = bank_kernel_for(1, register_bound(D, full != 0), full != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * floats + sizeof(int) * moments_ints(slots);
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  chunk_table_kernel<<<1, kTableThreads, 0, s>>>(static_cast<const int*>(sorted), B * LS, NB, offsets,
                                                 chunk_cum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reinterpret_cast<MomFn>(fn)<<<dim3(n_chunks, n_streams), kTile * slots, smem, s>>>(p, m);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(NB, (max_cols + kReduceThreads - 1) / kReduceThreads, n_streams);
  sum_chunks_kernel<<<grid, kReduceThreads, 0, s>>>(m);
  return (int)cudaGetLastError();
}

}  // extern "C"
