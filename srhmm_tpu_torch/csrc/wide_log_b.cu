// The emission pass of the vocabulary scorer (#1) and the word-loop decoder
// (#6-#8) at full covariance past D = 16, for NVIDIA Hopper (sm_90a).
//
// Part of the ports of srhmm_tpu/ops/pallas/scoring_pallas.py:301
// vocab_scores_pallas (the full branch of _stream_log_b, :157-163) and of
// srhmm_tpu/ops/pallas/decode_pallas.py:352 / :718 / :1050 (the full branch
// of _frame_log_b, :77-95).  The TPU kernels compute each frame's emission
// inside their recursions; at full covariance past D = 16 the port computes
// log b of every (frame, utterance) column a recursion will step and every
// row (word, state) of the vocabulary first, into a device buffer, and
// csrc/vocab_scores.cu / csrc/word_loop_decode.cu copy it into shared
// memory tile by tile (ops/kernels/wide_emission.py launches both).
//
// Per column (t, b) and row r: per stream the mixture log-likelihoods
// q = min(-1/2 sum_d z_d^2 + bias, log 1e20) + log w with z = L^T x + c
// (c = -L^T mu), the mixture logsumexp in mixture order (max seeded at
// NEG_INF, the 1e-38 guard), summed over the streams in stream order,
// unclamped (the recursions clamp after adding it, as they did).  Each z_d
// is bitwise emission.cuh full_mix_q's fmaf chain; only the sum of squares
// is taken in another order (per lane, then over a team of four lanes), so
// log b may differ from the lane kernels' in its last bits.
//
// Design (csrc/wide_gemm.cuh).  Block (x, y) takes kWideFrames columns of
// the caller's list from x kWideFrames on and the rows of row group y
// (consecutive rows; the blocks of one group run together, so its records
// stay in L2 while they do).  It stages each stream's features of its
// columns (zeros from D on) and walks the group's mixtures, row-major (row,
// mixture), in slices of kWideSlice streamed by cp.async through two
// buffers from records already in the staged layout (ops/kernels/common.py
// wide_records): one barrier a slice; warp w computes mixture w / 4 of the
// slice at 32 columns (wide_q: a float4 of L^T feeds 16 FMAs, the triangle
// below the diagonal skipped).  After that barrier thread c < kWideFrames
// pushes the previous slice's q of column c into its running logsumexp
// (lse_add, bitwise lse_push), closes a row's at its last mixture and
// writes (stream 0) or adds (the later streams) the row's log b at
// out[base(t, b) + r s_n], an element no other thread touches.
//
// The output layout is the caller's: base(t, b) = (b' / uo) s_ub + (t - t0)
// s_t + b' % uo with b' = b - b0.  The decoder takes (B, T, N) (a block's
// chunk of frames is one contiguous run), the scorer (B / U, T, N, U) (a
// frame's rows of a block's U utterances are one run).
//
// What bounds it on the H100: the z FMAs over L^T's triangle, D (D + 1) / 2
// + D a mixture and column, fp32 on the CUDA cores (67 TFLOP/s).  The
// records (7.2 KB a mixture at D = 39) are read once a block from L2,
// about a byte per 16 FMAs; log b is written once, 4 N bytes a column.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"
#include "tile_mma.cuh"
#include "wide_gemm.cuh"

namespace {

using namespace srhmm;

struct WideLogBParams {
  const float* feats[kMaxStreams];  // per stream: element (t, d, b) at t fst[0] + d fst[1] + b fst[2]
  long long fst[kMaxStreams][3];
  int dims[kMaxStreams];        // D_p
  int mixes[kMaxStreams];       // M_p
  long long offs[kMaxStreams];  // float offset of stream p's records in recs
  int n_streams;
  const float* recs;  // per stream N M_p staged records, row-major (row, mixture)
  const int* cols;    // (n_cols, 2): frame t, utterance b
  int n_cols;
  int N;               // rows
  int rows_per_group;  // rows of a block's group (grid y)
  float* out;
  int b0, t0, uo;  // the output layout (see the note at the top)
  long long s_ub, s_t, s_n;
};

template <int RB>
__global__ void __launch_bounds__(kWideThreads, 2) wide_log_b_kernel(const WideLogBParams p) {
  constexpr int P = wide_pitch(RB), MF = wide_mix_floats(RB), G = kWideSlice;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* slices = xs + kWideFrames * P;
  float* qs = slices + 2 * G * MF;
  __shared__ int col_t[kWideFrames], col_b[kWideFrames];
  const int tid = threadIdx.x, lane = tid & 31;
  const int gw = (tid >> 5) / (kWideFrames / 32), fg = (tid >> 5) % (kWideFrames / 32);
  const int c0 = blockIdx.x * kWideFrames;
  const int r0 = blockIdx.y * p.rows_per_group, nr = min(p.rows_per_group, p.N - r0);
  const bool mine = tid < kWideFrames && c0 + tid < p.n_cols;  // thread tid stores column c0 + tid
  long long base = 0;
  if (tid < kWideFrames) {
    const int c = min(c0 + tid, p.n_cols - 1);  // a column past the list repeats the last, never stored
    const int t = p.cols[2 * c], b = p.cols[2 * c + 1], bl = b - p.b0;
    col_t[tid] = t;
    col_b[tid] = b;
    base = (long long)(bl / p.uo) * p.s_ub + (long long)(t - p.t0) * p.s_t + bl % p.uo;
  }
  int n_st = 0;  // stages: per stream, slices of the group's nr M mixtures
  for (int q = 0; q < p.n_streams; ++q) n_st += (nr * p.mixes[q] + G - 1) / G;
  struct Stage {
    int q, mix0, n;
  };
  auto stage_at = [&](int q, int mix0) { return Stage{q, mix0, min(G, nr * p.mixes[q] - mix0)}; };
  auto start_copy = [&](int i, const Stage& s) {  // the copies of stage i's slice
    copy_staged_async<RB>(slices + (i & 1) * G * MF,
                          p.recs + p.offs[s.q] + ((size_t)r0 * p.mixes[s.q] + s.mix0) * MF, s.n);
    cp_async_commit();
  };
  auto stage_x = [&](int q) {  // stream q's features at the block's columns, zeros from D on
    const int D = p.dims[q];
    const float* f = p.feats[q];
    const long long s0 = p.fst[q][0], s1 = p.fst[q][1], s2 = p.fst[q][2];
    for (int i = tid; i < RB * kWideFrames; i += kWideThreads) {
      const int k = i / kWideFrames, c = i - k * kWideFrames;
      xs[c * P + k] = k < D ? __ldg(f + col_t[c] * s0 + k * s1 + col_b[c] * s2) : 0.f;
    }
  };
  Stage cur = stage_at(0, 0), prev = cur;
  start_copy(0, cur);
  __syncthreads();  // the columns are in
  stage_x(0);
  float mr = kNegInf, er = 0.f;
  for (int i = 0; i <= n_st; ++i) {
    cp_async_wait<0>();  // stage i's slice has landed
    __syncthreads();     // visible to all; stage i-1's q complete, its slice buffer free
    Stage next = cur;
    if (i + 1 < n_st) {
      next = cur.mix0 + G < nr * p.mixes[cur.q] ? stage_at(cur.q, cur.mix0 + G) : stage_at(cur.q + 1, 0);
      start_copy(i + 1, next);
    }
    if (i > 0 && tid < kWideFrames) {
      const int M = p.mixes[prev.q];
      const float* qv = qs + ((i - 1) & 1) * G * kWideFrames + tid;
      for (int g = 0; g < prev.n; ++g) {
        lse_add(qv[g * kWideFrames], mr, er);
        const int mi = prev.mix0 + g;
        if ((mi + 1) % M == 0) {  // the row's last mixture
          const float v = lse_value(mr, er);
          mr = kNegInf;
          er = 0.f;
          if (mine) {
            float* o = p.out + base + (long long)(r0 + mi / M) * p.s_n;
            *o = (prev.q == 0) ? v : *o + v;
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

template <int RB>
cudaError_t launch(const WideLogBParams& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * wide_emission_floats(RB);
  const cudaError_t err = wide_setup(reinterpret_cast<const void*>(wide_log_b_kernel<RB>), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_cols + kWideFrames - 1) / kWideFrames, (p.N + p.rows_per_group - 1) / p.rows_per_group);
  wide_log_b_kernel<RB><<<grid, kWideThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the pass on `stream` and returns cudaGetLastError() (0 = ok).
// feats / fstrides (t, d, b per stream, in floats) / dims / mixes / offs are
// host arrays of n_streams entries; feats' pointers, recs, cols and out are
// device pointers.  rb: the register bound of every stream's D (24, 32,
// 40, 48, 64; ops/kernels/composed.py register_bound).  Grid: the columns in
// tiles of 128, the rows in groups of rows_per_group (at most 65535 groups).
int srhmm_wide_log_b(const void* const* feats, const long long* fstrides, const int* dims, const int* mixes,
                     const long long* offs, int n_streams, int rb, const void* recs, const void* cols, int n_cols,
                     int N, int rows_per_group, void* out, int b0, int t0, int uo, long long s_ub, long long s_t,
                     long long s_n, int device, void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || n_cols < 1 || N < 1 || rows_per_group < 1 || uo < 1 ||
      (N + rows_per_group - 1) / rows_per_group > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WideLogBParams p = {};
  for (int i = 0; i < n_streams; ++i) {
    if (dims[i] < 1 || dims[i] > rb || mixes[i] < 1) return (int)cudaErrorInvalidValue;
    p.feats[i] = static_cast<const float*>(feats[i]);
    for (int j = 0; j < 3; ++j) p.fst[i][j] = fstrides[3 * i + j];
    p.dims[i] = dims[i];
    p.mixes[i] = mixes[i];
    p.offs[i] = offs[i];
  }
  p.n_streams = n_streams;
  p.recs = static_cast<const float*>(recs);
  p.cols = static_cast<const int*>(cols);
  p.n_cols = n_cols;
  p.N = N;
  p.rows_per_group = rows_per_group;
  p.out = static_cast<float*>(out);
  p.b0 = b0;
  p.t0 = t0;
  p.uo = uo;
  p.s_ub = s_ub;
  p.s_t = s_t;
  p.s_n = s_n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rb) {
    case 24: return (int)launch<24>(p, st);
    case 32: return (int)launch<32>(p, st);
    case 40: return (int)launch<40>(p, st);
    case 48: return (int)launch<48>(p, st);
    case 64: return (int)launch<64>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
