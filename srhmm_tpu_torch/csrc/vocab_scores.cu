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
// state 0 and is always taken; frames t >= length keep the carry (the loop
// simply stops there).
//
// Design.  One thread per (utterance, word); a block holds 128 utterances of
// one word (grid = (ceil(B/128), W)).  The word's packed constants are staged
// in shared memory once and read as warp-wide broadcasts; the S log-alpha
// values and the per-frame log b of each thread live in shared memory
// columns (index s * blockDim + tid: conflict-free), so S and the band are
// runtime values.  Each frame's features are read in the (T, D, B) layout,
// neighbouring threads on neighbouring addresses, into registers x[DMAX]
// (DMAX a template bound on D, padded with zeros).  The whole time loop runs
// inside the kernel: one launch per call.  All arithmetic is fp32 FMA, so
// there is no TF32 question.
//
// What bounds it on the H100.  Device-memory traffic is the features, read
// once per word block: W * T * sum(D_p) * B * 4 bytes, mostly served by the
// 50 MB L2 because the feature tensor of a batch is smaller than L2 at the
// recognizer's shapes.  Arithmetic is ~2 D flops per (state, mixture) on the
// diagonal path and ~2 D^2 on the full path, per frame, utterance and word;
// at the main-path shapes that is the larger bound, and the shared-memory
// broadcast loads of the constants (float4, one per four FMAs) are the
// instruction-issue limit.  The parallelism is B * W threads, and the
// sequential time loop cannot be split.  Later work: tensor-core emission at
// full fp32 precision, TMA feature staging shared across word blocks, and
// fewer re-reads of the features.

#include <cuda_runtime.h>
#include <math.h>

#include "emission.cuh"

namespace {

using namespace srhmm;

constexpr int kMaxThreads = 128;

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
  int T, B, S, band;
};

// The records of a word block follow csrc/emission.cuh (log w folded into
// the diagonal bias), then the (band+1, S) log-transition diagonals.

template <int DMAX, bool FULL, bool VITERBI>
__global__ void __launch_bounds__(kMaxThreads) vocab_scores_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int w = blockIdx.y;
  const int b = blockIdx.x * nt + tid;
  const int S = p.S;

  const float4* src = reinterpret_cast<const float4*>(p.consts + (size_t)w * p.C);
  for (int i = tid; i < p.C / 4; i += nt) smem4[i] = src[i];
  __syncthreads();
  if (b >= p.B) return;  // no barrier below this point

  const float* cst = smem;
  const float* diag = cst + p.diag_off;  // diag[d * S + j] = log a_w[j-d, j]
  float* alpha = smem + p.C;             // alpha[s * nt + tid]
  float* lb = alpha + S * nt;            // lb[s * nt + tid]

  const int t_end = min(max(p.lengths[b], 1), p.T);
  for (int t = 0; t < t_end; ++t) {
    for (int q = 0; q < p.n_streams; ++q) {
      const int D = p.dims[q];
      const int M = p.mixes[q];
      const int stride = record_stride<DMAX, FULL>(D);
      const float* f = p.feats[q] + (size_t)t * D * p.B + b;
      float x[DMAX];
#pragma unroll
      for (int e = 0; e < DMAX; ++e) x[e] = (e < D) ? __ldg(f + (size_t)e * p.B) : 0.f;
      const float* rec = cst + p.offs[q];
      if constexpr (FULL) {
        for (int s = 0; s < S; ++s) {
          const float v = full_state_log_b<DMAX>(rec + s * M * stride, M, D, x);
          lb[s * nt + tid] = (q == 0) ? v : lb[s * nt + tid] + v;
        }
      } else {
        float x2[DMAX];
#pragma unroll
        for (int e = 0; e < DMAX; ++e) x2[e] = x[e] * x[e];
        for (int s = 0; s < S; ++s) {
          const float v = diag_state_log_b<DMAX>(rec + s * M * stride, M, x, x2);
          lb[s * nt + tid] = (q == 0) ? v : lb[s * nt + tid] + v;
        }
      }
    }
    if (t == 0) {
      for (int s = 0; s < S; ++s)
        alpha[s * nt + tid] = fmaxf((s == 0 ? 0.f : kNegInf) + lb[s * nt + tid], kNegInf);
      continue;
    }
    // descending j: alpha[j - d] (d >= 0) still holds frame t-1's value
    for (int j = S - 1; j >= 0; --j) {
      const int dj = min(p.band, j);  // shifts that would cross a word start are skipped
      float m = kNegInf;
      for (int d = 0; d <= dj; ++d) m = fmaxf(m, alpha[(j - d) * nt + tid] + diag[d * S + j]);
      float upd = m;
      if constexpr (!VITERBI) {
        float e = 0.f;
        for (int d = 0; d <= dj; ++d) e += expf(alpha[(j - d) * nt + tid] + diag[d * S + j] - m);
        upd = fmaxf(logf(fmaxf(e, kTiny)) + m, kNegInf);
      }
      alpha[j * nt + tid] = fmaxf(upd + lb[j * nt + tid], kNegInf);
    }
  }
  for (int s = 0; s < S; ++s) p.out[((size_t)w * S + s) * p.B + b] = alpha[s * nt + tid];
}

template <int DMAX, bool FULL, bool VITERBI>
cudaError_t launch(const Params& p, int W, int threads, size_t smem, cudaStream_t stream) {
  auto kernel = vocab_scores_kernel<DMAX, FULL, VITERBI>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((p.B + threads - 1) / threads, W);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t dispatch(const Params& p, int W, int threads, size_t smem, cudaStream_t stream,
                     int full, int viterbi) {
  if (full) {
    return viterbi ? launch<DMAX, true, true>(p, W, threads, smem, stream)
                   : launch<DMAX, true, false>(p, W, threads, smem, stream);
  }
  return viterbi ? launch<DMAX, false, true>(p, W, threads, smem, stream)
                 : launch<DMAX, false, false>(p, W, threads, smem, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// feats/dims/mixes/offs are host arrays of n_streams entries; the pointers
// they hold, consts, lengths and out are device pointers.
int srhmm_vocab_scores(const void* const* feats, const int* dims, const int* mixes,
                       const int* offs, int n_streams, const void* consts, int C,
                       int diag_off, const void* lengths, void* out, int T, int B, int W, int S,
                       int band, int full, int viterbi, int dmax, int threads, int device,
                       void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || C % 4 != 0 || W < 1 || W > 65535 || B < 1 || T < 1 || S < 1 ||
      band < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  for (int i = 0; i < n_streams; ++i) {
    p.feats[i] = static_cast<const float*>(feats[i]);
    p.dims[i] = dims[i];
    p.mixes[i] = mixes[i];
    p.offs[i] = offs[i];
  }
  p.n_streams = n_streams;
  p.consts = static_cast<const float*>(consts);
  p.C = C;
  p.diag_off = diag_off;
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<float*>(out);
  p.T = T;
  p.B = B;
  p.S = S;
  p.band = band;
  const size_t smem = sizeof(float) * ((size_t)C + 2 * (size_t)S * threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dmax) {
    case 4: return (int)dispatch<4>(p, W, threads, smem, st, full, viterbi);
    case 8: return (int)dispatch<8>(p, W, threads, smem, st, full, viterbi);
    case 12: return (int)dispatch<12>(p, W, threads, smem, st, full, viterbi);
    case 16: return (int)dispatch<16>(p, W, threads, smem, st, full, viterbi);
    case 32: return (int)dispatch<32>(p, W, threads, smem, st, full, viterbi);
    case 64: return (int)dispatch<64>(p, W, threads, smem, st, full, viterbi);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* srhmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
