// GMM emission arithmetic shared by the Hopper kernels (vocab_scores.cu,
// fused_em.cu): the packed per-mixture record layout and the per-mixture /
// per-state log-likelihoods.  All arithmetic is fp32 fmaf on the CUDA cores,
// never TF32 or tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace srhmm {

constexpr int kMaxStreams = 6;
constexpr float kNegInf = -1e30f;
constexpr float kTiny = 1e-38f;
constexpr float kLogGausClamp = 46.051701859880914f;  // log(1e20)

// Record layouts (floats, every record 16-byte aligned), one record per
// (state, mixture), state-major (ops/kernels/common.py mixture_records):
//   diagonal: [mu*k (DMAX), -k/2 (DMAX), bias, log w, 0, 0]       2*DMAX + 4
//   full:     [L^T rows (D x DMAX), -L^T mu (DMAX), bias, log w, 0, 0]
//                                                                D*DMAX + DMAX + 4
// where the inverse covariance is K = L L^T.  vocab_scores folds log w into
// the diagonal bias and stores 0 in its slot (adding 0.0f is exact).
__host__ __device__ constexpr int record_stride(int dmax, int D, bool full) {
  return full ? D * dmax + dmax + 4 : 2 * dmax + 4;
}

template <int DMAX, bool FULL>
__host__ __device__ constexpr int record_stride(int D) {
  return record_stride(DMAX, D, FULL);
}

// online logsumexp over mixtures: max seeded at NEG_INF
__device__ __forceinline__ void lse_push(float q, float& m, float& e) {
  if (q > m) {
    e = e * expf(m - q) + 1.f;
    m = q;
  } else {
    e += expf(q - m);
  }
}

__device__ __forceinline__ float lse_value(float m, float e) { return logf(fmaxf(e, kTiny)) + m; }

// Weighted diagonal-covariance mixture log-likelihood:
// q = bias + <mu*k, x> + <-k/2, x^2> + log w.
template <int DMAX>
__device__ __forceinline__ float diag_mix_q(const float* rec, const float (&x)[DMAX],
                                            const float (&x2)[DMAX]) {
  const float4* lin = reinterpret_cast<const float4*>(rec);
  const float4* quad = reinterpret_cast<const float4*>(rec + DMAX);
  float acc = rec[2 * DMAX];
#pragma unroll
  for (int i = 0; i < DMAX / 4; ++i) {
    const float4 l = lin[i];
    const float4 q = quad[i];
    acc = fmaf(l.x, x[4 * i + 0], acc);
    acc = fmaf(l.y, x[4 * i + 1], acc);
    acc = fmaf(l.z, x[4 * i + 2], acc);
    acc = fmaf(l.w, x[4 * i + 3], acc);
    acc = fmaf(q.x, x2[4 * i + 0], acc);
    acc = fmaf(q.y, x2[4 * i + 1], acc);
    acc = fmaf(q.z, x2[4 * i + 2], acc);
    acc = fmaf(q.w, x2[4 * i + 3], acc);
  }
  return acc + rec[2 * DMAX + 1];
}

// Weighted full-covariance mixture log-likelihood through the Cholesky
// factor: z = L^T x - L^T mu, q = min(-1/2 sum z^2 + bias, log 1e20) + log w
// (the reference's 1e20 density clamp lands before the weight).
template <int DMAX>
__device__ __forceinline__ float full_mix_q(const float* rec, int D, const float (&x)[DMAX]) {
  const float* bg = rec + D * DMAX;
  float quad = 0.f;
  for (int d = 0; d < D; ++d) {
    const float4* row = reinterpret_cast<const float4*>(rec + d * DMAX);
    float z = bg[d];
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      const float4 r = row[i];
      z = fmaf(r.x, x[4 * i + 0], z);
      z = fmaf(r.y, x[4 * i + 1], z);
      z = fmaf(r.z, x[4 * i + 2], z);
      z = fmaf(r.w, x[4 * i + 3], z);
    }
    quad = fmaf(z, z, quad);
  }
  return fminf(fmaf(-0.5f, quad, bg[DMAX]), kLogGausClamp) + bg[DMAX + 1];
}

// Per-state mixture logsumexp log b over the state's M records.
template <int DMAX>
__device__ __forceinline__ float diag_state_log_b(const float* rec, int M, const float (&x)[DMAX],
                                                  const float (&x2)[DMAX]) {
  float m = kNegInf, e = 0.f;
  for (int mix = 0; mix < M; ++mix, rec += 2 * DMAX + 4) lse_push(diag_mix_q<DMAX>(rec, x, x2), m, e);
  return lse_value(m, e);
}

template <int DMAX>
__device__ __forceinline__ float full_state_log_b(const float* rec, int M, int D,
                                                  const float (&x)[DMAX]) {
  const int stride = record_stride<DMAX, true>(D);
  float m = kNegInf, e = 0.f;
  for (int mix = 0; mix < M; ++mix, rec += stride) lse_push(full_mix_q<DMAX>(rec, D, x), m, e);
  return lse_value(m, e);
}

// lse_push with selects in place of its branch, which the lanes take
// different ways: the same operations on the same values (the sum e is 0
// or >= 1 before every push, so a denormal term rounds away whether or not
// the compiler fuses its add into expf's last multiply)
__device__ __forceinline__ void lse_push_select(float q, float& m, float& e) {
  const bool up = q > m;
  const float t = expf(up ? m - q : q - m);
  e = up ? fmaf(e, t, 1.f) : e + t;
  m = up ? q : m;
}

// diag_mix_q of NC feature columns: each column's fmaf chain exactly
// diag_mix_q's (x^2 rounded on its own before it enters the chain), each
// record float4 read once for the NC columns.
template <int DMAX, int NC>
__device__ __forceinline__ void diag_mix_q_cols(const float* rec, const float (&x)[NC][DMAX], float (&q)[NC]) {
  const float4* lin = reinterpret_cast<const float4*>(rec);
  const float4* quad = reinterpret_cast<const float4*>(rec + DMAX);
#pragma unroll
  for (int c = 0; c < NC; ++c) q[c] = rec[2 * DMAX];
#pragma unroll
  for (int i = 0; i < DMAX / 4; ++i) {
    const float4 l = lin[i];
    const float4 w = quad[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* xc = x[c] + 4 * i;
      q[c] = fmaf(l.x, xc[0], q[c]);
      q[c] = fmaf(l.y, xc[1], q[c]);
      q[c] = fmaf(l.z, xc[2], q[c]);
      q[c] = fmaf(l.w, xc[3], q[c]);
      q[c] = fmaf(w.x, xc[0] * xc[0], q[c]);
      q[c] = fmaf(w.y, xc[1] * xc[1], q[c]);
      q[c] = fmaf(w.z, xc[2] * xc[2], q[c]);
      q[c] = fmaf(w.w, xc[3] * xc[3], q[c]);
    }
  }
  const float lw = rec[2 * DMAX + 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) q[c] = q[c] + lw;
}

// full_mix_q of NC feature columns, each column's arithmetic exactly
// full_mix_q's, each row of L^T read once for the NC columns.
template <int DMAX, int NC>
__device__ __forceinline__ void full_mix_q_cols(const float* rec, int D, const float (&x)[NC][DMAX], float (&q)[NC]) {
  const float* bg = rec + D * DMAX;
  float quad[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) quad[c] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float4* row = reinterpret_cast<const float4*>(rec + d * DMAX);
    float z[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) z[c] = bg[d];
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      const float4 r = row[i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        z[c] = fmaf(r.x, x[c][4 * i + 0], z[c]);
        z[c] = fmaf(r.y, x[c][4 * i + 1], z[c]);
        z[c] = fmaf(r.z, x[c][4 * i + 2], z[c]);
        z[c] = fmaf(r.w, x[c][4 * i + 3], z[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) quad[c] = fmaf(z[c], z[c], quad[c]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) q[c] = fminf(fmaf(-0.5f, quad[c], bg[DMAX]), kLogGausClamp) + bg[DMAX + 1];
}

// diag_state_log_b / full_state_log_b of NC feature columns at once, the
// same values bit for bit: two mixtures' chains of the NC columns side by
// side, pushed in mixture order.
template <int DMAX, bool FULL, int NC>
__device__ __forceinline__ void state_log_b_cols(const float* rec, int M, int D, const float (&x)[NC][DMAX],
                                                 float (&out)[NC]) {
  const int stride = record_stride<DMAX, FULL>(D);
  float m[NC], e[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) m[c] = kNegInf, e[c] = 0.f;
  int mix = 0;
  for (; mix + 2 <= M; mix += 2, rec += 2 * stride) {
    float qa[NC], qb[NC];
    if constexpr (FULL) {
      full_mix_q_cols<DMAX, NC>(rec, D, x, qa);
      full_mix_q_cols<DMAX, NC>(rec + stride, D, x, qb);
    } else {
      diag_mix_q_cols<DMAX, NC>(rec, x, qa);
      diag_mix_q_cols<DMAX, NC>(rec + stride, x, qb);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) lse_push_select(qa[c], m[c], e[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c) lse_push_select(qb[c], m[c], e[c]);
  }
  if (mix < M) {
    float qa[NC];
    if constexpr (FULL) {
      full_mix_q_cols<DMAX, NC>(rec, D, x, qa);
    } else {
      diag_mix_q_cols<DMAX, NC>(rec, x, qa);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) lse_push_select(qa[c], m[c], e[c]);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) out[c] = lse_value(m[c], e[c]);
}

}  // namespace srhmm
