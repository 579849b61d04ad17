// Helpers shared by the Hopper kernels of composed.cu and fused_em.cu:
// asynchronous staging of tiles into shared memory (cp.async), and the
// gamma-weighted moment contraction on the tensor cores in 3xTF32.
#pragma once

#include <cuda_runtime.h>

namespace srhmm {

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// one float; ok = false writes 0.0f to dst and reads nothing (src must
// still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// four floats, both addresses 16-byte aligned; ok = false writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows of U consecutive floats of a (T, X, B) tensor into shared
// memory: float (t0 + tt, x, b0 + u) goes to dst[tt * s_t + x * s_x + u]
// for tt < n, x < X, u < U; floats with t0 + tt outside [0, T) or b0 + u
// >= B become 0.0f.  The copying threads are threadIdx.x in [first, first +
// count) (U divides count); neighbouring threads take neighbouring
// addresses.  Where U and B are multiples of 4 (and dst, s_t, s_x, b0
// too) a copy moves 16 bytes, else 4: the number of copies in flight, not
// the bytes, bounds the rate of small ones.
__device__ __forceinline__ void stage_rows_async(float* dst, int s_t, int s_x, const float* src, int t0, int n,
                                                 int X, int T, int B, int b0, int U, int first, int count) {
  const int i = threadIdx.x - first;
  if (i < 0 || i >= count) return;
  const int w = (U % 4 == 0 && B % 4 == 0) ? 4 : 1;  // floats a copy
  const int G = U / w, step = count / G, g = i % G;
  const bool b_ok = b0 + g * w < B;
  int x = i / G, tt = 0;
  while (x >= X) {
    x -= X;
    ++tt;
  }
  while (tt < n) {
    const int t = t0 + tt;
    const bool ok = b_ok && t >= 0 && t < T;
    float* d = dst + tt * s_t + x * s_x + g * w;
    const float* s = ok ? src + ((size_t)t * X + x) * B + b0 + g * w : src;
    if (w == 4) {
      cp_async16(d, s, ok);
    } else {
      cp_async4(d, s, ok);
    }
    x += step;
    while (x >= X) {
      x -= X;
      ++tt;
    }
  }
}

// The way back: float dst[(t0 + tt) * X * B + x * B + b0 + u] = tile[tt *
// s_t + x * U + u] for tt < n, x < X, u < U with b0 + u < B, rows of U
// consecutive floats as they sit in the tile (16-byte stores where U and B
// are multiples of 4).  The storing threads are i in [0, count) (U / 4 or U
// divides count).
__device__ __forceinline__ void store_rows_from_tile(float* dst, const float* tile, int s_t, int t0, int n, int X,
                                                     int B, int b0, int U, int i, int count) {
  const int w = (U % 4 == 0 && B % 4 == 0) ? 4 : 1, G = U / w;
  const int step = count / G, g = i % G;
  if (b0 + g * w >= B) return;
  int x = i / G, tt = 0;
  while (x >= X) x -= X, ++tt;
  while (tt < n) {
    const float* s = tile + (size_t)tt * s_t + x * U + g * w;
    float* d = dst + ((size_t)(t0 + tt) * X + x) * B + b0 + g * w;
    if (w == 4) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else {
      *d = *s;
    }
    x += step;
    while (x >= X) x -= X, ++tt;
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 contraction
// ---------------------------------------------------------------------------

// the posterior weights enter the tensor cores times 2^48 (exact): a
// subnormal weight then keeps all its bits through the TF32 split, and the
// sums are scaled back by 2^-48 when written
constexpr float kWeightScale = 0x1p48f;
constexpr float kWeightUnscale = 0x1p-48f;

// v = hi + lo with hi and lo both tf32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a b for one m16n8k8 tile: a (16 x 8, row-major) and b (8 x 8) in the
// mma.sync fragment layout, c in fp32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One column of the moment lift [x; x^2 or vec(x x^T); 1] as a product of
// at most two staged feature rows: mode 0 zero (padding), 1 x[ia], 2
// x[ia] * x[ib], 3 one.  Column D + d*D + e of the full lift is x[e] x[d].
struct LiftCol {
  int mode, ia, ib;
};

template <bool FULL>
__device__ __forceinline__ LiftCol lift_col(int n, int D, int Cm) {
  if (n < D) return {1, n, 0};
  if (n == Cm - 1) return {3, 0, 0};
  if (n >= Cm) return {0, 0, 0};
  if constexpr (FULL) {
    const int r = n - D, d = r / D;
    return {2, r - d * D, d};
  } else {
    return {2, n - D, n - D};
  }
}

// without a branch (the lanes of a warp hold different columns): x[ia] *
// 1.0f is x[ia] exactly; modes 0 and 3 read (and drop) feature row 0
__device__ __forceinline__ float lift_value(const LiftCol& c, const float* x, int ks, int k) {
  const float a = x[c.ia * ks + k];
  const float v = a * (c.mode == 2 ? x[c.ib * ks + k] : 1.f);
  return c.mode == 3 ? 1.f : (c.mode == 0 ? 0.f : v);
}

// acc (rows, Cm) += W lift over ksteps * 8 staged columns, on the tensor
// cores in 3xTF32 (lo*hi + hi*lo + hi*hi into fp32): W (rows, ks) the
// posterior weights, x (D, ks) the features whose lift
// [x; x^2 or vec(x x^T); 1] is formed on the fly.  The work is cut into
// units of (16 rows) x (2 x 8 columns), unit `warp` and every `nwarps`-th
// after it taken by this warp; each accumulator belongs to one unit and is
// summed over the columns in mma order, so the result is the same on
// every run.  acc, W and x are in shared memory; the caller synchronises.
template <bool FULL>
__device__ __forceinline__ void contract_3xtf32(float* acc, int rows, int Cm, const float* w, const float* x,
                                                int ks, int D, int ksteps, int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mt_n = (rows + 15) / 16, nt_n = (Cm + 7) / 8, ng_n = (nt_n + 1) / 2;
  for (int un = warp; un < mt_n * ng_n; un += nwarps) {
    const int mt = un / ng_n, nt0 = (un - mt * ng_n) * 2;
    const int m0 = mt * 16 + gid, m1 = m0 + 8;
    float c[2][4];
    LiftCol col[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n0 = (nt0 + hh) * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (i < 2) ? m0 : m1, n = n0 + (i & 1);
        c[hh][i] = (m < rows && n < Cm) ? acc[m * Cm + n] : 0.f;
      }
      col[hh] = lift_col<FULL>((nt0 + hh) * 8 + gid, D, Cm);
    }
    const bool two = nt0 + 1 < nt_n;
    for (int kk = 0; kk < ksteps; ++kk) {
      const int k0 = kk * 8 + tig, k1 = k0 + 4;
      unsigned ahi[4], alo[4];
      split_tf32(m0 < rows ? w[m0 * ks + k0] : 0.f, ahi[0], alo[0]);
      split_tf32(m1 < rows ? w[m1 * ks + k0] : 0.f, ahi[1], alo[1]);
      split_tf32(m0 < rows ? w[m0 * ks + k1] : 0.f, ahi[2], alo[2]);
      split_tf32(m1 < rows ? w[m1 * ks + k1] : 0.f, ahi[3], alo[3]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (hh == 1 && !two) break;
        unsigned b0h, b0l, b1h, b1l;
        split_tf32(lift_value(col[hh], x, ks, k0), b0h, b0l);
        split_tf32(lift_value(col[hh], x, ks, k1), b1h, b1l);
        mma_tf32(c[hh], alo, b0h, b1h);
        mma_tf32(c[hh], ahi, b0l, b1l);
        mma_tf32(c[hh], ahi, b0h, b1h);
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n0 = (nt0 + hh) * 8 + 2 * tig;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = (i < 2) ? m0 : m1, n = n0 + (i & 1);
        if (m < rows && n < Cm) acc[m * Cm + n] = c[hh][i];
      }
    }
  }
}

}  // namespace srhmm
