"""Where the time of the hand-written kernels goes, by ablation (needs a
CUDA card and nvcc; not a tier-1 test):

    python tests/torch_kernel_variants.py [--tree DIR] [variant ...]

Each variant is a copy of a tree (this checkout, or DIR: another checkout
unpacked with git archive) in a temporary directory with parts of one
kernel cut out (its results are then wrong: only the time is read) or with
clock64 counters that print "CYC" lines.  After the build, a timing script
of this checkout runs with the copy's package on PYTHONPATH:
tests/torch_backward_compare.py time for csrc/composed.cu's
composed_backward_stats_kernel and csrc/fused_em.cu's backward_stats_kernel
(composed_backward_stats at emb_c4 / tied_c5 lattice shapes, backward_stats
at em_diag's), tests/torch_forward_decode_compare.py time for the
composed_forward and word-loop decode kernels (emb_c4 / tied_c5, dec_w200
K = 1, 2, 3), and the other compare scripts' `time` for the kernels they
compare (tests/torch_lattice_stats_compare.py for csrc/lattice.cu's
kernels and csrc/emission_em.cu's moments; the backward and Viterbi
variants time only backward_lattice and viterbi_batch;
tests/torch_bank_wide_compare.py for the "wide_" variants of the bank
kernels' z-GEMM blocks at full D = 39, tests/torch_em_wide_compare.py for
the "emw_" variants of the E-step's z-GEMM blocks at em_full39).  The "parent_"
variants cut a kernel as it was before its redesign (run them with --tree
on a checkout of that commit).
Prints one JSON line per variant with the kernel times and the last CYC
lines.  With no variant named every variant that applies runs, "base" (no
cut) first and last.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COMP, FEM = "srhmm_tpu_torch/csrc/composed.cu", "srhmm_tpu_torch/csrc/fused_em.cu"
DEC, DEC_PY = "srhmm_tpu_torch/csrc/word_loop_decode.cu", "srhmm_tpu_torch/ops/kernels/decode.py"
COMP_PY = "srhmm_tpu_torch/ops/kernels/composed.py"
MFCC = "srhmm_tpu_torch/csrc/mfcc.cu"
VOC, EMI = "srhmm_tpu_torch/csrc/vocab_scores.cu", "srhmm_tpu_torch/csrc/emission_em.cu"
LAT = "srhmm_tpu_torch/csrc/lattice.cu"
SCO_PY = "srhmm_tpu_torch/ops/kernels/scoring.py"
EMC = "srhmm_tpu_torch/csrc/emission.cuh"
WIDE = "srhmm_tpu_torch/csrc/wide_gemm.cuh"
EMI_PY = "srhmm_tpu_torch/ops/kernels/emission.py"
# emission.cuh's full_mix_q_cols with two rows' z chains side by side (a
# helper full_row_z computing one row's chain), the squares summed in row
# order: bitwise the one-row loop's
FULL_ROW_Z = """// z_d = row d of L^T . x - (L^T mu)_d for NC columns, full_mix_q's fmaf
// chain
template <int DMAX, int NC>
__device__ __forceinline__ void full_row_z(const float* rec, const float* bg, int d, const float (&x)[NC][DMAX],
                                           float (&z)[NC]) {
  const float4* row = reinterpret_cast<const float4*>(rec + d * DMAX);
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
}

// full_mix_q of NC feature columns"""
FULL_SINGLE = """  for (int d = 0; d < D; ++d) {
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
  }"""
FULL_PAIRS = """  int d = 0;
  for (; d + 2 <= D; d += 2) {
    float z0[NC], z1[NC];
    full_row_z<DMAX, NC>(rec, bg, d, x, z0);
    full_row_z<DMAX, NC>(rec, bg, d + 1, x, z1);
#pragma unroll
    for (int c = 0; c < NC; ++c) quad[c] = fmaf(z0[c], z0[c], quad[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c) quad[c] = fmaf(z1[c], z1[c], quad[c]);
  }
  if (d < D) {
    float z[NC];
    full_row_z<DMAX, NC>(rec, bg, d, x, z);
#pragma unroll
    for (int c = 0; c < NC; ++c) quad[c] = fmaf(z[c], z[c], quad[c]);
  }"""
FEM_PY, MFCC_PY = "srhmm_tpu_torch/ops/kernels/fused_em.py", "srhmm_tpu_torch/ops/kernels/mfcc.py"
C_STATS = ("    if (k >= 1) {\n      const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0);\n      float* la_tile",
           "    if (false) {\n      const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0);\n      float* la_tile")
C_REC = ("        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt = t - t_lo;\n          float* in_row",
         "        for (int t = t_hi - 1; t >= t_hi; --t) {\n          const int tt = t - t_lo;\n          float* in_row")
C_STAGE = ("      if (k + 1 < n_tiles) stage(k + 1);\n      if (k < n_tiles) {", "      if (k < n_tiles) {")
E_STATS = ("    if (k >= 1) {\n      const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0), n",
           "    if (false) {\n      const int t_hi = T - (k - 1) * TT, t_lo = max(t_hi - TT, 0), n")
E_REC = ("        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt",
         "        for (int t = t_hi - 1; t >= t_hi; --t) {\n          const int tt")
E_STAGE = ("      if (k + 1 < n_tiles) stage(k + 1);\n      if (k < n_tiles) {", "      if (k < n_tiles) {")

# cycle counts (clock64) of the phases of block 0, printed by its first
# recursion and first statistics thread: "CYC ..." lines
C_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("    for (int k = 0; k <= n_tiles; ++k) {\n      // tile k+1 goes into the slots",
     "    long long cy_rec = 0, cy_sync = 0;\n    int n_fr = 0;\n    for (int k = 0; k <= n_tiles; ++k) {\n      // tile k+1 goes into the slots"),
    ("        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt = t - t_lo;\n          float* in_row",
     "        const long long c0 = clock64();\n        n_fr += t_hi - t_lo;\n        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt = t - t_lo;\n          float* in_row"),
    ("          store_rows<R>(beta_tile + ((size_t)tt * U + u) * LP + j0, beta);\n        }\n      }\n      cp_async_wait<0>();\n      __syncthreads();\n    }\n    return;",
     "          store_rows<R>(beta_tile + ((size_t)tt * U + u) * LP + j0, beta);\n        }\n        cy_rec += clock64() - c0;\n      }\n      const long long c1 = clock64();\n      cp_async_wait<0>();\n      __syncthreads();\n      cy_sync += clock64() - c1;\n    }\n    if (blockIdx.x == 0 && tid == 0) printf(\"CYC composed recursion %lld sync %lld frames %d\\n\", cy_rec, cy_sync, n_fr);\n    return;"),
    ("  const int st = tid - role_threads;\n  for (int k = 0; k <= n_tiles; ++k) {",
     "  const int st = tid - role_threads;\n  long long cy_stage = 0, cy_comp = 0, cy_out = 0, cy_wait = 0;\n  for (int k = 0; k <= n_tiles; ++k) {\n    long long c0 = clock64();"),
    ("      named_barrier(2, role_threads);  // the tile's gamma is complete",
     "      cy_comp += clock64() - c0;\n      c0 = clock64();\n      named_barrier(2, role_threads);  // the tile's gamma is complete"),
    ("    __syncthreads();\n  }\n  if (live) {",
     "    cy_out += clock64() - c0;\n    c0 = clock64();\n    __syncthreads();\n    cy_wait += clock64() - c0;\n  }\n  if (blockIdx.x == 0 && st == 0) printf(\"CYC composed stage %lld statistics %lld out %lld wait %lld\\n\", cy_stage, cy_comp, cy_out, cy_wait);\n  if (live) {"),
)
E_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("    for (int k = 0; k <= n_tiles; ++k) {\n      // tile k+1 goes into the slot of",
     "    long long cy_rec = 0, cy_sync = 0;\n    int n_fr = 0;\n    for (int k = 0; k <= n_tiles; ++k) {\n      // tile k+1 goes into the slot of"),
    ("        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt",
     "        const long long c0 = clock64();\n        n_fr += t_hi - t_lo;\n        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt"),
    ("          g_tile[(size_t)tt * nt + tid] = gamma;\n        }\n      }\n      cp_async_wait<0>();\n      __syncthreads();\n    }",
     "          g_tile[(size_t)tt * nt + tid] = gamma;\n        }\n        cy_rec += clock64() - c0;\n      }\n      const long long c1 = clock64();\n      cp_async_wait<0>();\n      __syncthreads();\n      cy_sync += clock64() - c1;\n    }\n    if (blockIdx.x == 0 && tid == 0) printf(\"CYC em recursion %lld sync %lld frames %d\\n\", cy_rec, cy_sync, n_fr);"),
    ("  const int st = tid - n_rec, swarp = st >> 5;\n  for (int k = 0; k <= n_tiles; ++k) {",
     "  const int st = tid - n_rec, swarp = st >> 5;\n  long long cy_stage = 0, cy_cols = 0, cy_em = 0, cy_mma = 0, cy_wait = 0;\n  for (int k = 0; k <= n_tiles; ++k) {\n    long long c0 = clock64();"),
    ("      const int nk = count, k8",
     "      cy_cols += clock64() - c0;\n      c0 = clock64();\n      const int nk = count, k8"),
    ("        named_barrier(2, n_stat);\n        contract_3xtf32",
     "        named_barrier(2, n_stat);\n        cy_em += clock64() - c0;\n        c0 = clock64();\n        contract_3xtf32"),
    ("        named_barrier(2, n_stat);  // the weights and features are free again\n",
     "        named_barrier(2, n_stat);  // the weights and features are free again\n        cy_mma += clock64() - c0;\n        c0 = clock64();\n"),
    ("    __syncthreads();\n  }\n  for (int i = st;",
     "    c0 = clock64();\n    __syncthreads();\n    cy_wait += clock64() - c0;\n  }\n  if (blockIdx.x == 0 && st == 0) printf(\"CYC em stage %lld columns %lld emission %lld contraction %lld wait %lld\\n\", cy_stage, cy_cols, cy_em, cy_mma, cy_wait);\n  for (int i = st;"),
)


# the 03f5319 composed_forward_kernel: per-frame cycles of thread 20 U of
# block 0 (row 20 of utterance 0): the load of log_b (until it is ready),
# the log-sum-exp, the stores (shared row and log-alpha), the barrier
PF_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  float carry = kNegInf;\n  for (int t = 0; t < p.T; ++t) {\n    const size_t o = ((size_t)t * LS + j) * p.B + b;\n"
     "    const float lb = live ? p.log_b[o] : kNegInf;\n",
     "  float carry = kNegInf;\n  long long cy_load = 0, cy_lse = 0, cy_store = 0, cy_bar = 0;\n"
     "  for (int t = 0; t < p.T; ++t) {\n    const size_t o = ((size_t)t * LS + j) * p.B + b;\n"
     "    long long c0 = clock64();\n    float lb = live ? p.log_b[o] : kNegInf;\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(lb));\n    cy_load += clock64() - c0;\n    c0 = clock64();\n"),
    ("      carry = fmaxf(upd + lb, kNegInf);\n    }\n    sh[(t & 1) * nt + tid] = carry;\n"
     "    if (live) p.la_out[o] = carry;\n    __syncthreads();\n  }\n}\n",
     "      carry = fmaxf(upd + lb, kNegInf);\n    }\n    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(carry));\n"
     "    cy_lse += clock64() - c0;\n    c0 = clock64();\n    sh[(t & 1) * nt + tid] = carry;\n"
     "    if (live) p.la_out[o] = carry;\n    cy_store += clock64() - c0;\n    c0 = clock64();\n"
     "    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && tid == 20 * U) printf(\"CYC forward LS %d load %lld lse %lld store %lld barrier %lld "
     "frames %d\\n\", LS, cy_load, cy_lse, cy_store, cy_bar, p.T);\n}\n"),
)
# the 03f5319 word_loop_decode_kernel: cycles of threads 0 and nt - 32 of
# block 0 over the whole utterance: the chunk's features, its emission (each
# with its barrier), the cross-word phase (bigram: the exit phase with its
# barrier, the merge, the wait at its barrier), the within-word candidates
# with the pointer writes, the barrier closing the frame
PD_CYCLES = (
    ("#include <climits>\n", "#include <climits>\n#include <cstdio>\n"),
    ("__device__ __forceinline__ void bigram_cross(const DecodeParams& p, const float* prev, float* ew,\n"
     "                                             float* xvw, int* xbpw) {\n  const int N = p.N, S = p.S, W = p.W, nt = blockDim.x;\n",
     "__device__ __forceinline__ void bigram_cross(const DecodeParams& p, const float* prev, float* ew,\n"
     "                                             float* xvw, int* xbpw, long long* cy) {\n"
     "  const int N = p.N, S = p.S, W = p.W, nt = blockDim.x;\n  const long long ce = clock64();\n"),
    ("    ew[i] = e;\n  }\n  __syncthreads();\n", "    ew[i] = e;\n  }\n  __syncthreads();\n  const long long cm = clock64();\n  cy[3] += cm - ce;\n"),
    ("        xbpw[k * W + v] = lc[k];\n      }\n    }\n  }\n  __syncthreads();\n}\n",
     "        xbpw[k * W + v] = lc[k];\n      }\n    }\n  }\n  const long long cb = clock64();\n  __syncthreads();\n"
     "  cy[4] += cb - cm;\n  cy[5] += clock64() - cb;\n}\n"),
    ("                                            float* ew, float* xvw, int* xbpw) {\n",
     "                                            float* ew, float* xvw, int* xbpw, long long* cy) {\n"),
    ("  if (p.bigram) {\n    bigram_cross<K>(p, prev, ew, xvw, xbpw);\n  } else {\n    unigram_cross<K>(p, prev, red, round, xv, xbp);\n  }\n",
     "  long long c0 = clock64();\n  if (p.bigram) {\n    bigram_cross<K>(p, prev, ew, xvw, xbpw, cy);\n  } else {\n"
     "    unigram_cross<K>(p, prev, red, round, xv, xbp);\n  }\n  cy[0] += clock64() - c0;\n  c0 = clock64();\n"),
    ("        bpt[r * K + k] = bp;\n      }\n    }\n  }\n  __syncthreads();\n}\n",
     "        bpt[r * K + k] = bp;\n      }\n    }\n  }\n  cy[1] += clock64() - c0;\n  c0 = clock64();\n  __syncthreads();\n"
     "  cy[2] += clock64() - c0;\n}\n"),
    ("  int round = 0;\n  for (int t0 = 0; t0 < tend; t0 += F) {\n    const int nf = min(F, tend - t0);\n",
     "  int round = 0;\n  long long cy[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  int n_chunks = 0;\n"
     "  for (int t0 = 0; t0 < tend; t0 += F) {\n    const int nf = min(F, tend - t0);\n    long long cc = clock64();\n    ++n_chunks;\n"),
    ("    __syncthreads();\n    for (int r = tid; r < N; r += nt) {\n      float lbv[kFramesMax];\n",
     "    __syncthreads();\n    cy[6] += clock64() - cc;\n    cc = clock64();\n    for (int r = tid; r < N; r += nt) {\n      float lbv[kFramesMax];\n"),
    ("        if (f < nf) lbs[f * N + r] = lbv[f];\n    }\n    __syncthreads();\n",
     "        if (f < nf) lbs[f * N + r] = lbv[f];\n    }\n    __syncthreads();\n    cy[7] += clock64() - cc;\n"),
    ("lbs + f * N, bpt, red, round, ew, xvw,\n                     xbpw);\n",
     "lbs + f * N, bpt, red, round, ew, xvw,\n                     xbpw, cy);\n"),
    ("  // frames past the length: identity pointers, the carry kept\n",
     "  if (blockIdx.x == 0 && (tid == 0 || tid == nt - 32))\n"
     "    printf(\"CYC decode K%d bigram %d tid %d frames %d chunks %d features %lld emission %lld cross %lld exits %lld \"\n"
     "           \"merge %lld merge_wait %lld within_pointers %lld frame_barrier %lld\\n\", K, p.bigram, tid, tend, n_chunks,\n"
     "           cy[6], cy[7], cy[0], cy[3], cy[4], cy[5], cy[1], cy[2]);\n"
     "  // frames past the length: identity pointers, the carry kept\n"),
)

# composed_forward_kernel: cycles of lane 10 of recursion warp 0 of block 0
# (rows 20, 21 at R = 2): per tile the recursion (of it, the neighbours
# until they are ready and the log-sum-exp until it is), then the barrier
# closing the tile (its wait on the store warps)
F_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  float carry[R];\n  for (int k = 0; k < n_tiles; ++k) {\n",
     "  float carry[R];\n  long long cy_rec = 0, cy_bar = 0, cy_nb = 0, cy_lse = 0;\n"
     "  for (int k = 0; k < n_tiles; ++k) {\n    long long c0 = clock64();\n"),
    ("        float nb[NDB];\n#pragma unroll\n        for (int s = 1; s < NDB; ++s) {\n",
     "        long long c1 = clock64();\n        float nb[NDB];\n#pragma unroll\n        for (int s = 1; s < NDB; ++s) {\n"),
    ("          nb[s] = x;\n        }\n        float next[R];\n",
     "          nb[s] = x;\n        }\n#pragma unroll\n        for (int s = 1; s < NDB; ++s) asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(nb[s]));\n"
     "        cy_nb += clock64() - c1;\n        c1 = clock64();\n        float next[R];\n"),
    ("#pragma unroll\n        for (int r = 0; r < R; ++r) carry[r] = next[r];\n      }\n",
     "#pragma unroll\n        for (int r = 0; r < R; ++r) carry[r] = next[r];\n#pragma unroll\n"
     "        for (int r = 0; r < R; ++r) asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(carry[r]));\n"
     "        cy_lse += clock64() - c1;\n      }\n"),
    ("      if (W > 1) named_barrier(1, role_threads);  // the rows of frame t, for the next warp's sources\n"
     "    }\n    __syncthreads();\n  }\n}\n",
     "      if (W > 1) named_barrier(1, role_threads);  // the rows of frame t, for the next warp's sources\n"
     "    }\n    cy_rec += clock64() - c0;\n    c0 = clock64();\n    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && tid == 10) printf(\"CYC forward LS %d frames %d recursion %lld neighbours %lld lse %lld \"\n"
     "                                         \"barrier %lld\\n\", LS, T, cy_rec, cy_nb, cy_lse, cy_bar);\n}\n"),
)
# word_loop_decode_kernel: cycles of threads 0 and nt - 32 of block 0 over
# the whole utterance, the phases of PD_CYCLES (bigram "exits": the exit
# tokens, the top K sources and the list of sources that can enter a top K,
# with their two barriers)
D_CYCLES = (
    ("#include <climits>\n", "#include <climits>\n#include <cstdio>\n"),
    ("__device__ __forceinline__ void bigram_cross(const DecodeParams& p, const float* prev, float* ew, float* red,\n"
     "                                             int* survivors, float* xvw, int* xbpw) {\n"
     "  const int N = p.N, S = p.S, W = p.W, nt = blockDim.x, G = p.groups;\n",
     "__device__ __forceinline__ void bigram_cross(const DecodeParams& p, const float* prev, float* ew, float* red,\n"
     "                                             int* survivors, float* xvw, int* xbpw, long long* cy) {\n"
     "  const int N = p.N, S = p.S, W = p.W, nt = blockDim.x, G = p.groups;\n  const long long ce = clock64();\n"),
    ("    if (lane == 0) survivors[W] = n;\n  }\n  __syncthreads();\n",
     "    if (lane == 0) survivors[W] = n;\n  }\n  __syncthreads();\n  const long long cm = clock64();\n  cy[3] += cm - ce;\n"),
    ("        xbpw[k * W + v] = __ldg(p.exit_row + li[k] / K) * K + li[k] % K;\n      }\n    }\n  }\n  __syncthreads();\n}\n",
     "        xbpw[k * W + v] = __ldg(p.exit_row + li[k] / K) * K + li[k] % K;\n      }\n    }\n  }\n"
     "  const long long cb = clock64();\n  __syncthreads();\n  cy[4] += cb - cm;\n  cy[5] += clock64() - cb;\n}\n"),
    ("                                            float* ew, float* xvw, int* xbpw) {\n  const int N = p.N, nt = blockDim.x;\n",
     "                                            float* ew, float* xvw, int* xbpw, long long* cy) {\n"
     "  const int N = p.N, nt = blockDim.x;\n"),
    ("  if (p.bigram) {\n    bigram_cross<K>(p, prev, ew, red, reinterpret_cast<int*>(cur), xvw, xbpw);\n  } else {\n"
     "    unigram_cross<K>(p, prev, red, round, xv, xbp);\n  }\n",
     "  long long c0 = clock64();\n  if (p.bigram) {\n    bigram_cross<K>(p, prev, ew, red, reinterpret_cast<int*>(cur), xvw, xbpw, cy);\n"
     "  } else {\n    unigram_cross<K>(p, prev, red, round, xv, xbp);\n  }\n  cy[0] += clock64() - c0;\n  c0 = clock64();\n"),
    ("          bpt[r * K + k] = nbp[i][k];\n        }\n      }\n    }\n  }\n  __syncthreads();\n}\n",
     "          bpt[r * K + k] = nbp[i][k];\n        }\n      }\n    }\n  }\n  cy[1] += clock64() - c0;\n  c0 = clock64();\n"
     "  __syncthreads();\n  cy[2] += clock64() - c0;\n}\n"),
    ("  int round = 0;\n  for (int t0 = 0; t0 < tend; t0 += F) {\n    const int nf = min(F, tend - t0);\n",
     "  int round = 0;\n  long long cy[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  int n_chunks = 0;\n"
     "  for (int t0 = 0; t0 < tend; t0 += F) {\n    const int nf = min(F, tend - t0);\n    long long cc = clock64();\n    ++n_chunks;\n"),
    ("      xs[i] = x;\n    }\n    __syncthreads();\n", "      xs[i] = x;\n    }\n    __syncthreads();\n    cy[6] += clock64() - cc;\n    cc = clock64();\n"),
    ("            lbs[f * N + r] = (q == 0) ? s : lbs[f * N + r] + s;\n          }\n        }\n      }\n    }\n    __syncthreads();\n",
     "            lbs[f * N + r] = (q == 0) ? s : lbs[f * N + r] + s;\n          }\n        }\n      }\n    }\n    __syncthreads();\n"
     "    cy[7] += clock64() - cc;\n"),
    ("lbs + f * N, bpt, red, round, ew, xvw,\n                     xbpw);\n", "lbs + f * N, bpt, red, round, ew, xvw,\n                     xbpw, cy);\n"),
    ("  // frames past the length: identity pointers, the carry kept\n",
     "  if (blockIdx.x == 0 && (tid == 0 || tid == nt - 32))\n"
     "    printf(\"CYC decode K%d bigram %d tid %d frames %d chunks %d features %lld emission %lld cross %lld exits %lld \"\n"
     "           \"merge %lld merge_wait %lld within_pointers %lld frame_barrier %lld\\n\", K, p.bigram, tid, tend, n_chunks,\n"
     "           cy[6], cy[7], cy[0], cy[3], cy[4], cy[5], cy[1], cy[2]);\n"
     "  // frames past the length: identity pointers, the carry kept\n"),
)

# the cd9fbaf emit_forward_kernel: per-frame cycles of thread U of block 0
# (state 1 of utterance 0): the feature loads (until they have landed), the
# emission (its own state's mixtures, summed over the streams), the band
# step, the two global stores (their issue) and the block barrier
PE_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  float carry = kNegInf;\n  for (int t = 0; t < p.T; ++t) {\n    float lb = 0.f;\n    if (live) {\n"
     "      for (int q = 0; q < p.n_streams; ++q) {\n        const int D = p.dims[q], M = p.mixes[q];\n"
     "        float x[DMAX];\n        load_frame<DMAX>(p.feats[q] + (size_t)t * D * p.B + b, smem + p.origin_offs[q], D, p.B, x);\n",
     "  float carry = kNegInf;\n  long long cy_load = 0, cy_em = 0, cy_step = 0, cy_store = 0, cy_bar = 0;\n"
     "  for (int t = 0; t < p.T; ++t) {\n    long long c0 = clock64();\n    float lb = 0.f;\n    if (live) {\n"
     "      for (int q = 0; q < p.n_streams; ++q) {\n        const int D = p.dims[q], M = p.mixes[q];\n"
     "        float x[DMAX];\n        const long long c1 = clock64();\n"
     "        load_frame<DMAX>(p.feats[q] + (size_t)t * D * p.B + b, smem + p.origin_offs[q], D, p.B, x);\n"
     "#pragma unroll\n        for (int e = 0; e < DMAX; ++e) asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(x[e]));\n"
     "        cy_load += clock64() - c1;\n"),
    ("      lb = fmaxf(lb, kNegInf);\n    }\n    const float* prev",
     "      lb = fmaxf(lb, kNegInf);\n    }\n    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(lb));\n"
     "    cy_em += clock64() - c0;\n    c0 = clock64();\n    const float* prev"),
    ("      carry = fmaxf(upd + lb, kNegInf);\n    }\n    alpha[(t & 1) * nt + tid] = carry;\n",
     "      carry = fmaxf(upd + lb, kNegInf);\n    }\n    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(carry));\n"
     "    cy_step += clock64() - c0;\n    c0 = clock64();\n    alpha[(t & 1) * nt + tid] = carry;\n"),
    ("      p.la[o] = carry;\n    }\n    __syncthreads();\n  }\n}\n",
     "      p.la[o] = carry;\n    }\n    cy_store += clock64() - c0;\n    c0 = clock64();\n    __syncthreads();\n"
     "    cy_bar += clock64() - c0;\n  }\n  if (blockIdx.x == 0 && tid == U)\n"
     "    printf(\"CYC emit P%d T%d S%d U %d load %lld emission %lld step %lld store %lld barrier %lld frames %d\\n\",\n"
     "           p.n_streams, p.T, S, U, cy_load, cy_em - cy_load, cy_step, cy_store, cy_bar, p.T);\n}\n"),
)
# the cd9fbaf mfcc_kernel: cycles of thread 0 of blocks 0 and 5000 between
# its barriers: framing, the dense DFT with the power, the energy with the
# mel product and log floor, the DCT with the store
PM_CYCLES = (
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
    ("  // 1. pre-emphasis and framing into shared memory;",
     "  const long long c_start = clock64();\n  // 1. pre-emphasis and framing into shared memory;"),
    ("  __syncthreads();\n\n  // 2. windowed DFT", "  __syncthreads();\n  const long long c_frame = clock64();\n\n  // 2. windowed DFT"),
    ("  __syncthreads();\n\n  // 3. the log frame energy", "  __syncthreads();\n  const long long c_dft = clock64();\n\n  // 3. the log frame energy"),
    ("  __syncthreads();\n\n  // 5. DCT and the store", "  __syncthreads();\n  const long long c_mel = clock64();\n\n  // 5. DCT and the store"),
    ("    p.out[(row0 + f) * p.n_mfcc + c] = acc;\n  }\n}\n",
     "    p.out[(row0 + f) * p.n_mfcc + c] = acc;\n  }\n  __syncthreads();\n  const long long c_end = clock64();\n"
     "  if ((blockIdx.x == 0 || blockIdx.x == 5000) && tid == 0)\n"
     "    printf(\"CYC mfcc block %d framing %lld dft %lld mel %lld dct_store %lld threads %d\\n\", (int)blockIdx.x,\n"
     "           c_frame - c_start, c_dft - c_frame, c_mel - c_dft, c_end - c_mel, nt);\n}\n"),
)

# the redesigned emit_forward_kernel: block 0's emission thread 0 (the
# prologue's emission, per step the emission of the next tile and the wait
# at the step's barrier), memory thread 0 (per step the staging, the stores,
# the wait for the copies, the wait at the barrier) and recursion lane 1
# (state 1 of utterance 0: the wait for the prologue, per tile the frames,
# the wait at the barrier)
EN_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("    __syncthreads();  // tile 0's features are in\n    emit_tile(0);\n    __syncthreads();\n"
     "    for (int k = 0; k < n_tiles; ++k) {\n      if (k + 1 < n_tiles) emit_tile(k + 1);\n      __syncthreads();\n    }\n"
     "    return;\n",
     "    __syncthreads();  // tile 0's features are in\n    long long cy_pro = clock64(), cy_em = 0, cy_bar = 0;\n"
     "    emit_tile(0);\n    cy_pro = clock64() - cy_pro;\n    __syncthreads();\n"
     "    for (int k = 0; k < n_tiles; ++k) {\n      long long c0 = clock64();\n      if (k + 1 < n_tiles) emit_tile(k + 1);\n"
     "      cy_em += clock64() - c0;\n      c0 = clock64();\n      __syncthreads();\n      cy_bar += clock64() - c0;\n    }\n"
     "    if (blockIdx.x == 0 && e == 0)\n      printf(\"CYC emitnew em P%d T%d S%d tiles %d prologue %lld emission %lld wait %lld\\n\",\n"
     "             p.n_streams, T, S, n_tiles, cy_pro, cy_em, cy_bar);\n    return;\n"),
    ("    for (int k = 0; k < n_tiles; ++k) {\n      // tile k+2 goes into the slot of tile k, read last step\n"
     "      if (k + 2 < n_tiles) stage(k + 2);\n"
     "      if (k >= 1) store_rows_from_tile(p.la, las + ((k - 1) & 1) * s_tile, S * U, (k - 1) * TT, TT, S, p.B, b0, U, i, n_mem);\n"
     "      cp_async_wait<0>();\n      __syncthreads();\n    }\n",
     "    long long cy_st = 0, cy_out = 0, cy_cp = 0, cy_bar = 0;\n    for (int k = 0; k < n_tiles; ++k) {\n"
     "      long long c0 = clock64();\n      if (k + 2 < n_tiles) stage(k + 2);\n      cy_st += clock64() - c0;\n      c0 = clock64();\n"
     "      if (k >= 1) store_rows_from_tile(p.la, las + ((k - 1) & 1) * s_tile, S * U, (k - 1) * TT, TT, S, p.B, b0, U, i, n_mem);\n"
     "      cy_out += clock64() - c0;\n      c0 = clock64();\n      cp_async_wait<0>();\n      cy_cp += clock64() - c0;\n"
     "      c0 = clock64();\n      __syncthreads();\n      cy_bar += clock64() - c0;\n    }\n"
     "    if (blockIdx.x == 0 && i == 0)\n      printf(\"CYC emitnew mem P%d T%d S%d tiles %d stage %lld store %lld copies %lld wait %lld\\n\",\n"
     "             p.n_streams, T, S, n_tiles, cy_st, cy_out, cy_cp, cy_bar);\n"),
    ("  __syncthreads();  // tile 0's features are in\n  __syncthreads();  // tile 0's log_b is in\n  float carry = kNegInf;\n"
     "  for (int k = 0; k < n_tiles; ++k) {\n",
     "  long long cy_pw = clock64();\n  __syncthreads();  // tile 0's features are in\n  __syncthreads();  // tile 0's log_b is in\n"
     "  cy_pw = clock64() - cy_pw;\n  long long cy_rec = 0, cy_rbar = 0;\n  float carry = kNegInf;\n"
     "  for (int k = 0; k < n_tiles; ++k) {\n    long long c0 = clock64();\n"),
    ("      if (NSL == 0 || W > 1) named_barrier(1, n_rec);  // frame t's log-alpha, for the next frame's sources\n    }\n"
     "    __syncthreads();\n  }\n}\n",
     "      if (NSL == 0 || W > 1) named_barrier(1, n_rec);  // frame t's log-alpha, for the next frame's sources\n    }\n"
     "    cy_rec += clock64() - c0;\n    c0 = clock64();\n    __syncthreads();\n    cy_rbar += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && tid == 1)\n    printf(\"CYC emitnew rec P%d T%d S%d tiles %d prologue_wait %lld recursion %lld wait %lld\\n\",\n"
     "           p.n_streams, T, S, n_tiles, cy_pw, cy_rec, cy_rbar);\n}\n"),
)
# the FFT mfcc_kernel: thread 0 of blocks 0 and 5000 between its barriers:
# framing, the FFT's stages, the power (split step), the energy with the mel
# product and log floor, the DCT with the store
MN_CYCLES = (
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
    ("  float* b0 = reinterpret_cast<float*>(buf[0]);\n",
     "  const long long c_start = clock64();\n  float* b0 = reinterpret_cast<float*>(buf[0]);\n"),
    ("  __syncthreads();\n\n  // 2. the FFT's stages", "  __syncthreads();\n  const long long c_frame = clock64();\n\n  // 2. the FFT's stages"),
    ("  // 3. the power of bins", "  const long long c_fft = clock64();\n  // 3. the power of bins"),
    ("  __syncthreads();\n\n  // 4. the log frame energy", "  __syncthreads();\n  const long long c_power = clock64();\n\n  // 4. the log frame energy"),
    ("  __syncthreads();\n\n  // 5. DCT and the store", "  __syncthreads();\n  const long long c_mel = clock64();\n\n  // 5. DCT and the store"),
    ("    p.out[(row0 + f) * p.n_mfcc + c] = acc;\n  }\n}\n",
     "    p.out[(row0 + f) * p.n_mfcc + c] = acc;\n  }\n  __syncthreads();\n  const long long c_end = clock64();\n"
     "  if ((blockIdx.x == 0 || blockIdx.x == 5000) && tid == 0)\n"
     "    printf(\"CYC mfccfft block %d frames %d framing %lld fft %lld power %lld mel %lld dct_store %lld\\n\", (int)blockIdx.x,\n"
     "           FB, c_frame - c_start, c_fft - c_frame, c_power - c_fft, c_mel - c_power, c_end - c_mel);\n}\n"),
)


# 7ca66a2's vocab_scores_kernel (step 0 of its redesign): thread 0 of block
# (0, 0) over its frames, the feature loads (waited for), the emission
# with its log b stores to shared memory, the band step (log-alpha read
# from and written to shared memory)
PV_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  const int t_end = min(max(p.lengths[b], 1), p.T);\n",
     "  const int t_end = min(max(p.lengths[b], 1), p.T);\n  long long cy_load = 0, cy_em = 0, cy_step = 0;\n"),
    ("      float x[DMAX];\n#pragma unroll\n      for (int e = 0; e < DMAX; ++e) x[e] = (e < D) ? __ldg(f + (size_t)e * p.B) : 0.f;\n",
     "      const long long c0 = clock64();\n      float x[DMAX];\n#pragma unroll\n"
     "      for (int e = 0; e < DMAX; ++e) x[e] = (e < D) ? __ldg(f + (size_t)e * p.B) : 0.f;\n"
     "      float sink = 0.f;\n#pragma unroll\n"
     "      for (int e = 0; e < DMAX; ++e) asm volatile(\"add.f32 %0, %0, %1;\" : \"+f\"(sink) : \"f\"(x[e]));\n"
     "      const long long c1 = clock64();\n"),
    ("      }\n    }\n    if (t == 0) {",
     "      }\n      cy_load += c1 - c0;\n      cy_em += clock64() - c1;\n    }\n    if (t == 0) {"),
    ("    for (int j = S - 1; j >= 0; --j) {\n      const int dj",
     "    const long long c2 = clock64();\n    for (int j = S - 1; j >= 0; --j) {\n      const int dj"),
    ("      alpha[j * nt + tid] = fmaxf(upd + lb[j * nt + tid], kNegInf);\n    }\n  }\n",
     "      alpha[j * nt + tid] = fmaxf(upd + lb[j * nt + tid], kNegInf);\n    }\n    cy_step += clock64() - c2;\n  }\n"
     "  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)\n"
     "    printf(\"CYC vocab frames %d load %lld emission %lld step %lld\\n\", t_end, cy_load, cy_em, cy_step);\n"),
)
# 7ca66a2's emission_log_b_kernel: frames 0 and N/2, the frame load
# (waited for), then the emission with its log b stores
PE21_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  float x[DMAX], x2[DMAX];\n  load_frame<DMAX>(frames, n, D, true, x, x2);\n"
     "  for (int s = 0; s < S; ++s) log_b[n * S + s] = diag_state_log_b<DMAX>(rec_sh + s * M * stride, M, x, x2);\n",
     "  const long long c0 = clock64();\n  float x[DMAX], x2[DMAX];\n  load_frame<DMAX>(frames, n, D, true, x, x2);\n"
     "  float sink = 0.f;\n#pragma unroll\n"
     "  for (int e = 0; e < DMAX; ++e) asm volatile(\"add.f32 %0, %0, %1;\" : \"+f\"(sink) : \"f\"(x[e]));\n"
     "  const long long c1 = clock64();\n"
     "  for (int s = 0; s < S; ++s) log_b[n * S + s] = diag_state_log_b<DMAX>(rec_sh + s * M * stride, M, x, x2);\n"
     "  const long long c2 = clock64();\n"
     "  if (n == 0 || n == N / 2) printf(\"CYC emission21 frame %lld load %lld emission_and_stores %lld\\n\", n, c1 - c0, c2 - c1);\n"),
)
# the redesigned vocab_scores_kernel: thread 0 of block 0 (its first
# recursion lane) and its first emission thread, each over its tiles: the
# recursion's frame loop and its wait at the tile's barrier; the emission's
# tile and its wait
VN_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("    const int e = tid - n_rec;\n    __syncthreads();  // tile 0's features are in\n",
     "    const int e = tid - n_rec;\n    long long cy_em = 0, cy_wait = 0;\n    __syncthreads();  // tile 0's features are in\n"),
    ("      if (k + 1 < n_tiles)\n        emission_tile<DMAX, FULL>(p, cst, xs + ((k + 1) & 1) * x_tile, lbs + ((k + 1) & 1) * s_tile,\n"
     "                                  min(TT, T - (k + 1) * TT), nw, e, n_em);\n      __syncthreads();\n    }\n    return;",
     "      const long long c0 = clock64();\n"
     "      if (k + 1 < n_tiles)\n        emission_tile<DMAX, FULL>(p, cst, xs + ((k + 1) & 1) * x_tile, lbs + ((k + 1) & 1) * s_tile,\n"
     "                                  min(TT, T - (k + 1) * TT), nw, e, n_em);\n      const long long c1 = clock64();\n"
     "      __syncthreads();\n      cy_em += c1 - c0;\n      cy_wait += clock64() - c1;\n    }\n"
     "    if (blockIdx.x == 0 && e == 0) printf(\"CYC vocabnew emission %lld wait %lld tiles %d\\n\", cy_em, cy_wait, n_tiles);\n"
     "    return;"),
    ("  float carry = kNegInf;\n  for (int k = 0; k < n_tiles; ++k) {\n    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);\n",
     "  float carry = kNegInf;\n  long long cy_rec = 0, cy_rwait = 0;\n  for (int k = 0; k < n_tiles; ++k) {\n"
     "    const long long c0 = clock64();\n    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);\n"),
    ("        named_barrier(1, n_rec);\n      }\n    }\n    __syncthreads();\n  }\n",
     "        named_barrier(1, n_rec);\n      }\n    }\n    const long long c1 = clock64();\n    __syncthreads();\n"
     "    cy_rec += c1 - c0;\n    cy_rwait += clock64() - c1;\n  }\n"
     "  if (blockIdx.x == 0 && tid == 0) printf(\"CYC vocabnew recursion %lld wait %lld frames %d\\n\", cy_rec, cy_rwait, T);\n"),
)
PE21_STORE = "  for (int s = 0; s < S; ++s) log_b[n * S + s] = diag_state_log_b<DMAX>(rec_sh + s * M * stride, M, x, x2);\n"

# 6fe1112's lattice_forward_kernel (step 0 of its redesign): thread 0 of
# block 0 per launch, the log b load (waited for), the recursion, the stores
# (shared row and lattice), the barrier closing the frame; "mode" is
# last_only, state_minor, per_row
PL_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  float* row = sh;            // 2 * nt: the carries of frames t-1 and t\n",
     "  float* row = sh;            // 2 * nt: the carries of frames t-1 and t\n"
     "  long long cy_load = 0, cy_rec = 0, cy_store = 0, cy_bar = 0;\n"),
    ("    const float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;\n    if (t == 0) {",
     "    long long c0 = clock64();\n    float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(lb));\n    cy_load += clock64() - c0;\n    c0 = clock64();\n"
     "    if (t == 0) {"),
    ("      carry = fmaxf(m + logf(e) + lb, kNegInf);\n    }\n    row[(t & 1) * nt + threadIdx.x] = carry;\n"
     "    if (live && !p.last_only) p.out[ot] = carry;\n    __syncthreads();\n  }\n",
     "      carry = fmaxf(m + logf(e) + lb, kNegInf);\n    }\n    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(carry));\n"
     "    cy_rec += clock64() - c0;\n    c0 = clock64();\n    row[(t & 1) * nt + threadIdx.x] = carry;\n"
     "    if (live && !p.last_only) p.out[ot] = carry;\n    cy_store += clock64() - c0;\n    c0 = clock64();\n"
     "    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    printf(\"CYC lattice_fwd mode %d%d%d S %d T %d load %lld recursion %lld store %lld barrier %lld\\n\", p.last_only,\n"
     "           p.state_minor, p.per_row, S, p.T, cy_load, cy_rec, cy_store, cy_bar);\n"),
)
PL_STORE = "    if (live && !p.last_only) p.out[ot] = carry;\n    __syncthreads();\n"
# 6fe1112's emission_stats_kernel: threads 0 and 64 of block 0 (state 0,
# frames 0-2047) over its 16 chunks: the weights (frame load, q, g), the
# barrier after them, the column pass (thread 64 owns no column at M=3,
# D=9), the barrier closing the chunk
PS_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  const long long n1 = min(p.N, n0 + kFramesPerBlock);\n",
     "  const long long n1 = min(p.N, n0 + kFramesPerBlock);\n"
     "  long long cy_w = 0, cy_b1 = 0, cy_col = 0, cy_b2 = 0;\n  int n_chunks = 0;\n"),
    ("    const long long n = c0 + k;\n    const bool on = n < n1;\n",
     "    long long cc = clock64();\n    ++n_chunks;\n    const long long n = c0 + k;\n    const bool on = n < n1;\n"),
    ("      g_sh[mix * (kFrames + 1) + k] = on ? g * expf(fminf(q - lb, 0.f)) : 0.f;\n    }\n    __syncthreads();\n",
     "      g_sh[mix * (kFrames + 1) + k] = on ? g * expf(fminf(q - lb, 0.f)) : 0.f;\n    }\n"
     "    cy_w += clock64() - cc;\n    cc = clock64();\n    __syncthreads();\n    cy_b1 += clock64() - cc;\n    cc = clock64();\n"),
    ("      acc_sh[col] = a;\n    }\n    __syncthreads();\n  }\n",
     "      acc_sh[col] = a;\n    }\n    cy_col += clock64() - cc;\n    cc = clock64();\n    __syncthreads();\n"
     "    cy_b2 += clock64() - cc;\n  }\n  if (blockIdx.x == 0 && (k == 0 || k == 64))\n"
     "    printf(\"CYC stats tid %d chunks %d D %d M %d weights %lld barrier1 %lld columns %lld barrier2 %lld\\n\", k,\n"
     "           n_chunks, D, M, cy_w, cy_b1, cy_col, cy_b2);\n"),
)

# vocab_scores.cu and scoring.py with the utterances in launch order longest first
LONGEST_FIRST = [
    (VOC, ('  const int* lengths;   // (B,)\n  float* out;           // (W*S, B)\n  int T, B, W, S, band;\n  int U, WB, TT;        // utterances and words a block, frames a tile\n  int u_blocks;         // ceil(B / U): block x = word block * u_blocks + utterance block',
           '  const int* lengths;   // (B,)\n  const int* order;     // (B,) the utterances in launch order (longest first)\n  float* out;           // (W*S, B)\n  int T, B, W, S, band;\n  int U, WB, TT;        // utterances and words a block, frames a tile\n  int w_blocks;         // ceil(W / WB): block x = utterance block * w_blocks + word block')),
    (VOC, ("// two slots of (TT, WB, S, U) | log-alpha, two rows of (S, WB U) | the\n// block's frame count (one int, padded to 4); slot k & 1 holds tile k.\n__host__ __device__ inline size_t vocab_floats(const Params& p) {\n  const size_t P = (size_t)p.U * p.WB;\n  return (p.consts_global ? 0 : (size_t)p.WB * p.C) + 2 * (size_t)p.TT * p.U * p.sum_dims +\n         2 * (size_t)p.TT * p.S * P + 2 * (size_t)p.S * P + 4;\n}",
           "// two slots of (TT, WB, S, U) | log-alpha, two rows of (S, WB U) | ints:\n// the block's U utterances and its frame count (U + 1, padded to 4 past U);\n// slot k & 1 holds tile k.\n__host__ __device__ inline size_t vocab_floats(const Params& p) {\n  const size_t P = (size_t)p.U * p.WB;\n  return (p.consts_global ? 0 : (size_t)p.WB * p.C) + 2 * (size_t)p.TT * p.U * p.sum_dims +\n         2 * (size_t)p.TT * p.S * P + 2 * (size_t)p.S * P + p.U + 4;\n}")),
    (VOC, ('__device__ __forceinline__ void named_barrier(int id, int threads) {\n  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");\n}\n',
           '__device__ __forceinline__ void named_barrier(int id, int threads) {\n  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");\n}\n\n// Copies the features of frames t0 .. t0 + n of the block\'s utterances\n// ids[0 .. U) (an id of -1: none) from a (T, X, B) tensor into shared\n// memory: float (t0 + tt, x, ids[u]) goes to dst[tt * s_t + x * s_x + u],\n// 0.0f where there is no utterance or frame.  The utterances are not\n// consecutive along B, so a copy moves 4 bytes; the copying threads are\n// threadIdx.x in [first, first + count) (U divides count), a thread one\n// utterance.\n__device__ __forceinline__ void stage_gather_async(float* dst, int s_t, int s_x, const float* src, int t0, int n,\n                                                   int X, int T, const int* ids, int U, int first, int count, int B) {\n  const int i = threadIdx.x - first;\n  if (i < 0 || i >= count) return;\n  const int u = i % U, step = count / U, b = ids[u];\n  int x = i / U, tt = 0;\n  while (x >= X) x -= X, ++tt;\n  while (tt < n) {\n    const int t = t0 + tt;\n    const bool ok = b >= 0 && t < T;\n    cp_async4(dst + tt * s_t + x * s_x + u, ok ? src + ((size_t)t * X + x) * B + b : src, ok);\n    x += step;\n    while (x >= X) x -= X, ++tt;\n  }\n}\n')),
    (VOC, ('  float* rows = lbs + 2 * s_tile;                                 // log-alpha rows\n  int* t_blk = reinterpret_cast<int*>(rows + 2 * row);',
           "  float* rows = lbs + 2 * s_tile;                                 // log-alpha rows\n  int* ids = reinterpret_cast<int*>(rows + 2 * row);              // the block's utterances\n  int* t_blk = ids + U;")),
    (VOC, ('  const int ub = blockIdx.x % p.u_blocks, w0 = blockIdx.x / p.u_blocks * p.WB;\n  const int b0 = ub * U, nw = min(p.WB, p.W - w0);',
           '  const int w0 = blockIdx.x % p.w_blocks * p.WB, b0 = blockIdx.x / p.w_blocks * U;\n  const int nw = min(p.WB, p.W - w0);')),
    (VOC, ("  if (tid == 0) {  // the block's frames: its longest utterance (frame 0 always)\n    int m = 1;\n    for (int u = 0; u < U && b0 + u < p.B; ++u) m = max(m, min(max(p.lengths[b0 + u], 1), p.T));\n    *t_blk = m;\n  }",
           "  if (tid < U) ids[tid] = b0 + tid < p.B ? p.order[b0 + tid] : -1;\n  if (tid == 0) {  // the block's frames: its longest utterance (frame 0 always)\n    int m = 1;\n    for (int u = 0; u < U && b0 + u < p.B; ++u) m = max(m, min(max(p.lengths[p.order[b0 + u]], 1), p.T));\n    *t_blk = m;\n  }")),
    (VOC, ('        stage_rows_async(f, p.dims[q] * U, U, p.feats[q], t0, min(TT, T - t0), p.dims[q], p.T, p.B, b0, U,\n                         n_rec + n_em, n_mem);',
           '        stage_gather_async(f, p.dims[q] * U, U, p.feats[q], t0, min(TT, T - t0), p.dims[q], p.T, ids, U,\n                           n_rec + n_em, n_mem, p.B);')),
    (VOC, ('  const int lg_u = 31 - __clz(U), wl = prc >> lg_u, u = prc & (U - 1), b = b0 + u;\n  const bool th = slot && wl < nw;  // ... of a word of the vocabulary\n  const bool live = th && b < p.B;',
           '  const int lg_u = 31 - __clz(U), wl = prc >> lg_u, u = prc & (U - 1), b = ids[u];\n  const bool th = slot && wl < nw;  // ... of a word of the vocabulary\n  const bool live = th && b >= 0;')),
    (VOC, ('  p.lengths = static_cast<const int*>(lengths);\n  p.out = static_cast<float*>(out);',
           '  p.lengths = static_cast<const int*>(lengths);\n  p.order = static_cast<const int*>(order);\n  p.out = static_cast<float*>(out);')),
    (VOC, ('  p.u_blocks = (B + U - 1) / U;',
           '  p.w_blocks = (W + WB - 1) / WB;')),
    (VOC, ('                       int diag_off, const void* lengths, void* out, int T, int B, int W, int S,',
           '                       int diag_off, const void* lengths, const void* order, void* out, int T, int B, int W, int S,')),
    (SCO_PY, ('    WB U) and the block\'s frame count."""\n    P = U * WB\n    return 4 * ((0 if consts_global else WB * C) + 2 * TT * U * sum_d + 2 * TT * S * P + 2 * S * P + 4)',
              '    WB U), the block\'s U utterances and its frame count."""\n    P = U * WB\n    return 4 * ((0 if consts_global else WB * C) + 2 * TT * U * sum_d + 2 * TT * S * P + 2 * S * P + U + 4)')),
    (SCO_PY, ('        c_ptr, c_int, c_int, c_ptr, c_ptr,  # consts, C, diag_off, lengths, out',
              '        c_ptr, c_int, c_int, c_ptr, c_ptr, c_ptr,  # consts, C, diag_off, lengths, order, out')),
    (SCO_PY, ('        self.lengths = lengths.to(torch.int32).contiguous()\n',
              "        self.lengths = lengths.to(torch.int32).contiguous()\n        # the utterances longest first: a block's utterances end together,\n        # and the longest blocks start first\n        self.order = torch.argsort(self.lengths, descending=True, stable=True).to(torch.int32)\n")),
    (SCO_PY, ('        ln.consts.data_ptr(), ln.consts.shape[1], ln.diag_off, ln.lengths.data_ptr(), out.data_ptr(),',
              '        ln.consts.data_ptr(), ln.consts.shape[1], ln.diag_off, ln.lengths.data_ptr(), ln.order.data_ptr(),\n        out.data_ptr(),')),
]


def cut_lists(edits):
    """cut() over edits of several files: [(src, (old, new)), ...]; an edit
    of a file already edited by an earlier one applies to its result."""
    return tuple(e[0] for e in edits), tuple(e[1][0] for e in edits), tuple(e[1][1] for e in edits)

def cut(src, *edits):
    """A variant of src with each (old, new) edit applied."""
    return src, tuple(e[0] for e in edits), tuple(e[1] for e in edits)


VARIANTS = [
    ("base", COMP, "", ""),
    # composed_backward_stats_kernel: its recursion warps, its statistics
    # warps (without the copies), the copies alone
    ("composed_recursion_only", *cut(COMP, C_STAGE, C_STATS)),
    ("composed_statistics_only", *cut(COMP, C_REC, C_STAGE)),
    ("composed_copies_only", *cut(COMP, C_REC, C_STATS)),
    ("composed_no_copies", *cut(COMP, C_STAGE)),
    # backward_stats_kernel: the same, and the emission or the contraction cut
    ("em_recursion_only", *cut(FEM, E_STATS, E_STAGE)),
    ("em_statistics_only", *cut(FEM, E_REC, E_STAGE)),
    ("em_copies_only", *cut(FEM, E_REC, E_STATS)),
    ("em_no_copies", *cut(FEM, E_STAGE)),
    ("em_no_emission", FEM, "          int mix = 0;\n          for (; mix + 2 <= M; mix += 2) {",
     "          int mix = M;\n          for (; mix + 2 <= M; mix += 2) {"),
    ("composed_cycles", *cut(COMP, *C_CYCLES)),
    ("em_cycles", *cut(FEM, *E_CYCLES)),
    # launch shapes other than the wrappers' choice
    ("composed_2_utterances", COMP_PY, "    U = max(1, _LATTICE_WARPS // W)", "    U = max(1, 2 // W)"),
    ("composed_8_frame_tiles", COMP_PY, "BACKWARD_TILES = (16, 8, 4, 2, 1)", "BACKWARD_TILES = (8, 4, 2, 1)"),
    ("em_no_contraction", FEM, "        contract_3xtf32<FULL>(acc + (size_t)S * p.mom_offs[q]",
     "        if (false) contract_3xtf32<FULL>(acc + (size_t)S * p.mom_offs[q]"),
    # composed_forward_kernel and word_loop_decode_kernel
    ("forward_cycles", *cut(COMP, *F_CYCLES)),
    ("forward_no_lse", COMP, "      } else if (t < len) {\n        // nb[s] = log-alpha[t-1]",
     "      } else if (false) {\n        // nb[s] = log-alpha[t-1]"),
    ("decode_cycles", *cut(DEC, *D_CYCLES)),
    ("decode_no_emission", DEC, "        stream_log_b<FULL>(p, q, r, xs, nf, mx, ev);\n", ""),
    ("decode_8_frames", (DEC, DEC_PY), ("constexpr int kFramesMax = 16;", "_FRAMES_MAX = 16 "),
     ("constexpr int kFramesMax = 8;", "_FRAMES_MAX = 8 ")),
    ("decode_no_pointers", DEC, "          bpt[r * K + k] = nbp[i][k];\n", ""),
    ("decode_1_row_a_step", DEC, "constexpr int kRowBlock = 2;", "constexpr int kRowBlock = 1;"),
    ("decode_4_rows_a_step", DEC, "constexpr int kRowBlock = 2;", "constexpr int kRowBlock = 4;"),
    # 03f5319's composed_forward_kernel and word_loop_decode_kernel
    ("parent_forward_cycles", *cut(COMP, *PF_CYCLES)),
    ("parent_forward_no_lse", COMP, "    } else if (t < len) {\n      // sources j - d below row 0",
     "    } else if (false) {\n      // sources j - d below row 0"),
    ("parent_forward_no_barrier", COMP, "    if (live) p.la_out[o] = carry;\n    __syncthreads();\n",
     "    if (live) p.la_out[o] = carry;\n"),
    ("parent_forward_no_store", COMP, "    if (live) p.la_out[o] = carry;\n", "    if (live && t < 0) p.la_out[o] = carry;\n"),
    ("parent_decode_cycles", *cut(DEC, *PD_CYCLES)),
    ("parent_decode_no_emission", DEC, "      for (int q = 0; q < P; ++q) stream_log_b<FULL>(p, q, r, xs, nf, lbv);\n", ""),
    ("parent_decode_no_pointers", *cut(DEC, ("      bpt[r] = bp;\n", ""), ("        bpt[r * K + k] = bp;\n", ""))),
    # emit_forward and the MFCC kernel as of cd9fbaf (step 0 of their
    # redesign): base, clock64 counters, the emission cut, the two global
    # stores cut, the dense DFT cut
    ("emit_mfcc_base", FEM, "", ""),
    ("parent_emit_cycles", *cut(FEM, *PE_CYCLES)),
    ("parent_emit_no_emission", *cut(FEM, ("          v = full_state_log_b<DMAX>(rec, M, D, x);", "          v = x[0];"),
                                     ("          v = diag_state_log_b<DMAX>(rec, M, x, x2);", "          v = x2[0];"))),
    ("parent_emit_no_stores", FEM, "      p.log_b[o] = lb;\n      p.la[o] = carry;\n", ""),
    ("parent_mfcc_cycles", *cut(MFCC, *PM_CYCLES)),
    ("parent_mfcc_no_dft", *cut(MFCC, ("      for (; n + 4 <= p.W; n += 4) {", "      for (; n + 4 <= 0; n += 4) {"),
                                ("      for (; n < p.W; ++n) dft_row(", "      for (; n < 0; ++n) dft_row("))),
    # the redesigned emit_forward_kernel and mfcc_kernel: counters, and the
    # emission, the recursion, the log-alpha stores, the framing or the
    # FFT's stages cut
    ("emit_cycles", *cut(FEM, *EN_CYCLES)),
    ("emit_no_emission", FEM, "          for (int q = 0; q < p.n_streams; ++q) {\n            const int D = p.dims[q], M = p.mixes[q];\n"
     "            const float* o = cst", "          for (int q = 0; q < 0; ++q) {\n            const int D = p.dims[q], M = p.mixes[q];\n"
     "            const float* o = cst"),
    ("emit_no_recursion", FEM, "    for (int t = t_lo; t < t_hi; ++t) {\n      const int tt = t - t_lo;\n      const float lb = lbn;",
     "    for (int t = t_lo; t < t_lo; ++t) {\n      const int tt = t - t_lo;\n      const float lb = lbn;"),
    ("emit_no_stores", FEM, "      if (k >= 1) store_rows_from_tile(p.la, las", "      if (false) store_rows_from_tile(p.la, las"),
    ("mfcc_cycles", *cut(MFCC, *MN_CYCLES)),
    ("mfcc_no_framing", MFCC, "  for (int i = tid; i < FB * p.W; i += nt) {", "  for (int i = tid; i < 0; i += nt) {"),
    ("mfcc_no_stages", MFCC, "  for (int s = 0; s < p.n_stages; ++s) {", "  for (int s = 0; s < 0; ++s) {"),
    # launch shapes other than the wrappers' choice
    ("emit_16_frame_tiles", FEM_PY, "EMIT_TILES = (32, 16, 8, 4, 2, 1)", "EMIT_TILES = (16, 8, 4, 2, 1)"),
    ("emit_8_utterances", FEM_PY, "EMIT_UTTS = (16, 8, 4, 2, 1)", "EMIT_UTTS = (8, 4, 2, 1)"),
    ("mfcc_32_frames", *cut(MFCC_PY, ("FRAMES_PER_BLOCK = (16, 8, 4, 2, 1)", "FRAMES_PER_BLOCK = (32, 16, 8, 4, 2, 1)"),
                            ("BLOCK_SMEM = 56 * 1024", "BLOCK_SMEM = 112 * 1024"))),
    ("mfcc_4_frames", MFCC_PY, "FRAMES_PER_BLOCK = (16, 8, 4, 2, 1)", "FRAMES_PER_BLOCK = (4, 2, 1)"),
    # vocab_scores_kernel and emission_log_b_kernel as of 7ca66a2 (step 0 of
    # their redesign): clock64 counters; the emission, the feature loads or
    # the band step cut; #21's log b stores, its emission or its frame
    # loads cut
    ("parent_vocab_cycles", *cut(VOC, *PV_CYCLES)),
    ("parent_vocab_no_emission", *cut(VOC, ("full_state_log_b<DMAX>(rec + s * M * stride, M, D, x);", "x[0];"),
                                      ("diag_state_log_b<DMAX>(rec + s * M * stride, M, x, x2);", "x2[0];"))),
    ("parent_vocab_no_feature_loads", VOC, "x[e] = (e < D) ? __ldg(f + (size_t)e * p.B) : 0.f;",
     "x[e] = (e < D) ? 0.01f * (float)(e + t) : 0.f;"),
    ("parent_vocab_no_step", VOC, "    for (int j = S - 1; j >= 0; --j) {\n      const int dj",
     "    for (int j = S - 1; j >= S; --j) {\n      const int dj"),
    ("parent_emission_cycles", *cut(EMI, *PE21_CYCLES)),
    ("parent_emission_no_stores", EMI, PE21_STORE,
     "  for (int s = 0; s < S; ++s) {\n    const float v = diag_state_log_b<DMAX>(rec_sh + s * M * stride, M, x, x2);\n"
     "    if (v == 1.2345f) log_b[n * S + s] = v;\n  }\n"),
    ("parent_emission_no_emission", EMI, PE21_STORE, "  for (int s = 0; s < S; ++s) log_b[n * S + s] = x2[0] + (float)s;\n"),
    ("parent_emission_no_loads", EMI, "  load_frame<DMAX>(frames, n, D, true, x, x2);\n  for (int s = 0; s < S;",
     "#pragma unroll\n  for (int e = 0; e < DMAX; ++e) x[e] = (e < D) ? 0.01f * (float)(e + (int)n) : 0.f, x2[e] = x[e] * x[e];\n"
     "  for (int s = 0; s < S;"),
]


def joined(name, *parts):
    """A variant applying the edits of several (of different kernels) to one
    copy of the tree."""
    srcs, olds, news = [], [], []
    for part in parts:
        _, src, old, new = next(v for v in VARIANTS if v[0] == part)
        o, n = (old, new) if isinstance(old, tuple) else ((old,), (new,))
        srcs += list(src) if isinstance(src, tuple) else [src] * len(o)
        olds += o
        news += n
    return name, tuple(srcs), tuple(olds), tuple(news)


VARIANTS += [
    joined("emit_mfcc_cycles", "emit_cycles", "mfcc_cycles"),
    joined("emit_no_emission_mfcc_no_framing", "emit_no_emission", "mfcc_no_framing"),
    joined("emit_no_recursion_mfcc_no_stages", "emit_no_recursion", "mfcc_no_stages"),
    joined("emit_16_frame_tiles_mfcc_32_frames", "emit_16_frame_tiles", "mfcc_32_frames"),
    joined("emit_8_utterances_mfcc_4_frames", "emit_8_utterances", "mfcc_4_frames"),
    ("scoring_emission_base", VOC, "", ""),
    # the redesigned vocab_scores_kernel: counters; the emission or the
    # recursion cut; the emission inlined, four columns a thread; other
    # launch shapes (fewer recursion warps, two memory warps)
    ("vocab_cycles", *cut(VOC, *VN_CYCLES)),
    ("vocab_no_emission", VOC, "state_log_b_cols<DMAX, FULL, NC>(cw + p.offs[q] + s * M * record_stride<DMAX, FULL>(D), M, D, x, v);",
     "for (int j = 0; j < NC; ++j) v[j] = x[j][0];"),
    ("vocab_no_recursion", VOC, "    for (int t = t_lo; t < t_hi; ++t) {\n      const float lb = lbn;",
     "    for (int t = t_lo; t < t_lo; ++t) {\n      const float lb = lbn;"),
    ("vocab_noinline_emission", VOC, "__device__ __forceinline__ void emission_tile(", "__device__ __noinline__ void emission_tile("),
    ("vocab_4_columns", VOC, "constexpr int kCols = DMAX <= 16 ? 2 : 1;", "constexpr int kCols = DMAX <= 16 ? 4 : 1;"),
    ("vocab_4_recursion_warps", SCO_PY, "VOCAB_REC_WARPS = 8 ", "VOCAB_REC_WARPS = 4 "),
    ("vocab_2_memory_warps", SCO_PY, "VOCAB_MEMORY_WARPS = 1 ", "VOCAB_MEMORY_WARPS = 2 "),
    # the utterances ordered longest first (the wrapper's argsort, the
    # kernel gathering a block's utterances by 4-byte cp.async), and the
    # gather alone (the launch order the batch's)
    ("vocab_longest_first", *cut_lists(LONGEST_FIRST)),
    ("vocab_gather_unsorted", *cut_lists(LONGEST_FIRST + [(SCO_PY, (
        "torch.argsort(self.lengths, descending=True, stable=True).to(torch.int32)",
        "torch.arange(self.lengths.shape[0], dtype=torch.int32, device=self.lengths.device)"))])),
    ("vocab_6_recursion_warps", SCO_PY, "VOCAB_REC_WARPS = 8 ", "VOCAB_REC_WARPS = 6 "),
    ("vocab_12_recursion_warps", SCO_PY, "VOCAB_REC_WARPS = 8 ", "VOCAB_REC_WARPS = 12 "),
    # full covariance's rows of L^T two at a time (a second z chain side by
    # side, the squares summed in row order): vocab_scores, and emit_forward
    # (emit_ prefix)
    ("vocab_full_row_pairs", *cut(EMC, ("// full_mix_q of NC feature columns", FULL_ROW_Z), (FULL_SINGLE, FULL_PAIRS))),
    ("emit_full_row_pairs", *cut(EMC, ("// full_mix_q of NC feature columns", FULL_ROW_Z), (FULL_SINGLE, FULL_PAIRS))),
    # 672 threads a block (21 warps, 6 on a scheduler: 80 registers a thread
    # against 96 at 640, the emission spilling); 4 columns a thread at DMAX
    # <= 12
    ("vocab_672_threads", (VOC, SCO_PY), ("constexpr int kThreads = 640;", "VOCAB_THREADS = 640 "),
     ("constexpr int kThreads = 672;", "VOCAB_THREADS = 672 ")),
    ("vocab_4_columns_at_12", VOC, "constexpr int kCols = DMAX <= 16 ? 2 : 1;",
     "constexpr int kCols = DMAX <= 12 ? 4 : DMAX <= 16 ? 2 : 1;"),
    # #21 with 128 threads a block (more, smaller blocks a SM)
    ("emission_21_128_threads", EMI_PY, "EMISSION_THREADS = (256, 128, 64, 32)", "EMISSION_THREADS = (128, 64, 32)"),
    ("vocab_448_threads_2_blocks", (VOC, VOC, SCO_PY, SCO_PY),
     ("constexpr int kThreads = 640;", "__launch_bounds__(kThreads) vocab_scores_kernel", "VOCAB_THREADS = 640 ",
      "VOCAB_REC_WARPS = 8 "),
     ("constexpr int kThreads = 448;", "__launch_bounds__(kThreads, 2) vocab_scores_kernel", "VOCAB_THREADS = 448 ",
      "VOCAB_REC_WARPS = 4 ")),
    joined("parent_vocab_emission_cycles", "parent_vocab_cycles", "parent_emission_cycles"),
    joined("parent_vocab_no_emission_emission_no_stores", "parent_vocab_no_emission", "parent_emission_no_stores"),
    joined("parent_vocab_no_feature_loads_emission_no_emission", "parent_vocab_no_feature_loads",
           "parent_emission_no_emission"),
    joined("parent_vocab_no_step_emission_no_loads", "parent_vocab_no_step", "parent_emission_no_loads"),
]
VARIANTS += [
    ("lattice_stats_base", LAT, "", ""),
    # lattice_forward_kernel and emission_stats_kernel as of 6fe1112 (step 0
    # of their redesign): clock64 counters; the log b load, the per-frame
    # barrier or the lattice stores cut; the moments' weights (q and the
    # exp) or their column pass cut
    ("parent_lattice_fwd_cycles", *cut(LAT, *PL_CYCLES)),
    ("parent_lattice_fwd_no_load", LAT, "    const float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;\n    if (t == 0) {",
     "    const float lb = live ? -0.25f * (float)(t & 7) : kNegInf;\n    if (t == 0) {"),
    ("parent_lattice_fwd_no_barrier", LAT, PL_STORE, "    if (live && !p.last_only) p.out[ot] = carry;\n"),
    ("parent_lattice_fwd_no_store", LAT, PL_STORE,
     "    if (live && !p.last_only && t < 0) p.out[ot] = carry;\n    __syncthreads();\n"),
    ("parent_stats_cycles", *cut(EMI, *PS_CYCLES)),
    ("parent_stats_no_weights", EMI, "      const float q = diag_mix_q<DMAX>(rec_sh + mix * stride, x, x2);\n"
     "      g_sh[mix * (kFrames + 1) + k] = on ? g * expf(fminf(q - lb, 0.f)) : 0.f;",
     "      g_sh[mix * (kFrames + 1) + k] = on ? g : 0.f;"),
    ("parent_stats_no_columns", EMI, "    for (int col = k; col < M * Cm; col += kFrames) {",
     "    for (int col = k; col < 0; col += kFrames) {"),
]
# the redesigned lattice_forward_kernel: thread 0 of block 0 (its first
# recursion lane) per launch, the recursion over each tile and its wait at
# the tile's barrier; "mode" is layout, per_row
LN_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  for (int k = 0; k < n_tiles; ++k) {\n    const int t_lo = k * TT, t_hi = min(t_blk, t_lo + TT);\n",
     "  long long cy_rec = 0, cy_bar = 0;\n"
     "  for (int k = 0; k < n_tiles; ++k) {\n    long long c0 = clock64();\n"
     "    const int t_lo = k * TT, t_hi = min(t_blk, t_lo + TT);\n"),
    ("        if (!layout && wr[r]) ot[(size_t)tt * S * U + j[r] * U + u] = carry[r];\n      }\n    }\n    __syncthreads();\n  }\n",
     "        if (!layout && wr[r]) ot[(size_t)tt * S * U + j[r] * U + u] = carry[r];\n      }\n    }\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(carry[0]));\n    cy_rec += clock64() - c0;\n    c0 = clock64();\n"
     "    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && tid == 0)\n    printf(\"CYC latfwd_new mode %d%d S %d frames %d recursion %lld barrier %lld\\n\", layout, p.per_row, S,\n"
     "           t_blk, cy_rec, cy_bar);\n"),
)
# the redesigned emission_stats_kernel: threads 0 (warp 0, a contraction
# unit) and 160 (warp 5, none at em_diag) of block 0 over its tiles: the
# next tile's copies and the wait at the first barrier, the weights, the
# second barrier, the contraction
SN_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  for (int slot = 0; j < n_tiles; j += p.R, slot ^= 1) {\n    if (j + p.R < n_tiles) {",
     "  long long cy_wait = 0, cy_w = 0, cy_b2 = 0, cy_mma = 0;\n  int n_t = 0;\n"
     "  for (int slot = 0; j < n_tiles; j += p.R, slot ^= 1) {\n    long long c0 = clock64();\n    ++n_t;\n"
     "    if (j + p.R < n_tiles) {"),
    ("    __syncthreads();  // tile j is in; the last tile's contraction is done\n",
     "    __syncthreads();  // tile j is in; the last tile's contraction is done\n    cy_wait += clock64() - c0;\n    c0 = clock64();\n"),
    ("    __syncthreads();  // the tile's weights and features are complete\n"
     "    contract_3xtf32<false>(acc, rows, Cm, w_sh, x_sh, ks, D, (nf + 7) / 8, warp, nwarps);\n  }\n",
     "    cy_w += clock64() - c0;\n    c0 = clock64();\n    __syncthreads();  // the tile's weights and features are complete\n"
     "    cy_b2 += clock64() - c0;\n    c0 = clock64();\n"
     "    contract_3xtf32<false>(acc, rows, Cm, w_sh, x_sh, ks, D, (nf + 7) / 8, warp, nwarps);\n"
     "    cy_mma += clock64() - c0;\n  }\n  if (blockIdx.x == 0 && (tid == 0 || tid == 160))\n"
     "    printf(\"CYC stats_new tid %d D %d tiles %d wait %lld weights %lld barrier %lld contraction %lld\\n\", tid, D, n_t,\n"
     "           cy_wait, cy_w, cy_b2, cy_mma);\n"),
)
VARIANTS += [
    ("lattice_fwd_cycles", *cut(LAT, *LN_CYCLES)),
    ("stats_cycles", *cut(EMI, *SN_CYCLES)),
    ("lattice_fwd_no_store", LAT, "      if (!layout && k >= 1)\n        store_forward_tile(",
     "      if (!layout && k < 0)\n        store_forward_tile("),
    ("stats_no_contraction", EMI, "    contract_3xtf32<false>(acc, rows, Cm, w_sh, x_sh, ks, D, (nf + 7) / 8, warp, nwarps);\n",
     "    if (nf < 0) contract_3xtf32<false>(acc, rows, Cm, w_sh, x_sh, ks, D, (nf + 7) / 8, warp, nwarps);\n"),
    ("stats_no_weights", EMI, "        const float q = diag_mix_q<DMAX>(recs + (sl * M + mix) * stride, x, x2);\n"
     "        w_sh[(sl * M + mix) * ks + k] = on ? (g * expf(fminf(q - lb, 0.f))) * kWeightScale : 0.f;",
     "        w_sh[(sl * M + mix) * ks + k] = on ? g * kWeightScale : 0.f;"),
]
STATS_ONE_MIXTURE = """      for (int mix = 0; mix < M; ++mix) {
        const float q = diag_mix_q<DMAX>(recs + (sl * M + mix) * stride, x, x2);
        w_sh[(sl * M + mix) * ks + k] = on ? (g * expf(fminf(q - lb, 0.f))) * kWeightScale : 0.f;
      }
"""
STATS_MIXTURE_PAIRS = """      int mix = 0;
      for (; mix + 2 <= M; mix += 2) {
        const float qa = diag_mix_q<DMAX>(recs + (sl * M + mix) * stride, x, x2);
        const float qb = diag_mix_q<DMAX>(recs + (sl * M + mix + 1) * stride, x, x2);
        w_sh[(sl * M + mix) * ks + k] = on ? (g * expf(fminf(qa - lb, 0.f))) * kWeightScale : 0.f;
        w_sh[(sl * M + mix + 1) * ks + k] = on ? (g * expf(fminf(qb - lb, 0.f))) * kWeightScale : 0.f;
      }
      if (mix < M) {
        const float q = diag_mix_q<DMAX>(recs + (sl * M + mix) * stride, x, x2);
        w_sh[(sl * M + mix) * ks + k] = on ? (g * expf(fminf(q - lb, 0.f))) * kWeightScale : 0.f;
      }
"""
VARIANTS += [
    # the redesigned moments kernel's other shapes: two mixtures' q chains
    # side by side, 64-frame tiles, 128-thread blocks; the forward kernel
    # held to 40 registers (10 blocks an SM)
    ("stats_mixture_pairs", EMI, STATS_ONE_MIXTURE, STATS_MIXTURE_PAIRS),
    ("stats_tiles_64", EMI_PY, "STATS_TILES = (128, 64, 32, 16, 8)", "STATS_TILES = (64, 32, 16, 8)"),
    ("stats_128_threads", EMI, "constexpr int kStatsThreads = 256;", "constexpr int kStatsThreads = 128;"),
    ("lattice_fwd_10_blocks", LAT, "__global__ void __launch_bounds__(kFwdThreads) lattice_forward_kernel(",
     "__global__ void __launch_bounds__(kFwdThreads, 10) lattice_forward_kernel("),
]
VARIANTS += [joined("stats_tiles_64_lattice_fwd_10_blocks", "stats_tiles_64", "lattice_fwd_10_blocks")]
# the forward kernel's memory warp without a division a copy where the
# block's row of U utterances splits evenly over its threads (a thread keeps
# its column and steps the rows), and with four memory warps (one beside
# each recursion warp)
FWD_STAGE_ROWS = ("""    const int per = U / w, total = n * S * per;
    for (int c = i; c < total; c += count) {
      const int row = c / per, v = c - row * per, b = b0 + v * w;  // row = tt S + s
      const bool ok = b < B;""", """    const int per = U / w, total = n * S * per;
    if (count % per == 0) {
      const int v = i % per, b = b0 + v * w;
      const bool ok = b < B;
      for (int row = i / per; row < n * S; row += count / per) {
        const float* s = ok ? src + ((size_t)t0 * S + row) * B + b : src;
        float* d = dst + (size_t)row * U + v * w;
        if (vec) {
          cp_async16(d, s, ok);
        } else {
          cp_async4(d, s, ok);
        }
      }
      return;
    }
    for (int c = i; c < total; c += count) {
      const int row = c / per, v = c - row * per, b = b0 + v * w;  // row = tt S + s
      const bool ok = b < B;""")
FWD_STORE_ROWS = ("""  const int w = vec ? 4 : 1, per = U / w, total = n * S * per;
  for (int c = i; c < total; c += count) {
    const int row = c / per, v = c - row * per, b = b0 + v * w;
    if (b >= B) continue;""", """  const int w = vec ? 4 : 1, per = U / w, total = n * S * per;
  if (count % per == 0) {
    const int v = i % per, b = b0 + v * w;
    if (b >= B) return;
    for (int row = i / per; row < n * S; row += count / per) {
      float* d = dst + ((size_t)t0 * S + row) * B + b;
      const float* s = tile + (size_t)row * U + v * w;
      if (vec) {
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
      } else {
        *d = *s;
      }
    }
    return;
  }
  for (int c = i; c < total; c += count) {
    const int row = c / per, v = c - row * per, b = b0 + v * w;
    if (b >= B) continue;""")
VARIANTS += [
    ("lattice_fwd_rows_without_division", *cut(LAT, FWD_STAGE_ROWS, FWD_STORE_ROWS)),
    ("lattice_fwd_4_memory_warps", LAT, "constexpr int kFwdThreads = 32 * (kFwdRecWarps + 1);  // and one memory warp",
     "constexpr int kFwdThreads = 32 * (kFwdRecWarps + 4);  // and one memory warp"),
    ("stats_tiles_256", EMI_PY, "STATS_TILES = (128, 64, 32, 16, 8)", "STATS_TILES = (256, 128, 64, 32, 16, 8)"),
]
VARIANTS += [joined("lattice_fwd_4_memory_warps_stats_tiles_256", "lattice_fwd_4_memory_warps", "stats_tiles_256")]
VARIANTS += [
    joined("lattice_stats_cycles", "lattice_fwd_cycles", "stats_cycles"),
    joined("lattice_no_store_stats_no_contraction", "lattice_fwd_no_store", "stats_no_contraction"),
]
VARIANTS += [
    joined("parent_lattice_stats_cycles", "parent_lattice_fwd_cycles", "parent_stats_cycles"),
    joined("parent_lattice_no_load_stats_no_weights", "parent_lattice_fwd_no_load", "parent_stats_no_weights"),
    joined("parent_lattice_no_barrier_stats_no_columns", "parent_lattice_fwd_no_barrier", "parent_stats_no_columns"),
]
# bac667f's lattice_backward_kernel and viterbi_kernel (step 0 of their
# redesign): thread 0 of block 0 per launch, the log b load (waited for),
# the recursion, the stores (shared row and lattice or backpointers), the
# barrier of the frame
PB_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  for (int t = p.T - 2; t >= 0; --t) {\n"
     "    const float lbn = live ? fmaxf(p.log_b[o + (size_t)(t + 1) * p.st], kNegInf) : kNegInf;\n",
     "  long long cy_load = 0, cy_rec = 0, cy_store = 0, cy_bar = 0;\n  for (int t = p.T - 2; t >= 0; --t) {\n"
     "    long long c0 = clock64();\n    float lbn = live ? fmaxf(p.log_b[o + (size_t)(t + 1) * p.st], kNegInf) : kNegInf;\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(lbn));\n    cy_load += clock64() - c0;\n    c0 = clock64();\n"),
    ("    inner[threadIdx.x] = lbn + beta;\n    __syncthreads();\n",
     "    inner[threadIdx.x] = lbn + beta;\n    cy_store += clock64() - c0;\n    c0 = clock64();\n    __syncthreads();\n"
     "    cy_bar += clock64() - c0;\n    c0 = clock64();\n"),
    ("      beta = beta_init;\n    }\n    if (live) p.out[o + (size_t)t * p.st] = beta;\n  }\n}\n",
     "      beta = beta_init;\n    }\n    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(beta));\n    cy_rec += clock64() - c0;\n"
     "    c0 = clock64();\n    if (live) p.out[o + (size_t)t * p.st] = beta;\n    cy_store += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    printf(\"CYC lattice_bwd S %d T %d load %lld recursion %lld store %lld barrier %lld\\n\", S, p.T, cy_load,\n"
     "           cy_rec, cy_store, cy_bar);\n}\n"),
)
PV13_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  float carry = kNegInf;\n  __syncthreads();\n  for (int t = 0; t < p.T; ++t) {\n",
     "  float carry = kNegInf;\n  long long cy_load = 0, cy_rec = 0, cy_store = 0, cy_bar = 0;\n  __syncthreads();\n"
     "  for (int t = 0; t < p.T; ++t) {\n"),
    ("    const float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;\n    int arg = j;",
     "    long long c0 = clock64();\n    float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(lb));\n    cy_load += clock64() - c0;\n    c0 = clock64();\n    int arg = j;"),
    ("    row[(t & 1) * nt + threadIdx.x] = carry;\n    if (live) p.bptr[ot] = arg;\n    __syncthreads();\n  }\n",
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(carry));\n    cy_rec += clock64() - c0;\n    c0 = clock64();\n"
     "    row[(t & 1) * nt + threadIdx.x] = carry;\n    if (live) p.bptr[ot] = arg;\n    cy_store += clock64() - c0;\n"
     "    c0 = clock64();\n    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    printf(\"CYC viterbi S %d T %d load %lld recursion %lld store %lld barrier %lld\\n\", S, p.T, cy_load, cy_rec,\n"
     "           cy_store, cy_bar);\n"),
)
VARIANTS += [
    ("parent_lattice_bwd_cycles", *cut(LAT, *PB_CYCLES)),
    ("parent_lattice_bwd_no_load", LAT,
     "    const float lbn = live ? fmaxf(p.log_b[o + (size_t)(t + 1) * p.st], kNegInf) : kNegInf;\n",
     "    const float lbn = live ? -0.25f * (float)(t & 7) : kNegInf;\n"),
    ("parent_lattice_bwd_no_barrier", LAT, "    inner[threadIdx.x] = lbn + beta;\n    __syncthreads();\n",
     "    inner[threadIdx.x] = lbn + beta;\n"),
    ("parent_lattice_bwd_no_store", LAT, "    if (live) p.out[o + (size_t)t * p.st] = beta;\n",
     "    if (live && t < 0) p.out[o + (size_t)t * p.st] = beta;\n"),
    ("parent_viterbi_cycles", *cut(LAT, *PV13_CYCLES)),
    ("parent_viterbi_no_load", LAT, "    const float lb = live ? fmaxf(p.log_b[ot], kNegInf) : kNegInf;\n    int arg = j;",
     "    const float lb = live ? -0.25f * (float)(t & 7) : kNegInf;\n    int arg = j;"),
    ("parent_viterbi_no_barrier", LAT, "    if (live) p.bptr[ot] = arg;\n    __syncthreads();\n",
     "    if (live) p.bptr[ot] = arg;\n"),
    ("parent_viterbi_no_store", LAT, "    if (live) p.bptr[ot] = arg;\n", "    if (live && t < 0) p.bptr[ot] = arg;\n"),
]
VARIANTS += [
    joined(f"parent_lattice_bwd_viterbi_{cut_}", f"parent_lattice_bwd_{cut_}", f"parent_viterbi_{cut_}")
    for cut_ in ("cycles", "no_load", "no_barrier", "no_store")
]
# the redesigned lattice_backward_kernel and viterbi_kernel: thread 0 of
# block 0 (the first recursion lane) per launch, the recursion over each
# tile and its wait at the tile's barrier; and the memory warp's stores cut
BN_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  for (int k = 0; k < n_tiles; ++k) {\n    int t_lo, t_hi;\n    backward_rows(k, T, TT, t_lo, t_hi);\n"
     "    const float* lbt",
     "  long long cy_rec = 0, cy_bar = 0;\n  for (int k = 0; k < n_tiles; ++k) {\n    long long c0 = clock64();\n"
     "    int t_lo, t_hi;\n    backward_rows(k, T, TT, t_lo, t_hi);\n    const float* lbt"),
    ("        if (wr[r]) ot[(size_t)tt * fs + st[r] * U + u] = beta[r];\n    }\n    __syncthreads();\n  }\n",
     "        if (wr[r]) ot[(size_t)tt * fs + st[r] * U + u] = beta[r];\n    }\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(beta[0]));\n    cy_rec += clock64() - c0;\n    c0 = clock64();\n"
     "    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n  if (blockIdx.x == 0 && tid == 0)\n"
     "    printf(\"CYC latbwd_new S %d frames %d recursion %lld barrier %lld\\n\", S, T, cy_rec, cy_bar);\n"),
)
VN13_CYCLES = (
    ("#include <math.h>\n", "#include <math.h>\n#include <cstdio>\n"),
    ("  for (int k = 0; k < n_tiles; ++k) {\n    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);\n",
     "  long long cy_rec = 0, cy_bar = 0;\n  for (int k = 0; k < n_tiles; ++k) {\n    long long c0 = clock64();\n"
     "    const int t_lo = k * TT, t_hi = min(T, t_lo + TT);\n"),
    ("        if (wr[r]) bpt[u * Q + tt * S + j[r]] = step ? arg[r] : j[r];\n      }\n    }\n    __syncthreads();\n  }\n",
     "        if (wr[r]) bpt[u * Q + tt * S + j[r]] = step ? arg[r] : j[r];\n      }\n    }\n"
     "    asm volatile(\"mov.b32 %0, %0;\" : \"+f\"(score[0]));\n    cy_rec += clock64() - c0;\n    c0 = clock64();\n"
     "    __syncthreads();\n    cy_bar += clock64() - c0;\n  }\n  if (blockIdx.x == 0 && tid == 0)\n"
     "    printf(\"CYC viterbi_new S %d frames %d recursion %lld barrier %lld\\n\", S, T, cy_rec, cy_bar);\n"),
)
VARIANTS += [
    ("lattice_bwd_cycles", *cut(LAT, *BN_CYCLES)),
    ("viterbi_cycles", *cut(LAT, *VN13_CYCLES)),
    ("lattice_bwd_no_store", LAT, "      store_forward_tile(p.out, out_slots + (k & 1) * tile, t_lo, t_hi - t_lo,",
     "      if (k < 0) store_forward_tile(p.out, out_slots + (k & 1) * tile, t_lo, t_hi - t_lo,"),
    ("viterbi_no_store", LAT, "      store_run_tile(p.bptr, bp_slots + (k & 1) * tile,",
     "      if (k < 0) store_run_tile(p.bptr, bp_slots + (k & 1) * tile,"),
]
VARIANTS += [
    joined("lattice_bwd_viterbi_cycles", "lattice_bwd_cycles", "viterbi_cycles"),
    joined("lattice_bwd_viterbi_no_store", "lattice_bwd_no_store", "viterbi_no_store"),
]
# the (B, T, S) runs copied in and stored out with no division a copy: the
# memory warp steps each utterance's run in turn (the forward's last-row
# mode shares the copies)
RUNS_STAGE = ("""    const int per = (n * S + w - 1) / w, total = U * per;
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
    }""", """    const int per = (n * S + w - 1) / w;
    for (int u = 0; u < U; ++u) {
      const bool ok = b0 + u < B;
      const float* s0 = ok ? src + ((size_t)(b0 + u) * T + t0) * S : src;
      float* d0 = dst + (size_t)u * Q;
      for (int v = i; v < per; v += count) {
        if (vec) {
          cp_async16(d0 + v * w, ok ? s0 + v * w : src, ok);
        } else {
          cp_async4(d0 + v * w, ok ? s0 + v * w : src, ok);
        }
      }
    }""")
RUNS_STORE = ("""  const int w = vec ? 4 : 1, per = (n * S + w - 1) / w, total = U * per;
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
  }""", """  const int w = vec ? 4 : 1, per = (n * S + w - 1) / w;
  for (int u = 0; u < U && b0 + u < B; ++u) {
    int* d = dst + ((size_t)(b0 + u) * T + t0) * S;
    const int* s = tile + (size_t)u * Q;
    for (int v = i; v < per; v += count) {
      if (vec) {
        *reinterpret_cast<int4*>(d + v * 4) = *reinterpret_cast<const int4*>(s + v * 4);
      } else {
        d[v] = s[v];
      }
    }
  }""")
VARIANTS += [
    ("lattice_bwd_viterbi_runs_without_division", *cut(LAT, RUNS_STAGE, RUNS_STORE)),
    # two or four memory warps a block in the backward (and forward) and
    # the Viterbi kernels; the Viterbi with one, as first written
    ("lattice_bwd_viterbi_2_memory_warps", LAT,
     "constexpr int kFwdThreads = 32 * (kFwdRecWarps + 1);  // and one memory warp",
     "constexpr int kFwdThreads = 32 * (kFwdRecWarps + 2);  // and one memory warp"),
    ("lattice_bwd_viterbi_4_memory_warps", LAT,
     ("constexpr int kFwdThreads = 32 * (kFwdRecWarps + 1);  // and one memory warp",
      "constexpr int kVitThreads = 32 * (kFwdRecWarps + 2);"),
     ("constexpr int kFwdThreads = 32 * (kFwdRecWarps + 4);  // and one memory warp",
      "constexpr int kVitThreads = 32 * (kFwdRecWarps + 4);")),
    ("viterbi_1_memory_warp", LAT, "constexpr int kVitThreads = 32 * (kFwdRecWarps + 2);",
     "constexpr int kVitThreads = 32 * (kFwdRecWarps + 1);"),
]
VARIANTS += [joined("lattice_bwd_viterbi_runs_without_division_2_memory_warps",
                    "lattice_bwd_viterbi_runs_without_division", "lattice_bwd_viterbi_2_memory_warps")]
VARIANTS += [
    joined("vocab_noinline_4_columns", "vocab_noinline_emission", "vocab_4_columns"),
    joined("vocab_noinline_448_threads", "vocab_noinline_emission", "vocab_448_threads_2_blocks"),
]
# the z-GEMM bank kernels at full covariance past D = 16 (emb_full39):
# without the z FMAs (z = c), with one shared-memory load of L^T (or of x)
# a k group where there are RB / 4 (4), without the slices' copies, and
# the moments without their contraction or without their posteriors' z-GEMM
# (the first four cut csrc/wide_gemm.cuh, which the E-step's z-GEMM blocks
# share; the "wide_" variants time the bank kernels only)
Z_FMAS = ("  for (int kk = 0; kk < d4; ++kk) {\n    float4 x[4];", "  for (int kk = 0; kk < 0; ++kk) {\n    float4 x[4];")
SLICE_COPIES = ("  for (int i = threadIdx.x; i < n * per; i += blockDim.x) {",
                "  for (int i = threadIdx.x; i < 0; i += blockDim.x) {")
VARIANTS += [
    ("wide_base", COMP, "", ""),
    ("wide_no_z_fmas", WIDE, *Z_FMAS),
    ("wide_one_w_load", WIDE, "*reinterpret_cast<const float4*>(w + (4 * i + t) * P + 4 * kk);",
     "*reinterpret_cast<const float4*>(w + t * P + 4 * kk);"),
    ("wide_one_x_load", WIDE, "x[f] = *reinterpret_cast<const float4*>(xs + (f * 8 + tau) * P + 4 * kk);",
     "x[f] = *reinterpret_cast<const float4*>(xs + tau * P + 4 * kk);"),
    ("wide_no_copies", WIDE, *SLICE_COPIES),
    ("wide_moments_no_contraction", COMP, "    wide_contract<RB, MTW>(acc, xs, wq, tab, nm, nb * (kTile / 8), n_mt);\n",
     ""),
    ("wide_moments_no_posteriors", COMP, "      if (s < ns && gw < min(kWideSlice, M - s * kWideSlice) && fg < nb) {",
     "      if (false) {"),
]
# the E-step's z-GEMM blocks at full covariance past D = 16 (em_full39,
# tests/torch_em_wide_compare.py): without the z FMAs, without the slices'
# copies, the moments without their contraction, and the moments without
# their posteriors' z-GEMM (the floor of a route that stores q in #2 and
# reads it back here, beside the stored q's bytes the script times)
VARIANTS += [
    ("emw_base", FEM, "", ""),
    ("emw_no_z_fmas", WIDE, *Z_FMAS),
    ("emw_no_copies", WIDE, *SLICE_COPIES),
    ("emw_moments_no_contraction", FEM, "    wide_contract<RB, MTW>(acc, xs, wq, tab, nm, (nb + 7) / 8, n_mt);\n", ""),
    ("emw_moments_no_posteriors", FEM,
     "      if (s < ns && gw < min(kWideSlice, hi - lo - s * kWideSlice) && fg * 32 < nb) {", "      if (false) {"),
]
SCORING_EMISSION = ("scoring_emission_", "vocab_", "emission_", "parent_vocab", "parent_emission")
FORWARD_DECODE = ("forward_", "decode_", "parent_forward", "parent_decode")
EMIT_MFCC = ("emit_", "mfcc_", "parent_emit", "parent_mfcc")
LATTICE_STATS = ("lattice_", "stats_", "viterbi_", "parent_lattice", "parent_stats", "parent_viterbi")


# variants of the backward and Viterbi kernels time only their own calls
BACKWARD_VITERBI = ("lattice_bwd", "viterbi_", "parent_lattice_bwd", "parent_viterbi")


def timing_script(name: str) -> str:
    if name.startswith("wide_"):
        return "torch_bank_wide_compare.py"
    if name.startswith("emw_"):
        return "torch_em_wide_compare.py"
    if name.startswith(LATTICE_STATS):
        return "torch_lattice_stats_compare.py"
    if name.startswith(SCORING_EMISSION):
        return "torch_scoring_emission_compare.py"
    if name.startswith(EMIT_MFCC):
        return "torch_emit_mfcc_compare.py"
    return "torch_forward_decode_compare.py" if name.startswith(FORWARD_DECODE) else "torch_backward_compare.py"


def main(argv) -> None:
    global ROOT
    here = ROOT  # this checkout: its timing scripts run against every copy
    if argv[:1] == ["--tree"]:
        ROOT, argv = Path(argv[1]).resolve(), argv[2:]
    chosen = [v for v in VARIANTS if not argv or v[0] in argv]
    if not argv:
        chosen.append(VARIANTS[0])
    for name, src, old, new in chosen:
        d = Path(tempfile.mkdtemp(prefix=f"var_{name}_")) / "tree"
        shutil.copytree(ROOT, d, ignore=shutil.ignore_patterns(".git", "build", "scratch", "chiprun_out", "__pycache__"))
        olds, news = (old, new) if isinstance(old, tuple) else ((old,), (new,))
        srcs = src if isinstance(src, tuple) else (src,) * len(olds)
        for path, o, n in zip(srcs, olds, news):
            if o:
                f = d / path
                text = f.read_text()
                assert text.count(o) == 1, (name, o[:60])
                f.write_text(text.replace(o, n))
        script = here / "tests" / timing_script(name)
        only = ["backward_lattice", "viterbi_batch"] if name.startswith(BACKWARD_VITERBI) else []
        if name.startswith("emw_"):  # em_full39's inputs, built by the first variant and loaded by the rest
            only = [str(here / "build" / "em_full39_inputs.pt")]
        r = subprocess.run([sys.executable, str(script), "time", *only], cwd=d, capture_output=True,
                           text=True, timeout=900, env={**os.environ, "PYTHONPATH": str(d)})
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        out = json.loads(lines[-1]) if lines else {"error": r.stderr[-600:]}
        kinds = {}
        for line in r.stdout.splitlines():
            if line.startswith("CYC"):
                kinds.setdefault(" ".join(line.split()[:5]), []).append(line)
        cycles = [line for lines in kinds.values() for line in lines[-2:]]
        print(json.dumps({"variant": name, **out, **({"cycles": cycles} if cycles else {})}), flush=True)
        shutil.rmtree(d.parent, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
