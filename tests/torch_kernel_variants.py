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
K = 1, 2, 3).  The "parent_" variants cut the composed_forward and decode
kernels of 03f5319 (run them with --tree on a checkout of that commit).
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
    ("emit_no_emission", FEM, "        for (int q = 0; q < p.n_streams; ++q) {\n          const int D = p.dims[q], M = p.mixes[q];\n"
     "          const float* o = cst", "        for (int q = 0; q < 0; ++q) {\n          const int D = p.dims[q], M = p.mixes[q];\n"
     "          const float* o = cst"),
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
]
FORWARD_DECODE = ("forward_", "decode_", "parent_forward", "parent_decode")
EMIT_MFCC = ("emit_", "mfcc_", "parent_emit", "parent_mfcc")


def timing_script(name: str) -> str:
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
        r = subprocess.run([sys.executable, str(script), "time"], cwd=d, capture_output=True,
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
