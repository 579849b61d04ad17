"""Mutation check of csrc/lattice.cu, csrc/emission_em.cu, csrc/composed.cu,
csrc/fused_em.cu, csrc/tile_mma.cuh, csrc/emission.cuh, csrc/wide_gemm.cuh,
csrc/word_loop_decode.cu, csrc/mfcc.cu, csrc/vocab_scores.cu,
csrc/wide_log_b.cu and the wrappers that pack and split their launches
(needs a CUDA card and nvcc; not a tier-1 test):

    python tests/torch_kernel_mutants.py [mutant ...]

Each mutant is a copy of the tree in a temporary directory with one
deliberate fault in a kernel source (or a wrapper); the chip_smoke.py phase that should
catch it (kernel, kernel_lattice, kernel_emission, kernel_composed,
kernel_em, kernel_decode, kernel_mfcc, or kernel_lattice_wide,
kernel_em_wide and kernel_composed_wide, the shapes past 64 states and
full covariance past D = 16) runs there, after the build.
Prints one JSON line per mutant: caught (the phase raised) or survived,
and the largest moment error over its scale (``mom_*``) the phase's rows
reported before it ended.  With no arguments every mutant runs.
"""

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LAT, EM = "srhmm_tpu_torch/csrc/lattice.cu", "srhmm_tpu_torch/csrc/emission_em.cu"
COMP = "srhmm_tpu_torch/csrc/composed.cu"
FEM, TILE = "srhmm_tpu_torch/csrc/fused_em.cu", "srhmm_tpu_torch/csrc/tile_mma.cuh"
DEC = "srhmm_tpu_torch/csrc/word_loop_decode.cu"
EMC, VOC = "srhmm_tpu_torch/csrc/emission.cuh", "srhmm_tpu_torch/csrc/vocab_scores.cu"
WIDE = "srhmm_tpu_torch/csrc/wide_gemm.cuh"
MUTANTS = [
    ("forward_length_mask", LAT, "(t < len ? next[r] : carry[r])", "(t <= len ? next[r] : carry[r])", "kernel_lattice"),
    ("backward_stepping_rule", LAT, "beta[r] = (t + 1 < len) ? next[r] : init[r];",
     "beta[r] = (t + 2 < len) ? next[r] : init[r];", "kernel_lattice"),
    ("viterbi_tie_to_highest", LAT, "const bool up = bv[i + w] > bv[i];", "const bool up = bv[i + w] >= bv[i];",
     "kernel_lattice"),
    ("per_row_shared_matrix", LAT, "p.lt[(size_t)b0 * SS + i]", "p.lt[(size_t)b0 * SS + i % SS]", "kernel_lattice"),
    ("forward_no_carry_clamp", LAT, "  return fmaxf(m + logf(e) + lb, kNegInf);", "  return m + logf(e) + lb;", "kernel_lattice"),
    ("emission_drops_last_mixture", EM, "state_log_b_cols<DMAX, false, NC>(recs + s * M * stride, M, D, x, v);",
     "state_log_b_cols<DMAX, false, NC>(recs + s * M * stride, M - (M > 1), D, x, v);", "kernel_emission"),
    ("stats_tile_drops_last_frame", EM, "const int nf = (int)min((long long)TF, p.N - j * TF);",
     "const int nf = (int)min((long long)TF, p.N - j * TF) - 1;", "kernel_emission"),
    ("stats_sum_skips_last_block", EM, "for (int r = lane; r < ranges; r += 32)", "for (int r = lane; r + 1 < ranges; r += 32)",
     "kernel_emission"),
    ("stats_ignores_neg_inf_log_b", EM, "(on && lb > kNegInf) ? gt[k * p.SG + sl]", "(on) ? gt[k * p.SG + sl]",
     "kernel_emission"),
    ("moments_vote_skips_single_frame_tile", COMP, "__any_sync(~0u, gv[v] != 0.f)",
     "(__popc(__ballot_sync(~0u, gv[v] != 0.f)) > 1)", "kernel_composed"),
    ("moments_3xtf32_drops_lo_hi", TILE, "        mma_tf32(c[hh], alo, b0h, b1h);\n", "", "kernel_composed"),
    ("emission_groups_floor", COMP, "int groups_of(int D) { return (D + 3) / 4; }",
     "int groups_of(int D) { return D / 4; }", "kernel_composed"),
    ("sum_chunks_skips_last_partial", COMP, "g < m.chunk_cum[r + 1]; ++g)", "g + 1 < m.chunk_cum[r + 1]; ++g)",
     "kernel_composed"),
    ("emission_ring_reads_previous_row", COMP, "ring + (size_t)(nbuf > 0 ? j % nbuf : 0) * p.rec_floats;",
     "ring + (size_t)(nbuf > 0 ? (j + nbuf - 1) % nbuf : 0) * p.rec_floats;", "kernel_composed"),
    ("backward_ring_reads_previous_tile", COMP, "      float* la_tile = la_slots + ((k - 1) % 3) * tile;",
     "      float* la_tile = la_slots + (k % 3) * tile;", "kernel_composed"),
    ("backward_drops_first_frame_of_tile", COMP,
     "        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt = t - t_lo;\n          float* in_row",
     "        for (int t = t_hi - 1; t > t_lo; --t) {\n          const int tt = t - t_lo;\n          float* in_row",
     "kernel_composed"),
    ("backward_shuffle_off_by_one_row", COMP, "__shfl_down_sync(~0u, inner[q % R], q / R)",
     "__shfl_down_sync(~0u, inner[(q + 1) % R], (q + 1) / R)", "kernel_composed"),
    ("em_ring_reads_previous_tile", FEM, "        const float* buf = ring + (k % 3) * frame_tile;",
     "        const float* buf = ring + ((k + 2) % 3) * frame_tile;", "kernel_em"),
    ("em_drops_first_frame_of_tile", FEM, "        for (int t = t_hi - 1; t >= t_lo; --t) {\n          const int tt",
     "        for (int t = t_hi - 1; t > t_lo; --t) {\n          const int tt", "kernel_em"),
    ("em_3xtf32_drops_lo_hi", TILE, "        mma_tf32(c[hh], alo, b0h, b1h);\n", "", "kernel_em"),
    ("em_vote_skips_single_nonzero_column", FEM, "const bool keep = nonzero > 0;", "const bool keep = nonzero > 1;",
     "kernel_em"),
    ("forward_shuffle_off_by_one_row", COMP, "__shfl_up_sync(~0u, carry[(R - s % R) % R], o)",
     "__shfl_up_sync(~0u, carry[(R - (s + 1) % R) % R], (s + R) / R)", "kernel_composed"),
    ("forward_staging_reads_previous_tile", COMP, "    const float* lb_tile = lb_slots + (k & 1) * tile;",
     "    const float* lb_tile = lb_slots + ((k + 1) & 1) * tile;", "kernel_composed"),
    ("forward_off_chain_term_sums_one", COMP, "          for (int d = 0; d < NDB; ++d) e += expf(v[d] - m);",
     "          for (int d = 0; d < NDB; ++d) e += (v[d] == -INFINITY) ? 1.f : expf(v[d] - m);", "kernel_composed"),
    ("decode_merge_ties_to_higher_source", DEC, "    if (better(v, i, vals[k], ids[k])) {",
     "    if (v > vals[k] || (v == vals[k] && i > ids[k])) {", "kernel_decode"),
    ("decode_k2_runner_up_seed_dropped", DEC,
     "      if (better(kNegInf, ub, s1x, asr)) {\n        s1x = kNegInf;\n        asr = ub;\n      }\n", "",
     "kernel_decode"),
    ("decode_kn_insertion_unstable", DEC, "              slot_insert<K>(lv, li, c, u * K + kk);",
     "              {\n                float cv = c;\n                int ci = u * K + kk;\n"
     "                for (int q = 0; q < K; ++q)\n                  if (cv >= lv[q]) {\n"
     "                    const float tv = lv[q];\n                    const int ti = li[q];\n"
     "                    lv[q] = cv;\n                    li[q] = ci;\n                    cv = tv;\n"
     "                    ci = ti;\n                  }\n              }", "kernel_decode"),
]
MFCC = "srhmm_tpu_torch/csrc/mfcc.cu"
MUTANTS += [
    ("emit_shuffle_off_by_one_state", FEM, "float x = __shfl_up_sync(~0u, carry, kk);",
     "float x = __shfl_up_sync(~0u, carry, kk + 1);", "kernel_em"),
    ("emit_staging_reads_previous_tile", FEM, "        const float* f = xs + (k & 1) * x_tile;\n        float* lbt",
     "        const float* f = xs + ((k + 1) & 1) * x_tile;\n        float* lbt", "kernel_em"),
    ("emit_off_chain_term_sums_one", EMC, "  for (int kk = 0; kk < NSL; ++kk) e += expf(v[kk] - m);",
     "  for (int kk = 0; kk < NSL; ++kk) e += (v[kk] == -INFINITY) ? 1.f : expf(v[kk] - m);", "kernel_em"),
    ("emit_drops_last_frame_of_partial_tile", FEM, "const int t0 = k * TT, n = min(TT, T - t0), ncol = n * U;",
     "const int t0 = k * TT, n = min(TT, T - t0) - (T - t0 < TT), ncol = n * U;", "kernel_em"),
    ("emit_past_length_takes_the_step", FEM, "(t < len ? next : carry)", "next", "kernel_em"),
    ("mfcc_twiddle_conjugated", MFCC, "      const float2 w = __ldg(tw + (r - 1) * p + k);",
     "      const float2 w0 = __ldg(tw + (r - 1) * p + k), w = make_float2(w0.x, -w0.y);", "kernel_mfcc"),
    ("mfcc_split_drops_nyquist", MFCC, "    pw[(size_t)f * 2 * N + k] = __fadd_rn(",
     "    pw[(size_t)f * 2 * N + k] = (p.split && k == N) ? 0.f : __fadd_rn(", "kernel_mfcc"),
    ("mfcc_generic_stage_wrong_stride", MFCC, "const float2 v = x[i + a * m], w",
     "const float2 v = x[i + a * (m + 1)], w", "kernel_mfcc"),
    ("mfcc_mel_range_one_bin_short", MFCC, "for (int k = k_lo; k < k_hi; ++k) acc",
     "for (int k = k_lo; k < k_hi - 1; ++k) acc", "kernel_mfcc"),
]
MUTANTS += [
    ("vocab_shuffle_off_by_one_state", VOC, "float x = __shfl_up_sync(~0u, carry, kk);",
     "float x = __shfl_up_sync(~0u, carry, kk + 1);", "kernel"),
    ("vocab_staging_reads_previous_tile", VOC, "emission_tile<DMAX, FULL>(p, cst, xs + ((k + 1) & 1) * x_tile,",
     "emission_tile<DMAX, FULL>(p, cst, xs + (k & 1) * x_tile,", "kernel"),
    ("vocab_viterbi_sums", VOC, "upd = slots_max<NSL>(v);", "upd = slots_lse<NSL>(v);", "kernel"),
    ("vocab_drops_last_frame_of_ragged_utterance", VOC, "(t < len ? next : carry)", "(t + 1 < len ? next : carry)",
     "kernel"),
    ("emission_tail_tile_dropped", EM, "const long long n_tiles = (p.N + tf - 1) / tf;",
     "const long long n_tiles = p.N / tf;", "kernel_emission"),
    ("emission_store_offset_by_one_state", EM, "lbo[(size_t)(tid + c * nt) * S + s] = v[c];",
     "lbo[(size_t)(tid + c * nt) * S + (s + 1) % S] = v[c];", "kernel_emission"),
]
MUTANTS += [
    # the redesigned lattice forward kernel and emission_stats kernel
    ("lattice_fwd_shuffle_off_by_one_state", LAT, "__shfl_sync(~0u, carry, (src0 + i) & 31)",
     "__shfl_sync(~0u, carry, (src0 + i + 1) & 31)", "kernel_lattice"),
    ("lattice_fwd_wide_shuffle_off_by_one_state", LAT, "x[i] = __shfl_sync(~0u, carry[i >> 5], i & 31);",
     "x[i] = __shfl_sync(~0u, carry[i >> 5], (i + 1) & 31);", "kernel_lattice"),
    ("lattice_fwd_staging_reads_previous_tile", LAT, "const float* lbt = lb_slots + (k & 1) * tile;",
     "const float* lbt = lb_slots + ((k + 1) & 1) * tile;", "kernel_lattice"),
    ("lattice_fwd_drops_last_frame", LAT, "const int t_lo = k * TT, t_hi = min(t_blk, t_lo + TT);",
     "const int t_lo = k * TT, t_hi = min(t_blk - 1, t_lo + TT);", "kernel_lattice"),
    ("lattice_fwd_last_tile_store_short", LAT, "k * TT, t_blk - k * TT, S, p.B, b0, U, p.vec, i, count);",
     "k * TT, t_blk - k * TT - 1, S, p.B, b0, U, p.vec, i, count);", "kernel_lattice"),
    ("lattice_fwd_per_row_first_matrix", LAT, "(p.per_row ? (size_t)min(b, p.B - 1) * S * S : 0)",
     "(p.per_row ? (size_t)0 : 0)", "kernel_lattice"),
    ("stats_tail_tile_dropped", EM, "const long long n_tiles = (p.N + TF - 1) / TF;",
     "const long long n_tiles = p.N / TF;", "kernel_emission"),
    ("stats_group_offset_by_one_state", EM, "const float* recs = p.recs + (size_t)s0 * M * stride;",
     "const float* recs = p.recs + (size_t)(s0 > 0 ? s0 - 1 : 0) * M * stride;", "kernel_emission"),
    # the moments' 3xTF32 contraction without one correction product, and
    # as a single TF32 pass
    ("stats_3xtf32_drops_lo_hi", TILE, "        mma_tf32(c[hh], alo, b0h, b1h);\n", "", "kernel_emission"),
    ("stats_single_pass_tf32", TILE,
     "        mma_tf32(c[hh], alo, b0h, b1h);\n        mma_tf32(c[hh], ahi, b0l, b1l);\n", "", "kernel_emission"),
]
MUTANTS += [
    # the redesigned backward and Viterbi kernels
    ("backward_reads_frame_t", LAT, "p.log_b, 0, t_lo + 1, min(t_hi + 1, T) - t_lo - 1,",
     "p.log_b, 0, t_lo, min(t_hi + 1, T) - t_lo - 1,", "kernel_lattice"),
    ("backward_staging_drops_tile_edge_frame", LAT, "p.log_b, 0, t_lo + 1, min(t_hi + 1, T) - t_lo - 1,",
     "p.log_b, 0, t_lo + 1, min(t_hi, T) - t_lo - 1,", "kernel_lattice"),
    ("backward_shuffle_off_by_one_state", LAT, "forward_sources<NS>(inner[0], src0, S, ltr, v);",
     "forward_sources<NS>(inner[0], src0 + 1, S, ltr, v);", "kernel_lattice"),
    ("backward_wide_shuffle_off_by_one_state", LAT, "x[i] = __shfl_sync(~0u, inner[i >> 5], i & 31);",
     "x[i] = __shfl_sync(~0u, inner[i >> 5], (i + 1) & 31);", "kernel_lattice"),
    ("viterbi_shuffle_off_by_one_state", LAT, "forward_sources<NS>(score[0], src0, S, ltc, v);",
     "forward_sources<NS>(score[0], src0 + 1, S, ltc, v);", "kernel_lattice"),
    ("viterbi_wide_shuffle_off_by_one_state", LAT, "x[i] = __shfl_sync(~0u, score[i >> 5], i & 31);",
     "x[i] = __shfl_sync(~0u, score[i >> 5], (i + 1) & 31);", "kernel_lattice"),
    ("backward_last_tile_store_short", LAT, "t_lo, t_hi - t_lo, S, p.B, b0, U, p.vec, i, count);",
     "t_lo, t_hi - t_lo - (k == n_tiles - 1), S, p.B, b0, U, p.vec, i, count);", "kernel_lattice"),
    ("viterbi_last_tile_store_short", LAT, "k * TT, min(TT, T - k * TT), T, S, p.B, b0, U, Q, p.vec, i,",
     "k * TT, min(TT, T - k * TT) - (k == n_tiles - 1), T, S, p.B, b0, U, Q, p.vec, i,", "kernel_lattice"),
    ("viterbi_pointer_past_length", LAT, "bpt[u * Q + tt * S + j[r]] = step ? arg[r] : j[r];",
     "bpt[u * Q + tt * S + j[r]] = (t >= 1) ? arg[r] : j[r];", "kernel_lattice"),
    ("backward_init_row_at_length", LAT, "beta[r] = (t + 1 < len) ? next[r] : init[r];",
     "beta[r] = (t < len) ? next[r] : init[r];", "kernel_lattice"),
    ("viterbi_wide_tie_to_highest", LAT, "if (c > best) {", "if (c >= best) {", "kernel_lattice"),
]
MUTANTS += [
    # full covariance past D = 16
    ("full_moment_column_off_by_one_d", TILE, "    return {2, r - d * D, d};",
     "    return {2, r - d * D, d + 1 < D ? d + 1 : d};", "kernel_em_wide"),
    ("composed_full_record_stride_one_row_short", WIDE, "    const float* src = rec + (size_t)g * stride;",
     "    const float* src = rec + (size_t)g * (stride - h);", "kernel_composed_wide"),
]
MUTANTS += [
    # the group mode of the lattice forward and backward past 64 states: a
    # block's slice of the new row not written into its peers, the cluster
    # barrier a frame dropped, the online sum not rescaled where the running
    # max rises, a group's shorter utterance stepped past its length
    ("group_peer_slice_not_written", LAT, "for (int r = 0; r < C; ++r) *cluster.map_shared_rank(dst, r) = xv;",
     "*dst = xv;", "kernel_lattice_wide"),
    ("group_cluster_barrier_dropped", LAT, "      cluster.sync();  // the new row is in every block; the old one is read\n",
     "", "kernel_lattice_wide"),
    ("group_online_sum_not_rescaled", LAT, "                  acc[uu][c] *= fast_exp2((m[uu][c] - mx) * kLog2e);\n", "",
     "kernel_lattice_wide"),
    ("group_steps_past_length", LAT, "v = t < len ? fmaxf(ms.x + logf(ms.y) + lb, kNegInf) : carry[i * NT + tid];",
     "v = fmaxf(ms.x + logf(ms.y) + lb, kNegInf);", "kernel_lattice_wide"),
]
MUTANTS += [
    # the z-GEMM blocks of the bank kernels at full covariance past D = 16
    ("wide_mirror_copies_neighbouring_column", COMP,
     "        o[D + ib * D + ia] = v;  // the mirror",
     "        o[D + ib * D + ia] = o[D + ib * D + ia - 1];  // the mirror", "kernel_composed_wide"),
    ("wide_square_sum_drops_one_lane", WIDE, "    s += __shfl_sync(~0u, part, team + 3);\n", "",
     "kernel_composed_wide"),
    ("wide_n_tile_padding_mixture_enters_lse", COMP, "        for (int gg = 0; gg < n; ++gg) {",
     "        for (int gg = 0; gg < kWideSlice; ++gg) {", "kernel_composed_wide"),
    ("wide_slice_read_before_its_wait", COMP,
     "wide_q<RB>(xs + fg * 32 * P, slices + (i & 1) * G * MF + gw * MF, d4);",
     "wide_q<RB>(xs + fg * 32 * P, slices + ((i + 1) & 1) * G * MF + gw * MF, d4);",
     "kernel_composed_wide"),
    ("wide_3xtf32_drops_lo_hi", WIDE, "        mma_tf32(acc[u], alo, b0h, b1h);\n", "", "kernel_composed_wide"),
]
MUTANTS += [
    # the E-step's z-GEMM blocks at full covariance past D = 16
    ("em_wide_triangle_skip_drops_diagonal_group", WIDE, "      if (i > kk) break;", "      if (i >= kk) break;",
     "kernel_em_wide"),
    ("em_wide_slice_read_before_its_wait", FEM,
     "wide_q<RB>(xs + fg * 32 * P, slices + (i & 1) * G * MF + gw * MF, (p.dims[cur.q] + 3) / 4);",
     "wide_q<RB>(xs + fg * 32 * P, slices + ((i + 1) & 1) * G * MF + gw * MF, (p.dims[cur.q] + 3) / 4);",
     "kernel_em_wide"),
    ("em_wide_state_closes_a_mixture_early", FEM,
     "      if ((mi + 1) % M == 0) {  // the state's last mixture: its kept rows' weights",
     "      if ((mi + 2) % M == 0) {  // the state's last mixture: its kept rows' weights", "kernel_em_wide"),
    ("em_wide_mirror_copies_neighbouring_column", FEM,
     "        o[D + ib * D + ia] = v;  // the mirror (the same column where ia == ib)",
     "        o[D + ib * D + ia] = o[D + ib * D + ia - 1];  // the mirror", "kernel_em_wide"),
    ("em_wide_stored_q_in_the_next_state_row", FEM,
     "qout[((size_t)t * S * M + (mi % M) * S + mi / M) * p.B + b]",
     "qout[((size_t)t * S * M + (mi % M) * S + (mi / M + 1) % S) * p.B + b]", "kernel_em_wide"),
    ("em_wide_3xtf32_drops_lo_hi", WIDE, "        mma_tf32(acc[u], alo, b0h, b1h);\n", "", "kernel_em_wide"),
    ("em_wide_scan_drops_last_state_of_group", FEM,
     "        for (int j = 0; j < n_states; ++j) kept |= gm[(size_t)j * p.B] != 0.f;",
     "        for (int j = 0; j + 1 < n_states; ++j) kept |= gm[(size_t)j * p.B] != 0.f;", "kernel_em_wide"),
]
MUTANTS += [
    # the group mode's Viterbi past 64 states: a tie across the source shares
    # of a tile kept for the higher source, a block's slice of the new row
    # not written into its peers (the Viterbi's alone), a backpointer past a
    # member's length not the identity, a state not yet reachable taking the
    # best of its range alone (the packed route)
    ("viterbi_group_tie_across_shares_to_higher", LAT, "if (c > best || (c == best && a < arg)) {",
     "if (c > best || (c == best && a > arg)) {", "kernel_lattice_wide"),
    ("viterbi_group_peer_slice_not_written", LAT,
     "for (int r = 0; r < C; ++r) *cluster.map_shared_rank(dst, r) = xv;",
     "for (int r = 0; r < C; ++r) *cluster.map_shared_rank(dst, KIND == kViterbiKind ? rank : r) = xv;",
     "kernel_lattice_wide"),
    ("viterbi_group_pointer_past_length", LAT, "bp = t < len ? arg : k;", "bp = arg;", "kernel_lattice_wide"),
    ("viterbi_group_unreachable_takes_range", LAT, "  if (n > 0 && best > kNegInf) return best;",
     "  if (n > 0) return best;", "kernel_lattice_wide"),
]
WLB = "srhmm_tpu_torch/csrc/wide_log_b.cu"
KDEC, KCOM = "srhmm_tpu_torch/ops/kernels/decode.py", "srhmm_tpu_torch/ops/kernels/common.py"
MUTANTS += [
    # #1 and #6-#8 at full covariance past D = 16: the emission pass reading
    # the slice buffer being filled, a later stream's log b not added,
    # records whose padding is not zero, the scorer's copy warps staging a
    # tile into the slot the recursion reads, the decoder's later parts
    # writing their pointers over the first part's, a later chunk of frames
    # starting from no carry
    ("wide_pass_slice_read_before_its_wait", WLB,
     "wide_q<RB>(xs + fg * 32 * P, slices + (i & 1) * G * MF + gw * MF, (p.dims[cur.q] + 3) / 4);",
     "wide_q<RB>(xs + fg * 32 * P, slices + ((i + 1) & 1) * G * MF + gw * MF, (p.dims[cur.q] + 3) / 4);", "kernel"),
    ("wide_pass_later_stream_not_added", WLB, "*o = (prev.q == 0) ? v : *o + v;", "*o = (prev.q == 0) ? v : *o;",
     "kernel"),
    ("wide_records_padding_not_zero", KCOM, "rec = a.new_zeros((N, M, rb + 1, pitch))",
     "rec = a.new_ones((N, M, rb + 1, pitch))", "kernel"),
    ("vocab_wide_tile_copied_into_the_slot_being_read", VOC,
     "copy_tile(p, lbs + ((k + 1) & 1) * s_tile, t_lo, min(TT, T - t_lo), ub, w0, nw, e, n_em);",
     "copy_tile(p, lbs + (k & 1) * s_tile, t_lo, min(TT, T - t_lo), ub, w0, nw, e, n_em);", "kernel"),
    ("decode_wide_later_part_pointers_into_the_first", KDEC, "final[b_lo:].data_ptr(), bp[b_lo:].data_ptr(),",
     "final[b_lo:].data_ptr(), bp.data_ptr(),", "kernel_decode"),
    ("decode_wide_chunk_starts_without_the_carry", DEC,
     "    for (int i = tid; i < K * N; i += nt) carry[((t_first - 1) & 1) * K * N + i] = "
     "p.final_out[(size_t)b * K * N + i];\n", "", "kernel_decode"),
]
DRIVER = """
import sys, torch
import chip_smoke as cs
cs.phase_device(torch); cs.phase_build()
try:
    getattr(cs, "phase_" + sys.argv[1])(torch)
    print("MUTANT SURVIVED")
except AssertionError as e:
    print("MUTANT CAUGHT:", str(e)[:300])
"""


def main(names) -> None:
    only = set(names)
    for name, src, old, new, phase in MUTANTS:
        if only and name not in only:
            continue
        d = Path(tempfile.mkdtemp(prefix=f"mut_{name}_")) / "tree"
        shutil.copytree(ROOT, d, ignore=shutil.ignore_patterns(".git", "build", "scratch", "chiprun_out", "__pycache__"))
        f = d / src
        text = f.read_text()
        assert text.count(old) >= 1, name
        f.write_text(text.replace(old, new))
        r = subprocess.run([sys.executable, "-c", DRIVER, phase], cwd=d, capture_output=True, text=True, timeout=600)
        last = [l for l in r.stdout.splitlines() if l.startswith("MUTANT")]
        rows = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
        mom = [v for row in rows for k, v in row.items() if k.startswith("mom") and isinstance(v, float)]
        print(json.dumps({"mutant": name, "phase": phase, "rc": r.returncode,
                          "result": last[-1] if last else r.stderr[-600:],
                          "max_mom_rel_err": max(mom, default=None)}), flush=True)
        shutil.rmtree(d.parent, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
