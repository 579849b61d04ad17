"""Mutation check of csrc/lattice.cu, csrc/emission_em.cu, csrc/composed.cu,
csrc/fused_em.cu, csrc/tile_mma.cuh, csrc/word_loop_decode.cu and
csrc/mfcc.cu
(needs a CUDA card and nvcc; not a tier-1 test):

    python tests/torch_kernel_mutants.py [mutant ...]

Each mutant is a copy of the tree in a temporary directory with one
deliberate fault in a kernel source; the chip_smoke.py phase that should
catch it (kernel_lattice, kernel_emission, kernel_composed, kernel_em,
kernel_decode or kernel_mfcc) runs there, after the build.
Prints one JSON line per mutant: caught (the phase raised) or survived.
With no arguments every mutant runs.
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
MUTANTS = [
    ("forward_length_mask", LAT, "    } else if (t < len) {\n      const float* prev = row + ((t + 1) & 1) * nt + q.base;\n      float m",
     "    } else if (t <= len) {\n      const float* prev = row + ((t + 1) & 1) * nt + q.base;\n      float m", "kernel_lattice"),
    ("backward_stepping_rule", LAT, "if (t + 1 < len) {", "if (t < len) {", "kernel_lattice"),
    ("viterbi_tie_to_highest", LAT, "if (c > best) {", "if (c >= best) {", "kernel_lattice"),
    ("per_row_shared_matrix", LAT, "p.lt[(size_t)b0 * SS + i]", "p.lt[(size_t)b0 * SS + i % SS]", "kernel_lattice"),
    ("forward_no_carry_clamp", LAT, "carry = fmaxf(m + logf(e) + lb, kNegInf);", "carry = m + logf(e) + lb;", "kernel_lattice"),
    ("emission_drops_last_mixture", EM, "diag_state_log_b<DMAX>(rec_sh + s * M * stride, M, x, x2)",
     "diag_state_log_b<DMAX>(rec_sh + s * M * stride, M - (M > 1), x, x2)", "kernel_emission"),
    ("stats_chunk_drops_last_frame", EM, "const int nf = (int)min((long long)kFrames, n1 - c0);",
     "const int nf = (int)min((long long)kFrames, n1 - c0) - 1;", "kernel_emission"),
    ("stats_sum_skips_last_range", EM, "for (int r = 0; r < ranges; ++r)", "for (int r = 0; r + 1 < ranges; ++r)", "kernel_emission"),
    ("stats_ignores_neg_inf_log_b", EM, "(on && lb > kNegInf) ? p.gamma", "(on) ? p.gamma", "kernel_emission"),
    ("moments_vote_skips_single_frame_tile", COMP, "__any_sync(~0u, gv[v] != 0.f)",
     "(__popc(__ballot_sync(~0u, gv[v] != 0.f)) > 1)", "kernel_composed"),
    ("moments_3xtf32_drops_lo_hi", TILE, "        mma_tf32(c[hh], alo, b0h, b1h);\n", "", "kernel_composed"),
    ("emission_groups_floor", COMP, "int groups_of(int D) { return (D + 3) / 4; }",
     "int groups_of(int D) { return D / 4; }", "kernel_composed"),
    ("sum_chunks_skips_last_partial", COMP, "g < m.chunk_cum[r + 1]; ++g)", "g + 1 < m.chunk_cum[r + 1]; ++g)",
     "kernel_composed"),
    ("emission_ring_reads_previous_row", COMP, "ring + (size_t)(j % nbuf) * p.rec_floats;",
     "ring + (size_t)((j + nbuf - 1) % nbuf) * p.rec_floats;", "kernel_composed"),
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
    ("emit_staging_reads_previous_tile", FEM, "      const float* f = xs + (k & 1) * x_tile;\n      float* lbt",
     "      const float* f = xs + ((k + 1) & 1) * x_tile;\n      float* lbt", "kernel_em"),
    ("emit_off_chain_term_sums_one", FEM, "        for (int kk = 0; kk < NSL; ++kk) e += expf(v[kk] - m);",
     "        for (int kk = 0; kk < NSL; ++kk) e += (v[kk] == -INFINITY) ? 1.f : expf(v[kk] - m);", "kernel_em"),
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
        print(json.dumps({"mutant": name, "phase": phase, "rc": r.returncode,
                          "result": last[-1] if last else r.stderr[-600:]}), flush=True)
        shutil.rmtree(d.parent, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
