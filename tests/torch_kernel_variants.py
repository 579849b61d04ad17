"""Where the time of the backward-statistics kernels goes, by ablation (needs
a CUDA card and nvcc; not a tier-1 test):

    python tests/torch_kernel_variants.py [variant ...]

Each variant is a copy of the tree in a temporary directory with parts of
csrc/composed.cu's composed_backward_stats_kernel or csrc/fused_em.cu's
backward_stats_kernel cut out (its results are then wrong: only the time
is read); `python tests/torch_backward_compare.py time` runs there after
the build.  Prints one JSON line per variant with the three kernel times
(composed_backward_stats at emb_c4 / tied_c5 lattice shapes, backward_stats
at em_diag's).  With no arguments every variant runs, "base" (no cut)
first and last.
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
COMP_PY, FEM_PY = "srhmm_tpu_torch/ops/kernels/composed.py", "srhmm_tpu_torch/ops/kernels/fused_em.py"
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
    ("em_4_utterances", FEM_PY, "BACKWARD_UTTS = 8 ", "BACKWARD_UTTS = 4 "),
    ("em_16_utterances", FEM_PY, "BACKWARD_UTTS = 8 ", "BACKWARD_UTTS = 16 "),
    ("em_320_threads", FEM_PY, "warps = max(2, (_MAX_THREADS - n_rec) // 32)", "warps = max(2, (320 - n_rec) // 32)"),
    ("em_4_utterances_320_threads", FEM_PY, ("BACKWARD_UTTS = 8 ", "warps = max(2, (_MAX_THREADS - n_rec) // 32)"),
     ("BACKWARD_UTTS = 4 ", "warps = max(2, (320 - n_rec) // 32)")),
    ("em_16_utterances_512_threads", (FEM_PY, FEM_PY, FEM),
     ("BACKWARD_UTTS = 8 ", "warps = max(2, (_MAX_THREADS - n_rec) // 32)", "kMaxBackwardThreads = 320;"),
     ("BACKWARD_UTTS = 16 ", "warps = max(2, (512 - n_rec) // 32)", "kMaxBackwardThreads = 512;")),
    ("composed_2_utterances", COMP_PY, "    U = max(1, _BACKWARD_WARPS // W)", "    U = max(1, 2 // W)"),
    ("composed_8_frame_tiles", COMP_PY, "BACKWARD_TILES = (16, 8, 4, 2, 1)", "BACKWARD_TILES = (8, 4, 2, 1)"),
    ("em_no_contraction", FEM, "        contract_3xtf32<FULL>(acc + (size_t)S * p.mom_offs[q]",
     "        if (false) contract_3xtf32<FULL>(acc + (size_t)S * p.mom_offs[q]"),
]


def main(names) -> None:
    chosen = [v for v in VARIANTS if not names or v[0] in names]
    if not names:
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
                assert text.count(o) == 1, name
                f.write_text(text.replace(o, n))
        r = subprocess.run([sys.executable, "tests/torch_backward_compare.py", "time"], cwd=d, capture_output=True,
                           text=True, timeout=900, env={**os.environ, "PYTHONPATH": str(d)})
        lines = [l for l in r.stdout.splitlines() if l.startswith("{")]
        out = json.loads(lines[-1]) if lines else {"error": r.stderr[-600:]}
        kinds = {}
        for line in r.stdout.splitlines():
            if line.startswith("CYC"):
                kinds.setdefault(" ".join(line.split()[:3]), []).append(line)
        cycles = [line for lines in kinds.values() for line in lines[-4:]]
        print(json.dumps({"variant": name, **out, **({"cycles": cycles} if cycles else {})}), flush=True)
        shutil.rmtree(d.parent, ignore_errors=True)


if __name__ == "__main__":
    main(sys.argv[1:])
