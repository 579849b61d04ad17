"""Variants of csrc/lattice.cu's group mode timed on a CUDA card (not a
tier-1 test; needs nvcc):

    python tests/torch_lattice_group_variants.py [variant ...] [clusters]

Each variant is csrc/lattice.cu with one text replacement, built alone by
nvcc into its own library and loaded in place of the package's for the
lattice wrappers.  Each is timed (CUDA events, median of 3 after a warm-up)
on forward_lattice and viterbi_batch at lattice_s1024 (S = 1024 dense, B =
64 of 102-512 frames) and align_s96 (S = 96, band 1, B = 2048 of 102-512
frames), log b drawn from a seed; "base" also on the backward and the last row, and at
"forced" shapes beside the rule's (lattice_s1024 with groups of 8 over
clusters of 16: 8 clusters, one more than the card runs at once).  The
variants: base (the source as it is), cycles (clock64 counters of threads
0 and NT - 1 of block 0 a phase: the tile loop and its waits, the partials
or the log b wait, the owners, the frame's barrier; printed by the
kernel), no_exp (the streamed route's ex2 replaced by its argument),
no_tiles (the transition tiles not copied), no_push (the new row written
into the block's own shared memory only), no_bptr (the Viterbi's
backpointers not stored in the recursion's frames).  The timings of no_exp,
no_tiles, no_push and no_bptr are of wrong results: they show what a part
costs.
`clusters` prints cudaOccupancyMaxActiveClusters
(srhmm_lattice_group_clusters) for clusters of 1-16 blocks at
lattice_s1024's and align_s96's shapes.  Every line is JSON, with the
card's name, power limit and SM clock.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from torch_port_utils import log_trans_np  # noqa: E402

SRC = ROOT / "srhmm_tpu_torch/csrc/lattice.cu"
CYCLES = [
    ("#include <cooperative_groups.h>\n", "#include <cooperative_groups.h>\n#include <cstdio>\n"),
    ("  for (int s = 0; s < n_steps; ++s) {\n    issue_lb(s + kGroupRing - 1);",
     "  long long cyA = 0, cyB = 0, cyC = 0, cyD = 0, cyW = 0;\n  for (int s = 0; s < n_steps; ++s) {\n"
     "    long long t0 = clock64();\n    issue_lb(s + kGroupRing - 1);"),
    ("        if (j + 1 < n_tiles) {\n          cp_async_wait<kGroupStages - 2>();",
     "        long long tw = clock64();\n        if (j + 1 < n_tiles) {\n          cp_async_wait<kGroupStages - 2>();"),
    ("        __syncthreads();  // tile j is in for every thread; tile j - 1's slot is free\n",
     "        __syncthreads();  // tile j is in for every thread; tile j - 1's slot is free\n        cyW += clock64() - tw;\n"),
    ("      if (unit) {\n#pragma unroll\n        for (int uu = 0; uu < UT; ++uu)\n#pragma unroll\n          for (int c = 0; c < 4; ++c) {\n"
     "            const int u = ut * UT + uu, kk = 4 * kg + c;",
     "      cyA += clock64() - t0; t0 = clock64();\n      if (unit) {\n#pragma unroll\n        for (int uu = 0; uu < UT; ++uu)\n"
     "#pragma unroll\n          for (int c = 0; c < 4; ++c) {\n            const int u = ut * UT + uu, kk = 4 * kg + c;"),
    ("      cp_async_wait<kGroupRing - 1>();  // this thread's log b of step s\n    }\n",
     "      cp_async_wait<kGroupRing - 1>();  // this thread's log b of step s\n    }\n    cyB += clock64() - t0; t0 = clock64();\n"),
    ("    if (C == 1) {\n      __syncthreads();  // one block",
     "    cyC += clock64() - t0; t0 = clock64();\n    if (C == 1) {\n      __syncthreads();  // one block"),
    ("      cluster.sync();  // the new row is in every block; the old one is read\n    }\n  }\n",
     "      cluster.sync();  // the new row is in every block; the old one is read\n    }\n    cyD += clock64() - t0;\n  }\n"
     "  if (blockIdx.x == 0 && (tid == 0 || tid == NT - 1))\n"
     "    printf(\"{\\\"cycles_tid\\\": %d, \\\"steps\\\": %d, \\\"packed\\\": %d, \\\"tiles\\\": %lld, \\\"tile_waits\\\": %lld, "
     "\\\"partials_or_log_b_wait\\\": %lld, \\\"owners\\\": %lld, \\\"barrier\\\": %lld}\\n\", tid, n_steps, (int)packed, "
     "cyA, cyW, cyB, cyC, cyD);\n"),
]
VARIANTS = {
    "base": [],
    "cycles": CYCLES,
    "no_exp": [("                sum += fast_exp2(fmaf(xs[uu][q] + lane4(a[q], c), kLog2e, -mref));",
                "                sum += fmaf(xs[uu][q] + lane4(a[q], c), kLog2e, -mref);")],
    "no_tiles": [("  auto issue_tile = [&](int j) {\n", "  auto issue_tile = [&](int j) {\n    cp_async_commit();\n    return;\n")],
    "no_push": [("for (int r = 0; r < C; ++r) *cluster.map_shared_rank(dst, r) = xv;", "*dst = xv;")],
    "no_bptr": [("      if (KIND == kViterbiKind && b < B) p.bptr[((size_t)b * T + t) * S + k] = bp;\n", "")],
}


def build(name: str, work: Path):
    """(name, library path or None, nvcc's errors) of one variant."""
    text = SRC.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            return name, None, f"the variant's text is not in {SRC.name} once"
        text = text.replace(old, new)
    src = SRC.parent / f"_variant_{name}.cu"  # beside the source: its includes resolve
    src.write_text(text)
    lib = work / f"lib_{name}.so"
    try:
        r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                            "-Xcompiler", "-fPIC", "-shared", "-o", str(lib), str(src)], capture_output=True, text=True)
    finally:
        src.unlink()
    return name, lib if r.returncode == 0 else None, r.stderr[-2000:]


def load(lib: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(lib))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    dll.srhmm_lattice_group.restype = c_int
    dll.srhmm_lattice_group.argtypes = [c_int, c_ptr, c_ptr, c_int, c_ptr, c_ptr] + [c_int] * 11 + [c_ptr]
    dll.srhmm_lattice_group_clusters.restype = c_int
    dll.srhmm_lattice_group_clusters.argtypes = [c_int] * 10 + [c_ptr]
    dll.srhmm_viterbi.restype = c_int
    dll.srhmm_viterbi.argtypes = [c_ptr] * 5 + [c_int] * 13 + [c_ptr]
    return dll


def median_ms(fn, warm=1, reps=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cells() -> list:
    out = []
    for S, B, T, kind in ((1024, 64, 512, "dense"), (96, 2048, 512, "delta1")):
        rng = np.random.default_rng(S)
        lt = torch.as_tensor(log_trans_np(S, kind, seed=S), device="cuda")
        lens = torch.as_tensor([int(n) for n in rng.integers(T // 5, T, size=B - 1)] + [T], dtype=torch.int32,
                               device="cuda")
        lb_bts = torch.as_tensor((rng.normal(size=(B, T, S)) * 2).astype(np.float32), device="cuda")
        out.append((S, B, lb_bts, lb_bts.permute(1, 2, 0).contiguous(), lt, lens))
    return out


def clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main(args) -> None:
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    names = [a for a in args if a in VARIANTS] or ["base"]
    work = Path(tempfile.mkdtemp(prefix="lattice_variants_"))
    with ThreadPoolExecutor(8) as ex:
        built = list(ex.map(lambda n: build(n, work), names))
    libs = {}
    for name, lib, err in built:
        print(json.dumps({"variant": name, "built": lib is not None, "errors": "" if lib else err}), flush=True)
        if lib:
            libs[name] = load(lib)
    rule = kl.group_block
    if "clusters" in args and libs:
        dll = next(iter(libs.values()))
        for S, B in ((1024, 64), (96, 2048)):
            for C in kl.GROUP_CLUSTERS:
                G = max(1, -(-B // (132 // C)))
                sh = None
                while sh is None and G >= 1:
                    sh = kl.group_shape(S, G, C)
                    G -= 1
                if sh is None:
                    continue
                n = ctypes.c_int(-1)
                err = dll.srhmm_lattice_group_clusters(0, S, B, sh["utts"], C, sh["threads"], sh["splits"], sh["share"],
                                                       sh["lt_cap"], 0, ctypes.byref(n))
                print(json.dumps({"S": S, "B": B, "cluster": C, "utts": sh["utts"], "threads": sh["threads"],
                                  "smem_bytes": sh["smem_bytes"], "error": err, "clusters_at_once": n.value}),
                      flush=True)
    for name, dll in libs.items():
        kl.kernel_library = lambda dll=dll: dll
        for S, B, lb_bts, lb_tsb, lt, lens in cells():
            forced = [None] + ([(8, 16)] if name == "base" and S == 1024 else [])
            for shape in forced:
                sh = rule(S, B) if shape is None else {**kl.group_shape(S, *shape), "mode": "group"}
                kl.group_block = lambda *a, sh=sh, **k: sh
                try:
                    row = {"variant": name, "S": S, "B": B, "forced": shape,
                           "shape": {k: sh[k] for k in ("utts", "cluster", "threads", "splits", "share")}}
                    if name == "cycles":
                        kl.forward_lattice(lb_tsb, lt, lens)
                        torch.cuda.synchronize()
                    else:
                        row["forward_ms"] = median_ms(lambda: kl.forward_lattice(lb_tsb, lt, lens))
                        row["viterbi_ms"] = median_ms(lambda: kf.viterbi_batch(lb_bts, lt, lens))
                        if name == "base" and shape is None:
                            row["backward_ms"] = median_ms(lambda: kl.backward_lattice(lb_tsb, lt, lens))
                            row["last_row_ms"] = median_ms(lambda: kf.log_forward_batch(lb_bts, lt, lens))
                    row["card"] = clock()
                finally:
                    kl.group_block = rule
                print(json.dumps(row), flush=True)
            del lb_bts, lb_tsb


if __name__ == "__main__":
    main(sys.argv[1:])
