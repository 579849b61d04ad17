"""Mutation check of the multi-rank CPU tests of srhmm_tpu_torch/parallel:
each mutant is a broken copy of the tree in a temporary directory, and at
least one test of the named files must fail for it.

    JAX_PLATFORMS=cpu python tests/torch_parallel_mutants.py [NAME ...]

One line a mutant: its name, pytest's exit code and summary, the failing
tests.  Exit 1 if a mutant survives.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MESH = ["tests/test_torch_parallel_mesh.py"]
SEQUENCE = ["tests/test_torch_sequence_parallel.py"]
MUTANTS = {  # name: (file, original, broken, tests that must catch it)
    "e_step_skips_all_reduce": (
        "srhmm_tpu_torch/parallel/mesh.py",
        "    if group is None:\n        return stats\n    leaves = _leaves(stats)",
        "    if True:\n        return stats\n    leaves = _leaves(stats)",
        MESH),
    "shard_batch_off_by_one_row": (
        "srhmm_tpu_torch/parallel/mesh.py",
        "    return t[i * b : (i + 1) * b].to(mesh.device)",
        "    return t[i * b : (i + 1) * b - 1].to(mesh.device)",
        MESH),
    "time_xi_without_boundary_term": (
        "srhmm_tpu_torch/parallel/sequence.py",
        "    nxt = firsts[idx + 1] if idx + 1 < n else torch.zeros_like(fwd_in[:, 0])",
        "    nxt = torch.full_like(fwd_in[:, 0], -torch.inf)",
        SEQUENCE),
    "mixture_logsumexp_local_max": (
        "srhmm_tpu_torch/ops/emission.py",
        '    m = all_reduce(lg.amax(dim=-1), group, "max")',
        "    m = lg.amax(dim=-1)",
        MESH),
    "tree_statistics_rank_local": (
        "srhmm_tpu_torch/pipeline.py",
        "pad_multiple,\n                                 mesh, DATA_AXIS)",
        "pad_multiple,\n                                 None, DATA_AXIS)",
        ["tests/test_torch_pipeline.py::test_tree_cluster_on_a_mesh_reads_all_reduced_statistics"]),
}


def run(name: str, root: Path) -> bool:
    """True when the mutant is caught."""
    path, old, new, tests = MUTANTS[name]
    tree = root / name
    shutil.copytree(REPO, tree, ignore=shutil.ignore_patterns(".git", "build", "chiprun_out", "scratch",
                                                               "__pycache__"))
    f = tree / path
    src = f.read_text()
    if src.count(old) != 1:
        raise SystemExit(f"{name}: the original text is not in {path} exactly once")
    f.write_text(src.replace(old, new))
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", *tests], cwd=tree,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True, timeout=1200)
    summary = [line for line in r.stdout.splitlines() if " passed" in line or " failed" in line][-1:]
    failing = [line.split(" ")[1] for line in r.stdout.splitlines() if line.startswith(("FAILED", "ERROR"))]
    print(f"{name}: exit {r.returncode} {summary} failing {failing}", flush=True)
    return r.returncode != 0 and bool(failing)


if __name__ == "__main__":
    names = sys.argv[1:] or list(MUTANTS)
    with tempfile.TemporaryDirectory(prefix="parallel_mutants_") as d:
        survived = [n for n in names if not run(n, Path(d))]
    if survived:
        print(f"survived: {survived}")
        sys.exit(1)
