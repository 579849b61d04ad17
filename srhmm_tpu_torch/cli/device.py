"""The ``--device`` option of the CLIs: they run on the card unless the
caller asks for the CPU, and never fall back from one to the other."""

from __future__ import annotations

import argparse
import sys


def add_device_argument(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the computation runs (default cuda; no fallback to the CPU)",
    )


def resolve_device(name: str, prog: str):
    """The torch device for ``--device``, or None after printing why a
    CUDA device cannot be had (the caller then exits non-zero)."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        print(
            f"{prog}: --device cuda, but torch sees no CUDA device; pass --device cpu "
            "to run on the CPU",
            file=sys.stderr,
        )
        return None
    return torch.device(name)


def data_parallel_mesh(n: int, name: str, prog: str):
    """The (n, 1) data-parallel mesh of a run under a launcher of n ranks
    (``--data-parallel n``), each rank on its own device of kind `name`, or
    None after printing why not: the world of this run (WORLD_SIZE, which
    torchrun sets) must be n ranks."""
    import os

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n < 1 or world != n:
        print(
            f"{prog}: --data-parallel {n} needs a launcher of {n} ranks (WORLD_SIZE is {world}): "
            f"torchrun --standalone --nproc-per-node {n} -m srhmm_tpu_torch.cli.{prog} ... "
            f"--data-parallel {n}",
            file=sys.stderr,
        )
        return None
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh

    distributed.initialize(device=name)
    return make_mesh(n_data=n, n_model=1, device=name)
