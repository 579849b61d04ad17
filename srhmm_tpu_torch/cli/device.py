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
