"""Padded utterance batching (counterpart of ``srhmm_tpu/io/dataset.py``).

A list of utterances becomes one padded (B, T_max, D) tensor with a lengths
vector; every downstream op is masked by ``lengths`` so padding contributes
nothing.  T_max is rounded up to ``pad_multiple`` so shapes repeat.

Only the Python ``.perfil`` reader is ported; the threaded C++ loader of the
JAX package is not, and ``native=True`` raises instead of falling back.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch


@dataclass
class UtteranceBatch:
    """features: (B, T_max, D); lengths: (B,) int32, on the same device."""

    features: torch.Tensor
    lengths: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def max_frames(self) -> int:
        return self.features.shape[1]

    def mask(self) -> torch.Tensor:
        """(B, T_max) True on valid frames."""
        t = torch.arange(self.max_frames, device=self.lengths.device)[None, :]
        return t < self.lengths[:, None]

    def to(self, device) -> "UtteranceBatch":
        return UtteranceBatch(self.features.to(device), self.lengths.to(device))


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_utterances(
    utterances: list[np.ndarray],
    pad_multiple: int = 128,
    pad_batch_to: int | None = None,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> UtteranceBatch:
    """Pack variable-length utterances into a padded batch.

    Batch padding (pad_batch_to) adds zero-length dummy utterances.
    """
    if not utterances:
        raise ValueError("empty utterance list")
    D = utterances[0].shape[1]
    T = round_up(max(u.shape[0] for u in utterances), pad_multiple)
    B = len(utterances)
    if pad_batch_to is not None:
        B = max(B, pad_batch_to)
    feats = np.zeros((B, T, D), dtype=np.float64)
    lengths = np.zeros((B,), dtype=np.int32)
    for i, u in enumerate(utterances):
        feats[i, : u.shape[0]] = u
        lengths[i] = u.shape[0]
    return UtteranceBatch(
        features=torch.as_tensor(feats, dtype=dtype, device=device),
        lengths=torch.as_tensor(lengths, device=device),
    )


def load_batch(
    list_path: str | Path,
    relative_to: str | Path | None = None,
    pad_multiple: int = 128,
    pad_batch_to: int | None = None,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    native: bool = False,
) -> UtteranceBatch:
    """Read every .perfil in a list file into one padded batch.

    List entries resolve against ``relative_to`` (default: the current
    directory).  ``native=True`` asks for the C++ loader, which this package
    does not have yet: it raises NotImplementedError.
    """
    if native:
        raise NotImplementedError("srhmm_tpu_torch has no native .perfil loader yet")
    from .lists import read_list
    from .perfil import read_perfil

    base = Path(relative_to) if relative_to is not None else Path(".")
    utts = [read_perfil(str(base / p)) for p in read_list(list_path)]
    return pack_utterances(utts, pad_multiple, pad_batch_to, dtype, device)
