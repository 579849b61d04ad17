"""Padded utterance batching (counterpart of ``srhmm_tpu/io/dataset.py``).

A list of utterances becomes one padded (B, T_max, D) tensor with a lengths
vector; every downstream op is masked by ``lengths`` so padding contributes
nothing.  T_max is rounded up to ``pad_multiple`` so shapes repeat.

A list file is read by the native C++ worker-pool loader
(io/native_loader.py, native/loader.cpp) when it can be built, or by the
Python ``.perfil`` reader; both give the same bits.
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
    native: bool | None = None,
) -> UtteranceBatch:
    """Read every .perfil in a list file into one padded batch.

    List entries resolve against ``relative_to`` (default: the current
    directory).  native=None (default) uses the C++ worker-pool loader when
    it can be built (one pass to scan headers, one threaded pass straight
    into the padded array) and the Python reader otherwise; native=True
    uses the C++ loader or raises (NativeLoaderUnavailable when it cannot
    be built, IOError when a file cannot be scanned); native=False uses the
    Python reader.  Every route gives the same bits.
    """
    from .lists import read_list

    base = Path(relative_to) if relative_to is not None else Path(".")
    paths = [str(base / p) for p in read_list(list_path)]
    if not paths:
        raise ValueError("empty utterance list")

    if native is None or native:
        from .native_loader import load_batch_native, native_available, scan_perfil

        if native or native_available():
            shapes = scan_perfil(paths)
            if (shapes[:, 0] > 0).all():
                dims = set(int(d) for d in shapes[:, 1])
                if len(dims) != 1:
                    raise ValueError(f"{list_path}: mixed feature dims {dims}")
                dim = dims.pop()
                t_max = round_up(int(shapes[:, 0].max()), pad_multiple)
                # the Python route reads float64 and casts once: so does this
                np_dtype = np.float32 if dtype == torch.float32 else np.float64
                feats, lengths = load_batch_native(paths, t_max, dim, dtype=np_dtype)
                if pad_batch_to is not None and len(paths) < pad_batch_to:
                    extra = pad_batch_to - len(paths)
                    feats = np.concatenate([feats, np.zeros((extra, t_max, dim), feats.dtype)], 0)
                    lengths = np.concatenate([lengths, np.zeros((extra,), lengths.dtype)], 0)
                return UtteranceBatch(
                    features=torch.as_tensor(feats, dtype=dtype, device=device),
                    lengths=torch.as_tensor(lengths.astype(np.int32), device=device),
                )
            if native:
                raise IOError(f"{list_path}: native loader failed to scan inputs")

    from .perfil import read_perfil

    utts = [read_perfil(p) for p in paths]
    return pack_utterances(utts, pad_multiple, pad_batch_to, dtype, device)
