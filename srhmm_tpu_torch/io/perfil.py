"""`.perfil` feature-file codec.

Binary layout (little-endian), as consumed by the reference C programs
(`reading_coef_number` / `reading_coef`,
reference repository train/source/hmm-full-fs/hmm_continuous_full_fs.c:515-567):

    int32   coef_number
    float64 frame[coef_number]     repeated until EOF

A trailing partial frame (fewer than coef_number doubles before EOF) is
dropped, matching the C reader's `while (fread(...) != 0)` + short-read
semantics (a short read returns < coef_number and terminates the loop without
storing the frame).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_HEADER = struct.Struct("<i")


def read_perfil(path: str | Path) -> np.ndarray:
    """Read a .perfil file -> float64 array of shape (num_frames, coef_number)."""
    data = Path(path).read_bytes()
    if len(data) < _HEADER.size:
        raise ValueError(f"{path}: truncated .perfil (no header)")
    (coef_number,) = _HEADER.unpack_from(data, 0)
    if coef_number <= 0:
        raise ValueError(f"{path}: invalid coef_number {coef_number}")
    payload = len(data) - _HEADER.size
    frame_bytes = 8 * coef_number
    num_frames = payload // frame_bytes  # trailing partial frame dropped
    frames = np.frombuffer(
        data, dtype="<f8", count=num_frames * coef_number, offset=_HEADER.size
    )
    return frames.reshape(num_frames, coef_number).astype(np.float64)


def write_perfil(path: str | Path, frames: np.ndarray) -> None:
    """Write frames (T, D) float64 to a reference-compatible .perfil file."""
    frames = np.ascontiguousarray(frames, dtype="<f8")
    if frames.ndim != 2:
        raise ValueError(f"frames must be 2-D (T, D), got shape {frames.shape}")
    with open(path, "wb") as f:
        f.write(_HEADER.pack(frames.shape[1]))
        f.write(frames.tobytes())


def read_perfil_list(list_path: str | Path) -> list[np.ndarray]:
    """Read every .perfil named in a list file (one path per line).

    Relative paths are resolved the way the reference CLI does: against the
    current working directory, not against the list file.  Callers that want
    list-relative resolution should pre-resolve the lines themselves via
    :func:`srhmm_tpu_torch.io.lists.read_list`.
    """
    from .lists import read_list

    return [read_perfil(p) for p in read_list(list_path)]
