"""Transcript files of the embedded trainers (counterpart of
``srhmm_tpu/cli/train_embedded.py``).  Only ``read_transcripts`` is ported
so far: the forced-alignment CLI reads the same files.  Embedded and tied
training come with their own kernels."""

from __future__ import annotations

from pathlib import Path


def read_transcripts(path: str):
    """[(perfil_path, [unit names...])] from a transcript file: one
    utterance per line, ``path/to/features.perfil unit_a unit_b ...``;
    blank lines and lines starting with # are skipped."""
    items = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            raise ValueError(f"transcript line needs a path and units: {line!r}")
        items.append((parts[0], parts[1:]))
    return items
