"""List-file readers.

The reference reads all of its list files (training lists, model lists,
vocabulary/test transcripts) with `fscanf(f, "%s", ...)` — i.e. as
whitespace-separated tokens, not lines (e.g.
reference repository test/source/recognition-fs/recognition_continuous_fs.c:213,283,333).
We replicate that tokenization so fixtures parse identically.
"""

from __future__ import annotations

from pathlib import Path


def read_list(path: str | Path) -> list[str]:
    """Return whitespace-separated tokens of a list file, in order."""
    return Path(path).read_text().split()


def write_list(path: str | Path, items: list[str]) -> None:
    Path(path).write_text("\n".join(items) + "\n")
