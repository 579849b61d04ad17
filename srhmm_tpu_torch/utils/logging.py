"""Structured logging (counterpart of ``srhmm_tpu/utils/logging.py``).

Replaces the reference's raw printf progress trace (T1:222-308) with
structured JSONL events, machine-readable and greppable: one JSON object a
line, ``{"t": seconds since the log opened, "event": name, ...fields}``."""

from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path


class EventLog:
    """JSONL event sink (stderr by default, optionally a file)."""

    def __init__(self, path: str | Path | None = None, echo: bool = True):
        self.path = Path(path) if path else None
        self.echo = echo
        self._fh = open(self.path, "a") if self.path else None
        self.t0 = time.perf_counter()

    def emit(self, event: str, **fields):
        rec = {"t": round(time.perf_counter() - self.t0, 4), "event": event}
        rec.update(fields)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)

    @contextmanager
    def span(self, name: str, **fields):
        """Emit `name` with the block's wall seconds when the block exits."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit(name, seconds=round(time.perf_counter() - t0, 6), **fields)

    def close(self):
        if self._fh:
            self._fh.close()


NULL_LOG = EventLog(echo=False)
