"""Profiling / tracing hooks (counterpart of ``srhmm_tpu/utils/profiling.py``).

The reference profiles with gprof (-pg in every Makefile) and coarse
times()-based counters.  The replacements:

* `trace(dir)`: a torch.profiler trace of the enclosed block (CPU
  activity, and CUDA activity when a card is available), exported as a
  Chrome trace into `dir` (chrome://tracing, Perfetto);
* `Throughput`: audio-seconds/s and frames/s counters;
* `timed`: block timer that waits for the card before it stops the clock,
  for honest device timing.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import torch


@contextmanager
def trace(log_dir: str | Path):
    """Trace the enclosed block with torch.profiler and export it as
    `log_dir/trace_<pid>_<ns>.json`.  Yields the profiler, whose
    ``key_averages()`` and ``events()`` stay readable after the block."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the block's queued device work joins the trace
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextmanager
def timed(result: dict, key: str = "seconds", sync: object = None):
    """Wall-time the block; if `sync` is a CUDA tensor, synchronize its
    device first so the work queued on it is included."""
    t0 = time.perf_counter()
    yield
    if isinstance(sync, torch.Tensor) and sync.is_cuda:
        torch.cuda.synchronize(sync.device)
    result[key] = time.perf_counter() - t0


class Throughput:
    """Audio-seconds/s, frames/s bookkeeping across steps."""

    def __init__(self, frame_shift_s: float = 0.01):
        self.frame_shift_s = frame_shift_s
        self.frames = 0
        self.seconds = 0.0

    def add(self, num_frames: int, seconds: float):
        self.frames += int(num_frames)
        self.seconds += seconds

    @property
    def frames_per_sec(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    @property
    def audio_seconds_per_sec(self) -> float:
        return self.frames_per_sec * self.frame_shift_s

    @property
    def rtf(self) -> float:
        """Real-time factor (processing time / audio time); lower is faster."""
        audio = self.frames * self.frame_shift_s
        return self.seconds / audio if audio else 0.0
