"""The MFCC frontend as one kernel: waveforms -> MFCC frames.

Counterpart of ``srhmm_tpu/features/pallas_mfcc.py`` (TPU kernel #14).
A batch of waveforms travels as one float32 tensor of their samples laid
end to end and the host offsets of each waveform (``pack_waves``); the
result is one (sum F, n_mfcc) float32 tensor, waveform after waveform
(``split_frames`` cuts it back).  Per waveform the result is
``features.frontend.mfcc`` of that waveform: pre-emphasis, framing with
indices past the last sample clamped to it, the windowed DFT, power, mel
filterbank, log floor, DCT, and with ``include_energy`` the log frame
energy in column 0 (which the TPU kernel ignores).

* ``mfcc_fused`` launches the hand-written kernel ``csrc/mfcc.cu`` on a
  CUDA tensor (one launch for every waveform of the call) and counts one
  in ``mfcc_fused.launches``; on a CPU tensor it runs ``mfcc_plain``.
  A configuration outside the compiled bounds raises; nothing falls back.
* ``mfcc_plain`` is its twin: ``features.frontend.mfcc`` of each waveform
  in float32, the DFT as two dense products.
* ``fft_plan`` / ``fft_layout``: the kernel takes the DFT as a mixed-radix
  FFT; the plan (radices, strides) and its twiddles are built here in
  float64 and rounded once to float32 (``_constants``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...features.frontend import (
    FrontendConfig,
    _window,
    dct_matrix,
    mel_filterbank,
    mfcc,
)
from .common import SMEM_LIMIT

MAX_FRAME_LENGTH = 1024
MAX_MELS = 128
THREADS = 256  # csrc/mfcc.cu kThreads: threads of a block
FRAMES_PER_BLOCK = (16, 8, 4, 2, 1)  # frames a block holds, the largest within BLOCK_SMEM
BLOCK_SMEM = 56 * 1024  # bytes of shared memory a block aims at (four blocks an SM)
BUTTERFLIES = (8, 4, 2, 5, 3)  # radices csrc/mfcc.cu unrolls; any other prime is a generic stage
MAX_STAGES = 10  # csrc/mfcc.cu kMaxStages: a length up to 1024 has at most 10 prime factors
_WINDOWS = ("hamming", "hann", "rect")


def pack_waves(waves, device) -> tuple[torch.Tensor, np.ndarray]:
    """1-D numpy waveforms -> (float32 samples end to end on device, (n+1,)
    int64 host offsets), joined on the host and copied once."""
    if not len(waves):
        raise ValueError("pack_waves: no waveforms")
    joined = [np.asarray(w, np.float32).reshape(-1) for w in waves]
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in joined])]).astype(np.int64)
    return torch.as_tensor(np.concatenate(joined), device=device), offsets


def frame_offsets(offsets, cfg: FrontendConfig) -> np.ndarray:
    """(n+1,) int64 offsets of each waveform's first MFCC row (frame_count
    of each waveform, on the whole array at once)."""
    lens = np.diff(np.asarray(offsets, np.int64))
    counts = 1 + np.maximum(0, lens - cfg.frame_length) // cfg.frame_shift
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def split_frames(out, offsets, cfg: FrontendConfig) -> list:
    """(sum F, n_mfcc) -> one (F_i, n_mfcc) view per waveform."""
    fo = frame_offsets(offsets, cfg)
    return [out[fo[i] : fo[i + 1]] for i in range(len(fo) - 1)]


def _check_config(cfg: FrontendConfig) -> None:
    if cfg.window not in _WINDOWS:
        raise ValueError(f"mfcc_fused: window {cfg.window!r} is not one of {_WINDOWS}")
    if not 1 <= cfg.frame_length <= MAX_FRAME_LENGTH:
        raise ValueError(f"mfcc_fused: frame_length {cfg.frame_length} outside [1, {MAX_FRAME_LENGTH}]")
    if cfg.frame_shift < 1:
        raise ValueError(f"mfcc_fused: frame_shift {cfg.frame_shift} < 1")
    if not 1 <= cfg.n_mels <= MAX_MELS:
        raise ValueError(f"mfcc_fused: n_mels {cfg.n_mels} outside [1, {MAX_MELS}]")
    if not 1 <= cfg.n_mfcc <= cfg.n_mels:
        raise ValueError(f"mfcc_fused: n_mfcc {cfg.n_mfcc} outside [1, n_mels={cfg.n_mels}]")


def _check_waves(samples: torch.Tensor, offsets: np.ndarray) -> None:
    if samples.ndim != 1:
        raise ValueError("mfcc_fused: samples must be one 1-D tensor")
    if offsets.ndim != 1 or len(offsets) < 2 or offsets[0] != 0 or offsets[-1] != samples.shape[0]:
        raise ValueError("mfcc_fused: offsets must run from 0 to the number of samples")
    if (np.diff(offsets) < 1).any():
        raise ValueError("mfcc_fused: every waveform needs at least one sample")


def mfcc_plain(samples: torch.Tensor, offsets, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """The kernel's function in plain PyTorch: features.frontend.mfcc of
    each waveform in float32, rows concatenated -> (sum F, n_mfcc)."""
    offsets = np.asarray(offsets, np.int64)
    _check_waves(samples, offsets)
    x = samples.to(torch.float32)
    return torch.cat([mfcc(x[offsets[i] : offsets[i + 1]], cfg) for i in range(len(offsets) - 1)])


def fft_plan(W: int) -> tuple[int, bool, tuple[int, ...]]:
    """The FFT csrc/mfcc.cu runs on one W-sample frame: (N, split, radices).
    An even W is a W/2-point complex FFT of the sample pairs z[n] = x[2n] +
    i x[2n+1] followed by the real split step (split=True); an odd W a
    W-point complex FFT of the real frame.  radices: N's prime-power
    factors in stage order, 8s first, then a 4 or a 2, then 5s and 3s
    (unrolled butterflies), then the other primes ascending (generic
    stages; a prime N is one generic stage, a dense DFT of that length)."""
    N, split = (W // 2, True) if W % 2 == 0 else (W, False)
    radices, n = [], N
    while n % 8 == 0:
        radices.append(8)
        n //= 8
    for r in (4, 2):
        if n % r == 0:
            radices.append(r)
            n //= r
    for f in [5, 3] + list(range(7, n + 1, 2)):
        while n % f == 0:
            radices.append(f)
            n //= f
    return N, split, tuple(radices)


def fft_layout(W: int):
    """The plan's complex float64 table and where each part starts:
    (N, split, stages, table, split_off), stages a tuple of (radix R,
    stride p, offset) run in order (p is the product of the radices
    before).  Stockham stage (R, p) on N points: butterfly i < N / R with
    k = i mod p reads x[i + r N/R] (r < R), scales input r by
    exp(-2 pi i r k / (p R)) and writes its R-point DFT to y[(i - k) R + k
    + q p].  An unrolled stage's entries: the R roots exp(-2 pi i a / R),
    then the twiddles of input r >= 1 at (r - 1) p + k; a generic stage's:
    the p R roots exp(-2 pi i a / (p R)), input a of output (k + q p)
    taking root a (k + q p) mod p R.  Then the split step's N + 1 factors
    exp(-2 pi i k / W) at split_off (split only)."""
    N, split, radices = fft_plan(W)
    parts, stages, off, p = [], [], 0, 1
    for R in radices:
        if R in BUTTERFLIES:
            r, k = np.arange(1, R)[:, None], np.arange(p)[None, :]
            part = np.concatenate([np.exp(-2j * np.pi * np.arange(R) / R),
                                   np.exp(-2j * np.pi * r * k / (p * R)).reshape(-1)])
        else:
            part = np.exp(-2j * np.pi * np.arange(p * R) / (p * R))
        stages.append((R, p, off))
        parts.append(part)
        off += len(part)
        p *= R
    split_off = off
    if split:
        parts.append(np.exp(-2j * np.pi * np.arange(N + 1) / W))
    table = np.concatenate(parts) if parts else np.zeros(0, complex)
    return N, split, tuple(stages), table, split_off


def mel_ranges(cfg: FrontendConfig):
    """Each mel filter's nonzero bins of the float32 filterbank: ((n_mels,
    2) first bin and end bin, the weights of bins lo..hi-1 of every filter
    in filter order).  Outside its range a filter's weights are 0.0, and a
    product with 0.0 adds nothing to a sum of non-negative terms, so the
    kernel's sums over the ranges are its sums over every bin."""
    fb = mel_filterbank(cfg).astype(np.float32)
    ranges, weights = [], []
    for m in range(cfg.n_mels):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
        ranges.append((lo, hi))
        weights.append(fb[lo:hi, m])
    return np.asarray(ranges, np.int32).reshape(-1, 2), np.concatenate(weights)


@functools.lru_cache(maxsize=8)
def _constants(cfg: FrontendConfig, device: torch.device):
    """The kernel's constants on device: one float32 table (the FFT's
    complex factors as (re, im) pairs, the window, the mel weights, the
    DCT (n_mels, n_mfcc)), built in float64 and rounded once; the mel
    ranges (n_mels, 3) int32: first bin, end bin, float offset of the
    filter's weights in the table; and the offsets (in floats) of the
    stages, the split factors, the window, the mel weights (and their
    count) and the DCT."""
    _, _, stages, table, split_off = fft_layout(cfg.frame_length)
    ranges, weights = mel_ranges(cfg)
    win_off = 2 * len(table)
    mel_off = win_off + cfg.frame_length
    dct_off = mel_off + len(weights)
    floats = np.concatenate([np.stack([table.real, table.imag], -1).reshape(-1), _window(cfg),
                             weights.astype(np.float64), dct_matrix(cfg).reshape(-1)])
    starts = mel_off + np.concatenate([[0], np.cumsum(ranges[:, 1] - ranges[:, 0])[:-1]])
    rng = np.concatenate([ranges, starts[:, None]], 1).astype(np.int32)
    offsets = {"stages": tuple((R, p, 2 * o) for R, p, o in stages), "split": 2 * split_off,
               "window": win_off, "mel": mel_off, "weights": len(weights), "dct": dct_off}
    return (torch.as_tensor(floats, dtype=torch.float32, device=device).contiguous(),
            torch.as_tensor(rng, device=device).contiguous(), offsets)


@functools.lru_cache(maxsize=8)
def launch_shape(cfg: FrontendConfig) -> tuple[int, int, int]:
    """(threads, shared-memory bytes, frames) of one block: THREADS threads
    and the largest of FRAMES_PER_BLOCK whose block stays within BLOCK_SMEM
    (at least one frame); shared memory holds per frame two buffers of the
    FFT's N complex points (ping and pong of its stages; the power spectrum
    goes to the one the last stage did not write), the log-mel row and the
    energy, and once the filters' nonzero weights."""
    N = fft_plan(cfg.frame_length)[0]
    weights = 4 * len(mel_ranges(cfg)[1])
    per_frame = 4 * (4 * N + cfg.n_mels + 1)
    frames = next((f for f in FRAMES_PER_BLOCK if f * per_frame + weights <= BLOCK_SMEM), 1)
    return THREADS, frames * per_frame + weights, frames


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the MFCC launcher's C signature."""
    from .build import load_library

    lib = load_library()
    c_int, c_ll, c_ptr, c_float = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    p_int = ctypes.POINTER(c_int)
    lib.srhmm_mfcc.restype = c_int
    lib.srhmm_mfcc.argtypes = (
        [c_ptr, c_ptr, c_int, c_ll]  # samples, index, n_waves, n_tiles
        + [c_ptr] * 3  # table, mel ranges, out
        + [c_int] * 5  # W, shift, n_mels, n_mfcc, include_energy
        + [c_float, c_float]  # preemph, floor
        + [c_int, p_int, p_int, p_int] + [c_int] * 5  # stages, radices, strides, offsets; split, window, mel, weights, DCT
        + [c_int, c_int, c_int, c_int, c_ptr]  # frames a block, threads, smem, device, stream
    )
    return lib


def _mfcc_cuda(samples: torch.Tensor, offsets: np.ndarray, cfg: FrontendConfig) -> torch.Tensor:
    if samples.dtype != torch.float32:
        raise ValueError("mfcc_fused: the CUDA kernel takes float32 samples only")
    threads, smem, frames = launch_shape(cfg)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mfcc_fused: a block needs {smem} bytes of shared memory, above {SMEM_LIMIT}")
    dev = samples.device
    fo = frame_offsets(offsets, cfg)
    tiles = -(-np.diff(fo) // frames)
    to = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
    index = torch.as_tensor(np.stack([offsets, fo, to]), dtype=torch.int64).to(dev)
    table, ranges, off = _constants(cfg, dev)
    stages = off["stages"]
    ints = ctypes.c_int * max(1, len(stages))
    samples = samples.contiguous()
    out = torch.empty((int(fo[-1]), cfg.n_mfcc), dtype=torch.float32, device=dev)
    lib = _kernel_library()
    err = lib.srhmm_mfcc(
        samples.data_ptr(), index.data_ptr(), len(offsets) - 1, int(to[-1]),
        table.data_ptr(), ranges.data_ptr(), out.data_ptr(),
        cfg.frame_length, cfg.frame_shift, cfg.n_mels, cfg.n_mfcc, int(cfg.include_energy),
        float(cfg.preemphasis), float(cfg.log_floor),
        len(stages), ints(*(R for R, _, _ in stages)), ints(*(p for _, p, _ in stages)),
        ints(*(o for _, _, o in stages)), off["split"], off["window"], off["mel"], off["weights"], off["dct"],
        frames, threads, smem,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.srhmm_cuda_error_string(err).decode()
        raise RuntimeError(f"mfcc kernel launch failed: CUDA error {err} ({msg})")
    mfcc_fused.launches += 1
    return out


def mfcc_fused(samples: torch.Tensor, offsets, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Waveforms laid end to end (``pack_waves``) -> (sum F, n_mfcc)
    float32 MFCC rows, waveform after waveform.

    A CUDA tensor launches csrc/mfcc.cu once for every waveform of the call
    and counts one in ``mfcc_fused.launches``; a CPU tensor runs
    ``mfcc_plain``.  Nothing falls back from one to the other."""
    _check_config(cfg)
    offsets = np.asarray(offsets, np.int64)
    _check_waves(samples, offsets)
    kind = samples.device.type
    if kind == "cpu":
        return mfcc_plain(samples, offsets, cfg)
    if kind != "cuda":
        raise ValueError(f"mfcc_fused: no implementation for device {samples.device}")
    return _mfcc_cuda(samples, offsets, cfg)


mfcc_fused.launches = 0
