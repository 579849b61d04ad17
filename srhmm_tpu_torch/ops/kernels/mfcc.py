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
  in float32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...features.frontend import (
    FrontendConfig,
    dct_matrix,
    dft_matrices,
    frame_count,
    mel_filterbank,
    mfcc,
)
from .common import SMEM_LIMIT

FRAMES_PER_BLOCK = 32  # csrc/mfcc.cu kFrames
MAX_FRAME_LENGTH = 1024
MAX_MELS = 128
_MAX_THREADS = 256  # csrc/mfcc.cu kMaxThreads
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
    """(n+1,) int64 offsets of each waveform's first MFCC row."""
    lens = np.diff(np.asarray(offsets, np.int64))
    counts = [frame_count(int(n), cfg) for n in lens]
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


@functools.lru_cache(maxsize=8)
def _constants(cfg: FrontendConfig, device: torch.device):
    """The kernel's float32 constants on device, built in float64 first:
    cos and -sin (W, K) with the window folded in, mel (K, n_mels), DCT
    (n_mels, n_mfcc)."""
    cos_m, sin_m = dft_matrices(cfg)
    return tuple(
        torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
        for a in (cos_m, sin_m, mel_filterbank(cfg), dct_matrix(cfg))
    )


def launch_shape(cfg: FrontendConfig) -> tuple[int, int]:
    """(threads, shared-memory bytes) of one block: threads cover the K DFT
    columns in as few passes of at most 256 as possible; shared memory
    holds the frame tile (W x 32), the power tile (32 x K), the log-mel
    tile (32 x n_mels) and the energies."""
    K = cfg.frame_length // 2 + 1
    passes = -(-K // _MAX_THREADS)
    per_pass = -(-K // passes)
    threads = -(-per_pass // 32) * 32
    smem = 4 * FRAMES_PER_BLOCK * (cfg.frame_length + K + cfg.n_mels + 1)
    return threads, smem


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the MFCC launcher's C signature."""
    from .build import load_library

    lib = load_library()
    c_int, c_ll, c_ptr, c_float = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float
    lib.srhmm_mfcc.restype = c_int
    lib.srhmm_mfcc.argtypes = (
        [c_ptr, c_ptr, c_int, c_ll]  # samples, index, n_waves, n_tiles
        + [c_ptr] * 5  # cos, sin, mel, dct, out
        + [c_int] * 5  # W, K, shift, n_mels, n_mfcc
        + [c_float, c_float, c_int, c_int, c_int, c_ptr]  # preemph, floor, energy, threads, device, stream
    )
    return lib


def _mfcc_cuda(samples: torch.Tensor, offsets: np.ndarray, cfg: FrontendConfig) -> torch.Tensor:
    if samples.dtype != torch.float32:
        raise ValueError("mfcc_fused: the CUDA kernel takes float32 samples only")
    threads, smem = launch_shape(cfg)
    if smem > SMEM_LIMIT:
        raise ValueError(f"mfcc_fused: a block needs {smem} bytes of shared memory, above {SMEM_LIMIT}")
    dev = samples.device
    fo = frame_offsets(offsets, cfg)
    tiles = -(-np.diff(fo) // FRAMES_PER_BLOCK)
    to = np.concatenate([[0], np.cumsum(tiles)]).astype(np.int64)
    index = torch.as_tensor(np.stack([offsets, fo, to]), dtype=torch.int64).to(dev)
    cos_m, sin_m, mel, dct = _constants(cfg, dev)
    samples = samples.contiguous()
    out = torch.empty((int(fo[-1]), cfg.n_mfcc), dtype=torch.float32, device=dev)
    lib = _kernel_library()
    err = lib.srhmm_mfcc(
        samples.data_ptr(), index.data_ptr(), len(offsets) - 1, int(to[-1]),
        cos_m.data_ptr(), sin_m.data_ptr(), mel.data_ptr(), dct.data_ptr(), out.data_ptr(),
        cfg.frame_length, cfg.frame_length // 2 + 1, cfg.frame_shift, cfg.n_mels, cfg.n_mfcc,
        float(cfg.preemphasis), float(cfg.log_floor), int(cfg.include_energy), threads,
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
