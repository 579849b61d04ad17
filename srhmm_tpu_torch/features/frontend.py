"""MFCC / log-mel filterbank frontend (counterpart of
``srhmm_tpu/features/frontend.py``).

Every stage is a product with a precomputed constant:

    frames (..., F, W)  @ [window * DFT cos/sin] (W, K)   -> real/imag spectra
    power  (..., F, K)  @ mel filterbank         (K, n_mels)
    log-mel (..., F, n_mels) @ DCT-II            (n_mels, n_mfcc)

The constants are built in numpy float64 exactly as the JAX package builds
them and cast to the input's dtype only at use, so both packages multiply
by the same numbers.  ``mfcc`` / ``log_mel`` are plain torch in the dtype
of the input (float64 for the parity paths, float32 as the twin of the
hand-written kernel in ``ops/kernels/mfcc.py``).

Framing clamps the sample indices past the end of a waveform to its last
sample, as the JAX package's gather does: a waveform shorter than one frame
gives one frame whose tail repeats the last sample.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16_000
    frame_length: int = 400  # 25 ms
    frame_shift: int = 160  # 10 ms
    n_mels: int = 26
    n_mfcc: int = 13
    fmin: float = 20.0
    fmax: float | None = None  # default sr/2
    preemphasis: float = 0.97
    window: str = "hamming"  # hamming | hann | rect
    log_floor: float = 1e-10
    include_energy: bool = False


def _window(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    if cfg.window == "hamming":
        return 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    if cfg.window == "hann":
        return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    if cfg.window == "rect":
        return np.ones(n)
    raise ValueError(cfg.window)


def dft_matrices(cfg: FrontendConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT as two (W, K) float64 constants (cos, -sin)."""
    W = cfg.frame_length
    K = W // 2 + 1
    n = np.arange(W)[:, None]
    k = np.arange(K)[None, :]
    ang = 2.0 * np.pi * n * k / W
    win = _window(cfg)[:, None]
    return (np.cos(ang) * win, -np.sin(ang) * win)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """(K, n_mels) triangular mel filterbank (HTK mel scale)."""
    K = cfg.frame_length // 2 + 1
    fmax = cfg.fmax or cfg.sample_rate / 2.0
    mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    imel = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    pts = imel(np.linspace(mel(cfg.fmin), mel(fmax), cfg.n_mels + 2))
    bins = pts / (cfg.sample_rate / 2.0) * (K - 1)
    fb = np.zeros((K, cfg.n_mels))
    for m in range(cfg.n_mels):
        l, c, r = bins[m], bins[m + 1], bins[m + 2]
        k = np.arange(K)
        up = (k - l) / max(c - l, 1e-9)
        down = (r - k) / max(r - c, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def dct_matrix(cfg: FrontendConfig) -> np.ndarray:
    """(n_mels, n_mfcc) orthonormal DCT-II."""
    n, k = np.meshgrid(np.arange(cfg.n_mels), np.arange(cfg.n_mfcc), indexing="ij")
    d = np.cos(np.pi * (n + 0.5) * k / cfg.n_mels) * math.sqrt(2.0 / cfg.n_mels)
    d[:, 0] *= math.sqrt(0.5)
    return d


def frame_count(n_samples: int, cfg: FrontendConfig) -> int:
    """Frames of an n-sample waveform: 1 + (N - W) // shift, at least 1."""
    return 1 + max(0, n_samples - cfg.frame_length) // cfg.frame_shift


def frame_signal(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(..., N) -> (..., F, W) overlapping frames; indices past N-1 clamp
    to N-1 (a waveform shorter than a frame)."""
    N = x.shape[-1]
    if N < 1:
        raise ValueError("frame_signal: empty waveform")
    F = frame_count(N, cfg)
    idx = np.arange(F)[:, None] * cfg.frame_shift + np.arange(cfg.frame_length)[None, :]
    idx = torch.as_tensor(np.minimum(idx, N - 1), device=x.device)
    return x[..., idx]


def _preemphasize(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    if not cfg.preemphasis:
        return x
    return torch.cat([x[..., :1], x[..., 1:] - cfg.preemphasis * x[..., :-1]], dim=-1)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _power(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Waveform (..., N) -> power spectrum (..., F, K)."""
    frames = frame_signal(_preemphasize(x, cfg), cfg)
    cos_m, sin_m = dft_matrices(cfg)
    re = frames @ _const(cos_m, x)
    im = frames @ _const(sin_m, x)
    return re * re + im * im


def _log_mel_of_power(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    melspec = power @ _const(mel_filterbank(cfg), power)
    return torch.log(torch.clamp(melspec, min=cfg.log_floor))


def mfcc(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Waveform (..., N) -> MFCC (..., F, n_mfcc), in the input's dtype.
    With include_energy, column 0 is the log frame energy."""
    power = _power(x, cfg)
    out = _log_mel_of_power(power, cfg) @ _const(dct_matrix(cfg), x)
    if cfg.include_energy:
        energy = torch.log(torch.clamp(torch.sum(power, -1), min=cfg.log_floor))
        out = torch.cat([energy[..., None], out[..., 1:]], dim=-1)
    return out


def log_mel(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig()) -> torch.Tensor:
    """Waveform (..., N) -> log-mel filterbank (..., F, n_mels)."""
    return _log_mel_of_power(_power(x, cfg), cfg)


def delta_matrix(T: int, order_window: int = 2, dtype=np.float64) -> np.ndarray:
    """(T, T) banded regression-delta operator (HTK-style, edge-replicated):
    deltas as one product over the time axis."""
    N = order_window
    denom = 2.0 * sum(n * n for n in range(1, N + 1))
    m = np.zeros((T, T), dtype=dtype)
    for t in range(T):
        for n in range(1, N + 1):
            m[t, min(t + n, T - 1)] += n / denom
            m[t, max(t - n, 0)] -= n / denom
    return m


def add_deltas(feats: torch.Tensor, order_window: int = 2) -> torch.Tensor:
    """(..., T, D) -> (..., T, 3D): static + delta + delta-delta."""
    dm = _const(delta_matrix(feats.shape[-2], order_window), feats)
    d1 = torch.einsum("ts,...sd->...td", dm, feats)
    d2 = torch.einsum("ts,...sd->...td", dm, d1)
    return torch.cat([feats, d1, d2], dim=-1)


def cmvn(
    feats: torch.Tensor,
    lengths: torch.Tensor | None = None,
    var_norm: bool = True,
    eps: float = 1.0e-8,
) -> torch.Tensor:
    """Per-utterance cepstral mean (and variance) normalization.

    feats: (..., T, D); lengths: optional (...,) valid frame counts for
    padded batches: the statistics are taken over valid frames only and
    padded frames pass through untouched."""
    if lengths is None:
        mean = torch.mean(feats, dim=-2, keepdim=True)
        centered = feats - mean
        if not var_norm:
            return centered
        var = torch.mean(centered * centered, dim=-2, keepdim=True)
        return centered * torch.rsqrt(var + eps)
    T = feats.shape[-2]
    lengths = lengths.to(feats.device)
    mask = (torch.arange(T, device=feats.device) < lengths[..., None])[..., None].to(feats.dtype)
    n = torch.clamp(lengths[..., None, None].to(feats.dtype), min=1.0)
    mean = torch.sum(feats * mask, dim=-2, keepdim=True) / n
    centered = (feats - mean) * mask
    if var_norm:
        var = torch.sum(centered * centered, dim=-2, keepdim=True) / n
        centered = centered * torch.rsqrt(var + eps)
    return torch.where(mask > 0, centered, feats)


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def global_cmvn_stats(feats, lengths=None, eps: float = 1.0e-8):
    """Corpus-level mean/std over the valid frames of a padded (B, T, D)
    batch (tensor or array).  Returns ((D,) mean, (D,) std) as float64
    numpy arrays.

    This is the fast trainer's precision lever: EM is exactly equivariant
    under the affine map y = (x - mean)/std (densities pick up a constant
    Jacobian, occupancies are unchanged), so training in normalized space
    and de-normalizing the result (models.gmm_hmm.denormalize_model)
    reproduces raw-space training, while the float32 moment statistics
    round relative to O(1) magnitudes instead of the raw feature scale."""
    f = _host64(feats)
    if f.ndim == 2:
        f = f[None]
    if lengths is None:
        valid = np.ones(f.shape[:2], bool)
    else:
        ln = _host64(lengths).reshape(-1)
        valid = np.arange(f.shape[1])[None, :] < ln[:, None]
    sel = f[valid]  # (n_frames, D)
    mean = sel.mean(0)
    std = np.sqrt(np.maximum(sel.var(0), eps))
    return mean, std
