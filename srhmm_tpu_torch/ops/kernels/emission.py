"""Fused diagonal-GMM emission and sufficient-statistic kernels.

Counterpart of ``srhmm_tpu/ops/pallas/emission_pallas.py``, single stream,
diagonal covariance:

* ``pack_constants`` — the per-mixture GEMM matrices (M, 2D, S) and
  biases (M, 1, S), packed in float64 and then cast:
  q_m = [x, x^2] @ A_m + b_m with A_m = [mu k; -k/2] and
  b_m = -1/2 sum mu^2 k + log max(w_m, 1e-300) - 1/2 (D log 2pi + log|det|).
* ``emission_log_b`` (TPU kernel #21): frames (N, D) -> (N, S) log b =
  logsumexp_m q_m (no clamp).
* ``emission_stats`` (#22): frames, gamma (N, S), log b (N, S) -> (S, M,
  2D+1) moments [sum g x, sum g x^2, sum g] with g = gamma *
  exp(min(q_m - log b, 0)), gamma zeroed where log b <= -1e30.
* ``log_state_emission_fused`` — log b of a diagonal stream through #21.

CUDA float32 tensors launch the hand-written kernels of
``csrc/emission_em.cu`` (the constants re-laid as ``csrc/emission.cuh``
records) and count one in ``.launches``; CPU tensors run the plain twins
(``*_plain``).  The kernels take any N (the TPU kernels needed N % t_block
== 0), and the moments are summed in a fixed order, without atomics: two
runs are bitwise equal.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...models.gmm_hmm import DIAG, GmmStream
from .common import (
    NEG_INF,
    SMEM_LIMIT,
    check_launch,
    device_args,
    dmax_for,
    mixture_records,
    on_cpu,
    require_float32,
)

FRAMES_PER_CHUNK = 128  # csrc/emission_em.cu kFrames


def pack_constants(stream: GmmStream, dtype=torch.float32):
    """(M, 2D, S) GEMM matrices and (M, 1, S) biases of a diagonal stream,
    computed in float64 on the stream's device and then cast."""
    f64 = torch.float64
    mu, k, w = stream.means.to(f64), stream.inv_cov.to(f64), stream.weights.to(f64)
    log_det = stream.log_abs_det().to(f64)
    S, M, D = mu.shape
    a = torch.cat([mu * k, -0.5 * k], dim=-1).permute(1, 2, 0)  # (M, 2D, S)
    bias = (
        -0.5 * torch.sum(mu * mu * k, dim=-1)
        + torch.log(torch.clamp(w, min=1e-300))
        - 0.5 * (D * math.log(2.0 * math.pi) + log_det)
    )  # (S, M)
    return a.to(dtype).contiguous(), bias.T[:, None, :].to(dtype).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _mixture_q(lifted, a, b):
    """Per-mixture (N, S) log-likelihoods q_m, m = 0..M-1."""
    return [lifted @ a[m] + b[m] for m in range(a.shape[0])]


def emission_log_b_plain(frames, a, b):
    """The emission kernel's function in eager PyTorch: (N, S) float32,
    a running logaddexp over the mixtures' q_m."""
    x = frames.to(torch.float32)
    qs = _mixture_q(torch.cat([x, x * x], dim=-1), a.to(torch.float32), b.to(torch.float32))
    lb = qs[0]
    for q in qs[1:]:
        lb = torch.logaddexp(lb, q)
    return lb


def emission_stats_plain(frames, gamma, log_b, a, b):
    """The moments kernel's function in eager PyTorch: (S, M, 2D+1)
    float32."""
    x = frames.to(torch.float32)
    lb = log_b.to(torch.float32)
    g = torch.where(lb > NEG_INF, gamma.to(torch.float32), 0.0)
    lifted = torch.cat([x, x * x], dim=-1)
    cols = torch.cat([lifted, torch.ones_like(x[:, :1])], dim=-1)  # (N, 2D+1)
    out = []
    for q in _mixture_q(lifted, a.to(torch.float32), b.to(torch.float32)):
        # q - lb <= 0 up to rounding; the clamp also keeps lb = -inf finite
        gm = g * torch.exp(torch.clamp(q - lb, max=0.0))
        out.append(gm.T @ cols)  # (S, 2D+1)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/emission_em.cu)
# ---------------------------------------------------------------------------


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the emission launchers' C signatures."""
    from .build import load_library

    lib = load_library()
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib.srhmm_emission_log_b.restype = c_int
    lib.srhmm_emission_log_b.argtypes = [c_ptr] * 3 + [c_ll] + [c_int] * 5 + [c_ptr]
    lib.srhmm_emission_stats.restype = c_int
    lib.srhmm_emission_stats.argtypes = [c_ptr] * 6 + [c_ll] + [c_int] * 5 + [c_ptr]
    lib.srhmm_emission_frames_per_block.restype = c_int
    lib.srhmm_emission_frames_per_block.argtypes = []
    return lib


class _EmissionLaunch:
    """Checked operands of a csrc/emission_em.cu launch: frames (N, D),
    a (M, 2D, S), b (M, 1, S), the records packed at the compiled D bound."""

    def __init__(self, name, frames, a, b, extra=()):
        self.dev = frames.device
        require_float32(name, self.dev, [frames, a, b, *extra], [frames, a, b, *extra])
        if frames.dim() != 2 or a.dim() != 3 or a.shape[1] != 2 * frames.shape[1]:
            raise ValueError(f"{name}: frames (N, D) and constants (M, 2D, S) disagree")
        self.N, self.D = frames.shape
        self.M, _, self.S = a.shape
        if tuple(b.shape) != (self.M, 1, self.S):
            raise ValueError(f"{name}: biases must be (M, 1, S) = {(self.M, 1, self.S)}")
        if self.N < 1:
            raise ValueError(f"{name}: no frames")
        self.name = name
        self.dmax = dmax_for([self.D], name)
        self.frames = frames.contiguous()
        self.recs = mixture_records(a.permute(0, 2, 1), None, b.reshape(self.M, self.S, 1), None,
                                    self.D, self.M, 1, self.S, False, self.dmax).reshape(-1).contiguous()

    def fit(self, floats: int) -> None:
        if 4 * floats > SMEM_LIMIT:
            raise ValueError(f"{self.name}: {4 * floats} bytes of shared memory per block, above the "
                             f"{SMEM_LIMIT}-byte budget")


def emission_log_b(frames, a, b):
    """frames (N, D) + packed constants (pack_constants) -> (N, S)
    emission log-likelihoods float32 (see emission_log_b_plain).

    CUDA float32 tensors launch csrc/emission_em.cu's emission kernel and
    count one in ``emission_log_b.launches``; CPU tensors run the twin."""
    if on_cpu("emission_log_b", frames):
        return emission_log_b_plain(frames, a, b)
    ln = _EmissionLaunch("emission_log_b", frames, a, b)
    ln.fit(ln.recs.numel())
    out = torch.empty((ln.N, ln.S), dtype=torch.float32, device=ln.dev)
    check_launch(ln.name, _kernel_library().srhmm_emission_log_b(
        ln.frames.data_ptr(), ln.recs.data_ptr(), out.data_ptr(), ln.N, ln.D, ln.S, ln.M, ln.dmax,
        *device_args(ln.dev)))
    emission_log_b.launches += 1
    return out


emission_log_b.launches = 0


def emission_stats(frames, gamma, log_b, a, b):
    """Fused diagonal-GMM sufficient statistics: (S, M, 2D+1) moments
    [sum g x, sum g x^2, sum g] (see emission_stats_plain), without any
    (N, S, M) tensor in device memory.

    CUDA float32 tensors launch csrc/emission_em.cu's moments kernel (per
    block partial sums, then their sum in block order: two runs bitwise
    equal) and count one in ``emission_stats.launches``; CPU tensors run the
    twin."""
    if on_cpu("emission_stats", frames):
        return emission_stats_plain(frames, gamma, log_b, a, b)
    ln = _EmissionLaunch("emission_stats", frames, a, b, extra=(gamma, log_b))
    if tuple(gamma.shape) != (ln.N, ln.S) or tuple(log_b.shape) != (ln.N, ln.S):
        raise ValueError(f"emission_stats: gamma and log b must be (N, S) = {(ln.N, ln.S)}")
    gamma, log_b = gamma.contiguous(), log_b.contiguous()
    Cm = 2 * ln.D + 1
    ln.fit(ln.M * (2 * ln.dmax + 4) + ln.M * (FRAMES_PER_CHUNK + 1) + FRAMES_PER_CHUNK * (ln.D | 1)
           + ln.M * Cm)
    lib = _kernel_library()
    ranges = -(-ln.N // lib.srhmm_emission_frames_per_block())
    f32 = dict(dtype=torch.float32, device=ln.dev)
    partial = torch.empty(ranges * ln.S * ln.M * Cm, **f32)
    out = torch.empty((ln.S, ln.M, Cm), **f32)
    check_launch(ln.name, lib.srhmm_emission_stats(
        ln.frames.data_ptr(), gamma.data_ptr(), log_b.data_ptr(), ln.recs.data_ptr(), partial.data_ptr(),
        out.data_ptr(), ln.N, ln.D, ln.S, ln.M, ln.dmax, *device_args(ln.dev)))
    emission_stats.launches += 1
    return out


emission_stats.launches = 0


def log_state_emission_fused(frames, stream: GmmStream):
    """Fused replacement for ops.emission.log_state_emission on a single
    diagonal-covariance stream: frames (N, D) -> (N, S) float32 through
    emission_log_b (any N)."""
    if stream.cov_type != DIAG:
        raise ValueError("fused emission kernel is diagonal-covariance only")
    a, b = pack_constants(stream, torch.float32)
    return emission_log_b(frames, a.to(frames.device), b.to(frames.device))
