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
    aligned16,
    check_launch,
    device_args,
    dmax_for,
    mixture_records,
    on_cpu,
    require_float32,
    sm_count,
)

EMISSION_THREADS = (256, 128, 64, 32)  # an emission block's threads (csrc/emission_em.cu kEmitThreads first)
STATS_TILES = (128, 64, 32, 16, 8)  # frames a moments tile, largest first (each divides csrc/emission_em.cu kStatsThreads)


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
    lib.srhmm_emission_log_b.argtypes = [c_ptr] * 3 + [c_ll] + [c_int] * 8 + [c_ptr]
    lib.srhmm_emission_log_b_grid.restype = c_int
    lib.srhmm_emission_log_b_grid.argtypes = [c_ll] + [c_int] * 8 + [ctypes.POINTER(c_ll)]
    lib.srhmm_emission_stats.restype = c_int
    lib.srhmm_emission_stats.argtypes = [c_ptr] * 6 + [c_ll] + [c_int] * 9 + [c_ptr]
    lib.srhmm_emission_stats_occupancy.restype = c_int
    lib.srhmm_emission_stats_occupancy.argtypes = [c_int] * 7 + [ctypes.POINTER(c_int)]
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
        self.frames = aligned16(frames.contiguous())
        self.recs = mixture_records(a.permute(0, 2, 1), None, b.reshape(self.M, self.S, 1), None,
                                    self.D, self.M, 1, self.S, False, self.dmax).reshape(-1)


def emission_cols(dmax: int) -> int:
    """Frames an emission thread takes side by side (csrc/emission_em.cu
    kEmitCols)."""
    return 2 if dmax <= 16 else 1


def emission_smem_bytes(dmax: int, threads: int, D: int, S: int, M: int, recs_global: bool = False,
                        direct: bool = False) -> int:
    """csrc/emission_em.cu emit_floats: the records (unless read from device
    memory), two slots of (TF, D) frames and the (TF, S) log b tile (unless
    log b goes straight out), TF = threads * emission_cols(dmax)."""
    tf = threads * emission_cols(dmax)
    return 4 * ((0 if recs_global else S * M * (2 * dmax + 4)) + 2 * tf * D + (0 if direct else tf * S))


def emission_block(N: int, D: int, S: int, M: int, name: str = "emission_log_b") -> dict:
    """The emission launch shape: the most threads of EMISSION_THREADS whose
    block fits SMEM_LIMIT with the records in shared memory, else with the
    records in device memory; where no (TF, S) log b tile fits beside the
    frames (thousands of states), log b goes straight out, the same way;
    frames a tile and the tiles of N frames.  Every D <= 64 is taken."""
    dmax = dmax_for([D], name)
    for direct in (False, True):
        for recs_global in (False, True):
            for threads in EMISSION_THREADS:
                smem = emission_smem_bytes(dmax, threads, D, S, M, recs_global, direct)
                if smem <= SMEM_LIMIT:
                    tf = threads * emission_cols(dmax)
                    return {"threads": threads, "tile_frames": tf, "tiles": -(-N // tf),
                            "recs_global": recs_global, "direct": direct, "smem_bytes": smem, "dmax": dmax}
    raise AssertionError("unreachable: two (256, 64) frame tiles fit shared memory")


def emission_grid(N: int, D: int, S: int, M: int, device) -> int:
    """The blocks emission_log_b launches for N frames on a CUDA device:
    at most the blocks of emission_block's shape that fit on the card at
    once (the CUDA occupancy calculator), and no more than its tiles."""
    shape = emission_block(N, D, S, M)
    blocks = ctypes.c_longlong(0)
    dev = torch.device(device)
    check_launch("emission_log_b", _kernel_library().srhmm_emission_log_b_grid(
        N, D, S, M, shape["dmax"], shape["threads"], int(shape["recs_global"]), int(shape["direct"]),
        device_args(dev)[0], ctypes.byref(blocks)))
    return blocks.value


def emission_log_b(frames, a, b):
    """frames (N, D) + packed constants (pack_constants) -> (N, S)
    emission log-likelihoods float32 (see emission_log_b_plain).

    CUDA float32 tensors launch csrc/emission_em.cu's emission kernel and
    count one in ``emission_log_b.launches``; CPU tensors run the twin."""
    if on_cpu("emission_log_b", frames):
        return emission_log_b_plain(frames, a, b)
    ln = _EmissionLaunch("emission_log_b", frames, a, b)
    shape = emission_block(ln.N, ln.D, ln.S, ln.M)
    out = torch.empty((ln.N, ln.S), dtype=torch.float32, device=ln.dev)
    check_launch(ln.name, _kernel_library().srhmm_emission_log_b(
        ln.frames.data_ptr(), ln.recs.data_ptr(), out.data_ptr(), ln.N, ln.D, ln.S, ln.M, ln.dmax, shape["threads"],
        int(shape["recs_global"]), int(shape["direct"]), *device_args(ln.dev)))
    emission_log_b.launches += 1
    return out


emission_log_b.launches = 0


def stats_smem_bytes(dmax: int, D: int, SG: int, M: int, TF: int, recs_global: bool) -> int:
    """csrc/emission_em.cu stats_floats: the group's records (unless read
    from device memory), two slots each of frames (TF, D), posteriors and
    log b (TF, SG), the weights (SG M, TF + 4), the features (D, TF + 4)
    and the accumulators (SG M, 2D + 1)."""
    ks, rows = TF + 4, SG * M
    return 4 * ((0 if recs_global else rows * (2 * dmax + 4)) + 2 * TF * D + 4 * TF * SG + rows * ks + D * ks
                + rows * (2 * D + 1))


def stats_block(N: int, D: int, S: int, M: int, name: str = "emission_stats") -> dict:
    """The moments' launch shape (_stats_shape) and its tiles of N frames."""
    sh = _stats_shape(D, S, M, name)
    return {**sh, "tiles": -(-N // sh["tile_frames"])}


@functools.cache
def _stats_shape(D: int, S: int, M: int, name: str) -> dict:
    """The moments' launch shape: the largest tile of STATS_TILES frames
    whose block holds all S states, the records in shared memory, else in
    device memory; where no block holds all the states, tiles of 128 frames
    (the largest that holds one) with the records in device memory and as
    many states a block (a group) as fit, each group reading the frames
    once.  Raises ValueError only where no block of one state and 8 frames
    fits."""
    dmax = dmax_for([D], name)

    def most_states(TF, rg):  # the bytes grow with SG
        return next((sg for sg in range(S, 0, -1) if stats_smem_bytes(dmax, D, sg, M, TF, rg) <= SMEM_LIMIT), 0)

    shape = next(((tf, rg, S) for tf in STATS_TILES for rg in (False, True) if most_states(tf, rg) == S), None)
    if shape is None:
        tf = next((tf for tf in STATS_TILES if most_states(tf, True) >= 1), None)
        if tf is None:
            raise ValueError(f"{name}: no block of one state's {M} mixtures at D={D} fits the "
                             f"{SMEM_LIMIT}-byte shared-memory budget")
        shape = (tf, True, most_states(tf, True))
    TF, rg, SG = shape
    return {"tile_frames": TF, "states": SG, "groups": -(-S // SG), "recs_global": rg, "dmax": dmax,
            "smem_bytes": stats_smem_bytes(dmax, D, SG, M, TF, rg)}


@functools.cache
def _stats_per_sm(D: int, M: int, dmax: int, SG: int, TF: int, recs_global: bool, index: int) -> int:
    per_sm = ctypes.c_int(0)
    check_launch("emission_stats", _kernel_library().srhmm_emission_stats_occupancy(
        D, M, dmax, SG, TF, int(recs_global), index, ctypes.byref(per_sm)))
    return per_sm.value


def stats_grid(N: int, D: int, S: int, M: int, device) -> int:
    """R, the blocks of each group of states emission_stats launches for N
    frames on a CUDA device: the blocks of stats_block's shape that fit on
    the card at once (the CUDA occupancy calculator), shared among the
    groups, at least 1 and no more than the tiles."""
    sh = stats_block(N, D, S, M)
    index = device_args(torch.device(device))[0]
    per_sm = _stats_per_sm(D, M, sh["dmax"], sh["states"], sh["tile_frames"], sh["recs_global"], index)
    if per_sm < 1:
        raise RuntimeError(f"emission_stats: no block of {sh['smem_bytes']} bytes fits an SM")
    resident = sm_count(index) * per_sm
    return max(1, min(sh["tiles"], resident // sh["groups"]))


def emission_stats(frames, gamma, log_b, a, b):
    """Fused diagonal-GMM sufficient statistics: (S, M, 2D+1) moments
    [sum g x, sum g x^2, sum g] (see emission_stats_plain), without any
    (N, S, M) tensor in device memory.

    CUDA float32 tensors launch csrc/emission_em.cu's moments kernel
    (resident blocks walking tiles of frames with all the states, or a
    group of them: stats_block, stats_grid; per block partial sums, then
    their sum in a fixed order: two runs bitwise equal) and count one in
    ``emission_stats.launches``; CPU tensors run the twin."""
    if on_cpu("emission_stats", frames):
        return emission_stats_plain(frames, gamma, log_b, a, b)
    ln = _EmissionLaunch("emission_stats", frames, a, b, extra=(gamma, log_b))
    if tuple(gamma.shape) != (ln.N, ln.S) or tuple(log_b.shape) != (ln.N, ln.S):
        raise ValueError(f"emission_stats: gamma and log b must be (N, S) = {(ln.N, ln.S)}")
    gamma, log_b = aligned16(gamma.contiguous()), aligned16(log_b.contiguous())
    sh = stats_block(ln.N, ln.D, ln.S, ln.M)
    R = stats_grid(ln.N, ln.D, ln.S, ln.M, ln.dev)
    Cm = 2 * ln.D + 1
    f32 = dict(dtype=torch.float32, device=ln.dev)
    partial = torch.empty(R * ln.S * ln.M * Cm, **f32)
    out = torch.empty((ln.S, ln.M, Cm), **f32)
    check_launch(ln.name, _kernel_library().srhmm_emission_stats(
        ln.frames.data_ptr(), gamma.data_ptr(), log_b.data_ptr(), ln.recs.data_ptr(), partial.data_ptr(),
        out.data_ptr(), ln.N, ln.D, ln.S, ln.M, ln.dmax, sh["states"], sh["tile_frames"], R, int(sh["recs_global"]),
        *device_args(ln.dev)))
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
