"""Constants and host-side helpers shared by the kernels (counterparts of
``srhmm_tpu/ops/pallas/fused_em_pallas.py:59-61`` and ``trans_band``), and
the per-mixture record layout of ``csrc/emission.cuh``."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...models.gmm_hmm import GAUS_INF_CLAMP

NEG_INF = -1e30  # finite log-domain floor every recursion clamps to
_TINY = 1e-38  # smallest f32 normal-ish; log argument guard
LOG_GAUS_CLAMP = math.log(GAUS_INF_CLAMP)  # calc_gaus 1e20 clamp, T1:1880-1883


def trans_band(trans) -> int | None:
    """Band width of a (stack of) transition matrices: the smallest ``band``
    with trans[i, j] == 0 outside 0 <= j - i <= band, or None if
    lower-triangular entries exist (not left-right)."""
    t = np.asarray(trans)
    S = t.shape[-1]
    nz = np.argwhere(t.reshape(-1, S, S).sum(0) != 0)
    d = nz[:, 1] - nz[:, 0]
    if (d < 0).any():
        return None
    return int(d.max())


DMAX_BOUNDS = (4, 8, 12, 16, 32, 64)  # template bounds on D compiled in the .cu files
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
# full covariance past D = 16: the z-GEMM blocks of csrc/wide_gemm.cuh (kWide*)
WIDE_THREADS = 256  # threads of a block: 8 warps
WIDE_FRAMES = 128  # frames (columns) of a z-GEMM tile, 32 a warp
WIDE_SLICE = 2  # mixtures of a record slice (two slice buffers)
WIDE_GROUP = 8  # mixtures of a moments block: one mma n tile
# the log b buffer of the vocabulary scorer's and the word-loop decoder's
# emission pass (csrc/wide_log_b.cu) at full covariance past D = 16: one
# launch of the pass and its recursion holds at most this many bytes of it
# (ops/kernels/wide_emission.py plan_parts splits a call's utterances, and
# the frames of an utterance past it, over launches)
WIDE_LOG_B_BYTES = 1 << 30


def wide_lift_rows(D: int) -> int:
    """Rows of the z-GEMM moments' lift: x, the lower triangle of x x^T, 1."""
    return D + D * (D + 1) // 2 + 1


def wide_emission_bytes(rb: int) -> int:
    """csrc/wide_gemm.cuh wide_emission_floats in bytes at register bound
    rb: the features of a z-GEMM tile (rows of rb + 4 floats), two record
    slices of WIDE_SLICE mixtures (rows of L^T at that pitch, c, bias and
    log w) and their q."""
    pitch = rb + 4
    return 4 * (WIDE_FRAMES * pitch + 2 * WIDE_SLICE * (rb * pitch + rb + 4 + WIDE_FRAMES))


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (a wrapper runs its plain twin), False for a
    CUDA one (it launches its kernel); any other device raises."""
    kind = t.device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return False


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is off 16-byte alignment (a view):
    the kernels copy 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def device_args(dev: torch.device) -> tuple[int, int]:
    """(device index, current stream handle) of a launch on dev."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        from .build import load_library

        msg = load_library().srhmm_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def require_float32(name: str, dev: torch.device, tensors, float_tensors) -> None:
    """Every tensor on dev, every float tensor float32: what a CUDA kernel
    takes."""
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on the same CUDA device")
    if any(t.dtype != torch.float32 for t in float_tensors):
        raise ValueError(f"{name}: the CUDA kernel takes float32 tensors only")


def dmax_for(dims, name: str) -> int:
    """The smallest compiled bound DMAX >= every feature dim; the error
    names the calling kernel."""
    fits = [b for b in DMAX_BOUNDS if b >= max(dims)]
    if not fits:
        raise ValueError(f"{name}: feature dim {max(dims)} exceeds {DMAX_BOUNDS[-1]}")
    return fits[0]


def mixture_records(a, bias_g, bias, logw, D: int, M: int, W: int, S: int, full: bool, dmax: int):
    """Re-lay one stream's packed GEMM constants into csrc/emission.cuh's
    records: (W, S*M*stride) floats, one record per (state, mixture),
    state-major within each of W blocks, every record 16-byte aligned:

      diagonal: [mu*k (dmax), -k/2 (dmax), bias, log w, 0, 0]
      full:     [L^T rows (D x dmax), -L^T mu (dmax), bias, log w, 0, 0]

    Inputs in the vocabulary layout (rows ordered (w, s) within each plane):
    a (M, W*S, 2D) diagonal or (M*D, W*S, D) full; bias_g (M*D, W*S, 1)
    (full only); bias and logw (M, W*S, 1).  logw=None stores 0 (the
    mixture log-weight already folded into bias)."""
    bias = bias.reshape(M, W, S).permute(1, 2, 0)[..., None]  # (W, S, M, 1)
    logw = None if logw is None else logw.reshape(M, W, S).permute(1, 2, 0)[..., None]
    if full:
        zeros = torch.zeros_like(bias)
        lt = a.reshape(M, D, W, S, D).permute(2, 3, 0, 1, 4)  # (W, S, M, d, e)
        lt = F.pad(lt, (0, dmax - D)).reshape(W, S, M, D * dmax)
        zmu = F.pad(bias_g.reshape(M, D, W, S).permute(2, 3, 0, 1), (0, dmax - D))
        rec = torch.cat([lt, zmu, bias, zeros if logw is None else logw, zeros, zeros], -1)
    else:  # filled in place: a few device operations a call
        at = a.reshape(M, W, S, 2 * D).permute(1, 2, 0, 3)  # (W, S, M, 2D)
        rec = a.new_zeros((W, S, M, 2 * dmax + 4))
        rec[..., :D] = at[..., :D]
        rec[..., dmax : dmax + D] = at[..., D:]
        rec[..., 2 * dmax : 2 * dmax + 1] = bias
        if logw is not None:
            rec[..., 2 * dmax + 1 : 2 * dmax + 2] = logw
    return rec.reshape(W, -1)


def wide_records(a, bias_g, bias, logw, D: int, M: int, N: int, rb: int) -> torch.Tensor:
    """One stream's packed full-covariance constants (pack_vocab_constants:
    a (M*D, N, D), bias_g (M*D, N, 1), bias and logw (M, N, 1)) in
    csrc/wide_gemm.cuh's staged layout at register bound rb, flat: N*M
    records of wide_mix_floats(rb) = (rb + 1) * (rb + 4) floats, row-major
    (row, mixture), each an (rb + 1, rb + 4) matrix whose rows d < rb are
    row d of L^T (zeros from D on and past rb) and whose row rb is c = -L^T
    mu (rb floats, zeros from D on), bias, log w, 0, 0.  A re-layout, no
    arithmetic: the Cholesky factor was taken on the host in float64."""
    pitch = rb + 4
    rec = a.new_zeros((N, M, rb + 1, pitch))
    rec[:, :, :D, :D] = a.reshape(M, D, N, D).permute(2, 0, 1, 3)
    rec[:, :, rb, :D] = bias_g.reshape(M, D, N).permute(2, 0, 1)
    rec[:, :, rb, rb] = bias.reshape(M, N).T
    rec[:, :, rb, rb + 1] = logw.reshape(M, N).T
    return rec.reshape(-1)
