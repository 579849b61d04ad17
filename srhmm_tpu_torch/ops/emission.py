"""GMM emission likelihoods (counterpart of ``srhmm_tpu/ops/emission.py``).

Two paths:

* **log path**: log-space Gaussian mixture log-likelihoods.  Diagonal
  covariance is one GEMM over the lifted feature map [x, x^2]:

      log N(x; mu, s^2) = -1/2 (D log 2pi + sum log s^2)
                          - 1/2 sum x^2 k + sum x (mu k) - 1/2 sum mu^2 k
      with k = 1/s^2 (the stored inverse covariance).

  Full covariance evaluates the quadratic form with an einsum and clamps
  the density at log 1e20 (the reference's calc_gaus overflow clamp).

* **parity path**: the reference's probability-domain computation in
  float64 — ``calc_gaus`` (full: with the isinf -> 1e20 clamp; diag: no
  clamp) and ``calc_symbol_probab``.  Where det == 0 the C function returns
  an uninitialized double; this path returns 0.0.

Where the JAX package vmaps over words, these functions take the extra axes
directly: stream tensors may carry leading axes before (S, M) — e.g. a
(W, S, M, D) stacked vocabulary — and frames may carry leading axes before
(T, D).  Results are laid out (*frame_axes, *stream_axes, M) for log_gauss.
"""

from __future__ import annotations

import math

import torch

from ..models.gmm_hmm import DIAG, FULL, GAUS_INF_CLAMP, GmmStream

# ---------------------------------------------------------------------------
# log path
# ---------------------------------------------------------------------------


def log_gauss(frames: torch.Tensor, stream: GmmStream) -> torch.Tensor:
    """Per-mixture Gaussian log-pdfs.

    frames: (*F, D); stream tensors shaped (*P, M, ...).  Returns (*F, *P, M)
    in the frames' dtype.  A mixture with log|det| = -inf (det == 0) is
    degenerate and gets -inf.
    """
    dtype = frames.dtype
    mu = stream.means.to(dtype)  # (*P, M, D)
    k = stream.inv_cov.to(dtype)
    D = frames.shape[-1]
    pm_shape = mu.shape[:-1]  # (*P, M)
    N = math.prod(pm_shape)
    lad = stream.log_abs_det()
    log_norm = (-0.5 * (D * math.log(2.0 * math.pi) + lad)).to(dtype)
    degenerate = ~torch.isfinite(log_norm)
    log_norm = torch.where(degenerate, torch.zeros_like(log_norm), log_norm)
    f_shape = frames.shape[:-1]

    if stream.cov_type == DIAG:
        mu2 = mu.reshape(N, D)
        k2 = k.reshape(N, D)
        w = torch.cat([(mu2 * k2).T, (-0.5 * k2).T], dim=0)  # (2D, N)
        bias = -0.5 * torch.sum(mu2 * mu2 * k2, dim=-1)  # (N,)
        feats = torch.cat([frames, frames * frames], dim=-1)  # (*F, 2D)
        q = torch.matmul(feats, w) + bias
        out = q.reshape(*f_shape, *pm_shape) + log_norm
        return torch.where(degenerate, -torch.inf, out)
    if stream.cov_type == FULL:
        dif = frames[..., None, :] - mu.reshape(N, D)  # (*F, N, D)
        quad = torch.einsum("...nd,nde,...ne->...n", dif, k.reshape(N, D, D), dif)
        out = -0.5 * quad.reshape(*f_shape, *pm_shape) + log_norm
        # the reference clamps overflowing full-cov densities to 1e20; the
        # log path clamps at log(1e20), which also catches indefinite
        # covariances (negative quadratic forms) before they overflow
        out = torch.clamp(out, max=math.log(GAUS_INF_CLAMP))
        return torch.where(degenerate, -torch.inf, out)
    raise ValueError(f"unknown cov_type {stream.cov_type}")


def log_state_emission(frames, streams) -> torch.Tensor:
    """log b_i(o_t): per-state emission log-likelihood, summed over streams.

    frames: (*F, D) shared across streams, or a tuple of per-stream
    (*F, D_p) tensors (the reference reads one feature file per stream).
    Returns (*F, *P) with P the stream tensors' state axes.
    """
    per_stream = (
        tuple(frames) if isinstance(frames, (tuple, list)) else (frames,) * len(streams)
    )
    if len(per_stream) != len(streams):
        raise ValueError(
            f"{len(streams)} streams need {len(streams)} frame sets, got {len(per_stream)}"
        )
    total = None
    for fr, stream in zip(per_stream, streams):
        lg = log_gauss(fr, stream)  # (*F, *P, M)
        logw = torch.log(stream.weights.to(fr.dtype))
        per_state = torch.logsumexp(lg + logw, dim=-1)
        total = per_state if total is None else total + per_state
    return total


def log_mixture_posteriors(frames: torch.Tensor, stream: GmmStream):
    """(log b per state, per-mixture posterior) — the quantities the
    trainer's ``calc_symbol_probab`` produces (T1:1791-1811): posteriors are
    the weighted mixture likelihoods normalized within each state.

    frames (*F, D) -> (log_b (*F, S), post (*F, S, M)), post in linear
    domain; a state with zero total likelihood gets zero posteriors."""
    lg = log_gauss(frames, stream) + torch.log(stream.weights.to(frames.dtype))
    log_b = torch.logsumexp(lg, dim=-1)
    post = torch.exp(lg - log_b[..., None])
    post = torch.where(torch.isfinite(log_b)[..., None], post, torch.zeros_like(post))
    return log_b, post


# ---------------------------------------------------------------------------
# parity path (float64 probability domain, reference-exact semantics)
# ---------------------------------------------------------------------------


def prob_gauss_parity(frames: torch.Tensor, stream: GmmStream) -> torch.Tensor:
    """calc_gaus over all frames/states/mixtures in probability domain.

    frames (T, D) -> (T, *P, M) float64.  Full covariance applies the
    isinf -> 1e20 clamp; the diagonal variant has no clamp.  det == 0
    yields 0.0.
    """
    frames = frames.to(torch.float64)
    mu = stream.means.to(torch.float64)
    k = stream.inv_cov.to(torch.float64)
    det = stream.det.to(torch.float64)
    D = frames.shape[-1]
    norm = (2.0 * math.pi) ** (D / 2.0)  # aux1 (T1:1851-1853)
    pm_shape = mu.shape[:-1]
    N = math.prod(pm_shape)

    dif = frames[:, None, :] - mu.reshape(N, D)  # (T, N, D)
    if stream.cov_type == FULL:
        quad = torch.einsum("tnd,nde,tne->tn", dif, k.reshape(N, D, D), dif)
    else:
        quad = torch.einsum("tnd,nd->tn", dif * dif, k.reshape(N, D))
    quad = quad.reshape(frames.shape[0], *pm_shape)
    gaus = torch.exp(-0.5 * quad) / (norm * torch.sqrt(torch.abs(det)))
    if stream.cov_type == FULL:
        gaus = torch.where(torch.isinf(gaus), GAUS_INF_CLAMP, gaus)
    return torch.where(det != 0.0, gaus, 0.0)


def prob_state_emission_parity(frames: torch.Tensor, stream: GmmStream):
    """calc_symbol_probab for one stream: (symbol_probab (T, *P),
    normalized per-mixture posteriors (T, *P, M))."""
    gaus = prob_gauss_parity(frames, stream) * stream.weights.to(torch.float64)
    b = torch.sum(gaus, dim=-1)
    nz = b[..., None] != 0.0
    post = torch.where(nz, gaus / torch.where(nz, b[..., None], 1.0), 0.0)
    return b, post


def prob_emission_parity(frames_per_stream, streams) -> torch.Tensor:
    """Product over streams of per-state symbol probabilities (T, *P), as
    the forward pass consumes them (T1:1437-1441)."""
    total = None
    for frames, stream in zip(frames_per_stream, streams):
        b, _ = prob_state_emission_parity(frames, stream)
        total = b if total is None else total * b
    return total
