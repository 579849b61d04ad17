"""GMM-HMM parameter containers (PyTorch modules).

Counterpart of ``srhmm_tpu/models/gmm_hmm.py``.  Every parameter is a dense
tensor with explicit state / mixture / coefficient axes, held as a buffer of
an ``nn.Module``, so a whole vocabulary stacks into one leading ``word`` axis
and scoring all words is one batched computation.

Covariance conventions follow the reference's on-disk contract: what is
stored is the **inverse** covariance together with the determinant of the
*original* covariance, so recognition never inverts anything.

Precision: lower it with ``astype(dtype)``, never with a bare
``module.to(torch.float32)``.  Real determinants reach ~6.7e40, which is
``inf`` in float32; ``astype`` takes ``log |det|`` in float64 *before* the
cast.  To make the trap harmless as well, every ``GmmStream`` fills its
``log_det`` buffer in float64 at construction when none is given.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

FULL = "full"
DIAG = "diag"

# Numerical-contract constants carried over from the reference's semantics.
FINITE_PROBAB = 1.0e-5  # floor for mixture weights & cov diagonals (T1:38)
GAUS_INF_CLAMP = 1e20  # calc_gaus overflow clamp (T1:1880-1883)
BETA_INF_CLAMP = 1e200  # calc_beta overflow clamp (T1:1540)
ZERO_DET_THRESHOLD = 1e-20  # treat_zero_det trigger (T1:2242)


def _tensor(x, dtype=None, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype or x.dtype, device=device or x.device)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device or "cpu")


class GmmStream(nn.Module):
    """Gaussian-mixture emission parameters for one feature stream.

    Shapes (S = states, M = mixtures, D = feature dim):
      weights:  (..., S, M)     mixture coefficients
      means:    (..., S, M, D)
      inv_cov:  (..., S, M, D, D) for full covariance, (..., S, M, D) for diag
      det:      (..., S, M)     determinant of the ORIGINAL covariance
      log_det:  (..., S, M)     log |det|; derived from ``det`` in float64
                                when not given
    Leading ``...`` axes (e.g. a vocabulary axis) are allowed everywhere.
    """

    def __init__(self, weights, means, inv_cov, det, cov_type: str = FULL, log_det=None):
        super().__init__()
        if cov_type not in (FULL, DIAG):
            raise ValueError(f"unknown cov_type {cov_type}")
        self.cov_type = cov_type
        self.register_buffer("weights", _tensor(weights))
        self.register_buffer("means", _tensor(means))
        self.register_buffer("inv_cov", _tensor(inv_cov))
        self.register_buffer("det", _tensor(det))
        if log_det is None:
            d = self.det.to(torch.float64)
            log_det = torch.log(torch.abs(d)).to(self.det.dtype)
        self.register_buffer("log_det", _tensor(log_det))

    @property
    def num_states(self) -> int:
        return self.weights.shape[-2]

    @property
    def num_mixtures(self) -> int:
        return self.weights.shape[-1]

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    def log_abs_det(self) -> torch.Tensor:
        """log |Sigma| in a representation safe for low-precision compute."""
        return self.log_det

    def astype(self, dtype: torch.dtype) -> "GmmStream":
        """Cast for compute, on the same device.  ``log_det`` is taken in
        float64 before the cast, so float32 compute never materializes the
        (overflowing) raw determinant."""
        return GmmStream(
            weights=self.weights.to(dtype),
            means=self.means.to(dtype),
            inv_cov=self.inv_cov.to(dtype),
            det=self.det.to(dtype),
            cov_type=self.cov_type,
            log_det=self.log_det.to(torch.float64).to(dtype),
        )


class GmmHmm(nn.Module):
    """A left-to-right continuous-density HMM for one word (or a stacked vocab).

    trans: (..., S, S) transition probabilities (rows sum to 1 over the
    allowed band).  The initial distribution is implicit: the reference
    always starts in state 0 (``pi[0]=1``, T1:218-219), so pi is not stored.
    ``word`` is a string, or a tuple of strings for a stacked vocabulary.
    """

    def __init__(self, trans, streams: Sequence[GmmStream], word=""):
        super().__init__()
        self.register_buffer("trans", _tensor(trans))
        self.streams = nn.ModuleList(streams)
        self.word = word

    @property
    def num_states(self) -> int:
        return self.trans.shape[-1]

    @property
    def num_streams(self) -> int:
        return len(self.streams)

    @property
    def mixture_numbers(self) -> tuple[int, ...]:
        return tuple(s.num_mixtures for s in self.streams)

    @property
    def coef_numbers(self) -> tuple[int, ...]:
        return tuple(s.dim for s in self.streams)

    def log_trans(self) -> torch.Tensor:
        """log transition matrix with -inf for structurally-forbidden entries."""
        t = self.trans
        return torch.where(t > 0, torch.log(torch.where(t > 0, t, torch.ones_like(t))), -torch.inf)

    def astype(self, dtype: torch.dtype) -> "GmmHmm":
        """Cast for compute, on the same device (determinants switch to log
        space, see GmmStream.astype).  Use this, not ``.to(dtype)``, to
        lower precision."""
        return GmmHmm(
            trans=self.trans.to(dtype),
            streams=[s.astype(dtype) for s in self.streams],
            word=self.word,
        )


def concat_models(units: GmmHmm, ids: Sequence[int], word: str = "") -> GmmHmm:
    """Left-to-right concatenation of stacked unit models into ONE GmmHmm.

    units: a stacked (P, S, ...) inventory (e.g. materialized tied
    triphones); ids: the unit sequence.  The result has L*S states:
    block-diagonal transitions with a chain arc from unit k's exit state
    into unit k+1's entry carrying the exit state's self-loop mass (the
    decode/continuous.compose_sequence convention), so a word built here
    decodes as the forced-alignment graph of its unit sequence does.  The
    result lives on the units' device, in their dtype."""
    idx = torch.as_tensor(np.asarray(ids, np.int64), device=units.trans.device)
    L = len(idx)
    S = units.trans.shape[-1]
    t = units.trans[idx]  # (L, S, S)
    trans = torch.zeros((L * S, L * S), dtype=t.dtype, device=t.device)
    for k in range(L):
        trans[k * S : (k + 1) * S, k * S : (k + 1) * S] = t[k]
        if k + 1 < L:
            trans[k * S + S - 1, (k + 1) * S] = t[k, S - 1, S - 1]

    def gather(a):
        a = a[idx]  # (L, S, M, ...)
        return a.reshape(L * S, *a.shape[2:])

    streams = [
        GmmStream(
            weights=gather(st.weights),
            means=gather(st.means),
            inv_cov=gather(st.inv_cov),
            det=gather(st.det),
            cov_type=st.cov_type,
            log_det=gather(st.log_det),
        )
        for st in units.streams
    ]
    return GmmHmm(trans=trans, streams=streams, word=word)


def stack_models(models: Sequence[GmmHmm]) -> GmmHmm:
    """Stack per-word models into a single GmmHmm with a leading vocab axis.

    All models must share (S, streams, M, D) shapes and covariance types.
    """
    if not models:
        raise ValueError("stack_models: empty vocabulary")
    first = models[0]
    for m in models[1:]:
        if (
            m.num_states != first.num_states
            or m.mixture_numbers != first.mixture_numbers
            or m.coef_numbers != first.coef_numbers
        ):
            raise ValueError(
                "stack_models requires homogeneous model shapes; "
                f"{m.word}: {m.num_states}/{m.mixture_numbers}/{m.coef_numbers} vs "
                f"{first.word}: {first.num_states}/{first.mixture_numbers}/{first.coef_numbers}"
            )
        if [s.cov_type for s in m.streams] != [s.cov_type for s in first.streams]:
            raise ValueError("stack_models requires homogeneous covariance types")
    streams = []
    for p, st in enumerate(first.streams):
        parts = [m.streams[p] for m in models]
        streams.append(
            GmmStream(
                weights=torch.stack([s.weights for s in parts]),
                means=torch.stack([s.means for s in parts]),
                inv_cov=torch.stack([s.inv_cov for s in parts]),
                det=torch.stack([s.det for s in parts]),
                cov_type=st.cov_type,
                log_det=torch.stack([s.log_det for s in parts]),
            )
        )
    return GmmHmm(
        trans=torch.stack([m.trans for m in models]),
        streams=streams,
        word=tuple(m.word for m in models),
    )


def pad_stack_models(models: Sequence[GmmHmm]) -> tuple[GmmHmm, torch.Tensor]:
    """Stack per-word models of HETEROGENEOUS shapes into one GmmHmm.

    Every model is padded to the max (S, M) per stream:

      * filler STATES are unreachable (their trans rows are a self-loop 1.0
        only, and no real state reaches them), so both scoring modes are
        unaffected, but the FINAL state of a padded word is no longer index
        S_max-1: final-state scoring gathers the returned ``final_states``;
      * filler MIXTURES get weight 0 with benign identity covariances.

    Feature dims must match across models.  Returns (stacked GmmHmm, (W,)
    int32 final-state indices), on the CPU.
    """
    if not models:
        raise ValueError("pad_stack_models: empty vocabulary")
    n_streams = models[0].num_streams
    for m in models[1:]:
        if m.num_streams != n_streams:
            raise ValueError("pad_stack_models: stream counts differ")
        if m.coef_numbers != models[0].coef_numbers:
            raise ValueError(
                "pad_stack_models: feature dims differ "
                f"({m.word}: {m.coef_numbers} vs {models[0].coef_numbers})"
            )
    s_max = max(m.num_states for m in models)
    m_max = [max(m.streams[p].num_mixtures for m in models) for p in range(n_streams)]

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    padded = []
    for m in models:
        S = m.num_states
        dtype = host(m.trans).dtype
        trans = np.zeros((s_max, s_max), dtype)
        trans[:S, :S] = host(m.trans)
        for s in range(S, s_max):
            trans[s, s] = 1.0  # unreachable self-loop keeps rows stochastic
        new_streams = []
        for p, st in enumerate(m.streams):
            M, D = st.num_mixtures, st.dim
            Mx = m_max[p]
            w = np.zeros((s_max, Mx), dtype)
            w[:S, :M] = host(st.weights)
            w[S:, 0] = 1.0  # filler states: benign unit weight on mixture 0
            mu = np.zeros((s_max, Mx, D), dtype)
            mu[:S, :M] = host(st.means)
            det = np.ones((s_max, Mx), dtype)
            det[:S, :M] = host(st.det)
            ld = np.zeros((s_max, Mx), dtype)  # filler: log|det| of 1
            ld[:S, :M] = host(st.log_abs_det())
            if st.cov_type == FULL:
                ic = np.tile(np.eye(D, dtype=dtype), (s_max, Mx, 1, 1))
            else:
                ic = np.ones((s_max, Mx, D), dtype)
            ic[:S, :M] = host(st.inv_cov)
            new_streams.append(
                GmmStream(weights=w, means=mu, inv_cov=ic, det=det, cov_type=st.cov_type, log_det=ld)
            )
        padded.append(GmmHmm(trans=trans, streams=new_streams, word=m.word))
    stacked = stack_models(padded)
    final_states = torch.tensor([m.num_states - 1 for m in models], dtype=torch.int32)
    return stacked, final_states


def init_left_right_trans(
    states_number: int, delta: int = 1, dtype: torch.dtype = torch.float64, device="cpu"
) -> torch.Tensor:
    """Uniform banded left-right transition matrix.

    Replicates ``init_transition_probab`` (T1:772-791): row i is uniform over
    states [i, min(i+delta, S-1)], zero elsewhere.
    """
    i = np.arange(states_number)[:, None]
    j = np.arange(states_number)[None, :]
    allowed = (j >= i) & (j <= i + delta)
    width = np.minimum(delta + 1, states_number - np.arange(states_number))
    trans = np.where(allowed, 1.0 / width[:, None], 0.0)
    return torch.as_tensor(trans, dtype=dtype, device=device)


def validate_model(model: GmmHmm, atol: float = 1e-3) -> list[str]:
    """Stochasticity sanity checks mirroring the reference's printf warnings
    (row sums T1:1926, mixture-coefficient sums T1:1997-1998).  Returns a
    list of human-readable violations (empty = OK)."""
    problems = []
    row_sums = model.trans.detach().cpu().numpy().sum(axis=-1)
    bad = np.abs(row_sums - 1.0) > atol
    if bad.any():
        problems.append(f"transition row sums off: {row_sums[bad]}")
    for si, s in enumerate(model.streams):
        w_sums = s.weights.detach().cpu().numpy().sum(axis=-1)
        badw = np.abs(w_sums - 1.0) > atol
        if badw.any():
            problems.append(f"stream {si} mixture weight sums off: {w_sums[badw]}")
    return problems


def denormalize_stream(stream: GmmStream, mean, std) -> GmmStream:
    """Map a stream trained on y = (x - mean)/std back to raw feature space
    (the exact inverse affine transform):

        mu_x = std * mu_y + mean
        Sigma_x^{-1} = S^{-1} Sigma_y^{-1} S^{-1}      (S = diag(std))
        log|Sigma_x| = log|Sigma_y| + 2 sum log std

    With features.frontend.global_cmvn_stats this makes the fast trainer's
    normalized-space EM export raw-space .hmm models."""
    dtype, device = stream.means.dtype, stream.means.device
    m = torch.as_tensor(mean, dtype=dtype, device=device)
    s = torch.as_tensor(std, dtype=dtype, device=device)
    means = stream.means * s + m
    if stream.cov_type == FULL:
        inv_cov = stream.inv_cov / (s[:, None] * s[None, :])
    else:
        inv_cov = stream.inv_cov / (s * s)
    # log-space determinant update avoids overflowing the linear det
    log_std = torch.log(torch.as_tensor(std, dtype=torch.float64, device=device))
    log_det = stream.log_abs_det() + 2.0 * torch.sum(log_std.to(dtype))
    return GmmStream(
        weights=stream.weights,
        means=means,
        inv_cov=inv_cov,
        det=torch.exp(log_det),
        cov_type=stream.cov_type,
        log_det=log_det,
    )


def denormalize_model(model: GmmHmm, stats) -> GmmHmm:
    """denormalize_stream over every stream; stats: list of (mean, std) per
    stream (or a single pair for single-stream models)."""
    if not isinstance(stats, list):
        stats = [stats]
    return GmmHmm(
        trans=model.trans,
        streams=[denormalize_stream(st, m, s) for st, (m, s) in zip(model.streams, stats)],
        word=model.word,
    )
