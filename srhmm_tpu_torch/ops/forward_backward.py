"""Forward recursions (counterpart of ``srhmm_tpu/ops/forward_backward.py``).

* **log path**: the log-space forward recursion, mask-aware for padded
  batches.  Score equivalences with the reference's scaled recursion:

      total-probability score  (-sum log c_t)            == logsumexp_i log_alpha[T-1, i]
      final-state score (-sum log c_t + log a^[S-1][T-1]) == log_alpha[T-1, S-1]

* **parity path**: the scaled probability-domain recursion exactly as the C
  does it, float64, with per-frame normalization c_t = 1 / sum_i alpha_i.

The JAX ``lax.scan`` is a Python loop over time here, and its ``vmap`` over
words or utterances is a leading batch axis: every function accepts extra
leading axes before (T, S).
"""

from __future__ import annotations

import torch

from ..models.gmm_hmm import BETA_INF_CLAMP

# ---------------------------------------------------------------------------
# log path
# ---------------------------------------------------------------------------


def log_forward(
    log_b: torch.Tensor, log_trans: torch.Tensor, length: torch.Tensor | None = None
) -> torch.Tensor:
    """Log-space forward recursion.

    log_b: (..., T, S) per-state emission log-likelihoods; log_trans:
    (..., S, S), broadcastable against log_b's leading axes.  The initial
    state is state 0.  length: optional number of valid frames,
    broadcastable to the leading axes; steps t >= length carry log_alpha
    through unchanged, so the result is log_alpha at the last valid frame.

    Returns log_alpha_final: (..., S).
    """
    T, S = log_b.shape[-2:]
    start = torch.full((S,), -torch.inf, dtype=log_b.dtype, device=log_b.device)
    start[0] = 0.0
    carry = start + log_b[..., 0, :]
    if length is not None:
        length = torch.as_tensor(length, device=log_b.device)[..., None]
    for t in range(1, T):
        new = torch.logsumexp(carry[..., :, None] + log_trans, dim=-2) + log_b[..., t, :]
        if length is not None:
            new = torch.where(t < length, new, carry)
        carry = new
    return carry


def log_forward_full(
    log_b: torch.Tensor, log_trans: torch.Tensor, length: torch.Tensor | None = None
) -> torch.Tensor:
    """Like log_forward but returns the whole (..., T, S) log-alpha lattice
    (needed by EM).  Rows at t >= length repeat the last valid row."""
    T, S = log_b.shape[-2:]
    start = torch.full((S,), -torch.inf, dtype=log_b.dtype, device=log_b.device)
    start[0] = 0.0
    carry = start + log_b[..., 0, :]
    if length is not None:
        length = torch.as_tensor(length, device=log_b.device)[..., None]
    rows = [carry]
    for t in range(1, T):
        new = torch.logsumexp(carry[..., :, None] + log_trans, dim=-2) + log_b[..., t, :]
        if length is not None:
            new = torch.where(t < length, new, carry)
        carry = new
        rows.append(carry)
    return torch.stack(rows, dim=-2)


def log_backward_full(
    log_b: torch.Tensor,
    log_trans: torch.Tensor,
    length: torch.Tensor | None = None,
    final_state_only: bool = True,
) -> torch.Tensor:
    """Log-space backward recursion, (..., T, S) log-beta lattice.

    final_state_only=True matches the reference's initialization
    beta[S-1][T-1] = 1, else 0 (T1:1511-1513) — the model must end in the
    final state.  With padding, the "last frame" is length-1: positions
    t >= length hold the initial condition and the recursion starts there.
    """
    T, S = log_b.shape[-2:]
    if final_state_only:
        beta_T = torch.full((S,), -torch.inf, dtype=log_b.dtype, device=log_b.device)
        beta_T[S - 1] = 0.0
    else:
        beta_T = torch.zeros((S,), dtype=log_b.dtype, device=log_b.device)
    if length is None:
        length = T
    last = torch.as_tensor(length, device=log_b.device)[..., None] - 1
    carry = beta_T.expand(log_b.shape[:-2] + (S,))
    rows = [carry]
    for t in range(T - 2, -1, -1):  # computing beta[t] from beta[t+1]
        new = torch.logsumexp(log_trans + (log_b[..., t + 1, :] + carry)[..., None, :], dim=-1)
        # t >= last: stay at the initial condition until the recursion
        # "begins" at the last valid frame
        carry = torch.where(t < last, new, beta_T)
        rows.append(carry)
    return torch.stack(rows[::-1], dim=-2)


def score_total(log_alpha_final: torch.Tensor) -> torch.Tensor:
    """Total-probability score: R1's -sum log c_t."""
    return torch.logsumexp(log_alpha_final, dim=-1)


def score_final_state(log_alpha_final: torch.Tensor) -> torch.Tensor:
    """Final-state score: trainer/R2's -sum log c_t + log a^[S-1][T-1]."""
    return log_alpha_final[..., -1]


# ---------------------------------------------------------------------------
# parity path (scaled probability domain, float64)
# ---------------------------------------------------------------------------


def scaled_forward_parity(b: torch.Tensor, trans: torch.Tensor):
    """The reference's scaled forward recursion (T1:1414-1473), float64.

    b: (..., T, S) per-state symbol probabilities (product over streams);
    trans: (..., S, S).  Returns (alpha: (..., T, S) scaled, scaling: (..., T))
    with scaling[t] = 1 / sum_i alpha_raw[t, i] exactly as the C stores it.
    """
    b = b.to(torch.float64)
    trans = trans.to(torch.float64)
    T, S = b.shape[-2:]
    pi = torch.zeros((S,), dtype=torch.float64, device=b.device)
    pi[0] = 1.0

    a_raw = pi * b[..., 0, :]
    c = 1.0 / torch.sum(a_raw, dim=-1)
    a = a_raw * c[..., None]
    alphas, cs = [a], [c]
    for t in range(1, T):
        a_raw = torch.matmul(a[..., None, :], trans)[..., 0, :] * b[..., t, :]
        c = 1.0 / torch.sum(a_raw, dim=-1)
        a = a_raw * c[..., None]
        alphas.append(a)
        cs.append(c)
    return torch.stack(alphas, dim=-2), torch.stack(cs, dim=-1)


def scaled_backward_parity(b: torch.Tensor, trans: torch.Tensor, scaling: torch.Tensor):
    """The reference's scaled backward recursion (T1:1493-1543), float64,
    final-state initialization and the isinf -> 1e200 clamp (T1:1540).

    b: (..., T, S); trans: (..., S, S); scaling: (..., T) from the forward
    pass.  Returns beta: (..., T, S) scaled with the forward factors."""
    b = b.to(torch.float64)
    trans = trans.to(torch.float64)
    T, S = b.shape[-2:]
    unit = torch.zeros((S,), dtype=torch.float64, device=b.device)
    unit[S - 1] = 1.0
    beta = unit * scaling[..., T - 1, None]
    betas = [beta]
    for t in range(T - 2, -1, -1):  # computing beta[t] from beta[t+1]
        new = torch.matmul(trans, (beta * b[..., t + 1, :])[..., None])[..., 0]
        new = new * scaling[..., t, None]
        beta = torch.where(torch.isinf(new), BETA_INF_CLAMP, new)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=-2)


def parity_score_total(scaling: torch.Tensor) -> torch.Tensor:
    """R1 calc_probability: -sum log c_t."""
    return -torch.sum(torch.log(scaling), dim=-1)


def parity_score_final_state(scaling: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """T1/R2 calc_probability: -sum log c_t + log alpha_scaled[T-1, S-1]."""
    return -torch.sum(torch.log(scaling), dim=-1) + torch.log(alpha[..., -1, -1])
