"""Forward recursions (counterpart of ``srhmm_tpu/ops/forward_backward.py``).

* **log path**: the log-space forward recursion, mask-aware for padded
  batches.  Score equivalences with the reference's scaled recursion:

      total-probability score  (-sum log c_t)            == logsumexp_i log_alpha[T-1, i]
      final-state score (-sum log c_t + log a^[S-1][T-1]) == log_alpha[T-1, S-1]

* **parity path**: the scaled probability-domain recursion exactly as the C
  does it, float64, with per-frame normalization c_t = 1 / sum_i alpha_i.

The JAX ``lax.scan`` is a Python loop over time here, and its ``vmap`` over
words or utterances is a leading batch axis: every function accepts extra
leading axes before (T, S).  The backward passes belong to training and are
not ported yet.
"""

from __future__ import annotations

import torch

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


def parity_score_total(scaling: torch.Tensor) -> torch.Tensor:
    """R1 calc_probability: -sum log c_t."""
    return -torch.sum(torch.log(scaling), dim=-1)


def parity_score_final_state(scaling: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """T1/R2 calc_probability: -sum log c_t + log alpha_scaled[T-1, S-1]."""
    return -torch.sum(torch.log(scaling), dim=-1) + torch.log(alpha[..., -1, -1])
