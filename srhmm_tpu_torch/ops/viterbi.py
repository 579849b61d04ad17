"""Viterbi decoding (counterpart of ``srhmm_tpu/ops/viterbi.py``).

A max-plus forward loop carrying per-state best log-scores and a (T-1, S)
backpointer lattice, traced back afterwards.  Mask-aware for padded
batches.  In this package it is the oracle for the scoring kernel's
(max, +) semiring.
"""

from __future__ import annotations

import torch


def viterbi(
    log_b: torch.Tensor,
    log_trans: torch.Tensor,
    length: int | torch.Tensor | None = None,
    final_state_only: bool = True,
):
    """Single-utterance Viterbi.

    log_b: (T, S), log_trans: (S, S); start state fixed to 0.  Returns
    (best_score, path (T,) int32).

    final_state_only: score/backtrace from the last state; False takes the
    argmax end state.  Padded steps (t >= length) carry scores unchanged and
    store backpointer j -> j, so backtrace through padding is the identity.
    """
    T, S = log_b.shape
    carry = torch.full((S,), -torch.inf, dtype=log_b.dtype, device=log_b.device)
    carry[0] = 0.0
    carry = carry + log_b[0]
    idint = torch.arange(S, dtype=torch.int32, device=log_b.device)
    bptrs = []
    for t in range(1, T):
        cand = carry[:, None] + log_trans  # (from, to)
        best, best_prev = torch.max(cand, dim=0)
        best_prev = best_prev.to(torch.int32)
        new = best + log_b[t]
        if length is not None and not t < length:
            new, best_prev = carry, idint
        carry = new
        bptrs.append(best_prev)
    if final_state_only:
        end_state = S - 1
        best_score = carry[S - 1]
    else:
        end_state = int(torch.argmax(carry))
        best_score = torch.max(carry)
    path = [end_state]
    for bp in reversed(bptrs):
        path.append(int(bp[path[-1]]))
    return best_score, torch.tensor(path[::-1], dtype=torch.int32)


def viterbi_batch(log_b, log_trans, lengths, final_state_only: bool = True):
    """Viterbi over a padded batch: log_b (B, T, S), lengths (B,).
    Returns (scores (B,), paths (B, T) int32)."""
    out = [
        viterbi(lb, log_trans, int(ln), final_state_only)
        for lb, ln in zip(log_b, lengths)
    ]
    return torch.stack([s for s, _ in out]), torch.stack([p for _, p in out])
