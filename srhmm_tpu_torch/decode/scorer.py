"""Isolated-word scoring (counterpart of ``srhmm_tpu/decode/scorer.py``).

The whole vocabulary is one stacked GmmHmm with a leading word axis, and a
single batched computation scores every word at once; a batch axis over
utterances sits on top of that.  Where the JAX package vmaps, the word and
batch axes are explicit tensor axes here.

Two scoring modes, matching the two reference recognizer variants:
  * "total"  — total probability, R1 (recognition-full-fs:822-836)
  * "final"  — final-state probability, R2 (recognition-fs:820-836)
and two numerics modes: the log-space fast path and the float64
probability-domain parity path (exact reference semantics incl. clamps).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gmm_hmm import DIAG, FULL, GmmHmm
from ..ops.emission import log_state_emission, prob_emission_parity
from ..ops.forward_backward import (
    log_forward,
    parity_score_final_state,
    parity_score_total,
    scaled_forward_parity,
    score_final_state,
    score_total,
)

TOTAL = "total"
FINAL = "final"


def _read_scores(la: torch.Tensor, mode: str, final_states) -> torch.Tensor:
    """(..., W, S) final log-alpha -> (..., W) scores."""
    if mode == TOTAL:
        # padded filler states (pad_stack_models) are unreachable: their
        # log-alpha is -inf and drops out of the logsumexp
        return score_total(la)
    if final_states is None:
        return score_final_state(la)
    W = la.shape[-2]
    idx = final_states.to(device=la.device, dtype=torch.int64)
    return la[..., torch.arange(W, device=la.device), idx]


def _log_b(vocab: GmmHmm, frames_per_stream) -> torch.Tensor:
    """Per-stream (*F, T, D_p) frames -> (*F, T, W, S) summed emissions."""
    log_b = None
    for frames, stream in zip(frames_per_stream, vocab.streams):
        lb = log_state_emission(frames, (stream,))
        log_b = lb if log_b is None else log_b + lb
    return log_b


def score_vocab_log(
    vocab: GmmHmm,
    frames_per_stream,
    mode: str = TOTAL,
    length=None,
    final_states: torch.Tensor | None = None,
) -> torch.Tensor:
    """Log-space scores of one utterance against a stacked vocabulary.

    vocab: GmmHmm with leading word axis W; frames_per_stream: one (T, D_p)
    tensor per stream.  final_states: optional (W,) per-word final-state
    indices (heterogeneous vocabularies padded by pad_stack_models).
    Returns (W,) scores (higher = better).
    """
    log_b = _log_b(vocab, frames_per_stream).permute(1, 0, 2)  # (W, T, S)
    la = log_forward(log_b, vocab.log_trans(), length)
    return _read_scores(la, mode, final_states)


def score_batch_log(
    vocab: GmmHmm,
    batch,
    mode: str = TOTAL,
    final_states: torch.Tensor | None = None,
) -> torch.Tensor:
    """Score a padded utterance batch against a stacked vocabulary.

    batch: UtteranceBatch (B, T, D), or a tuple of per-stream UtteranceBatch
    objects for multi-stream vocabularies.  Returns (B, W) scores — every
    utterance against every word in one batched computation.
    """
    batches = batch if isinstance(batch, tuple) else (batch,)
    log_b = _log_b(vocab, [b.features for b in batches])  # (B, T, W, S)
    log_b = log_b.permute(0, 2, 1, 3)  # (B, W, T, S)
    la = log_forward(log_b, vocab.log_trans(), batches[0].lengths[:, None])
    return _read_scores(la, mode, final_states)


def score_batch(
    vocab: GmmHmm,
    batch,
    mode: str = TOTAL,
    final_states: torch.Tensor | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Batch scoring dispatcher.

    The hand-written scoring kernel (``ops.kernels.scoring.score_batch_fused``,
    one kernel for ALL utterances x ALL words) runs when the features are
    CUDA tensors, everything is float32, the covariance is homogeneous diag
    or full and there is one feature batch per stream; ``score_batch_log``
    otherwise.  Heterogeneous padded vocabularies pass ``final_states``;
    multi-stream vocabularies pass ``batch`` as a per-stream tuple.

    impl: None = auto; "fused" forces ``score_batch_fused`` (on CPU tensors
    it runs the kernel's plain PyTorch version); "plain" forces
    ``score_batch_log``.  "plain" is the JAX package's impl="xla".
    """
    if impl not in (None, "fused", "plain"):
        raise ValueError(f"score_batch: unknown impl {impl!r}")
    batches = batch if isinstance(batch, tuple) else (batch,)
    vocab_tensors = [vocab.trans] + [t for st in vocab.streams for t in st.buffers()]
    eligible = (
        len(vocab.streams) == len(batches)
        and len({st.cov_type for st in vocab.streams}) == 1
        and vocab.streams[0].cov_type in (DIAG, FULL)
        and all(b.features.is_cuda and b.features.dtype == torch.float32 for b in batches)
        and all(t.dtype == torch.float32 for t in vocab_tensors)
    )
    use_fused = eligible if impl is None else impl == "fused"
    if use_fused:
        from ..ops.kernels.scoring import score_batch_fused

        return score_batch_fused(vocab, batch, mode=mode, final_states=final_states)
    return score_batch_log(vocab, batch, mode=mode, final_states=final_states)


def score_vocab_parity(
    vocab: GmmHmm,
    frames_per_stream,
    mode: str = TOTAL,
    final_states: torch.Tensor | None = None,
) -> torch.Tensor:
    """Float64 probability-domain scores replicating the reference exactly.

    final_states: optional (W,) per-word final-state indices for padded
    heterogeneous vocabularies (pad_stack_models)."""
    b = prob_emission_parity(list(frames_per_stream), vocab.streams)  # (T, W, S)
    alpha, scaling = scaled_forward_parity(b.permute(1, 0, 2), vocab.trans)
    if mode == TOTAL:
        return parity_score_total(scaling)
    if final_states is None:
        return parity_score_final_state(scaling, alpha)
    W = alpha.shape[0]
    idx = final_states.to(device=alpha.device, dtype=torch.int64)
    return -torch.sum(torch.log(scaling), dim=-1) + torch.log(
        alpha[torch.arange(W, device=alpha.device), -1, idx]
    )


def rank(scores: np.ndarray) -> np.ndarray:
    """Descending-score ranking with stable ties; NaN scores rank last.

    This is the *sane* ranking for the fast path.  It intentionally differs
    from the reference for NaN inputs — see rank_c_parity.
    """
    scores = np.asarray(scores)
    # place NaNs below every finite/-inf score
    keys = np.where(np.isnan(scores), -np.inf, scores)
    nan_penalty = np.isnan(scores).astype(np.int64)  # tie-break NaNs last
    order = np.lexsort((np.arange(len(scores)), nan_penalty, -keys))
    return order


def rank_c_parity(scores: np.ndarray) -> np.ndarray:
    """The reference's `sorting_probab` bubble sort, literally (R2:968-995).

    Load-bearing quirk: `if (probab[index[i]] < probab[index[i+1]]) swap` is
    false for any comparison involving NaN, so NaN entries freeze the
    permutation around them.  With the committed full-cov models most
    cross-word scores underflow to NaN, the sort returns the *identity*
    permutation, and word 0 (vc_186...) "wins" every utterance — which is
    exactly how the golden report test/test/result/hmm-result.txt gets its
    1/13 = 7.69% accuracy.  Reproducing that report requires this sort.
    """
    scores = np.asarray(scores)
    idx = list(range(len(scores)))
    done = False
    while not done:
        done = True
        for i in range(len(scores) - 1):
            if scores[idx[i]] < scores[idx[i + 1]]:
                idx[i], idx[i + 1] = idx[i + 1], idx[i]
                done = False
    return np.asarray(idx)
