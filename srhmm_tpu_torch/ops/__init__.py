from .emission import (
    log_gauss,
    log_mixture_posteriors,
    log_state_emission,
    prob_emission_parity,
    prob_gauss_parity,
    prob_state_emission_parity,
)
from .forward_backward import (
    log_backward_full,
    log_forward,
    log_forward_full,
    parity_score_final_state,
    parity_score_total,
    scaled_backward_parity,
    scaled_forward_parity,
    score_final_state,
    score_total,
)
from .kernels.emission import log_state_emission_fused
from .kernels.forward import backtrace, log_forward_batch
from .viterbi import viterbi, viterbi_batch

__all__ = [
    "log_gauss",
    "log_mixture_posteriors",
    "log_state_emission",
    "prob_emission_parity",
    "prob_gauss_parity",
    "prob_state_emission_parity",
    "log_backward_full",
    "log_forward",
    "log_forward_full",
    "parity_score_final_state",
    "parity_score_total",
    "scaled_backward_parity",
    "scaled_forward_parity",
    "score_final_state",
    "score_total",
    "viterbi",
    "viterbi_batch",
    "backtrace",
    "log_forward_batch",
    "log_state_emission_fused",
]
