from .emission import (
    log_gauss,
    log_state_emission,
    prob_emission_parity,
    prob_gauss_parity,
    prob_state_emission_parity,
)
from .forward_backward import (
    log_forward,
    parity_score_final_state,
    parity_score_total,
    scaled_forward_parity,
    score_final_state,
    score_total,
)
from .viterbi import viterbi, viterbi_batch

__all__ = [
    "log_gauss",
    "log_state_emission",
    "prob_emission_parity",
    "prob_gauss_parity",
    "prob_state_emission_parity",
    "log_forward",
    "parity_score_final_state",
    "parity_score_total",
    "scaled_forward_parity",
    "score_final_state",
    "score_total",
    "viterbi",
    "viterbi_batch",
]
