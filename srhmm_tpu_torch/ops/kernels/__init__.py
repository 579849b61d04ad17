from .common import LOG_GAUS_CLAMP, NEG_INF, trans_band
from .emission import (
    emission_log_b,
    emission_log_b_plain,
    emission_stats,
    emission_stats_plain,
    log_state_emission_fused,
    pack_constants,
)
from .forward import (
    backtrace,
    log_forward_batch,
    log_forward_batch_plain,
    viterbi_batch,
    viterbi_batch_plain,
)
from .lattice import (
    backward_lattice,
    backward_lattice_blocked,
    backward_lattice_plain,
    forward_lattice,
    forward_lattice_blocked,
    forward_lattice_plain,
)
from .scoring import (
    pack_batch,
    pack_vocab_constants,
    score_batch_fused,
    scores_from_log_alpha,
    vocab_scores,
    vocab_scores_plain,
)

__all__ = [
    "LOG_GAUS_CLAMP",
    "NEG_INF",
    "backtrace",
    "backward_lattice",
    "backward_lattice_blocked",
    "backward_lattice_plain",
    "emission_log_b",
    "emission_log_b_plain",
    "emission_stats",
    "emission_stats_plain",
    "forward_lattice",
    "forward_lattice_blocked",
    "forward_lattice_plain",
    "log_forward_batch",
    "log_forward_batch_plain",
    "log_state_emission_fused",
    "pack_batch",
    "pack_constants",
    "pack_vocab_constants",
    "score_batch_fused",
    "scores_from_log_alpha",
    "trans_band",
    "viterbi_batch",
    "viterbi_batch_plain",
    "vocab_scores",
    "vocab_scores_plain",
]
