from .common import LOG_GAUS_CLAMP, NEG_INF, trans_band
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
    "pack_batch",
    "pack_vocab_constants",
    "score_batch_fused",
    "scores_from_log_alpha",
    "trans_band",
    "vocab_scores",
    "vocab_scores_plain",
]
