from .scorer import (
    FINAL,
    TOTAL,
    rank,
    rank_c_parity,
    score_batch,
    score_batch_log,
    score_vocab_log,
    score_vocab_parity,
)

__all__ = [
    "FINAL",
    "TOTAL",
    "rank",
    "rank_c_parity",
    "score_batch",
    "score_batch_log",
    "score_vocab_log",
    "score_vocab_parity",
]
