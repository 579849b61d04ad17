from .continuous import (
    compose_sequence,
    compose_word_loop,
    compose_word_loop_blocks,
    decode_continuous,
    decode_continuous_batch,
)
from .scorer import (
    FINAL,
    TOTAL,
    rank,
    rank_c_parity,
    score_batch,
    score_batch_log,
    score_batch_sharded,
    score_vocab_log,
    score_vocab_parity,
)

__all__ = [
    "FINAL",
    "TOTAL",
    "compose_sequence",
    "compose_word_loop",
    "compose_word_loop_blocks",
    "decode_continuous",
    "decode_continuous_batch",
    "rank",
    "rank_c_parity",
    "score_batch",
    "score_batch_log",
    "score_batch_sharded",
    "score_vocab_log",
    "score_vocab_parity",
]
