from .convert import gmm_hmm_from_numpy, gmm_hmm_to_numpy
from .gmm_hmm import (
    DIAG,
    FULL,
    GmmHmm,
    GmmStream,
    init_left_right_trans,
    pad_stack_models,
    stack_models,
)

__all__ = [
    "DIAG",
    "FULL",
    "GmmHmm",
    "GmmStream",
    "gmm_hmm_from_numpy",
    "gmm_hmm_to_numpy",
    "init_left_right_trans",
    "pad_stack_models",
    "stack_models",
]
