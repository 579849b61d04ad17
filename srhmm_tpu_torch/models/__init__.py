from .convert import gmm_hmm_from_numpy, gmm_hmm_to_numpy
from .gmm_hmm import (
    DIAG,
    FULL,
    GmmHmm,
    GmmStream,
    denormalize_model,
    denormalize_stream,
    init_left_right_trans,
    pad_stack_models,
    stack_models,
    validate_model,
)

__all__ = [
    "DIAG",
    "FULL",
    "GmmHmm",
    "GmmStream",
    "denormalize_model",
    "denormalize_stream",
    "gmm_hmm_from_numpy",
    "gmm_hmm_to_numpy",
    "init_left_right_trans",
    "pad_stack_models",
    "stack_models",
    "validate_model",
]
