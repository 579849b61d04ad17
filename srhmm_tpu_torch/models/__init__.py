from .convert import gmm_hmm_from_numpy, gmm_hmm_to_numpy, tied_hmm_set_from_numpy
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
from .tying import TiedHmmSet, tie_from_models, untied_state_map

__all__ = [
    "DIAG",
    "FULL",
    "GmmHmm",
    "GmmStream",
    "TiedHmmSet",
    "denormalize_model",
    "denormalize_stream",
    "gmm_hmm_from_numpy",
    "gmm_hmm_to_numpy",
    "init_left_right_trans",
    "pad_stack_models",
    "stack_models",
    "tie_from_models",
    "tied_hmm_set_from_numpy",
    "untied_state_map",
    "validate_model",
]
