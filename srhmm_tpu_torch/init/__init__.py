from .lbg import create_initial_model, init_mix_mean, init_stream
from .segmentation import segment_bounds, segment_ids

__all__ = [
    "create_initial_model",
    "init_mix_mean",
    "init_stream",
    "segment_bounds",
    "segment_ids",
]
