from .em import e_step_fused, e_step_lane_major
from .em_parity import THRESHOLD, TrainResult, train_word_parity

__all__ = ["THRESHOLD", "TrainResult", "e_step_fused", "e_step_lane_major", "train_word_parity"]
