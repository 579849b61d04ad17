from .em_parity import THRESHOLD, TrainResult, train_word_parity

__all__ = ["THRESHOLD", "TrainResult", "train_word_parity"]
