from .frontend import (
    FrontendConfig,
    add_deltas,
    cmvn,
    dft_matrices,
    frame_signal,
    global_cmvn_stats,
    log_mel,
    mel_filterbank,
    mfcc,
)

__all__ = [
    "FrontendConfig",
    "add_deltas",
    "cmvn",
    "dft_matrices",
    "frame_signal",
    "global_cmvn_stats",
    "log_mel",
    "mel_filterbank",
    "mfcc",
]
