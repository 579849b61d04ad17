"""Uniform time segmentation: frames -> states, the cold-start alignment.

Counterpart of ``srhmm_tpu/init/segmentation.py``, the same numpy code.

Replicates the reference's split (T1:876-898 / T1:1028-1048): each utterance
of T frames over S states gives floor(T/S) frames per state, with the
remainder distributed one frame each to the EARLIEST states.
"""

from __future__ import annotations

import numpy as np


def segment_bounds(num_frames: int, states_number: int) -> np.ndarray:
    """(S+1,) boundaries; state k owns frames [bounds[k], bounds[k+1])."""
    per = num_frames // states_number
    rem = num_frames % states_number
    sizes = np.full(states_number, per, dtype=np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def segment_ids(num_frames: int, states_number: int) -> np.ndarray:
    """(T,) state id per frame under uniform segmentation."""
    bounds = segment_bounds(num_frames, states_number)
    ids = np.zeros(num_frames, dtype=np.int64)
    for k in range(states_number):
        ids[bounds[k] : bounds[k + 1]] = k
    return ids
