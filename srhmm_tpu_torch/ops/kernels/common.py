"""Constants and host-side helpers shared by the kernels (counterparts of
``srhmm_tpu/ops/pallas/fused_em_pallas.py:59-61`` and ``trans_band``)."""

from __future__ import annotations

import math

import numpy as np

from ...models.gmm_hmm import GAUS_INF_CLAMP

NEG_INF = -1e30  # finite log-domain floor every recursion clamps to
_TINY = 1e-38  # smallest f32 normal-ish; log argument guard
LOG_GAUS_CLAMP = math.log(GAUS_INF_CLAMP)  # calc_gaus 1e20 clamp, T1:1880-1883


def trans_band(trans) -> int | None:
    """Band width of a (stack of) transition matrices: the smallest ``band``
    with trans[i, j] == 0 outside 0 <= j - i <= band, or None if
    lower-triangular entries exist (not left-right)."""
    t = np.asarray(trans)
    S = t.shape[-1]
    nz = np.argwhere(t.reshape(-1, S, S).sum(0) != 0)
    d = nz[:, 1] - nz[:, 0]
    if (d < 0).any():
        return None
    return int(d.max())
