"""Carry model weights across between ``srhmm_tpu`` and ``srhmm_tpu_torch``.

Both directions go through numpy arrays, so neither package imports the
other: take the JAX model's leaves with ``np.asarray`` and hand them to
``gmm_hmm_from_numpy``; ``gmm_hmm_to_numpy`` gives back the same leaves.
A stream is a dict with the keys ``weights, means, inv_cov, det, log_det,
cov_type`` (``log_det`` may be None: it is then derived from ``det`` in
float64).  A tied set goes through ``tied_hmm_set_from_numpy``: its senone
stream as such a dict, the per-unit transitions, the state map and the unit
names.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .gmm_hmm import GmmHmm, GmmStream
from .tying import TiedHmmSet


def _stream_from_numpy(s: dict) -> GmmStream:
    return GmmStream(
        weights=np.asarray(s["weights"]),
        means=np.asarray(s["means"]),
        inv_cov=np.asarray(s["inv_cov"]),
        det=np.asarray(s["det"]),
        cov_type=s["cov_type"],
        log_det=None if s.get("log_det") is None else np.asarray(s["log_det"]),
    )


def gmm_hmm_from_numpy(trans, streams: Sequence[dict], word="") -> GmmHmm:
    """Build a CPU GmmHmm from numpy leaves; dtypes are kept as given."""
    return GmmHmm(trans=np.asarray(trans), streams=[_stream_from_numpy(s) for s in streams], word=word)


def tied_hmm_set_from_numpy(senones: dict, trans, state_map, unit_names=()) -> TiedHmmSet:
    """Build a CPU TiedHmmSet from numpy leaves: the senone stream dict
    ((N, M, ...) arrays), trans (P, S, S), state_map (P, S); dtypes of the
    float leaves are kept as given."""
    return TiedHmmSet(
        senones=_stream_from_numpy(senones),
        trans=np.asarray(trans),
        state_map=np.asarray(state_map, np.int32),
        unit_names=unit_names,
    )


def gmm_hmm_to_numpy(model: GmmHmm):
    """Inverse of gmm_hmm_from_numpy: (trans, [stream dicts], word)."""

    def host(t):
        return t.detach().cpu().numpy()

    streams = [
        {
            "weights": host(s.weights),
            "means": host(s.means),
            "inv_cov": host(s.inv_cov),
            "det": host(s.det),
            "log_det": host(s.log_det),
            "cov_type": s.cov_type,
        }
        for s in model.streams
    ]
    return host(model.trans), streams, model.word
