"""Carry model weights across between ``srhmm_tpu`` and ``srhmm_tpu_torch``.

Both directions go through numpy arrays, so neither package imports the
other: take the JAX model's leaves with ``np.asarray`` and hand them to
``gmm_hmm_from_numpy``; ``gmm_hmm_to_numpy`` gives back the same leaves.
A stream is a dict with the keys ``weights, means, inv_cov, det, log_det,
cov_type`` (``log_det`` may be None: it is then derived from ``det`` in
float64).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .gmm_hmm import GmmHmm, GmmStream


def gmm_hmm_from_numpy(trans, streams: Sequence[dict], word="") -> GmmHmm:
    """Build a CPU GmmHmm from numpy leaves; dtypes are kept as given."""
    return GmmHmm(
        trans=np.asarray(trans),
        streams=[
            GmmStream(
                weights=np.asarray(s["weights"]),
                means=np.asarray(s["means"]),
                inv_cov=np.asarray(s["inv_cov"]),
                det=np.asarray(s["det"]),
                cov_type=s["cov_type"],
                log_det=None if s.get("log_det") is None else np.asarray(s["log_det"]),
            )
            for s in streams
        ],
        word=word,
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
