"""Does tied-state EM fall at its third iteration in srhmm_tpu as in the port?

A one-off check, not a tier-1 test (it takes minutes on the CPU):

    JAX_PLATFORMS=cpu python tests/torch_tied_fall.py [B]

It builds chip_smoke.py's tied_c5 configuration from the same seed (700
triphone units of S=3 over 2000 senones, M=16, D=39 diagonal, L=10 units
an utterance, 250-304 frames, var_floor 0.1) with the batch cut to B
utterances (default 64), and runs three tied EM iterations in float32 on
the CPU through srhmm_tpu's tied_em_step (XLA, fused=False) and through
srhmm_tpu_torch's (plain, fused=False) from the same model and data.  It
prints one JSON line: both log-probability histories, whether each falls
at the third iteration, and the largest relative difference between them.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def build(B: int):
    """tied_c5's senones, transitions, state map, transcripts and padded
    features (chip_smoke.py::tied_c5_inputs, with B utterances)."""
    senones, trans, sm, trs, utts = cs.tied_c5_inputs(B)
    D = senones["means"].shape[-1]
    feats = np.zeros((B, max(len(u) for u in utts), D), np.float32)
    for i, u in enumerate(utts):
        feats[i, : len(u)] = u
    lengths = np.asarray([len(u) for u in utts], np.int32)
    return senones, trans, sm, trs.astype(np.int32), feats, lengths


def run(B: int = 64, iters: int = 3, var_floor: float = 0.1) -> dict:
    import srhmm_tpu.models as jm
    import srhmm_tpu.models.tying as jty
    import srhmm_tpu.train.tied as jt
    import srhmm_tpu_torch.train.tied as tt
    from srhmm_tpu_torch.models import tied_hmm_set_from_numpy

    senones, trans, sm, trs, feats, lengths = build(B)
    j_tied = jty.TiedHmmSet(
        senones=jm.GmmStream(weights=jnp.asarray(senones["weights"]), means=jnp.asarray(senones["means"]),
                             inv_cov=jnp.asarray(senones["inv_cov"]), det=jnp.asarray(senones["det"]),
                             cov_type="diag"),
        trans=jnp.asarray(trans), state_map=jnp.asarray(sm, jnp.int32),
    ).astype(jnp.float32)
    t_tied = tied_hmm_set_from_numpy(senones, trans, sm).astype(torch.float32)
    hist = {"srhmm_tpu": [], "srhmm_tpu_torch": []}
    for _ in range(iters):
        j_tied, lp, _ = jt.tied_em_step(j_tied, jnp.asarray(trs), jnp.asarray(feats), jnp.asarray(lengths),
                                        var_floor=var_floor, fused=False)
        hist["srhmm_tpu"].append(float(lp))
        t_tied, lp, _ = tt.tied_em_step(t_tied, torch.as_tensor(trs), torch.as_tensor(feats),
                                        torch.as_tensor(lengths), var_floor=var_floor, fused=False)
        hist["srhmm_tpu_torch"].append(float(lp))
    a, b = np.asarray(hist["srhmm_tpu"]), np.asarray(hist["srhmm_tpu_torch"])
    return {"config": "tied_c5", "B": B, "frames": int(lengths.sum()), "iterations": iters, "history": hist,
            "falls_at_iteration_3": {k: bool(v[2] < v[1]) for k, v in hist.items()},
            "max_rel_diff": float(np.max(np.abs(a - b) / np.abs(a)))}


if __name__ == "__main__":
    print(json.dumps(run(int(sys.argv[1]) if len(sys.argv) > 1 else 64)))
