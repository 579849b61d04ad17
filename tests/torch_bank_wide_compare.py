"""Times of the composed bank kernels at full covariance D = 39 (needs a
CUDA card; not a tier-1 test):

    PYTHONPATH=TREE python tests/torch_bank_wide_compare.py time

The batch and start model of chip_smoke.py's emb_full39 cell (40 units of
3 states, M = 8 full covariance at D = 39, B = 512 utterances of 12 units,
400-512 frames, seeded), built by chip_smoke.py's own functions; log b,
the lattices and gamma from the kernels of the package on PYTHONPATH (this
checkout's, or another one unpacked with git archive).  Then, for
bank_emission (#9), bank_moments_lattice (#12) and bank_moments (#13):
CUDA-event medians of 20 after 3 warm-ups, each call's kernels' device
time (chip_smoke.kernel_device_ms over 5 calls a kernel), and the
moments on an all-zero gamma (the scan, set-up and pass 2 alone) and on
a gamma 1 / LS at every frame t < length (no tile skipped).  One JSON line with the card's name and
power limit.  Run two trees in one call, in the order parent, change,
change, parent, to compare them.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.append(str(Path(__file__).resolve().parents[1]))  # chip_smoke.py; the package comes from PYTHONPATH

KERNELS = {"bank_emission": ("bank_emission",), "bank_moments_lattice": ("chunk_table", "bank_moments", "sum_chunks"),
           "bank_moments": ("chunk_table", "bank_moments", "sum_chunks")}


def emb_full39_inputs():
    """emb_full39's ids, bank, features, lengths and diagonals on the card."""
    import chip_smoke as cs
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models

    P, S, M, D, B, L, t_range = cs.EMB_FULL39
    rng = np.random.default_rng(4439)
    units = [(cs.left_right_trans(S, 4.0), [cs.rand_stream(rng, S, M, D, "full")]) for _ in range(P)]
    models = stack_models([gmm_hmm_from_numpy(t, st, f"ph{i:02d}") for i, (t, st) in enumerate(units)])
    W = np.stack([st[0]["weights"] for _, st in units]).reshape(P * S, M)
    MU = np.stack([st[0]["means"] for _, st in units]).reshape(P * S, M, D)
    trs = rng.integers(0, P, size=(B, L))
    rows = (trs[:, :, None] * S + np.arange(S)).reshape(B, L * S)
    utts = cs.composed_dataset(rng, W, MU, np.ones((P * S, M, D)), rows, B, t_range)
    transcripts, feats, lengths = cs.pad_batch(torch, utts, trs)
    models = models.astype(torch.float32).to("cuda")
    return (*cs.composed_inputs(torch, models, transcripts, feats, lengths), feats, lengths)


def device_ms(cs, fn, keys, calls=5):
    """The device time of one call of fn: the sum over keys of each
    kernel's per-launch device time (chip_smoke.kernel_device_ms, one
    launch a call); None if a key's profiler windows never saw one launch
    a call."""
    per = [cs.kernel_device_ms(torch, fn, key, calls)[0] for key in keys]
    return None if any(v is None for v in per) else float(sum(per))


def time_kernels() -> dict:
    import chip_smoke as cs
    from srhmm_tpu_torch.ops.kernels import composed as kc
    from srhmm_tpu_torch.ops.kernels.common import NEG_INF

    ids, banks, diag_row, diag_col, full, feats, lengths = emb_full39_inputs()
    lb = kc.bank_emission(ids, banks, feats, full)
    la = kc.composed_forward(lb, diag_col, lengths)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    gamma = kc.composed_backward_stats(lb, la, diag_row, lengths, torch.where(valid, log_z, 0.0),
                                       valid.to(torch.float32))[0]
    gamma_bst = gamma.permute(2, 1, 0).contiguous()
    on = torch.arange(gamma.shape[0], device=gamma.device)[:, None, None] < lengths[None, None, :]
    calls = {
        "bank_emission": lambda: kc.bank_emission(ids, banks, feats, full),
        "bank_moments_lattice": lambda: kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full),
        "bank_moments": lambda: kc.bank_moments(ids, banks, feats, gamma_bst, lengths, full),
        "moments_zero_gamma": lambda: kc.bank_moments_lattice(ids, banks, feats, torch.zeros_like(gamma), lengths,
                                                              full),
        "moments_dense_gamma": lambda: kc.bank_moments_lattice(
            ids, banks, feats, on.expand_as(gamma).to(torch.float32) / gamma.shape[1], lengths, full),
    }
    out = {}
    for name, fn in calls.items():
        out[name] = {"ms": cs.median_ms(torch, fn)}
        if name in KERNELS:
            out[name]["device_ms"] = device_ms(cs, fn, KERNELS[name])
    out["moment_tiles"] = cs.moment_tiles(torch, gamma, lengths)
    if hasattr(kc, "wide_occupancy"):
        out["blocks_per_sm"] = kc.wide_occupancy(feats.shape[-1])
    return out


def main(argv) -> int:
    if argv[:1] != ["time"]:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    import srhmm_tpu_torch

    print(json.dumps({"tree": str(Path(srhmm_tpu_torch.__file__).resolve().parents[1]), "card": smi,
                      **time_kernels()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
