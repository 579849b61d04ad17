"""One composed EM iteration at emb_c4 and at tied_c5, timed in one checkout on
a CUDA card (not a tier-1 test):

    PYTHONPATH=<checkout> python tests/torch_iteration_compare.py

Builds the inputs the way that checkout's chip_smoke.py builds them (emb_c4:
40 units, S=3, M=32, D=13, B=512; tied_c5: 700 triphones over 2000 senones,
M=16, D=39, B=1024), from the same seeds, and prints one JSON line: the
CUDA-event medians of 20 fused iterations (embedded_em_step / tied_em_step,
fused=True) and, from torch.profiler over one iteration, the device's busy
time and idle share.  Run it in two checkouts in one call (parent, change,
change, parent) to compare them on one card.
"""

import json
import subprocess

import numpy as np
import torch

import chip_smoke as cs


def emb_c4():
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models
    from srhmm_tpu_torch.train import embedded as emb

    P, S, M, D, B, L = 40, 3, 32, 13, 512, 12
    rng = np.random.default_rng(44)  # chip_smoke.phase_embedded's draws, in its order
    units = [(cs.left_right_trans(S, 4.0), [cs.rand_stream(rng, S, M, D, "diag")]) for _ in range(P)]
    models = stack_models([gmm_hmm_from_numpy(t, st, f"ph{i:02d}") for i, (t, st) in enumerate(units)])
    W = np.stack([st[0]["weights"] for _, st in units]).reshape(P * S, M)
    MU = np.stack([st[0]["means"] for _, st in units]).reshape(P * S, M, D)
    K = np.stack([st[0]["inv_cov"] for _, st in units]).reshape(P * S, M, D)
    trs = rng.integers(0, P, size=(B, L))
    rows = (trs[:, :, None] * S + np.arange(S)).reshape(B, L * S)
    utts = cs.composed_dataset(rng, W, MU, K, rows, B, (400, 513))
    transcripts, feats, lengths = cs.pad_batch(torch, utts, trs)
    start = models.astype(torch.float32).to("cuda")
    return lambda: emb.embedded_em_step(start, transcripts, feats, lengths, fused=True)


def tied_c5():
    from srhmm_tpu_torch.models import tied_hmm_set_from_numpy
    from srhmm_tpu_torch.train import tied as tt

    P, S, N, M, D, B, L = cs.TIED_C5
    senones, trans, sm, trs, utts = cs.tied_c5_inputs(B)
    tied0 = tied_hmm_set_from_numpy(senones, trans, sm, tuple(f"t{i:03d}" for i in range(P)))
    transcripts, feats, lengths = cs.pad_batch(torch, utts, trs)
    start = tied0.astype(torch.float32).to("cuda")
    return lambda: tt.tied_em_step(start, transcripts, feats, lengths, var_floor=cs.TIED_C5_VAR_FLOOR, fused=True)


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"checkout": cs.ROOT.name, "card": card}
    for cell, make in (("emb_c4", emb_c4), ("tied_c5", tied_c5)):
        step = make()
        ms = cs.median_ms(torch, step)
        prof = cs.profile_window(torch, step, kernel_keys=cs.COMPOSED_KERNEL_NAMES)
        out[cell] = {"iteration_ms": ms, "device_busy_ms": prof["device_busy_ms"],
                     "kernel_device_ms": prof["kernel_device_ms"], "idle_share": prof["idle_share"]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
