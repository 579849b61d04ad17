"""tied_c5's treat_zero_det flip, kernel step vs plain step from one model
(needs a CUDA card and nvcc; not a tier-1 test):

    python tests/torch_tied_reseed.py make STATE    # writes STATE
    python tests/torch_tied_reseed.py check STATE   # reads it

`make` builds chip_smoke.py's tied_c5 model and utterances, takes one EM
step through the composed kernels and saves the model and the batch to
STATE (torch.save); both modes then take one kernel step (gamma in the
(B, LS, T) layout) and one plain step from that model and print one JSON
line: the largest means difference over the mixtures above the 1e-3 weight
floor, the states beyond 2e-3 of scale, and for those the mixtures the
M-step re-seeds (log det below log 1e-20) on each side and the donor.
Running `check` in a checkout of another commit, on the same STATE, holds
that commit's kernels to the same model.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from srhmm_tpu_torch.models import tied_hmm_set_from_numpy  # noqa: E402
from srhmm_tpu_torch.train import em  # noqa: E402
from srhmm_tpu_torch.train import tied as tt  # noqa: E402


def make(state: Path) -> None:
    senones, trans, sm, trs, utts = cs.tied_c5_inputs(cs.TIED_C5[5])
    tied0 = tied_hmm_set_from_numpy(senones, trans, sm, tuple(f"t{i:03d}" for i in range(len(trans))))
    batch = cs.pad_batch(torch, utts, trs)
    vf = cs.TIED_C5_VAR_FLOOR
    m1, _, _ = tt.tied_em_step(tied0.astype(torch.float32).to("cuda"), *batch, var_floor=vf, fused=True)
    torch.save({"m1": m1, "batch": batch, "var_floor": vf}, state)


def check(state: Path) -> dict:
    saved = torch.load(state, weights_only=False)
    m1, batch, vf = saved["m1"], saved["batch"], saved["var_floor"]
    steps = {"kernel": tt.tied_batch_stats_fused(m1, *batch, gamma_lattice=False),
             "plain": tt.tied_batch_stats(m1, *batch)}
    new, bad = {}, {}
    for tag, st in steps.items():
        new[tag] = em.update_stream(m1.senones, st[0], st[1], vf)
        # the log det before the re-seed
        log_det = em.update_stream(m1.senones, st[0], st[1], vf, zero_det_threshold=-np.inf).log_det
        bad[tag] = (log_det < em._LOG_ZERO_DET, log_det.argmax(-1))
    mask = (m1.senones.weights > 1e-3) & (new["kernel"].weights > 1e-3) & (new["plain"].weights > 1e-3)
    dmu = (new["kernel"].means - new["plain"].means).abs().amax(-1)
    scale = float(new["plain"].means.abs().max())
    far = ((dmu > 2e-3 * scale) & mask).any(-1).nonzero().flatten().tolist()
    return {"max_means_diff": float(dmu[mask].max()), "scale": scale, "states_beyond_2e-3": far,
            "reseeded": {str(s): {tag: {"mixtures": bad[tag][0][s].nonzero().flatten().tolist(),
                                        "donor": int(bad[tag][1][s])} for tag in bad} for s in far}}


def main(argv) -> None:
    mode, state = argv[0], Path(argv[1])
    cs.phase_build()
    if mode == "make":
        make(state)
    print(json.dumps(check(state)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
