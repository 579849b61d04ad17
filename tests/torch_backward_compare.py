"""One-off comparison on a CUDA card of two builds of the backward-
statistics kernels (not a tier-1 test):

    python tests/torch_backward_compare.py dump OUT.pt      # in each checkout
    python tests/torch_backward_compare.py compare A.pt B.pt
    python tests/torch_backward_compare.py time             # in each checkout

`dump` runs composed_backward_stats at emb_c4's and tied_c5's lattice
shapes (LS 36 / 30, B 512 / 1024, T 512 / 304, 3 diagonals) and
backward_stats at em_diag's (S=8, M=3, D=9 diagonal, band 1, B=2048
utterances of 500 frames padded to T=512) on inputs made from fixed seeds, and saves gamma, xi, den_trans,
den_mix (and backward_stats' moments).  `compare` prints, per output,
whether the two files are bitwise equal and the largest difference.
`time` prints the CUDA-event median of 20 launches of each kernel on the
same inputs, with the card's name and power limit.  The script imports only
srhmm_tpu_torch, so it runs unchanged in an older checkout (put that
checkout first on PYTHONPATH).
"""

import json
import sys

import numpy as np
import torch

NEG_INF = -1e30


def composed_inputs(seed, LS, nd, T, B):
    from srhmm_tpu_torch.ops.kernels import composed as kc

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    lens = np.minimum(rng.integers(T // 2, T + 1, size=B), T)
    lens[:3] = [T, 0, 1]
    p = rng.uniform(0.05, 1.0, size=(LS, nd, B))
    p[(np.arange(LS)[:, None] + np.arange(nd)[None, :]) >= LS] = 0.0
    p /= p.sum(1, keepdims=True)
    with np.errstate(divide="ignore"):
        row = np.maximum(np.log(p), NEG_INF).transpose(1, 0, 2)
    col = np.full_like(row, NEG_INF)
    for d in range(nd):
        col[d, d:] = row[d, : LS - d]
    log_b = torch.as_tensor(rng.normal(size=(T, LS, B)) * 3 - 10, dtype=torch.float32, device=dev)
    diag_row = torch.as_tensor(row, dtype=torch.float32, device=dev)
    diag_col = torch.as_tensor(col, dtype=torch.float32, device=dev)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    la = kc.composed_forward(log_b, diag_col, lengths)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    return log_b, la, diag_row, lengths, torch.where(valid, log_z, 0.0), valid.to(torch.float32)


def em_inputs(seed, S=8, M=3, D=9, B=2048, T=512, length=500):
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy
    from srhmm_tpu_torch.ops.kernels import fused_em as fe

    rng = np.random.default_rng(seed)
    trans = np.zeros((S, S))
    for i in range(S):
        trans[i, i : i + 2] = rng.uniform(0.2, 1.0, size=min(2, S - i))
    trans /= trans.sum(-1, keepdims=True)
    w = rng.uniform(0.5, 1.0, size=(S, M))
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    stream = {"weights": w / w.sum(-1, keepdims=True), "means": rng.normal(size=(S, M, D)) * 3,
              "inv_cov": 1.0 / var, "det": np.prod(var, -1), "cov_type": "diag"}
    model = gmm_hmm_from_numpy(trans, [stream]).astype(torch.float32).to("cuda")
    feats = (torch.as_tensor(rng.normal(size=(T, D, B)) * 3, dtype=torch.float32, device="cuda"),)
    origins = (model.streams[0].means.mean(dim=(0, 1)),)
    packed = (fe.pack_lane_constants(model.streams[0], torch.float32, origin=origins[0]),)
    lengths = torch.full((B,), length, dtype=torch.int32, device="cuda")
    lb, la = fe.emit_forward(feats, packed, origins, model.trans, lengths, 1)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    return (feats, lb, la, packed, origins, model.trans, lengths, torch.where(valid, log_z, 0.0),
            valid.to(torch.float32), 1)


def dump(path):
    from srhmm_tpu_torch.ops.kernels import composed as kc
    from srhmm_tpu_torch.ops.kernels import fused_em as fe

    out = {}
    for cell, (LS, B, T) in {"emb_c4": (36, 512, 512), "tied_c5": (30, 1024, 304)}.items():
        st = kc.composed_backward_stats(*composed_inputs(11, LS, 3, T, B))
        out.update({f"{cell}_{n}": t.cpu() for n, t in zip(("gamma", "xi", "den_trans", "den_mix"), st)})
    xi, dt, dm, moms = fe.backward_stats(*em_inputs(12))
    out.update({"em_diag_xi": xi.cpu(), "em_diag_den_trans": dt.cpu(), "em_diag_den_mix": dm.cpu(),
                "em_diag_moments": moms[0].cpu()})
    torch.save(out, path)


def median_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_kernels():
    import subprocess

    from srhmm_tpu_torch.ops.kernels import composed as kc
    from srhmm_tpu_torch.ops.kernels import fused_em as fe

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {}
    for cell, (LS, B, T) in {"emb_c4": (36, 512, 512), "tied_c5": (30, 1024, 304)}.items():
        args = composed_inputs(11, LS, 3, T, B)
        out[f"composed_backward_stats_{cell}_ms"] = median_ms(lambda: kc.composed_backward_stats(*args))
    args = em_inputs(12)
    out["backward_stats_em_diag_ms"] = median_ms(lambda: fe.backward_stats(*args))
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": fe.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    for k in sorted(a):
        diff = float((a[k].double() - b[k].double()).abs().max())
        print(json.dumps({"output": k, "bitwise_equal": bool(torch.equal(a[k], b[k])), "max_abs_diff": diff,
                          "scale": float(b[k].abs().max())}), flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif sys.argv[1] == "time":
        time_kernels()
    else:
        compare(sys.argv[2], sys.argv[3])
