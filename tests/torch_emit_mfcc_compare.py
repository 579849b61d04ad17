"""Two builds of the emit-forward kernel and of the MFCC kernel compared on a
CUDA card (not a tier-1 test):

    PYTHONPATH=<checkout> python tests/torch_emit_mfcc_compare.py dump OUT.pt
    python tests/torch_emit_mfcc_compare.py compare A.pt B.pt
    PYTHONPATH=<checkout> python tests/torch_emit_mfcc_compare.py time

The inputs are made from fixed seeds by this file and by the chip_smoke.py
beside it (loaded by path), so every checkout sees the same numbers; only
the srhmm_tpu_torch package comes from PYTHONPATH.  Run `time` in two
checkouts in one call, in the order parent, change, change, parent.

`dump` saves emit_forward's log_b and log-alpha at em_diag (S=8, M=3, D=9
diagonal, band 1, B=2048 utterances of 500 frames, T=512), em_full (S=6,
M=1, D=9 full, B=2048 of 103-213 frames), em_diag_p2 (em_diag plus a D=3,
M=2 stream) and in every case of chip_smoke.py's kernel_em phase and emit
check, and the MFCC kernel's rows (with its twin's) at mfcc_b256_10s (256
waveforms of 10 s) and on the kernel_mfcc phase's batch in every
mfcc_configs() entry.  `compare` prints, per output, whether the two files
are bitwise equal and the largest difference, and for the MFCC rows each
file's largest difference from the twin.  `time` prints the CUDA-event
medians of 20 calls of emit_forward at em_diag, em_full and em_diag_p2
and of the MFCC kernel at mfcc_b256_10s (the wrapper's host work
included) and each kernel's own device time under torch.profiler (over
five calls, per launch seen), one em_diag em_step(fused=True)
on the host clock and under torch.profiler (device busy time, idle share),
and, for reference, the same MFCC function composed of torch.fft.rfft and
two matrix products on the card (chip_smoke.py mfcc_rfft_matmul); with the
card's name and power limit.
"""

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# (S, [(M, D) per stream], cov, lengths: "500" = every utterance 500 frames
# of T=512, "fixtures" = 103-213 frames)
EM_CELLS = {
    "em_diag": (8, [(3, 9)], "diag", "500"),
    "em_full": (6, [(1, 9)], "full", "fixtures"),
    "em_diag_p2": (8, [(3, 9), (2, 3)], "diag", "500"),
}


def smoke():
    """This tree's chip_smoke.py, whatever srhmm_tpu_torch is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def em_cell(cs, name, B=2048, seed=12):
    """(model, batch, k1): a seeded model of the cell's shape, its
    utterances as an UtteranceBatch, and emit_forward's arguments."""
    from srhmm_tpu_torch.io.dataset import UtteranceBatch
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy
    from srhmm_tpu_torch.ops.kernels import fused_em as fe

    S, mixes_dims, cov, kind = EM_CELLS[name]
    rng = np.random.default_rng(seed)
    trans = cs.left_right_trans(S, 4.0)
    streams = [cs.rand_stream(rng, S, M, D, cov) for M, D in mixes_dims]
    model = gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to("cuda")
    lens = np.full(B, 500) if kind == "500" else rng.integers(103, 214, size=B)
    T = 512 if kind == "500" else int(lens.max())
    lengths = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    batches = tuple(UtteranceBatch(torch.as_tensor(rng.normal(size=(B, T, D)) * 3, dtype=torch.float32,
                                                   device="cuda"), lengths) for _, D in mixes_dims)
    feats = tuple(b.features.permute(1, 2, 0).contiguous() for b in batches)
    origins = tuple(s.means.mean(dim=(0, 1)) for s in model.streams)
    packed = tuple(fe.pack_lane_constants(s, torch.float32, origin=o) for s, o in zip(model.streams, origins))
    batch = batches[0] if len(batches) == 1 else batches
    return model, batch, (feats, packed, origins, model.trans, lengths, 1)


def mfcc_cell(cs):
    """chip_smoke.phase_timing_mfcc's inputs: 256 waveforms of 10 s."""
    from srhmm_tpu_torch.features.frontend import FrontendConfig

    cfg = FrontendConfig()
    n_waves, n = 256, 10 * cfg.sample_rate
    rng = np.random.default_rng(31)
    samples = torch.as_tensor((0.1 * rng.standard_normal(n_waves * n)).astype(np.float32), device="cuda")
    return samples, np.arange(n_waves + 1, dtype=np.int64) * n, cfg


def dump(path):
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels import mfcc as km

    cs = smoke()
    out = {}
    for name in EM_CELLS:
        _, _, k1 = em_cell(cs, name)
        lb, la = fe.emit_forward(*k1)
        out[f"{name}_log_b"], out[f"{name}_log_alpha"] = lb.cpu(), la.cpu()
        del lb, la
    for tag, (cov, band, mixes_dims, lens, S, shared) in cs.emit_cases(fe).items():
        feats, packed, origins, trans, lengths = cs.em_case(torch, cov, band, mixes_dims, lens, S=S,
                                                            shared_gaussians=shared)
        try:
            lb, la = fe.emit_forward(feats, packed, origins, trans, lengths, band)
        except ValueError as e:  # a shape this checkout refuses
            print(json.dumps({"case": tag, "refused": str(e)}), flush=True)
            continue
        out[f"{tag}_log_b"], out[f"{tag}_log_alpha"] = lb.cpu(), la.cpu()
    samples, offsets, cfg = mfcc_cell(cs)
    out["mfcc_b256_10s"] = km.mfcc_fused(samples, offsets, cfg).cpu()
    out["mfcc_b256_10s_twin"] = km.mfcc_plain(samples, offsets, cfg).cpu()
    for name, (cfg, waves) in cs.mfcc_check_inputs().items():
        samples, offsets = km.pack_waves(waves, "cuda")
        out[f"mfcc_{name}"] = km.mfcc_fused(samples, offsets, cfg).cpu()
        out[f"mfcc_{name}_twin"] = km.mfcc_plain(samples, offsets, cfg).cpu()
    torch.save(out, path)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    equal = 0
    keys = sorted((set(a) | set(b)) - {k for k in set(a) | set(b) if k.endswith("_twin")})
    for k in keys:
        if k not in a or k not in b:
            print(json.dumps({"output": k, "missing_in": "a" if k not in a else "b"}), flush=True)
            continue
        x, y = a[k], b[k]
        row = {"output": k, "bitwise_equal": bool(torch.equal(x, y)),
               "max_abs_diff": float((x.double() - y.double()).abs().max()) if x.numel() else 0.0,
               "differing": int((x != y).sum())}
        if k.startswith("mfcc_") and f"{k}_twin" in a:
            row["a_vs_twin"] = float((x.double() - a[f"{k}_twin"].double()).abs().max())
            row["b_vs_twin"] = float((y.double() - b[f"{k}_twin"].double()).abs().max())
        equal += row["bitwise_equal"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"outputs": len(keys), "bitwise_equal": equal}), flush=True)


def time_kernels():
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels import mfcc as km
    from srhmm_tpu_torch.train.em import em_step

    cs = smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {}
    for name in EM_CELLS:
        model, batch, k1 = em_cell(cs, name)
        out[f"emit_forward_{name}_ms"] = cs.median_ms(torch, lambda: fe.emit_forward(*k1))
        out[f"emit_forward_{name}_kernel_device_ms"] = cs.kernel_device_ms(
            torch, lambda: fe.emit_forward(*k1), "emit_forward_kernel")[0]
        if name == "em_diag":
            feats_tdb = k1[0][0]
            step = lambda: em_step(model, batch, fused=True, feats_tdb=feats_tdb, band=1)
            step()
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            prof = cs.profile_window(torch, step, kernel_keys=("emit_forward_kernel", "backward_stats_kernel"))
            out["em_step_em_diag_wall_ms"] = float(np.median(walls)) * 1e3
            out["em_step_em_diag_profile"] = prof
        del model, batch, k1
    samples, offsets, cfg = mfcc_cell(cs)
    out["mfcc_b256_10s_ms"] = cs.median_ms(torch, lambda: km.mfcc_fused(samples, offsets, cfg))
    out["mfcc_b256_10s_kernel_device_ms"] = cs.kernel_device_ms(
        torch, lambda: km.mfcc_fused(samples, offsets, cfg), "mfcc_kernel")[0]
    ref = cs.mfcc_rfft_matmul(torch, samples, offsets, cfg)
    out["mfcc_b256_10s_rfft_matmul_ms"] = cs.median_ms(torch, lambda: cs.mfcc_rfft_matmul(torch, samples, offsets, cfg))
    out["mfcc_b256_10s_rfft_matmul_vs_twin"] = float(
        (ref - km.mfcc_plain(samples, offsets, cfg)).abs().max())
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": fe.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif sys.argv[1] == "time":
        time_kernels()
    else:
        compare(sys.argv[2], sys.argv[3])
