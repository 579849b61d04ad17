"""Two builds of the lattice forward, backward and Viterbi kernels and of
the emission-moments kernel compared on a CUDA card (not a tier-1 test):

    PYTHONPATH=<checkout> python tests/torch_lattice_stats_compare.py dump OUT.pt
    python tests/torch_lattice_stats_compare.py compare A.pt B.pt
    PYTHONPATH=<checkout> python tests/torch_lattice_stats_compare.py time [call ...]
    PYTHONPATH=<checkout> python tests/torch_lattice_stats_compare.py time wide

The inputs are made from fixed seeds by this file and by the chip_smoke.py
beside it (loaded by path), so every checkout sees the same numbers; only
the srhmm_tpu_torch package comes from PYTHONPATH.  Run `time` in two
checkouts in one call, in the order parent, change, change, parent.

`dump` saves the forward kernel's outputs (forward_lattice on (T, S, B),
log_forward_batch's last row on (B, T, S)), the backward lattice and the
Viterbi scores and backpointers at em_diag (S=8, B=2048 utterances of 500
frames), the last row with per-row transitions at diag10 (W=10 words x
B=2048 utterances of 400-500 frames = 20,480 rows), all four at every
input of chip_smoke.py's kernel_lattice phase (lattice_check_inputs, the
last row with shared and per-row transitions), and emission_stats'
moments at em_diag (N = 1,024,000 frames, M=3, D=9) and at every
kernel_emission input with posteriors (emission_check_inputs).  A shape a
checkout refuses is printed as refused and left out.  `compare` prints,
per output, whether the two files are bitwise equal, the largest
difference and the largest difference over the largest |b|, then the
count of bitwise-equal outputs per kernel.  `time` prints the CUDA-event
medians of 20 calls around each wrapper (the wrapper's host work
included), each call's own device time under torch.profiler (over five
calls, counted only where the profiler saw all five launches: the lattice
kernels per launch, the moments' two kernels per call), for
emission_stats at em_diag (also with one state's posterior a frame, and
with all posteriors zero), forward_lattice, forward_lattice_blocked,
backward_lattice, backward_lattice_blocked (k_block = 4) and viterbi_batch
at em_diag, log_forward_batch at em_diag and per row at diag10; as a
diagnostic the cuBLAS time of the moments' contraction alone ((N, S M)^T @
(N, 2D+1) in fp32 on precomputed weights); and one e_step_fused and one
e_step_lane_major("pallas") at em_diag on the host clock (median of 5)
with the device busy time of one under torch.profiler; with the card's
name and power limit.  Named calls (substrings of the call names) time
only those calls (and E-steps), with no cuBLAS diagnostic.  `time wide`
times the kernels past 64 states instead (wide_cells): forward_lattice,
forward_lattice_blocked, backward_lattice, backward_lattice_blocked (k_block
= 4), log_forward_batch and viterbi_batch (on the whole T, and cut to its
first 40000 // S frames as chip_smoke.py timed it before its twin took the
whole T: 39 at S = 1024) at align_s96 (S = 96, band 1, B = 2048 of 204-512
frames) and lattice_s1024 (S = 1024 dense, B = 64 of 102-512 frames), each
a CUDA-event median around the call (WIDE_REPS) and its device time per
launch under torch.profiler (WIDE_PROFILE calls; the kernels whose names
contain "lattice_", the Viterbi's VITERBI_KEYS: a block-wide kernel's or
the group mode's), with the card's SM clock; `time wide NAME ...` only the
calls whose names contain a NAME.
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
LATTICE_KEY = "lattice_forward_kernel"
BACKWARD_KEY, VITERBI_KEY = "lattice_backward_kernel", "viterbi_kernel"
STATS_KEYS = ("emission_stats_kernel", "sum_blocks_kernel")
WIDE_KEY = "lattice_"  # the kernels past 64 states: any tree's forward and backward there
WIDE_REPS = {"align_s96": (3, 20), "lattice_s1024": (1, 5)}  # (warm-up, CUDA-event reps) a cell
WIDE_PROFILE = {"align_s96": 5, "lattice_s1024": 2}  # profiled calls a cell
# the Viterbi past 64 states: the block-wide kernel of d778d84 and of fd0649c, the group mode's max-plus kind
VITERBI_KEYS = ("lattice_block_kernel", "viterbi_block_kernel", "lattice_group_kernel<2,")


def smoke():
    """This tree's chip_smoke.py, whatever srhmm_tpu_torch is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def em_diag_cell(cs, B=2048, T=500, seed=21):
    """em_diag on the card: (model, batch, frames (N, 9), log b (B, T, S)
    from the emission twin, gamma (N, S) a softmax of log b, the packed
    constants a, b): a seeded S=8, M=3, D=9 diagonal model and B
    utterances of T frames from chip_smoke.make_dataset."""
    from srhmm_tpu_torch.io.dataset import UtteranceBatch
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy
    from srhmm_tpu_torch.ops.kernels import emission as ke

    S, M, D = 8, 3, 9
    rng = np.random.default_rng(seed)
    stream = cs.rand_stream(rng, S, M, D, "diag")
    model = gmm_hmm_from_numpy(cs.left_right_trans(S, T / S), [stream]).astype(torch.float32).to("cuda")
    feats = torch.as_tensor(np.stack(cs.make_dataset(seed, B, S, M, D, (T, T + 1))), dtype=torch.float32,
                            device="cuda")
    batch = UtteranceBatch(feats, torch.full((B,), T, dtype=torch.int32, device="cuda"))
    frames = feats.reshape(B * T, D)
    a, b = ke.pack_constants(model.streams[0])
    log_b = ke.emission_log_b_plain(frames, a, b)
    gamma = torch.softmax(log_b, dim=1)
    return model, batch, frames, log_b.reshape(B, T, S), gamma, a, b


def diag10_rows(cs, B=2048):
    """diag10's per-row forward inputs: (log b (B W, T, S), per-row log
    transitions (B W, S, S), lengths (B W,)) for W=10 words (S=8, M=4,
    D=13) and B utterances (64 sampled from the words, 400-500 frames,
    repeated), rows ordered (utterance, word)."""
    from srhmm_tpu_torch.io.dataset import pack_utterances

    words = cs.rand_words(12, 10, 8, [(4, 13)], "diag", dur=450 / 8)
    vocab = cs.torch_vocab(words).astype(torch.float32).to("cuda")
    rng = np.random.default_rng(7)
    utts = [cs.sample(rng, *words[i % 10], int(rng.integers(400, 501)))[0] for i in range(64)]
    batch = pack_utterances(utts * (B // 64), pad_multiple=1, dtype=torch.float32, device="cuda")
    return cs.vocab_rows(torch, vocab, batch)


def wide_cells(cs) -> dict:
    """The lattice inputs of chip_smoke.py's align_s96 and lattice_s1024
    cells: {cell: ((B, T, S) log b, its (T, S, B) copy, (S, S) log
    transitions, lengths)}.  lattice_s1024's are the phase's own (the same
    seed and draws); align_s96's transitions and lengths are the phase's,
    its log b drawn from a seed (the phase computes it from sampled
    utterances: the kernels' work does not depend on the values)."""
    out = {}
    units, states, _, _, B, T = cs.ALIGN_S96
    S = units * states
    rng = np.random.default_rng(96)
    lens = [int(n) for n in rng.integers(T * 2 // 5, T + 1, size=B - 1)] + [T]
    with np.errstate(divide="ignore"):
        lt = np.log(cs.left_right_trans(S, 1.5)).astype(np.float32)
    out["align_s96"] = (rng.normal(size=(B, T, S)) * 2).astype(np.float32), lt, lens
    S, B, T = cs.LATTICE_S1024
    rng = np.random.default_rng(1024)
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p /= p.sum(-1, keepdims=True)
    cs.rand_stream(rng, S, 1, 4, "diag")
    lens = [int(n) for n in rng.integers(T // 5, T, size=B - 1)] + [T]
    rng.normal(size=(B, T, 4))
    out["lattice_s1024"] = (rng.normal(size=(B, T, S)) * 2).astype(np.float32), np.log(p).astype(np.float32), lens
    cuda = lambda x: torch.as_tensor(x, device="cuda")  # noqa: E731
    return {cell: (cuda(lb), cuda(lb).permute(1, 2, 0).contiguous(), cuda(lt),
                   torch.as_tensor(lens, dtype=torch.int32, device="cuda")) for cell, (lb, lt, lens) in out.items()}


def time_wide(cs, card, only=()):
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    out = {}
    for cell, (lb_bts, lb_tsb, lt, lengths) in wide_cells(cs).items():
        warm, reps = WIDE_REPS[cell]
        cut = lb_bts[:, : max(1, 40000 // lb_bts.shape[2])].contiguous()
        calls = {
            "forward_lattice": lambda: kl.forward_lattice(lb_tsb, lt, lengths),
            "forward_lattice_blocked": lambda: kl.forward_lattice_blocked(lb_tsb, lt, lengths, k_block=4),
            "backward_lattice": lambda: kl.backward_lattice(lb_tsb, lt, lengths),
            "backward_lattice_blocked": lambda: kl.backward_lattice_blocked(lb_tsb, lt, lengths, k_block=4),
            "log_forward_batch": lambda: kf.log_forward_batch(lb_bts, lt, lengths),
            "viterbi_batch": lambda: kf.viterbi_batch(lb_bts, lt, lengths),
            "viterbi_batch_cut": lambda: kf.viterbi_batch(cut, lt, lengths),
        }
        for name, fn in calls.items():
            if only and not any(o in name for o in only):
                continue
            out[f"{name}_{cell}_ms"] = cs.median_ms(torch, fn, warmup=warm, reps=reps)
            for key in VITERBI_KEYS if name.startswith("viterbi") else (WIDE_KEY,):
                ms, _ = cs.kernel_device_ms(torch, fn, key, calls=WIDE_PROFILE[cell], windows=2)
                out[f"{name}_{cell}_device_ms"] = ms
                if ms is not None:
                    out[f"{name}_{cell}_device_key"] = key
                    break
        out[f"viterbi_{cell}_frames_cut"] = int(cut.shape[1])
        del lb_bts, lb_tsb, cut
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": kl.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


def tried(out, key, fn):
    """out[key] = fn() on the host, or a line saying the checkout refused it."""
    try:
        res = fn()
    except ValueError as e:  # a shape this checkout refuses
        print(json.dumps({"case": key, "refused": str(e)}), flush=True)
        return
    out[key] = tuple(r.cpu() for r in res) if isinstance(res, tuple) else res.cpu()


def dump(path):
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    cs = smoke()
    out = {}
    model, batch, frames, log_b, gamma, a, b = em_diag_cell(cs)
    lt, lengths = model.log_trans().to(torch.float32), batch.lengths
    lb_tsb = log_b.permute(1, 2, 0).contiguous()
    out["lattice_em_diag"] = kl.forward_lattice(lb_tsb, lt, lengths).cpu()
    out["lastrow_em_diag"] = kf.log_forward_batch(log_b, lt, lengths).cpu()
    out["backward_em_diag"] = kl.backward_lattice(lb_tsb, lt, lengths).cpu()
    out["viterbi_em_diag"] = tuple(r.cpu() for r in kf.viterbi_batch(log_b, lt, lengths))
    out["stats_em_diag"] = ke.emission_stats(frames, gamma, log_b.reshape(-1, 8), a, b).cpu()
    del model, batch, frames, log_b, gamma, lb_tsb
    out["lastrow_diag10_per_row"] = kf.log_forward_batch(*diag10_rows(cs)).cpu()
    for tag, (lb, lt, rows, lengths) in cs.lattice_check_inputs(torch).items():
        if rows is None:  # (B, T, S) Viterbi tie
            tried(out, f"viterbi_{tag}", lambda: kf.viterbi_batch(lb, lt, lengths))
            continue
        lb_bts = lb.permute(2, 0, 1).contiguous()
        tried(out, f"lattice_{tag}", lambda: kl.forward_lattice(lb, lt, lengths))
        tried(out, f"backward_{tag}", lambda: kl.backward_lattice(lb, lt, lengths))
        tried(out, f"lastrow_{tag}_shared", lambda: kf.log_forward_batch(lb_bts, lt, lengths))
        tried(out, f"lastrow_{tag}_per_row", lambda: kf.log_forward_batch(lb_bts, rows, lengths))
        tried(out, f"viterbi_{tag}", lambda: kf.viterbi_batch(lb_bts, lt, lengths))
    for tag, (frames, a, b, gamma) in cs.emission_check_inputs(torch).items():
        if gamma is None:
            continue
        lb = ke.emission_log_b_plain(frames, a, b)
        tried(out, f"stats_{tag}", lambda: ke.emission_stats(frames, gamma, lb, a, b))
    torch.save(out, path)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    counts = {}
    for k in sorted(set(a) | set(b)):
        kind = k.split("_", 1)[0]
        if k not in a or k not in b:
            print(json.dumps({"output": k, "missing_in": "a" if k not in a else "b"}), flush=True)
            continue
        xs, ys = (a[k], b[k]) if isinstance(a[k], tuple) else ((a[k],), (b[k],))
        eq = all(torch.equal(x, y) for x, y in zip(xs, ys))
        x, y = xs[0].double(), ys[0].double()
        fin = torch.isfinite(x) & torch.isfinite(y)
        diff = float((x[fin] - y[fin]).abs().max()) if fin.any() else 0.0
        scale = float(y[fin].abs().max()) if fin.any() else 0.0
        row = {"output": k, "bitwise_equal": eq, "max_abs_diff": diff,
               "max_diff_over_max_abs": diff / scale if scale else 0.0,
               "differing": int(sum(int((x != y).sum()) for x, y in zip(xs, ys)))}
        n, e = counts.get(kind, (0, 0))
        counts[kind] = (n + 1, e + eq)
        print(json.dumps(row), flush=True)
    print(json.dumps({kind: {"outputs": n, "bitwise_equal": e} for kind, (n, e) in counts.items()}), flush=True)


def device_ms_per_call(cs, fn, keys, calls=5):
    """The device time of one call of fn: each key's per-launch device time
    (chip_smoke.kernel_device_ms, one launch a call), and their sum (None
    if a key's windows never saw one launch a call)."""
    per = {key: cs.kernel_device_ms(torch, fn, key, calls)[0] for key in keys}
    total = None if any(v is None for v in per.values()) else float(sum(per.values()))
    return total, per


def time_kernels(only=()):
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl
    from srhmm_tpu_torch.train import em

    cs = smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    if list(only[:1]) == ["wide"]:
        return time_wide(cs, card, only[1:])
    model, batch, frames, log_b, gamma, a, b = em_diag_cell(cs)
    lt, lengths = model.log_trans().to(torch.float32), batch.lengths
    lb_tsb = log_b.permute(1, 2, 0).contiguous()
    lb_flat = log_b.reshape(-1, log_b.shape[-1])
    rows = diag10_rows(cs)
    calls = {
        "emission_stats_em_diag": (lambda: ke.emission_stats(frames, gamma, lb_flat, a, b), STATS_KEYS),
        "forward_lattice_em_diag": (lambda: kl.forward_lattice(lb_tsb, lt, lengths), (LATTICE_KEY,)),
        "forward_lattice_blocked_em_diag": (lambda: kl.forward_lattice_blocked(lb_tsb, lt, lengths, k_block=4),
                                            (LATTICE_KEY,)),
        "log_forward_batch_em_diag": (lambda: kf.log_forward_batch(log_b, lt, lengths), (LATTICE_KEY,)),
        "log_forward_batch_diag10_per_row": (lambda: kf.log_forward_batch(*rows), (LATTICE_KEY,)),
        "backward_lattice_em_diag": (lambda: kl.backward_lattice(lb_tsb, lt, lengths), (BACKWARD_KEY,)),
        "backward_lattice_blocked_em_diag": (lambda: kl.backward_lattice_blocked(lb_tsb, lt, lengths, k_block=4),
                                             (BACKWARD_KEY,)),
        "viterbi_batch_em_diag": (lambda: kf.viterbi_batch(log_b, lt, lengths), (VITERBI_KEY,)),
    }
    # the moments on other posteriors of the same shape: one state a frame
    # (a one-hot of the argmax), and all zero
    one_hot = torch.nn.functional.one_hot(gamma.argmax(dim=1), gamma.shape[1]).to(torch.float32)
    for tag, g in (("one_state", one_hot), ("zero", torch.zeros_like(gamma))):
        calls[f"emission_stats_em_diag_{tag}_gamma"] = (
            lambda g=g: ke.emission_stats(frames, g, lb_flat, a, b), STATS_KEYS)
    out = {}
    for name, (fn, keys) in calls.items():
        if only and not any(o in name for o in only):
            continue
        out[f"{name}_ms"] = cs.median_ms(torch, fn)
        out[f"{name}_device_ms"], per = device_ms_per_call(cs, fn, keys)
        if len(per) > 1:
            out[f"{name}_device_ms_by_kernel"] = per
    if not only:
        # the contraction alone, in cuBLAS fp32: weights (N, S M) precomputed
        # as the moments' twin forms them, the lift [x, x^2, 1] (N, 2D+1)
        x = frames
        lift = torch.cat([x, x * x, torch.ones_like(x[:, :1])], dim=1)
        g = torch.where(lb_flat > cs.NEG_INF, gamma, 0.0)
        qs = [torch.cat([x, x * x], dim=1) @ a[m] + b[m] for m in range(a.shape[0])]
        w = torch.stack([g * torch.exp(torch.clamp(q - lb_flat, max=0.0)) for q in qs], dim=2).reshape(x.shape[0], -1)
        out["cublas_contraction_em_diag_ms"] = cs.median_ms(torch, lambda: w.T @ lift)
        del w, qs, lift
    steps = {"e_step_fused": lambda: em.e_step_fused(model, batch),
             "e_step_lane_major_pallas": lambda: em.e_step_lane_major(model, batch, lattices="pallas")}
    for name, fn in steps.items():
        if only and not any(o in name for o in only):
            continue
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_em_diag_wall_ms"] = float(np.median(walls))
        out[f"{name}_em_diag_profile"] = cs.profile_window(torch, fn, kernel_keys=(LATTICE_KEY, BACKWARD_KEY,
                                                                                   *STATS_KEYS))
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": kl.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif sys.argv[1] == "time":
        time_kernels(sys.argv[2:])
    else:
        compare(sys.argv[2], sys.argv[3])
