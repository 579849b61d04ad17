"""Two builds of composed_forward and of the word-loop decode kernel compared
on a CUDA card (not a tier-1 test):

    PYTHONPATH=<checkout> python tests/torch_forward_decode_compare.py dump OUT.pt
    python tests/torch_forward_decode_compare.py compare A.pt B.pt
    PYTHONPATH=<checkout> python tests/torch_forward_decode_compare.py time
    PYTHONPATH=<checkout> python tests/torch_forward_decode_compare.py time wide

The inputs are made from fixed seeds by this file and by the chip_smoke.py
beside it (loaded by path), so every checkout sees the same numbers; only
the srhmm_tpu_torch package comes from PYTHONPATH.  Run `time` in two
checkouts in one call, in the order parent, change, change, parent.

`dump` saves composed_forward's log-alpha at emb_c4's and tied_c5's lattice
shapes (LS 36 / 30, B 512 / 1024, T 512 / 304, 3 diagonals) and at every
shape of torch_port_utils.LATTICE_CASES, and the decode kernel's final
scores and backpointers at dec_w200 (chip_smoke.py phase_decode's
vocabulary and utterances: W=200, S=8, M=4, D=13 diagonal, B=128 strings
of 4-8 words; K=1 unigram, K=2 and K=3 bigram) and in every kernel_decode
configuration (dec_w200's pointers as a SHA-256 and per-utterance sums).
`compare` prints, per output, whether the two files are bitwise equal and
the largest difference.  `time` prints the CUDA-event medians of 20
launches of each kernel at emb_c4, tied_c5 and dec_w200 K = 1, 2, 3, and
one whole decode_continuous_batch at dec_w200 K=2 on the host clock and
under torch.profiler (its kernel, device-to-host and idle shares), with the
card's name and power limit.  `time wide` prints, at dec_w200_full39
(chip_smoke.py dec_w200_inputs at full D=39: W=200, S=8, M=4, B=128), the
CUDA-event median of 5 decode launches at K = 1 unigram, 2 and 3 bigram
around the call and each call's device time by kernel
(chip_smoke.device_ms_keys over 3 calls: the emission pass
wide_log_b_kernel, where the checkout has it, and word_loop_decode_kernel),
with the card.
"""

import hashlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
LATTICE_CELLS = {"emb_c4": (36, 512, 512), "tied_c5": (30, 1024, 304)}  # LS, B, T


def smoke():
    """This tree's chip_smoke.py, whatever srhmm_tpu_torch is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_utils():
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_port_utils

    return torch_port_utils


def forward_inputs(seed, LS, nd, T, B):
    return port_utils().forward_lattice_case(torch.device("cuda"), seed, LS, nd, T, B)


def dec_w200(cs):
    """chip_smoke.phase_decode's main shape without its files: (vocab,
    batch, unigram, bigram) on the card."""
    from srhmm_tpu_torch.io import pack_utterances

    words = cs.rand_words(40, 200, 8, [(4, 13)], "diag", dur=3.0)
    rng = np.random.default_rng(41)  # write_decode_fixture's draws, in its order
    utts = []
    for _ in range(128):
        seq = [int(w) for w in rng.integers(0, 200, size=int(rng.integers(4, 9)))]
        utts.append(np.concatenate([cs.sample(rng, *words[w], int(rng.integers(60, 125)))[0] for w in seq]))
    lm = np.log(rng.dirichlet(np.ones(200), size=200))
    uni = np.log(np.random.default_rng(42).dirichlet(np.ones(200)))
    vocab = cs.torch_vocab(words).astype(torch.float32).to("cuda")
    batch = pack_utterances(utts, pad_multiple=1, dtype=torch.float32, device="cuda")
    return vocab, batch, uni, lm


DEC_RUNS = ((1, "uni"), (2, "lm"), (3, "lm"))


def digest(t) -> str:
    return hashlib.sha256(memoryview(t.contiguous().cpu().numpy()).cast("B")).hexdigest()


def dump(path):
    from srhmm_tpu_torch.ops.kernels import composed as kc

    cs = smoke()
    out = {}
    for cell, (LS, B, T) in LATTICE_CELLS.items():
        out[f"forward_{cell}"] = kc.composed_forward(*forward_inputs(11, LS, 3, T, B)).cpu()
    for LS, nd, T, B in port_utils().LATTICE_CASES:
        out[f"forward_LS{LS}_nd{nd}_T{T}_B{B}"] = kc.composed_forward(*forward_inputs(900 + LS, LS, nd, T, B)).cpu()
    vocab, batch, uni, lm = dec_w200(cs)
    for K, which in DEC_RUNS:
        args, kw = cs.decode_operands(vocab, (batch,), {"lm_logprobs": uni if which == "uni" else lm})
        final, bp = cs.decode_kernel(args, kw, K)
        out[f"dec_w200_K{K}_final"] = final.cpu()
        out[f"dec_w200_K{K}_bp_sha256"] = digest(bp)
        out[f"dec_w200_K{K}_bp_sums"] = bp.long().sum(dim=tuple(range(bp.dim() - 1))).cpu()
        del final, bp
    for name, args, kw, Ks, _ in cs.kernel_decode_cases(torch):
        for K in Ks:
            final, bp = cs.decode_kernel(args, kw, K)
            out[f"{name}_K{K}_final"], out[f"{name}_K{K}_bp"] = final.cpu(), bp.cpu()
    torch.save(out, path)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    equal = 0
    for k in sorted(set(a) | set(b)):
        if k not in a or k not in b:
            print(json.dumps({"output": k, "missing_in": "a" if k not in a else "b"}), flush=True)
            continue
        x, y = a[k], b[k]
        if isinstance(x, str):
            row = {"output": k, "bitwise_equal": x == y}
        else:
            row = {"output": k, "bitwise_equal": bool(torch.equal(x, y)),
                   "max_abs_diff": float((x.double() - y.double()).abs().max()) if x.numel() else 0.0,
                   "differing": int((x != y).sum())}
        equal += row["bitwise_equal"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"outputs": len(set(a) | set(b)), "bitwise_equal": equal}), flush=True)


def time_kernels():
    from srhmm_tpu_torch.decode import continuous as dc
    from srhmm_tpu_torch.ops.kernels import composed as kc

    cs = smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {}
    for cell, (LS, B, T) in LATTICE_CELLS.items():
        args = forward_inputs(11, LS, 3, T, B)
        out[f"composed_forward_{cell}_ms"] = cs.median_ms(torch, lambda: kc.composed_forward(*args))
    vocab, batch, uni, lm = dec_w200(cs)
    for K, which in DEC_RUNS:
        args, kw = cs.decode_operands(vocab, (batch,), {"lm_logprobs": uni if which == "uni" else lm})
        out[f"word_loop_decode_K{K}_ms"] = cs.median_ms(torch, lambda: cs.decode_kernel(args, kw, K))
    run = lambda: dc.decode_continuous_batch(vocab, batch, lm_logprobs=lm, n_best=2)
    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = cs.profile_window(torch, run)
    out["decode_continuous_batch_K2_wall_ms"] = float(np.median(walls)) * 1e3
    out["decode_continuous_batch_K2_profile"] = {
        **prof, "kernel_share": prof["kernel_device_ms"] / prof["profiled_wall_ms"],
        "d2h_share": prof["d2h_device_ms"] / prof["profiled_wall_ms"]}
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": kc.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


def time_wide():
    from srhmm_tpu_torch.ops.kernels import decode as kd

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_scoring_emission_compare import wide_keys

    cs = smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    vocab, batch, _, uni, lm = cs.dec_w200_inputs(torch, 39, "full")
    out = {}
    for K, which in DEC_RUNS:
        args, kw = cs.decode_operands(vocab, (batch,), {"lm_logprobs": uni if which == "uni" else lm})
        call = lambda: cs.decode_kernel(args, kw, K)  # noqa: E731
        out[f"word_loop_decode_full39_K{K}_ms"] = cs.median_ms(torch, call, warmup=1, reps=5)
        out.update({f"word_loop_decode_full39_K{K}_{k}": v for k, v in
                    cs.device_ms_keys(torch, call, wide_keys("word_loop_decode_kernel")).items()})
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": kd.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1] == "dump":
        dump(sys.argv[2])
    elif sys.argv[1] == "time" and sys.argv[2:] == ["wide"]:
        time_wide()
    elif sys.argv[1] == "time":
        time_kernels()
    else:
        compare(sys.argv[2], sys.argv[3])
