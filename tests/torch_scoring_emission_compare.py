"""Two builds of the vocabulary-scoring kernel and of the emission log-b
kernel compared on a CUDA card (not a tier-1 test):

    PYTHONPATH=<checkout> python tests/torch_scoring_emission_compare.py dump OUT.pt
    python tests/torch_scoring_emission_compare.py compare A.pt B.pt
    PYTHONPATH=<checkout> python tests/torch_scoring_emission_compare.py time
    PYTHONPATH=<checkout> python tests/torch_scoring_emission_compare.py time wide

The inputs are made from fixed seeds by this file and by the chip_smoke.py
beside it (loaded by path), so every checkout sees the same numbers; only
the srhmm_tpu_torch package comes from PYTHONPATH.  Run `time` in two
checkouts in one call, in the order parent, change, change, parent.

`dump` saves vocab_scores' final log-alpha (sum and max semirings) at
full13 (W=13, S=6, M=1, D=9 full covariance) and diag10 (W=10, S=8, M=4,
D=13 diagonal), each over B=2048 utterances of 400-500 frames sampled from
the words, and at every input of chip_smoke.py's kernel phase
(vocab_check_inputs), and emission_log_b's log b at em_diag (S=8, M=3, D=9,
N=1,024,000 frames) and at every input of the kernel_emission phase
(emission_check_inputs).  A shape a checkout refuses is printed as refused
and left out.  `compare` prints, per output, whether the two files are
bitwise equal and the largest difference, then the count of bitwise-equal
outputs per kernel.  `time` prints the CUDA-event medians of 20 calls of
vocab_scores at full13 and diag10 and of emission_log_b at em_diag (the
wrapper's host work included: the constants' re-layout), each kernel's own
device time under torch.profiler (over five calls, per launch seen), and
the median of 20 score_batch calls at full13 and diag10 (the recognizer's
call: packing the vocabulary included); with the card's name and power
limit.  `time wide` prints, at full13_d39 (chip_smoke.py full13_d39_inputs:
W=13, S=6, M=4, full D=39, B=2048 of 103-213 frames), the CUDA-event median
of 10 vocab_scores calls around the call and its device time by kernel
(chip_smoke.device_ms_keys over 3 calls: the emission pass
wide_log_b_kernel, where the checkout has it, and vocab_scores_kernel),
with the card.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# (seed, W, S, [(M, D)], cov): chip_smoke.py main's two recognizer cells
SCORE_CELLS = {
    "full13": (11, 13, 6, [(1, 9)], "full"),
    "diag10": (12, 10, 8, [(4, 13)], "diag"),
}


def smoke():
    """This tree's chip_smoke.py, whatever srhmm_tpu_torch is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def score_cell(cs, name, B=2048):
    """(vocab, batch, args, kw): the cell's words, B utterances (64 sampled
    from the words, 400-500 frames each, repeated), and vocab_scores'
    arguments."""
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.ops.kernels import scoring as ks

    seed, W, S, mixes_dims, cov = SCORE_CELLS[name]
    words = cs.rand_words(seed, W, S, mixes_dims, cov, dur=450 / S)
    vocab = cs.torch_vocab(words).astype(torch.float32).to("cuda")
    rng = np.random.default_rng(7)
    utts = [cs.sample(rng, *words[i % W], int(rng.integers(400, 501)))[0] for i in range(64)]
    batch = pack_utterances(utts * (B // 64), pad_multiple=1, dtype=torch.float32, device="cuda")
    args, kw = ks.pack_batch(vocab, batch)
    return vocab, batch, args, kw


def emission_cell(cs, N=2048 * 500, seed=12):
    """em_diag's emission inputs: (frames (N, 9), a, b) of a seeded S=8,
    M=3, D=9 diagonal stream."""
    from srhmm_tpu_torch.ops.kernels import emission as ke

    rng = np.random.default_rng(seed)
    stream = cs.emission_stream(torch, seed, 8, 3, 9, zero_weight=False)
    frames = torch.as_tensor(rng.normal(size=(N, 9)) * 3, dtype=torch.float32, device="cuda")
    return (frames, *ke.pack_constants(stream))


def dump(path):
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import scoring as ks

    cs = smoke()
    out = {}
    for name in SCORE_CELLS:
        _, _, args, kw = score_cell(cs, name)
        for semiring in ("sum", "max"):
            out[f"vocab_{name}_{semiring}"] = ks.vocab_scores(*args, **kw, semiring=semiring).cpu()
    for tag, (args, kw) in cs.vocab_check_inputs(torch).items():
        for semiring in ("sum", "max"):
            try:
                la = ks.vocab_scores(*args, **kw, semiring=semiring)
            except ValueError as e:  # a shape this checkout refuses
                print(json.dumps({"case": tag, "refused": str(e)}), flush=True)
                break
            out[f"vocab_{tag}_{semiring}"] = la.cpu()
    out["emission_em_diag"] = ke.emission_log_b(*emission_cell(cs)).cpu()
    for tag, (frames, a, b, _) in cs.emission_check_inputs(torch).items():
        try:
            out[f"emission_{tag}"] = ke.emission_log_b(frames, a, b).cpu()
        except ValueError as e:
            print(json.dumps({"case": tag, "refused": str(e)}), flush=True)
    torch.save(out, path)


def compare(a_path, b_path):
    a, b = torch.load(a_path), torch.load(b_path)
    counts = {}
    for k in sorted(set(a) | set(b)):
        kind = k.split("_", 1)[0]
        if k not in a or k not in b:
            print(json.dumps({"output": k, "missing_in": "a" if k not in a else "b"}), flush=True)
            continue
        x, y = a[k], b[k]
        fin = torch.isfinite(x) & torch.isfinite(y)
        row = {"output": k, "bitwise_equal": bool(torch.equal(x, y)),
               "max_abs_diff": float((x[fin].double() - y[fin].double()).abs().max()) if fin.any() else 0.0,
               "differing": int((x != y).sum())}
        n, eq = counts.get(kind, (0, 0))
        counts[kind] = (n + 1, eq + row["bitwise_equal"])
        print(json.dumps(row), flush=True)
    print(json.dumps({kind: {"outputs": n, "bitwise_equal": eq} for kind, (n, eq) in counts.items()}), flush=True)


def time_kernels():
    from srhmm_tpu_torch.decode.scorer import score_batch
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import scoring as ks

    cs = smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {}
    for name in SCORE_CELLS:
        vocab, batch, args, kw = score_cell(cs, name)
        call = lambda: ks.vocab_scores(*args, **kw)  # noqa: E731
        out[f"vocab_scores_{name}_ms"] = cs.median_ms(torch, call)
        out[f"vocab_scores_{name}_kernel_device_ms"] = cs.kernel_device_ms(torch, call, "vocab_scores_kernel")[0]
        mode = "total" if name == "full13" else "final"
        out[f"score_batch_{name}_ms"] = cs.median_ms(torch, lambda: score_batch(vocab, batch, mode=mode))
        del vocab, batch, args, kw
    em = emission_cell(cs)
    call = lambda: ke.emission_log_b(*em)  # noqa: E731
    out["emission_log_b_em_diag_ms"] = cs.median_ms(torch, call)
    out["emission_log_b_em_diag_kernel_device_ms"] = cs.kernel_device_ms(torch, call, "emission_log_b_kernel")[0]
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": ks.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


def wide_keys(recursion: str) -> tuple:
    """The kernels a full-covariance call past D = 16 launches in the
    srhmm_tpu_torch on the path: the emission pass (where the checkout has
    it) and the recursion."""
    import importlib.util

    pass_ = importlib.util.find_spec("srhmm_tpu_torch.ops.kernels.wide_emission") is not None
    return ("wide_log_b_kernel", recursion) if pass_ else (recursion,)


def time_wide():
    from srhmm_tpu_torch.ops.kernels import scoring as ks

    cs = smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    vocab, batch, _ = cs.full13_d39_inputs(torch)
    args, kw = ks.pack_batch(vocab, batch)
    call = lambda: ks.vocab_scores(*args, **kw)  # noqa: E731
    out = {"vocab_scores_full13_d39_ms": cs.median_ms(torch, call, warmup=2, reps=10),
           **{f"vocab_scores_full13_d39_{k}": v for k, v in
              cs.device_ms_keys(torch, call, wide_keys("vocab_scores_kernel")).items()}}
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    print(json.dumps({**out, "package": ks.__file__, "card": card, "sm_clock_after": clocks}), flush=True)


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
