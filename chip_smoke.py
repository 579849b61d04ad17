#!/usr/bin/env python3
"""GPU smoke run of srhmm_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this repository beside the script; it exits
non-zero without them.  It imports nothing of JAX.  Phases, one JSON line
each (any failure raises, so the exit code is non-zero):

  0 device   card, CUDA, nvcc and power limit; TF32 switched off
  1 build    nvcc builds srhmm_tpu_torch/csrc/*.cu into build/srhmm_tpu_torch/
  2 kernel   vocab_scores kernel vs its plain PyTorch version on the same CUDA
             tensors (diag/full, total/final, sum/max, two streams, a
             heterogeneous vocabulary, odd B and T, a zero-length utterance,
             a 200-word vocabulary): max|k-p|/max(|p|,1) <= 1e-5, equal
             finite masks, identical argmax over words
  3 main     the recognizer end to end at full width on generated data:
             .hmm/.perfil files -> read_vocabulary -> stack_models ->
             astype(float32) -> cuda; load_batch -> score_batch -> rank ->
             RecognitionReport / isolated_accuracy, for W=13 S=6 M=1 D=9 full
             covariance (the reference fixtures' shape) and W=10 S=8 M=4 D=13
             diagonal; then the recognize CLI (--numerics fast) on 13 files
  4 timing   kernel and plain version at both main-path shapes, CUDA events

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BOUND = 1e-5  # kernel vs plain: max |k - p| / max(|p|, 1) over finite scores
FRAME_S = 0.01  # seconds of audio per frame


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# models and data, made from a seed with numpy
# ---------------------------------------------------------------------------


def left_right_trans(S: int, dur: float) -> np.ndarray:
    """Left-right transitions with an expected stay of `dur` frames per
    state (the last state absorbs)."""
    t = np.zeros((S, S))
    for s in range(S - 1):
        t[s, s], t[s, s + 1] = 1.0 - 1.0 / dur, 1.0 / dur
    t[S - 1, S - 1] = 1.0
    return t


def rand_stream(rng, S, M, D, cov, scale=3.0) -> dict:
    means = rng.normal(size=(S, M, D)) * scale
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    if cov == "full":
        a = rng.normal(size=(S, M, D, D)) * 0.3
        c = a @ np.swapaxes(a, -1, -2) + np.eye(D)
        inv_cov, det = np.linalg.inv(c), np.linalg.det(c)
    else:
        var = rng.uniform(0.5, 1.5, size=(S, M, D))
        inv_cov, det = 1.0 / var, np.prod(var, -1)
    return {"weights": w, "means": means, "inv_cov": inv_cov, "det": det, "cov_type": cov}


def rand_words(seed, W, S, mixes_dims, cov, dur=2.0):
    """W random words: [(trans, [stream dicts])]."""
    rng = np.random.default_rng(seed)
    return [
        (left_right_trans(S, dur), [rand_stream(rng, S, M, D, cov) for M, D in mixes_dims])
        for _ in range(W)
    ]


def sample(rng, trans, streams, T) -> list[np.ndarray]:
    """T frames per stream sampled from a left-right HMM starting in state 0."""
    S = trans.shape[0]
    states = np.zeros(T, np.int64)
    u = rng.uniform(size=T)
    for t in range(1, T):
        s = states[t - 1]
        states[t] = s + 1 if (s + 1 < S and u[t] < trans[s, s + 1]) else s
    out = []
    for st in streams:
        M, D = st["weights"].shape[1], st["means"].shape[-1]
        cum = np.cumsum(st["weights"][states], axis=1)
        mix = np.minimum((rng.uniform(size=(T, 1)) > cum).sum(1), M - 1)
        mu = st["means"][states, mix]
        k = st["inv_cov"][states, mix]
        z = rng.normal(size=(T, D))
        if st["cov_type"] == "full":
            # x = mu + L^-T z with K = L L^T, so cov(x) = K^-1
            L = np.linalg.cholesky(k)
            x = mu + np.linalg.solve(np.swapaxes(L, -1, -2), z[..., None])[..., 0]
        else:
            x = mu + z / np.sqrt(k)
        out.append(x)
    return out


def torch_vocab(words):
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models

    return stack_models([gmm_hmm_from_numpy(t, s, f"w{i}") for i, (t, s) in enumerate(words)])


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def compare(k, p, what: str) -> dict:
    """Kernel scores k vs plain scores p, both (B, W) tensors; raises
    unless they agree within BOUND with equal finite masks and argmax."""
    k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
    fk, fp = np.isfinite(k), np.isfinite(p)
    if not (fk == fp).all():
        raise AssertionError(f"{what}: finite masks differ at {int((fk != fp).sum())} entries")
    diff = np.abs(k[fp] - p[fp])
    rel = float(np.max(diff / np.maximum(np.abs(p[fp]), 1.0))) if fp.any() else 0.0
    if not rel <= BOUND:
        raise AssertionError(f"{what}: kernel vs plain relative error {rel} > {BOUND}")
    if not (k.argmax(1) == p.argmax(1)).all():
        raise AssertionError(f"{what}: argmax over words differs")
    return {"rel_err": rel, "max_abs_err": float(diff.max()) if fp.any() else 0.0}


def kernel_vs_plain(vocab, batch, mode, semiring, final_states=None) -> dict:
    """score_batch_fused through the kernel, and the same packed CUDA
    tensors through vocab_scores_plain, reduced the same way."""
    import torch

    from srhmm_tpu_torch.ops.kernels.scoring import (
        pack_batch,
        score_batch_fused,
        scores_from_log_alpha,
        vocab_scores_plain,
    )

    fused = score_batch_fused(vocab, batch, mode=mode, semiring=semiring, final_states=final_states)
    args, kw = pack_batch(vocab, batch)
    plain = scores_from_log_alpha(
        vocab_scores_plain(*args, **kw, semiring=semiring), kw["s_word"], mode, final_states
    )
    torch.cuda.synchronize()
    return compare(fused, plain, f"{mode}/{semiring}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is needed")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from srhmm_tpu_torch.ops.kernels.build import find_nvcc

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]).splitlines()[0]
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": sh([find_nvcc(), "--version"]).splitlines()[-1],
        "nvidia_smi": smi,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    emit(info)
    return info


def phase_build() -> None:
    from srhmm_tpu_torch.ops.kernels.build import build_library, load_library

    t0 = time.perf_counter()
    lib, nvcc_s = build_library()
    load_library()
    emit({"phase": "build", "nvcc_seconds": nvcc_s, "seconds": time.perf_counter() - t0,
          "cached": nvcc_s == 0.0, "library": str(lib.relative_to(ROOT))})


def phase_kernel(torch) -> float:
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, pad_stack_models

    dev = torch.device("cuda")
    rng = np.random.default_rng(2024)
    worst_abs = 0.0

    def batch_for(dims, lens):
        return tuple(
            pack_utterances([rng.normal(size=(n, D)) * 3 for n in lens], pad_multiple=1,
                            dtype=torch.float32, device=dev)
            for D in dims
        )

    odd_lens = [int(n) for n in rng.integers(1, 95, size=35)] + [95, 0]  # odd B=37 and T=95
    configs = []
    for cov in ("diag", "full"):
        configs.append((f"{cov}_1stream", torch_vocab(rand_words(1, 6, 5, [(2, 6)], cov)), (6,), None))
        configs.append((f"{cov}_2stream", torch_vocab(rand_words(2, 5, 6, [(3, 9), (2, 3)], cov)), (9, 3), None))
    hetero = [gmm_hmm_from_numpy(t, s, f"h{i}") for i, (t, s) in enumerate(
        rand_words(3, 1, S, [(M, 6)], "diag")[0] for S, M in ((4, 2), (6, 1), (6, 3), (4, 2)))]
    hv, hfs = pad_stack_models(hetero)
    configs.append(("heterogeneous_S4664", hv, (6,), hfs))
    for name, vocab, dims, fs in configs:
        vocab = vocab.astype(torch.float32).to(dev)
        batch = batch_for(dims, odd_lens)
        batch = batch[0] if len(batch) == 1 else batch
        for mode in ("total", "final"):
            for semiring in ("sum", "max"):
                res = kernel_vs_plain(vocab, batch, mode, semiring, fs)
                worst_abs = max(worst_abs, res["max_abs_err"])
                emit({"phase": "kernel", "config": name, "mode": mode, "semiring": semiring,
                      "B": len(odd_lens), "T": max(odd_lens), **res})
    # the suite's 200-word continuous-decode vocabulary at S=8, M=4, D=13
    vocab = torch_vocab(rand_words(4, 200, 8, [(4, 13)], "diag")).astype(torch.float32).to(dev)
    lens = [int(n) for n in rng.integers(150, 301, size=255)] + [0]
    for semiring in ("sum", "max"):
        res = kernel_vs_plain(vocab, batch_for((13,), lens)[0], "total", semiring)
        worst_abs = max(worst_abs, res["max_abs_err"])
        emit({"phase": "kernel", "config": "vocab200_S8_M4_D13", "mode": "total",
              "semiring": semiring, "B": len(lens), "T": max(lens), **res})
    return worst_abs


def write_fixture(root: Path, words, n_utts=64, B=2048, t_range=(400, 501), seed=7):
    """.hmm vocabulary + n_utts .perfil utterances (utterance i spoken from
    word i % W) + lists repeating them to B entries."""
    from srhmm_tpu_torch.io import write_hmm, write_perfil
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy

    rng = np.random.default_rng(seed)
    names = [f"word{i:02d}" for i in range(len(words))]
    for (t, s), n in zip(words, names):
        write_hmm(root / f"{n}.hmm", gmm_hmm_from_numpy(t, s, n))
    (root / "models.txt").write_text("".join(f"{n}.hmm\n" for n in names))
    spoken = []
    for i in range(n_utts):
        w = i % len(words)
        (frames,) = sample(rng, *words[w], int(rng.integers(*t_range)))
        write_perfil(root / f"utt{i:02d}.perfil", frames)
        spoken.append(names[w])
    reps = B // n_utts
    (root / "utts.txt").write_text("".join(f"utt{i:02d}.perfil\n" for i in range(n_utts)) * reps)
    return names, spoken * reps


def phase_main(torch, name, words, cov, tmp: Path) -> dict:
    from srhmm_tpu_torch.decode.scorer import rank, score_batch, score_batch_log
    from srhmm_tpu_torch.eval.metrics import isolated_accuracy
    from srhmm_tpu_torch.eval.report import RecognitionReport
    from srhmm_tpu_torch.io import load_batch, read_vocabulary
    from srhmm_tpu_torch.models import stack_models
    from srhmm_tpu_torch.ops.kernels.scoring import (
        pack_batch,
        scores_from_log_alpha,
        vocab_scores,
        vocab_scores_plain,
    )

    root = tmp / name
    root.mkdir()
    names, spoken = write_fixture(root, words)
    mode = "total" if cov == "full" else "final"  # the recognize CLI's default

    vocab_scores.launches = 0
    t0 = time.perf_counter()
    vocab = stack_models(read_vocabulary(root / "models.txt", relative_to=root))
    vocab = vocab.astype(torch.float32).to("cuda")
    batch = load_batch(root / "utts.txt", relative_to=root, dtype=torch.float32, device="cuda")
    scores = score_batch(vocab, batch, mode=mode)
    host = scores.cpu().numpy()
    rankings = [rank(row) for row in host]
    report = RecognitionReport(list(vocab.word), 1, ["models.txt"], [1.0], cov_type=cov)
    for word, r, n in zip(spoken, rankings, batch.lengths.tolist()):
        report.add_utterance(word, r, n)
    text = report.finalize()
    wall = time.perf_counter() - t0
    launches = vocab_scores.launches
    if launches < 1:
        raise AssertionError(f"{name}: the main path launched the vocab_scores kernel 0 times")

    hyps = [vocab.word[r[0]] for r in rankings]
    acc = isolated_accuracy(spoken, hyps)
    args, kw = pack_batch(vocab, batch)
    plain = scores_from_log_alpha(vocab_scores_plain(*args, **kw), kw["s_word"], mode)
    vs_plain = compare(scores, plain, f"{name} kernel vs plain")
    ref = score_batch_log(vocab, batch, mode=mode).cpu().numpy()
    fin = np.isfinite(ref)
    if not (np.isfinite(host) == fin).all():
        raise AssertionError(f"{name}: finite masks differ from score_batch_log")
    rtol = 1e-5 if cov == "diag" else 1e-4
    np.testing.assert_allclose(host[fin], ref[fin], rtol=rtol, atol=1e-5 * np.abs(ref[fin]).max())
    if not (host.argmax(1) == ref.argmax(1)).all():
        raise AssertionError(f"{name}: decisions differ from score_batch_log")
    if not acc >= 0.9:
        raise AssertionError(f"{name}: accuracy {acc} < 0.9")
    if f"Percentagen correct : {acc * 100:.2f}%" not in text:
        raise AssertionError(f"{name}: report and isolated_accuracy disagree")
    res = {
        "phase": "main", "config": name, "cov": cov, "mode": mode,
        "W": len(names), "S": vocab.num_states, "M": vocab.mixture_numbers[0],
        "D": vocab.coef_numbers[0], "B": batch.batch_size, "T": batch.max_frames,
        "frames": int(batch.lengths.sum()), "launches": launches, "accuracy": acc,
        "kernel_vs_plain_rel": vs_plain["rel_err"], "kernel_vs_plain_abs": vs_plain["max_abs_err"],
        "vs_score_batch_log_rel": float(np.max(np.abs(host[fin] - ref[fin]) / np.abs(ref[fin]))),
        "wall_s_with_io": wall,
    }
    emit(res)
    return {"root": root, "names": names, "spoken": spoken, "scores": host, "res": res,
            "vocab": vocab, "batch": batch}


def phase_cli(main_diag: dict) -> None:
    """The recognize CLI, --numerics fast, on the card: its top-1 word for
    13 utterances must equal the kernel's."""
    root = main_diag["root"]
    n = 13
    (root / "inputs13.txt").write_text("".join(f"utt{i:02d}.perfil\n" for i in range(n)))
    (root / "words13.txt").write_text("".join(f"{w}\n" for w in main_diag["spoken"][:n]))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "srhmm_tpu_torch.cli.recognize", "--numerics", "fast",
         "1", "models.txt", "1", "inputs13.txt", "words13.txt", "report13.txt"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600,
    )
    if r.returncode != 0:
        raise RuntimeError(f"recognize CLI failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    lines = r.stdout.split("Starting Tests", 1)[1].splitlines()
    tops, block = [], False
    for line in lines:
        if " :  " in line and not block:
            tops.append(line.split(" :")[0])
            block = True
        elif not line.strip():
            block = False
    kernel_tops = [main_diag["names"][i] for i in main_diag["scores"][:n].argmax(1)]
    if tops != kernel_tops:
        raise AssertionError(f"CLI top-1 {tops} != kernel top-1 {kernel_tops}")
    emit({"phase": "cli", "numerics": "fast", "utterances": n, "top1_equal": True,
          "report_lines": len((root / "report13.txt").read_text().splitlines())})


def median_ms(torch, fn, warmup=3, reps=20) -> float:
    for _ in range(warmup):
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


def phase_timing(torch, main: dict, smi: str) -> dict:
    from srhmm_tpu_torch.ops.kernels.scoring import pack_batch, vocab_scores, vocab_scores_plain

    args, kw = pack_batch(main["vocab"], main["batch"])
    saved = vocab_scores.launches
    # plain, kernel, kernel, plain: a drift across the window shows up as a
    # difference between the two readings of one version
    plain_a = median_ms(torch, lambda: vocab_scores_plain(*args, **kw))
    kern_a = median_ms(torch, lambda: vocab_scores(*args, **kw))
    kern_b = median_ms(torch, lambda: vocab_scores(*args, **kw))
    plain_b = median_ms(torch, lambda: vocab_scores_plain(*args, **kw))
    vocab_scores.launches = saved  # timing launches are not main-path launches
    audio_s = main["res"]["frames"] * FRAME_S
    kern, plain = min(kern_a, kern_b), min(plain_a, plain_b)
    res = {
        "phase": "timing", "config": main["res"]["config"], "reps": 20,
        "kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b],
        "kernel_audio_s_per_s": audio_s / (kern / 1e3),
        "plain_audio_s_per_s": audio_s / (plain / 1e3),
        "audio_s": audio_s, "card": smi,
    }
    emit(res)
    return {"ms": kern, "plain_ms": plain}


def main() -> int:
    import torch

    import srhmm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    info = phase_device(torch)
    phase_build()
    worst_abs = phase_kernel(torch)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        full_words = rand_words(11, 13, 6, [(1, 9)], "full", dur=450 / 6)
        diag_words = rand_words(12, 10, 8, [(4, 13)], "diag", dur=450 / 8)
        main_full = phase_main(torch, "W13_S6_M1_D9_full", full_words, "full", tmp)
        main_diag = phase_main(torch, "W10_S8_M4_D13_diag", diag_words, "diag", tmp)
        launches = main_full["res"]["launches"] + main_diag["res"]["launches"]
        worst_abs = max(worst_abs, main_full["res"]["kernel_vs_plain_abs"],
                        main_diag["res"]["kernel_vs_plain_abs"])
        phase_cli(main_diag)
        t_full = phase_timing(torch, main_full, info["nvidia_smi"])
        phase_timing(torch, main_diag, info["nvidia_smi"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"kernels": [{
        "name": "vocab_scores",
        "route": "cuda",
        "source": "srhmm_tpu_torch/csrc/vocab_scores.cu",
        "replaces": "srhmm_tpu/ops/pallas/scoring_pallas.py:301",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": t_full["ms"],
        "plain_ms": t_full["plain_ms"],
    }]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
