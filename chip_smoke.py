#!/usr/bin/env python3
"""GPU smoke run of srhmm_tpu_torch, the PyTorch + CUDA port.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this repository beside the script; it exits
non-zero without them.  It imports nothing of JAX.  Phases, one JSON line
each (any failure raises, so the exit code is non-zero):

  0 device    card, CUDA, nvcc and power limit; TF32 switched off
  1 build     one nvcc per srhmm_tpu_torch/csrc/*.cu, all started together,
              linked into build/srhmm_tpu_torch/
  2 kernel    every kernel vs its plain PyTorch version on the same CUDA
              tensors.  vocab_scores (diag/full, total/final, sum/max, two
              streams, a heterogeneous vocabulary, odd B and T, a zero-length
              utterance, a 200-word vocabulary): max|k-p|/max(|p|,1) <= 1e-5,
              equal finite masks, identical argmax over words.  kernel_em:
              emit_forward and backward_stats (diag/full x band 1, 2, dense x
              one stream D=9/M=3 or two streams D=9/M=3 + D=3/M=2, B=37,
              T=95, a zero-length and a length-1 row): log_b / log_alpha
              max|k-p|/max(|p|,1) <= 1e-5 with equal masks of values above
              NEG_INF/2; every summed statistic (xi, den_trans, den_mix,
              and each stream's first moments, second moments and
              occupancies apart) max|k-p| <= 1e-4 max|p|; two kernel runs
              of one E-step bitwise equal
  3 main      the recognizer end to end at full width on generated data:
              .hmm/.perfil files -> read_vocabulary -> stack_models ->
              astype(float32) -> cuda; load_batch -> score_batch -> rank ->
              RecognitionReport / isolated_accuracy, for W=13 S=6 M=1 D=9 full
              covariance (the reference fixtures' shape) and W=10 S=8 M=4 D=13
              diagonal; then the recognize CLI (--numerics fast) on 13 files
    train     Baum-Welch training at full width on generated data: .perfil
              files -> load_batch -> create_initial_model (LBG) ->
              astype(float32) -> cuda -> train_fast, for em_diag_S8_M3_D9
              (B=2048, T=500, the JAX package's EM headline shape) and
              em_full_S6_M1_D9 (B=2048 of 103-213 frames, the reference
              fixtures' model shape); then, from the trained model,
              em_train_scan(5) through the kernels vs fused=False on the card
    train_cli the train CLI (--numerics fast --scan-iters 8) on a 4-word
              vocabulary, its .hmm files read back and 64 held-out utterances
              scored through the vocab_scores kernel: accuracy >= 0.9
    kernel_decode
              the word-loop decode kernel (word_loop_decode / _k2 / _kn,
              K = 1, 2, 3) vs its twin: diag/full x unigram, bigram S=8,
              bigram S=6 (padded to 8 states) x one stream D=9/M=3 or two
              D=9/M=3 + D=3/M=2, heterogeneous final states, a duplicated
              word (exact ties decided by the tie-breaks), B=37, T=95
              with a zero-length and a length-1 row, and W=200 bigram at a
              short T: final max|k-p|/max(|p|,1) <= 1e-5 with equal masks,
              pointer mismatches <= 1e-4 of all pointers, identical
              hypotheses (word ids, spans) through the same backtrace,
              two kernel runs bitwise equal
  3 decode    continuous decoding at full width: W=200 S=8 M=4 D=13 diag
              (.hmm files), B=128 strings of 4-8 words (.perfil files), a
              bigram LM file: the decode CLI (--batch --n-best 2 --lm
              --ref) with WER <= 5 %; decode_continuous_batch at K=1
              unigram, K=2 and K=3 bigram vs the twin, K=1 vs the block
              engine; W=13 S=6 M=1 D=9 full covariance, B=1024, bigram;
              then the align CLI on 16 utterances
    kernel_composed
              the composed-lattice kernels of embedded / tied training
              (bank_emission, composed_forward, composed_backward_stats,
              bank_moments_lattice / bank_moments) vs their twins: diag/full,
              S = 2, 3, 4, L = 1-12, one or two streams, a repeated unit,
              the emb_c4 / tied_c5 bank widths, B=37, T=95 with a
              zero-length and a length-1 row; log_b / log_alpha within
              BOUND, statistics and moments within STAT_BOUND, two runs and
              the two gamma layouts bitwise equal
  3 embedded  emb_c4 (suite config 4: 40 units, S=3, M=32, D=13, B=512,
              T <= 512, L=12) and tied_c5 (config 5: 700 triphones over
    tied      2000 senones, M=16, D=39, B=1024, T <= 304, L=10) from a
              seed: 3 EM iterations through the kernels vs 3 with
              fused=False (log-prob histories rtol 2e-4; each kernel
              iteration vs a plain one from the same model, means and
              trans within 2e-3 of their scale above the weight floor), then
              train_embedded / train_tied on the same utterances
    train_embedded_cli
              the train_embedded CLI (LBG flat start, --scan-iters 8) on 8
              units, its models decoding 32 held-out strings through the
              decode CLI (WER <= 5 %), then --tied on triphone clones
  4 timing    every kernel and its plain version at the main-path shapes, and
              one whole EM iteration through the kernels vs fused=False;
              CUDA events, median of 20 after warm-up (the decode and
              composed twins: median of 3); each kernel's bound from its
              inputs; timing_composed adds torch.profiler over one
              embedded / tied EM iteration

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
# summed E-step statistics, kernel vs plain: max |k - p| <= 1e-4 max |p|
# (fp32 sums over up to ~1e6 frames, taken in another order)
STAT_BOUND = 1e-4
NEG_INF = -1e30  # the kernels' log-domain floor
FRAME_S = 0.01  # seconds of audio per frame
# the least time the card could take (NVIDIA H100 SXM data sheet):
# the bytes a kernel must move over 3.35 TB/s, or its fp32 operations over
# 67 TFLOP/s outside the tensor cores, whichever is larger
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms / bound_by of a kernel that must move nbytes (each input read
    once, each output written once) and do ops fp32 operations (a multiply-
    add counts two; exp, log, max and compare one each)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_ops": ops}


def mixture_ops(D: int, M: int, full: bool) -> int:
    """fp32 operations of one state's emission: per mixture the lifted dot
    product (diagonal: 2D multiply-adds) or the Cholesky z and its square
    (full: D*D + D multiply-adds), then ~8 for the running logsumexp."""
    return M * ((2 * D * D + 2 * D) if full else 4 * D) + 8 * M


def valid_frames(lengths, T: int) -> int:
    """Frames a kernel steps: min(max(length, 1), T) per row (frame 0 is
    always taken)."""
    return int(sum(min(max(int(n), 1), T) for n in lengths))


def numel_bytes(*tensors) -> int:
    return sum(4 * t.numel() for t in tensors if t is not None)


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


def make_dataset(seed, B, S, M, D, t_range, full=False):
    """B utterances from bench.py:49-63 make_dataset's wandering left-right
    process (per-state means x5, unit noise, the S-1 state boundaries drawn
    uniformly), with M Gaussians per state around the state mean (x4) so
    that every mixture of an M-mixture model has a component to find, and
    correlated noise for full covariance; lengths drawn from t_range."""
    rng = np.random.default_rng(seed)
    state_means = rng.normal(size=(S, D)) * 5.0
    mix_means = state_means[:, None, :] + rng.normal(size=(S, M, D)) * 4.0
    chol = np.eye(D) + (np.tril(rng.normal(size=(S, D, D)), -1) * 0.4 if full else 0.0)
    utts = []
    for _ in range(B):
        T = int(rng.integers(*t_range))
        bounds = np.sort(rng.choice(np.arange(1, T), S - 1, replace=False))
        ids = np.zeros(T, dtype=int)
        for k, b in enumerate(bounds):
            ids[b:] = k + 1
        mix = rng.integers(0, M, size=T)
        z = rng.normal(size=(T, D))
        noise = np.einsum("tde,te->td", chol[ids], z) if full else z
        utts.append(mix_means[ids, mix] + noise)
    return utts


def em_case(torch, cov, band, mixes_dims, lens, S=6, seed=0):
    """One E-step's CUDA inputs from a seed: (feats, packed, origins, trans,
    lengths) for emit_forward / backward_stats.  band=None gives a dense
    random transition matrix, else a left-right one of that band."""
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy
    from srhmm_tpu_torch.ops.kernels.fused_em import pack_lane_constants

    rng = np.random.default_rng(seed)
    if band is None:
        trans = rng.uniform(0.1, 1.0, size=(S, S))
    else:
        trans = np.zeros((S, S))
        for i in range(S):
            trans[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    trans /= trans.sum(-1, keepdims=True)
    streams = [rand_stream(rng, S, M, D, cov) for M, D in mixes_dims]
    model = gmm_hmm_from_numpy(trans, streams).astype(torch.float32).to("cuda")
    T, B = max(lens), len(lens)
    feats = tuple(
        torch.as_tensor(rng.normal(size=(T, D, B)) * 3, dtype=torch.float32, device="cuda")
        for _, D in mixes_dims
    )
    origins = tuple(s.means.mean(dim=(0, 1)) for s in model.streams)
    packed = tuple(pack_lane_constants(s, torch.float32, origin=o) for s, o in zip(model.streams, origins))
    lengths = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    return feats, packed, origins, model.trans, lengths


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


def compare_lattice(k, p, what: str) -> dict:
    """(T, S, B) log-domain lattices: equal masks of values above
    NEG_INF/2, and max |k - p| / max(|p|, 1) <= BOUND over them."""
    k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
    mk, mp = k > NEG_INF / 2, p > NEG_INF / 2
    if not (mk == mp).all():
        raise AssertionError(f"{what}: masks above NEG_INF/2 differ at {int((mk != mp).sum())} entries")
    diff = np.abs(k[mp] - p[mp])
    rel = float(np.max(diff / np.maximum(np.abs(p[mp]), 1.0))) if mp.any() else 0.0
    if not rel <= BOUND:
        raise AssertionError(f"{what}: kernel vs plain relative error {rel} > {BOUND}")
    return {"rel_err": rel, "max_abs_err": float(diff.max()) if mp.any() else 0.0}


def compare_stat(k, p, what: str) -> dict:
    """A summed statistic: max |k - p| <= STAT_BOUND * max |p|."""
    k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
    if not np.isfinite(k).all():
        raise AssertionError(f"{what}: kernel statistic not finite")
    diff = float(np.abs(k - p).max())
    scale = float(np.abs(p).max())
    if not diff <= STAT_BOUND * scale:
        raise AssertionError(f"{what}: kernel vs plain {diff} > {STAT_BOUND} x {scale}")
    return {"rel_err": diff / scale if scale else 0.0, "max_abs_err": diff}


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


def phase_kernel_em(torch) -> dict:
    """emit_forward and backward_stats vs their plain twins on the same CUDA
    tensors; the twins' lattices feed both backward passes.  Returns the
    worst absolute error per kernel."""
    from srhmm_tpu_torch.ops.kernels import fused_em as fe

    rng = np.random.default_rng(2025)
    lens = [int(n) for n in rng.integers(2, 95, size=34)] + [95, 0, 1]  # B=37, T=95
    worst = {"emit_forward": 0.0, "backward_stats": 0.0}
    saved = fe.emit_forward.launches, fe.backward_stats.launches
    for cov in ("diag", "full"):
        for band in (1, 2, None):
            for mixes_dims in ([(3, 9)], [(3, 9), (2, 3)]):
                feats, packed, origins, trans, lengths = em_case(torch, cov, band, mixes_dims, lens)
                args = (feats, packed, origins, trans, lengths)
                lb_k, la_k = fe.emit_forward(*args, band)
                lb_p, la_p = fe.emit_forward_plain(*args, band)
                lb_k2, la_k2 = fe.emit_forward(*args, band)
                log_z = la_p[-1, -1]
                valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
                safe_z = torch.where(valid, log_z, 0.0)
                vmask = valid.to(torch.float32)
                rest = (feats, lb_p, la_p, packed, origins, trans, lengths, safe_z, vmask, band)
                st_k = fe.backward_stats(*rest)
                st_p = fe.backward_stats_plain(*rest)
                st_k2 = fe.backward_stats(*rest)
                torch.cuda.synchronize()
                name = f"{cov}_band{band}_P{len(mixes_dims)}"
                res = {"log_b": compare_lattice(lb_k, lb_p, f"{name} log_b"),
                       "log_alpha": compare_lattice(la_k, la_p, f"{name} log_alpha")}
                # each moment block is its own statistic: its first moments,
                # second moments and occupancy column have different scales
                def parts(st):
                    out = [st[0], st[1], st[2]]
                    for mom, (_, D) in zip(st[3], mixes_dims):
                        out += [mom[:, :D], mom[:, D:-1], mom[:, -1]]
                    return out

                kst, pst = parts(st_k), parts(st_p)
                names = ["xi", "den_trans", "den_mix"] + [
                    f"mom{q}_{part}" for q in range(len(mixes_dims)) for part in ("x", "xx", "w")
                ]
                for n, a, b in zip(names, kst, pst):
                    res[n] = compare_stat(a, b, f"{name} {n}")
                again = parts(st_k2)
                bitwise = (torch.equal(lb_k, lb_k2) and torch.equal(la_k, la_k2)
                           and all(torch.equal(a, b) for a, b in zip(kst, again)))
                if not bitwise:
                    raise AssertionError(f"{name}: two kernel runs of one E-step differ")
                worst["emit_forward"] = max(worst["emit_forward"], res["log_b"]["max_abs_err"],
                                            res["log_alpha"]["max_abs_err"])
                worst["backward_stats"] = max(worst["backward_stats"],
                                              *(res[n]["max_abs_err"] for n in names))
                emit({"phase": "kernel_em", "config": name, "B": len(lens), "T": max(lens),
                      "valid": int(vmask.sum()), "bitwise_repeat": bitwise,
                      **{k: v["rel_err"] for k, v in res.items()}})
    fe.emit_forward.launches, fe.backward_stats.launches = saved  # comparison launches
    return worst


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


def write_utterances(root: Path, name: str, utts) -> Path:
    """One .perfil per utterance and a list file naming them."""
    from srhmm_tpu_torch.io import write_perfil

    d = root / name
    d.mkdir()
    for i, u in enumerate(utts):
        write_perfil(d / f"{i:05d}.perfil", u)
    lst = root / f"{name}.txt"
    lst.write_text("".join(f"{name}/{i:05d}.perfil\n" for i in range(len(utts))))
    return lst


def phase_train(torch, name, cov, S, M, D, t_range, tmp: Path, B=2048) -> dict:
    """The training main path at full width: .perfil files -> load_batch ->
    create_initial_model (LBG) -> astype(float32) -> cuda -> train_fast;
    then, from the trained model, em_train_scan(5) through the kernels vs
    fused=False on the card."""
    from srhmm_tpu_torch.init.lbg import create_initial_model
    from srhmm_tpu_torch.io import load_batch
    from srhmm_tpu_torch.io.dataset import UtteranceBatch
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels.common import trans_band
    from srhmm_tpu_torch.train.em import em_train_scan, train_fast

    seed = {"diag": 21, "full": 22}[cov]
    lst = write_utterances(tmp, name, make_dataset(seed, B, S, M, D, t_range, full=cov == "full"))
    t0 = time.perf_counter()
    host = load_batch(lst, relative_to=tmp, dtype=torch.float64)
    t_load = time.perf_counter() - t0
    utts = [host.features[i, : int(host.lengths[i])].numpy() for i in range(B)]
    t0 = time.perf_counter()
    init = create_initial_model([utts], S, [M], word=name, cov_type=cov)
    t_init = time.perf_counter() - t0
    model = init.astype(torch.float32).to("cuda")
    batch = UtteranceBatch(host.features.to("cuda", torch.float32), host.lengths.to("cuda"))

    fe.emit_forward.launches = fe.backward_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_fast(model, batch, max_iterations=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"emit_forward": fe.emit_forward.launches, "backward_stats": fe.backward_stats.launches}
    for k, n in launches.items():
        if n < res.iterations:
            raise AssertionError(f"{name}: {k} launched {n} times for {res.iterations} iterations")
    hist = np.asarray(res.log_prob_history)
    drops = (hist[1:] - hist[:-1]) / np.abs(hist[:-1])
    if (drops < -1e-5).any():
        raise AssertionError(f"{name}: log-probability decreased: {hist.tolist()}")
    if res.exemplar_count != B:
        raise AssertionError(f"{name}: num_valid {res.exemplar_count} != {B}")
    means = res.model.streams[0].means
    if not bool(torch.isfinite(means).all()):
        raise AssertionError(f"{name}: trained means are not finite")

    # five more iterations from the trained model, through the kernels and
    # through fused=False.  Not from the LBG start: there EM first drives
    # some mixtures to the 1e-5 weight floor, and the means of such a
    # mixture, fed by about a frame of occupancy, differ by ~1% after five
    # iterations between any two fp32 summation orders (and between fp32 and
    # fp64); near the trained model EM contracts
    band = trans_band(model.trans.cpu().numpy())
    trained = res.model
    fin_k, lps_k, nvs_k = em_train_scan(trained, batch, 5, batch.features.permute(1, 2, 0).contiguous(),
                                        fused=True, band=band)
    fin_p, lps_p, nvs_p = em_train_scan(trained, batch, 5, fused=False)
    lps_k, lps_p = lps_k.double().cpu().numpy(), lps_p.double().cpu().numpy()
    lp_rel = float(np.max(np.abs(lps_k - lps_p) / np.abs(lps_p)))
    if not lp_rel <= 1e-4:
        raise AssertionError(f"{name}: kernel vs plain log probs {lps_k} vs {lps_p}")
    if not (nvs_k.cpu().numpy() == B).all() or not (nvs_p.cpu().numpy() == B).all():
        raise AssertionError(f"{name}: num_valid != {B} in em_train_scan")
    mk = fin_k.streams[0].means.double().cpu().numpy()
    mp = fin_p.streams[0].means.double().cpu().numpy()
    np.testing.assert_allclose(mk, mp, rtol=1e-3, atol=1e-3 * np.abs(mp).max())
    frames = int(host.lengths.sum())
    out = {
        "phase": "train", "config": name, "cov": cov, "S": S, "M": M, "D": D, "B": B,
        "T": int(host.lengths.max()), "frames": frames, "iterations": res.iterations,
        "launches": launches, "history": hist.tolist(), "mean_log_prob": res.mean_log_prob,
        "num_valid": res.exemplar_count, "scan5_lps_rel_vs_plain": lp_rel,
        "scan5_means_max_abs_vs_plain": float(np.abs(mk - mp).max()),
        "load_s": t_load, "lbg_init_s": t_init, "train_fast_wall_s": wall,
    }
    emit(out)
    return {"res": out, "model": model, "batch": batch, "launches": launches}


def phase_train_cli(torch, tmp: Path) -> None:
    """The train CLI (--numerics fast --scan-iters 8) on the card for a
    4-word vocabulary (S=6, M=2, D=9 diagonal, 32 utterances per word), then
    the four .hmm files read back and 64 held-out utterances scored through
    the vocab_scores kernel."""
    from srhmm_tpu_torch.decode.scorer import score_batch
    from srhmm_tpu_torch.eval.metrics import isolated_accuracy
    from srhmm_tpu_torch.io import pack_utterances, read_hmm, write_perfil
    from srhmm_tpu_torch.models import stack_models
    from srhmm_tpu_torch.ops.kernels.scoring import vocab_scores

    root = tmp / "train_cli"
    root.mkdir()
    words = rand_words(31, 4, 6, [(2, 9)], "diag", dur=150 / 6)
    rng = np.random.default_rng(32)
    names = [f"cmd{i}" for i in range(len(words))]
    procs = []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for (trans, streams), n in zip(words, names):
        utts = [sample(rng, trans, streams, int(rng.integers(100, 200)))[0] for _ in range(32)]
        for i, u in enumerate(utts):
            write_perfil(root / f"{n}_{i:02d}.perfil", u)
        (root / f"list_{n}.txt").write_text("".join(f"{n}_{i:02d}.perfil\n" for i in range(32)))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "srhmm_tpu_torch.cli.train", "--cov", "diag", "--numerics", "fast",
             "--scan-iters", "8", n, "6", "1", "2", f"list_{n}.txt", f"{n}.hmm"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    for n, proc in zip(names, procs):
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"train CLI failed for {n}:\n{out[-2000:]}\n{err[-4000:]}")
    held, spoken = [], []
    for i in range(64):
        w = i % len(words)
        held.append(sample(rng, *words[w], int(rng.integers(100, 200)))[0])
        spoken.append(names[w])
    vocab = stack_models([read_hmm(root / f"{n}.hmm") for n in names]).astype(torch.float32).to("cuda")
    batch = pack_utterances(held, pad_multiple=1, dtype=torch.float32, device="cuda")
    vocab_scores.launches = 0
    scores = score_batch(vocab, batch, mode="final").cpu().numpy()
    if vocab_scores.launches < 1:
        raise AssertionError("train_cli: scoring did not launch the vocab_scores kernel")
    acc = isolated_accuracy(spoken, [vocab.word[j] for j in scores.argmax(1)])
    if not acc >= 0.9:
        raise AssertionError(f"train_cli: accuracy {acc} < 0.9")
    emit({"phase": "train_cli", "words": len(names), "train_utts_per_word": 32,
          "held_out": len(held), "accuracy": acc})


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
    t = timed_pair(torch, lambda: vocab_scores_plain(*args, **kw), lambda: vocab_scores(*args, **kw),
                   plain_warmup=3)
    vocab_scores.launches = saved  # timing launches are not main-path launches
    audio_s = main["res"]["frames"] * FRAME_S
    # bound: features of the stepped frames, the constants, the (W*S, B)
    # output; per stepped frame and row the emission and the banded step
    feats, a, bias_g, bias, logw, diag, lengths = args
    T, D, B = feats.shape
    N = a.shape[1]
    full = main["res"]["cov"] == "full"
    frames = valid_frames(lengths.tolist(), T)
    bnd = bound(4 * frames * D + numel_bytes(a, bias_g, bias, logw, diag, lengths) + 4 * N * B,
                frames * N * (mixture_ops(D, main["res"]["M"], full) + 4 * (kw["band"] + 1) + 4))
    emit({
        "phase": "timing", "config": main["res"]["config"], "reps": 20,
        "kernel_ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "kernel_audio_s_per_s": audio_s / (t["ms"] / 1e3),
        "plain_audio_s_per_s": audio_s / (t["best_plain_ms"] / 1e3),
        "audio_s": audio_s, **bnd, "card": smi,
    })
    return {"ms": t["ms"], "plain_ms": t["best_plain_ms"], **bnd}


def timed_pair(torch, plain, kernel, plain_warmup=1) -> dict:
    """CUDA-event medians of 20 in the order plain, kernel, kernel, plain:
    a drift across the window shows up as a difference between the two
    readings of one version."""
    plain_a = median_ms(torch, plain, warmup=plain_warmup)
    kern_a = median_ms(torch, kernel)
    kern_b = median_ms(torch, kernel)
    plain_b = median_ms(torch, plain, warmup=plain_warmup)
    return {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b],
            "ms": min(kern_a, kern_b), "best_plain_ms": min(plain_a, plain_b)}


def phase_timing_em(torch, train: dict, smi: str) -> dict:
    """emit_forward, backward_stats and one whole EM iteration (kernel path
    vs fused=False) at a train shape, on the trained phase's initial model."""
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels.common import trans_band
    from srhmm_tpu_torch.train.em import em_step

    model, batch = train["model"], train["batch"]
    band = trans_band(model.trans.cpu().numpy())
    feats_tdb = batch.features.permute(1, 2, 0).contiguous()
    origins = (model.streams[0].means.mean(dim=(0, 1)),)
    packed = (fe.pack_lane_constants(model.streams[0], torch.float32, origin=origins[0]),)
    k1 = ((feats_tdb,), packed, origins, model.trans, batch.lengths, band)
    lb, la = fe.emit_forward(*k1)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (batch.lengths > 0)
    k2 = ((feats_tdb,), lb, la, packed, origins, model.trans, batch.lengths,
          torch.where(valid, log_z, 0.0), valid.to(torch.float32), band)
    saved = fe.emit_forward.launches, fe.backward_stats.launches
    out = {
        "emit_forward": timed_pair(torch, lambda: fe.emit_forward_plain(*k1), lambda: fe.emit_forward(*k1)),
        "backward_stats": timed_pair(torch, lambda: fe.backward_stats_plain(*k2), lambda: fe.backward_stats(*k2)),
        "em_iteration": timed_pair(
            torch, lambda: em_step(model, batch, fused=False),
            lambda: em_step(model, batch, fused=True, feats_tdb=feats_tdb, band=band)),
    }
    occ = {k: fe.occupancy(w, *k1) for k, w in (("emit_forward", 0), ("backward_stats", 1))}
    fe.emit_forward.launches, fe.backward_stats.launches = saved  # timing launches
    audio_s = train["res"]["frames"] * FRAME_S
    it = out["em_iteration"]
    # bounds: K1 reads the stepped frames' features and the constants and
    # writes log_b and log_alpha (T, S, B); K2 reads them back with the
    # features and writes xi, den_trans, den_mix and the moment partials.
    # Per stepped frame and state: K1 the emission and the banded forward
    # step; K2 the emission again, the mixture posteriors' moment
    # multiply-adds (2 (L+1) per mixture, L = 2D or D + D^2) and the banded
    # backward step with xi
    T, D, B = feats_tdb.shape
    S, M, full = model.num_states, model.mixture_numbers[0], model.streams[0].cov_type == "full"
    frames = valid_frames(batch.lengths.tolist(), T)
    L1 = (D + D * D if full else 2 * D) + 1
    nb = (band if band is not None else S - 1) + 1
    consts = numel_bytes(*packed[0], model.trans)
    out["emit_forward"].update(bound(4 * frames * D + consts + 4 * 2 * T * S * B,
                                     frames * S * (mixture_ops(D, M, full) + 4 * nb + 4)))
    out["backward_stats"].update(bound(
        4 * frames * D + consts + 4 * 2 * T * S * B + 4 * (nb + 2) * S * B + 4 * M * S * L1,
        frames * S * (mixture_ops(D, M, full) + 2 * M * L1 + 8 * nb + 8)))
    res = {
        "phase": "timing_em", "config": train["res"]["config"], "reps": 20, **out,
        "em_audio_s_per_s": audio_s / (it["ms"] / 1e3),
        "plain_em_audio_s_per_s": audio_s / (it["best_plain_ms"] / 1e3),
        "audio_s": audio_s, "occupancy": occ, "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "card": smi,
    }
    emit(res)
    return res


# ---------------------------------------------------------------------------
# continuous decoding: the word-loop kernel (csrc/word_loop_decode.cu)
# ---------------------------------------------------------------------------

DECODE_WRAPPERS = {1: "word_loop_decode", 2: "word_loop_decode_k2", 3: "word_loop_decode_kn"}
POINTER_BOUND = 1e-4  # kernel vs twin pointer mismatches, a share of all pointers


def skip_trans(S: int) -> np.ndarray:
    """Left-right transitions with a skip over one state (band 2)."""
    t = np.zeros((S, S))
    for s in range(S):
        nxt = [x for x in (s, s + 1, s + 2) if x < S]
        t[s, nxt] = np.array([0.5, 0.3, 0.2])[: len(nxt)]
    return t / t.sum(-1, keepdims=True)


def decode_counts() -> dict:
    from srhmm_tpu_torch.ops.kernels import decode as kd

    return {name: getattr(kd, name).launches for name in DECODE_WRAPPERS.values()}


def set_decode_counts(counts: dict) -> None:
    from srhmm_tpu_torch.ops.kernels import decode as kd

    for name, n in counts.items():
        getattr(kd, name).launches = n


def on_decode_twin(fn):
    """fn() with the decode wrappers routed to the plain twin: then
    decode_continuous_batch runs the same backtrace and dedupe on the
    twin's lattice.  The wrappers are restored before returning."""
    from srhmm_tpu_torch.ops.kernels import decode as kd

    kernels = kd.word_loop_decode, kd.word_loop_decode_k2, kd.word_loop_decode_kn
    kd.word_loop_decode = lambda *a, **k: kd.word_loop_decode_plain(*a, n_best=1, **k)
    kd.word_loop_decode_k2 = lambda *a, **k: kd.word_loop_decode_plain(*a, n_best=2, **k)
    kd.word_loop_decode_kn = lambda *a, **k: kd.word_loop_decode_plain(*a, **k)
    out = fn()
    kd.word_loop_decode, kd.word_loop_decode_k2, kd.word_loop_decode_kn = kernels
    return out


def compare_hyps(got, want, n_best: int, what: str) -> float:
    """Two decode_continuous_batch results: identical word ids and spans for
    every utterance and rank, scores within BOUND relative.  Returns the
    worst relative score error."""
    worst = 0.0
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} utterances")
    for b, (g, w) in enumerate(zip(got, want)):
        g, w = ([g], [w]) if n_best == 1 else (g, w)
        if [h[1:] for h in g] != [h[1:] for h in w]:
            raise AssertionError(f"{what}: utterance {b} hypotheses differ: {g} vs {w}")
        for hg, hw in zip(g, w):
            if hg[0] != hw[0]:
                worst = max(worst, abs(hg[0] - hw[0]) / max(abs(hw[0]), 1.0))
    if not worst <= BOUND:
        raise AssertionError(f"{what}: hypothesis scores differ by {worst} > {BOUND}")
    return worst


def decode_operands(vocab, batches, graph_kw):
    """(args, kwargs) of the decode wrappers for one batch, exactly as
    decode_continuous_batch builds them."""
    from srhmm_tpu_torch.decode import continuous as dc

    graph = dc.compose_word_loop_blocks(vocab, **graph_kw)
    (feats, a, bias, bias_g, logw, diag, band, arc_col, entry_col, exit_col, lengths,
     s_eff) = dc._fused_operands(vocab, graph, batches)
    return ((feats, a, bias, diag, arc_col, entry_col, lengths, s_eff, band),
            {"exit_col": exit_col, "bias_g": bias_g, "logw": logw})


def decode_kernel(args, kw, K):
    from srhmm_tpu_torch.ops.kernels import decode as kd

    if K == 1:
        return kd.word_loop_decode(*args, **kw)
    if K == 2:
        return kd.word_loop_decode_k2(*args, **kw)
    return kd.word_loop_decode_kn(*args, n_best=K, **kw)


def phase_kernel_decode(torch) -> dict:
    """The word-loop kernel vs its plain twin on the same CUDA tensors, at
    K = 1, 2, 3: diag and full covariance; unigram, bigram at S=8 and
    bigram at S=6 (padded to 8 states); one stream D=9/M=3 or two streams
    D=9/M=3 + D=3/M=2; heterogeneous word lengths (final states through
    exit_col); a duplicated word (exact ties); B=37, T=95 with a zero-length
    and a length-1 row; one W=200 bigram case at a short T.  Returns the
    worst absolute error per wrapper."""
    from srhmm_tpu_torch.decode import continuous as dc
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, pad_stack_models, stack_models
    from srhmm_tpu_torch.ops.kernels import decode as kd

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    lens37 = [int(n) for n in rng.integers(2, 95, size=34)] + [95, 0, 1]
    worst = {name: 0.0 for name in DECODE_WRAPPERS.values()}
    saved = decode_counts()
    # variant: "hetero" = words of S and S-2 states (final states through
    # exit_col); "dup" = word 3 a copy of word 1 with the same arcs in and
    # out (uniform unigram, or the bigram's row and column), so their tokens
    # tie bitwise in both implementations and the lowest-row / lowest-plane
    # tie-breaks alone decide pointers and word ids
    configs = []
    for cov in ("diag", "full"):
        for S, bigram in ((8, False), (8, True), (6, True)):
            for md in ([(3, 9)], [(3, 9), (2, 3)]):
                configs.append((cov, 5, S, bigram, md, None, lens37))
        for bigram in (False, True):
            configs.append((cov, 5, 8, bigram, [(3, 9)], "hetero", lens37))
            configs.append((cov, 5, 8, bigram, [(3, 9)], "dup", lens37))
    configs.append(("diag", 200, 8, True, [(4, 13)], None, [60, 0, 1] + [int(n) for n in rng.integers(2, 60, 34)]))
    for ci, (cov, W, S, bigram, md, variant, lens) in enumerate(configs):
        wrng = np.random.default_rng(100 + ci)
        sizes = [S - 2 * (i % 2) if variant == "hetero" else S for i in range(W)]
        leaves = [(left_right_trans(n, 2.0) if i % 2 == 0 else skip_trans(n),
                   [rand_stream(wrng, n, M, D, cov) for M, D in md]) for i, n in enumerate(sizes)]
        if variant == "dup":
            leaves[3] = leaves[1]
        words = [gmm_hmm_from_numpy(t, st, f"w{i}") for i, (t, st) in enumerate(leaves)]
        vocab, fs = pad_stack_models(words) if variant == "hetero" else (stack_models(words), None)
        vocab = vocab.astype(torch.float32).to(dev)
        batches = tuple(pack_utterances([wrng.normal(size=(n, D)) * 3 for n in lens], pad_multiple=1,
                                        dtype=torch.float32, device=dev) for _, D in md)
        batch = batches[0] if len(batches) == 1 else batches
        graph_kw = {"final_states": fs}
        if bigram:
            lm = np.log(wrng.dirichlet(np.ones(W), size=W))
            if variant == "dup":  # the copy's arcs in and out too: the two are interchangeable
                lm[:, 3] = lm[:, 1]
                lm[3] = lm[1]
            graph_kw["lm_logprobs"] = lm
        args, kw = decode_operands(vocab, batches, graph_kw)
        for K in (1, 2, 3):
            fk, bk = decode_kernel(args, kw, K)
            fk2, bk2 = decode_kernel(args, kw, K)
            fp, bp = kd.word_loop_decode_plain(*args, n_best=K, **kw)
            torch.cuda.synchronize()
            name = f"{cov}_W{W}_S{S}_{'bigram' if bigram else 'unigram'}_P{len(md)}" + \
                (f"_{variant}" if variant else "") + f"_K{K}"
            res = compare_lattice(fk, fp, f"{name} final")
            mism = int((bk != bp).sum())
            if not mism <= POINTER_BOUND * bk.numel():
                raise AssertionError(f"{name}: {mism} of {bk.numel()} pointers differ from the twin")
            bitwise = bool(torch.equal(fk, fk2) and torch.equal(bk, bk2))
            if not bitwise:
                raise AssertionError(f"{name}: two kernel runs differ")
            hk = dc.decode_continuous_batch(vocab, batch, n_best=K, **graph_kw)
            hp = on_decode_twin(lambda: dc.decode_continuous_batch(vocab, batch, n_best=K, **graph_kw))
            hyp_rel = compare_hyps(hk, hp, K, name)
            worst[DECODE_WRAPPERS[K]] = max(worst[DECODE_WRAPPERS[K]], res["max_abs_err"])
            emit({"phase": "kernel_decode", "config": name, "B": len(lens), "T": max(lens),
                  "s_eff": args[7], "final_rel_err": res["rel_err"], "pointer_mismatches": mism,
                  "pointers": bk.numel(), "hyp_score_rel_err": hyp_rel, "bitwise_repeat": bitwise})
    set_decode_counts(saved)  # comparison launches are not main-path launches
    return worst


def write_decode_fixture(root: Path, words, n_utts, words_per_utt, frames_per_word, seed):
    """.hmm vocabulary (absolute paths in models.txt), n_utts .perfil
    utterances, each a string of words sampled from the word models, a
    reference transcript file and a bigram LM text file with Dirichlet
    rows (suite.py:206).  Returns (names, refs, utterances, lm)."""
    from srhmm_tpu_torch.io import write_hmm, write_perfil
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy

    root.mkdir()
    rng = np.random.default_rng(seed)
    W = len(words)
    names = [f"word{i:03d}" for i in range(W)]
    for (t, st), n in zip(words, names):
        write_hmm(root / f"{n}.hmm", gmm_hmm_from_numpy(t, st, n))
    (root / "models.txt").write_text("".join(f"{root / n}.hmm\n" for n in names))
    refs, utts = [], []
    for i in range(n_utts):
        seq = [int(w) for w in rng.integers(0, W, size=int(rng.integers(*words_per_utt)))]
        frames = np.concatenate([sample(rng, *words[w], int(rng.integers(*frames_per_word)))[0] for w in seq])
        write_perfil(root / f"u{i:04d}.perfil", frames)
        refs.append([names[w] for w in seq])
        utts.append(frames)
    (root / "inputs.txt").write_text("".join(f"{root}/u{i:04d}.perfil\n" for i in range(n_utts)))
    (root / "ref.txt").write_text("".join(" ".join(r) + "\n" for r in refs))
    lm = np.log(rng.dirichlet(np.ones(W), size=W))
    (root / "lm.txt").write_text("".join(f"{names[u]} {names[v]} {float(lm[u, v])!r}\n"
                                         for u in range(W) for v in range(W)))
    return names, refs, utts, lm


def wer_of(results, refs, names, n_best) -> float:
    from srhmm_tpu_torch.eval.metrics import WerCounts, edit_alignment

    total = WerCounts()
    for r, ref in zip(results, refs):
        best = r if n_best == 1 else r[0]
        total = total + edit_alignment(ref, [names[w] for w in best[1]])
    return total.wer


def phase_decode(torch, tmp: Path) -> dict:
    """Continuous decoding end to end on the card.  Main shape: the JAX
    package's config-3 vocabulary (suite.py:279-311), W=200 words, S=8,
    M=4, D=13 diagonal, from a seed, as .hmm files; B=128 utterances of
    4-8 words (T <= 1000) as .perfil files, a bigram LM file, a reference
    file.  The decode CLI (--batch --n-best 2 --lm --ref) in-process: WER
    <= 5 %.  decode_continuous_batch on the same batch at K=1 unigram, K=2
    bigram, K=3 bigram against the twin on the card; K=1 against the
    per-utterance block engine for 4 utterances.  Second shape: the
    reference fixtures' model (W=13, S=6, M=1, D=9 full covariance) with a
    bigram LM, B=1024 (padded to 8 states).  Then the align CLI on 16
    utterances with their true transcripts."""
    from srhmm_tpu_torch.cli import align as align_cli
    from srhmm_tpu_torch.cli import decode as decode_cli
    from srhmm_tpu_torch.decode import continuous as dc
    from srhmm_tpu_torch.io import pack_utterances, read_vocabulary
    from srhmm_tpu_torch.models import stack_models

    out = {}
    set_decode_counts({name: 0 for name in DECODE_WRAPPERS.values()})
    # --- the main shape: files -> CLI -------------------------------------
    words = rand_words(40, 200, 8, [(4, 13)], "diag", dur=3.0)
    root = tmp / "decode_w200"
    names, refs, utts, lm = write_decode_fixture(root, words, 128, (4, 9), (60, 125), seed=41)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = decode_cli.main([str(root / "models.txt"), str(root / "inputs.txt"), str(root / "out.txt"),
                          "--batch", "--n-best", "2", "--lm", str(root / "lm.txt"),
                          "--ref", str(root / "ref.txt")])
    cli_wall = time.perf_counter() - t0
    text = (root / "out.txt").read_text()
    wer_line = [l for l in text.splitlines() if l.startswith("WER:")]
    if rc != 0 or not wer_line:
        raise AssertionError(f"decode CLI exit {rc}, no WER line")
    cli_wer = float(wer_line[0].split()[1].rstrip("%"))
    if not cli_wer <= 5.0:
        raise AssertionError(f"decode CLI WER {cli_wer}% > 5%")
    if decode_counts()["word_loop_decode_k2"] < 1:
        raise AssertionError("the decode CLI did not launch the 2-best kernel")
    # --- the library on the same batch, kernel vs twin ---------------------
    vocab = stack_models(read_vocabulary(root / "models.txt")).astype(torch.float32).to("cuda")
    batch = pack_utterances(utts, pad_multiple=1, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(42)
    uni = np.log(rng.dirichlet(np.ones(len(names))))
    runs = {}
    for K, lm_k in ((1, uni), (2, lm), (3, lm)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dc.decode_continuous_batch(vocab, batch, lm_logprobs=lm_k, n_best=K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = on_decode_twin(lambda: dc.decode_continuous_batch(vocab, batch, lm_logprobs=lm_k, n_best=K))
        rel = compare_hyps(got, want, K, f"W200 K={K}")
        runs[K] = {"wer": wer_of(got, refs, names, K), "hyp_score_rel_err_vs_twin": rel,
                   "decode_continuous_batch_wall_s": wall}
        if K == 1:
            for b in range(4):
                L = int(batch.lengths[b])
                ref = dc.decode_continuous(vocab, batch.features[b, :L], lm_logprobs=uni, n_best=1)[0]
                if ref[1:] != got[b][1:] or not abs(ref[0] - got[b][0]) <= 2e-5 * abs(ref[0]):
                    raise AssertionError(f"W200 K=1 utterance {b}: batch {got[b]} vs block engine {ref}")
        if not runs[K]["wer"] <= 0.05:
            raise AssertionError(f"W200 K={K}: WER {runs[K]['wer']} > 5%")
    frames = int(batch.lengths.sum())
    out["w200"] = {"W": 200, "S": 8, "M": 4, "D": 13, "B": batch.batch_size, "T": batch.max_frames,
                   "frames": frames, "cli_wer_percent": cli_wer, "cli_wall_s": cli_wall, "runs": runs}
    emit({"phase": "decode", "config": "W200_S8_M4_D13_diag", **out["w200"]})
    # --- the second shape: the reference fixtures' full-covariance model ---
    words13 = rand_words(43, 13, 6, [(1, 9)], "full")
    rng13 = np.random.default_rng(44)
    refs13, utts13 = [], []
    for _ in range(1024):
        seq = [int(w) for w in rng13.integers(0, 13, size=int(rng13.integers(3, 7)))]
        utts13.append(np.concatenate([sample(rng13, *words13[w], int(rng13.integers(20, 40)))[0] for w in seq]))
        refs13.append([f"w{w}" for w in seq])
    vocab13 = torch_vocab(words13).astype(torch.float32).to("cuda")
    batch13 = pack_utterances(utts13, pad_multiple=1, dtype=torch.float32, device="cuda")
    lm13 = np.log(rng13.dirichlet(np.ones(13), size=13))
    runs13 = {}
    for K in (1, 2):
        got = dc.decode_continuous_batch(vocab13, batch13, lm_logprobs=lm13, n_best=K)
        want = on_decode_twin(lambda: dc.decode_continuous_batch(vocab13, batch13, lm_logprobs=lm13, n_best=K))
        runs13[K] = {"wer": wer_of(got, refs13, list(vocab13.word), K),
                     "hyp_score_rel_err_vs_twin": compare_hyps(got, want, K, f"W13 full K={K}")}
        if not runs13[K]["wer"] <= 0.05:
            raise AssertionError(f"W13 full K={K}: WER {runs13[K]['wer']} > 5%")
    out["w13"] = {"W": 13, "S": 6, "s_eff": 8, "M": 1, "D": 9, "B": batch13.batch_size,
                  "T": batch13.max_frames, "frames": int(batch13.lengths.sum()), "runs": runs13}
    emit({"phase": "decode", "config": "W13_S6_M1_D9_full_bigram", **out["w13"]})
    # --- forced alignment of 16 utterances with their true transcripts ----
    (root / "trans.txt").write_text("".join(f"{root}/u{i:04d}.perfil {' '.join(refs[i])}\n" for i in range(16)))
    t0 = time.perf_counter()
    rc = align_cli.main([str(root / "models.txt"), str(root / "trans.txt"), str(root / "align.txt")])
    align_wall = time.perf_counter() - t0
    units = [l.split("\t")[1] for l in (root / "align.txt").read_text().splitlines()]
    if rc != 0 or units != [u for r in refs[:16] for u in r]:
        raise AssertionError(f"align CLI exit {rc}; units differ from the transcripts")
    emit({"phase": "align", "utterances": 16, "units": len(units), "exit": rc, "wall_s": align_wall})
    out["launches"] = decode_counts()
    for name, n in out["launches"].items():
        if n < 1:
            raise AssertionError(f"the decode main path launched {name} 0 times")
    out["batch"], out["vocab"], out["uni"], out["lm"] = batch, vocab, uni, lm
    return out


def decode_bound(args, kw, K) -> dict:
    """The bound of one decode launch: the stepped frames' features, the
    packed constants and the outputs (final (K, N, B), every frame's
    pointers (T, K, N, B)); per stepped frame and row the emission, the
    (band+1) K within-word candidates and K cross-word ones, and for a
    bigram 2 K W W per frame for the destinations' merges."""
    feats, a, bias, diag, arc_col, entry_col, lengths, s_word, band = args
    featss = feats if isinstance(feats, tuple) else (feats,)
    a_s = a if isinstance(a, tuple) else (a,)
    T, _, B = featss[0].shape
    N = a_s[0].shape[1]
    W = N // s_word
    bigram = tuple(arc_col.shape) == (W, W)
    frames = valid_frames(lengths.tolist(), T)
    full = kw["bias_g"] is not None
    em = 0
    for f, a_p in zip(featss, a_s):
        D = f.shape[1]
        em += mixture_ops(D, a_p.shape[0] // D if full else a_p.shape[0], full)
    consts = numel_bytes(*a_s, *(bias if isinstance(bias, tuple) else (bias,)), diag, arc_col,
                         entry_col, kw["exit_col"], lengths)
    if full:
        consts += numel_bytes(*kw["bias_g"], *kw["logw"]) if isinstance(kw["bias_g"], tuple) \
            else numel_bytes(kw["bias_g"], kw["logw"])
    nbytes = 4 * frames * sum(f.shape[1] for f in featss) + consts + 4 * K * N * B + 4 * T * K * N * B
    ops = frames * (N * (em + 2 * (band + 1) * K + 2 * K) + (2 * K * W * W if bigram else 0))
    return bound(nbytes, ops)


def profile_window(torch, fn, kernel_keys=("word_loop_decode_kernel",)) -> dict:
    """One call of fn under torch.profiler: its host wall (profiler on),
    the device time summed over the device's own events (kernels, copies),
    the share of the kernels whose names contain one of kernel_keys,
    device-to-host copies, the number of device events, and the idle share
    1 - device busy / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = kernel = d2h = 0.0
    ops = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # a host op's entry repeats its device time
            continue
        dt = getattr(ev, "self_device_time_total", None)
        dt = ev.self_cuda_time_total if dt is None else dt
        busy += dt
        ops += ev.count
        if any(k in ev.key for k in kernel_keys):
            kernel += dt
        if "DtoH" in ev.key or "Device -> Pageable" in ev.key or "DeviceToHost" in ev.key:
            d2h += dt
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3, "kernel_device_ms": kernel / 1e3,
            "d2h_device_ms": d2h / 1e3, "device_ops": ops, "idle_share": 1.0 - busy / wall_us}


def phase_timing_decode(torch, dec: dict, smi: str) -> dict:
    """The decode kernel vs its twin at the main shape, for K=1 unigram,
    K=2 bigram, K=3 bigram: CUDA events, kernel median of 20 after warm-up,
    twin median of 3, in the order twin, kernel, kernel, twin; decode
    audio-s/s; one whole decode_continuous_batch on the host clock, then
    one under torch.profiler (device busy and idle shares)."""
    from srhmm_tpu_torch.decode import continuous as dc
    from srhmm_tpu_torch.ops.kernels import decode as kd

    vocab, batch = dec["vocab"], dec["batch"]
    saved = decode_counts()
    audio_s = int(batch.lengths.sum()) * FRAME_S
    out = {}
    for K, lm_k, tag in ((1, dec["uni"], "unigram"), (2, dec["lm"], "bigram"), (3, dec["lm"], "bigram")):
        args, kw = decode_operands(vocab, (batch,), {"lm_logprobs": lm_k})
        plain_a = median_ms(torch, lambda: kd.word_loop_decode_plain(*args, n_best=K, **kw), warmup=0, reps=3)
        kern_a = median_ms(torch, lambda: decode_kernel(args, kw, K))
        kern_b = median_ms(torch, lambda: decode_kernel(args, kw, K))
        plain_b = median_ms(torch, lambda: kd.word_loop_decode_plain(*args, n_best=K, **kw), warmup=0, reps=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dc.decode_continuous_batch(vocab, batch, lm_logprobs=lm_k, n_best=K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = profile_window(torch, lambda: dc.decode_continuous_batch(vocab, batch, lm_logprobs=lm_k, n_best=K))
        ms = min(kern_a, kern_b)
        res = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b], "ms": ms,
               "best_plain_ms": min(plain_a, plain_b), "decode_audio_s_per_s": audio_s / (ms / 1e3),
               "decode_continuous_batch_wall_s": wall, "decode_continuous_batch_profile": prof,
               **decode_bound(args, kw, K)}
        out[K] = res
        emit({"phase": "timing_decode", "config": f"W200_S8_M4_D13_diag_K{K}_{tag}", "B": batch.batch_size,
              "T": batch.max_frames, "audio_s": audio_s, "kernel_reps": 20, "plain_reps": 3, **res,
              "card": smi})
    set_decode_counts(saved)  # timing launches are not main-path launches
    return out


# ---------------------------------------------------------------------------
# embedded and tied training: the composed-lattice kernels (csrc/composed.cu)
# ---------------------------------------------------------------------------

COMPOSED_SRC = "srhmm_tpu_torch/csrc/composed.cu"
COMPOSED_KERNEL_NAMES = ("bank_emission_kernel", "composed_forward_kernel", "composed_backward_stats_kernel",
                         "bank_moments_kernel", "segment_rows_kernel")  # csrc/composed.cu
COMPOSED_ROWS = [  # (wrapper, the TPU kernel it replaces)
    ("bank_emission", "srhmm_tpu/ops/pallas/composed_pallas.py:218"),
    ("composed_forward", "srhmm_tpu/ops/pallas/composed_pallas.py:348"),
    ("composed_backward_stats", "srhmm_tpu/ops/pallas/composed_pallas.py:474"),
    ("bank_moments_lattice", "srhmm_tpu/ops/pallas/composed_pallas.py:707"),
    ("bank_moments", "srhmm_tpu/ops/pallas/composed_pallas.py:792"),
]
# (cov, S, L, [(M, D) per stream]); the last two carry the emb_c4 and
# tied_c5 bank widths at B=37, T=95
COMPOSED_CASES = [
    ("diag", 2, 1, [(3, 9)]),
    ("diag", 3, 3, [(3, 9), (2, 9)]),
    ("full", 3, 5, [(2, 6)]),
    ("diag", 4, 5, [(4, 13)]),
    ("full", 2, 3, [(3, 4), (2, 4)]),
    ("diag", 3, 12, [(32, 13)]),
    ("diag", 3, 10, [(16, 39)]),
]


def composed_counts() -> dict:
    from srhmm_tpu_torch.ops.kernels import composed as kc

    return kc.launch_counts()


def set_composed_counts(counts: dict) -> None:
    from srhmm_tpu_torch.ops.kernels import composed as kc

    kc.set_launch_counts(counts)


def composed_inputs(torch, models, transcripts, feats, lengths):
    """The four kernels' inputs of one batch, as the fused E-step builds
    them: (ids, banks, diag_row, diag_col, full)."""
    from srhmm_tpu_torch.train import embedded as emb

    full = models.streams[0].cov_type == "full"
    D = feats.shape[-1]
    S = models.num_states
    banks = tuple(emb._pack_bank(st, D, full) for st in models.streams)
    pos_logt = models.log_trans().to(torch.float32)[transcripts.long()]
    diag_row, diag_col = emb._composed_diagonals(pos_logt, max(S - 1, 1))
    banks = banks if len(banks) > 1 else banks[0]
    return emb._positions(transcripts, S), banks, diag_row, diag_col, full


def composed_check(torch, ids, banks, feats, lengths, diag_row, diag_col, full, what) -> dict:
    """Each composed kernel vs its twin on the same CUDA tensors, twice
    (bitwise repeat), both gamma layouts of the moments (bitwise equal).
    Lattice-kernel inputs come from the twins.  Returns the worst absolute
    error per wrapper and the relative errors."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    D = feats.shape[-1]
    lb_k, lb_k2 = kc.bank_emission(ids, banks, feats, full), kc.bank_emission(ids, banks, feats, full)
    lb_p = kc.bank_emission_plain(ids, banks, feats, full)
    la_k, la_k2 = kc.composed_forward(lb_p, diag_col, lengths), kc.composed_forward(lb_p, diag_col, lengths)
    la_p = kc.composed_forward_plain(lb_p, diag_col, lengths)
    log_z = la_p[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    rest = (lb_p, la_p, diag_row, lengths, torch.where(valid, log_z, 0.0), valid.to(torch.float32))
    st_k, st_k2 = kc.composed_backward_stats(*rest), kc.composed_backward_stats(*rest)
    st_p = kc.composed_backward_stats_plain(*rest)
    gamma = st_p[0]
    m_k = kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full)
    m_k2 = kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full)
    m_b = kc.bank_moments(ids, banks, feats, gamma.permute(2, 1, 0).contiguous(), lengths, full)
    m_p = kc.bank_moments_lattice_plain(ids, banks, feats, gamma, lengths, full)
    torch.cuda.synchronize()
    as_t = lambda m: m if isinstance(m, tuple) else (m,)
    res = {"log_b": compare_lattice(lb_k, lb_p, f"{what} log_b"),
           "log_alpha": compare_lattice(la_k, la_p, f"{what} log_alpha")}
    for n, a, b in zip(("gamma", "xi", "den_trans", "den_mix"), st_k, st_p):
        res[n] = compare_stat(a, b, f"{what} {n}")
    for q, (a, b) in enumerate(zip(as_t(m_k), as_t(m_p))):
        for part, sl in (("x", slice(0, D)), ("xx", slice(D, -1)), ("w", slice(-1, None))):
            res[f"mom{q}_{part}"] = compare_stat(a[..., sl], b[..., sl], f"{what} mom{q}_{part}")
    bitwise = (torch.equal(lb_k, lb_k2) and torch.equal(la_k, la_k2)
               and all(torch.equal(a, b) for a, b in zip(st_k, st_k2))
               and all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(as_t(m_k), as_t(m_k2), as_t(m_b))))
    if not bitwise:
        raise AssertionError(f"{what}: two kernel runs (or the two gamma layouts) differ")
    mom_abs = max(v["max_abs_err"] for k, v in res.items() if k.startswith("mom"))
    worst = {"bank_emission": res["log_b"]["max_abs_err"], "composed_forward": res["log_alpha"]["max_abs_err"],
             "composed_backward_stats": max(res[n]["max_abs_err"] for n in ("gamma", "xi", "den_trans", "den_mix")),
             "bank_moments_lattice": mom_abs, "bank_moments": mom_abs}
    return {"worst": worst, "rel": {k: v["rel_err"] for k, v in res.items()}}


def phase_kernel_composed(torch) -> dict:
    """The four composed kernels vs their twins on CUDA tensors at B=37,
    T=95 with a zero-length and a length-1 row: diag/full, S = 2, 3, 4
    (band 1, 2, 3), L = 1, 3, 5, 10, 12, one or two streams, utterance 0
    repeating one unit, the emb_c4 and tied_c5 bank widths.  Returns the
    worst absolute error per wrapper."""
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models

    dev = torch.device("cuda")
    saved = composed_counts()
    worst = {name: 0.0 for name, _ in COMPOSED_ROWS}
    for ci, (cov, S, L, md) in enumerate(COMPOSED_CASES):
        rng = np.random.default_rng(300 + ci)
        lens = [int(n) for n in rng.integers(2, 95, size=34)] + [95, 0, 1]
        P = 6
        units = [(left_right_trans(S, 3.0) if i % 2 else skip_trans(S), [rand_stream(rng, S, M, D, cov) for M, D in md])
                 for i in range(P)]
        models = stack_models([gmm_hmm_from_numpy(t, st, f"u{i}") for i, (t, st) in enumerate(units)])
        models = models.astype(torch.float32).to(dev)
        trs = rng.integers(0, P, size=(len(lens), L))
        trs[0] = 1
        transcripts = torch.as_tensor(trs, device=dev)
        feats = torch.as_tensor(rng.normal(size=(len(lens), max(lens), md[0][1])) * 3, dtype=torch.float32,
                                device=dev)
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        ids, banks, diag_row, diag_col, full = composed_inputs(torch, models, transcripts, feats, lengths)
        name = f"{cov}_S{S}_L{L}_" + "_".join(f"M{M}D{D}" for M, D in md)
        out = composed_check(torch, ids, banks, feats, lengths, diag_row, diag_col, full, name)
        for k, v in out["worst"].items():
            worst[k] = max(worst[k], v)
        emit({"phase": "kernel_composed", "config": name, "B": len(lens), "T": max(lens), "LS": L * S,
              "bitwise_repeat": True, "gamma_layouts_bitwise_equal": True, **out["rel"]})
    set_composed_counts(saved)  # comparison launches are not main-path launches
    return worst


def composed_dataset(rng, W, MU, K, rows, B, t_range):
    """B utterances sampled from composed chains: utterance b walks its
    rows[b] (parameter-row ids of its L*S composed states) left to right,
    the row boundaries drawn uniformly, each frame from a mixture of its
    row (weights W, means MU, inverse variances K, diagonal).  Returns
    (list of (T_b, D) arrays)."""
    utts = []
    R = rows.shape[1]
    D = MU.shape[-1]
    cum = np.cumsum(W, axis=-1)
    for b in range(B):
        T = int(rng.integers(*t_range))
        bounds = np.sort(rng.choice(np.arange(1, T), R - 1, replace=False))
        seg = np.zeros(T, dtype=int)
        seg[bounds] = 1
        r = rows[b][np.cumsum(seg)]
        mix = np.minimum((rng.uniform(size=(T, 1)) > cum[r]).sum(1), W.shape[-1] - 1)
        utts.append(MU[r, mix] + rng.normal(size=(T, D)) / np.sqrt(K[r, mix]))
    return utts


def pad_batch(torch, utts, trs):
    """(transcripts, feats (B, T, D) zero-padded float32, lengths) on the card."""
    B, T, D = len(utts), max(len(u) for u in utts), utts[0].shape[1]
    feats = np.zeros((B, T, D), np.float32)
    for i, u in enumerate(utts):
        feats[i, : len(u)] = u
    dev = "cuda"
    return (torch.as_tensor(trs, dtype=torch.int32, device=dev), torch.as_tensor(feats, device=dev),
            torch.as_tensor([len(u) for u in utts], dtype=torch.int32, device=dev))


def above_floor(weights) -> np.ndarray:
    """Mixtures whose weight is above the EM floor region (1e-3)."""
    return weights.double().cpu().numpy() > 1e-3


def param_close(name, what, a, b, mask) -> float:
    """max |a - b| <= 2e-3 max |b| over the mask (the STAT_BOUND form at
    the trajectory tolerance); returns the difference."""
    a, b = a.double().cpu().numpy()[mask], b.double().cpu().numpy()[mask]
    diff, scale = float(np.abs(a - b).max()), float(np.abs(b).max())
    if not diff <= 2e-3 * scale:
        raise AssertionError(f"{name} {what}: kernel vs plain {diff} > 2e-3 x {scale}")
    return diff


def em_comparison(torch, name, step, start, params) -> dict:
    """Three EM iterations through the kernels (the second with
    gamma_lattice=False, kernel #13) and three with fused=False on the card
    from the same start.  step(model, fused, gamma_lattice) -> (new model,
    log prob, num valid); params(model) -> (weights, means, trans).

    Checked: the two free-running log-prob histories within rtol 2e-4; each
    kernel iteration against one plain iteration from the same model, means
    and trans within 2e-3 of their scale over the mixtures above the weight
    floor (1e-3) before and after.  Reported only: the free-running final
    parameters' divergence, since EM on mixtures with a few frames each
    (tied_c5: ~9 frames a mixture in 39 dimensions) is chaotic, and fp32
    summation orders put single mixtures on different paths within two
    iterations (PERF.md)."""
    m, lps_k, steps = start, [], []
    for it in range(3):
        new, lp, _ = step(m, True, it != 1)
        ref, lp_ref, _ = step(m, False, True)
        (w0, _, _), (w1, mu1, tr1), (w2, mu2, tr2) = params(m), params(new), params(ref)
        mask = above_floor(w0) & above_floor(w1) & above_floor(w2)
        lp_rel = abs(float(lp) - float(lp_ref)) / abs(float(lp_ref))
        if not lp_rel <= 2e-4:
            raise AssertionError(f"{name} iteration {it}: kernel vs plain log prob {float(lp)} vs {float(lp_ref)}")
        steps.append({"lp_rel": lp_rel, "mixtures_compared": int(mask.sum()),
                      "means_max_abs": param_close(name, f"iteration {it} means", mu1, mu2, mask),
                      "trans_max_abs": param_close(name, f"iteration {it} trans", tr1, tr2,
                                                   np.ones(tuple(tr2.shape), bool))})
        lps_k.append(lp)
        m = new
    fin_k = m
    m, lps_p = start, []
    for _ in range(3):
        m, lp, _ = step(m, False, True)
        lps_p.append(lp)
    lk = torch.stack(lps_k).double().cpu().numpy()
    lp = torch.stack(lps_p).double().cpu().numpy()
    lp_rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    if not lp_rel <= 2e-4:
        raise AssertionError(f"{name}: kernel vs plain log-prob histories {lk} vs {lp}")
    (wk, muk, trk), (wp, mup, trp) = params(fin_k), params(m)
    mask = above_floor(wk) & above_floor(wp)
    dmu = np.abs(muk.double().cpu().numpy() - mup.double().cpu().numpy()).max(-1)[mask]
    scale = float(mup.double().abs().max())
    return {"history_kernels": lk.tolist(), "history_plain": lp.tolist(), "lps_rel_vs_plain": lp_rel,
            "steps": steps, "free_running_means_max_abs": float(dmu.max()),
            "free_running_mixtures_beyond_2e-3_of_scale": int((dmu > 2e-3 * scale).sum()),
            "free_running_mixtures": int(mask.sum()), "means_scale": scale,
            "free_running_trans_max_abs": float((trk - trp).abs().max())}


def phase_embedded(torch) -> dict:
    """Embedded training at suite config 4's full width (emb_c4): P=40
    units, S=3, M=32, D=13 diagonal, B=512 utterances of L=12 units,
    T <= 512, models and data from a seed: em_comparison of
    embedded_em_step, then train_embedded on the same utterances (3
    iterations, its own buckets) against the kernel history."""
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models
    from srhmm_tpu_torch.train import embedded as emb

    P, S, M, D, B, L = 40, 3, 32, 13, 512, 12
    rng = np.random.default_rng(44)
    units = [(left_right_trans(S, 4.0), [rand_stream(rng, S, M, D, "diag")]) for _ in range(P)]
    models = stack_models([gmm_hmm_from_numpy(t, st, f"ph{i:02d}") for i, (t, st) in enumerate(units)])
    W = np.stack([st[0]["weights"] for _, st in units]).reshape(P * S, M)
    MU = np.stack([st[0]["means"] for _, st in units]).reshape(P * S, M, D)
    K = np.stack([st[0]["inv_cov"] for _, st in units]).reshape(P * S, M, D)
    trs = rng.integers(0, P, size=(B, L))
    rows = (trs[:, :, None] * S + np.arange(S)).reshape(B, L * S)
    t0 = time.perf_counter()
    utts = composed_dataset(rng, W, MU, K, rows, B, (400, 513))
    t_data = time.perf_counter() - t0
    transcripts, feats, lengths = pad_batch(torch, utts, trs)
    start = models.astype(torch.float32).to("cuda")
    if not emb._embedded_fused_eligible(start, transcripts, feats):
        raise AssertionError("emb_c4: the batch is not eligible for the composed kernels")

    def step(m, fused, gamma_lattice):
        return emb.embedded_em_step(m, transcripts, feats, lengths, fused=fused, gamma_lattice=gamma_lattice)

    def params(m):
        return m.streams[0].weights, m.streams[0].means, m.trans

    before = composed_counts()
    cmp = em_comparison(torch, "emb_c4", step, start, params)
    mid = composed_counts()
    res = emb.train_embedded(start, utts, trs.tolist(), max_iterations=3, chunk=3, threshold=-1.0)
    after = composed_counts()
    launches = {k: after[k] - before[k] for k in after}
    if any(mid[k] - before[k] != n for k, n in (("bank_emission", 3), ("bank_moments", 1))):
        raise AssertionError(f"emb_c4: the kernel iterations launched {mid} (from {before})")
    np.testing.assert_allclose(res.log_prob_history, cmp["history_kernels"], rtol=2e-4,
                               err_msg="emb_c4 train_embedded")
    if res.exemplar_count != B or res.iterations != 3:
        raise AssertionError(f"emb_c4: train_embedded ran {res.iterations} iterations on {res.exemplar_count}")
    frames = int(lengths.sum())
    out = {"phase": "embedded", "config": "emb_c4_P40_S3_M32_D13_diag", "P": P, "S": S, "M": M, "D": D,
           "B": B, "L": L, "T": int(feats.shape[1]), "frames": frames, "launches": launches,
           "train_embedded_history": res.log_prob_history, **cmp, "data_s": t_data}
    emit(out)
    return {"res": out, "models": start, "batch": (transcripts, feats, lengths), "launches": launches}


def phase_tied(torch) -> dict:
    """Tied-state training at suite config 5's full width (tied_c5): 700
    triphone units of S=3 sharing N=2000 senones of M=16, D=39 diagonal,
    B=1024 utterances of L=10 units, T <= 304, var_floor 0.1, from a seed:
    em_comparison of tied_em_step, then train_tied (3 iterations)."""
    from srhmm_tpu_torch.models import tied_hmm_set_from_numpy
    from srhmm_tpu_torch.train import tied as tt

    P, S, N, M, D, B, L, vf = 700, 3, 2000, 16, 39, 1024, 10, 0.1
    rng = np.random.default_rng(45)
    senones = rand_stream(rng, N, M, D, "diag")  # (N, M, ...) leaves: senones as the "state" axis
    sm = np.zeros((P, S), np.int64)
    pools = np.array_split(np.arange(N), S)
    for s, pool in enumerate(pools):  # every senone used, the rest drawn from the state's pool
        perm = rng.permutation(P)
        sm[perm[: len(pool)], s] = pool
        sm[perm[len(pool):], s] = rng.choice(pool, size=P - len(pool))
    trans = np.stack([left_right_trans(S, 3.0) for _ in range(P)])
    tied0 = tied_hmm_set_from_numpy(senones, trans, sm, tuple(f"t{i:03d}" for i in range(P)))
    trs = rng.integers(0, P, size=(B, L))
    rows = sm[trs].reshape(B, L * S)
    t0 = time.perf_counter()
    utts = composed_dataset(rng, senones["weights"], senones["means"], senones["inv_cov"], rows, B, (250, 305))
    t_data = time.perf_counter() - t0
    transcripts, feats, lengths = pad_batch(torch, utts, trs)
    start = tied0.astype(torch.float32).to("cuda")
    if not tt._tied_fused_eligible(start, transcripts, feats):
        raise AssertionError("tied_c5: the batch is not eligible for the composed kernels")

    def step(t, fused, gamma_lattice):
        return tt.tied_em_step(t, transcripts, feats, lengths, var_floor=vf, fused=fused,
                               gamma_lattice=gamma_lattice)

    def params(t):
        return t.senones.weights, t.senones.means, t.trans

    before = composed_counts()
    cmp = em_comparison(torch, "tied_c5", step, start, params)
    mid = composed_counts()
    res = tt.train_tied(start, utts, trs.tolist(), max_iterations=3, chunk=3, threshold=-1.0, var_floor=vf)
    after = composed_counts()
    launches = {k: after[k] - before[k] for k in after}
    if any(mid[k] - before[k] != n for k, n in (("bank_emission", 3), ("bank_moments", 1))):
        raise AssertionError(f"tied_c5: the kernel iterations launched {mid} (from {before})")
    np.testing.assert_allclose(res.log_prob_history, cmp["history_kernels"], rtol=2e-4,
                               err_msg="tied_c5 train_tied")
    if res.exemplar_count != B or res.iterations != 3:
        raise AssertionError(f"tied_c5: train_tied ran {res.iterations} iterations on {res.exemplar_count}")
    frames = int(lengths.sum())
    out = {"phase": "tied", "config": "tied_c5_P700_S3_N2000_M16_D39_diag", "P": P, "S": S, "N": N, "M": M,
           "D": D, "B": B, "L": L, "T": int(feats.shape[1]), "frames": frames, "var_floor": vf,
           "launches": launches, "train_tied_history": res.log_prob_history, **cmp, "data_s": t_data}
    emit(out)
    return {"res": out, "tied": start, "batch": (transcripts, feats, lengths), "launches": launches}


def triphone_names(seq, names) -> list[str]:
    """`l-c+r` names of a unit string, sil at the edges."""
    out = []
    for k, u in enumerate(seq):
        left = names[seq[k - 1]] if k > 0 else "sil"
        right = names[seq[k + 1]] if k + 1 < len(seq) else "sil"
        out.append(f"{left}-{names[u]}+{right}")
    return out


def phase_train_embedded_cli(torch, tmp: Path) -> dict:
    """The train_embedded CLI on the card: 8 units (S=3, M=2, D=13 diag)
    from a seed, 160 training strings of 3-5 units as .perfil files, the
    LBG flat start, --scan-iters 8; the decode CLI (--batch) on 32
    held-out strings with the trained .hmm files: WER <= 5 %.  Then --tied
    on triphone-named clones of the trained units (--init): exit 0, fewer
    senones than units x S, and a log-prob history that does not decrease
    (fp32 slack 1e-4 relative)."""
    from srhmm_tpu_torch.cli import decode as decode_cli
    from srhmm_tpu_torch.cli import train_embedded as te_cli
    from srhmm_tpu_torch.io import write_perfil
    from srhmm_tpu_torch.train import tied as tied_mod

    root = tmp / "train_embedded_cli"
    root.mkdir()
    words = rand_words(51, 8, 3, [(2, 13)], "diag", dur=4.0)
    names = [f"p{i}" for i in range(len(words))]
    rng = np.random.default_rng(52)

    def strings(n, tag):
        seqs, lines = [], []
        for i in range(n):
            seq = [int(u) for u in rng.integers(0, len(words), size=int(rng.integers(3, 6)))]
            frames = np.concatenate([sample(rng, *words[u], int(rng.integers(20, 36)))[0] for u in seq])
            write_perfil(root / f"{tag}{i:03d}.perfil", frames)
            seqs.append(seq)
            lines.append(f"{root}/{tag}{i:03d}.perfil")
        return seqs, lines

    train_seqs, train_files = strings(160, "tr")
    (root / "trans.txt").write_text("".join(f"{f} {' '.join(names[u] for u in s)}\n"
                                            for f, s in zip(train_files, train_seqs)))
    t0 = time.perf_counter()
    rc = te_cli.main([str(root / "trans.txt"), str(root / "mono"), "--states", "3", "--mix", "2",
                      "--scan-iters", "8", "--device", "cuda"])
    mono_wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train_embedded CLI exit {rc}")
    summary = json.loads((root / "mono" / "summary.json").read_text())
    held_seqs, held_files = strings(32, "he")
    (root / "models.txt").write_text("".join(f"{root}/mono/{n}.hmm\n" for n in names))
    (root / "inputs.txt").write_text("".join(f"{f}\n" for f in held_files))
    (root / "ref.txt").write_text("".join(" ".join(names[u] for u in s) + "\n" for s in held_seqs))
    rc = decode_cli.main([str(root / "models.txt"), str(root / "inputs.txt"), str(root / "out.txt"),
                          "--batch", "--ref", str(root / "ref.txt")])
    wer_line = [l for l in (root / "out.txt").read_text().splitlines() if l.startswith("WER:")]
    if rc != 0 or not wer_line:
        raise AssertionError(f"decode CLI exit {rc}, no WER line")
    wer = float(wer_line[0].split()[1].rstrip("%"))
    if not wer <= 5.0:
        raise AssertionError(f"train_embedded CLI models: held-out WER {wer}% > 5%")

    # --tied on triphone-named clones of the trained monophones
    tri_seqs = [triphone_names(s, names) for s in train_seqs]
    tris = sorted({t for s in tri_seqs for t in s})
    init = root / "tri_init"
    init.mkdir()
    for t in tris:
        shutil.copyfile(root / "mono" / f"{t.split('-')[1].split('+')[0]}.hmm", init / f"{t}.hmm")
    (root / "trans_tri.txt").write_text("".join(f"{f} {' '.join(s)}\n" for f, s in zip(train_files, tri_seqs)))
    results = []
    train_tied = tied_mod.train_tied

    def recording(*a, **k):  # the CLI's TrainResult, for its history
        results.append(train_tied(*a, **k))
        return results[-1]

    tied_mod.train_tied = recording
    try:
        t0 = time.perf_counter()
        rc = te_cli.main([str(root / "trans_tri.txt"), str(root / "tied"), "--tied", "--init", str(init),
                          "--scan-iters", "8", "--device", "cuda"])
        tied_wall = time.perf_counter() - t0
    finally:
        tied_mod.train_tied = train_tied
    if rc != 0 or len(results) != 1:
        raise AssertionError(f"train_embedded --tied exit {rc}")
    tsum = json.loads((root / "tied" / "summary.json").read_text())
    if not tsum["n_senones"] < len(tris) * 3:
        raise AssertionError(f"--tied: {tsum['n_senones']} senones for {len(tris)} units x 3 states")
    hist = np.asarray(results[0].log_prob_history)
    drops = (hist[1:] - hist[:-1]) / np.abs(hist[:-1])
    if (drops < -1e-4).any():
        raise AssertionError(f"--tied: log-probability decreased: {hist.tolist()}")
    if sorted(json.loads((root / "tied" / "senone_map.json").read_text())) != tris:
        raise AssertionError("--tied: senone_map.json does not name every unit")
    out = {"phase": "train_embedded_cli", "units": len(names), "train_strings": len(train_seqs),
           "held_out": len(held_seqs), "iterations": summary["iterations"], "wer_percent": wer,
           "mono_wall_s": mono_wall, "triphones": len(tris), "n_senones": tsum["n_senones"],
           "tied_history": hist.tolist(), "tied_wall_s": tied_wall}
    emit(out)
    return out


def composed_bounds(ids, banks, feats, lengths, diag, full) -> dict:
    """The bound of each composed kernel on one batch (see bound()):
    inputs read once, outputs written once; operations of the frames the
    kernels step (emission: every frame of the padded T, as the kernel
    computes them; lattices and moments: t < length)."""
    banks = banks if isinstance(banks, tuple) else (banks,)
    B, T, D = feats.shape
    LS = ids.shape[1]
    nd = diag.shape[0]
    lens = lengths.tolist()
    stepped = valid_frames(lens, T)
    used = int(sum(min(int(n), T) for n in lens))
    lat = 4 * T * LS * B
    em_ops = sum(mixture_ops(D, bk.shape[1], full) for bk in banks)
    Cm = (D + D * D + 1) if full else (2 * D + 1)
    mom_out = sum(4 * bk.shape[0] * bk.shape[1] * Cm for bk in banks)
    mom_ops = sum(bk.shape[1] * (2 * Cm + 6) for bk in banks)
    return {
        "bank_emission": bound(numel_bytes(ids, *banks, feats) + lat, T * B * LS * em_ops),
        "composed_forward": bound(2 * lat + numel_bytes(diag, lengths), stepped * LS * (5 * nd + 4)),
        "composed_backward_stats": bound(4 * lat + numel_bytes(diag, lengths) + 4 * (nd + 4) * LS * B,
                                         stepped * LS * (9 * nd + 10)),
        "bank_moments": bound(numel_bytes(ids, *banks, lengths) + 4 * used * (D + LS) + mom_out,
                              used * LS * (em_ops + mom_ops) + B * LS * sum(bk.shape[1] * Cm for bk in banks)),
    }


def phase_timing_composed(torch, emb: dict, tied: dict, smi: str) -> dict:
    """Each composed kernel and its twin at emb_c4 and tied_c5 (CUDA
    events: kernels median of 20, twins median of 3, in the order twin,
    kernel, kernel, twin), the kernels vs twins on those full-width inputs,
    one whole EM iteration through the kernels vs fused=False, and one
    kernel iteration under torch.profiler (device busy and idle shares)."""
    from srhmm_tpu_torch.ops.kernels import composed as kc
    from srhmm_tpu_torch.train import embedded as embm
    from srhmm_tpu_torch.train import tied as tt

    saved = composed_counts()
    out = {}
    for cell, src in (("emb_c4", emb), ("tied_c5", tied)):
        transcripts, feats, lengths = src["batch"]
        if cell == "emb_c4":
            models = src["models"]
            ids, banks, diag_row, diag_col, full = composed_inputs(torch, models, transcripts, feats, lengths)
            step = lambda fused: embm.embedded_em_step(models, transcripts, feats, lengths, fused=fused)
        else:
            td = src["tied"]
            full = False
            ids = tt._senone_ids(td, transcripts)
            banks = embm._pack_bank(td.senones, feats.shape[-1], full)
            diag_row, diag_col = embm._composed_diagonals(
                td.log_trans().to(torch.float32)[transcripts.long()], max(td.num_states - 1, 1))
            step = lambda fused: tt.tied_em_step(td, transcripts, feats, lengths, var_floor=0.1, fused=fused)
        check = composed_check(torch, ids, banks, feats, lengths, diag_row, diag_col, full, f"{cell} full width")
        lb = kc.bank_emission(ids, banks, feats, full)
        la = kc.composed_forward(lb, diag_col, lengths)
        log_z = la[-1, -1]
        valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
        bw = (lb, la, diag_row, lengths, torch.where(valid, log_z, 0.0), valid.to(torch.float32))
        gamma = kc.composed_backward_stats(*bw)[0]
        gamma_bst = gamma.permute(2, 1, 0).contiguous()
        calls = {
            "bank_emission": (lambda: kc.bank_emission_plain(ids, banks, feats, full),
                              lambda: kc.bank_emission(ids, banks, feats, full)),
            "composed_forward": (lambda: kc.composed_forward_plain(lb, diag_col, lengths),
                                 lambda: kc.composed_forward(lb, diag_col, lengths)),
            "composed_backward_stats": (lambda: kc.composed_backward_stats_plain(*bw),
                                        lambda: kc.composed_backward_stats(*bw)),
            "bank_moments_lattice": (lambda: kc.bank_moments_lattice_plain(ids, banks, feats, gamma, lengths, full),
                                     lambda: kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full)),
            "bank_moments": (lambda: kc.bank_moments_plain(ids, banks, feats, gamma_bst, lengths, full),
                             lambda: kc.bank_moments(ids, banks, feats, gamma_bst, lengths, full)),
        }
        bnd = composed_bounds(ids, banks, feats, lengths, diag_row, full)
        bnd["bank_moments_lattice"] = bnd["bank_moments"]
        rows = {}
        for name, (plain, kernel) in calls.items():
            plain_a = median_ms(torch, plain, warmup=1, reps=3)
            kern_a = median_ms(torch, kernel)
            kern_b = median_ms(torch, kernel)
            plain_b = median_ms(torch, plain, warmup=1, reps=3)
            rows[name] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b], "ms": min(kern_a, kern_b),
                          "best_plain_ms": min(plain_a, plain_b), **bnd[name]}
        it = timed_pair(torch, lambda: step(False), lambda: step(True))
        prof = profile_window(torch, lambda: step(True), kernel_keys=COMPOSED_KERNEL_NAMES)
        audio_s = int(lengths.sum()) * FRAME_S
        out[cell] = {"kernels": rows, "em_iteration": it, "worst_abs": check["worst"],
                     "em_audio_s_per_s": audio_s / (it["ms"] / 1e3),
                     "plain_em_audio_s_per_s": audio_s / (it["best_plain_ms"] / 1e3), "profile": prof}
        emit({"phase": "timing_composed", "config": cell, "B": int(feats.shape[0]), "T": int(feats.shape[1]),
              "LS": int(ids.shape[1]), "audio_s": audio_s, "kernel_reps": 20, "plain_reps": 3,
              "full_width_vs_twin_rel": check["rel"], **out[cell], "card": smi})
    set_composed_counts(saved)  # timing launches are not main-path launches
    return out


def main() -> int:
    import torch

    import srhmm_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    info = phase_device(torch)
    phase_build()
    worst_abs = phase_kernel(torch)
    worst_em = phase_kernel_em(torch)
    worst_dec = phase_kernel_decode(torch)
    worst_comp = phase_kernel_composed(torch)
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
        train_diag = phase_train(torch, "em_diag_S8_M3_D9", "diag", 8, 3, 9, (500, 501), tmp)
        train_full = phase_train(torch, "em_full_S6_M1_D9", "full", 6, 1, 9, (103, 214), tmp)
        phase_train_cli(torch, tmp)
        dec = phase_decode(torch, tmp)
        # the composed path: embedded and tied training at full width, then
        # the train_embedded CLI; launches counted over the three phases
        set_composed_counts({name: 0 for name, _ in COMPOSED_ROWS})
        emb = phase_embedded(torch)
        tied = phase_tied(torch)
        phase_train_embedded_cli(torch, tmp)
        comp_launches = composed_counts()
        for name, _ in COMPOSED_ROWS:
            if comp_launches[name] < 1:
                raise AssertionError(f"the embedded / tied main path launched {name} 0 times")
        t_full = phase_timing(torch, main_full, info["nvidia_smi"])
        phase_timing(torch, main_diag, info["nvidia_smi"])
        em_diag = phase_timing_em(torch, train_diag, info["nvidia_smi"])
        phase_timing_em(torch, train_full, info["nvidia_smi"])
        t_dec = phase_timing_decode(torch, dec, info["nvidia_smi"])
        t_comp = phase_timing_composed(torch, emb, tied, info["nvidia_smi"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fused_src = "srhmm_tpu_torch/csrc/fused_em.cu"
    em_launches = {k: train_diag["launches"][k] + train_full["launches"][k]
                   for k in ("emit_forward", "backward_stats")}
    # no single PyTorch call computes any of these functions: library_ms is null
    bkeys = ("bound_ms", "bound_by")
    decode_src = "srhmm_tpu_torch/csrc/word_loop_decode.cu"
    decode_rows = [
        ("word_loop_decode", 1, "srhmm_tpu/ops/pallas/decode_pallas.py:352"),
        ("word_loop_decode_k2", 2, "srhmm_tpu/ops/pallas/decode_pallas.py:718"),
        ("word_loop_decode_kn", 3, "srhmm_tpu/ops/pallas/decode_pallas.py:1050"),
    ]
    emit({"kernels": [
        {
            "name": "vocab_scores",
            "route": "cuda",
            "source": "srhmm_tpu_torch/csrc/vocab_scores.cu",
            "replaces": "srhmm_tpu/ops/pallas/scoring_pallas.py:301",
            "launches": launches,
            "max_abs_err": worst_abs,
            "ms": t_full["ms"],
            "plain_ms": t_full["plain_ms"],
            **{k: t_full[k] for k in bkeys},
            "library_ms": None,
        },
        {
            "name": "emit_forward",
            "route": "cuda",
            "source": fused_src,
            "replaces": "srhmm_tpu/ops/pallas/fused_em_pallas.py:350 (and :946, multi-stream)",
            "launches": em_launches["emit_forward"],
            "max_abs_err": worst_em["emit_forward"],
            "ms": em_diag["emit_forward"]["ms"],
            "plain_ms": em_diag["emit_forward"]["best_plain_ms"],
            **{k: em_diag["emit_forward"][k] for k in bkeys},
            "library_ms": None,
        },
        {
            "name": "backward_stats",
            "route": "cuda",
            "source": fused_src,
            "replaces": "srhmm_tpu/ops/pallas/fused_em_pallas.py:612 (and :1034, multi-stream)",
            "launches": em_launches["backward_stats"],
            "max_abs_err": worst_em["backward_stats"],
            "ms": em_diag["backward_stats"]["ms"],
            "plain_ms": em_diag["backward_stats"]["best_plain_ms"],
            **{k: em_diag["backward_stats"][k] for k in bkeys},
            "library_ms": None,
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": decode_src,
            "replaces": where,
            "launches": dec["launches"][name],
            "max_abs_err": worst_dec[name],
            "ms": t_dec[K]["ms"],
            "plain_ms": t_dec[K]["best_plain_ms"],
            **{k: t_dec[K][k] for k in bkeys},
            "library_ms": None,
        }
        for name, K, where in decode_rows
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": COMPOSED_SRC,
            "replaces": where,
            "launches": comp_launches[name],
            "max_abs_err": max(worst_comp[name], t_comp["emb_c4"]["worst_abs"][name],
                               t_comp["tied_c5"]["worst_abs"][name]),
            "ms": t_comp["emb_c4"]["kernels"][name]["ms"],
            "plain_ms": t_comp["emb_c4"]["kernels"][name]["best_plain_ms"],
            **{k: t_comp["emb_c4"]["kernels"][name][k] for k in bkeys},
            "library_ms": None,
        }
        for name, where in COMPOSED_ROWS
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
