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
              of one E-step bitwise equal; then emit_forward alone at the
              launch shapes of torch_port_utils.EMIT_CHECK_CASES (band 0,
              8 slots, bands past the unrolled slots, dense and banded
              utterances across warps, the constants in device memory, a
              ragged last block, T shorter than a tile), failing unless
              every shape of EMIT_SHAPES was reached
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
              K = 1, 2, 3, 4) vs its twin: diag/full x unigram, bigram S=8,
              bigram S=6 (padded to 8 states) x one stream D=9/M=3 or two
              D=9/M=3 + D=3/M=2, heterogeneous final states, duplicated
              words (exact ties decided by the tie-breaks, also across the
              lanes of the bigram merge and the warps of the unigram
              argmax), entry states without a self-loop, B=37, T=95 with a
              zero-length and a length-1 row, and W=45, W=200 and W=400
              (arcs above shared memory) at a short T: final
              max|k-p|/max(|p|,1) <= 1e-5 with equal masks,
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
              the two gamma layouts bitwise equal; the moments also on
              hand-made gammas with all-zero 32-frame tiles beside tiles
              whose one non-zero frame is the first or the last;
              composed_forward and composed_backward_stats alone at the
              launch shapes of torch_port_utils.LATTICE_CASES (failing
              unless each kernel's rows per lane, warps per utterance,
              ragged blocks, partial and short tiles and wide bands were
              reached)
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
    train_p2  train_fast on two streams (D=9/M=3 + D=3/M=2) at em_diag's
              B=2048, T=500: 5 iterations through the E-step kernels at P=2
    kernel_mfcc
              the MFCC kernel vs its twin over ten configurations (default,
              n_mels 40, hann, W=512/shift 128, include_energy, W=1024 with
              128 mels, W=551/shift 220 at 22,050 Hz, a prime W=397, W=480,
              an odd W=405 with include_energy: every FFT stage, radix 8,
              4, 2, 5, 3 and the generic odd-prime one, must be reached) on
              one batch of noise, a 300-sample (clamped) and a silent
              waveform, and synthesized speech (also 16-bit) at the
              default configuration: max|k-p| <= 1e-3 on the MFCC, two
              launches bitwise equal
    features_cli
              the features CLI on 64 WAV files of 2-9 s of synthesized
              speech at 30 dB SNR, every .perfil vs the twin within 1e-3
    pipeline  run_pipeline at bench.py:571-579's shape (3-word utterances,
              40 train / 16 test, 5 + 5 EM iterations, n_best=2) at clean,
              10 dB and 0 dB: WER <= 0.10 / 0.10 / 0.5; the pipeline CLI at
              its defaults: WER <= 0.10; the MFCC, composed and 2-best
              decode kernels each launched
    kernel_lattice
              the lattice kernels (csrc/lattice.cu: forward_lattice /
              backward_lattice and their blocked wrappers, log_forward_batch
              shared and per row, viterbi_batch) vs their twins: S = 3, 6,
              8, 16, 64 x delta 1, delta 2, dense, B=37, T=95 with a
              zero-length and a length-1 row, k_block 1, 5, 19 (bitwise the
              unblocked kernel), a duplicated-state tie for Viterbi: within
              BOUND, equal masks and backpointers, two launches bitwise equal
    kernel_emission
              emission_log_b / emission_stats (csrc/emission_em.cu) vs their
              twins: D = 3, 9, 13, 39 x M = 1, 3, 16, N=4133 (off every
              tile), a zero-weight mixture, -inf log b rows: log b within
              BOUND, moments within STAT_BOUND, two launches bitwise equal
    lane_em   the slice at full width (em_diag, the model phase train
              trained): e_step_fused and e_step_lane_major(lattices=
              "pallas") vs e_step within STAT_BOUND, the lattice kernels vs
              the plain scans within BOUND, 3 EM iterations through
              e_step_fused vs e_step (rtol 2e-4), log_forward_batch at
              em_diag and per row at diag10 (20,480 rows) vs its twin and vs
              the vocab_scores kernel (1e-4), viterbi_batch (pointer
              mismatches <= 1e-4); each of the eight kernels launched
  4 timing    every kernel and its plain version at the main-path shapes, and
              one whole EM iteration through the kernels vs fused=False;
              CUDA events, median of 20 after warm-up (the decode, composed,
              P=2 E-step and MFCC twins: median of 3); each kernel's bound
              from its inputs; timing_composed adds torch.profiler over one
              embedded / tied EM iteration (its idle share), the share of
              moments tiles skipped and the moments' dense bound
              (dense_bound_ms); timing_em and timing_mfcc add each
              kernel's own device time (torch.profiler) beside the CUDA
              events around its call, timing_em the fused iteration's
              device busy time and idle share; timing_mfcc is the cell
              mfcc_b256_10s (256 waveforms of 10 s in one launch), with the
              same function as torch.fft.rfft and two matmuls beside it;
              timing_lane times #15-#22 at em_diag (#15 also at diag10) and
              one E-step through e_step_fused, e_step_lane_major("pallas")
              and e_step_fused_lane, with torch.profiler's idle share

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
TF32_TC_OPS_PER_S = 495e12  # dense TF32 tensor-core rate (NVIDIA H100 SXM data sheet)


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


def em_case(torch, cov, band, mixes_dims, lens, S=6, seed=0, shared_gaussians=False):
    """One E-step's CUDA inputs from a seed: (feats, packed, origins, trans,
    lengths) for emit_forward / backward_stats.  band=None gives a dense
    random transition matrix, else a left-right one of that band.
    shared_gaussians: every mixture of a state gets mixture 0's Gaussian,
    so the posteriors are the mixture weights (none near 0 or 1)."""
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
    if shared_gaussians:
        for st in streams:
            for key in ("means", "inv_cov", "det"):
                st[key] = np.repeat(st[key][:, :1], st[key].shape[1], axis=1)
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


# backward_stats cases beyond the diag/full x band x P = 1, 2 grid:
# (cov, band, [(M, D) per stream], S); D=39 diagonal, full D=16, six
# streams, full D=16 M=16 (its accumulators only fit in the partials:
# backward_block's acc_global) and dense S=10 (transition slots past the
# registers' kXiRegs)
EM_EXTRA_CASES = [
    ("diag", 1, [(3, 39)], 6),
    ("full", 1, [(2, 16)], 6),
    ("diag", 2, [(3, 9), (2, 3), (2, 5), (1, 7), (3, 4), (2, 6)], 6),
    ("full", 1, [(16, 16)], 6),
    ("diag", None, [(3, 9)], 10),
]


def port_utils():
    """tests/torch_port_utils.py: the test inputs shared with
    tests/test_torch_cuda.py (no JAX)."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_port_utils

    return torch_port_utils


def kernel_em_cases(fe) -> list:
    """phase_kernel_em's E-steps, (cov, band, [(M, D) per stream], lengths,
    S): diag/full x band 1, 2, dense x P = 1, 2 at random lengths (B=37,
    T=95, rows of length 0 and 1), then EM_EXTRA_CASES at lengths on the
    backward-stats tile edges, then two utterances of 2 and 3 frames (their
    mixtures share one Gaussian: em_case's shared_gaussians)."""
    rng = np.random.default_rng(2025)
    lens = [int(n) for n in rng.integers(2, 95, size=34)] + [95, 0, 1]  # B=37, T=95
    cases = [(cov, band, md, lens, 6) for cov in ("diag", "full") for band in (1, 2, None)
             for md in ([(3, 9)], [(3, 9), (2, 3)])]
    edges = port_utils().em_tile_lengths
    cases += [(cov, band, md, edges(np.random.default_rng(30 + i), 95, fe.BACKWARD_TILES[0]), S)
              for i, (cov, band, md, S) in enumerate(EM_EXTRA_CASES)]
    # moments of one or two frames, the posteriors the mixture weights: the
    # contraction's rounding is neither averaged away over many terms nor
    # hidden by posteriors of exactly 1
    cases += [("diag", 1, [(2, 9)], [2, 3], 2)]
    return cases


def emit_case_name(cov, band, mixes_dims, S, B, T) -> str:
    return f"{cov}_S{S}_band{band}_" + "_".join(f"M{M}D{D}" for M, D in mixes_dims) + f"_B{B}_T{T}"


def emit_cases(fe) -> dict:
    """Every emit_forward input of kernel_em and of its emit check, by name:
    (cov, band, [(M, D) per stream], lengths, S, shared_gaussians)."""
    out = {}
    for cov, band, md, lens, S in kernel_em_cases(fe):
        out["kernel_em_" + emit_case_name(cov, band, md, S, len(lens), max(lens))] = (cov, band, md, lens, S,
                                                                                     len(lens) == 2)
    pu = port_utils()
    for i, (cov, band, md, S, B, T) in enumerate(pu.EMIT_CHECK_CASES):
        out["emit_check_" + emit_case_name(cov, band, md, S, B, T)] = (cov, band, md, pu.emit_check_lengths(i, B, T),
                                                                      S, False)
    return out


def phase_kernel_em(torch) -> dict:
    """emit_forward and backward_stats vs their plain twins on the same CUDA
    tensors (kernel_em_cases); the twins' lattices feed both backward
    passes.  Fails unless a partial tile (T % TT != 0), skipped gamma
    columns (frames past a length) and accumulators in the partials were
    reached.  Then emit_check.  Returns the worst absolute error per
    kernel."""
    from srhmm_tpu_torch.ops.kernels import fused_em as fe

    worst = {"emit_forward": 0.0, "backward_stats": 0.0}
    saved = fe.emit_forward.launches, fe.backward_stats.launches
    reached, emit_seen = set(), set()
    for cov, band, mixes_dims, lens, S in kernel_em_cases(fe):
        feats, packed, origins, trans, lengths = em_case(torch, cov, band, mixes_dims, lens, S=S,
                                                         shared_gaussians=len(lens) == 2)
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
        occ = fe.occupancy(1, *args, band)
        emit_seen |= emit_reached(fe, args, band, lens)
        T = max(lens)
        skipped = sum(T - min(n, T) if v else T for n, v in zip(lens, valid.tolist()))
        reached |= {"partial_tile"} if T % occ["tile_frames"] else set()
        reached |= {"skipped_columns"} if skipped else set()
        reached |= {"acc_in_partials"} if not occ["acc_in_shared_memory"] else set()
        reached |= {"slots_past_registers"} if band is None and S > fe.XI_REGS else set()
        name = f"{cov}_S{S}_band{band}_" + "_".join(f"M{M}D{D}" for M, D in mixes_dims)
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
        emit({"phase": "kernel_em", "config": name, "B": len(lens), "T": T,
              "valid": int(vmask.sum()), "bitwise_repeat": bitwise, "block": occ,
              "skipped_columns": skipped, **{k: v["rel_err"] for k, v in res.items()}})
    want = {"partial_tile", "skipped_columns", "acc_in_partials", "slots_past_registers"}
    if reached != want:
        raise AssertionError(f"kernel_em reached {sorted(reached)}, not {sorted(want)}")
    worst["emit_forward"] = max(worst["emit_forward"], emit_check(torch, fe, emit_seen))
    fe.emit_forward.launches, fe.backward_stats.launches = saved  # comparison launches
    return worst


# the emit-forward launch shapes emit_check must see reached
EMIT_SHAPES = {"slots_2", "slots_4", "slots_8", "slots_generic", "band_0", "band_1", "band_2", "dense",
               "s_not_dividing_32", "utterance_across_warps", "ragged_block", "partial_tile", "short_tile",
               "streams_6", "length_0", "length_1", "consts_global"}


def emit_reached(fe, args, band, lens) -> set:
    """The launch shapes of EMIT_SHAPES one emit_forward call reaches, from
    the shape the wrapper chooses (fe.occupancy)."""
    occ = fe.occupancy(0, *args, band)
    S, B, T, P = args[3].shape[-1], len(lens), max(lens), len(args[0])
    out = {f"slots_{occ['slots'] or 'generic'}", "dense" if band is None else f"band_{band}"}
    out |= {"s_not_dividing_32"} if S <= 32 and 32 % S else set()
    out |= {"utterance_across_warps"} if occ["warps_per_utt"] > 1 else set()
    out |= {"ragged_block"} if B % occ["utts"] else set()
    out |= {"short_tile"} if T < occ["tile"] else ({"partial_tile"} if T % occ["tile"] else set())
    out |= {"streams_6"} if P == 6 else set()
    out |= {f"length_{n}" for n in (0, 1) if n in lens}
    out |= {"consts_global"} if occ["consts_global"] else set()
    return out & EMIT_SHAPES


def emit_check(torch, fe, seen: set) -> float:
    """emit_forward alone at tests/torch_port_utils.EMIT_CHECK_CASES vs its
    twin (log_b and log-alpha within BOUND, equal masks), two launches
    bitwise equal; fails unless these and the kernel_em launches (seen)
    reached every launch shape of EMIT_SHAPES.  Returns the worst absolute
    error."""
    pu = port_utils()
    worst = 0.0
    for i, (cov, band, mixes_dims, S, B, T) in enumerate(pu.EMIT_CHECK_CASES):
        lens = pu.emit_check_lengths(i, B, T)
        args = em_case(torch, cov, band, mixes_dims, lens, S=S)
        lb_k, la_k = fe.emit_forward(*args, band)
        lb_k2, la_k2 = fe.emit_forward(*args, band)
        lb_p, la_p = fe.emit_forward_plain(*args, band)
        torch.cuda.synchronize()
        name = emit_case_name(cov, band, mixes_dims, S, B, T)
        res = {"log_b": compare_lattice(lb_k, lb_p, f"emit_check {name} log_b"),
               "log_alpha": compare_lattice(la_k, la_p, f"emit_check {name} log_alpha")}
        if not (torch.equal(lb_k, lb_k2) and torch.equal(la_k, la_k2)):
            raise AssertionError(f"emit_check {name}: two launches differ")
        got = emit_reached(fe, args, band, lens)
        seen |= got
        worst = max(worst, res["log_b"]["max_abs_err"], res["log_alpha"]["max_abs_err"])
        emit({"phase": "kernel_em", "check": "emit", "config": name, "reached": sorted(got),
              "bitwise_repeat": True, **{k: v["rel_err"] for k, v in res.items()}})
    if seen != EMIT_SHAPES:
        raise AssertionError(f"emit_check reached {sorted(seen)}, not {sorted(EMIT_SHAPES)}")
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
    return {"res": out, "model": model, "trained": trained, "batch": batch, "launches": launches}


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


def em_bounds(out: dict, T: int, dims, full: bool, packed, trans, lengths, valid, band) -> None:
    """Adds each E-step kernel's bound (see bound()) and share of it to
    out["emit_forward"] / out["backward_stats"]; raises if a kernel's time
    is below its bound.  K1 reads the stepped frames' features and the
    constants and writes log_b and log_alpha (T, S, B); K2 reads them back
    with the features and writes xi, den_trans, den_mix and the moments.
    Per stepped frame and state: K1 the emission and the banded forward
    step; K2 the banded backward step with xi, and the emission again with
    the posteriors' moment multiply-adds (2 (L+1) per mixture, L = 2D or
    D + D^2).  K2's bound counts the emission and moments of the columns
    with a gamma that is not zero only (frames t < length of valid
    utterances: the kernel skips the others, which add nothing), the
    contraction's multiply-adds at the TF32 tensor-core rate, the rest at
    the fp32 rate, the larger of the three times; dense_bound_ms counts
    every stepped frame at the fp32 rate, as before the kernel skipped."""
    B = lengths.shape[0]
    S = trans.shape[-1]
    lens = lengths.tolist()
    frames = valid_frames(lens, T)
    kept = int(sum(min(int(n), T) for n, v in zip(lens, valid.tolist()) if v))
    nb = (band if band is not None else S - 1) + 1
    sum_d = sum(D for D, _ in dims)
    consts = sum(numel_bytes(*pk) for pk in packed) + numel_bytes(trans)
    em_ops = sum(mixture_ops(D, M, full) for D, M in dims)
    mom = sum(M * ((D + D * D if full else 2 * D) + 1) for D, M in dims)
    lattices = 4 * 2 * T * S * B
    out["emit_forward"].update(bound(4 * frames * sum_d + consts + lattices, frames * S * (em_ops + 4 * nb + 4)))
    k2_bytes = 4 * frames * sum_d + consts + lattices + 4 * (nb + 2) * S * B + 4 * S * mom
    dense = bound(k2_bytes, frames * S * (em_ops + 2 * mom + 8 * nb + 8))
    fp32_ops = frames * S * (8 * nb + 8) + kept * S * (em_ops + sum(6 * M for _, M in dims))
    tc_ops = kept * S * 2 * mom
    times = {"bytes": k2_bytes / HBM_BYTES_PER_S * 1e3,
             "operations": max(fp32_ops / FP32_OPS_PER_S, tc_ops / TF32_TC_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    out["backward_stats"].update({"bound_ms": times[by], "bound_by": by, "bound_bytes": k2_bytes,
                                  "bound_ops": fp32_ops, "bound_tensor_core_ops": tc_ops,
                                  "nonzero_gamma_columns": kept, "stepped_columns": frames,
                                  "skipped_column_share": 1.0 - kept / (T * B),
                                  "dense_bound_ms": dense["bound_ms"], "dense_bound_by": dense["bound_by"]})
    for name in ("emit_forward", "backward_stats"):
        row = out[name]
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["us_per_frame"] = row["ms"] / T * 1e3
        if row["share_of_bound"] > 1.0:
            raise AssertionError(f"{name}: {row['ms']} ms is below its bound {row['bound_ms']} ms")


def phase_timing_em(torch, train: dict, smi: str) -> dict:
    """emit_forward, backward_stats and one whole EM iteration (kernel path
    vs fused=False) at a train shape, on the trained phase's initial model:
    CUDA events around each call (the wrapper's host work included), each
    kernel's own device time and the fused iteration's device busy time and
    idle share under torch.profiler."""
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
    for name, fn in (("emit_forward", lambda: fe.emit_forward(*k1)), ("backward_stats", lambda: fe.backward_stats(*k2))):
        out[name]["kernel_device_ms"] = kernel_device_ms(torch, fn, f"{name}_kernel")
    out["em_iteration"]["profile"] = profile_window(
        torch, lambda: em_step(model, batch, fused=True, feats_tdb=feats_tdb, band=band),
        kernel_keys=("emit_forward_kernel", "backward_stats_kernel"))
    occ = {k: fe.occupancy(w, *k1) for k, w in (("emit_forward", 0), ("backward_stats", 1))}
    fe.emit_forward.launches, fe.backward_stats.launches = saved  # timing launches
    audio_s = train["res"]["frames"] * FRAME_S
    it = out["em_iteration"]
    D, M, full = feats_tdb.shape[1], model.mixture_numbers[0], model.streams[0].cov_type == "full"
    em_bounds(out, feats_tdb.shape[0], [(D, M)], full, packed, model.trans, batch.lengths, valid, band)
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


def kernel_decode_configs(rng) -> list:
    """(cov, W, S, bigram, [(M, D) per stream], variant, lengths, Ks) of
    kernel_decode.  variant: "hetero" = words of S and S-2 states (final
    states through exit_col); ("dup", a, c) = word c a copy of word a with
    the same arcs in and out (uniform unigram, or the bigram's row and
    column), so their tokens tie bitwise in both implementations and the
    lowest-row / lowest-plane tie-breaks alone decide pointers and word
    ids; "noloop" = no self-loop at the words' first states, words 0-19
    unreachable by the bigram."""
    lens37 = [int(n) for n in rng.integers(2, 95, size=34)] + [95, 0, 1]
    configs = []
    for cov in ("diag", "full"):
        for S, bigram in ((8, False), (8, True), (6, True)):
            for md in ([(3, 9)], [(3, 9), (2, 3)]):
                configs.append((cov, 5, S, bigram, md, None, lens37, (1, 2, 3)))
        for bigram in (False, True):
            configs.append((cov, 5, 8, bigram, [(3, 9)], "hetero", lens37, (1, 2, 3)))
            configs.append((cov, 5, 8, bigram, [(3, 9)], ("dup", 1, 3), lens37, (1, 2, 3, 4)))
    configs.append(("diag", 200, 8, True, [(4, 13)], None, [60, 0, 1] + [int(n) for n in rng.integers(2, 60, 34)],
                    (1, 2, 3)))
    # W off the multiples of 32, with a copy whose ties the bigram merge
    # settles across two lanes of one destination's group (sources 2 and 33
    # of G = 8 lanes) and the unigram argmax across two warps; a bigram whose
    # (W, W) arcs (640 KB) exceed a block's shared memory
    for bigram in (False, True):
        configs.append(("diag", 45, 8, bigram, [(3, 9)], ("dup", 2, 33), lens37, (1, 2, 3, 4)))
    # no self-loop at the entry states, and words 0-19 that no word may
    # follow (zero bigram columns): while every exit token is NEG_INF (the
    # first frames) an entry row's own candidates fall below NEG_INF, so the
    # bigram's NEG_INF-level cross candidates, tie-breaks and all, reach the
    # pointers (the 2-best runner-up rule, the K-best order)
    configs.append(("diag", 45, 8, True, [(3, 9)], "noloop", lens37, (1, 2, 3, 4)))
    configs.append(("diag", 400, 8, True, [(2, 9)], None, [40, 0, 1] + [int(n) for n in rng.integers(2, 40, 34)],
                    (1, 2, 3)))
    return configs


def kernel_decode_cases(torch):
    """The kernel_decode configurations on the card, one at a time: (name,
    args, kw, Ks, (vocab, batch, graph keywords, lengths)) with the decode
    wrappers' operands."""
    from srhmm_tpu_torch.io.dataset import pack_utterances
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, pad_stack_models, stack_models

    dev = torch.device("cuda")
    configs = kernel_decode_configs(np.random.default_rng(2026))
    for ci, (cov, W, S, bigram, md, variant, lens, Ks) in enumerate(configs):
        wrng = np.random.default_rng(100 + ci)
        sizes = [S - 2 * (i % 2) if variant == "hetero" else S for i in range(W)]
        leaves = [(left_right_trans(n, 2.0) if i % 2 == 0 else skip_trans(n),
                   [rand_stream(wrng, n, M, D, cov) for M, D in md]) for i, n in enumerate(sizes)]
        if variant == "noloop":
            leaves = [(port_utils().entry_without_loop(t), st) for t, st in leaves]
        dup = variant[1:] if isinstance(variant, tuple) else None
        if dup:
            leaves[dup[1]] = leaves[dup[0]]
        words = [gmm_hmm_from_numpy(t, st, f"w{i}") for i, (t, st) in enumerate(leaves)]
        vocab, fs = pad_stack_models(words) if variant == "hetero" else (stack_models(words), None)
        vocab = vocab.astype(torch.float32).to(dev)
        batches = tuple(pack_utterances([wrng.normal(size=(n, D)) * 3 for n in lens], pad_multiple=1,
                                        dtype=torch.float32, device=dev) for _, D in md)
        graph_kw = {"final_states": fs}
        if bigram:
            lm = np.log(wrng.dirichlet(np.ones(W), size=W))
            if dup:  # the copy's arcs in and out too: the two are interchangeable
                lm[:, dup[1]] = lm[:, dup[0]]
                lm[dup[1]] = lm[dup[0]]
            if variant == "noloop":
                lm[:, :20] = -np.inf
            graph_kw["lm_logprobs"] = lm
        args, kw = decode_operands(vocab, batches, graph_kw)
        tag = ("_dup" if dup == (1, 3) else f"_dup{dup[0]}_{dup[1]}") if dup else (f"_{variant}" if variant else "")
        name = f"{cov}_W{W}_S{S}_{'bigram' if bigram else 'unigram'}_P{len(md)}" + tag
        yield name, args, kw, Ks, (vocab, batches[0] if len(batches) == 1 else batches, graph_kw, lens)


def decode_wrapper(K: int) -> str:
    return DECODE_WRAPPERS[min(K, 3)]


def phase_kernel_decode(torch) -> dict:
    """The word-loop kernel vs its plain twin on the same CUDA tensors over
    kernel_decode_configs, at K = 1, 2, 3 (and 4): diag and full
    covariance; unigram, bigram at S=8 and bigram at S=6 (padded to 8
    states); one stream D=9/M=3 or two streams D=9/M=3 + D=3/M=2;
    heterogeneous word lengths (final states through exit_col); duplicated
    words (exact ties); B=37, T=95 with a zero-length and a length-1 row;
    W=45, W=200 and W=400 (arcs above shared memory) at a short T.  Returns
    the worst absolute error per wrapper."""
    from srhmm_tpu_torch.decode import continuous as dc
    from srhmm_tpu_torch.ops.kernels import decode as kd

    worst = {name: 0.0 for name in DECODE_WRAPPERS.values()}
    saved = decode_counts()
    for name0, args, kw, Ks, (vocab, batch, graph_kw, lens) in kernel_decode_cases(torch):
        for K in Ks:
            fk, bk = decode_kernel(args, kw, K)
            fk2, bk2 = decode_kernel(args, kw, K)
            fp, bp = kd.word_loop_decode_plain(*args, n_best=K, **kw)
            torch.cuda.synchronize()
            name = f"{name0}_K{K}"
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
            worst[decode_wrapper(K)] = max(worst[decode_wrapper(K)], res["max_abs_err"])
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


def kernel_device_ms(torch, fn, key: str, calls: int = 5):
    """A kernel's own device time per launch: torch.profiler over `calls`
    calls of fn, the device time of the kernels whose names contain key
    over the number of their launches the profiler saw (a window may lose
    some); None if it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and key in ev.key:
            dt = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if dt is None else dt
            count += ev.count
    return total / count / 1e3 if count else None


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
                         "chunk_table_kernel", "bank_moments_kernel", "sum_chunks_kernel")  # csrc/composed.cu
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
    # the emission ring at 2 and 1 rows, the moments batch at 2 and 1 tiles
    ("diag", 3, 4, [(32, 64)] * 6),
    ("diag", 3, 4, [(64, 39)] * 6),
    ("full", 3, 4, [(82, 16)]),
    ("diag", 3, 4, [(200, 39)]),
]


def composed_counts() -> dict:
    from srhmm_tpu_torch.ops.kernels import composed as kc

    return kc.launch_counts()


def set_composed_counts(counts: dict) -> None:
    from srhmm_tpu_torch.ops.kernels import composed as kc

    kc.set_launch_counts(counts)


class ClusteringStatsLaunches:
    """While installed, counts the composed-kernel launches made inside
    pipeline._bucketed_embedded_stats (the tree-clustering statistics of
    the pipeline and of train_embedded --tied, which import it at call
    time)."""

    def __enter__(self):
        import srhmm_tpu_torch.pipeline as pl

        self.module, self.orig, self.launches = pl, pl._bucketed_embedded_stats, 0

        def counted(*args, **kwargs):
            before = sum(composed_counts().values())
            out = self.orig(*args, **kwargs)
            self.launches += sum(composed_counts().values()) - before
            return out

        pl._bucketed_embedded_stats = counted
        return self

    def __exit__(self, *exc):
        self.module._bucketed_embedded_stats = self.orig


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


MOMENT_TILE = 32  # frames of a moments tile (csrc/composed.cu kTile)


def sparse_moments_check(torch, ids, banks, feats, lengths, full, what) -> dict:
    """The moments kernel vs its twin on sparse_gammas: twice (bitwise
    repeat) and in both gamma layouts (bitwise equal); max |k - p| <=
    STAT_BOUND max |p| per part.  Returns the worst absolute error."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    D = feats.shape[-1]
    as_t = lambda m: m if isinstance(m, tuple) else (m,)
    worst = 0.0
    sparse_gammas = port_utils().sparse_gammas

    for tag, gamma in sparse_gammas(ids, lengths, feats.shape[1], seed=ids.shape[1]).items():
        m_k = as_t(kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full))
        m_k2 = as_t(kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full))
        m_b = as_t(kc.bank_moments(ids, banks, feats, gamma.permute(2, 1, 0).contiguous(), lengths, full))
        m_p = as_t(kc.bank_moments_lattice_plain(ids, banks, feats, gamma, lengths, full))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(m_k, m_k2, m_b)):
            raise AssertionError(f"{what} {tag}: two moments runs (or the two gamma layouts) differ")
        for q, (a, b) in enumerate(zip(m_k, m_p)):
            for part, sl in (("x", slice(0, D)), ("xx", slice(D, -1)), ("w", slice(-1, None))):
                worst = max(worst, compare_stat(a[..., sl], b[..., sl], f"{what} {tag} mom{q}_{part}")["max_abs_err"])
    return worst


def forward_check(torch) -> float:
    """composed_forward vs its twin over torch_port_utils' LATTICE_CASES
    (log-alpha within BOUND with equal masks, two runs bitwise equal); fails
    unless every launch shape in question was reached: 1, 2 and 4 rows a
    lane, 2+ warps an utterance, a ragged block, a partial tile, T shorter
    than a tile, 16 diagonals, rows of length 0 and 1.  Returns the worst
    absolute error."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    utils = port_utils()
    worst, reached = 0.0, set()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for LS, nd, T, B in utils.LATTICE_CASES:
        args = utils.forward_lattice_case(torch.device("cuda"), 900 + LS, LS, nd, T, B)
        la_k, la_k2 = kc.composed_forward(*args), kc.composed_forward(*args)
        la_p = kc.composed_forward_plain(*args)
        torch.cuda.synchronize()
        what = f"forward LS{LS} nd{nd} T{T} B{B}"
        res = compare_lattice(la_k, la_p, what)
        worst = max(worst, res["max_abs_err"])
        if not torch.equal(la_k, la_k2):
            raise AssertionError(f"{what}: two runs differ")
        blk = kc.forward_block(LS, B, nd, sms)
        lens = set(args[-1].tolist())
        reached |= {("rows_per_lane", blk["rows_per_lane"])}
        reached |= {"warps_per_utterance"} if blk["warps"] > 1 else set()
        reached |= {"ragged_block"} if blk["utts"] > 1 and B % blk["utts"] else set()
        reached |= {"partial_tile"} if T > blk["tile"] and T % blk["tile"] else set()
        reached |= {"one_partial_tile"} if T < blk["tile"] else set()
        reached |= {"16_diagonals"} if nd == 16 else set()
        reached |= {f"length_{n}" for n in (0, 1) if n in lens}
        emit({"phase": "kernel_composed", "config": what, "block": blk, "rel_err": res["rel_err"],
              "bitwise_repeat": True})
    want = {("rows_per_lane", 1), ("rows_per_lane", 2), ("rows_per_lane", 4), "warps_per_utterance",
            "ragged_block", "partial_tile", "one_partial_tile", "16_diagonals", "length_0", "length_1"}
    if reached != want:
        raise AssertionError(f"forward_check reached {sorted(reached, key=str)}, not {sorted(want, key=str)}")
    return worst


def backward_check(torch) -> float:
    """composed_backward_stats vs its twin over torch_port_utils'
    LATTICE_CASES (gamma, xi,
    den_trans, den_mix within STAT_BOUND, two runs bitwise equal); fails
    unless every launch shape in question was reached.  Returns the worst
    absolute error."""
    from srhmm_tpu_torch.ops.kernels import composed as kc

    utils = port_utils()
    worst, reached = 0.0, set()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for LS, nd, T, B in utils.LATTICE_CASES:
        args = utils.backward_lattice_case(torch.device("cuda"), 700 + LS, LS, nd, T, B)
        st_k, st_k2 = kc.composed_backward_stats(*args), kc.composed_backward_stats(*args)
        st_p = kc.composed_backward_stats_plain(*args)
        torch.cuda.synchronize()
        what = f"backward LS{LS} nd{nd} T{T} B{B}"
        rel = {}
        for n, a, b, c in zip(("gamma", "xi", "den_trans", "den_mix"), st_k, st_p, st_k2):
            r = compare_stat(a, b, f"{what} {n}")
            rel[n] = r["rel_err"]
            worst = max(worst, r["max_abs_err"])
            if not torch.equal(a, c):
                raise AssertionError(f"{what}: two runs of {n} differ")
        blk = kc.backward_block(LS, B, nd, sms)
        reached |= {("rows_per_lane", blk["rows_per_lane"])}
        reached |= {"warps_per_utterance"} if blk["warps"] > 1 else set()
        reached |= {"ragged_block"} if blk["utts"] > 1 and B % blk["utts"] else set()
        reached |= {"partial_tile"} if T % blk["tile"] else set()
        reached |= {"one_partial_tile"} if T < blk["tile"] else set()
        reached |= {"wide_band"} if nd > 4 else set()
        emit({"phase": "kernel_composed", "config": what, "block": blk,
              "valid": int(args[-1].sum()), "bitwise_repeat": True, **rel})
    want = {("rows_per_lane", 1), ("rows_per_lane", 2), ("rows_per_lane", 4), "warps_per_utterance",
            "ragged_block", "partial_tile", "one_partial_tile", "wide_band"}
    if reached != want:
        raise AssertionError(f"backward_check reached {sorted(reached, key=str)}, not {sorted(want, key=str)}")
    return worst


def phase_kernel_composed(torch) -> dict:
    """The four composed kernels vs their twins on CUDA tensors at B=37,
    T=95 with a zero-length and a length-1 row: diag/full, S = 2, 3, 4
    (band 1, 2, 3), L = 1, 3, 5, 10, 12, one or two streams, utterance 0
    repeating one unit, the emb_c4 and tied_c5 bank widths; the moments
    also on hand-made sparse gammas (sparse_moments_check: all-zero
    32-frame tiles beside tiles whose one non-zero frame is the first or
    the last); every depth of the emission's record ring (3, 2, 1 rows)
    and of the moments batch (4, 2, 1 tiles).  Returns the worst absolute
    error per wrapper."""
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models
    from srhmm_tpu_torch.ops.kernels import composed as kc

    dev = torch.device("cuda")
    saved = composed_counts()
    worst = {name: 0.0 for name, _ in COMPOSED_ROWS}
    depths = set()
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
        sparse = sparse_moments_check(torch, ids, banks, feats, lengths, full, name)
        for k, v in out["worst"].items():
            worst[k] = max(worst[k], v)
        for k in ("bank_moments_lattice", "bank_moments"):
            worst[k] = max(worst[k], sparse)
        mixes, D = [M for M, _ in md], md[0][1]
        ring = kc.emission_ring(mixes, [kc.record_stride(D, full)] * len(mixes))
        slots = kc.moments_slots(mixes, D, full)
        depths |= {("ring", ring), ("slots", slots)}
        emit({"phase": "kernel_composed", "config": name, "B": len(lens), "T": max(lens), "LS": L * S,
              "emission_ring": ring, "moments_slots": slots,
              "bitwise_repeat": True, "gamma_layouts_bitwise_equal": True, **out["rel"],
              "zero_tile_gammas_max_abs": sparse})
    worst["composed_forward"] = max(worst["composed_forward"], forward_check(torch))
    worst["composed_backward_stats"] = max(worst["composed_backward_stats"], backward_check(torch))
    set_composed_counts(saved)  # comparison launches are not main-path launches
    want = {("ring", 3), ("ring", 2), ("ring", 1), ("slots", 4), ("slots", 2), ("slots", 1)}
    if depths != want:
        raise AssertionError(f"kernel_composed reached the buffer depths {sorted(depths)}, not {sorted(want)}")
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


def repaired_like(stream, like):
    """stream's weights and means after the M-step's treat_zero_det
    re-seed (train/em.py _repair_degenerate: a mixture whose log det falls
    below log 1e-20 takes its state's largest-determinant mixture's mean
    and covariance) with the mask and donors of `like`; both are updates
    without the re-seed, with leading state axes (..., M)."""
    from srhmm_tpu_torch.train.em import _repair_degenerate

    M = stream.weights.shape[-1]
    cov = stream.inv_cov.shape[stream.weights.dim():]
    w, mu, _, _ = _repair_degenerate(stream.weights.reshape(-1, M), stream.means.reshape(-1, M, stream.dim),
                                     stream.inv_cov.reshape(-1, M, *cov), like.log_det.reshape(-1, M),
                                     stream.cov_type)
    return w.reshape(stream.weights.shape), mu.reshape(stream.means.shape)


def em_comparison(torch, name, stats, update, unrepaired, start, params) -> dict:
    """Three EM iterations through the kernels (the second with
    gamma_lattice=False, kernel #13) and three with fused=False on the card
    from the same start.  stats(model, fused, gamma_lattice) -> (E-step
    statistics, log prob); update(model, statistics) -> the M-step's model;
    unrepaired(model, statistics) -> its emission stream without the
    treat_zero_det re-seed; params(model) -> (emission stream, trans).

    Checked: the two free-running log-prob histories within rtol 2e-4; each
    kernel iteration against one plain iteration from the same model, means
    and trans within 2e-3 of their scale over every mixture above the
    weight floor (1e-3) before and after.  The re-seed is a threshold on a
    mixture's log det: a mixture on it is re-seeded on one side only,
    whatever the summation order (PERF.md: tied_c5's senone 1363 at
    iteration 1), so the kernel side's means are compared after the plain
    side's re-seed (its mask and donors, repaired_like) applied to the
    kernel statistics' update; the states whose own masks differ are only
    reported.  Reported only: the free-running final parameters'
    divergence, since EM on mixtures with a few frames each (tied_c5: ~9
    frames a mixture in 39 dimensions) is chaotic, and fp32 summation
    orders put single mixtures on different paths within two iterations
    (PERF.md)."""
    from srhmm_tpu_torch.train.em import _LOG_ZERO_DET

    m, lps_k, steps = start, [], []
    for it in range(3):
        sk, lp = stats(m, True, it != 1)
        sp, lp_ref = stats(m, False, True)
        new = update(m, sk)
        (s0, _), (_, tr1), (s2, tr2) = params(m), params(new), params(update(m, sp))
        uk, up = unrepaired(m, sk), unrepaired(m, sp)
        w1, mu1 = (a.reshape(b.shape) for a, b in zip(repaired_like(uk, up), (s2.weights, s2.means)))
        floor = above_floor(s0.weights) & above_floor(w1) & above_floor(s2.weights)
        flipped = ((uk.log_det < _LOG_ZERO_DET) != (up.log_det < _LOG_ZERO_DET)).any(-1)
        lp_rel = abs(float(lp) - float(lp_ref)) / abs(float(lp_ref))
        if not lp_rel <= 2e-4:
            raise AssertionError(f"{name} iteration {it}: kernel vs plain log prob {float(lp)} vs {float(lp_ref)}")
        steps.append({"lp_rel": lp_rel, "mixtures_compared": int(floor.sum()),
                      "means_max_abs": param_close(name, f"iteration {it} means", mu1, s2.means, floor),
                      "trans_max_abs": param_close(name, f"iteration {it} trans", tr1, tr2,
                                                   np.ones(tuple(tr2.shape), bool)),
                      "reseed_flipped_states": torch.flatten(flipped).nonzero().flatten().tolist()})
        lps_k.append(lp)
        m = new
    fin_k = m
    m, lps_p = start, []
    for _ in range(3):
        sp, lp = stats(m, False, True)
        m = update(m, sp)
        lps_p.append(lp)
    lk = torch.stack(lps_k).double().cpu().numpy()
    lp = torch.stack(lps_p).double().cpu().numpy()
    lp_rel = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    if not lp_rel <= 2e-4:
        raise AssertionError(f"{name}: kernel vs plain log-prob histories {lk} vs {lp}")
    (sk, trk), (sp, trp) = params(fin_k), params(m)
    mask = above_floor(sk.weights) & above_floor(sp.weights)
    dmu = np.abs(sk.means.double().cpu().numpy() - sp.means.double().cpu().numpy()).max(-1)[mask]
    scale = float(sp.means.double().abs().max())
    return {"history_kernels": lk.tolist(), "history_plain": lp.tolist(), "lps_rel_vs_plain": lp_rel,
            "steps": steps, "free_running_means_max_abs": float(dmu.max()),
            "free_running_mixtures_beyond_2e-3_of_scale": int((dmu > 2e-3 * scale).sum()),
            "free_running_mixtures": int(mask.sum()), "means_scale": scale,
            "free_running_trans_max_abs": float((trk - trp).abs().max())}


def phase_embedded(torch) -> dict:
    """Embedded training at suite config 4's full width (emb_c4): P=40
    units, S=3, M=32, D=13 diagonal, B=512 utterances of L=12 units,
    T <= 512, models and data from a seed: em_comparison of
    embedded_em_step's E-step and M-step, then train_embedded on the same utterances (3
    iterations, its own buckets) against the kernel history."""
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy, stack_models
    from srhmm_tpu_torch.train import embedded as emb
    from srhmm_tpu_torch.train.em import update_stream

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

    def stats(m, fused, gamma_lattice):
        if fused:
            st = emb.batch_stats_fused(m, transcripts, feats, lengths, gamma_lattice=gamma_lattice)
        else:
            st = emb.batch_stats(m, transcripts, feats, lengths)
        return st, st.log_prob

    def update(m, st):
        return emb._unit_m_step(m, st, 0.0)

    def unrepaired(m, st):  # _unit_m_step's stream update, units folded into states
        folded = emb._unstack_stats_axis(st)
        stream = emb._reshape_stream(m.streams[0], (P * S,), 2)
        return update_stream(stream, folded.streams[0], folded.den_mix, 0.0, zero_det_threshold=-np.inf)

    def params(m):
        return m.streams[0], m.trans

    before = composed_counts()
    cmp = em_comparison(torch, "emb_c4", stats, update, unrepaired, start, params)
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


TIED_C5 = (700, 3, 2000, 16, 39, 1024, 10)  # P units, S, N senones, M, D, B utterances, L units each
TIED_C5_VAR_FLOOR = 0.1


def tied_c5_inputs(B: int):
    """tied_c5's senones (numpy leaves, the senones on the "state" axis),
    unit transitions, state map (P, S), transcripts (B, L) and B utterances
    (250-304 frames), drawn from seed 45 in this order."""
    P, S, N, M, D, _, L = TIED_C5
    rng = np.random.default_rng(45)
    senones = rand_stream(rng, N, M, D, "diag")
    sm = np.zeros((P, S), np.int64)
    for s, pool in enumerate(np.array_split(np.arange(N), S)):  # every senone used, the rest from the pool
        perm = rng.permutation(P)
        sm[perm[: len(pool)], s] = pool
        sm[perm[len(pool):], s] = rng.choice(pool, size=P - len(pool))
    trans = np.stack([left_right_trans(S, 3.0) for _ in range(P)])
    trs = rng.integers(0, P, size=(B, L))
    rows = sm[trs].reshape(B, L * S)
    utts = composed_dataset(rng, senones["weights"], senones["means"], senones["inv_cov"], rows, B, (250, 305))
    return senones, trans, sm, trs, utts


def phase_tied(torch) -> dict:
    """Tied-state training at suite config 5's full width (tied_c5): 700
    triphone units of S=3 sharing N=2000 senones of M=16, D=39 diagonal,
    B=1024 utterances of L=10 units, T <= 304, var_floor 0.1, from a seed:
    em_comparison of tied_em_step's E-step and M-step, then train_tied (3
    iterations)."""
    from srhmm_tpu_torch.models import tied_hmm_set_from_numpy
    from srhmm_tpu_torch.train import tied as tt
    from srhmm_tpu_torch.train.em import update_stream

    P, S, N, M, D, B, L, vf = *TIED_C5, TIED_C5_VAR_FLOOR
    t0 = time.perf_counter()
    senones, trans, sm, trs, utts = tied_c5_inputs(B)
    t_data = time.perf_counter() - t0
    tied0 = tied_hmm_set_from_numpy(senones, trans, sm, tuple(f"t{i:03d}" for i in range(P)))
    transcripts, feats, lengths = pad_batch(torch, utts, trs)
    start = tied0.astype(torch.float32).to("cuda")
    if not tt._tied_fused_eligible(start, transcripts, feats):
        raise AssertionError("tied_c5: the batch is not eligible for the composed kernels")

    def stats(t, fused, gamma_lattice):
        if fused:
            st = tt.tied_batch_stats_fused(t, transcripts, feats, lengths, gamma_lattice=gamma_lattice)
        else:
            st = tt.tied_batch_stats(t, transcripts, feats, lengths)
        return st, st[4]

    def update(t, st):
        return tt._apply_tied_update(t, st, vf)

    def unrepaired(t, st):
        return update_stream(t.senones, st[0], st[1], vf, zero_det_threshold=-np.inf)

    def params(t):
        return t.senones, t.trans

    before = composed_counts()
    cmp = em_comparison(torch, "tied_c5", stats, update, unrepaired, start, params)
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
        with ClusteringStatsLaunches() as stats_launches:
            rc = te_cli.main([str(root / "trans_tri.txt"), str(root / "tied"), "--tied", "--init", str(init),
                              "--scan-iters", "8", "--device", "cuda"])
        tied_wall = time.perf_counter() - t0
    finally:
        tied_mod.train_tied = train_tied
    if rc != 0 or len(results) != 1:
        raise AssertionError(f"train_embedded --tied exit {rc}")
    if stats_launches.launches < 1:
        raise AssertionError("--tied: the clustering statistics launched no composed kernel")
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
           "tied_history": hist.tolist(), "tied_wall_s": tied_wall,
           "clustering_stats_launches": stats_launches.launches}
    emit(out)
    return out




def moment_tiles(torch, gamma, lengths) -> dict:
    """The moments kernel's 32-frame tiles of one gamma (T, LS, B): tiles
    that hold frames t < length, and those whose gamma are all exactly 0
    there (skipped by the kernel's warp vote)."""
    T, LS, B = gamma.shape
    n_t = -(-T // MOMENT_TILE)
    on = torch.arange(n_t * MOMENT_TILE, device=gamma.device)[:, None] < lengths[None, :]  # (T', B)
    g = torch.zeros((n_t * MOMENT_TILE, LS, B), dtype=gamma.dtype, device=gamma.device)
    g[:T] = gamma
    nz = ((g != 0) & on[:, None, :]).reshape(n_t, MOMENT_TILE, LS, B).any(1)  # (n_t, LS, B)
    valid = on.reshape(n_t, MOMENT_TILE, B).any(1)[:, None, :].expand(n_t, LS, B)
    total, kept = int(valid.sum()), int((nz & valid).sum())
    return {"tiles": total, "tiles_skipped": total - kept,
            "tiles_skipped_share": (total - kept) / total if total else 0.0}


def record_bytes(banks, D: int, full: bool) -> int:
    """Bytes of the bank records that a function of D features reads:
    2D + 4 floats a diagonal record, (D + 1) D + 4 a full one (the packed
    stride pads the records to the compiled bound DMAX with zeros)."""
    per = (D + 1) * D + 4 if full else 2 * D + 4
    return sum(4 * bk.shape[0] * bk.shape[1] * per for bk in banks)


def composed_bounds(torch, ids, banks, feats, lengths, diag, full, gamma) -> dict:
    """The bound of each composed kernel on one batch (see bound()):
    inputs read once (the records without their padding, record_bytes),
    outputs written once; operations of the frames the
    kernels must step (emission: every frame of the padded T, as its output
    holds them; lattices: t < length).  The moments count the emission,
    posteriors and contraction of the (t, j, b) entries with gamma != 0 and
    t < length only (a zero gamma adds nothing), the contraction's
    multiply-adds at the TF32 tensor-core rate and the rest at the fp32
    rate, the larger of the three times; dense_bound_ms is the dense count
    (every t < length, every multiply-add at the fp32 rate)."""
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
    rec = record_bytes(banks, D, full)
    mom_bytes = numel_bytes(ids, lengths) + rec + 4 * used * (D + LS) + mom_out
    dense = bound(mom_bytes, used * LS * (em_ops + mom_ops) + B * LS * sum(bk.shape[1] * Cm for bk in banks))
    on = torch.arange(T, device=gamma.device)[:, None, None] < lengths[None, None, :]
    nz = int(((gamma != 0) & on).sum())
    fp32_ops = nz * (em_ops + sum(6 * bk.shape[1] for bk in banks))
    tc_ops = nz * sum(2 * bk.shape[1] * Cm for bk in banks)
    times = {"bytes": mom_bytes / HBM_BYTES_PER_S * 1e3, "operations": max(fp32_ops / FP32_OPS_PER_S,
                                                                           tc_ops / TF32_TC_OPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    moments = {"bound_ms": times[by], "bound_by": by, "bound_bytes": mom_bytes, "bound_ops": fp32_ops,
               "bound_tensor_core_ops": tc_ops, "nonzero_gamma_entries": nz,
               "dense_bound_ms": dense["bound_ms"], "dense_bound_by": dense["bound_by"]}
    return {
        "bank_emission": bound(numel_bytes(ids, feats) + rec + lat, T * B * LS * em_ops),
        "composed_forward": bound(2 * lat + numel_bytes(diag, lengths), stepped * LS * (5 * nd + 4)),
        "composed_backward_stats": bound(4 * lat + numel_bytes(diag, lengths) + 4 * (nd + 4) * LS * B,
                                         stepped * LS * (9 * nd + 10)),
        "bank_moments": moments,
    }


def phase_timing_composed(torch, emb: dict, tied: dict, smi: str) -> dict:
    """Each composed kernel and its twin at emb_c4 and tied_c5 (CUDA
    events: kernels median of 20, twins median of 3, in the order twin,
    kernel, kernel, twin), the kernels vs twins on those full-width inputs,
    one whole EM iteration through the kernels vs fused=False, and one
    kernel iteration under torch.profiler (device busy and idle shares).
    Also printed: each kernel's share of its bound (above 1 fails), the
    moments' 32-frame tiles and the share skipped (gamma all 0), the
    moments' dense bound beside the new one, and the moments'
    split: the device time of its kernels in one call (torch.profiler), its
    time on an all-zero gamma (scan, set-up, pass 2) and on a gamma with no
    zero tile."""
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
        bnd = composed_bounds(torch, ids, banks, feats, lengths, diag_row, full, gamma)
        bnd["bank_moments_lattice"] = bnd["bank_moments"]
        tiles = moment_tiles(torch, gamma, lengths)
        rows = {}
        for name, (plain, kernel) in calls.items():
            plain_a = median_ms(torch, plain, warmup=1, reps=3)
            kern_a = median_ms(torch, kernel)
            kern_b = median_ms(torch, kernel)
            plain_b = median_ms(torch, plain, warmup=1, reps=3)
            ms = min(kern_a, kern_b)
            rows[name] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b], "ms": ms,
                          "best_plain_ms": min(plain_a, plain_b), **bnd[name], "share_of_bound": bnd[name]["bound_ms"] / ms,
                          "us_per_frame": ms / gamma.shape[0] * 1e3}
            if rows[name]["share_of_bound"] > 1.0:
                raise AssertionError(f"{cell} {name}: {ms} ms is below its bound {bnd[name]['bound_ms']} ms")
        # the moments' split, read off its inputs: gamma all 0 (every tile
        # skipped: the scan, the chunk set-up and pass 2) and gamma 1/LS on
        # every frame t < length (no tile skipped)
        on = (torch.arange(gamma.shape[0], device=gamma.device)[:, None, None] < lengths[None, None, :])
        dense = on.expand_as(gamma).to(torch.float32) / gamma.shape[1]
        zero = torch.zeros_like(gamma)
        z_ms = median_ms(torch, lambda: kc.bank_moments_lattice(ids, banks, feats, zero, lengths, full))
        d_ms = median_ms(torch, lambda: kc.bank_moments_lattice(ids, banks, feats, dense, lengths, full))
        kept = tiles["tiles"] - tiles["tiles_skipped"]
        # one call under the profiler: the device time of its three kernels
        # (pass 0, 1, 2) against the wall of the call (host work of the wrapper)
        one = profile_window(torch, lambda: kc.bank_moments_lattice(ids, banks, feats, gamma, lengths, full),
                             kernel_keys=("chunk_table_kernel", "bank_moments_kernel", "sum_chunks_kernel"))
        split = {"device_ms": one["kernel_device_ms"], "device_busy_ms": one["device_busy_ms"],
                 "profiled_wall_ms": one["profiled_wall_ms"],
                 "zero_gamma_ms": z_ms, "dense_gamma_ms": d_ms, "dense_tiles": tiles["tiles"], "kept_tiles": kept,
                 "us_per_computed_tile": (d_ms - z_ms) / tiles["tiles"] * 1e3,
                 "scan_setup_share": z_ms / rows["bank_moments_lattice"]["ms"]}
        it = timed_pair(torch, lambda: step(False), lambda: step(True))
        prof = profile_window(torch, lambda: step(True), kernel_keys=COMPOSED_KERNEL_NAMES)
        audio_s = int(lengths.sum()) * FRAME_S
        out[cell] = {"kernels": rows, "em_iteration": it, "em_iteration_idle_share": prof["idle_share"],
                     "moment_tiles": tiles, "moments_split": split, "worst_abs": check["worst"],
                     "em_audio_s_per_s": audio_s / (it["ms"] / 1e3),
                     "plain_em_audio_s_per_s": audio_s / (it["best_plain_ms"] / 1e3), "profile": prof}
        emit({"phase": "timing_composed", "config": cell, "B": int(feats.shape[0]), "T": int(feats.shape[1]),
              "LS": int(ids.shape[1]), "audio_s": audio_s, "kernel_reps": 20, "plain_reps": 3,
              "full_width_vs_twin_rel": check["rel"], **out[cell], "card": smi})
    set_composed_counts(saved)  # timing launches are not main-path launches
    return out


# ---------------------------------------------------------------------------
# two-stream training (TPU kernels #4 / #5: the E-step kernels at P = 2)
# ---------------------------------------------------------------------------


def phase_train_p2(torch, train_diag: dict) -> dict:
    """train_fast on two streams at em_diag's shape: stream 1 the em_diag
    features (D=9, M=3), stream 2 D=3, M=2 features from the same
    wandering process (B=2048, T=500), from em_diag's initial stream 1 and
    a random stream 2; 5 iterations through the E-step kernels at P=2."""
    from srhmm_tpu_torch.io.dataset import UtteranceBatch
    from srhmm_tpu_torch.models import GmmHmm, gmm_hmm_from_numpy
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.train.em import train_fast

    batch1 = train_diag["batch"]
    B, T = batch1.features.shape[:2]
    S = train_diag["model"].num_states
    utts = make_dataset(24, B, S, 2, 3, (T, T + 1))
    feats2 = torch.as_tensor(np.stack(utts), dtype=torch.float32, device="cuda")
    batch2 = UtteranceBatch(feats2, batch1.lengths)
    rng = np.random.default_rng(25)
    stream2 = gmm_hmm_from_numpy(left_right_trans(S, 2.0), [rand_stream(rng, S, 2, 3, "diag")]).streams[0]
    init = train_diag["model"]
    model = GmmHmm(trans=init.trans, streams=[init.streams[0], stream2.astype(torch.float32).to("cuda")],
                   word="em_diag_p2")
    batch = (batch1, batch2)
    fe.emit_forward.launches = fe.backward_stats.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_fast(model, batch, max_iterations=5, threshold=-1.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"emit_forward": fe.emit_forward.launches, "backward_stats": fe.backward_stats.launches}
    for k, n in launches.items():
        if n < res.iterations:
            raise AssertionError(f"em_diag_p2: {k} launched {n} times for {res.iterations} iterations")
    hist = np.asarray(res.log_prob_history)
    if (np.diff(hist) / np.abs(hist[:-1]) < -1e-5).any():
        raise AssertionError(f"em_diag_p2: log-probability decreased: {hist.tolist()}")
    if not all(bool(torch.isfinite(s.means).all()) for s in res.model.streams):
        raise AssertionError("em_diag_p2: trained means are not finite")
    out = {"phase": "train_p2", "config": "em_diag_p2", "streams": [[3, 9], [2, 3]], "S": S, "B": B, "T": T,
           "iterations": res.iterations, "launches": launches, "history": hist.tolist(),
           "train_fast_wall_s": wall}
    emit(out)
    return {"model": model, "batch": batch, "launches": launches, "frames": int(batch1.lengths.sum())}


def phase_timing_em_p2(torch, p2: dict, smi: str) -> dict:
    """emit_forward and backward_stats at P=2 (em_diag_p2): CUDA events,
    kernels median of 20, twins median of 3, in the order twin, kernel,
    kernel, twin; bounds as phase_timing_em's, summed over the streams."""
    from srhmm_tpu_torch.ops.kernels import fused_em as fe
    from srhmm_tpu_torch.ops.kernels.common import trans_band

    model, batch = p2["model"], p2["batch"]
    band = trans_band(model.trans.cpu().numpy())
    feats = tuple(b.features.permute(1, 2, 0).contiguous() for b in batch)
    lengths = batch[0].lengths
    origins = tuple(s.means.mean(dim=(0, 1)) for s in model.streams)
    packed = tuple(fe.pack_lane_constants(s, torch.float32, origin=o) for s, o in zip(model.streams, origins))
    k1 = (feats, packed, origins, model.trans, lengths, band)
    lb, la = fe.emit_forward(*k1)
    log_z = la[-1, -1]
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    k2 = (feats, lb, la, packed, origins, model.trans, lengths, torch.where(valid, log_z, 0.0),
          valid.to(torch.float32), band)
    saved = fe.emit_forward.launches, fe.backward_stats.launches
    out = {}
    for name, plain, kernel in (("emit_forward", lambda: fe.emit_forward_plain(*k1), lambda: fe.emit_forward(*k1)),
                                ("backward_stats", lambda: fe.backward_stats_plain(*k2),
                                 lambda: fe.backward_stats(*k2))):
        plain_a = median_ms(torch, plain, warmup=1, reps=3)
        kern_a, kern_b = median_ms(torch, kernel), median_ms(torch, kernel)
        plain_b = median_ms(torch, plain, warmup=1, reps=3)
        out[name] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b], "ms": min(kern_a, kern_b),
                     "best_plain_ms": min(plain_a, plain_b),
                     "kernel_device_ms": kernel_device_ms(torch, kernel, f"{name}_kernel")}
    fe.emit_forward.launches, fe.backward_stats.launches = saved  # timing launches
    em_bounds(out, feats[0].shape[0], [(s.dim, s.num_mixtures) for s in model.streams], False, packed,
              model.trans, lengths, valid, band)
    emit({"phase": "timing_em", "config": "em_diag_p2", "P": 2, "kernel_reps": 20, "plain_reps": 3, **out,
          "audio_s": p2["frames"] * FRAME_S, "card": smi})
    return out


# ---------------------------------------------------------------------------
# the MFCC frontend (csrc/mfcc.cu) and the end-to-end pipeline
# ---------------------------------------------------------------------------

MFCC_SRC = "srhmm_tpu_torch/csrc/mfcc.cu"
# kernel vs twin: max |k - p| on the MFCC, the JAX package's own
# compiled-vs-interpret gate for this kernel (bench.py:547-549)
MFCC_BOUND = 1e-3
PIPELINE_STAGES = ("synthesize", "mfcc", "lbg_init", "monophone_em", "tree_cluster", "tied_em",
                   "materialize", "decode", "wer")
PIPELINE_KERNELS = ("mfcc", "bank_emission", "composed_forward", "composed_backward_stats",
                    "bank_moments_lattice", "word_loop_decode_k2")


def mfcc_configs() -> dict:
    from srhmm_tpu_torch.features.frontend import FrontendConfig

    return {
        "default": FrontendConfig(),
        "mels40": FrontendConfig(n_mels=40, n_mfcc=20),
        "hann": FrontendConfig(window="hann"),
        "w512_s128": FrontendConfig(frame_length=512, frame_shift=128),
        "energy": FrontendConfig(include_energy=True),
        "w1024_mels128": FrontendConfig(frame_length=1024, frame_shift=256, n_mels=128, n_mfcc=40),
        # W = 19 x 29: two generic odd-prime FFT stages; another sample rate
        "w551_22k": FrontendConfig(sample_rate=22_050, frame_length=551, frame_shift=220),
        # a prime W: one generic stage, a dense DFT of that length
        "w397_prime": FrontendConfig(frame_length=397),
        # W/2 = 240 = 8 x 2 x 5 x 3: the radix-2 and radix-3 butterflies
        "w480_radix3": FrontendConfig(frame_length=480),
        # an odd W = 405 = 5 x 3^4 (no real split step), with the frame energy
        "w405_energy": FrontendConfig(frame_length=405, include_energy=True),
    }


def mfcc_check_inputs() -> dict:
    """phase_kernel_mfcc's batches, name -> (config, waveforms): white noise
    of 5000 samples (29 frames, no tile multiple), a 300-sample waveform
    (one clamped frame), a silent one and 2 s of quiet noise; the default
    configuration (the pipeline's and the CLI's) adds two synthesized
    utterances, the second quantized to 16 bits."""
    from srhmm_tpu_torch.pipeline import PipelineConfig, synthesize_dataset

    rng = np.random.default_rng(2026)
    speech = synthesize_dataset(PipelineConfig(seed=7), 2, 0)[0]
    quantized = np.round(speech[1] / np.abs(speech[1]).max() * 0.9 * 32767.0) / 32768.0
    waves = [rng.normal(size=5000), rng.normal(size=300), np.zeros(4000), 0.1 * rng.normal(size=32000)]
    return {name: (cfg, waves + [speech[0], quantized] if name == "default" else waves)
            for name, cfg in mfcc_configs().items()}


def mfcc_compare(k, p, what: str) -> dict:
    """Kernel vs twin MFCC rows: equal shapes, finite, max |k - p| <=
    MFCC_BOUND; also reports max |k - p| / max(|p|, 1)."""
    k, p = k.double().cpu().numpy(), p.double().cpu().numpy()
    if k.shape != p.shape:
        raise AssertionError(f"{what}: kernel shape {k.shape} != twin shape {p.shape}")
    if not np.isfinite(k).all():
        raise AssertionError(f"{what}: kernel MFCC not finite")
    diff = np.abs(k - p)
    worst = float(diff.max())
    if not worst <= MFCC_BOUND:
        raise AssertionError(f"{what}: kernel vs twin max abs error {worst} > {MFCC_BOUND}")
    return {"max_abs_err": worst, "rel_err": float((diff / np.maximum(np.abs(p), 1.0)).max())}


def mfcc_ops(n_frames: int, n_samples: int, cfg) -> float:
    """fp32 operations the waveform -> MFCC function needs (a multiply-add
    counts two), with the DFT taken as a real-input FFT, 2.5 W log2 W a
    frame: pre-emphasis (2 a sample), the window (W), the FFT, the power (3 K),
    the mel product over the filterbank's nonzeros (2 nnz), the log floor
    (2 n_mels), the DCT (2 n_mels n_mfcc), the energy sum."""
    from srhmm_tpu_torch.features.frontend import mel_filterbank

    W, K = cfg.frame_length, cfg.frame_length // 2 + 1
    nnz = int(np.count_nonzero(mel_filterbank(cfg)))
    per = W + 2.5 * W * np.log2(W) + 3 * K + 2 * nnz + 2 * cfg.n_mels + 2 * cfg.n_mels * cfg.n_mfcc
    if cfg.include_energy:
        per += K + 2
    return float(n_frames * per + 2 * n_samples)


def mfcc_rfft_matmul(torch, samples, offsets, cfg):
    """The MFCC function composed of library calls on the card, a yardstick
    used nowhere in the port: pre-emphasis, framing by unfold (for
    waveforms of one length that are whole frames long: no index clamps),
    the window, torch.fft.rfft, the power, and two matrix products."""
    from srhmm_tpu_torch.features.frontend import _window, dct_matrix, mel_filterbank

    dev = samples.device
    x = samples.view(-1, int(offsets[1] - offsets[0]))
    y = torch.cat([x[:, :1], x[:, 1:] - cfg.preemphasis * x[:, :-1]], dim=1)
    frames = y.unfold(1, cfg.frame_length, cfg.frame_shift)
    spec = torch.fft.rfft(frames * torch.as_tensor(_window(cfg), dtype=torch.float32, device=dev), dim=-1)
    power = spec.real * spec.real + spec.imag * spec.imag
    mel = torch.as_tensor(mel_filterbank(cfg), dtype=torch.float32, device=dev)
    dct = torch.as_tensor(dct_matrix(cfg), dtype=torch.float32, device=dev)
    return (torch.log(torch.clamp(power @ mel, min=cfg.log_floor)) @ dct).reshape(-1, cfg.n_mfcc)


def write_wav(path: Path, x: np.ndarray, sr: int) -> None:
    """16-bit PCM mono WAV of a waveform in [-1, 1]."""
    import wave

    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def phase_kernel_mfcc(torch) -> float:
    """The MFCC kernel vs its twin on the same CUDA tensors over every
    mfcc_configs() entry, one launch each for mfcc_check_inputs()'s batch.
    Speech is left out of the configurations other than the default: there
    the narrower bands (128 mels) or the lower window sidelobes (hann) leave
    the weakest mel bands of noise-free synthetic speech with less power
    than the float32 rounding of the DFT sums, so any two summation orders
    (kernel and twin alike) differ there, by 2e-3 to 2e-2 in the MFCC
    (measured on the H100).  Two launches bitwise equal.  Fails unless the
    configurations reach every FFT stage of the kernel (radix 8, 4, 2, 5,
    3, the generic odd-prime stage) and both the real split step (even W)
    and the odd-W path.  Returns the worst absolute error."""
    from srhmm_tpu_torch.ops.kernels import mfcc as km

    saved = km.mfcc_fused.launches
    worst = 0.0
    reached = set()
    for name, (cfg, batch) in mfcc_check_inputs().items():
        samples, offsets = km.pack_waves(batch, "cuda")
        k = km.mfcc_fused(samples, offsets, cfg)
        k2 = km.mfcc_fused(samples, offsets, cfg)
        p = km.mfcc_plain(samples, offsets, cfg)
        torch.cuda.synchronize()
        res = mfcc_compare(k, p, f"kernel_mfcc {name}")
        if not torch.equal(k, k2):
            raise AssertionError(f"kernel_mfcc {name}: two launches differ")
        worst = max(worst, res["max_abs_err"])
        _, split, radices = km.fft_plan(cfg.frame_length)
        reached |= {r if r in km.BUTTERFLIES else "generic" for r in radices} | {"split" if split else "odd"}
        emit({"phase": "kernel_mfcc", "config": name, "waves": len(batch), "frames": int(k.shape[0]),
              "fft_radices": list(radices), "bitwise_repeat": True, **res})
    km.mfcc_fused.launches = saved  # comparison launches
    want = {*km.BUTTERFLIES, "generic", "split", "odd"}
    if reached != want:
        raise AssertionError(f"kernel_mfcc reached {sorted(map(str, reached))}, not {sorted(map(str, want))}")
    return worst


def phase_features_cli(torch, tmp: Path) -> float:
    """The features CLI on the card: 64 WAV files of 2-9 s of synthesized
    speech at 30 dB SNR (16-bit), every .perfil read back and held against
    the twin on the waveforms as the CLI read them.  The noise floor is a
    recording's: noise-free synthetic speech leaves its weakest mel bands
    near the float32 rounding of the DFT sums, where any two summation
    orders differ by up to ~6e-4 (a float32 emulation of the kernel's sums
    on the CPU; ~5e-5 at 30 dB).  Returns the worst absolute error."""
    import contextlib
    import io

    from srhmm_tpu_torch.cli import features as features_cli
    from srhmm_tpu_torch.features.frontend import FrontendConfig
    from srhmm_tpu_torch.io import read_perfil
    from srhmm_tpu_torch.ops.kernels import mfcc as km
    from srhmm_tpu_torch.pipeline import PipelineConfig, synthesize_dataset

    root = tmp / "features_cli"
    root.mkdir()
    waves = synthesize_dataset(PipelineConfig(min_words=6, max_words=24, snr_db=30.0, seed=5), 64, 0)[0]
    peak = max(float(np.abs(w).max()) for w in waves)
    names = [f"s{i:02d}" for i in range(len(waves))]
    for n, w in zip(names, waves):
        write_wav(root / f"{n}.wav", w / peak * 0.9, 16000)
    (root / "wavs.txt").write_text("".join(f"{root}/{n}.wav\n" for n in names))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = features_cli.main([str(root / "wavs.txt"), str(root / "out"), "--device", "cuda"])
    wall = time.perf_counter() - t0
    if rc != 0 or len(buf.getvalue().splitlines()) != len(names):
        raise AssertionError(f"features CLI exit {rc}:\n{buf.getvalue()[-2000:]}")
    xs = [features_cli.read_wav(root / f"{n}.wav")[0] for n in names]
    cfg = FrontendConfig()
    samples, offsets = km.pack_waves(xs, "cuda")
    twin = km.split_frames(km.mfcc_plain(samples, offsets, cfg), offsets, cfg)
    got = torch.cat([torch.as_tensor(read_perfil(root / "out" / f"{n}.perfil")) for n in names])
    res = mfcc_compare(got, torch.cat(twin), "features_cli")
    secs = [len(x) / cfg.sample_rate for x in xs]
    emit({"phase": "features_cli", "files": len(names), "seconds_min": min(secs), "seconds_max": max(secs),
          "audio_s": sum(secs), "frames": int(got.shape[0]), "cli_wall_s": wall, **res})
    return res["max_abs_err"]


def pipeline_counts() -> dict:
    from srhmm_tpu_torch.ops.kernels import mfcc as km

    comp, dec = composed_counts(), decode_counts()
    return {"mfcc": km.mfcc_fused.launches, **comp, **dec}


def set_pipeline_counts(counts: dict) -> None:
    from srhmm_tpu_torch.ops.kernels import mfcc as km

    km.mfcc_fused.launches = counts["mfcc"]
    set_composed_counts({k: counts[k] for k in composed_counts()})
    set_decode_counts({k: counts[k] for k in decode_counts()})


def phase_pipeline(torch) -> dict:
    """run_pipeline on the card at bench.py:571-579's shape (3-word
    utterances, n_train=40, n_test=16, 5 + 5 EM iterations, n_best=2,
    pad_multiple=128) at clean, 10 dB and 0 dB: WER <= 0.10, 0.10, 0.5;
    then the pipeline CLI with its defaults (48 / 16 / 8 / 8, clean): WER
    <= 0.10.  Launches are counted over the phase: the MFCC kernel, the
    four composed kernels and the 2-best decode kernel must each run."""
    import contextlib
    import dataclasses
    import io

    from srhmm_tpu_torch.cli import pipeline as pipeline_cli
    from srhmm_tpu_torch.pipeline import PipelineConfig, run_pipeline

    set_pipeline_counts({k: 0 for k in pipeline_counts()})
    base = PipelineConfig(min_words=3, max_words=3)
    out = {}
    for label, snr, gate in (("clean", None, 0.10), ("10db", 10.0, 0.10), ("0db", 0.0, 0.5)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ClusteringStatsLaunches() as stats_launches:
            res = run_pipeline(dataclasses.replace(base, snr_db=snr), n_train=40, n_test=16, max_iterations=5,
                               tied_iterations=5, n_best=2, pad_multiple=128, device="cuda")
        wall = time.perf_counter() - t0
        if stats_launches.launches < 1:
            raise AssertionError(f"pipeline {label}: the clustering statistics launched no composed kernel")
        if not res.wer.wer <= gate:
            raise AssertionError(f"pipeline {label}: WER {res.wer.wer} > {gate} ({res.hyps} vs {res.refs})")
        if not (np.isfinite(res.mono_log_prob) and np.isfinite(res.tied_log_prob)):
            raise AssertionError(f"pipeline {label}: log probabilities not finite")
        if not 3 <= res.n_senones < res.n_units * 3 or set(res.stage_seconds) != set(PIPELINE_STAGES):
            raise AssertionError(f"pipeline {label}: {res.n_senones} senones, stages {res.stage_seconds}")
        out[label] = {"wer": res.wer.wer, "ref_words": res.wer.num_ref_words, "n_senones": res.n_senones,
                      "n_units": res.n_units, "mono_iterations": res.mono_iterations,
                      "tied_iterations": res.tied_iterations, "mono_log_prob": res.mono_log_prob,
                      "tied_log_prob": res.tied_log_prob, "stage_seconds": res.stage_seconds, "wall_s": wall,
                      "clustering_stats_launches": stats_launches.launches}
        emit({"phase": "pipeline", "config": f"pipe_c3_{label}", "n_train": 40, "n_test": 16, **out[label]})
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = pipeline_cli.main(["--device", "cuda", "--quiet"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"pipeline CLI exit {rc}:\n{buf.getvalue()[-2000:]}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if not summary["wer"] <= 0.10:
        raise AssertionError(f"pipeline CLI: WER {summary['wer']} > 0.10")
    emit({"phase": "pipeline_cli", "args": "defaults (48/16/8/8, clean)", "summary": summary, "wall_s": wall})
    counts = pipeline_counts()
    launches = {k: counts[k] for k in PIPELINE_KERNELS}
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"the pipeline launched {k} 0 times")
    emit({"phase": "pipeline_launches", **launches})
    return {"runs": out, "cli": summary, "launches": launches}


def phase_timing_mfcc(torch, smi: str) -> dict:
    """Cell mfcc_b256_10s: 256 waveforms of 10 s at 16 kHz (default
    FrontendConfig: 998 frames each, 255,488 in all, 2,560 audio-s) in one
    launch.  CUDA events: kernel median of 20, twin median of 3, in the
    order twin, kernel, kernel, twin; the kernel vs the twin on these
    inputs; the bound from the samples read, the constants read and the
    MFCCs written against mfcc_ops (an FFT's count); beside it, for
    reference, the same function composed of torch.fft.rfft and two matrix
    products (mfcc_rfft_matmul, CUDA-event median of 20; no one PyTorch
    call computes it, so library_ms stays null)."""
    from srhmm_tpu_torch.features.frontend import FrontendConfig
    from srhmm_tpu_torch.ops.kernels import mfcc as km

    cfg = FrontendConfig()
    n_waves, n = 256, 10 * cfg.sample_rate
    rng = np.random.default_rng(31)
    samples = torch.as_tensor((0.1 * rng.standard_normal(n_waves * n)).astype(np.float32), device="cuda")
    offsets = np.arange(n_waves + 1, dtype=np.int64) * n
    saved = km.mfcc_fused.launches
    check = mfcc_compare(km.mfcc_fused(samples, offsets, cfg), km.mfcc_plain(samples, offsets, cfg),
                         "mfcc_b256_10s")
    plain = lambda: km.mfcc_plain(samples, offsets, cfg)
    kernel = lambda: km.mfcc_fused(samples, offsets, cfg)
    plain_a = median_ms(torch, plain, warmup=1, reps=3)
    kern_a, kern_b = median_ms(torch, kernel), median_ms(torch, kernel)
    plain_b = median_ms(torch, plain, warmup=1, reps=3)
    device_ms = kernel_device_ms(torch, kernel, "mfcc_kernel")
    km.mfcc_fused.launches = saved  # timing launches
    composed = lambda: mfcc_rfft_matmul(torch, samples, offsets, cfg)
    composed_err = float((composed() - km.mfcc_plain(samples, offsets, cfg)).abs().max())
    composed_ms = median_ms(torch, composed)
    frames = int(km.frame_offsets(offsets, cfg)[-1])
    table, ranges, _ = km._constants(cfg, samples.device)
    bnd = bound(4 * samples.numel() + 8 * 3 * (n_waves + 1) + numel_bytes(table, ranges) + 4 * frames * cfg.n_mfcc,
                mfcc_ops(frames, samples.numel(), cfg))
    ms = min(kern_a, kern_b)
    audio_s = n_waves * n / cfg.sample_rate
    res = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b], "ms": ms,
           "best_plain_ms": min(plain_a, plain_b), "frontend_audio_s_per_s": audio_s / (ms / 1e3),
           "plain_audio_s_per_s": audio_s / (min(plain_a, plain_b) / 1e3), **bnd,
           "share_of_bound": bnd["bound_ms"] / ms, "kernel_device_ms": device_ms, "rfft_matmul_ms": composed_ms,
           "rfft_matmul_vs_twin": composed_err, "fft_radices": list(km.fft_plan(cfg.frame_length)[2])}
    emit({"phase": "timing_mfcc", "config": "mfcc_b256_10s", "waves": n_waves, "frames": frames,
          "audio_s": audio_s, "kernel_reps": 20, "plain_reps": 3, "full_width_vs_twin": check, **res,
          "card": smi})
    return {**res, "max_abs_err": check["max_abs_err"]}


# ---------------------------------------------------------------------------
# the lattice, Viterbi and fused-emission kernels (csrc/lattice.cu,
# csrc/emission_em.cu; TPU kernels #15-#22)
# ---------------------------------------------------------------------------

LATTICE_SRC = "srhmm_tpu_torch/csrc/lattice.cu"
EMISSION_SRC = "srhmm_tpu_torch/csrc/emission_em.cu"
LANE_ROWS = [  # (wrapper, its module under ops/kernels, the TPU kernel it replaces, source)
    ("log_forward_batch", "forward", "srhmm_tpu/ops/pallas/forward_pallas.py:70", LATTICE_SRC),
    ("viterbi_batch", "forward", "srhmm_tpu/ops/pallas/forward_pallas.py:137", LATTICE_SRC),
    ("forward_lattice", "lattice", "srhmm_tpu/ops/pallas/lattice_pallas.py:102", LATTICE_SRC),
    ("backward_lattice", "lattice", "srhmm_tpu/ops/pallas/lattice_pallas.py:134", LATTICE_SRC),
    ("backward_lattice_blocked", "lattice", "srhmm_tpu/ops/pallas/lattice_pallas.py:253", LATTICE_SRC),
    ("forward_lattice_blocked", "lattice", "srhmm_tpu/ops/pallas/lattice_pallas.py:302", LATTICE_SRC),
    ("emission_log_b", "emission", "srhmm_tpu/ops/pallas/emission_pallas.py:72", EMISSION_SRC),
    ("emission_stats", "emission", "srhmm_tpu/ops/pallas/emission_pallas.py:142", EMISSION_SRC),
]
LANE_KERNEL_NAMES = ("lattice_forward_kernel", "lattice_backward_kernel", "viterbi_kernel",
                     "emission_log_b_kernel", "emission_stats_kernel", "sum_blocks_kernel")


def lane_wrapper(name: str):
    import importlib

    module = next(m for n, m, _, _ in LANE_ROWS if n == name)
    return getattr(importlib.import_module(f"srhmm_tpu_torch.ops.kernels.{module}"), name)


def lane_counts() -> dict:
    return {name: lane_wrapper(name).launches for name, *_ in LANE_ROWS}


def set_lane_counts(counts: dict) -> None:
    for name, n in counts.items():
        lane_wrapper(name).launches = n


def lattice_trans(rng, S: int, kind: str) -> np.ndarray:
    """(S, S) float32 log transitions, -inf off the band: left-right with
    delta 1 or 2, or dense."""
    if kind == "dense":
        t = rng.uniform(0.1, 1.0, size=(S, S))
    else:
        band = {"delta1": 1, "delta2": 2}[kind]
        t = np.zeros((S, S))
        for i in range(S):
            t[i, i : i + band + 1] = rng.uniform(0.2, 1.0, size=min(band + 1, S - i))
    t /= t.sum(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        return np.log(t).astype(np.float32)


def compare_clamped(k, p, what: str) -> dict:
    """compare_lattice, and the -1e30 floor: the entries at or below
    NEG_INF/2 (outside compare_lattice's mask) equal bit for bit.  Kernel
    and twin put a carry on the floor by the same single operations, so a
    kernel that lets a carry fall through the floor shows only here."""
    below = p <= NEG_INF / 2
    if not k[below].equal(p[below]):
        raise AssertionError(f"{what}: entries on the -1e30 floor differ between kernel and twin")
    return compare_lattice(k, p, what)


def pointer_mismatch(k, p, what: str) -> float:
    """Share of backpointers that differ; raises above POINTER_BOUND."""
    share = float((k != p).float().mean())
    if not share <= POINTER_BOUND:
        raise AssertionError(f"{what}: {share} of the backpointers differ (> {POINTER_BOUND})")
    return share


def phase_kernel_lattice(torch) -> dict:
    """#15-#20 vs their twins on the same CUDA tensors: S in 3, 6, 8, 16, 64
    (the largest the kernels take) x delta 1, delta 2, dense transitions;
    B=37, T=95 with a zero-length and a length-1 row, seven -inf entries
    of log b and one state made impossible from frame 5; the blocked wrappers at k_block 1, 5, 19 (bitwise the
    unblocked kernels); #15 with shared and per-row transitions; #16 with
    equal backpointers, and a configuration of two duplicated states whose
    candidates tie exactly.  Lattices and scores within BOUND with equal
    masks and equal entries on the floor (compare_clamped); two launches
    bitwise equal.  Returns the worst absolute error
    per wrapper."""
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl

    saved = lane_counts()
    worst = {name: 0.0 for name, *_ in LANE_ROWS[:6]}
    rng = np.random.default_rng(2027)
    lens = [int(n) for n in rng.integers(2, 95, size=34)] + [95, 0, 1]
    T, B = max(lens), len(lens)
    lengths = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
    cuda = lambda x: torch.as_tensor(x, device="cuda")
    for S in (3, 6, 8, 16, 64):
        for kind in ("delta1", "delta2", "dense"):
            lb_np = (rng.normal(size=(T, S, B)) * 2).astype(np.float32)
            lb_np[rng.integers(0, T, 7), rng.integers(0, S, 7), rng.integers(0, B, 7)] = -np.inf
            # state 0 of the full-length row impossible from frame 5: its
            # carry sits on the -1e30 floor while log b is -inf, the one
            # input where a carry without the floor would fall to -inf
            lb_np[5:, 0, lens.index(T)] = -np.inf
            lb, lt = cuda(lb_np), cuda(lattice_trans(rng, S, kind))
            res = {}
            for name, fn, plain in (("forward_lattice", kl.forward_lattice, kl.forward_lattice_plain),
                                    ("backward_lattice", kl.backward_lattice, kl.backward_lattice_plain)):
                k, k2, p = fn(lb, lt, lengths), fn(lb, lt, lengths), plain(lb, lt, lengths)
                blocked = getattr(kl, f"{name}_blocked")
                for kb in (1, 5, 19):
                    if not torch.equal(blocked(lb, lt, lengths, k_block=kb), k):
                        raise AssertionError(f"{name}_blocked k_block={kb} S={S} {kind}: differs from {name}")
                if not torch.equal(k, k2):
                    raise AssertionError(f"{name} S={S} {kind}: two launches differ")
                res[name] = compare_clamped(k, p, f"{name} S={S} {kind}")
                res[f"{name}_blocked"] = res[name]
            lb_bts = lb.permute(2, 0, 1).contiguous()
            rows = cuda(np.stack([lattice_trans(rng, S, ("delta1", "delta2", "dense")[b % 3]) for b in range(B)]))
            for tag, trans in (("shared", lt), ("per_row", rows)):
                k, k2 = kf.log_forward_batch(lb_bts, trans, lengths), kf.log_forward_batch(lb_bts, trans, lengths)
                if not torch.equal(k, k2):
                    raise AssertionError(f"log_forward_batch {tag} S={S} {kind}: two launches differ")
                r = compare_clamped(k, kf.log_forward_batch_plain(lb_bts, trans, lengths),
                                    f"log_forward_batch {tag} S={S} {kind}")
                res["log_forward_batch"] = max(res.get("log_forward_batch", r), r, key=lambda x: x["max_abs_err"])
            sc, bp = kf.viterbi_batch(lb_bts, lt, lengths)
            sc2, bp2 = kf.viterbi_batch(lb_bts, lt, lengths)
            sc_p, bp_p = kf.viterbi_batch_plain(lb_bts, lt, lengths)
            torch.cuda.synchronize()
            if not (torch.equal(sc, sc2) and torch.equal(bp, bp2)):
                raise AssertionError(f"viterbi_batch S={S} {kind}: two launches differ")
            if not torch.equal(bp, bp_p):
                raise AssertionError(f"viterbi_batch S={S} {kind}: backpointers differ from the twin")
            res["viterbi_batch"] = compare_clamped(sc, sc_p, f"viterbi_batch S={S} {kind}")
            for name, r in res.items():
                worst[name] = max(worst[name], r["max_abs_err"])
            emit({"phase": "kernel_lattice", "S": S, "trans": kind, "B": B, "T": T, "bitwise_repeat": True,
                  "bptr_equal": True, **{k: v["rel_err"] for k, v in res.items()}})
    # duplicated states 2 and 3: every candidate from them ties exactly
    S = 6
    p = rng.uniform(0.1, 1.0, size=(S, S))
    p[3, :] = p[2, :]
    p[:, 3] = p[:, 2]
    lt = cuda(np.log(p / p.sum(-1, keepdims=True)).astype(np.float32))
    lb = cuda((rng.normal(size=(B, T, S)) * 2).astype(np.float32))
    lb[..., 3] = lb[..., 2]
    sc, bp = kf.viterbi_batch(lb, lt, lengths)
    sc_p, bp_p = kf.viterbi_batch_plain(lb, lt, lengths)
    torch.cuda.synchronize()
    live = torch.arange(T, device="cuda")[None, :] < lengths[:, None].long()
    live[:, 0] = False  # row 0 and rows past a length are the identity
    if not torch.equal(bp, bp_p) or bool((bp[live] == 3).any()):
        raise AssertionError("viterbi_batch tie: backpointers differ from the twin or take the higher source")
    r = compare_lattice(sc, sc_p, "viterbi_batch tie")
    worst["viterbi_batch"] = max(worst["viterbi_batch"], r["max_abs_err"])
    emit({"phase": "kernel_lattice", "config": "viterbi_tie_S6", "bptr_equal": True,
          "ties_to_lowest": True, "viterbi_batch": r["rel_err"]})
    set_lane_counts(saved)  # comparison launches
    return worst


def emission_stream(torch, seed, S, M, D, zero_weight=True):
    """A random diagonal GmmStream (float32, cuda) with one zero-weight
    mixture."""
    from srhmm_tpu_torch.models import gmm_hmm_from_numpy

    rng = np.random.default_rng(seed)
    st = rand_stream(rng, S, M, D, "diag")
    if zero_weight:
        st["weights"][1, 0] = 0.0
    return gmm_hmm_from_numpy(left_right_trans(S, 2.0), [st]).astype(torch.float32).to("cuda").streams[0]


def phase_kernel_emission(torch) -> dict:
    """#21 / #22 vs their twins: D in 3, 9, 13, 39 x M in 1, 3, 16, S=8,
    N=4133 frames (off every tile: 128 a chunk, 2048 a block), a
    zero-weight mixture, 40 log b rows at -inf for the moments: log b
    within BOUND, each moment block within STAT_BOUND (kernel and twin
    each reading the log b of its own emission), two launches bitwise
    equal.  Returns the worst absolute error per wrapper."""
    from srhmm_tpu_torch.ops.kernels import emission as ke

    saved = lane_counts()
    worst = {"emission_log_b": 0.0, "emission_stats": 0.0}
    rng = np.random.default_rng(2028)
    S, N = 8, 4133
    for D in (3, 9, 13, 39):
        for M in (1, 3, 16):
            stream = emission_stream(torch, 100 * D + M, S, M, D)
            frames = torch.as_tensor(rng.normal(size=(N, D)) * 3, dtype=torch.float32, device="cuda")
            gamma = torch.as_tensor(rng.uniform(size=(N, S)), dtype=torch.float32, device="cuda")
            a, b = ke.pack_constants(stream)
            lb, lb2 = ke.emission_log_b(frames, a, b), ke.emission_log_b(frames, a, b)
            lb_p = ke.emission_log_b_plain(frames, a, b)
            r_lb = compare_lattice(lb, lb_p, f"emission_log_b D={D} M={M}")
            # each moments call reads the log b of its own emission, as in
            # the E-step: exp(min(q_m - log b, 0)) cancels two fp32 values of
            # size |q| (~400 at D=39), so a log b summed in another order
            # biases every posterior by a few ulps of |q| (1.6e-4 of the
            # moments' scale at D=39, M=1 on the H100)
            lb, lb_p = lb.clone(), lb_p.clone()
            lb[1000:1040] = lb_p[1000:1040] = -torch.inf
            st, st2 = ke.emission_stats(frames, gamma, lb, a, b), ke.emission_stats(frames, gamma, lb, a, b)
            st_p = ke.emission_stats_plain(frames, gamma, lb_p, a, b)
            torch.cuda.synchronize()
            if not (torch.equal(lb2, ke.emission_log_b(frames, a, b)) and torch.equal(st, st2)):
                raise AssertionError(f"emission D={D} M={M}: two launches differ")
            parts = {part: compare_stat(st[..., sl], st_p[..., sl], f"emission_stats D={D} M={M} {part}")
                     for part, sl in (("x", slice(0, D)), ("xx", slice(D, 2 * D)), ("w", slice(2 * D, None)))}
            worst["emission_log_b"] = max(worst["emission_log_b"], r_lb["max_abs_err"])
            worst["emission_stats"] = max(worst["emission_stats"], *(v["max_abs_err"] for v in parts.values()))
            emit({"phase": "kernel_emission", "D": D, "M": M, "S": S, "N": N, "bitwise_repeat": True,
                  "log_b": r_lb["rel_err"], **{f"mom_{k}": v["rel_err"] for k, v in parts.items()}})
    set_lane_counts(saved)  # comparison launches
    return worst


def stat_fields(st) -> dict:
    s0 = st.streams[0]
    return {"num_trans": st.num_trans, "den_trans": st.den_trans, "den_mix": st.den_mix,
            "w": s0.w, "x": s0.x, "xx": s0.xx}


def vocab_rows(torch, vocab, batch):
    """The (utterance, word) rows of vocabulary scoring for
    log_forward_batch's per-row form: log b (B*W, T, S) through the
    emission kernel (#21) word by word, per-row log transitions
    (B*W, S, S) and lengths (B*W,), rows ordered (utterance, word)."""
    from srhmm_tpu_torch.models import GmmStream
    from srhmm_tpu_torch.ops.kernels import emission as ke

    B, T, D = batch.features.shape
    W, S = len(vocab.word), vocab.num_states
    s = vocab.streams[0]
    flat = batch.features.reshape(B * T, D)
    per_word = []
    for w in range(W):
        sw = GmmStream(weights=s.weights[w], means=s.means[w], inv_cov=s.inv_cov[w], det=s.det[w],
                       cov_type=s.cov_type, log_det=s.log_det[w])
        per_word.append(ke.emission_log_b(flat, *ke.pack_constants(sw)).reshape(B, T, S))
    log_b = torch.stack(per_word, dim=1).reshape(B * W, T, S)
    lt = vocab.log_trans().to(torch.float32)[None].expand(B, W, S, S).reshape(B * W, S, S).contiguous()
    return log_b, lt, batch.lengths.repeat_interleave(W)


def readout_vs_vocab_scores(torch, la_final, vocab, batch, what: str) -> dict:
    """log_forward_batch's final-state and total readouts against the
    vocab_scores kernel's (#1) scores for the same pairs: max |a - b| /
    max(|b|, 1) <= 1e-4 over finite scores."""
    from srhmm_tpu_torch.ops.kernels.scoring import score_batch_fused

    B, W = batch.batch_size, len(vocab.word)
    out = {}
    for mode, ours in (("final", la_final[:, -1]), ("total", torch.logsumexp(la_final, dim=-1))):
        ref = score_batch_fused(vocab, batch, mode=mode).double().cpu().numpy()
        got = ours.reshape(B, W).double().cpu().numpy()
        fin = np.isfinite(ref) & (ref > NEG_INF / 2)
        if not ((got > NEG_INF / 2) == fin).all():
            raise AssertionError(f"{what} {mode}: finite masks differ from vocab_scores")
        rel = float(np.max(np.abs(got[fin] - ref[fin]) / np.maximum(np.abs(ref[fin]), 1.0)))
        if not rel <= 1e-4:
            raise AssertionError(f"{what} {mode}: log_forward_batch vs vocab_scores {rel} > 1e-4")
        out[mode] = rel
    return out


def phase_lane_em(torch, train_diag: dict, main_diag: dict) -> dict:
    """The slice at full width: em_diag (B=2048, T=500, S=8, M=3, D=9) from
    the model phase_train trained.  e_step_fused (#21, #22) and
    e_step_lane_major(lattices="pallas") (#20, #19) statistics vs the plain
    e_step within STAT_BOUND; the lattice kernels (#17, #18; bitwise the
    blocked ones) vs the plain (T, S, B) scans within BOUND; 3 EM
    iterations through e_step_fused + m_step vs through e_step (histories
    rtol 2e-4); #15 at em_diag (shared transitions) and at diag10 (W=10
    words x B=2048 utterances = 20,480 rows, per-row transitions) vs its
    twin, its readouts vs the vocab_scores kernel (#1) within 1e-4; #16 at
    em_diag vs its twin (scores within BOUND, backpointer mismatches <=
    POINTER_BOUND).  Launches are counted over the phase: each of the eight
    kernels must run."""
    from srhmm_tpu_torch.models import stack_models
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl
    from srhmm_tpu_torch.train import em

    model, batch = train_diag["trained"], train_diag["batch"]
    B, T, D = batch.features.shape
    S, lengths = model.num_states, batch.lengths
    set_lane_counts({name: 0 for name, *_ in LANE_ROWS})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_f = em.e_step_fused(model, batch)
    st_l = em.e_step_lane_major(model, batch, lattices="pallas")
    st_p = em.e_step(model, batch)
    worst = {name: 0.0 for name, *_ in LANE_ROWS}
    res = {}
    for tag, st in (("e_step_fused", st_f), ("e_step_lane_major", st_l)):
        ours, ref = stat_fields(st), stat_fields(st_p)
        res[tag] = {k: compare_stat(ours[k], ref[k], f"{tag} {k}")["rel_err"] for k in ours}
        lp_rel = abs(float(st.log_prob) - float(st_p.log_prob)) / abs(float(st_p.log_prob))
        if not lp_rel <= 1e-5 or float(st.num_valid) != float(st_p.num_valid):
            raise AssertionError(f"{tag}: log prob {float(st.log_prob)} vs {float(st_p.log_prob)}")
        res[tag]["log_prob"] = lp_rel
    # the lattice kernels on the em_diag emissions vs the plain scans
    a, bias = ke.pack_constants(model.streams[0])
    log_b = ke.emission_log_b(batch.features.reshape(B * T, D), a, bias).reshape(B, T, S)
    lb_tsb = log_b.permute(1, 2, 0).contiguous()
    lt = model.log_trans().to(torch.float32)
    la, lbw = kl.forward_lattice(lb_tsb, lt, lengths), kl.backward_lattice(lb_tsb, lt, lengths)
    k_block = next(k for k in (16, 8, 4, 2, 1) if T % k == 0)
    if not (torch.equal(la, kl.forward_lattice_blocked(lb_tsb, lt, lengths, k_block=k_block))
            and torch.equal(lbw, kl.backward_lattice_blocked(lb_tsb, lt, lengths, k_block=k_block))):
        raise AssertionError("lane_em: the blocked lattices differ from the unblocked")
    for name, got, scan in (("forward_lattice", la, em._log_forward_lattice_tb(lb_tsb, lt, lengths)),
                            ("backward_lattice", lbw, em._log_backward_lattice_tb(lb_tsb, lt, lengths))):
        r = compare_lattice(got, scan, f"lane_em {name} vs scan")
        res[f"{name}_vs_scan"] = r["rel_err"]
        worst[name] = worst[f"{name}_blocked"] = r["max_abs_err"]
    # three EM iterations through e_step_fused vs through e_step
    m_f = m_p = model
    hist_f, hist_p = [], []
    for _ in range(3):
        sf, sp = em.e_step_fused(m_f, batch), em.e_step(m_p, batch)
        hist_f.append(float(sf.log_prob))
        hist_p.append(float(sp.log_prob))
        m_f, m_p = em.m_step(m_f, sf), em.m_step(m_p, sp)
    hist_rel = float(np.max(np.abs(np.subtract(hist_f, hist_p)) / np.abs(hist_p)))
    if not hist_rel <= 2e-4:
        raise AssertionError(f"lane_em: EM histories {hist_f} vs {hist_p}")
    # #15 at em_diag (shared) and diag10 (per row), #16 at em_diag
    lf = kf.log_forward_batch(log_b, lt, lengths)
    r15 = compare_lattice(lf, kf.log_forward_batch_plain(log_b, lt, lengths), "log_forward_batch em_diag")
    x15 = readout_vs_vocab_scores(torch, lf, stack_models([model]), batch, "log_forward_batch em_diag")
    vocab, vb = main_diag["vocab"], main_diag["batch"]
    rows_lb, rows_lt, rows_len = vocab_rows(torch, vocab, vb)
    lf10 = kf.log_forward_batch(rows_lb, rows_lt, rows_len)
    r15_10 = compare_lattice(lf10, kf.log_forward_batch_plain(rows_lb, rows_lt, rows_len), "log_forward_batch diag10")
    x15_10 = readout_vs_vocab_scores(torch, lf10, vocab, vb, "log_forward_batch diag10")
    sc, bp = kf.viterbi_batch(log_b, lt, lengths)
    sc_p, bp_p = kf.viterbi_batch_plain(log_b, lt, lengths)
    r16 = compare_lattice(sc, sc_p, "viterbi_batch em_diag")
    mismatch = pointer_mismatch(bp, bp_p, "viterbi_batch em_diag")
    path_diff = int((kf.backtrace(bp, lengths, S - 1) != kf.backtrace(bp_p, lengths, S - 1)).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lane_counts()
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the lane_em main path launched {name} 0 times")
    worst["log_forward_batch"] = max(r15["max_abs_err"], r15_10["max_abs_err"])
    worst["viterbi_batch"] = r16["max_abs_err"]
    gamma = (torch.exp(torch.clamp(la + lbw - torch.where(lengths > 0, la[-1, -1], 0.0), max=0.0))
             * (torch.arange(T, device="cuda")[:, None] < lengths[None, :])[:, None, :])
    gamma = gamma.permute(2, 0, 1).reshape(B * T, S).contiguous()
    out = {"phase": "lane_em", "config": "em_diag_S8_M3_D9", "B": B, "T": T, "k_block": k_block,
           "vs_e_step": res, "em3_history_fused": hist_f, "em3_history_plain": hist_p,
           "em3_history_rel": hist_rel, "log_forward_batch_em_diag": r15["rel_err"],
           "log_forward_batch_em_diag_vs_vocab_scores": x15, "log_forward_batch_diag10_rows": int(rows_lb.shape[0]),
           "log_forward_batch_diag10": r15_10["rel_err"], "log_forward_batch_diag10_vs_vocab_scores": x15_10,
           "viterbi_batch": r16["rel_err"], "viterbi_bptr_mismatch_share": mismatch,
           "viterbi_path_positions_differing": path_diff, "launches": launches, "wall_s": wall}
    emit(out)
    return {"launches": launches, "worst": worst, "model": model, "batch": batch, "log_b": log_b,
            "lb_tsb": lb_tsb, "lt": lt, "a": a, "bias": bias, "gamma": gamma, "rows": (rows_lb, rows_lt, rows_len)}


def lane_bounds(lane: dict) -> dict:
    """The bound of each #15-#22 call timed at em_diag (see bound()):
    inputs read once, outputs written once; operations of the frames the
    recursions step (a logsumexp candidate ~5 operations, a max-plus one
    3) and of every frame for the emission and moments."""
    log_b, lt, lengths, a = lane["log_b"], lane["lt"], lane["batch"].lengths, lane["a"]
    B, T, S = log_b.shape
    M, D = a.shape[0], a.shape[1] // 2
    N = B * T
    stepped = valid_frames(lengths.tolist(), T)
    lat = 4 * T * S * B
    small = numel_bytes(lt, lengths)
    consts = numel_bytes(lane["a"], lane["bias"])
    rows_lb, rows_lt, rows_len = lane["rows"]
    R, T10, S10 = rows_lb.shape
    em_ops = mixture_ops(D, M, False)
    return {
        "log_forward_batch": bound(lat + small + 4 * B * S, stepped * S * (5 * S + 4)),
        "log_forward_batch_diag10": bound(numel_bytes(rows_lb, rows_lt, rows_len) + 4 * R * S10,
                                          valid_frames(rows_len.tolist(), T10) * S10 * (5 * S10 + 4)),
        "viterbi_batch": bound(2 * lat + small + 4 * B * S, stepped * S * (3 * S + 2)),
        "forward_lattice": bound(2 * lat + small, stepped * S * (5 * S + 4)),
        "backward_lattice": bound(2 * lat + small, stepped * S * (5 * S + 4)),
        "emission_log_b": bound(4 * N * D + consts + 4 * N * S, N * S * em_ops),
        "emission_stats": bound(4 * N * (D + 2 * S) + consts + 4 * S * M * (2 * D + 1),
                                N * S * (em_ops + M * (2 * (2 * D + 1) + 4))),
    }


def phase_timing_lane(torch, lane: dict, smi: str) -> dict:
    """Each of #15-#22 and its twin at em_diag (#15 also per row at diag10):
    CUDA events, kernels median of 20, twins median of 3, in the order twin,
    kernel, kernel, twin; each bound from its inputs.  Then one E-step at
    em_diag through e_step_fused, e_step_lane_major(lattices="pallas") and
    e_step_fused_lane (#2-#5, the yardstick), each on the host clock
    (median of 3 after a warm-up) and once under torch.profiler (device
    busy and idle shares)."""
    from srhmm_tpu_torch.ops.kernels import emission as ke
    from srhmm_tpu_torch.ops.kernels import forward as kf
    from srhmm_tpu_torch.ops.kernels import lattice as kl
    from srhmm_tpu_torch.ops.kernels.common import trans_band
    from srhmm_tpu_torch.train import em

    saved = lane_counts()
    model, batch = lane["model"], lane["batch"]
    log_b, lb_tsb, lt, a, bias = lane["log_b"], lane["lb_tsb"], lane["lt"], lane["a"], lane["bias"]
    lengths = batch.lengths
    B, T, D = batch.features.shape
    frames = batch.features.reshape(B * T, D)
    lb_flat = log_b.reshape(B * T, -1)
    rows = lane["rows"]
    calls = {
        "log_forward_batch": (kf.log_forward_batch_plain, kf.log_forward_batch, (log_b, lt, lengths)),
        "log_forward_batch_diag10": (kf.log_forward_batch_plain, kf.log_forward_batch, rows),
        "viterbi_batch": (kf.viterbi_batch_plain, kf.viterbi_batch, (log_b, lt, lengths)),
        "forward_lattice": (kl.forward_lattice_plain, kl.forward_lattice, (lb_tsb, lt, lengths)),
        "backward_lattice": (kl.backward_lattice_plain, kl.backward_lattice, (lb_tsb, lt, lengths)),
        "forward_lattice_blocked": (kl.forward_lattice_plain, lambda *x: kl.forward_lattice_blocked(*x, k_block=4),
                                    (lb_tsb, lt, lengths)),
        "backward_lattice_blocked": (kl.backward_lattice_plain, lambda *x: kl.backward_lattice_blocked(*x, k_block=4),
                                     (lb_tsb, lt, lengths)),
        "emission_log_b": (ke.emission_log_b_plain, ke.emission_log_b, (frames, a, bias)),
        "emission_stats": (ke.emission_stats_plain, ke.emission_stats, (frames, lane["gamma"], lb_flat, a, bias)),
    }
    bnd = lane_bounds(lane)
    bnd["forward_lattice_blocked"], bnd["backward_lattice_blocked"] = bnd["forward_lattice"], bnd["backward_lattice"]
    out = {}
    for name, (plain, kernel, args) in calls.items():
        plain_a = median_ms(torch, lambda: plain(*args), warmup=1, reps=3)
        kern_a, kern_b = median_ms(torch, lambda: kernel(*args)), median_ms(torch, lambda: kernel(*args))
        plain_b = median_ms(torch, lambda: plain(*args), warmup=1, reps=3)
        ms = min(kern_a, kern_b)
        out[name] = {"kernel_ms": [kern_a, kern_b], "plain_ms": [plain_a, plain_b], "ms": ms,
                     "best_plain_ms": min(plain_a, plain_b), **bnd[name], "share_of_bound": bnd[name]["bound_ms"] / ms}
    band = trans_band(model.trans.cpu().numpy())
    feats_tdb = batch.features.permute(1, 2, 0).contiguous()
    steps = {
        "e_step_fused": lambda: em.e_step_fused(model, batch),
        "e_step_lane_major_pallas": lambda: em.e_step_lane_major(model, batch, lattices="pallas"),
        "e_step_fused_lane": lambda: em.e_step_fused_lane(model, batch, feats_tdb, band),
    }
    e_steps = {}
    for name, fn in steps.items():
        fn()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        e_steps[name] = {"wall_ms": float(np.median(walls)), "walls_ms": walls,
                         "profile": profile_window(torch, fn, kernel_keys=LANE_KERNEL_NAMES + (
                             "emit_forward_kernel", "backward_stats_kernel"))}
    set_lane_counts(saved)  # timing launches are not main-path launches
    audio_s = int(lengths.sum()) * FRAME_S
    res = {"phase": "timing_lane", "config": "em_diag_S8_M3_D9", "B": B, "T": T, "kernel_reps": 20, "plain_reps": 3,
           "kernels": out, "e_step": e_steps,
           "e_step_audio_s_per_s": {k: audio_s / (v["wall_ms"] / 1e3) for k, v in e_steps.items()},
           "audio_s": audio_s, "card": smi}
    emit(res)
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
    worst_mfcc = phase_kernel_mfcc(torch)
    worst_lat = phase_kernel_lattice(torch)
    worst_lat.update(phase_kernel_emission(torch))
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
        train_p2 = phase_train_p2(torch, train_diag)
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
        # the frontend and the end-to-end pipeline; launches counted over
        # the pipeline phase (phase_pipeline)
        worst_mfcc = max(worst_mfcc, phase_features_cli(torch, tmp))
        pipe = phase_pipeline(torch)
        # the lattice / Viterbi / fused-emission path at em_diag and diag10;
        # launches counted over the phase (phase_lane_em)
        lane = phase_lane_em(torch, train_diag, main_diag)
        t_full = phase_timing(torch, main_full, info["nvidia_smi"])
        phase_timing(torch, main_diag, info["nvidia_smi"])
        em_diag = phase_timing_em(torch, train_diag, info["nvidia_smi"])
        phase_timing_em(torch, train_full, info["nvidia_smi"])
        em_p2 = phase_timing_em_p2(torch, train_p2, info["nvidia_smi"])
        t_dec = phase_timing_decode(torch, dec, info["nvidia_smi"])
        t_comp = phase_timing_composed(torch, emb, tied, info["nvidia_smi"])
        t_mfcc = phase_timing_mfcc(torch, info["nvidia_smi"])
        t_lane = phase_timing_lane(torch, lane, info["nvidia_smi"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fused_src = "srhmm_tpu_torch/csrc/fused_em.cu"
    em_launches = {k: train_diag["launches"][k] + train_full["launches"][k]
                   for k in ("emit_forward", "backward_stats")}
    # no single PyTorch call computes any of these functions (waveform ->
    # MFCC included): library_ms is null
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
            # the kernel's own device time (torch.profiler); ms includes the wrapper's host work
            "kernel_device_ms": em_diag["emit_forward"]["kernel_device_ms"],
            # P = 2 (TPU kernel #4): em_diag_p2
            "launches_p2": train_p2["launches"]["emit_forward"],
            "kernel_device_ms_p2": em_p2["emit_forward"]["kernel_device_ms"],
            "ms_p2": em_p2["emit_forward"]["ms"],
            "plain_ms_p2": em_p2["emit_forward"]["best_plain_ms"],
            **{f"{k}_p2": em_p2["emit_forward"][k] for k in bkeys},
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
            # P = 2 (TPU kernel #5): em_diag_p2
            "launches_p2": train_p2["launches"]["backward_stats"],
            "ms_p2": em_p2["backward_stats"]["ms"],
            "plain_ms_p2": em_p2["backward_stats"]["best_plain_ms"],
            **{f"{k}_p2": em_p2["backward_stats"][k] for k in bkeys},
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
            # the same kernel at tied_c5
            "ms_tied_c5": t_comp["tied_c5"]["kernels"][name]["ms"],
            "plain_ms_tied_c5": t_comp["tied_c5"]["kernels"][name]["best_plain_ms"],
            **{f"{k}_tied_c5": t_comp["tied_c5"]["kernels"][name][k] for k in bkeys},
        }
        for name, where in COMPOSED_ROWS
    ] + [
        {
            "name": "mfcc",
            "route": "cuda",
            "source": MFCC_SRC,
            "replaces": "srhmm_tpu/features/pallas_mfcc.py:39",
            "launches": pipe["launches"]["mfcc"],
            "max_abs_err": max(worst_mfcc, t_mfcc["max_abs_err"]),
            "ms": t_mfcc["ms"],
            "plain_ms": t_mfcc["best_plain_ms"],
            **{k: t_mfcc[k] for k in bkeys},
            "library_ms": None,
            "kernel_device_ms": t_mfcc["kernel_device_ms"],
            # the same function as torch.fft.rfft and two matmuls (a yardstick)
            "rfft_matmul_ms": t_mfcc["rfft_matmul_ms"],
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": where,
            "launches": lane["launches"][name],
            "max_abs_err": max(worst_lat[name], lane["worst"][name]),
            "ms": t_lane[name]["ms"],
            "plain_ms": t_lane[name]["best_plain_ms"],
            **{k: t_lane[name][k] for k in bkeys},
            "library_ms": None,
            # #15 with per-row transitions at diag10 (20,480 rows)
            **({f"{k}_diag10": t_lane["log_forward_batch_diag10"][v] for k, v in
                (("ms", "ms"), ("plain_ms", "best_plain_ms"), ("bound_ms", "bound_ms"), ("bound_by", "bound_by"))}
               if name == "log_forward_batch" else {}),
        }
        for name, _, where, src in LANE_ROWS
    ]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
