"""Vocabulary scoring: every utterance against every stacked word in one pass.

Counterpart of ``srhmm_tpu/ops/pallas/scoring_pallas.py``.  Three layers:

* ``pack_vocab_constants`` — the per-stream GEMM constants and banded
  log-transition diagonals, packed on the host in float64 and only then cast
  (an f32 Cholesky of real inverse covariances gives NaNs).  The layouts are
  the JAX package's, so both packages can be compared on the same arrays.
* ``vocab_scores`` — (T, D, B) features + packed constants -> (W*S, B) final
  log-alpha.  On CUDA tensors it launches the hand-written kernel
  ``csrc/vocab_scores.cu``; on CPU tensors it runs ``vocab_scores_plain``,
  the same function in eager PyTorch.  ``vocab_scores.launches`` counts
  kernel launches.
* ``score_batch_fused`` — (B, W) scores from an utterance batch: the
  counterpart of ``score_batch_fused_lane``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ...models.gmm_hmm import DIAG, FULL, GmmHmm
from .common import (
    _TINY,
    LOG_GAUS_CLAMP,
    NEG_INF,
    SMEM_LIMIT,
    dmax_for,
    mixture_records,
    trans_band,
)

MAX_STREAMS = 6
_THREADS = 128  # utterances per block; csrc/vocab_scores.cu kMaxThreads


def pack_vocab_constants(vocab: GmmHmm, dtype=torch.float32, stream: int = 0, device=None):
    """Packed constants for ONE stream of a stacked vocabulary.

    Returns (a, bias_g, bias, logw, diag, band) with rows ordered (w, s)
    within each plane, as tensors of ``dtype`` on ``device`` (default: the
    vocabulary's device).

    Diagonal covariance: a (M, W*S, 2D) lift rows; bias (M, W*S, 1) with the
    mixture log-weight FOLDED IN (no density clamp on the diag path);
    bias_g / logw are (1, 1, 1) dummies.

    Full covariance: the Cholesky z-GEMM (K = L L^T): a (M*D, W*S, D) with
    a[m*D + d, w*S + s] = row d of L^T for mixture m of state s of word w;
    bias_g (M*D, W*S, 1) = -(L^T mu)_d; bias (M, W*S, 1) the Gaussian
    normalizer alone; logw (M, W*S, 1) the log mixture weight, separate so
    the 1e20 density clamp lands between density and weight.  Degenerate
    mixtures: non-finite log|det| -> NEG_INF bias; finite det but non-PD
    inverse -> LOG_GAUS_CLAMP bias.

    diag (band+1, W*S, 1): diag[d][w*S + j] = log trans_w[j-d, j], NEG_INF
    where j < d or the transition is zero.
    """
    device = vocab.trans.device if device is None else device
    st = vocab.streams[stream]
    if st.cov_type not in (DIAG, FULL):
        raise ValueError("pack_vocab_constants: diag or full covariance")

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    mu = host(st.means)  # (W, S, M, D)
    k = host(st.inv_cov)
    w = host(st.weights)
    log_det = host(st.log_abs_det())
    W, S, M, D = mu.shape
    N = W * S
    norm = -0.5 * (D * math.log(2.0 * math.pi) + log_det)  # (W, S, M)
    logw = np.log(np.maximum(w, 1e-300))
    if st.cov_type == FULL:
        # np.linalg.cholesky raises on any non-PD matrix: factor each
        # mixture on its own when the batched call fails
        det_ok = np.isfinite(norm)
        try:
            chol = np.linalg.cholesky(k)
            pd_ok = np.ones((W, S, M), bool)
        except np.linalg.LinAlgError:
            chol = np.zeros_like(k)
            pd_ok = np.zeros((W, S, M), bool)
            for idx in np.ndindex(W, S, M):
                try:
                    chol[idx] = np.linalg.cholesky(k[idx])
                    pd_ok[idx] = True
                except np.linalg.LinAlgError:
                    pass
        ok = pd_ok & det_ok
        zmu = np.einsum("wsmed,wsme->wsmd", chol, mu)  # L^T mu
        chol = np.where(ok[..., None, None], chol, 0.0)
        zmu = np.where(ok[..., None], zmu, 0.0)
        bias = np.where(ok, norm, np.where(det_ok, LOG_GAUS_CLAMP, NEG_INF))
        a = np.transpose(chol, (2, 4, 0, 1, 3)).reshape(M * D, N, D)
        bias_g = -np.transpose(zmu, (2, 3, 0, 1)).reshape(M * D, N, 1)
        bias = np.transpose(bias, (2, 0, 1)).reshape(M, N, 1)
        logw_out = np.transpose(logw, (2, 0, 1)).reshape(M, N, 1)
    else:
        a = np.concatenate([mu * k, -0.5 * k], axis=-1)  # (W, S, M, 2D)
        a = np.transpose(a, (2, 0, 1, 3)).reshape(M, N, 2 * D)
        bias = -0.5 * np.sum(mu * mu * k, axis=-1) + logw + norm
        bias = np.transpose(bias, (2, 0, 1)).reshape(M, N, 1)
        bias_g = np.zeros((1, 1, 1))
        logw_out = np.zeros((1, 1, 1))

    trans = host(vocab.trans)  # (W, S, S)
    band = trans_band(trans)
    if band is None:
        raise ValueError("pack_vocab_constants: left-right (banded) models only")
    with np.errstate(divide="ignore"):
        lt = np.where(trans > 0, np.log(np.maximum(trans, 1e-300)), NEG_INF)
    j = np.arange(S)
    diag = np.full((band + 1, W, S), NEG_INF)
    for d in range(band + 1):
        cols = j[d:]
        diag[d, :, cols] = lt[:, cols - d, cols].T  # (W, S-d)
    diag = diag.reshape(band + 1, N, 1)

    def out(x):
        return torch.as_tensor(np.maximum(x, NEG_INF), dtype=dtype, device=device)

    return (
        torch.as_tensor(a, dtype=dtype, device=device),
        out(bias_g),
        out(bias),
        out(logw_out),
        out(diag),
        band,
    )


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _stream_shapes(featss, a_s):
    """Per-stream (D, M) and the covariance type, inferred from a's planes
    (2D wide: diagonal, D wide: full)."""
    ds = tuple(f.shape[1] for f in featss)
    fulls, ms = [], []
    for f_d, a in zip(ds, a_s):
        n_planes, _, a_w = a.shape
        if a_w not in (2 * f_d, f_d):
            raise ValueError(f"vocab_scores: constants of width {a_w} do not fit D={f_d}")
        full = a_w == f_d and a_w != 2 * f_d
        fulls.append(full)
        ms.append(n_planes // f_d if full else n_planes)
    if len(set(fulls)) != 1:
        raise ValueError("vocab_scores: homogeneous covariance across streams only")
    return ds, tuple(ms), fulls[0]


def _plain_stream_log_b(x, a, bias_g, bias, logw, n_dim, full):
    """(D, B) frame -> (N, B) per-state mixture logsumexp for one stream."""
    if full:
        M = a.shape[0] // n_dim
        z = torch.matmul(a, x) + bias_g  # (M*D, N, B)
        quad = (z * z).reshape(M, n_dim, *z.shape[1:]).sum(1)  # (M, N, B)
        q = torch.clamp(-0.5 * quad + bias, max=LOG_GAUS_CLAMP) + logw
    else:
        lift = torch.cat([x, x * x], dim=0)  # (2D, B)
        q = torch.matmul(a, lift) + bias  # (M, N, B)
    m = torch.clamp(q.max(dim=0).values, min=NEG_INF)
    e = torch.exp(q - m).sum(dim=0)
    return torch.log(torch.clamp(e, min=_TINY)) + m


def vocab_scores_plain(
    feats_tdb, a, bias_g, bias, logw, diag, lengths, s_word: int, band: int,
    semiring: str = "sum",
) -> torch.Tensor:
    """The scoring kernel's function in eager PyTorch: (T, D, B) features
    (a tuple of them for multi-stream) + packed constants (tuples likewise)
    -> (W*S, B) float32 final log-alpha.  semiring: "sum" = forward scores,
    "max" = Viterbi."""
    if semiring not in ("sum", "max"):
        raise ValueError(f"unknown semiring {semiring}")
    featss, a_s = _as_tuple(feats_tdb), _as_tuple(a)
    bias_gs, biass, logws = _as_tuple(bias_g), _as_tuple(bias), _as_tuple(logw)
    ds, _, full = _stream_shapes(featss, a_s)
    T, _, B = featss[0].shape
    N = a_s[0].shape[1]
    dev = featss[0].device
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    row = (torch.arange(N, device=dev) % s_word)[:, None]
    start = torch.where(row == 0, torch.zeros_like(neg), neg)
    lens = lengths.to(dev)
    la = None
    for t in range(T):
        log_b = None
        for p in range(len(featss)):
            lb = _plain_stream_log_b(
                featss[p][t].to(torch.float32), a_s[p], bias_gs[p], biass[p], logws[p], ds[p], full
            )
            log_b = lb if log_b is None else log_b + lb
        if t == 0:  # frame 0 is always taken
            la = torch.maximum(start + log_b, neg)
            continue
        terms = []
        for d in range(band + 1):
            sh = la if d == 0 else torch.where(row >= d, torch.roll(la, d, dims=0), neg)
            terms.append(sh + diag[d])
        terms = torch.stack(terms)
        m = torch.maximum(terms.max(dim=0).values, neg)
        if semiring == "max":
            upd = m
        else:
            e2 = torch.exp(terms - m).sum(dim=0)
            upd = torch.maximum(torch.log(torch.clamp(e2, min=_TINY)) + m, neg)
        new = torch.maximum(upd + log_b, neg)
        la = torch.where(lens > t, new, la)
    return la


def _kernel_constants(a_s, bias_gs, biass, logws, diag, ds, ms, W, S, band, full, dmax):
    """Re-lay the packed constants into one (W, C) block per word: per
    stream, the mixture records of csrc/emission.cuh, then the (band+1, S)
    diagonals; C is padded to a multiple of 4 floats."""
    parts, offs, off = [], [], 0
    for a, bg, bi, lw, D, M in zip(a_s, bias_gs, biass, logws, ds, ms):
        # the diagonal path folds log w into bias: its record stores 0
        rec = mixture_records(a, bg, bi, lw if full else None, D, M, W, S, full, dmax)
        parts.append(rec)
        offs.append(off)
        off += rec.shape[1]
    parts.append(diag.reshape(band + 1, W, S).permute(1, 0, 2).reshape(W, -1))
    diag_off = off
    off += (band + 1) * S
    if off % 4:
        parts.append(diag.new_zeros(W, 4 - off % 4))
    consts = torch.cat(parts, dim=1).contiguous()
    return consts, offs, diag_off


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the launcher's C signature declared."""
    from .build import load_library

    lib = load_library()
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.srhmm_vocab_scores.restype = c_int
    lib.srhmm_vocab_scores.argtypes = [
        ctypes.POINTER(c_ptr), ctypes.POINTER(c_int), ctypes.POINTER(c_int),
        ctypes.POINTER(c_int), c_int,  # feats, dims, mixes, offs, n_streams
        c_ptr, c_int, c_int, c_ptr, c_ptr,  # consts, C, diag_off, lengths, out
        c_int, c_int, c_int, c_int, c_int,  # T, B, W, S, band
        c_int, c_int, c_int, c_int, c_int,  # full, viterbi, dmax, threads, device
        c_ptr,  # stream
    ]
    return lib


def _vocab_scores_cuda(featss, a_s, bias_gs, biass, logws, diag, lengths, s_word, band, semiring):
    dev = featss[0].device
    tensors = [*featss, *a_s, *bias_gs, *biass, *logws, diag]
    if any(t.device != dev for t in [*tensors, lengths]):
        raise ValueError("vocab_scores: every tensor must be on the features' CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("vocab_scores: the CUDA kernel takes float32 tensors only")
    P = len(featss)
    if P > MAX_STREAMS:
        raise ValueError(f"vocab_scores: at most {MAX_STREAMS} streams, got {P}")
    ds, ms, full = _stream_shapes(featss, a_s)
    T, _, B = featss[0].shape
    N = a_s[0].shape[1]
    if N % s_word:
        raise ValueError("vocab_scores: rows are not a whole number of words")
    S, W = s_word, N // s_word
    if W > 65535:
        raise ValueError(f"vocab_scores: at most 65535 words per launch, got {W}")
    if any(f.shape[0] != T or f.shape[2] != B for f in featss) or lengths.shape != (B,):
        raise ValueError("vocab_scores: streams disagree on (T, B)")
    dmax = dmax_for(ds, "vocab_scores")
    consts, offs, diag_off = _kernel_constants(
        a_s, bias_gs, biass, logws, diag, ds, ms, W, S, band, full, dmax
    )
    C = consts.shape[1]
    smem = 4 * (C + 2 * S * _THREADS)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"vocab_scores: one word needs {smem} bytes of shared memory, "
            f"above the {SMEM_LIMIT}-byte budget of a block"
        )
    featss = [f.contiguous() for f in featss]
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((N, B), dtype=torch.float32, device=dev)

    lib = _kernel_library()
    ints = ctypes.c_int * P
    err = lib.srhmm_vocab_scores(
        (ctypes.c_void_p * P)(*[f.data_ptr() for f in featss]),
        ints(*ds), ints(*ms), ints(*offs), P,
        consts.data_ptr(), C, diag_off, lens.data_ptr(), out.data_ptr(),
        T, B, W, S, band, int(full), int(semiring == "max"), dmax, _THREADS,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.srhmm_cuda_error_string(err).decode()
        raise RuntimeError(f"vocab_scores kernel launch failed: CUDA error {err} ({msg})")
    vocab_scores.launches += 1
    return out


def vocab_scores(
    feats_tdb, a, bias_g, bias, logw, diag, lengths, s_word: int, band: int,
    semiring: str = "sum",
) -> torch.Tensor:
    """(T, D, B) features + packed constants (pack_vocab_constants) ->
    (W*S, B) final log-alpha of every word at every utterance's last valid
    frame.  Multi-stream: pass tuples for feats_tdb / a / bias_g / bias /
    logw, one entry per stream, homogeneous covariance, shared diag.

    CUDA tensors launch the hand-written kernel (csrc/vocab_scores.cu) and
    count one in ``vocab_scores.launches``; CPU tensors run
    ``vocab_scores_plain``.  Nothing falls back from one to the other."""
    if semiring not in ("sum", "max"):
        raise ValueError(f"unknown semiring {semiring}")
    featss = _as_tuple(feats_tdb)
    kind = featss[0].device.type
    if kind == "cpu":
        return vocab_scores_plain(
            feats_tdb, a, bias_g, bias, logw, diag, lengths, s_word, band, semiring
        )
    if kind != "cuda":
        raise ValueError(f"vocab_scores: no implementation for device {featss[0].device}")
    return _vocab_scores_cuda(
        featss, _as_tuple(a), _as_tuple(bias_g), _as_tuple(bias), _as_tuple(logw),
        diag, lengths, s_word, band, semiring,
    )


vocab_scores.launches = 0


def pack_batch(vocab: GmmHmm, batch):
    """(args, kwargs) for ``vocab_scores`` / ``vocab_scores_plain`` from a
    stacked vocabulary and an UtteranceBatch (or a per-stream tuple of
    them): features as float32 (T, D, B), constants packed onto the
    features' device."""
    P = len(vocab.streams)
    if any(st.cov_type not in (DIAG, FULL) for st in vocab.streams):
        raise ValueError("score_batch_fused: diag/full covariance only")
    if len({st.cov_type for st in vocab.streams}) != 1:
        raise ValueError("score_batch_fused: homogeneous covariance only")
    batches = _as_tuple(batch)
    if len(batches) != P:
        raise ValueError(f"score_batch_fused: {P} streams need {P} feature batches")
    dev = batches[0].features.device
    packs = [pack_vocab_constants(vocab, torch.float32, stream=p, device=dev) for p in range(P)]
    feats_tdb = tuple(
        b.features.to(torch.float32).permute(1, 2, 0).contiguous() for b in batches
    )
    if P == 1:
        feats_tdb, consts = feats_tdb[0], packs[0][:4]
    else:
        consts = tuple(tuple(pk[i] for pk in packs) for i in range(4))
    args = (feats_tdb, *consts, packs[0][4], batches[0].lengths)
    return args, {"s_word": vocab.trans.shape[-1], "band": packs[0][5]}


def scores_from_log_alpha(
    la: torch.Tensor, s_word: int, mode: str = "total", final_states: torch.Tensor | None = None
) -> torch.Tensor:
    """(W*S, B) final log-alpha -> (B, W) scores: logsumexp over states
    ("total") or the final state ("final", gathered per word from
    ``final_states`` when given); NEG_INF-level scores become -inf."""
    N, B = la.shape
    S, W = s_word, N // s_word
    la = la.reshape(W, S, B)
    neg = torch.tensor(NEG_INF, dtype=la.dtype, device=la.device)
    if mode == "total":
        scores = torch.logsumexp(torch.maximum(la, neg), dim=1)  # (W, B)
        scores = torch.where(scores > NEG_INF / 2, scores, -torch.inf)
    else:
        if final_states is None:
            fin = la[:, S - 1, :]
        else:
            idx = final_states.to(device=la.device, dtype=torch.int64)
            fin = la[torch.arange(W, device=la.device), idx, :]
        scores = torch.where(fin > NEG_INF / 2, fin, -torch.inf)
    return scores.T


def score_batch_fused(
    vocab: GmmHmm,
    batch,
    mode: str = "total",
    semiring: str = "sum",
    final_states: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, W) scores of every utterance against every word through
    ``vocab_scores`` — the counterpart of ``score_batch_fused_lane``
    (srhmm_tpu/ops/pallas/scoring_pallas.py:473) and a drop-in for
    decode.scorer.score_batch_log for diagonal or full covariance.

    mode: "total" (logsumexp over states) or "final" (last state).
    semiring="max" gives Viterbi (best-path) scores instead of forward.
    final_states: optional (W,) per-word final-state indices for
    heterogeneous vocabularies (pad_stack_models); filler states are
    unreachable inside the kernel, so only "final" needs them.
    Multi-stream: pass ``batch`` as a tuple of per-stream UtteranceBatch
    objects (shared lengths).  The constants are packed onto the features'
    device; CUDA features run the kernel, CPU features the plain version.
    """
    args, kw = pack_batch(vocab, batch)
    la = vocab_scores(*args, **kw, semiring=semiring)
    return scores_from_log_alpha(la, kw["s_word"], mode, final_states)
