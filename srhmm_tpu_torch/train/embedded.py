"""Embedded re-estimation: Baum-Welch over transcript-composed HMM chains
(counterpart of ``srhmm_tpu/train/embedded.py``).

The reference trains each word model in isolation from pre-segmented
exemplars.  Phone-based systems instead train ALL unit models jointly from
whole utterances and their transcripts: each utterance's HMM is the
left-to-right concatenation of its transcript's unit models (the chain arc
unit k.exit -> unit k+1.entry carries the exit state's self-loop mass), the
forward-backward runs over the composed state space, and the per-position
statistics sum back onto the shared unit models.

Two E-step implementations:

* the plain path (``batch_stats``): per-utterance emissions on the gathered
  (L*S)-row parameter bank, the composed forward and backward lattices and
  every statistic as batched tensor code over an explicit utterance axis —
  any dtype and device, the float64 reference for the tests;
* the fused path (``batch_stats_fused``): the four composed-lattice kernels
  of ops/kernels/composed.py (csrc/composed.cu on CUDA float32 tensors,
  their plain twins on CPU tensors), diagonal or full covariance, one or
  more streams sharing the feature matrix, left-right unit transitions.

Unit-space sums are one-hot contractions (``composed.segment_sum``), whose
order is the same on every run; the M-step folds the unit axis into the
state axis and runs ``train/em.py::m_step`` once.  ``train_embedded``
buckets utterances by (padded length, transcript length) and runs the
chunked convergence driver (train/driver.py).

Data-parallel training (parallel/mesh.py): ``batch_stats_fused_sharded``,
``embedded_train_scan_sharded`` and ``train_embedded(mesh=)`` run each
rank's rows of every bucket and all-reduce the unit-space statistics once
an iteration.
"""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gmm_hmm import DIAG, FULL, GmmHmm, GmmStream
from ..ops.forward_backward import log_backward_full, log_forward_full
from ..ops.kernels import composed as kc
from ..ops.kernels.common import LOG_GAUS_CLAMP, NEG_INF, dmax_for, trans_band
from .em import StreamStats, SuffStats, gmm_moment_stats, m_step


def _composed_log_trans(unit_log_trans: torch.Tensor) -> torch.Tensor:
    """(..., L, S, S) per-position unit transitions -> (..., L*S, L*S)
    chain graph.  The chain arc k.exit -> (k+1).entry carries the exit
    state's self-loop mass (decode/continuous.compose_sequence)."""
    *lead, L, S, _ = unit_log_trans.shape
    lt = torch.full((*lead, L, S, L, S), -torch.inf, dtype=unit_log_trans.dtype,
                    device=unit_log_trans.device)
    for k in range(L):
        lt[..., k, :, k, :] = unit_log_trans[..., k, :, :]
    for k in range(L - 1):
        lt[..., k, S - 1, k + 1, 0] = unit_log_trans[..., k, S - 1, S - 1]
    return lt.reshape(*lead, L * S, L * S)


def _log_gauss_positional(feats, mu, k, log_abs_det, cov_type):
    """Per-mixture log-pdfs (B, T, N) of each utterance's frames against its
    own gathered mixtures: feats (B, T, D); mu (B, N, D); k (B, N, D) diag
    or (B, N, D, D) full; log_abs_det (B, N).  ops/emission.log_gauss with
    the utterance axis written out (a degenerate mixture gets -inf; full
    covariance clamps the density at log 1e20)."""
    dtype = feats.dtype
    D = feats.shape[-1]
    log_norm = -0.5 * (D * math.log(2.0 * math.pi) + log_abs_det.to(dtype))
    degenerate = ~torch.isfinite(log_norm)
    log_norm = torch.where(degenerate, torch.zeros_like(log_norm), log_norm)
    if cov_type == DIAG:
        w = torch.cat([mu * k, -0.5 * k], dim=-1)  # (B, N, 2D)
        bias = -0.5 * torch.sum(mu * mu * k, dim=-1)
        q = torch.bmm(torch.cat([feats, feats * feats], dim=-1), w.transpose(1, 2)) + bias[:, None]
        out = q + log_norm[:, None]
    elif cov_type == FULL:
        dif = feats[:, :, None, :] - mu[:, None]  # (B, T, N, D)
        quad = torch.einsum("btnd,bnde,btne->btn", dif, k, dif)
        out = torch.clamp(-0.5 * quad + log_norm[:, None], max=LOG_GAUS_CLAMP)
    else:
        raise ValueError(f"unknown cov_type {cov_type}")
    return torch.where(degenerate[:, None], -torch.inf, out)


def _gather_rows(stream: GmmStream, rows: torch.Tensor, lead: int):
    """The mixtures of parameter rows `rows` (B, LS) of a stream whose first
    `lead` axes index rows: (weights (B, LS, M), means (B, LS*M, D),
    inv_cov (B, LS*M, D[, D]), log|det| (B, LS*M))."""
    B, LS = rows.shape
    M = stream.num_mixtures
    r = rows.long()

    def take(a):
        flat = a.reshape(-1, *a.shape[lead:])
        return flat[r]

    tail = lambda a: a.reshape(B, LS * M, *a.shape[3:])
    return take(stream.weights), tail(take(stream.means)), tail(take(stream.inv_cov)), \
        take(stream.log_abs_det()).reshape(B, LS * M)


def _positional_stats(gathered, cov_types, pos_logt, feats, lengths):
    """The per-POSITION E-step shared by embedded and tied training.

    gathered: per stream the _gather_rows tuple of the utterances' L*S
    composed rows; pos_logt (B, L, S, S) per-position unit log-transitions;
    feats (B, T, D); lengths (B,).  Returns (stream StreamStats with
    (B, L*S, M, ...) tensors, den_mix (B, L, S), xi (B, L, S, S) with the
    chain flow folded into the exit self-loops, den_trans (B, L, S), log_z
    (B,), valid (B,)), every statistic zero for invalid utterances."""
    B, L, S, _ = pos_logt.shape
    T = feats.shape[1]
    LS = L * S
    dtype = feats.dtype
    dev = feats.device
    lengths = lengths.to(dev)

    log_b, posts = None, []
    for (w, mu, k, lad), cov in zip(gathered, cov_types):
        M = w.shape[-1]
        lg = _log_gauss_positional(feats, mu.to(dtype), k.to(dtype), lad, cov).reshape(B, T, LS, M)
        lg = lg + torch.log(w.to(dtype))[:, None]
        lb = torch.logsumexp(lg, dim=-1)  # (B, T, LS)
        post = torch.exp(lg - lb[..., None])
        posts.append(torch.where(torch.isfinite(lb)[..., None], post, torch.zeros_like(post)))
        log_b = lb if log_b is None else log_b + lb
    lb_pos = log_b.reshape(B, T, L, S)

    log_trans = _composed_log_trans(pos_logt)  # (B, LS, LS)
    la = log_forward_full(log_b, log_trans, lengths)
    lbw = log_backward_full(log_b, log_trans, lengths)
    log_z = la[:, -1, -1]
    valid = torch.isfinite(log_z) & (lengths > 0)
    safe_z = torch.where(valid, log_z, 0.0)
    z4 = safe_z[:, None, None, None]

    t_idx = torch.arange(T, device=dev)
    frame_mask = (t_idx[None, :] < lengths[:, None]).to(dtype)  # (B, T)
    la_p = la.reshape(B, T, L, S)
    lb_p = lbw.reshape(B, T, L, S)
    gamma = torch.exp(torch.clamp(la_p + lb_p - z4, max=0.0)) * frame_mask[..., None, None]

    xi_mask = (t_idx[None, :-1] < (lengths - 1)[:, None]).to(dtype)  # (B, T-1)
    fwd_in = (lb_pos + lb_p)[:, 1:]  # log_b + beta at t+1
    log_xi = la_p[:, :-1, :, :, None] + pos_logt[:, None] + fwd_in[:, :, :, None, :] - z4[..., None]
    xi = torch.exp(torch.clamp(log_xi, max=0.0)) * xi_mask[..., None, None, None]
    xi_pos = xi.sum(1)  # (B, L, S, S)
    if L > 1:
        arc = pos_logt[:, :-1, S - 1, S - 1]  # (B, L-1)
        cross = la_p[:, :-1, :-1, S - 1] + arc[:, None] + fwd_in[:, :, 1:, 0] - safe_z[:, None, None]
        cross_flow = torch.exp(torch.clamp(cross, max=0.0)) * xi_mask[..., None]
        xi_pos[:, :-1, S - 1, S - 1] += cross_flow.sum(1)

    den_trans = (gamma[:, :-1] * xi_mask[..., None, None]).sum(1)  # (B, L, S)
    den_mix = gamma.sum(1)

    stream_stats = []
    for post, cov in zip(posts, cov_types):
        gm = gamma.reshape(B, T, LS)[..., None] * post  # (B, T, LS, M)
        w_s, x_s, xx_s = gmm_moment_stats(gm, feats, cov)
        stream_stats.append(StreamStats(w=w_s, x=x_s, xx=xx_s))

    def zero(a):
        v = valid.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(v, a, torch.zeros_like(a))

    return (
        tuple(StreamStats(w=zero(s.w), x=zero(s.x), xx=zero(s.xx)) for s in stream_stats),
        zero(den_mix), zero(xi_pos), zero(den_trans), torch.where(valid, log_z, 0.0), valid.to(dtype),
    )


def _positions(transcripts: torch.Tensor, S: int) -> torch.Tensor:
    """(B, L) unit ids -> (B, L*S) unit-state rows unit*S + s."""
    B, L = transcripts.shape
    s = torch.arange(S, device=transcripts.device)
    return (transcripts.long()[:, :, None] * S + s).reshape(B, L * S)


def utterance_stats_positional(
    models: GmmHmm,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
) -> SuffStats:
    """Per-POSITION E-step statistics of a batch against the shared unit
    models (the JAX function vmapped over utterances, written batched).

    models: stacked GmmHmm with leading unit axis P; transcripts (B, L) unit
    ids; feats (B, T, D) padded; lengths (B,).  Returns SuffStats whose
    leading axes are (B, L) (and S for den_trans/den_mix); log_prob and
    num_valid are (B,).  Emissions run on the gathered (L*S)-row bank only:
    the inventory's emissions are never materialized."""
    S = models.num_states
    B, L = transcripts.shape
    rows = _positions(transcripts.to(feats.device), S)
    gathered = [_gather_rows(st, rows, 2) for st in models.streams]
    pos_logt = models.log_trans().to(feats.dtype)[transcripts.long()]  # (B, L, S, S)
    streams, den_mix, xi, den_trans, log_prob, valid = _positional_stats(
        gathered, [st.cov_type for st in models.streams], pos_logt, feats, lengths
    )
    unflat = lambda a: a.reshape(B, L, S, *a.shape[2:])
    return SuffStats(
        num_trans=xi,
        den_trans=den_trans,
        den_mix=den_mix,
        streams=tuple(StreamStats(w=unflat(s.w), x=unflat(s.x), xx=unflat(s.xx)) for s in streams),
        log_prob=log_prob,
        num_valid=valid,
    )


def batch_stats(
    models: GmmHmm,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
) -> SuffStats:
    """Batch E-step statistics in UNIT space: positional stats, then ONE
    segment sum over the (B*L,) transcript unit ids (scattering per
    utterance would materialize (B, P, ...) inventory statistics)."""
    P = models.trans.shape[0]
    B, L = transcripts.shape
    per = utterance_stats_positional(models, transcripts, feats, lengths)
    ids = transcripts.reshape(B * L).to(feats.device)

    def seg(a):
        return kc.segment_sum(a.reshape(B * L, *a.shape[2:]), ids, P)

    return SuffStats(
        num_trans=seg(per.num_trans),
        den_trans=seg(per.den_trans),
        den_mix=seg(per.den_mix),
        streams=tuple(StreamStats(w=seg(s.w), x=seg(s.x), xx=seg(s.xx)) for s in per.streams),
        log_prob=per.log_prob.sum(),
        num_valid=per.num_valid.sum(),
    )


def utterance_stats(models: GmmHmm, transcript, feats, length) -> SuffStats:
    """Unit-space E-step statistics for ONE utterance (batch_stats of a
    singleton batch)."""
    length = torch.as_tensor(length, device=feats.device).reshape(1)
    return batch_stats(models, torch.as_tensor(transcript)[None], feats[None], length)


# ---------------------------------------------------------------------------
# the parameter banks of the composed kernels
# ---------------------------------------------------------------------------


def pack_position_bank(means, inv_cov, weights, log_abs_det, D):
    """Diagonal-Gaussian lifted constants for a parameter bank with any
    leading index shape: means / inv_cov (..., M, D), weights / log_abs_det
    (..., M).  Returns float64 (a (..., M, 2D), bias (..., M)) with
    a . [x; x^2] + bias the weighted per-mixture log-likelihood, bias
    clamped at NEG_INF."""
    f64 = torch.float64
    mu, kk, w = means.to(f64), inv_cov.to(f64), weights.to(f64)
    a = torch.cat([mu * kk, -0.5 * kk], dim=-1)
    bias = (
        -0.5 * torch.sum(mu * mu * kk, dim=-1)
        + torch.log(torch.clamp(w, min=1e-300))
        - 0.5 * (D * math.log(2.0 * math.pi) + log_abs_det.to(f64))
    )
    return a, torch.clamp(bias, min=NEG_INF)


def pack_position_bank_diag(means, inv_cov, weights, log_abs_det, D):
    """The diagonal bank of the composed kernels: (NB, M, 2*dmax + 4)
    float32 records of csrc/emission.cuh, [mu*k | -k/2 | bias + log w | 0 |
    0 | 0] (each part padded to dmax = dmax_for(D)), leading axes of the
    inputs flattened to NB.  Packed in float64 on the inputs' device, then
    cast."""
    a, bias = pack_position_bank(means, inv_cov, weights, log_abs_det, D)
    M = a.shape[-2]
    dmax = dmax_for([D], "pack_position_bank_diag")
    a = a.reshape(-1, M, 2 * D)
    bias = bias.reshape(-1, M, 1)
    pad = lambda v: F.pad(v, (0, dmax - D))
    zeros = torch.zeros_like(bias)
    rec = torch.cat([pad(a[..., :D]), pad(a[..., D:]), bias, zeros, zeros, zeros], dim=-1)
    return rec.to(torch.float32).contiguous()


def pack_position_bank_full(means, inv_cov, weights, log_abs_det, D):
    """The full-covariance bank (the Cholesky z form, K = L L^T): means
    (..., M, D), inv_cov (..., M, D, D), weights / log_abs_det (..., M) ->
    (NB, M, D*dmax + dmax + 4) float32 records [rows d of L^T | -L^T mu |
    bias | log w | 0 | 0], so z = L^T x - L^T mu and quad = sum_d z_d^2 (no
    cancellation), and the 1e20 density clamp lands between bias and log w.
    A mixture whose log|det| is not finite gets zero rows and bias NEG_INF;
    one whose inverse covariance is not positive definite gets zero rows and
    bias LOG_GAUS_CLAMP.  Packed in float64 on the inputs' device (a float32
    Cholesky of real inverse covariances gives NaNs), then cast."""
    f64 = torch.float64
    mu, kk, w = means.to(f64), inv_cov.to(f64), weights.to(f64)
    M = mu.shape[-2]
    dmax = dmax_for([D], "pack_position_bank_full")
    norm = -0.5 * (D * math.log(2.0 * math.pi) + log_abs_det.to(f64))  # (..., M)
    logw = torch.log(torch.clamp(w, min=1e-300))
    chol, info = torch.linalg.cholesky_ex(kk, check_errors=False)  # (..., M, D, D) lower
    zmu = torch.einsum("...ed,...e->...d", chol, mu)  # L^T mu per mixture
    det_ok = torch.isfinite(norm)
    ok = (info == 0) & torch.isfinite(chol).all(-1).all(-1) & det_ok
    chol = torch.where(ok[..., None, None], chol, 0.0)
    zmu = torch.where(ok[..., None], zmu, 0.0)
    clamp_or_neg = torch.where(det_ok, LOG_GAUS_CLAMP, NEG_INF).to(f64)
    bias = torch.where(ok, norm, clamp_or_neg)
    lt = F.pad(chol.transpose(-1, -2), (0, dmax - D)).reshape(-1, M, D * dmax)  # row d of L^T
    rec = torch.cat([
        lt,
        F.pad(-zmu, (0, dmax - D)).reshape(-1, M, dmax),
        torch.clamp(bias, min=NEG_INF).reshape(-1, M, 1),
        torch.clamp(logw, min=NEG_INF).reshape(-1, M, 1),
        torch.zeros_like(lt[..., :2]),
    ], dim=-1)
    return rec.to(torch.float32).contiguous()


def _pack_bank(stream: GmmStream, D: int, full: bool):
    pack = pack_position_bank_full if full else pack_position_bank_diag
    return pack(stream.means, stream.inv_cov, stream.weights, stream.log_abs_det(), D)


# ---------------------------------------------------------------------------
# fused E-step
# ---------------------------------------------------------------------------


def _composed_diagonals(pos_logt: torch.Tensor, band: int):
    """Per-utterance banded diagonals of the composed chain from (B, L, S, S)
    unit log-transitions: (row form diag_row[d][i, b] = log a_b[i, i+d],
    column form diag_col[d][j, b] = log a_b[j-d, j]), each (band+1, LS, B)
    float32, NEG_INF where there is no arc.  The d=1 diagonal at each
    unit's exit row is the chain arc, carrying the exit self-loop mass."""
    B, L, S, _ = pos_logt.shape
    LS = L * S
    s_idx = torch.arange(S, device=pos_logt.device)
    diags = []
    for d in range(band + 1):
        within = torch.where(
            (s_idx + d < S)[None, None, :],
            pos_logt[:, :, s_idx, torch.clamp(s_idx + d, max=S - 1)],
            -torch.inf,
        )  # (B, L, S)
        if d == 1 and L > 1:
            within = within.clone()
            within[:, :-1, S - 1] = pos_logt[:, :-1, S - 1, S - 1]
        diags.append(within.reshape(B, LS))
    diag_row = torch.clamp(torch.stack(diags, 0).permute(0, 2, 1), min=NEG_INF).to(torch.float32)
    cols = []
    for d in range(band + 1):
        k = min(d, LS)
        cols.append(torch.cat([torch.full((k, B), NEG_INF, dtype=torch.float32, device=pos_logt.device),
                               diag_row[d, : LS - k]], 0))
    return diag_row.contiguous(), torch.stack(cols, 0)


def fused_positional_stats(
    ids: torch.Tensor,
    bank,
    pos_logt: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    cov_full: bool = False,
    gamma_lattice: bool = True,
):
    """The fused composed-lattice E-step core (embedded AND tied training).

    ids (B, L*S) composed row -> bank row (unit*S + s embedded, senone id
    tied); bank: one (NB, M, stride) record tensor or a tuple of them, one
    per stream (pack_position_bank_diag / _full); pos_logt (B, L, S, S)
    left-right unit log-transitions; feats (B, T, D), shared by the streams;
    lengths (B,).  Runs the four composed kernels: emission, forward,
    backward-stats and moments (gamma_lattice=True reads gamma in the
    backward kernel's (T, LS, B) layout, #12; False transposes it to
    (B, LS, T) first, #13).  Returns (mom: per stream (NB, M, Cm) bank-row
    rows [sum g x | sum g x^2 or vec(x x^T) | sum g], den_mix (B, L, S),
    den_trans (B, L, S), num_trans (B, L, S, S) with the chain flow folded
    into the exit self-loops, safe_z (B,), vmask (B,))."""
    B, L, S, _ = pos_logt.shape
    LS = L * S
    band = max(S - 1, 1)  # the chain arc is flattened distance 1
    feats = feats.to(torch.float32)
    lengths = lengths.to(feats.device)
    log_b = kc.bank_emission(ids, bank, feats, cov_full)  # (T, LS, B)
    diag_row, diag_col = _composed_diagonals(pos_logt, band)
    la = kc.composed_forward(log_b, diag_col, lengths)
    log_z = la[-1, LS - 1, :]  # rows repeat past each length
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    vmask = valid.to(torch.float32)
    safe_z = torch.where(valid, log_z, 0.0)
    gamma, xi_diag, den_trans_sb, den_mix_sb = kc.composed_backward_stats(
        log_b, la, diag_row, lengths, safe_z, vmask
    )
    if gamma_lattice:
        mom = kc.bank_moments_lattice(ids, bank, feats, gamma, lengths, cov_full)
    else:
        mom = kc.bank_moments(ids, bank, feats, gamma.permute(2, 1, 0).contiguous(), lengths, cov_full)
    den_mix = den_mix_sb.T.reshape(B, L, S)
    den_trans = den_trans_sb.T.reshape(B, L, S)
    xi_bls = xi_diag.permute(2, 0, 1).reshape(B, band + 1, L, S)
    nt = torch.zeros((B, L, S, S), dtype=torch.float32, device=feats.device)
    for d in range(band + 1):
        s_in = torch.arange(S - d, device=feats.device)
        nt[:, :, s_in, s_in + d] += xi_bls[:, d, :, : S - d]
    if L > 1:
        # the d=1 diagonal at each unit's exit row is the chain arc's flow,
        # folded into the exit self-loop (the reference's semantics)
        nt[:, :-1, S - 1, S - 1] += xi_bls[:, 1, :-1, S - 1]
    return mom, den_mix, den_trans, nt, safe_z, vmask


def _bank_stream_stats(mom, D: int, full: bool, lead: tuple) -> StreamStats:
    """(NB, M, Cm) bank-row moments -> StreamStats with leading axes lead."""
    M = mom.shape[1]
    m = mom.reshape(*lead, M, mom.shape[-1])
    xx = m[..., D : D + D * D].reshape(*lead, M, D, D) if full else m[..., D : 2 * D]
    return StreamStats(w=m[..., -1], x=m[..., :D], xx=xx)


def batch_stats_fused(
    models: GmmHmm,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    gamma_lattice: bool = True,
) -> SuffStats:
    """Batch embedded E-step on the composed kernels: one or more streams
    (homogeneous covariance type, sharing the feature matrix), diagonal or
    full covariance, left-right unit transitions.  Equivalent to
    batch_stats; the GMM moments come back already summed into unit-state
    bank rows (row u*S + s)."""
    cov = models.streams[0].cov_type
    if cov not in (DIAG, FULL) or any(s.cov_type != cov for s in models.streams):
        raise ValueError("batch_stats_fused: homogeneous diag/full streams required")
    full = cov == FULL
    multi = len(models.streams) > 1
    P, S = models.trans.shape[0], models.num_states
    B, L = transcripts.shape
    D = feats.shape[-1]
    transcripts = transcripts.to(feats.device)
    banks = tuple(_pack_bank(st, D, full) for st in models.streams)
    pos_logt = models.log_trans().to(torch.float32)[transcripts.long()]
    mom, den_mix_p, den_trans_p, nt, safe_z, vmask = fused_positional_stats(
        _positions(transcripts, S), banks if multi else banks[0], pos_logt, feats, lengths,
        cov_full=full, gamma_lattice=gamma_lattice,
    )
    ids = transcripts.reshape(B * L)

    def seg(a):  # (B, L, ...) -> (P, ...)
        return kc.segment_sum(a.reshape(B * L, *a.shape[2:]), ids, P)

    moms = mom if multi else (mom,)
    return SuffStats(
        num_trans=seg(nt),
        den_trans=seg(den_trans_p),
        den_mix=seg(den_mix_p),
        streams=tuple(_bank_stream_stats(m, D, full, (P, S)) for m in moms),
        log_prob=torch.sum(safe_z * vmask),
        num_valid=vmask.sum(),
    )


def _left_right(trans: torch.Tensor) -> bool:
    """Whether every unit's transitions are upper-triangular (one host copy
    of the small transition tensor)."""
    return trans_band(trans.detach().cpu().numpy()) is not None


def _embedded_fused_eligible(models: GmmHmm, transcripts, feats) -> bool:
    """Static facts only, in place of the JAX package's VMEM budget
    (``_embedded_fused_default``): CUDA float32 features, streams the
    composed kernels take (kc.fused_eligible: covariance, dims, shared
    memory, band, rows, batch), and left-right unit transitions."""
    S = models.num_states
    return kc.fused_eligible(
        feats, [s.cov_type for s in models.streams], [s.dim for s in models.streams],
        [s.num_mixtures for s in models.streams], S, transcripts.shape[1] * S, transcripts.shape[0],
    ) and _left_right(models.trans)


def _unstack_stats_axis(stats: SuffStats) -> SuffStats:
    """Unit-space SuffStats (P, S, ...) with the unit axis folded into the
    state axis (P*S, ...): the M-step then runs once over every unit (the
    JAX package vmaps m_step over units)."""

    def fold(a):
        return a.reshape(-1, *a.shape[2:])

    return SuffStats(
        num_trans=fold(stats.num_trans),
        den_trans=fold(stats.den_trans),
        den_mix=fold(stats.den_mix),
        streams=tuple(StreamStats(w=fold(s.w), x=fold(s.x), xx=fold(s.xx)) for s in stats.streams),
        log_prob=stats.log_prob,
        num_valid=stats.num_valid,
    )


def _reshape_stream(st: GmmStream, lead: tuple, n: int) -> GmmStream:
    """The stream with its first n axes reshaped to lead."""
    r = lambda a: a.reshape(*lead, *a.shape[n:])
    return GmmStream(weights=r(st.weights), means=r(st.means), inv_cov=r(st.inv_cov), det=r(st.det),
                     cov_type=st.cov_type, log_det=r(st.log_det))


def _unit_m_step(models: GmmHmm, stats: SuffStats, var_floor: float) -> GmmHmm:
    """train/em.py m_step over every unit at once, the unit axis folded
    into the state axis (every operation of the M-step is per state)."""
    P, S = models.trans.shape[0], models.num_states
    folded = GmmHmm(
        trans=models.trans.reshape(P * S, S),
        streams=[_reshape_stream(st, (P * S,), 2) for st in models.streams],
        word=models.word,
    )
    new = m_step(folded, _unstack_stats_axis(stats), var_floor=var_floor)
    return GmmHmm(
        trans=new.trans.reshape(P, S, S),
        streams=[_reshape_stream(st, (P, S), 1) for st in new.streams],
        word=models.word,
    )


def embedded_em_step(
    models: GmmHmm,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    var_floor: float = 0.0,
    fused: bool | None = None,
    gamma_lattice: bool = True,
):
    """One embedded EM iteration over a bucket of utterances with equal
    padded shapes: transcripts (B, L) exact unit ids (bucket by transcript
    length), feats (B, T, D).  Returns (new models, total log prob, num
    valid), the last two as device scalars.

    fused=None takes the composed kernels when _embedded_fused_eligible
    holds; True forces them (their plain twins on CPU tensors); False the
    plain batch_stats."""
    if fused is None:
        fused = _embedded_fused_eligible(models, transcripts, feats)
    if fused:
        stats = batch_stats_fused(models, transcripts, feats, lengths, gamma_lattice=gamma_lattice)
    else:
        stats = batch_stats(models, transcripts, feats, lengths)
    return _unit_m_step(models, stats, var_floor), stats.log_prob, stats.num_valid


def _add_stats(a: SuffStats, b: SuffStats) -> SuffStats:
    return SuffStats(
        num_trans=a.num_trans + b.num_trans,
        den_trans=a.den_trans + b.den_trans,
        den_mix=a.den_mix + b.den_mix,
        streams=tuple(
            StreamStats(**{f.name: getattr(x, f.name) + getattr(y, f.name) for f in fields(StreamStats)})
            for x, y in zip(a.streams, b.streams)
        ),
        log_prob=a.log_prob + b.log_prob,
        num_valid=a.num_valid + b.num_valid,
    )


def _embedded_chunk(models, packed, k: int, var_floor: float, fused: bool, group=None):
    """k embedded EM iterations over all shape buckets with no host sync
    (the train/driver.py run_chunk contract): per iteration the bucket
    statistics add up on the device, then one unit M-step.  group: the
    data axis of a data-parallel run (packed holds this rank's rows of every
    bucket): the summed statistics are all-reduced over it once an
    iteration, before the M-step that every rank runs alike.  Returns
    (final models, (k,) log-prob history, (k,) num_valid history)."""
    from ..parallel.mesh import all_reduce_stats

    lps, nvs = [], []
    m = models
    for _ in range(k):
        agg = None
        for trs, feats, lengths in packed:
            st = (batch_stats_fused if fused else batch_stats)(m, trs, feats, lengths)
            agg = st if agg is None else _add_stats(agg, st)
        agg = all_reduce_stats(agg, group)
        m = _unit_m_step(m, agg, var_floor)
        lps.append(agg.log_prob)
        nvs.append(agg.num_valid)
    if not lps:
        empty = torch.zeros(0, dtype=models.trans.dtype, device=models.trans.device)
        return m, empty, empty
    return m, torch.stack(lps), torch.stack(nvs)


def pack_buckets(utterances, transcripts, dtype, device, pad_multiple: int = 32, rows_multiple: int = 1):
    """Shape buckets of the composed trainers: utterances grouped by
    (length rounded up to pad_multiple, transcript length), each bucket
    (transcripts (Bk, L) int32, feats (Bk, T, D) zero-padded, lengths
    (Bk,) int32) as tensors on `device`.  rows_multiple: Bk is padded up to
    a multiple with empty utterances (length 0: no statistics), so that a
    data axis of that many ranks divides every bucket."""
    from ..io.dataset import round_up

    buckets: dict[tuple[int, int], list[int]] = {}
    for i, (u, tr) in enumerate(zip(utterances, transcripts)):
        buckets.setdefault((round_up(len(u), pad_multiple), len(tr)), []).append(i)
    D = utterances[0].shape[1]
    packed = []
    for (T, L), idxs in buckets.items():
        nb = round_up(len(idxs), rows_multiple)
        feats = np.zeros((nb, T, D))
        lengths = np.zeros(nb, np.int32)
        trs = np.zeros((nb, L), np.int32)
        for row, i in enumerate(idxs):
            feats[row, : len(utterances[i])] = utterances[i]
            lengths[row] = len(utterances[i])
            trs[row] = transcripts[i]
        packed.append((
            torch.as_tensor(trs, device=device),
            torch.as_tensor(feats, dtype=dtype, device=device),
            torch.as_tensor(lengths, device=device),
        ))
    return tuple(packed)


def shard_buckets(fn: str, packed, mesh, axis: str):
    """This rank's rows of every bucket (transcripts, feats, lengths) on the
    mesh's device; every bucket's row count must divide by the axis (pad
    with empty utterances: pack_buckets rows_multiple)."""
    from ..parallel.mesh import require_axis, shard_rows

    require_axis(fn, mesh, axis)
    return tuple(tuple(shard_rows(t, mesh, axis) for t in bucket) for bucket in packed)


def mesh_buckets(fn: str, utterances, transcripts, trans: torch.Tensor, pad_multiple: int, mesh, axis: str):
    """(buckets, data group) of a composed trainer: pack_buckets on trans'
    device and dtype; under a mesh, each rank's rows of buckets padded to a
    multiple of the axis, and the axis' group (None without a mesh)."""
    if mesh is None:
        return pack_buckets(utterances, transcripts, trans.dtype, trans.device, pad_multiple), None
    from ..parallel.mesh import require_axis

    require_axis(fn, mesh, axis)  # before mesh.size below
    packed = pack_buckets(utterances, transcripts, trans.dtype, trans.device, pad_multiple, mesh.size(axis))
    return shard_buckets(fn, packed, mesh, axis), mesh.group(axis)


def batch_stats_fused_sharded(models: GmmHmm, transcripts, feats, lengths, mesh, axis: str = "data") -> SuffStats:
    """Data-parallel composed E-step: each rank runs batch_stats_fused (the
    composed kernels, TPU kernels #9-#12, on CUDA float32) on its rows of
    the batch (the same whole batch on every rank; B must divide by the
    axis), then one all_reduce of the unit-space statistics over `axis`.
    The models are replicated."""
    from ..parallel.mesh import all_reduce_stats

    (local,) = shard_buckets("batch_stats_fused_sharded", ((transcripts, feats, lengths),), mesh, axis)
    return all_reduce_stats(batch_stats_fused(models, *local), mesh.group(axis))


def embedded_train_scan_sharded(models: GmmHmm, packed, n_iters: int, mesh, axis: str = "data",
                                var_floor: float = 0.0):
    """N data-parallel embedded EM iterations: every rank runs
    batch_stats_fused on its rows of every bucket, the unit-space
    statistics are all-reduced over `axis` once an iteration, and every
    rank runs the same unit M-step.  packed: the train_embedded buckets,
    each one's row count divisible by the axis.  Returns (final models,
    (n_iters,) log-prob history, (n_iters,) num_valid history), the same on
    every rank."""
    local = shard_buckets("embedded_train_scan_sharded", packed, mesh, axis)
    return _embedded_chunk(models, local, n_iters, var_floor, True, mesh.group(axis))


def _manager(checkpoint_dir):
    """The chunked driver's CheckpointManager for checkpoint_dir (None: no
    checkpoints)."""
    if checkpoint_dir is None:
        return None
    from .checkpoint import CheckpointManager

    return CheckpointManager(checkpoint_dir)


def train_embedded(
    models: GmmHmm,
    utterances: list[np.ndarray],
    transcripts: list[list[int]],
    threshold: float = 1e-3,
    max_iterations: int = 50,
    var_floor: float = 0.0,
    pad_multiple: int = 32,
    fused: bool | None = None,
    chunk: int = 8,
    mesh=None,
    mesh_axis: str = "data",
    checkpoint_dir=None,
    log_prob_offset: float = 0.0,
):
    """Embedded EM driver: buckets utterances by (padded length, transcript
    length) on the models' device and dtype, then runs the chunked
    convergence driver (train/driver.py) with the reference convergence
    rule.  fused=None takes the composed kernels when every bucket is
    eligible (_embedded_fused_eligible), decided once here.

    checkpoint_dir: chunk-granular checkpoint / resume through the chunked
    driver (train/checkpoint.py); a rerun with the same directory resumes
    from its newest complete checkpoint with the identical trajectory.

    mesh: a Mesh (parallel/mesh.py) with a `mesh_axis` axis: data-parallel
    training, every rank passing the same utterances and the models on its
    device.  Every bucket is padded with empty utterances to a multiple of
    the axis and each rank trains on its rows of it (the routing to the
    kernels decided on those rows), the statistics all-reduced once an
    iteration; only the coordinator writes checkpoints, and every rank
    resumes from them."""
    from .driver import chunked_convergence_train
    from .em_parity import TrainResult

    packed, group = mesh_buckets("train_embedded", utterances, transcripts, models.trans, pad_multiple,
                                 mesh, mesh_axis)
    if fused is None:
        fused = all(_embedded_fused_eligible(models, trs, f) for trs, f, _ in packed)

    def run(m, k):
        return _embedded_chunk(m, packed, k, var_floor, fused, group)

    models, iteration, history, n_valid = chunked_convergence_train(
        models, run, threshold=threshold, max_iterations=max_iterations, chunk=chunk,
        log_prob_offset=log_prob_offset, checkpoint=_manager(checkpoint_dir),
    )
    return TrainResult(
        model=models,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )
