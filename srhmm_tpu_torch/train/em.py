"""Log-space batched Baum-Welch EM (counterpart of ``srhmm_tpu/train/em.py``).

Two E-step implementations behind the ``em_step`` dispatcher:

* the fused kernels (``e_step_fused_lane`` / ``e_step_fused_lane_multi``):
  emit-forward then backward-stats (ops/kernels/fused_em.py), the hand-
  written CUDA kernels of csrc/fused_em.cu on CUDA float32 tensors and their
  plain PyTorch twins on the CPU — diagonal or full covariance, one or more
  streams;
* the plain path (``e_step``): emission, forward and backward lattices and
  every statistic as batched tensor code over an explicit utterance axis —
  any dtype and device, the float64 reference for the tests.

Two more E-steps, which ``em_step`` does not route to (nor does the JAX
package's, whose TPU measurements superseded them by the fused kernels):
``e_step_fused`` (one diagonal stream: emission and GMM moments through
ops/kernels/emission.py, TPU kernels #21 / #22) and ``e_step_lane_major``
((T, S, B) lattices; ``lattices="pallas"`` runs ops/kernels/lattice.py,
kernels #20 / #19).

``em_train_scan`` runs N iterations as a Python loop that keeps the log
probs on the device (no host sync inside); ``train_fast`` applies the
reference's per-iteration convergence rule (T1:306-346) through the chunked
driver (train/driver.py).

Covariance statistics accumulate raw moments (sum gamma, sum gamma x,
sum gamma x x^T) and the M-step recovers the reference's residual-about-
PRE-update-means covariance (T1:1744-1750) through the moment identity
sum g (x-mu0)(x-mu0)^T = XX - mu0 a^T - a mu0^T + w mu0 mu0^T.

Not ported yet: the sharded variants (data- and time-parallel) and
``bf16_stats``.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from ..io.dataset import UtteranceBatch
from ..models.gmm_hmm import DIAG, FINITE_PROBAB, FULL, GmmHmm, GmmStream
from ..ops.emission import log_mixture_posteriors
from ..ops.forward_backward import log_backward_full, log_forward_full
from ..ops.kernels.common import NEG_INF, trans_band


@dataclass
class StreamStats:
    w: torch.Tensor  # (S, M)        sum_t gamma_m
    x: torch.Tensor  # (S, M, D)     sum_t gamma_m * x_t
    xx: torch.Tensor  # (S, M, D, D) full | (S, M, D) diag: second moment


@dataclass
class SuffStats:
    num_trans: torch.Tensor  # (S, S)
    den_trans: torch.Tensor  # (S,)
    den_mix: torch.Tensor  # (S,)
    streams: tuple[StreamStats, ...]
    log_prob: torch.Tensor  # scalar: sum over utterances of final-state log P
    num_valid: torch.Tensor  # scalar: utterances with finite log P


def _map_stats(fn, st: SuffStats) -> SuffStats:
    """Apply fn to every tensor of a SuffStats."""
    return SuffStats(
        num_trans=fn(st.num_trans),
        den_trans=fn(st.den_trans),
        den_mix=fn(st.den_mix),
        streams=tuple(
            StreamStats(**{f.name: fn(getattr(s, f.name)) for f in fields(StreamStats)})
            for s in st.streams
        ),
        log_prob=fn(st.log_prob),
        num_valid=fn(st.num_valid),
    )


def gmm_moment_stats(gm, feats, cov_type):
    """Occupancy-weighted GMM moment statistics as single contractions.

    gm: (..., N, G, M) mixture occupancy (gamma * posterior) over N frames
    and G groups (states); feats: (..., N, D).  Returns (w (..., G, M),
    x (..., G, M, D), xx (..., G, M, D, D) full | (..., G, M, D) diag);
    leading axes (e.g. utterances) are kept."""
    ones = torch.ones_like(feats[..., :1])
    D = feats.shape[-1]
    if cov_type == FULL:
        smk = torch.einsum("...ngm,...nk->...gmk", gm, torch.cat([feats, ones], -1))
        x, w = smk[..., :D], smk[..., D]
        xx = torch.einsum("...ngm,...nd,...ne->...gmde", gm, feats, feats)
    else:
        smk = torch.einsum("...ngm,...nk->...gmk", gm, torch.cat([feats, feats * feats, ones], -1))
        x, xx, w = smk[..., :D], smk[..., D : 2 * D], smk[..., 2 * D]
    return w, x, xx


def _per_utterance_stats(model: GmmHmm, feats_per_stream, lengths) -> SuffStats:
    """E-step statistics per utterance, with a leading (B,) axis on every
    tensor.  feats_per_stream: one (B, T, D_p) tensor per stream (all
    streams of an utterance share the frame count, T1:274)."""
    S = model.num_states
    dtype = feats_per_stream[0].dtype
    log_trans = model.log_trans().to(dtype)

    log_b = None
    posts = []
    for stream, sf in zip(model.streams, feats_per_stream):
        lb_s, post_s = log_mixture_posteriors(sf, stream)  # (B, T, S), (B, T, S, M)
        posts.append(post_s)
        log_b = lb_s if log_b is None else log_b + lb_s

    la = log_forward_full(log_b, log_trans, lengths)  # (B, T, S)
    lbw = log_backward_full(log_b, log_trans, lengths)
    log_z = la[:, -1, S - 1]  # rows at t >= length repeat the last valid row
    valid = torch.isfinite(log_z) & (lengths > 0)
    safe_z = torch.where(valid, log_z, 0.0)

    T = feats_per_stream[0].shape[1]
    t_idx = torch.arange(T, device=lengths.device)
    frame_mask = (t_idx[None, :] < lengths[:, None]).to(dtype)  # (B, T)

    lgamma = la + lbw - safe_z[:, None, None]
    gamma = torch.exp(torch.clamp(lgamma, max=0.0)) * frame_mask[..., None]  # (B, T, S)

    # banded xi statistics (calc_transition_probab T1:1609-1647)
    xi_mask = (t_idx[None, :-1] < (lengths - 1)[:, None]).to(dtype)  # (B, T-1)
    log_xi = (
        la[:, :-1, :, None]
        + log_trans
        + (log_b[:, 1:] + lbw[:, 1:])[:, :, None, :]
        - safe_z[:, None, None, None]
    )
    xi = torch.exp(torch.clamp(log_xi, max=0.0)) * xi_mask[..., None, None]
    num_trans = xi.sum(1)
    den_trans = (gamma[:, :-1] * xi_mask[..., None]).sum(1)
    den_mix = gamma.sum(1)

    stream_stats = []
    for stream, post, sf in zip(model.streams, posts, feats_per_stream):
        gm = gamma[..., None] * post  # (B, T, S, M)
        w, x, xx = gmm_moment_stats(gm, sf, stream.cov_type)
        stream_stats.append(StreamStats(w=w, x=x, xx=xx))

    def zero(a):
        v = valid.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(v, a, torch.zeros_like(a))

    return SuffStats(
        num_trans=zero(num_trans),
        den_trans=zero(den_trans),
        den_mix=zero(den_mix),
        streams=tuple(StreamStats(w=zero(s.w), x=zero(s.x), xx=zero(s.xx)) for s in stream_stats),
        log_prob=torch.where(valid, log_z, 0.0),
        num_valid=valid.to(dtype),
    )


def _as_batches(batch) -> tuple[UtteranceBatch, ...]:
    return batch if isinstance(batch, tuple) else (batch,)


def e_step(model: GmmHmm, batch) -> SuffStats:
    """Batched E-step: per-utterance statistics over the batch axis, summed.

    batch: an UtteranceBatch, or a tuple of UtteranceBatch (one per stream,
    equal lengths) for multi-stream models."""
    batches = _as_batches(batch)
    feats = tuple(b.features for b in batches)
    if len(feats) == 1 and len(model.streams) > 1:
        feats = feats * len(model.streams)
    per_utt = _per_utterance_stats(model, feats, batches[0].lengths)
    return _map_stats(lambda a: a.sum(0), per_utt)


def update_stream(
    stream: GmmStream,
    st: StreamStats,
    den_mix: torch.Tensor,
    var_floor: float = 0.0,
    abs_floor=None,
    zero_det_threshold=None,
) -> GmmStream:
    """Emission-parameter update for one stream from its sufficient stats
    (the GMM half of the M-step).

    abs_floor: optional replacement for the reference's ABSOLUTE variance
    floor FINITE_PROBAB (T1:1975-1977), scalar or per-dim (D,).  Training
    in affine-normalized feature space (--cmvn global) passes
    FINITE_PROBAB / std^2 so the floor acts at the raw-space magnitudes."""
    dtype, device = stream.means.dtype, stream.means.device
    if abs_floor is None:
        # filled on the device: a tensor made from a host scalar would be a
        # host-to-device copy, which waits for the queued E-step
        base_floor = torch.full((), max(FINITE_PROBAB, var_floor), dtype=dtype, device=device)
    else:
        base_floor = torch.clamp(torch.as_tensor(abs_floor, dtype=dtype, device=device), min=var_floor)
    touched = (den_mix > 0)[..., None]
    w_safe = torch.where(st.w > 0, st.w, 1.0)

    weights = torch.where(
        touched, st.w / torch.where(den_mix > 0, den_mix, 1.0)[..., None], stream.weights
    )
    weights = torch.clamp(weights, min=FINITE_PROBAB)
    weights = weights / weights.sum(-1, keepdim=True)

    mu0 = stream.means
    means = torch.where(touched[..., None], st.x / w_safe[..., None], mu0)

    old_log_det = stream.log_abs_det()
    if stream.cov_type == FULL:
        a = st.x
        cov = (
            st.xx
            - mu0[..., :, None] * a[..., None, :]
            - a[..., :, None] * mu0[..., None, :]
            + st.w[..., None, None] * mu0[..., :, None] * mu0[..., None, :]
        ) / w_safe[..., None, None]
        D = cov.shape[-1]
        eye = torch.eye(D, dtype=dtype, device=device)
        diag = torch.diagonal(cov, dim1=-2, dim2=-1)
        floored = torch.maximum(diag, base_floor)
        cov = cov + (floored - diag)[..., None] * eye
        inv_new, log_det_new = _batched_inv_logdet(cov)
        inv = torch.where(touched[..., None, None], inv_new, stream.inv_cov)
        log_det = torch.where(touched, log_det_new, old_log_det)
    else:
        cov = (st.xx - 2.0 * mu0 * st.x + st.w[..., None] * mu0 * mu0) / w_safe[..., None]
        cov = torch.maximum(cov, base_floor)
        inv_new = 1.0 / cov
        log_det_new = torch.sum(torch.log(cov), dim=-1)
        inv = torch.where(touched[..., None], inv_new, stream.inv_cov)
        log_det = torch.where(touched, log_det_new, old_log_det)

    zd = _LOG_ZERO_DET if zero_det_threshold is None else zero_det_threshold
    weights, means, inv, log_det = _repair_degenerate(weights, means, inv, log_det, stream.cov_type, zd)
    if stream.cov_type == FULL:
        # Last-resort PSD fallback (beyond the reference): a mixture whose
        # covariance is still not invertible after donor repair falls back
        # to its diagonal covariance, always PSD after flooring.
        still_bad = ~torch.isfinite(log_det) | (log_det < zd)
        diag_inv = 1.0 / floored
        inv = torch.where(still_bad[..., None, None], diag_inv[..., None] * eye, inv)
        log_det = torch.where(still_bad, torch.sum(torch.log(floored), dim=-1), log_det)
    return GmmStream(
        weights=weights,
        means=means,
        inv_cov=inv,
        # linear det kept for the .hmm export contract; may overflow in f32
        # (log_det is the authoritative fast-path value)
        det=torch.exp(log_det),
        cov_type=stream.cov_type,
        log_det=log_det,
    )


def m_step(
    model: GmmHmm,
    stats: SuffStats,
    var_floor: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
) -> GmmHmm:
    """Reference-semantics parameter update (T1:1907-2000 + re-inversion),
    vectorized over (S, M), with the vectorized treat_zero_det repair
    (T1:2226-2265): every mixture whose determinant collapses below 1e-20 is
    re-seeded from its state's largest-determinant mixture."""
    dtype = model.trans.dtype
    # structural mask from the model's own support: EM preserves zeros
    band = (model.trans > 0).to(dtype)
    den = stats.den_trans
    trans_new = torch.where(
        (den > 0)[:, None],
        band * stats.num_trans / torch.where(den > 0, den, 1.0)[:, None],
        model.trans,
    )
    new_streams = [
        update_stream(
            stream, st, stats.den_mix, var_floor,
            None if abs_floors is None else abs_floors[i],
            None if zero_det_thresholds is None else zero_det_thresholds[i],
        )
        for i, (stream, st) in enumerate(zip(model.streams, stats.streams))
    ]
    return GmmHmm(trans=trans_new, streams=new_streams, word=model.word)


def _batched_inv_logdet(cov: torch.Tensor):
    """(..., D, D) SPD inverse + log-determinant via Cholesky (the fast-path
    replacement for the reference's LDL^T, ops/linalg_parity.py).

    ``cholesky_ex`` does not raise or sync on a matrix that is not positive
    definite; it leaves a partial factor, so such a matrix is marked bad by
    its ``info`` as well as by a non-finite log-determinant: log_det -inf,
    inverse 0."""
    L, info = torch.linalg.cholesky_ex(cov, check_errors=False)
    diag_l = torch.diagonal(L, dim1=-2, dim2=-1)
    log_det = 2.0 * torch.sum(torch.log(diag_l), dim=-1)
    D = cov.shape[-1]
    eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
    l_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    inv = torch.einsum("...ki,...kj->...ij", l_inv, l_inv)
    bad = ~torch.isfinite(log_det) | (info != 0)
    log_det = torch.where(bad, -torch.inf, log_det)
    inv = torch.where(bad[..., None, None], 0.0, inv)
    return inv, log_det


_LOG_ZERO_DET = -46.0517018598809136  # log(1e-20), treat_zero_det trigger


def _repair_degenerate(weights, means, inv, log_det, cov_type, zd=_LOG_ZERO_DET):
    """Vectorized treat_zero_det (T1:2226-2265): re-seed collapsed mixtures
    from the state's largest-determinant mixture (the first one on ties)."""
    bad = log_det < zd  # (S, M)
    any_bad = bad.any(-1)
    donor = torch.argmax(log_det, dim=-1)  # (S,)

    def take(a):
        return torch.take_along_dim(a, donor.reshape((-1,) + (1,) * (a.ndim - 1)), dim=1)

    d_means, d_inv, d_ld, d_w = take(means), take(inv), take(log_det), take(weights)
    means = torch.where(bad[..., None], d_means * 1.05, means)
    # donor mean shrinks when it actually donated
    M = means.shape[1]
    donated = any_bad[:, None] & (torch.arange(M, device=donor.device)[None] == donor[:, None])
    means = torch.where(donated[..., None], means * 0.95, means)
    if cov_type == FULL:
        inv = torch.where(bad[..., None, None], d_inv, inv)
    else:
        inv = torch.where(bad[..., None], d_inv, inv)
    log_det = torch.where(bad, d_ld, log_det)
    weights = torch.where(donated, weights / 2.0, weights)
    weights = torch.where(bad, d_w / 2.0, weights)
    weights = weights / weights.sum(-1, keepdim=True)
    return weights, means, inv, log_det


def _num_trans_from_xi(xi, band):
    """num_trans (S, S) from backward_stats' per-utterance xi (nslots, S, B),
    which already carries the transition weights: banded, slot d at column
    j holds xi[j-d -> j]; dense, slot i holds xi[i -> j]."""
    xi_sum = xi.sum(-1)
    if band is None:
        return xi_sum
    S = xi.shape[1]
    num = torch.zeros((S, S), dtype=xi.dtype, device=xi.device)
    for d in range(band + 1):
        j = torch.arange(d, S, device=xi.device)
        num[j - d, j] = xi_sum[d, d:]
    return num


def _unshift_moments(mom, origin, cov_type, S: int, M: int, D: int) -> StreamStats:
    """(M*S, L+1) moments about ``origin`` -> feature-space StreamStats:
    sum g x = sum g y + o sum g, and the second moment by the binomial
    identity in o."""
    L = (D + D * D) if cov_type == FULL else 2 * D
    mom = mom.reshape(M, S, L + 1).permute(1, 0, 2)  # (S, M, L+1)
    o = origin
    w = mom[..., L]
    ys = mom[..., :D]
    x = ys + o * w[..., None]
    if cov_type == FULL:
        yy = mom[..., D:L].reshape(S, M, D, D)
        xx = (
            yy
            + o[:, None] * ys[..., None, :]
            + ys[..., :, None] * o[None, :]
            + (o[:, None] * o[None, :]) * w[..., None, None]
        )
    else:
        yy = mom[..., D:L]
        xx = yy + 2.0 * o * ys + (o * o) * w[..., None]
    return StreamStats(w=w, x=x, xx=xx)


def _e_step_fused(model: GmmHmm, batches, feats_tdb, band) -> SuffStats:
    """The fused E-step for P >= 1 streams: emit-forward, then
    backward-stats, in float32.  Any (B, T): the kernels mask frames past
    each length and zero-length rows themselves, so no padding is needed."""
    from ..ops.kernels.fused_em import backward_stats, emit_forward, pack_lane_constants

    streams = model.streams
    if len(streams) != len(batches):
        raise ValueError("fused E-step: one batch per stream")
    cov = streams[0].cov_type
    if any(s.cov_type != cov for s in streams) or cov not in (DIAG, FULL):
        raise ValueError("fused E-step: homogeneous diag/full streams only")
    S = model.num_states
    dtype = torch.float32
    lengths = batches[0].lengths
    if feats_tdb is None:
        feats_tdb = tuple(b.features.to(dtype).permute(1, 2, 0).contiguous() for b in batches)
    # shifted origin (mean of means): emission and moments run at residual
    # scale instead of raw feature scale; the unshift below is exact
    origins = tuple(s.means.to(dtype).mean(dim=(0, 1)) for s in streams)
    packed = tuple(pack_lane_constants(s, dtype, origin=o) for s, o in zip(streams, origins))
    trans = model.trans.to(dtype)

    log_b, la = emit_forward(feats_tdb, packed, origins, trans, lengths, band)
    log_z = la[-1, S - 1, :]  # (B,): rows repeat past each length
    valid = torch.isfinite(log_z) & (log_z > NEG_INF / 2) & (lengths > 0)
    vmask = valid.to(dtype)
    safe_z = torch.where(valid, log_z, 0.0)

    xi, den_trans, den_mix, moms = backward_stats(
        feats_tdb, log_b, la, packed, origins, trans, lengths, safe_z, vmask, band
    )
    stream_stats = tuple(
        _unshift_moments(mom, o, cov, S, s.num_mixtures, s.dim)
        for s, mom, o in zip(streams, moms, origins)
    )
    return SuffStats(
        num_trans=_num_trans_from_xi(xi, band),
        den_trans=den_trans.sum(-1),
        den_mix=den_mix.sum(-1),
        streams=stream_stats,
        log_prob=torch.sum(safe_z),
        num_valid=vmask.sum(),
    )


def e_step_fused_lane(
    model: GmmHmm, batch: UtteranceBatch, feats_tdb=None, band: int | None = None
) -> SuffStats:
    """Batched E-step on the fused emit-forward / backward-stats kernels,
    single-stream models, diagonal or full covariance.

    feats_tdb: optional precomputed (T, D, B) float32 transpose of
    batch.features (train_fast passes it so the loop does not redo it).
    band: static transition band width (trans_band of the initial model,
    computed once on the host); None = dense transitions.  Any (B, T) shape
    is accepted; statistics do not depend on padding."""
    if len(model.streams) != 1:
        raise ValueError("e_step_fused_lane: single-stream models only")
    return _e_step_fused(model, (batch,), None if feats_tdb is None else (feats_tdb,), band)


def e_step_fused_lane_multi(model: GmmHmm, batches, band: int | None = None) -> SuffStats:
    """Multi-stream fused E-step: each stream keeps its own (T, D_p, B)
    features and constants, emit-forward sums the per-stream
    log-likelihoods before the forward recursion (the reference's product
    of stream likelihoods, T1:1437-1441), and backward-stats normalizes
    each stream's posteriors by its own mixture logsumexp.

    batches: tuple of UtteranceBatch, one per stream (equal lengths); all
    streams share the covariance type."""
    return _e_step_fused(model, tuple(batches), None, band)


def e_step_fused(model: GmmHmm, batch: UtteranceBatch) -> SuffStats:
    """Batched E-step with the fused emission / moment kernels (single
    diagonal-covariance stream): log b through ``emission_log_b`` (TPU
    kernel #21) over every frame of the (B, T) batch, per-utterance lattices
    and xi in plain torch (``log_forward_full`` / ``log_backward_full``, as
    the JAX package leaves them to XLA), then the GMM moments through
    ``emission_stats`` (#22), which never builds a (B, T, S, M) tensor.
    The kernels run in float32 (CUDA float32 launches them, CPU tensors run
    their twins); the lattices and xi in the features' dtype."""
    stream = model.streams[0]
    if len(model.streams) != 1 or stream.cov_type != DIAG:
        raise ValueError("e_step_fused: single diagonal-covariance stream only")
    from ..ops.kernels.emission import emission_log_b, emission_stats, pack_constants

    feats, lengths = batch.features, batch.lengths
    B, T, D = feats.shape
    S = model.num_states
    dtype = feats.dtype
    log_trans = model.log_trans().to(dtype)
    a, bias = pack_constants(stream, torch.float32)
    flat = feats.reshape(B * T, D).to(torch.float32)
    log_b = emission_log_b(flat, a, bias).reshape(B, T, S).to(dtype)

    la = log_forward_full(log_b, log_trans, lengths)  # (B, T, S)
    lbw = log_backward_full(log_b, log_trans, lengths)
    log_z = la[:, -1, S - 1]
    valid = torch.isfinite(log_z) & (lengths > 0)
    vmask = valid.to(dtype)
    safe_z = torch.where(valid, log_z, 0.0)
    t_idx = torch.arange(T, device=lengths.device)
    frame_mask = (t_idx[None, :] < lengths[:, None]).to(dtype)  # (B, T)
    gamma = (
        torch.exp(torch.clamp(la + lbw - safe_z[:, None, None], max=0.0))
        * frame_mask[..., None]
        * vmask[:, None, None]
    )
    xi_mask = (t_idx[None, :-1] < (lengths - 1)[:, None]).to(dtype) * vmask[:, None]  # (B, T-1)
    log_xi = (
        la[:, :-1, :, None]
        + log_trans
        + (log_b[:, 1:] + lbw[:, 1:])[:, :, None, :]
        - safe_z[:, None, None, None]
    )
    xi = torch.exp(torch.clamp(log_xi, max=0.0)) * xi_mask[..., None, None]

    smk = emission_stats(
        flat, gamma.reshape(B * T, S).to(torch.float32), log_b.reshape(B * T, S).to(torch.float32), a, bias
    ).to(dtype)  # (S, M, 2D+1)
    x, xx, w = smk[..., :D], smk[..., D : 2 * D], smk[..., 2 * D]
    return SuffStats(
        num_trans=xi.sum((0, 1)),
        den_trans=(gamma[:, :-1] * xi_mask[..., None]).sum((0, 1)),
        den_mix=gamma.sum((0, 1)),
        streams=(StreamStats(w=w, x=x, xx=xx),),
        log_prob=torch.sum(torch.where(valid, log_z, 0.0)),
        num_valid=vmask.sum(),
    )


def _log_forward_lattice_tb(log_b_tsb, log_trans, lengths):
    """Forward lattice with (S, B) carries: (T, S, B) log b -> (T, S, B)
    log-alpha, -inf for impossible paths (rows at t >= length repeat the
    last valid row)."""
    T, S, B = log_b_tsb.shape
    start = torch.full((S, 1), -torch.inf, dtype=log_b_tsb.dtype, device=log_b_tsb.device)
    start[0] = 0.0
    carry = log_b_tsb[0] + start
    rows = [carry]
    for t in range(1, T):
        cand = carry[:, None, :] + log_trans[:, :, None]  # (from, to, B)
        new = torch.logsumexp(cand, dim=0) + log_b_tsb[t]
        carry = torch.where(t < lengths[None, :], new, carry)
        rows.append(carry)
    return torch.stack(rows)


def _log_backward_lattice_tb(log_b_tsb, log_trans, lengths):
    """Backward lattice with (S, B) carries, final-state initialization at
    each utterance's last valid frame."""
    T, S, B = log_b_tsb.shape
    beta_t = torch.full((S, 1), -torch.inf, dtype=log_b_tsb.dtype, device=log_b_tsb.device)
    beta_t[S - 1] = 0.0
    beta_t = beta_t.expand(S, B)
    last = lengths - 1
    carry = beta_t
    rows = [carry]
    for t in range(T - 2, -1, -1):
        cand = log_trans[:, :, None] + (log_b_tsb[t + 1] + carry)[None, :, :]
        new = torch.logsumexp(cand, dim=1)
        carry = torch.where(t < last[None, :], new, beta_t)
        rows.append(carry)
    return torch.stack(rows[::-1])


def e_step_lane_major(model: GmmHmm, batch: UtteranceBatch, lattices: str = "scan") -> SuffStats:
    """Batched E-step with (T, S, B) lattices (the batch on the minor axis).

    lattices="scan": the plain torch recursions ``_log_forward_lattice_tb``
    / ``_log_backward_lattice_tb`` in the features' dtype (-inf for
    impossible paths); lattices="pallas" (the JAX package's name, kept so
    one call serves both packages): the hand-written lattice kernels of
    ops/kernels/lattice.py (``forward_lattice_blocked`` /
    ``backward_lattice_blocked``, TPU kernels #20 / #19; their twins on CPU
    tensors) in float32 with the -1e30 clamp, k_block the first of 16, 8, 4,
    2, 1 that divides T.  Emission (``log_mixture_posteriors``), xi and the
    GMM moments are plain torch, as the JAX package leaves them to XLA."""
    feats, lengths = batch.features, batch.lengths  # (B, T, D)
    B, T, D = feats.shape
    S = model.num_states
    dtype = feats.dtype
    log_trans = model.log_trans().to(dtype)

    flat = feats.reshape(B * T, D)
    log_b = None
    posts = []
    for stream in model.streams:
        lb_s, post_s = log_mixture_posteriors(flat, stream)  # (B*T, S), (B*T, S, M)
        posts.append(post_s)
        lb_s = lb_s.reshape(B, T, S)
        log_b = lb_s if log_b is None else log_b + lb_s

    lb_tsb = log_b.permute(1, 2, 0)  # (T, S, B)
    if lattices == "pallas":
        from ..ops.kernels.lattice import backward_lattice_blocked, forward_lattice_blocked

        k = next(k for k in (16, 8, 4, 2, 1) if T % k == 0)
        lb32, lt32 = lb_tsb.to(torch.float32), log_trans.to(torch.float32)
        la = forward_lattice_blocked(lb32, lt32, lengths, k_block=k).to(dtype)
        lbw = backward_lattice_blocked(lb32, lt32, lengths, k_block=k).to(dtype)
    elif lattices == "scan":
        la = _log_forward_lattice_tb(lb_tsb, log_trans, lengths)
        lbw = _log_backward_lattice_tb(lb_tsb, log_trans, lengths)
    else:
        raise ValueError(f"e_step_lane_major: lattices must be 'scan' or 'pallas', got {lattices!r}")

    log_z = la[-1, S - 1]  # (B,)
    # the kernels clamp -inf to -1e30: an unreachable final state is a large
    # negative finite value there, not -inf
    valid = torch.isfinite(log_z) & (log_z > -1e29) & (lengths > 0)
    safe_z = torch.where(valid, log_z, 0.0)
    vmask = valid.to(dtype)

    t_idx = torch.arange(T, device=lengths.device)
    frame_mask = (t_idx[:, None] < lengths[None, :]).to(dtype)  # (T, B)
    gamma_tsb = (
        torch.exp(torch.clamp(la + lbw - safe_z, max=0.0)) * frame_mask[:, None, :] * vmask
    )  # (T, S, B)
    xi_mask = (t_idx[:-1, None] < (lengths - 1)[None, :]).to(dtype)  # (T-1, B)
    log_xi = la[:-1, :, None, :] + log_trans[None, :, :, None] + (lb_tsb[1:] + lbw[1:])[:, None] - safe_z
    xi = torch.exp(torch.clamp(log_xi, max=0.0)) * (xi_mask * vmask)[:, None, None, :]  # (T-1, S, S, B)

    gamma_bts = gamma_tsb.permute(2, 0, 1)  # (B, T, S)
    stream_stats = []
    for stream, post in zip(model.streams, posts):
        gm = gamma_bts.reshape(B * T, S)[..., None] * post  # (B*T, S, M)
        w, x, xx = gmm_moment_stats(gm, flat, stream.cov_type)
        stream_stats.append(StreamStats(w=w, x=x, xx=xx))
    return SuffStats(
        num_trans=xi.sum((0, 3)),
        den_trans=(gamma_tsb[:-1] * xi_mask[:, None, :]).sum((0, 2)),
        den_mix=gamma_tsb.sum((0, 2)),
        streams=tuple(stream_stats),
        log_prob=torch.sum(torch.where(valid, log_z, 0.0)),
        num_valid=vmask.sum(),
    )


def _fused_lane_eligible(model: GmmHmm, batch) -> bool:
    """Static facts only: the fused kernels take homogeneous diagonal or
    full covariance (one batch per stream), float32 features, and CUDA
    tensors."""
    cov = model.streams[0].cov_type
    if cov not in (DIAG, FULL) or any(s.cov_type != cov for s in model.streams):
        return False
    batches = _as_batches(batch)
    if len(batches) != len(model.streams):
        return False
    return all(
        b.features.dtype == torch.float32 and b.features.device.type == "cuda" for b in batches
    )


def _fused_setup(model: GmmHmm, batch):
    """(use_fused, feats_tdb, band) for a loop of E-steps, decided once on
    the host: eligibility, the static transition band of the model (EM
    preserves its zeros) and the single-stream (T, D, B) feature transpose."""
    if not _fused_lane_eligible(model, batch):
        return False, None, None
    band = trans_band(model.trans.detach().cpu().numpy())
    feats_tdb = None if isinstance(batch, tuple) else batch.features.permute(1, 2, 0).contiguous()
    return True, feats_tdb, band


def _e_step_any(model, batch, fused: bool, feats_tdb, band) -> SuffStats:
    if not fused:
        return e_step(model, batch)
    batches = _as_batches(batch)
    return _e_step_fused(model, batches, None if feats_tdb is None else (feats_tdb,), band)


def em_step(
    model: GmmHmm,
    batch,
    var_floor: float = 0.0,
    fused: bool | None = None,
    bf16_stats: bool = False,
    feats_tdb=None,
    band: int | None = None,
):
    """One full EM iteration: (new_model, total_log_prob, num_valid), the
    last two as device scalars.

    fused: None auto-selects the fused kernels when eligible
    (_fused_lane_eligible: CUDA float32, homogeneous diag/full); True forces
    them (the plain twins on CPU tensors); False forces the plain e_step.
    feats_tdb / band: precomputed (T, D, B) feature transpose and static
    transition band for the fused path; band=None computes it on the host
    from model.trans (a device sync: loops pass it)."""
    if bf16_stats:
        raise NotImplementedError("em_step: bf16_stats is not ported to srhmm_tpu_torch")
    use_fused = _fused_lane_eligible(model, batch) if fused is None else fused
    if use_fused and band is None:
        band = trans_band(model.trans.detach().cpu().numpy())
    stats = _e_step_any(model, batch, use_fused, feats_tdb, band)
    new_model = m_step(model, stats, var_floor=var_floor)
    return new_model, stats.log_prob, stats.num_valid


def em_train_scan(
    model: GmmHmm,
    batch,
    n_iters: int,
    feats_tdb=None,
    var_floor: float = 0.0,
    fused: bool = True,
    band: int | None = None,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """N EM iterations with no host sync inside: a Python loop of E- and
    M-steps whose log probs stay on the device.  Returns (final model,
    (n_iters,) log-prob history, (n_iters,) num_valid history).

    fused=True runs the fused kernels (pass feats_tdb and band
    precomputed; band=None means dense transitions); False the plain
    e_step."""
    lps, nvs = [], []
    m = model
    for _ in range(n_iters):
        st = _e_step_any(m, batch, fused, feats_tdb, band)
        m = m_step(
            m, st, var_floor=var_floor, abs_floors=abs_floors,
            zero_det_thresholds=zero_det_thresholds,
        )
        lps.append(st.log_prob)
        nvs.append(st.num_valid)
    if not lps:
        empty = torch.zeros(0, dtype=model.trans.dtype, device=model.trans.device)
        return m, empty, empty
    return m, torch.stack(lps), torch.stack(nvs)


def train_fast(
    model: GmmHmm,
    batch,
    threshold: float = 1.0e-3,
    max_iterations: int = 100,
    var_floor: float = 0.0,
    chunk: int = 8,
    log_prob_offset: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """EM driver with the reference's convergence rule (|old - new| / |old|
    <= threshold, old initialized to 1.0, final pass not applying an update
    — T1:306-346).

    Iterations run in em_train_scan chunks, speculatively pipelined by the
    chunked convergence driver (train/driver.py): the trajectory equals the
    per-iteration loop's, but the host waits for the device once per
    `chunk` iterations.  The fused kernels run when eligible
    (_fused_lane_eligible); the band is decided once from the initial model
    (EM preserves the transition structure)."""
    from .driver import chunked_convergence_train
    from .em_parity import TrainResult

    use_fused, feats_tdb, band = _fused_setup(model, batch)

    def run(m, k):
        return em_train_scan(
            m, batch, k, feats_tdb, var_floor=var_floor, fused=use_fused, band=band,
            abs_floors=abs_floors, zero_det_thresholds=zero_det_thresholds,
        )

    model, iteration, history, n_valid = chunked_convergence_train(
        model, run, threshold=threshold, max_iterations=max_iterations,
        chunk=chunk, log_prob_offset=log_prob_offset,
    )
    return TrainResult(
        model=model,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )
