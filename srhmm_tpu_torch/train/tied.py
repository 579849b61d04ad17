"""Tied-state (senone) embedded re-estimation (counterpart of
``srhmm_tpu/train/tied.py``).

The tied variant of train/embedded.py: each utterance gathers the senone
parameters of its L*S transcript positions (an utterance touches a small
slice of the inventory, so gathering beats emissions for all N senones),
and the E-step statistics sum into senone space: tying IS the segment sum.
Per-unit transition statistics stay unit-level.

The statistics are a tuple (senone StreamStats (N, M, ...), den_mix (N,),
num_trans (P, S, S), den_trans (P, S), log_prob, num_valid), as in the JAX
package.  Not ported yet: the sharded functions (``tied_*_sharded``;
``mesh=`` raises) and checkpointing (``checkpoint_dir=`` raises).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gmm_hmm import DIAG, FULL
from ..models.tying import TiedHmmSet
from ..ops.kernels import composed as kc
from .em import StreamStats, update_stream
from .embedded import (
    _bank_stream_stats,
    _gather_rows,
    _left_right,
    _not_ported,
    _pack_bank,
    _positional_stats,
    fused_positional_stats,
    pack_buckets,
)


def _senone_ids(tied: TiedHmmSet, transcripts: torch.Tensor) -> torch.Tensor:
    """(B, L) unit ids -> (B, L*S) senone ids (state_map over the transcript)."""
    B, L = transcripts.shape
    return tied.state_map.long()[transcripts.long()].reshape(B, L * tied.num_states)


def tied_utterance_stats_positional(
    tied: TiedHmmSet,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
):
    """Per-POSITION E-step statistics of a batch against a tied set (the
    JAX function vmapped over utterances, written batched).

    Returns (StreamStats over the (B, L*S) positions, den_mix_pos (B, L*S),
    xi_pos (B, L, S, S), den_trans_pos (B, L, S), log_prob (B,), valid
    (B,)); the senone and unit sums happen in tied_batch_stats."""
    B, L = transcripts.shape
    transcripts = transcripts.to(feats.device)
    gathered = [_gather_rows(tied.senones, _senone_ids(tied, transcripts), 1)]
    pos_logt = tied.log_trans().to(feats.dtype)[transcripts.long()]  # (B, L, S, S)
    (st,), den_mix, xi, den_trans, log_prob, valid = _positional_stats(
        gathered, [tied.senones.cov_type], pos_logt, feats, lengths
    )
    return st, den_mix.reshape(B, -1), xi, den_trans, log_prob, valid


def tied_batch_stats(
    tied: TiedHmmSet,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
):
    """Batch E-step statistics in senone / unit space: positional stats,
    then ONE segment sum over the (B*L*S,) senone ids and one over the
    (B*L,) unit ids.  Returns (senone StreamStats (N, ...), den_mix (N,),
    num_trans (P, S, S), den_trans (P, S), log_prob, num_valid)."""
    P, S, N = tied.num_units, tied.num_states, tied.num_senones
    B, L = transcripts.shape
    transcripts = transcripts.to(feats.device)
    pos, den_mix_pos, xi_pos, den_trans_pos, log_prob, valid = tied_utterance_stats_positional(
        tied, transcripts, feats, lengths
    )
    sen = _senone_ids(tied, transcripts).reshape(B * L * S)
    flat = lambda a: a.reshape(B * L * S, *a.shape[2:])
    sen_stats = StreamStats(*(kc.segment_sum(flat(a), sen, N) for a in (pos.w, pos.x, pos.xx)))
    units = transcripts.reshape(B * L)
    return (
        sen_stats,
        kc.segment_sum(den_mix_pos.reshape(B * L * S), sen, N),
        kc.segment_sum(xi_pos.reshape(B * L, S, S), units, P),
        kc.segment_sum(den_trans_pos.reshape(B * L, S), units, P),
        log_prob.sum(),
        valid.sum(),
    )


def tied_batch_stats_fused(
    tied: TiedHmmSet,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    gamma_lattice: bool = True,
):
    """tied_batch_stats on the composed kernels (train/embedded.py
    fused_positional_stats): the senone inventory is the kernels' bank and
    the per-position senone ids are the bank rows, so the GMM moments come
    back already summed into senone space.  Diagonal or full-covariance
    senones, left-right unit transitions; same return contract as
    tied_batch_stats."""
    sen = tied.senones
    if sen.cov_type not in (DIAG, FULL):
        raise ValueError(f"tied_batch_stats_fused: unknown cov_type {sen.cov_type}")
    full = sen.cov_type == FULL
    P, S, N = tied.num_units, tied.num_states, tied.num_senones
    B, L = transcripts.shape
    D = feats.shape[-1]
    transcripts = transcripts.to(feats.device)
    ids = _senone_ids(tied, transcripts)
    pos_logt = tied.log_trans().to(torch.float32)[transcripts.long()]
    mom, den_mix_p, den_trans_p, nt, safe_z, vmask = fused_positional_stats(
        ids, _pack_bank(sen, D, full), pos_logt, feats, lengths, cov_full=full,
        gamma_lattice=gamma_lattice,
    )
    units = transcripts.reshape(B * L)
    return (
        _bank_stream_stats(mom, D, full, (N,)),
        kc.segment_sum(den_mix_p.reshape(B * L * S), ids.reshape(-1), N),
        kc.segment_sum(nt.reshape(B * L, S, S), units, P),
        kc.segment_sum(den_trans_p.reshape(B * L, S), units, P),
        torch.sum(safe_z * vmask),
        vmask.sum(),
    )


def _tied_fused_eligible(tied: TiedHmmSet, transcripts, feats) -> bool:
    """Static facts only, in place of the JAX package's VMEM budget
    (``_tied_fused_default``): CUDA float32 features, senones the composed
    kernels take (kc.fused_eligible), left-right unit transitions."""
    sen = tied.senones
    S = tied.num_states
    return kc.fused_eligible(
        feats, [sen.cov_type], [sen.dim], [sen.num_mixtures], S, transcripts.shape[1] * S,
        transcripts.shape[0],
    ) and _left_right(tied.trans)


def _apply_tied_update(tied: TiedHmmSet, stats, var_floor: float) -> TiedHmmSet:
    """Tied M-step from aggregated statistics: the senone emission update
    (train/em.py update_stream, over the senone axis) and the per-unit
    banded transition row normalization."""
    sen_stats, den_mix, num_trans, den_trans = stats[:4]
    senones = update_stream(tied.senones, sen_stats, den_mix, var_floor)
    band = (tied.trans > 0).to(tied.trans.dtype)  # per-unit support mask
    trans_new = torch.where(
        (den_trans > 0)[..., None],
        band * num_trans / torch.where(den_trans > 0, den_trans, 1.0)[..., None],
        tied.trans,
    )
    return TiedHmmSet(senones=senones, trans=trans_new, state_map=tied.state_map,
                      unit_names=tied.unit_names)


def tied_em_step(
    tied: TiedHmmSet,
    transcripts: torch.Tensor,
    feats: torch.Tensor,
    lengths: torch.Tensor,
    var_floor: float = 0.0,
    fused: bool | None = None,
    gamma_lattice: bool = True,
):
    """One tied-state embedded EM iteration over an equal-shape bucket.
    Returns (new TiedHmmSet, total log prob, num valid), the last two as
    device scalars.  fused=None takes the composed kernels when
    _tied_fused_eligible holds; True forces them (their twins on CPU
    tensors); False the plain tied_batch_stats."""
    if fused is None:
        fused = _tied_fused_eligible(tied, transcripts, feats)
    if fused:
        stats = tied_batch_stats_fused(tied, transcripts, feats, lengths, gamma_lattice=gamma_lattice)
    else:
        stats = tied_batch_stats(tied, transcripts, feats, lengths)
    return _apply_tied_update(tied, stats, var_floor), stats[4], stats[5]


def _add_tied(a, b):
    st = StreamStats(w=a[0].w + b[0].w, x=a[0].x + b[0].x, xx=a[0].xx + b[0].xx)
    return (st,) + tuple(x + y for x, y in zip(a[1:], b[1:]))


def _tied_chunk(tied, packed, k: int, var_floor: float, fused: bool):
    """k tied EM iterations over all shape buckets with no host sync (the
    train/driver.py run_chunk contract)."""
    lps, nvs = [], []
    t = tied
    for _ in range(k):
        agg = None
        for trs, feats, lengths in packed:
            st = (tied_batch_stats_fused if fused else tied_batch_stats)(t, trs, feats, lengths)
            agg = st if agg is None else _add_tied(agg, st)
        t = _apply_tied_update(t, agg, var_floor)
        lps.append(agg[4])
        nvs.append(agg[5])
    if not lps:
        empty = torch.zeros(0, dtype=tied.trans.dtype, device=tied.trans.device)
        return t, empty, empty
    return t, torch.stack(lps), torch.stack(nvs)


def train_tied(
    tied: TiedHmmSet,
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
    """Tied-state embedded EM driver: shape buckets on the set's device and
    dtype, iterations in chunks through the chunked convergence driver
    (train/driver.py) with the reference convergence rule.  fused=None
    takes the composed kernels when every bucket is eligible
    (_tied_fused_eligible), decided once here.

    mesh= and checkpoint_dir= raise NotImplementedError until the
    multi-device slice and train/checkpoint.py are ported."""
    from .driver import chunked_convergence_train
    from .em_parity import TrainResult

    _not_ported("train_tied", mesh, checkpoint_dir)
    packed = pack_buckets(utterances, transcripts, tied.trans.dtype, tied.trans.device, pad_multiple)
    if fused is None:
        fused = all(_tied_fused_eligible(tied, trs, f) for trs, f, _ in packed)

    def run(t, k):
        return _tied_chunk(t, packed, k, var_floor, fused)

    tied, iteration, history, n_valid = chunked_convergence_train(
        tied, run, threshold=threshold, max_iterations=max_iterations, chunk=chunk,
        log_prob_offset=log_prob_offset,
    )
    return TrainResult(
        model=tied,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )
