"""Sequence (time) parallelism: forward / backward lattices and the EM
E-step over a time-sharded utterance batch (counterpart of
``srhmm_tpu/parallel/sequence.py``).

The forward recursion is a chain of per-frame (S, S) operators under the
(logsumexp, +) semiring,

    alpha_t = alpha_{t-1} o M_t,   M_t[i, j] = log_trans[i, j] + log_b[t, j],

so a block of frames composes into one block operator, and blocks held by
different ranks reduce independently.  Each rank of the ``time`` axis:

  1. reduces its frame block to one (S, S) block operator
     (ops/forward_backward.py log_matmul_chain, a pairwise tree);
  2. all_gathers the block operators of the axis and folds those of the
     ranks before it (after it, for the backward lattice) into the
     log-alpha (log-beta) entering its block: the exclusive prefix that the
     JAX package takes by a Hillis-Steele scan over ``ppermute``, here one
     all_gather and a local fold (the same values; only the order of the
     log-matmuls differs);
  3. replays its block from that boundary state at O(S^2) a frame.

Padded frames (t >= length) are identity operators, so the lattices equal
ops/forward_backward.py's: forward rows past the end repeat the last valid
row, backward rows hold the final-state initialization.  The first frame's
operator is diag(log_b[0]) (pi = one-hot state 0, T1:218-219).  Lattice
functions return the whole (..., T, S) lattice on every rank.  This path
has no kernel of its own, in the JAX package or here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.forward_backward import eye_log, log_matmul_chain
from . import distributed
from .mesh import Mesh, _build_mesh, all_reduce_stats

TIME_AXIS = "time"


def make_time_mesh(n_time: int | None = None, device: str = "cuda") -> Mesh:
    """A 1-D ("time",) mesh over the ranks of this run (n_time must be the
    world size; None takes it)."""
    return _build_mesh({TIME_AXIS: distributed.world_size() if n_time is None else n_time}, device)


def pad_time(log_b: torch.Tensor, multiple: int) -> torch.Tensor:
    """Pad the time axis (dim -2 of (..., T, S)) with zero rows to a
    multiple; the padded rows are masked by the true `length`."""
    pad = (-log_b.shape[-2]) % multiple
    return log_b if pad == 0 else F.pad(log_b, (0, 0, 0, pad))


def _block_bounds(T: int, mesh: Mesh, axis: str) -> tuple[int, int]:
    n = mesh.size(axis)
    if T % n:
        raise ValueError(
            f"time axis {T} not divisible by mesh axis {axis!r} ({n}); pad the frames to a "
            "multiple (pad_time, or pack the batch padded to one) and pass the true length"
        )
    Tl = T // n
    return mesh.index(axis) * Tl, Tl


def _frame_ops(lb, log_trans, t_global, length, first_frame_diag: bool):
    """Per-frame transfer operators of a local block: lb (..., Tl, S),
    log_trans (S, S), t_global (Tl,) global frame indices, length (...,).
    Global frame 0 is diag(log_b[0]) when first_frame_diag; frames at
    t >= length are identity operators."""
    S = lb.shape[-1]
    mats = log_trans + lb[..., :, None, :]  # (..., Tl, S, S)
    eye = eye_log(S, lb.dtype, lb.device)
    if first_frame_diag:
        diag0 = torch.where(eye == 0.0, lb[..., :, None, :], -torch.inf)
        mats = torch.where((t_global == 0)[:, None, None], diag0, mats)
    live = t_global < length[..., None]  # (..., Tl)
    return torch.where(live[..., None, None], mats, eye)


def _forward_local(lb, log_trans, length, mesh: Mesh, axis: str, t0: int):
    """This rank's (..., Tl, S) rows of the log-alpha lattice."""
    Tl, S = lb.shape[-2:]
    t_global = t0 + torch.arange(Tl, device=lb.device)
    mats = _frame_ops(lb, log_trans, t_global, length, True)
    blocks = distributed.all_gather(log_matmul_chain(mats), mesh.group(axis))  # (n, ..., S, S)
    alpha = torch.full(lb.shape[:-2] + (S,), -torch.inf, dtype=lb.dtype, device=lb.device)
    alpha[..., 0] = 0.0  # the initial one-hot state, pushed through the blocks before this one
    for k in range(mesh.index(axis)):
        alpha = torch.logsumexp(alpha[..., :, None] + blocks[k], dim=-2)
    rows = []
    for t in range(Tl):
        alpha = torch.logsumexp(alpha[..., :, None] + mats[..., t, :, :], dim=-2)
        rows.append(alpha)
    return torch.stack(rows, dim=-2)


def _backward_local(lb, log_trans, length, mesh: Mesh, axis: str, t0: int):
    """This rank's (..., Tl, S) rows of the log-beta lattice (final-state
    initialization).  The backward pass never applies the first-frame
    operator."""
    Tl, S = lb.shape[-2:]
    t_global = t0 + torch.arange(Tl, device=lb.device)
    mats = _frame_ops(lb, log_trans, t_global, length, False)
    blocks = distributed.all_gather(log_matmul_chain(mats), mesh.group(axis))
    beta = torch.full(lb.shape[:-2] + (S,), -torch.inf, dtype=lb.dtype, device=lb.device)
    beta[..., S - 1] = 0.0  # the final-state one-hot, pulled through the blocks after this one
    for k in range(mesh.size(axis) - 1, mesh.index(axis), -1):
        beta = torch.logsumexp(blocks[k] + beta[..., None, :], dim=-1)
    rows = [beta]
    for t in range(Tl - 2, -1, -1):  # row t from the operator of frame t + 1
        beta = torch.logsumexp(mats[..., t + 1, :, :] + beta[..., None, :], dim=-1)
        rows.append(beta)
    return torch.stack(rows[::-1], dim=-2)


def _sharded_lattice(local_fn, log_b, log_trans, mesh, length, axis):
    T = log_b.shape[-2]
    t0, Tl = _block_bounds(T, mesh, axis)
    lb = log_b[..., t0 : t0 + Tl, :].to(mesh.device)
    length = torch.as_tensor(T if length is None else length, device=mesh.device).expand(lb.shape[:-2])
    rows = local_fn(lb, log_trans.to(mesh.device, lb.dtype), length, mesh, axis, t0)
    return torch.cat(list(distributed.all_gather(rows, mesh.group(axis))), dim=-2)


def log_forward_time_sharded(log_b, log_trans, mesh: Mesh, length=None, axis: str = TIME_AXIS):
    """The (..., T, S) log-alpha lattice with T split over `axis`; the same
    semantics as ops.forward_backward.log_forward_full (rows at t >= length
    repeat the last valid row).  T must divide by the axis (pad_time)."""
    return _sharded_lattice(_forward_local, log_b, log_trans, mesh, length, axis)


def log_backward_time_sharded(log_b, log_trans, mesh: Mesh, length=None, axis: str = TIME_AXIS):
    """The (..., T, S) log-beta lattice (final-state initialization) with T
    split over `axis`; matches ops.forward_backward.log_backward_full."""
    return _sharded_lattice(_backward_local, log_b, log_trans, mesh, length, axis)


# ---------------------------------------------------------------------------
# sequence-parallel EM E-step
# ---------------------------------------------------------------------------


def time_shard(batch, mesh: Mesh, axis: str = TIME_AXIS):
    """(per-stream (B, Tl, D_p) frame blocks of this rank, lengths (B,)) of
    a padded batch (UtteranceBatch or a tuple, one per stream), on the
    mesh's device.  The frame count must divide by the axis size."""
    batches = batch if isinstance(batch, tuple) else (batch,)
    t0, Tl = _block_bounds(batches[0].features.shape[1], mesh, axis)
    feats = tuple(b.features[:, t0 : t0 + Tl].to(mesh.device) for b in batches)
    return feats, batches[0].lengths.to(mesh.device)


def e_step_time_local(model, feats_loc, lengths, mesh: Mesh, axis: str = TIME_AXIS):
    """The Baum-Welch statistics of a time-sharded batch from this rank's
    frame blocks (time_shard).  Emission, gamma and xi are local to the
    block; the lattices come from the block-operator exchange above; the one
    more exchange carries (log_b + log_beta) at each block's first frame to
    the rank before it, the term of xi_t = alpha_t + trans + b_{t+1} +
    beta_{t+1} - Z whose transition crosses the block edge.  The statistics
    are sums over frames, so one all_reduce over `axis` completes them, as
    the data axis completes the batch sum."""
    from ..ops.emission import log_mixture_posteriors
    from ..train.em import StreamStats, SuffStats, gmm_moment_stats

    if len(feats_loc) == 1 and len(model.streams) > 1:
        feats_loc = feats_loc * len(model.streams)
    group = mesh.group(axis)
    n, idx = mesh.size(axis), mesh.index(axis)
    B, Tl = feats_loc[0].shape[:2]
    S = model.num_states
    dtype = feats_loc[0].dtype
    t0 = idx * Tl
    log_trans = model.log_trans().to(dtype)
    t_global = t0 + torch.arange(Tl, device=lengths.device)

    log_b, posts = None, []
    for stream, sf in zip(model.streams, feats_loc):
        lb_s, post_s = log_mixture_posteriors(sf, stream)  # (B, Tl, S), (B, Tl, S, M)
        posts.append(post_s)
        log_b = lb_s if log_b is None else log_b + lb_s

    la = _forward_local(log_b, log_trans, lengths, mesh, axis, t0)  # (B, Tl, S)
    lbw = _backward_local(log_b, log_trans, lengths, mesh, axis, t0)

    # the final-state log Z is the last block's last row (padded rows repeat
    # the last valid one)
    log_z = distributed.broadcast(la[:, -1, S - 1].contiguous(), n - 1, group)
    valid = torch.isfinite(log_z) & (lengths > 0)
    safe_z = torch.where(valid, log_z, 0.0)
    vmask = valid.to(dtype)

    frame_mask = (t_global[None, :] < lengths[:, None]).to(dtype)  # (B, Tl)
    gamma = torch.exp(torch.clamp(la + lbw - safe_z[:, None, None], max=0.0)) * frame_mask[..., None] * vmask[:, None, None]

    # xi across the block edge: (log_b + beta) at the NEXT block's first frame
    fwd_in = log_b + lbw  # (B, Tl, S)
    firsts = distributed.all_gather(fwd_in[:, 0].contiguous(), group)  # (n, B, S)
    # the last block has no frame after it; its last xi row is masked anyway
    nxt = firsts[idx + 1] if idx + 1 < n else torch.zeros_like(fwd_in[:, 0])
    fwd_in_next = torch.cat([fwd_in[:, 1:], nxt[:, None]], dim=1)
    xi_mask = (t_global[None, :] < (lengths - 1)[:, None]).to(dtype) * vmask[:, None]  # (B, Tl)
    log_xi = la[..., :, None] + log_trans + fwd_in_next[:, :, None, :] - safe_z[:, None, None, None]
    xi = torch.exp(torch.clamp(log_xi, max=0.0)) * xi_mask[..., None, None]

    stream_stats = []
    for stream, post, sf in zip(model.streams, posts, feats_loc):
        gm = (gamma[..., None] * post).reshape(B * Tl, S, -1)
        w, x, xx = gmm_moment_stats(gm, sf.reshape(B * Tl, -1), stream.cov_type)
        stream_stats.append(StreamStats(w=w, x=x, xx=xx))
    num_trans, den_trans, den_mix, streams = all_reduce_stats(
        (xi.sum((0, 1)), (gamma * xi_mask[..., None]).sum((0, 1)), gamma.sum((0, 1)), tuple(stream_stats)), group
    )
    return SuffStats(
        num_trans=num_trans,
        den_trans=den_trans,
        den_mix=den_mix,
        streams=tuple(streams),
        log_prob=torch.sum(torch.where(valid, log_z, 0.0)),
        num_valid=vmask.sum(),
    )


def e_step_time_sharded(model, batch, mesh: Mesh, axis: str = TIME_AXIS):
    """Batched Baum-Welch E-step with the TIME axis split over `axis`: the
    statistics of train.em.e_step (to summation order) on every rank.  For
    utterances whose lattices outgrow one device.  batch: UtteranceBatch or
    a tuple of per-stream batches, the same whole batch on every rank; its
    frame count must divide by the axis (pack it padded to a multiple)."""
    feats, lengths = time_shard(batch, mesh, axis)
    return e_step_time_local(model, feats, lengths, mesh, axis)
