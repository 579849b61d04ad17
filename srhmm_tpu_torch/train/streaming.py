"""Streaming EM: datasets larger than device memory, with async prefetch
(counterpart of ``srhmm_tpu/train/streaming.py``).

EM sufficient statistics are linear in the data, so an iteration over a
dataset that does not fit the card is a sum of per-shard E-steps: stream
the shards through the device (io/pipeline.device_put_loader copies shard
k+1 on its own CUDA stream behind the compute of shard k), add the
SuffStats up on the device in shard order, and run one M-step.  Each shard
goes through the fused E-step kernels (csrc/fused_em.cu, kernels #2 / #3,
or #4 / #5 for several streams) when ``_fused_lane_eligible`` allows, else
the plain ``e_step``.

The per-iteration host sync (the reference convergence rule) is free here:
each iteration already walks the whole dataset, which costs far more than
one round trip.
"""

from __future__ import annotations

import torch

from ..io.dataset import UtteranceBatch
from ..io.pipeline import device_put_loader, pin_batch
from ..ops.kernels.common import trans_band
from .em import _e_step_any, _fused_lane_eligible, m_step
from .embedded import _add_stats


def em_step_streaming(
    model,
    loader,
    var_floor: float = 0.0,
    fused: bool | None = None,
    band: int | None = None,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """One EM iteration over a stream of UtteranceBatch shards.

    loader: an iterable of device-resident UtteranceBatch (typically a
    device_put_loader, so shard k+1 copies while shard k computes).
    fused: None picks the fused kernels from the first shard when eligible
    (the rule of em_step); band: the static transition band, None computes
    it from model.trans on the host (a device sync) unless fused is False.
    Returns (new_model, total_log_prob, num_valid), the last two as device
    scalars."""
    if band is None and fused is not False:
        band = trans_band(model.trans.detach().cpu().numpy())
    agg = None
    for batch in loader:
        if fused is None:
            fused = _fused_lane_eligible(model, batch, band)
        st = _e_step_any(model, batch, fused, None, band)
        agg = st if agg is None else _add_stats(agg, st)
    if agg is None:
        raise ValueError("em_step_streaming: empty loader")
    new_model = m_step(model, agg, var_floor=var_floor, abs_floors=abs_floors,
                       zero_det_thresholds=zero_det_thresholds)
    return new_model, agg.log_prob, agg.num_valid


def train_streaming(
    model,
    host_shards,
    threshold: float = 1.0e-3,
    max_iterations: int = 100,
    var_floor: float = 0.0,
    depth: int = 2,
    log_prob_offset: float = 0.0,
    abs_floors=None,
    zero_det_thresholds=None,
):
    """EM driver with the reference convergence rule over sharded data.

    host_shards: list of UtteranceBatch (or tuples of them, one per stream)
    whose tensors live on the HOST; each iteration streams them to the
    model's device through a fresh io/pipeline.device_put_loader, so the
    copy of shard k+1 overlaps the E-step of shard k.  Semantically
    identical to `train_fast` on the concatenated batch (statistics are
    summed in shard order).  The band is decided once from the initial
    model, and the shards are pinned once when the model is on a card."""
    from .em_parity import TrainResult

    device = model.trans.device
    if device.type == "cuda":
        host_shards = [pin_batch(s) for s in host_shards]
    band = trans_band(model.trans.detach().cpu().numpy())
    old = 1.0
    history: list[float] = []
    iteration = 0
    n_valid = 0
    while iteration < max_iterations:
        iteration += 1
        loader = device_put_loader(host_shards, depth=depth, device=device)
        new_model, log_prob, num_valid = em_step_streaming(
            model, loader, var_floor=var_floor, band=band,
            abs_floors=abs_floors, zero_det_thresholds=zero_det_thresholds,
        )
        lp = float(log_prob) + log_prob_offset
        n_valid = int(num_valid)
        history.append(lp)
        if old != 0.0 and abs((old - lp) / old) <= threshold:
            break
        old = lp
        model = new_model
    return TrainResult(
        model=model,
        iterations=iteration,
        mean_log_prob=history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=history,
    )


def shard_batch(batch, n_shards: int):
    """Split a host UtteranceBatch (or a tuple of them, one per stream) into
    n roughly-equal shards along the batch axis (equal (T, D), so every
    shard takes the same launch shapes).  Shards keep a common batch size by
    zero-length padding the tail (inert rows)."""
    if isinstance(batch, tuple):
        return [tuple(s) for s in zip(*(shard_batch(b, n_shards) for b in batch))]
    feats = batch.features.detach().cpu()
    lengths = batch.lengths.detach().cpu()
    B = feats.shape[0]
    n_shards = max(1, min(n_shards, B))
    per = -(-B // n_shards)
    shards = []
    for i in range(0, B, per):
        f = feats[i : i + per]
        ln = lengths[i : i + per]
        if f.shape[0] < per:  # pad the tail shard to the common shape
            pad = per - f.shape[0]
            f = torch.cat([f, f.new_zeros((pad,) + tuple(f.shape[1:]))])
            ln = torch.cat([ln, ln.new_zeros((pad,))])
        shards.append(UtteranceBatch(features=f, lengths=ln))
    return shards
