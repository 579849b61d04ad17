"""Tied-state (senone) model sets (counterpart of ``srhmm_tpu/models/tying.py``).

A tied-state triphone system keeps many context-dependent unit HMMs whose
emission states SHARE a smaller inventory of Gaussian mixtures (senones):
one senone ``GmmStream`` of shape (N, M, ...) plus an integer map
(unit, state) -> senone.  Senone emissions for an utterance are one
computation however many units share them, and EM statistics segment-sum
into the senone inventory: tying IS the scatter.

``materialize()`` expands to a stacked per-unit ``GmmHmm`` (gathering senone
parameters), so every decode and scoring path works unchanged on tied
systems.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from .gmm_hmm import FULL, GmmHmm, GmmStream, _tensor


class TiedHmmSet(nn.Module):
    """senones: (N, M, ...) shared emission states; trans: (P, S, S) per-unit
    transitions; state_map: (P, S) int32 senone ids; unit_names: one name
    per unit."""

    def __init__(self, senones: GmmStream, trans, state_map, unit_names: Any = ()):
        super().__init__()
        self.senones = senones
        self.register_buffer("trans", _tensor(trans))
        self.register_buffer("state_map", _tensor(state_map, dtype=torch.int32))
        self.unit_names = unit_names

    @property
    def num_units(self) -> int:
        return self.trans.shape[0]

    @property
    def num_states(self) -> int:
        return self.trans.shape[-1]

    @property
    def num_senones(self) -> int:
        return self.senones.weights.shape[0]

    def log_trans(self) -> torch.Tensor:
        t = self.trans
        return torch.where(t > 0, torch.log(torch.where(t > 0, t, torch.ones_like(t))), -torch.inf)

    def materialize(self) -> GmmHmm:
        """Expand to a stacked per-unit GmmHmm (P, S, M, ...) by gathering
        senone parameters, for the existing decode machinery."""
        sm = self.state_map.long()
        sen = self.senones
        stream = GmmStream(
            weights=sen.weights[sm],
            means=sen.means[sm],
            inv_cov=sen.inv_cov[sm],
            det=sen.det[sm],
            cov_type=sen.cov_type,
            log_det=sen.log_det[sm],
        )
        return GmmHmm(trans=self.trans, streams=[stream], word=self.unit_names)

    def astype(self, dtype: torch.dtype) -> "TiedHmmSet":
        """Cast for compute, on the same device (``GmmStream.astype``)."""
        return TiedHmmSet(
            senones=self.senones.astype(dtype),
            trans=self.trans.to(dtype),
            state_map=self.state_map,
            unit_names=self.unit_names,
        )


def untied_state_map(num_units: int, num_states: int) -> torch.Tensor:
    """The no-sharing map: senone id = unit * S + state (N = P*S)."""
    return torch.arange(num_units * num_states, dtype=torch.int32).reshape(num_units, num_states)


def tie_from_models(models: GmmHmm, state_map) -> TiedHmmSet:
    """A tied set from a stacked per-unit GmmHmm: the parameters of the
    states mapped to one senone are averaged in float64 on the host (a
    seeding scheme; decision-tree clustering chooses the map).  Full
    covariance pools the inverse covariances and re-derives det from the
    pooled inverse.  The senones land on the models' device."""
    stream = models.streams[0]
    sm = np.asarray(state_map.cpu() if isinstance(state_map, torch.Tensor) else state_map)
    N = int(sm.max()) + 1
    P, S = sm.shape

    def pool(a):
        a = a.detach().cpu().numpy().astype(np.float64)
        flat = a.reshape(P * S, *a.shape[2:])
        out = np.zeros((N, *a.shape[2:]))
        cnt = np.zeros(N)
        np.add.at(out, sm.reshape(-1), flat)
        np.add.at(cnt, sm.reshape(-1), 1.0)
        return out / cnt.reshape(-1, *([1] * (a.ndim - 2)))

    weights = pool(stream.weights)
    weights = weights / weights.sum(-1, keepdims=True)
    means = pool(stream.means)
    inv = pool(stream.inv_cov)
    if stream.cov_type == FULL:
        det = 1.0 / np.abs(np.linalg.det(inv))
    else:
        det = np.prod(1.0 / inv, axis=-1)
    dev = models.trans.device
    senones = GmmStream(
        weights=torch.as_tensor(weights, device=dev),
        means=torch.as_tensor(means, device=dev),
        inv_cov=torch.as_tensor(inv, device=dev),
        det=torch.as_tensor(det, device=dev),
        cov_type=stream.cov_type,
    )
    return TiedHmmSet(
        senones=senones,
        trans=models.trans,
        state_map=torch.as_tensor(sm, dtype=torch.int32, device=dev),
        unit_names=models.word,
    )
