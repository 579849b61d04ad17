"""Rank meshes for EM training and batch scoring (counterpart of
``srhmm_tpu/parallel/mesh.py``).

* **Data parallelism**: utterance batches split over a ``data`` axis.  EM
  sufficient statistics are linear in the data, so each rank's E-step on
  its rows plus one ``all_reduce(SUM)`` of the statistics is the E-step of
  the whole batch; every rank then runs the same M-step on the same
  reduced statistics, which keeps the model replicated by construction.
* **Mixture parallelism**: the Gaussian-mixture axis M of each stream
  split over a ``model`` axis.  The per-state logsumexp over M becomes an
  ``all_reduce(MAX)`` and an ``all_reduce(SUM)`` of the shifted
  exponentials (ops/emission.py); the per-mixture statistics stay on their
  rank until the M-step, which normalizes the weights over all M mixtures
  and re-seeds collapsed mixtures from the largest-determinant one of the
  state, so it runs on the statistics gathered over the ``model`` axis and
  each rank keeps its slice.

Where the JAX package places arrays with NamedSharding and lets GSPMD
insert the collectives, the port runs one process per rank
(parallel/distributed.py) and calls the collectives itself.  Ranks lay out
row-major over (data, model), as ``np.reshape`` lays out the JAX mesh; a
single-process world gives the trivial 1 x 1 mesh, on which every sharded
function is its unsharded counterpart.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..io.dataset import UtteranceBatch
from ..models.gmm_hmm import FULL, GmmHmm, GmmStream
from . import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ranks.

    shape: {axis: size}, axes in row-major order; coords: this rank's index
    along each axis; groups: the process group of the ranks that differ
    from this one along each axis only (None for an axis of one rank: its
    collectives are the identity); device: this rank's device."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def _build_mesh(shape: dict, device: str) -> Mesh:
    """The mesh of `shape` over this world, its groups made with new_group in
    the same order on every rank (every rank must call new_group for every
    group, members or not)."""
    n = distributed.world_size()
    sizes = tuple(shape.values())
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} != {n} ranks")
    me = distributed.rank()
    grid = np.arange(n).reshape(sizes)
    coords = dict(zip(shape, (int(c) for c in np.unravel_index(me, sizes))))
    groups = {}
    for i, axis in enumerate(shape):
        groups[axis] = None
        if sizes[i] == 1:
            continue
        for ranks in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]):
            g = dist.new_group([int(r) for r in ranks])
            if me in ranks:
                groups[axis] = g
    return Mesh(shape=dict(shape), coords=coords, groups=groups, device=distributed.local_device(device))


def make_mesh(n_data: int | None = None, n_model: int = 1, device: str = "cuda") -> Mesh:
    """A (data, model) mesh over the ranks of this run (the whole world).
    device: "cuda" (each rank's own card, distributed.local_device) or
    "cpu"."""
    n = distributed.world_size()
    if n_data is None:
        if n % n_model:
            raise ValueError(f"{n} ranks not divisible by n_model={n_model}")
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} ranks")
    return _build_mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, device)


def require_axis(fn: str, mesh, axis: str) -> None:
    """Raise TypeError unless `mesh` is a Mesh with `axis`."""
    if not isinstance(mesh, Mesh) or axis not in mesh.shape:
        raise TypeError(f"{fn}: mesh must be a srhmm_tpu_torch.parallel.Mesh with a {axis!r} axis, got {mesh!r}")


def shard_rows(t: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's contiguous rows [i B/n, (i+1) B/n) of `t` along dim 0,
    on the mesh's device (the layout of P(axis)).  B must divide by n."""
    n, i = mesh.size(axis), mesh.index(axis)
    B = t.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by mesh axis {axis!r} ({n}); pad with empty utterances")
    b = B // n
    return t[i * b : (i + 1) * b].to(mesh.device)


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS, local: bool = False):
    """This rank's rows of a padded batch (UtteranceBatch, or a tuple of them
    for multi-stream models) on the mesh's device.  The batch size must
    divide by the axis size (pad_batch_to in io/dataset.py adds zero-length
    rows, which contribute zero statistics).  local=True: the batch already
    holds only this rank's rows (each process read its own shard); it is
    moved to the device as it is."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, mesh, axis, local) for b in batch)
    if local:
        return batch.to(mesh.device)
    return UtteranceBatch(shard_rows(batch.features, mesh, axis), shard_rows(batch.lengths, mesh, axis))


# the mixture axis of each GmmStream buffer, from the end
def _mixture_dims(stream: GmmStream) -> dict:
    return {"weights": -1, "means": -2, "inv_cov": -3 if stream.cov_type == FULL else -2, "det": -1, "log_det": -1}


def _map_stream(stream: GmmStream, fn) -> GmmStream:
    return GmmStream(cov_type=stream.cov_type,
                     **{k: fn(getattr(stream, k), d) for k, d in _mixture_dims(stream).items()})


def shard_model(model: GmmHmm, mesh: Mesh, shard_mixtures: bool | None = None) -> GmmHmm:
    """The model on the mesh's device, its mixture axis sliced by this
    rank's `model` coordinate when that axis has more than one rank (the
    transitions replicated).  Each stream's M must divide by the axis."""
    if shard_mixtures is None:
        shard_mixtures = mesh.size(MODEL_AXIS) > 1
    n, i = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)

    def part(t, d):
        if not shard_mixtures:
            return t.to(mesh.device)
        M = t.shape[d]
        if M % n:
            raise ValueError(f"{M} mixtures not divisible by mesh axis 'model' ({n})")
        return t.narrow(d, i * (M // n), M // n).to(mesh.device)

    return GmmHmm(trans=model.trans.to(mesh.device), streams=[_map_stream(s, part) for s in model.streams],
                  word=model.word)


def replicate(tree, mesh: Mesh):
    """A module, tensor or batch on the mesh's device, whole on every rank."""
    return tree.to(mesh.device)


def gather_model(model: GmmHmm, mesh: Mesh) -> GmmHmm:
    """The whole model from the mixture slices of the `model` axis, on every
    rank of it (for outputs, tests and the mixture-sharded M-step)."""
    group = mesh.group(MODEL_AXIS)

    def whole(t, d):
        return torch.cat(list(distributed.all_gather(t, group)), dim=d)

    return GmmHmm(trans=model.trans, streams=[_map_stream(s, whole) for s in model.streams], word=model.word)


# ---------------------------------------------------------------------------
# statistics trees: one collective per E-step
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    raise TypeError(f"not a statistics tree leaf: {type(tree).__name__}")


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _rebuild(getattr(tree, f.name), it) for f in dataclasses.fields(tree)})
    return type(tree)(_rebuild(t, it) for t in tree)


def all_reduce_stats(stats, group):
    """The sum over `group` of a statistics tree (SuffStats, the tied
    trainer's tuple, or any nesting of dataclasses, tuples and tensors of
    one dtype): every leaf flattened into one buffer in a fixed order, one
    all_reduce(SUM), and the leaves cut back out.  group None: the tree as
    it is."""
    if group is None:
        return stats
    leaves = _leaves(stats)
    flat = distributed.all_reduce(torch.cat([t.reshape(-1) for t in leaves]), group)
    parts = torch.split(flat, [t.numel() for t in leaves])
    return _rebuild(stats, iter(p.reshape(t.shape) for p, t in zip(parts, leaves)))


def _gather_stream_stats(st, stream: GmmStream, group):
    """StreamStats with the mixture axis gathered over `group`."""
    from ..train.em import StreamStats

    xx_dim = -3 if stream.cov_type == FULL else -2
    whole = lambda t, d: torch.cat(list(distributed.all_gather(t, group)), dim=d)
    return StreamStats(w=whole(st.w, -1), x=whole(st.x, -2), xx=whole(st.xx, xx_dim))


def em_step_sharded(model: GmmHmm, batch, mesh: Mesh, var_floor: float = 0.0):
    """One EM iteration over this rank's shard: model from shard_model,
    batch from shard_batch.  The E-step's mixture logsumexp runs over the
    `model` axis, its statistics sum over the `data` axis (one
    all_reduce); the M-step runs on the statistics gathered over the
    `model` axis, the transitions replicated.  Returns (this rank's slice
    of the new model, total log prob, num valid), the model sliced as
    shard_model slices it."""
    from ..train.em import e_step, m_step

    model_group = mesh.group(MODEL_AXIS)
    stats = e_step(model, batch, model_group=model_group)
    stats = all_reduce_stats(stats, mesh.group(DATA_AXIS))
    if model_group is None:
        return m_step(model, stats, var_floor=var_floor), stats.log_prob, stats.num_valid
    whole = gather_model(model, mesh)
    gathered = dataclasses.replace(
        stats, streams=tuple(_gather_stream_stats(st, s, model_group) for st, s in zip(stats.streams, model.streams))
    )
    new = m_step(whole, gathered, var_floor=var_floor)
    return shard_model(new, mesh), stats.log_prob, stats.num_valid
