"""Checkpoint / resume / failure recovery (counterpart of
``srhmm_tpu/train/checkpoint.py``).

The reference's only checkpoint is the final `.hmm` write, and its
documented warm-start flag is broken (argv[argc] off-by-one, T1:204): a
crash mid-EM loses everything.

Here every EM iteration can be checkpointed.  Two formats:

* **reference-compatible `.hmm`** (io/hmm_format.py): interchange with the
  C programs, final-model export;
* **native checkpoint**: the model's ``state_dict()`` through ``torch.save``
  plus a JSON sidecar holding the EM driver state (iteration, last log prob,
  history), so a restarted job resumes mid-training with identical
  subsequent iterations.  EM is restartable at iteration granularity
  because the model is the complete driver state (statistics are recomputed
  each pass).

A checkpoint is ``ckpt_{iteration:06d}.pt`` and ``ckpt_{iteration:06d}.json``.
Both are written under a temporary name and renamed, the sidecar last, so
the sidecar's presence marks a complete checkpoint.  ``latest()`` loads the
newest complete one into a copy of a template module (``GmmHmm``, a stacked
vocabulary, ``TiedHmmSet``): every key, shape and dtype must equal the
template's, or it raises, so a checkpoint is never half-loaded.  Fields that
are not tensors (word, covariance types, unit names) come from the template.
With ``torch.distributed`` initialized only rank 0 writes; every rank
computes the same replicated model.
"""

from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass
from pathlib import Path

import torch
from torch import nn


@dataclass
class EmDriverState:
    iteration: int
    old_log_prob: float
    history: list


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _paths(self, iteration: int) -> tuple[Path, Path]:
        return self.dir / f"ckpt_{iteration:06d}.pt", self.dir / f"ckpt_{iteration:06d}.json"

    @staticmethod
    def should_write() -> bool:
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return torch.distributed.get_rank() == 0
        return True

    def save(self, model: nn.Module, state: EmDriverState) -> None:
        if not self.should_write():
            return
        pt, js = self._paths(state.iteration)
        meta = {
            "iteration": state.iteration,
            "old_log_prob": state.old_log_prob,
            "history": state.history,
            # model-identity fields are best-effort: the manager handles any
            # trainer-state module (GmmHmm, stacked vocab, TiedHmmSet)
            "word": str(getattr(model, "word", "")),
            "cov_types": [s.cov_type for s in getattr(model, "streams", ())],
        }
        tmp = pt.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            torch.save(model.state_dict(), f)
        os.replace(tmp, pt)  # atomic: .json presence marks completeness
        tmp_j = js.with_suffix(".jtmp")
        tmp_j.write_text(json.dumps(meta))
        os.replace(tmp_j, js)
        self._gc()

    def _gc(self):
        done = sorted(self.dir.glob("ckpt_*.json"))
        for js in done[: -self.keep]:
            js.with_suffix(".pt").unlink(missing_ok=True)
            js.unlink(missing_ok=True)

    def latest(self, template: nn.Module) -> tuple[nn.Module, EmDriverState] | None:
        """Newest complete checkpoint, loaded into a copy of `template` on
        the template's device (keys, shapes and dtypes must match the run's
        configuration)."""
        done = sorted(self.dir.glob("ckpt_*.json"))
        for js in reversed(done):
            pt = js.with_suffix(".pt")
            if not pt.exists():
                continue
            meta = json.loads(js.read_text())
            model = _load_into(template, pt)
            return model, EmDriverState(
                iteration=meta["iteration"],
                old_log_prob=meta["old_log_prob"],
                history=meta["history"],
            )
        return None


def _load_into(template: nn.Module, path: str | Path) -> nn.Module:
    """A copy of `template` holding the state dict saved at `path`.  Raises
    ValueError, before anything is copied, when the saved keys, shapes or
    dtypes differ from the template's."""
    want = template.state_dict()
    device = next(iter(want.values())).device
    got = torch.load(path, map_location=device, weights_only=True)
    missing, unexpected = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or unexpected:
        raise ValueError(f"{path}: keys differ from the template (missing {missing}, unexpected {unexpected})")
    for k, t in want.items():
        g = got[k]
        if not isinstance(g, torch.Tensor) or g.shape != t.shape or g.dtype != t.dtype:
            what = (tuple(g.shape), g.dtype) if isinstance(g, torch.Tensor) else type(g).__name__
            raise ValueError(f"{path}: {k} is {what}, the template's is {(tuple(t.shape), t.dtype)}")
    model = copy.deepcopy(template)
    model.load_state_dict(got, strict=True)
    return model


def train_fast_resumable(
    model,
    batch,
    ckpt_dir: str | Path,
    threshold: float = 1.0e-3,
    max_iterations: int = 100,
    var_floor: float = 0.0,
    log_prob_offset: float = 0.0,
):
    """train_fast with per-iteration checkpointing and automatic resume.

    Crash-and-restart at any point continues from the last completed
    iteration with the identical trajectory (EM state == model + scalar
    bookkeeping).  One em_step an iteration, through the fused kernels when
    eligible; the band and eligibility are decided once, from the model
    passed in (EM preserves the transition structure)."""
    from .em import _as_batches, _fused_setup, em_step
    from .em_parity import TrainResult

    use_fused, feats_tdb, band = _fused_setup(model, batch)
    mgr = CheckpointManager(ckpt_dir)
    state = EmDriverState(iteration=0, old_log_prob=1.0, history=[])
    resumed = mgr.latest(model)
    if resumed is not None:
        model, state = resumed

    n_valid = _as_batches(batch)[0].batch_size
    while state.iteration < max_iterations:
        state.iteration += 1
        new_model, log_prob, num_valid = em_step(
            model, batch, var_floor, fused=use_fused, feats_tdb=feats_tdb, band=band
        )
        log_prob = float(log_prob) + log_prob_offset
        n_valid = int(num_valid)
        state.history.append(log_prob)
        if state.old_log_prob != 0.0 and (
            abs((state.old_log_prob - log_prob) / state.old_log_prob) <= threshold
        ):
            mgr.save(model, state)
            break
        state.old_log_prob = log_prob
        model = new_model
        mgr.save(model, state)
    return TrainResult(
        model=model,
        iterations=state.iteration,
        mean_log_prob=state.history[-1] / max(n_valid, 1),
        exemplar_count=n_valid,
        log_prob_history=state.history,
    )
