"""dryrun_multichip: every sharded training path of the port on n ranks at
tiny shapes (counterpart of ``__graft_entry__.py`` dryrun_multichip).

    python -m srhmm_tpu_torch.parallel.dryrun N [--device cpu|cuda]

spawns N ranks (parallel/distributed.py spawn) that run, each against its
unsharded or per-step counterpart: a (data, model) mesh em_step_sharded
(mixtures split over two ranks where N is even), the time-sharded EM step,
the data-parallel fused E-step, the data-parallel and time-parallel EM
scans against their per-step loops, and the data-parallel embedded and
tied E-step and scans.  It raises on the first disagreement and prints one
summary line from the coordinator.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _toy(torch_dtype, S: int, M: int, D: int, B: int, T: int, seed: int = 1):
    """A left-to-right diagonal model and a (B, T) batch from a seed."""
    from ..io.dataset import UtteranceBatch
    from ..models import DIAG, GmmHmm, GmmStream

    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 1.5, size=(S, M, D))
    w = rng.uniform(0.3, 0.7, size=(S, M))
    w /= w.sum(-1, keepdims=True)
    trans = np.zeros((S, S))
    for i in range(S - 1):
        trans[i, i] = trans[i, i + 1] = 0.5
    trans[-1, -1] = 1.0
    model = GmmHmm(trans=torch.as_tensor(trans), streams=[GmmStream(
        torch.as_tensor(w), torch.as_tensor(rng.normal(size=(S, M, D))), torch.as_tensor(1.0 / var),
        torch.as_tensor(np.prod(var, -1)), DIAG)]).astype(torch_dtype)
    feats = torch.as_tensor(rng.normal(size=(B, T, D)), dtype=torch_dtype)
    lengths = torch.as_tensor(rng.integers(T // 2, T + 1, size=B), dtype=torch.int32)
    return model, UtteranceBatch(feats, lengths)


def _close(what: str, got: float, want: float, rtol: float) -> None:
    if not (np.isfinite(got) and abs(got - want) <= rtol * max(1.0, abs(want))):
        raise AssertionError(f"dryrun: {what}: {got} vs {want} (rtol {rtol})")


def _close_all(what: str, got, want, rtol: float) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not (np.isfinite(got).all() and np.allclose(got, want, rtol=rtol, atol=0.0)):
        raise AssertionError(f"dryrun: {what}: {got.tolist()} vs {want.tolist()} (rtol {rtol})")


def _dryrun_rank(r: int, device: str) -> dict:
    from ..models import GmmHmm, stack_models
    from ..models.tying import tie_from_models
    from ..train import embedded as emb
    from ..train import tied as td
    from ..train.em import (
        e_step_fused_lane_sharded,
        em_step_time_sharded,
        em_train_scan_sharded,
        em_train_scan_time_sharded,
        m_step,
    )
    from . import distributed
    from .mesh import em_step_sharded, make_mesh, shard_batch, shard_model
    from .sequence import make_time_mesh

    n = distributed.world_size()
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    S, D = 4, 8
    model, batch = _toy(torch.float32, S, 2 * n_model, D, 2 * n_data, 8 * n)  # T divides the time axis
    model, batch = model.to(distributed.local_device(device)), batch.to(distributed.local_device(device))

    # (data, model) mesh: mixtures over the model axis, rows over the data axis
    mesh = make_mesh(n_data=n_data, n_model=n_model, device=device)
    _, log_prob, num_valid = em_step_sharded(shard_model(model, mesh), shard_batch(batch, mesh), mesh)
    log_prob = float(log_prob)
    if not np.isfinite(log_prob):
        raise AssertionError(f"dryrun: em_step_sharded log prob {log_prob}")

    # time mesh: the same step with the frames split over every rank
    tmesh = make_time_mesh(device=device)
    _, sp_log_prob, _ = em_step_time_sharded(model, batch, tmesh)
    _close("sequence-parallel log prob vs data-parallel", float(sp_log_prob), log_prob, 1e-2)

    # the fused E-step over a pure data mesh
    dmesh = make_mesh(n_data=n, n_model=1, device=device)
    f_log_prob = float(e_step_fused_lane_sharded(model, batch, dmesh).log_prob)
    _close("fused data-parallel log prob", f_log_prob, log_prob, 1e-2)

    # the data-parallel scan against its per-step loop
    n_scan = 4
    _, scan_lps, _ = em_train_scan_sharded(model, batch, n_scan, dmesh)
    cur, ref_lps = model, []
    for _ in range(n_scan):
        st = e_step_fused_lane_sharded(cur, batch, dmesh)
        ref_lps.append(float(st.log_prob))
        cur = m_step(cur, st)
    _close_all("data-parallel scan vs per-step loop", scan_lps.cpu(), ref_lps, 1e-5)

    # the time-parallel scan against its per-step loop
    _, tscan_lps, _ = em_train_scan_time_sharded(model, batch, n_scan, tmesh)
    cur, tref_lps = model, []
    for _ in range(n_scan):
        cur, tlp, _ = em_step_time_sharded(cur, batch, tmesh)
        tref_lps.append(float(tlp))
    _close_all("time-parallel scan vs per-step loop", tscan_lps.cpu(), tref_lps, 1e-5)

    # the composed E-step and scans, embedded and tied
    units = stack_models([GmmHmm(trans=model.trans, streams=list(model.streams), word=f"u{i}") for i in range(3)])
    rng = np.random.default_rng(3)
    trs = torch.as_tensor(rng.integers(0, 3, size=(n, 2)), dtype=torch.int32, device=model.trans.device)
    fts = torch.as_tensor(np.random.default_rng(4).normal(size=(n, 16, D)), dtype=torch.float32,
                          device=model.trans.device)
    lns = torch.full((n,), 16, dtype=torch.int32, device=model.trans.device)
    c_ref = float(emb.batch_stats_fused(units, trs, fts, lns).log_prob)
    c_got = float(emb.batch_stats_fused_sharded(units, trs, fts, lns, dmesh).log_prob)
    _close("data-parallel composed E-step", c_got, c_ref, 1e-2)
    packed = ((trs, fts, lns),)
    _, e_ref, _ = emb._embedded_chunk(units, packed, 2, 0.0, True)
    _, e_got, _ = emb.embedded_train_scan_sharded(units, packed, 2, dmesh)
    _close_all("data-parallel embedded scan", e_got.cpu(), e_ref.cpu(), 1e-4)
    sm = (np.arange(3 * S) // 2).reshape(3, S)  # two states share each senone
    tied = tie_from_models(units, sm).astype(torch.float32)
    _, t_ref, _ = td._tied_chunk(tied, packed, 2, 0.0, True)
    _, t_got, _ = td.tied_train_scan_sharded(tied, packed, 2, dmesh)
    _close_all("data-parallel tied scan", t_got.cpu(), t_ref.cpu(), 1e-4)
    return {
        "mesh": dict(mesh.shape), "log_prob": log_prob, "valid": int(num_valid),
        "time_mesh": dict(tmesh.shape), "sp_log_prob": float(sp_log_prob),
        "fused_dp_log_prob": f_log_prob, "sharded_scan_lps": scan_lps.tolist(),
        "sp_scan_lps": tscan_lps.tolist(), "composed_dp_log_prob": c_got,
        "tied_scan_lps": t_got.tolist(),
    }


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run the checks above on `n_devices` spawned ranks (on the card
    unless device="cpu"; ranks that share a card talk over gloo) and return
    the coordinator's summary; raises if any rank fails or disagrees."""
    from . import distributed

    summary = distributed.spawn(_dryrun_rank, n_devices, args=(device,), device=device, timeout_s=timeout_s)[0]
    print("dryrun_multichip OK: " + " ".join(f"{k}={v}" for k, v in summary.items()), flush=True)
    return summary


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ns = ap.parse_args()
    dryrun_multichip(ns.n, ns.device)
    sys.exit(0)
