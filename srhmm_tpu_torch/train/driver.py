"""Chunked convergence driver: reference EM semantics at device speed.

Counterpart of ``srhmm_tpu/train/driver.py``.  The reference's convergence
rule (|old - new| / |old| <= threshold, old initialized to 1.0, the final
pass NOT applying an update — T1:306-346) forces a host decision per EM
iteration, and a naive driver pays a device->host round trip for each one.

This driver keeps the trajectory and pays the round trip once per chunk:

* iterations run in chunks of k (`run_chunk(state, k) -> (state_after_k_
  updates, lps (k,), nvs (k,))`, where lps[j] is the log prob computed on
  the state BEFORE update j) with no host sync inside a chunk;
* the host walks each chunk's fetched log probs and applies the exact
  reference rule; if convergence triggers after j updates mid-chunk, the
  kept model is recomputed as `run_chunk(chunk_start, j)` — EM is
  deterministic, so the re-run reproduces the discarded intermediate
  exactly (one extra chunk, only at the end);
* chunks are issued SPECULATIVELY (pipeline depth 2): while the host blocks
  fetching chunk n's log probs, chunk n+1 is already queued on the device.
  If convergence triggers, the speculative work is discarded;
* with a checkpoint manager (train/checkpoint.py) a newest complete
  checkpoint resumes the run, and the state after a chunk is saved once
  that chunk's log probs are on the host, never while it is in flight.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A chunk's log probs on the host (blocks on that chunk's work only)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def chunked_convergence_train(
    state,
    run_chunk: Callable,
    threshold: float = 1e-3,
    max_iterations: int = 100,
    chunk: int = 8,
    pipeline: int = 2,
    log_prob_offset: float = 0.0,
    checkpoint=None,
):
    """Run `run_chunk` under the reference convergence rule.

    log_prob_offset is added to every fetched log prob before the
    convergence test and before recording history — used by CMVN-normalized
    training to apply the constant Jacobian correction INSIDE the rule (the
    reference's relative-change test is not shift-invariant).

    checkpoint: optional train.checkpoint.CheckpointManager.  The state
    and the driver bookkeeping (iteration, old log prob, history) are saved
    after every fetched chunk and once more at convergence, and a newest
    complete checkpoint in the directory resumes training mid-run with the
    identical trajectory (EM is deterministic and the state is the complete
    driver state).  A crash replays at most `chunk` iterations.

    Returns (final_state, iterations, log_prob_history, last_num_valid).
    `run_chunk(state, k)` must run k EM iterations and return
    (new_state, lps, nvs) with lps[j] the total log prob evaluated on the
    model before the j-th update (the em_train_scan contract).
    """
    from .checkpoint import EmDriverState

    chunk = max(1, min(chunk, max_iterations))
    old = 1.0
    history: list[float] = []
    n_valid = 0
    iteration = 0
    if checkpoint is not None:
        resumed = checkpoint.latest(state)
        if resumed is not None:
            state, ck = resumed
            iteration = ck.iteration
            old = ck.old_log_prob
            history = list(ck.history)
    cur = state
    inflight: deque = deque()
    planned = iteration
    final_state = state
    converged = iteration >= max_iterations

    while True:
        while not converged and planned < max_iterations and len(inflight) < pipeline:
            k = min(chunk, max_iterations - planned)
            out = run_chunk(cur, k)
            inflight.append((cur, out, k))
            cur = out[0]
            planned += k
        if not inflight:
            break
        start, (after, lps, nvs), k = inflight.popleft()
        lps_h = _host(lps)  # blocks on this chunk only; later chunks
        nvs_h = _host(nvs)  # keep running on the device meanwhile
        for j in range(k):
            iteration += 1
            lp = float(lps_h[j]) + log_prob_offset
            history.append(lp)
            n_valid = int(nvs_h[j])
            if old != 0.0 and abs((old - lp) / old) <= threshold:
                # keep the model after j updates (the reference does not
                # apply the final update); re-run the deterministic prefix
                final_state = run_chunk(start, j)[0] if j > 0 else start
                converged = True
                break
            old = lp
        if converged:
            inflight.clear()  # discard speculative chunks
            break
        final_state = after
        if checkpoint is not None:
            # `after` follows every op whose log probs were just fetched on
            # the stream; a speculative chunk queued behind it is not saved
            checkpoint.save(after, EmDriverState(iteration=iteration, old_log_prob=old, history=history))
    if checkpoint is not None and converged:
        checkpoint.save(final_state, EmDriverState(iteration=iteration, old_log_prob=old, history=history))
    return final_state, iteration, history, n_valid
