"""Batched log-space forward scores and Viterbi, (B, T, S) layout.

Counterpart of ``srhmm_tpu/ops/pallas/forward_pallas.py``:

* ``log_forward_batch`` (TPU kernel #15): (B, T, S) log b, (S, S) log
  transitions or (B, S, S) per row (vocabulary scoring), lengths (B,) ->
  (B, S) final log-alpha, the carry frozen past each length.  Scores read
  off as in ops/forward_backward.py: total = logsumexp over states,
  final-state = the last column.
* ``viterbi_batch`` (#16): (S, S) log transitions -> ((B, S) scores,
  (B, T, S) int32 backpointers; row t maps the state at t to the best state
  at t-1, row 0 and rows past a length are the identity, ties go to the
  lowest source as ``lax.argmax`` breaks them).
* ``backtrace``: backpointers -> (B, T) int32 state paths, in plain torch.

CUDA float32 tensors launch the forward kernel of ``csrc/lattice.cu`` in
its last-row mode and its Viterbi kernel, reading (B, T, S) in place, and
count one in ``.launches``; CPU tensors run the plain twins
(``*_plain``), which clamp every input and carry at NEG_INF = -1e30 as the
Pallas kernels do (``ops/forward_backward.py::log_forward`` and
``ops/viterbi.py`` keep -inf).
"""

from __future__ import annotations

import torch

from .common import NEG_INF, check_launch, on_cpu
from .lattice import LatticeLaunch, _clamped, _start, forward_recursion, kernel_library


def log_forward_batch_plain(log_b, log_trans, lengths):
    """The log_forward_batch kernel's function in eager PyTorch: (B, S)
    final log-alpha, float32."""
    lt = log_trans.permute(1, 2, 0) if log_trans.dim() == 3 else log_trans[:, :, None]
    carry, _ = forward_recursion(log_b.permute(1, 2, 0), lt, lengths, keep_rows=False)
    return carry.T.contiguous()


def viterbi_batch_plain(log_b, log_trans, lengths):
    """The viterbi_batch kernel's function in eager PyTorch: ((B, S)
    scores float32, (B, T, S) int32 backpointers).  The best source is
    taken by a strict > from source 0, so ties go to the lowest."""
    B, T, S = log_b.shape
    lb = _clamped(log_b)
    lt = _clamped(log_trans)
    dev = lb.device
    lens = lengths.to(dev)[:, None]
    idc = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    carry = lb[:, 0] + _start(S, 0, dev)[:, 0]
    bptr = torch.empty((B, T, S), dtype=torch.int32, device=dev)
    bptr[:, 0] = idc
    for t in range(1, T):
        cand = carry[:, :, None] + lt  # (B, from, to)
        best = cand[:, 0]
        arg = torch.zeros((B, S), dtype=torch.int32, device=dev)
        for i in range(1, S):
            better = cand[:, i] > best
            best = torch.where(better, cand[:, i], best)
            arg = torch.where(better, i, arg)
        new = torch.clamp(best + lb[:, t], min=NEG_INF)
        keep = lens > t
        bptr[:, t] = torch.where(keep, arg, idc)
        carry = torch.where(keep, new, carry)
    return carry, bptr


def log_forward_batch(log_b, log_trans, lengths):
    """(B, T, S) emissions + (S, S) or per-row (B, S, S) log transitions
    -> (B, S) final log-alpha float32 (see log_forward_batch_plain).

    CUDA float32 tensors launch csrc/lattice.cu's forward kernel in its
    last-row mode and count one in ``log_forward_batch.launches``; CPU
    tensors run the twin."""
    if on_cpu("log_forward_batch", log_b):
        return log_forward_batch_plain(log_b, log_trans, lengths)
    ln = LatticeLaunch("log_forward_batch", log_b, log_trans, lengths, "bts", per_row_ok=True)
    out = ln.empty((ln.B, ln.S))
    check_launch(ln.name, kernel_library().srhmm_lattice_forward(*ln.head(), out.data_ptr(), 1, *ln.tail()))
    log_forward_batch.launches += 1
    return out


log_forward_batch.launches = 0


def viterbi_batch(log_b, log_trans, lengths):
    """(B, T, S) emissions + (S, S) log transitions -> ((B, S) final
    scores, (B, T, S) int32 backpointers) (see viterbi_batch_plain; use
    ``backtrace`` to recover paths).

    CUDA float32 tensors launch csrc/lattice.cu's Viterbi kernel and count
    one in ``viterbi_batch.launches``; CPU tensors run the twin."""
    if on_cpu("viterbi_batch", log_b):
        return viterbi_batch_plain(log_b, log_trans, lengths)
    ln = LatticeLaunch("viterbi_batch", log_b, log_trans, lengths, "bts")
    scores = ln.empty((ln.B, ln.S))
    bptr = ln.empty((ln.B, ln.T, ln.S), torch.int32)
    check_launch(ln.name, kernel_library().srhmm_viterbi(
        *ln.head(), scores.data_ptr(), bptr.data_ptr(), *ln.tail()))
    viterbi_batch.launches += 1
    return scores, bptr


viterbi_batch.launches = 0


def backtrace(bptr, lengths, end_state: int):
    """(B, T, S) backpointers -> (B, T) int32 state paths ending at
    end_state at the last frame; padding rows are the identity, so the path
    ends at end_state at each row's last valid frame too (lengths, kept for
    the JAX signature, are not needed)."""
    B, T, _ = bptr.shape
    state = torch.full((B, 1), end_state, dtype=torch.int64, device=bptr.device)
    path = torch.empty((B, T), dtype=torch.int32, device=bptr.device)
    path[:, T - 1] = end_state
    for t in range(T - 1, 0, -1):
        state = torch.gather(bptr[:, t], 1, state).long()
        path[:, t - 1] = state[:, 0]
    return path
