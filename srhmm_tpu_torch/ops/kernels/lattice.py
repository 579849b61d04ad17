"""Dense log-domain lattice kernels: the whole forward and backward lattices.

Counterpart of ``srhmm_tpu/ops/pallas/lattice_pallas.py``.  Four wrappers,
two hand-written CUDA kernels (``csrc/lattice.cu``) and their plain PyTorch
twins (``*_plain``); CUDA float32 tensors launch a kernel, CPU tensors run
its twin, and nothing falls back from one to the other:

* ``forward_lattice`` (TPU kernel #17) and ``forward_lattice_blocked``
  (#20): (T, S, B) log b, (S, S) log transitions, lengths (B,) -> (T, S, B)
  log-alpha, started in state 0; rows at t >= length repeat the last valid
  row;
* ``backward_lattice`` (#18) and ``backward_lattice_blocked`` (#19): ->
  (T, S, B) log-beta, started in the final state; rows at t >= length-1
  hold that initialization.

Every input is clamped at NEG_INF = -1e30 and so is every carry, as the
Pallas kernels do (the plain scans of train/em.py use -inf instead).  The
blocked wrappers keep the JAX signature and its ``T % k_block == 0``
assertion, but ``k_block`` was the TPU's time tiling: they launch the same
kernel as the unblocked ones, each counting its own launches in
``.launches``.  ``csrc/lattice.cu`` also holds the forward kernel's
last-row mode and the Viterbi kernel of ops/kernels/forward.py.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .common import NEG_INF, check_launch, device_args, on_cpu, require_float32

MAX_STATES = 64  # csrc/lattice.cu kMaxStates
THREADS_PER_BLOCK = 128  # a block holds max(1, 128 // S) utterances


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _clamped(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x.to(torch.float32), min=NEG_INF)


def _start(S: int, state: int, device) -> torch.Tensor:
    """(S, 1): 0 in `state`, NEG_INF elsewhere."""
    return torch.where(torch.arange(S, device=device) == state, 0.0, NEG_INF)[:, None]


def forward_recursion(log_b_tsb, lt_ssb, lengths, keep_rows: bool):
    """The forward kernel's function on (T, S, B) log b and (S, S, 1)
    shared or (S, S, B) per-utterance log transitions: (final carries
    (S, B), the (T, S, B) lattice or None), float32."""
    T, S, B = log_b_tsb.shape
    lb = _clamped(log_b_tsb)
    lt = _clamped(lt_ssb)
    lens = lengths.to(lb.device)
    carry = lb[0] + _start(S, 0, lb.device)  # frame 0 always initializes, unclamped
    rows = [carry] if keep_rows else None
    for t in range(1, T):
        cand = carry[:, None, :] + lt  # (from, to, B)
        m = torch.clamp(cand.amax(0), min=NEG_INF)
        new = torch.clamp(m + torch.log(torch.exp(cand - m).sum(0)) + lb[t], min=NEG_INF)
        carry = torch.where(lens > t, new, carry)
        if keep_rows:
            rows.append(carry)
    return carry, (torch.stack(rows) if keep_rows else None)


def forward_lattice_plain(log_b_tsb, log_trans, lengths):
    """The forward lattice kernels' function in eager PyTorch: (T, S, B)
    log-alpha, float32."""
    return forward_recursion(log_b_tsb, log_trans[:, :, None], lengths, keep_rows=True)[1]


def backward_lattice_plain(log_b_tsb, log_trans, lengths):
    """The backward lattice kernels' function in eager PyTorch: (T, S, B)
    log-beta, float32, final-state initialization at each utterance's last
    valid frame."""
    T, S, B = log_b_tsb.shape
    lb = _clamped(log_b_tsb)
    lt = _clamped(log_trans)[:, :, None]
    lens = lengths.to(lb.device)
    beta_t = _start(S, S - 1, lb.device).expand(S, B)
    carry = beta_t
    rows = [carry]
    for t in range(T - 2, -1, -1):
        cand = lt + (lb[t + 1] + carry)[None]  # (from, to, B)
        m = torch.clamp(cand.amax(1), min=NEG_INF)
        new = torch.clamp(m + torch.log(torch.exp(cand - m[:, None]).sum(1)), min=NEG_INF)
        carry = torch.where(lens > t + 1, new, beta_t)
        rows.append(carry)
    return torch.stack(rows[::-1])


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/lattice.cu)
# ---------------------------------------------------------------------------


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The built kernel library with the lattice launchers' C signatures."""
    from .build import load_library

    lib = load_library()
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    head = [c_ptr, c_ll, c_ll, c_ll, c_ptr, c_int, c_ptr]  # log_b st ss sb lt per_row lengths
    tail = [c_int] * 6 + [c_ptr]  # T S B U state_minor device, stream
    lib.srhmm_lattice_forward.restype = c_int
    lib.srhmm_lattice_forward.argtypes = head + [c_ptr, c_int] + tail  # out, last_only
    lib.srhmm_lattice_backward.restype = c_int
    lib.srhmm_lattice_backward.argtypes = head + [c_ptr] + tail  # out
    lib.srhmm_viterbi.restype = c_int
    lib.srhmm_viterbi.argtypes = head + [c_ptr, c_ptr] + tail  # scores, bptr
    return lib


class LatticeLaunch:
    """Checked operands of one csrc/lattice.cu launch.  layout "tsb": log b
    (T, S, B), threads state-major; "bts": (B, T, S), utterance-major.
    log_trans (S, S), or with per_row_ok also (B, S, S) per utterance."""

    def __init__(self, name: str, log_b, log_trans, lengths, layout: str, per_row_ok: bool = False):
        dev = log_b.device
        require_float32(name, dev, [log_b, log_trans, lengths], [log_b, log_trans])
        if log_b.dim() != 3:
            raise ValueError(f"{name}: log b must have three axes, got {tuple(log_b.shape)}")
        if layout == "tsb":
            T, S, B = log_b.shape
            self.strides, self.state_minor = (S * B, B, 1), 0
        else:
            B, T, S = log_b.shape
            self.strides, self.state_minor = (S, 1, T * S), 1
        self.per_row = int(per_row_ok and log_trans.dim() == 3)
        want = (B, S, S) if self.per_row else (S, S)
        if tuple(log_trans.shape) != want or tuple(lengths.shape) != (B,):
            raise ValueError(f"{name}: log transitions {want} and lengths ({B},) must fit log b")
        if not 1 <= S <= MAX_STATES or T < 1 or B < 1:
            raise ValueError(f"{name}: 1 to {MAX_STATES} states and T, B >= 1, got T={T} S={S} B={B}")
        self.name, self.dev, self.T, self.S, self.B = name, dev, T, S, B
        self.U = max(1, THREADS_PER_BLOCK // S)
        # kept alive in locals of the wrapper until the launch is queued
        self.log_b = log_b.contiguous()
        self.log_trans = log_trans.contiguous()
        self.lengths = lengths.to(torch.int32).contiguous()

    def head(self):
        return [self.log_b.data_ptr(), *self.strides, self.log_trans.data_ptr(), self.per_row,
                self.lengths.data_ptr()]

    def tail(self):
        return [self.T, self.S, self.B, self.U, self.state_minor, *device_args(self.dev)]

    def empty(self, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=self.dev)


def _forward_cuda(name, log_b_tsb, log_trans, lengths):
    ln = LatticeLaunch(name, log_b_tsb, log_trans, lengths, "tsb")
    out = ln.empty((ln.T, ln.S, ln.B))
    check_launch(name, kernel_library().srhmm_lattice_forward(*ln.head(), out.data_ptr(), 0, *ln.tail()))
    return out


def _backward_cuda(name, log_b_tsb, log_trans, lengths):
    ln = LatticeLaunch(name, log_b_tsb, log_trans, lengths, "tsb")
    out = ln.empty((ln.T, ln.S, ln.B))
    check_launch(name, kernel_library().srhmm_lattice_backward(*ln.head(), out.data_ptr(), *ln.tail()))
    return out


def forward_lattice(log_b_tsb, log_trans, lengths):
    """(T, S, B) emissions -> (T, S, B) log-alpha lattice (rows at
    t >= length repeat the row at length-1); see forward_lattice_plain.

    CUDA float32 tensors launch the forward kernel of csrc/lattice.cu and
    count one in ``forward_lattice.launches``; CPU tensors run the twin."""
    if on_cpu("forward_lattice", log_b_tsb):
        return forward_lattice_plain(log_b_tsb, log_trans, lengths)
    out = _forward_cuda("forward_lattice", log_b_tsb, log_trans, lengths)
    forward_lattice.launches += 1
    return out


forward_lattice.launches = 0


def backward_lattice(log_b_tsb, log_trans, lengths):
    """(T, S, B) emissions -> (T, S, B) log-beta lattice, final-state
    initialization at each utterance's last valid frame; see
    backward_lattice_plain.

    CUDA float32 tensors launch the backward kernel of csrc/lattice.cu and
    count one in ``backward_lattice.launches``; CPU tensors run the twin."""
    if on_cpu("backward_lattice", log_b_tsb):
        return backward_lattice_plain(log_b_tsb, log_trans, lengths)
    out = _backward_cuda("backward_lattice", log_b_tsb, log_trans, lengths)
    backward_lattice.launches += 1
    return out


backward_lattice.launches = 0


def forward_lattice_blocked(log_b_tsb, log_trans, lengths, k_block: int = 8):
    """forward_lattice under the time-blocked TPU kernel's signature
    (T % k_block == 0).  The same kernel runs whatever k_block; a CUDA
    launch counts one in ``forward_lattice_blocked.launches``."""
    T = log_b_tsb.shape[0]
    assert T % k_block == 0, (T, k_block)
    if on_cpu("forward_lattice_blocked", log_b_tsb):
        return forward_lattice_plain(log_b_tsb, log_trans, lengths)
    out = _forward_cuda("forward_lattice_blocked", log_b_tsb, log_trans, lengths)
    forward_lattice_blocked.launches += 1
    return out


forward_lattice_blocked.launches = 0


def backward_lattice_blocked(log_b_tsb, log_trans, lengths, k_block: int = 16):
    """backward_lattice under the time-blocked TPU kernel's signature
    (T % k_block == 0); a CUDA launch counts one in
    ``backward_lattice_blocked.launches``."""
    T = log_b_tsb.shape[0]
    assert T % k_block == 0, (T, k_block)
    if on_cpu("backward_lattice_blocked", log_b_tsb):
        return backward_lattice_plain(log_b_tsb, log_trans, lengths)
    out = _backward_cuda("backward_lattice_blocked", log_b_tsb, log_trans, lengths)
    backward_lattice_blocked.launches += 1
    return out


backward_lattice_blocked.launches = 0
