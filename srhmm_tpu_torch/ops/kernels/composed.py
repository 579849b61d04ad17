"""Composed-lattice E-step kernels of embedded and tied training.

Counterpart of ``srhmm_tpu/ops/pallas/composed_pallas.py``.  Every
utterance b composes its transcript's L units of S states into one
left-to-right chain of LS = L*S rows; row j emits from bank row ids[b, j]
(unit*S + state for embedded training, the senone id for tied training) and
the transitions are per utterance, band+1 diagonals of the (LS, LS) chain.

Four functions, each a hand-written CUDA kernel (``csrc/composed.cu``) on
CUDA float32 tensors and its plain PyTorch twin (``*_plain``) on CPU
tensors; nothing falls back from one to the other:

* ``bank_emission`` (TPU kernel #9): ids (B, LS), per-stream mixture
  record banks (NB, M_p, stride_p), features (B, T, D) shared by the
  streams -> log_b (T, LS, B);
* ``composed_forward`` (#10): log_b, column-form diagonals (band+1, LS, B)
  (diag[d][j, b] = log a_b[j-d, j]), lengths -> log-alpha (T, LS, B);
* ``composed_backward_stats`` (#11): + log-alpha, row-form diagonals
  (diag[d][i, b] = log a_b[i, i+d]), safe_z, vmask -> (gamma (T, LS, B),
  xi (band+1, LS, B), den_trans (LS, B), den_mix (LS, B));
* ``bank_moments_lattice`` (#12, gamma (T, LS, B)) and ``bank_moments``
  (#13, gamma (B, LS, T)): one kernel with the gamma strides as arguments
  -> per stream (NB, M_p, Cm) moment rows [sum g x | sum g x^2 or
  sum g vec(x x^T) | sum g] already summed into bank rows, Cm = 2D+1
  diagonal or D+D^2+1 full.

Each wrapper counts its launches in ``.launches``.  The records are
``csrc/emission.cuh``'s (train/embedded.py pack_position_bank_diag /
_full lays them out); the features are raw (no shifted origin), as in the
JAX kernels.  Deliberate differences from the TPU kernels: no padding of
mixtures to multiples of 8, of LS to multiples of 8, of B or of T; the
moments' bank-row sums are taken in a fixed order (the stable sort of the
ids), not by a read-modify-write per grid step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models.gmm_hmm import DIAG, FULL
from .common import (
    _TINY,
    DMAX_BOUNDS,
    LOG_GAUS_CLAMP,
    NEG_INF,
    SMEM_LIMIT,
    WIDE_FRAMES,
    WIDE_GROUP,
    WIDE_SLICE,
    WIDE_THREADS,
    check_launch,
    device_args,
    dmax_for,
    on_cpu,
    require_float32,
    sm_count,
    wide_emission_bytes,
    wide_lift_rows,
)
from .fused_em import _lse_terms, _shift_down, _shift_up

MAX_STREAMS = 6
MAX_BAND = 15  # csrc/composed.cu kMaxBand: diagonals - 1 of the composed chain
TILE = 32  # csrc/composed.cu kTile: frames of a moments tile
SCAN = 4  # csrc/composed.cu kScan: candidate tiles a warp checks a scan step
PAIRS_PER_CHUNK = 16  # csrc/composed.cu kChunk: (utterance, row) pairs a moments block
MOMENTS_SLOTS = (4, 2, 1)  # tiles a moments batch = warps a block, largest that fits first
# where a moments block keeps (records, accumulators), the first that fits:
# shared memory, then the accumulators in the chunk's partial row, then the
# records read from device memory, then both (hundreds of mixtures a row)
MOMENTS_PLACES = ((False, False), (False, True), (True, False), (True, True))
EMISSION_RING = (3, 2, 1, 0)  # record buffers of a bank-emission block, deepest that fits first (0: device memory)
# full covariance past D = 16: the z-GEMM blocks (common.WIDE_*)
WIDE_TILES = WIDE_FRAMES // TILE  # moments tiles a batch
_WIDE_QCAP = SCAN * (WIDE_THREADS // 32) + WIDE_TILES  # queued tiles a moments block holds
_FULL_REGISTER_BOUNDS = (4, 8, 12, 16, 24, 32, 40, 48, 64)  # csrc/composed.cu register_bound, full covariance
_MAX_LATTICE_THREADS = 1024
ROWS_PER_LANE = (1, 2, 4)  # composed rows a lattice lane holds (csrc/composed.cu instantiations)
FORWARD_TILES = (32, 16, 8, 4, 2, 1)  # frames a forward tile stages, largest that fits first
BACKWARD_TILES = (16, 8, 4, 2, 1)  # frames a backward-stats tile stages, largest that fits first
# recursion warps a block: csrc/composed.cu kForwardThreads / 64 and kBackwardThreads / 64
_LATTICE_WARPS = 8
_MAX_GRID_Y = 65535
_ELEMS_PER_CHUNK = 1 << 24  # per-mixture elements the twins hold at once


def record_stride(D: int, full: bool) -> int:
    """Floats per mixture record (csrc/emission.cuh record_stride) for
    feature dim D at the compiled bound dmax_for(D)."""
    dmax = dmax_for([D], "record_stride")
    return D * dmax + dmax + 4 if full else 2 * dmax + 4


def _dmax_of(stride: int, D: int, full: bool) -> int:
    dmax = (stride - 4) // (D + 1) if full else (stride - 4) // 2
    if record_stride(D, full) != stride:
        raise ValueError(f"composed: records of {stride} floats do not fit D={D} ({'full' if full else 'diag'})")
    return dmax


def moment_cols(D: int, full: bool) -> int:
    return D + D * D + 1 if full else 2 * D + 1


def register_bound(D: int) -> int:
    """csrc/composed.cu register_bound at full covariance: the smallest
    compiled bound of the bank kernels >= D rounded up to 4 (0 where none
    is)."""
    return next((rb for rb in _FULL_REGISTER_BOUNDS if rb >= 4 * -(-D // 4)), 0)


def wide_full(D: int, full: bool) -> bool:
    """Whether the bank kernels take the z-GEMM blocks: full covariance
    past D = 16 (register bound 24 to 64)."""
    return full and register_bound(D) > 16


def wide_smem_bytes(D: int, which: int) -> int:
    """csrc/composed.cu wide_emission_floats (which = 0) and
    wide_moments_floats / wide_moments_ints (1): the features of a
    z-GEMM tile (rows of RB + 4 floats), two record slices of WIDE_SLICE
    mixtures (rows of L^T at that pitch, c, bias and log w) and their q;
    the moments add the n tile's weights, the tile queue, the lift table
    and the chunk's pairs.  It does not grow with the mixtures."""
    rb = register_bound(D)
    if which == 0:
        return wide_emission_bytes(rb)
    floats = WIDE_GROUP * (WIDE_FRAMES + 4) + _WIDE_QCAP * TILE
    ints = 16 * -(-wide_lift_rows(D) // 16) + 2 * _WIDE_QCAP + 2 * (WIDE_THREADS // 32) + 4 * PAIRS_PER_CHUNK + 1
    return wide_emission_bytes(rb) + 4 * floats + 4 * ints


def _moments_bytes(mixes, strides, D: int, full: bool, slots: int, rec_global: bool = False,
                   acc_global: bool = False) -> int:
    """csrc/composed.cu moments_floats / moments_ints: one moments block of
    the widest stream (a block takes one stream) at `slots` tiles a batch,
    the records (rec_global) or the accumulators (acc_global) kept out of
    shared memory; past full D = 16 the z-GEMM block's (wide_smem_bytes)."""
    if wide_full(D, full):
        return wide_smem_bytes(D, 1)
    Cm = moment_cols(D, full)
    ks = TILE * slots + 4
    qcap = (SCAN + 1) * slots
    floats = max((0 if rec_global else M * st) + (M + D) * ks + (0 if acc_global else M * Cm)
                 for M, st in zip(mixes, strides)) + qcap * TILE
    return 4 * floats + 4 * (2 * qcap + 2 * slots + 4 * PAIRS_PER_CHUNK + 1)


def moments_shape(mixes, D: int, full: bool, strides=None) -> tuple[int, bool, bool]:
    """(slots, rec_global, acc_global) of a moments block: the first of
    MOMENTS_PLACES at which one of MOMENTS_SLOTS fits SMEM_LIMIT, the
    largest such slots; else the last try (and the launch refuses).  Past
    full D = 16 the z-GEMM block: WIDE_TILES tiles a batch, records and
    accumulators neither in device memory."""
    if wide_full(D, full):
        return WIDE_TILES, False, False
    strides = strides or [record_stride(D, full)] * len(mixes)
    for rec_global, acc_global in MOMENTS_PLACES:
        for slots in MOMENTS_SLOTS:
            if _moments_bytes(mixes, strides, D, full, slots, rec_global, acc_global) <= SMEM_LIMIT:
                return slots, rec_global, acc_global
    return MOMENTS_SLOTS[-1], True, True


def moments_slots(mixes, D: int, full: bool) -> int:
    """Tiles a moments batch (warps a block): moments_shape's."""
    return moments_shape(mixes, D, full)[0]


def moments_smem_bytes(mixes, D: int, full: bool) -> int:
    """Dynamic shared memory of one moments block (csrc/composed.cu
    bank_moments_kernel) at moments_shape: one bank row's records of the
    widest stream (unless in device memory), its posterior weights and the
    features of a batch of tiles, its accumulators (unless in the partial
    rows), the tile queue and the chunk's pairs."""
    strides = [record_stride(D, full)] * len(mixes)
    return _moments_bytes(mixes, strides, D, full, *moments_shape(mixes, D, full))


def emission_ring(mixes, strides) -> int:
    """Record buffers of a bank-emission block below full D = 16: the
    deepest of EMISSION_RING whose ring (that many bank rows' records of
    every stream) fits SMEM_LIMIT; 0 (the records read from device memory)
    where one row's do not."""
    row = 4 * sum(m * s for m, s in zip(mixes, strides))
    return next(nbuf for nbuf in EMISSION_RING if nbuf * row <= SMEM_LIMIT)


def fused_eligible(feats, cov_types, dims, mixes, S: int, LS: int, B: int) -> bool:
    """Whether a batch rides the composed kernels, from facts known before
    any launch: CUDA float32 features; one homogeneous diagonal or full
    covariance type over 1 to MAX_STREAMS streams that share the feature
    dim; D within the compiled bound of 64 (diagonal or full); the chain's
    band (max(S-1, 1)) within MAX_BAND; LS rows within one lattice block;
    B within the grid; the moments block within the shared-memory budget
    (the emission takes any bank row: its records stay in device memory
    where they do not fit; past full D = 16 both z-GEMM blocks fit at any
    number of mixtures, their records streamed in slices).
    Left-right transitions are the caller's check."""
    if feats.device.type != "cuda" or feats.dtype != torch.float32:
        return False
    if len(set(cov_types)) != 1 or cov_types[0] not in (DIAG, FULL):
        return False
    full = cov_types[0] == FULL
    D = feats.shape[-1]
    if not 1 <= len(dims) <= MAX_STREAMS or any(d != D for d in dims) or D > DMAX_BOUNDS[-1]:
        return False
    if max(S - 1, 1) > MAX_BAND or LS > _MAX_LATTICE_THREADS or B > _MAX_GRID_Y:
        return False
    return moments_smem_bytes(mixes, D, full) <= SMEM_LIMIT


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = sum of values[r] over the rows r with ids[r] == i, (n, ...).

    A one-hot contraction: the same sum order on every run on a card
    (``index_add_`` / ``scatter_add_`` on CUDA floats use atomics, whose
    order changes from run to run), and exact zeros for the rows not
    selected.  values (R, ...), ids (R,) in [0, n)."""
    R = values.shape[0]
    onehot = (ids.reshape(1, R).long() == torch.arange(n, device=ids.device)[:, None]).to(values.dtype)
    return (onehot @ values.reshape(R, -1)).reshape((n,) + values.shape[1:])


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _stream_q(x, rec, D: int, full: bool):
    """Per-mixture weighted log-likelihoods (b, T, LS, M) of raw features
    x (b, T, D) against gathered records rec (b, LS, M, stride)."""
    dmax = _dmax_of(rec.shape[-1], D, full)
    if full:
        b, LS, M, _ = rec.shape
        lt = rec[..., : D * dmax].reshape(b, LS, M, D, dmax)[..., :D]  # rows d of L^T
        bg = rec[..., D * dmax :]  # [-L^T mu (dmax) | bias | log w | 0 | 0]
        z = torch.einsum("bte,bjmde->btjmd", x, lt) + bg[:, None, ..., :D]
        quad = (z * z).sum(-1)
        q = torch.clamp(-0.5 * quad + bg[:, None, ..., dmax], max=LOG_GAUS_CLAMP)
        return q + bg[:, None, ..., dmax + 1]
    lin, quad = rec[..., :D], rec[..., dmax : dmax + D]
    q = torch.einsum("btd,bjmd->btjm", x, lin) + torch.einsum("btd,bjmd->btjm", x * x, quad)
    return q + rec[:, None, ..., 2 * dmax] + rec[:, None, ..., 2 * dmax + 1]


def _lse_mix(q):
    """Mixture logsumexp over the last axis, max seeded at NEG_INF."""
    m = torch.clamp(q.amax(-1), min=NEG_INF)
    e = torch.exp(q - m[..., None]).sum(-1)
    return torch.log(torch.clamp(e, min=_TINY)) + m


def _utt_chunks(B: int, per_utt: int):
    """Utterance ranges whose per-mixture tensors stay under the budget."""
    step = max(1, _ELEMS_PER_CHUNK // max(per_utt, 1))
    return [(b0, min(B, b0 + step)) for b0 in range(0, B, step)]


def _check_streams(banks, feats, full):
    D = feats.shape[-1]
    NB = banks[0].shape[0]
    if not 1 <= len(banks) <= MAX_STREAMS:
        raise ValueError(f"composed: 1 to {MAX_STREAMS} streams")
    for bk in banks:
        if bk.dim() != 3 or bk.shape[0] != NB:
            raise ValueError("composed: every bank is (NB, M_p, stride_p) with one NB")
        _dmax_of(bk.shape[-1], D, full)
    return D, NB


def bank_emission_plain(ids, bank, feats, full: bool = False):
    """The bank_emission kernel's function in eager PyTorch: log_b
    (T, LS, B) float32 = max(sum over streams of the mixture logsumexp of
    the records of bank row ids[b, j] at frame t, NEG_INF)."""
    banks = _as_tuple(bank)
    D, _ = _check_streams(banks, feats, full)
    B, LS = ids.shape
    T = feats.shape[1]
    x_all = feats.to(torch.float32)
    out = torch.empty((B, T, LS), dtype=torch.float32, device=feats.device)
    per_utt = T * LS * max(bk.shape[1] for bk in banks) * (D if full else 1)
    for b0, b1 in _utt_chunks(B, per_utt):
        lb = None
        for bk in banks:
            rec = bk.to(torch.float32)[ids[b0:b1].long()]  # (b, LS, M, stride)
            v = _lse_mix(_stream_q(x_all[b0:b1], rec, D, full))
            lb = v if lb is None else lb + v
        out[b0:b1] = torch.clamp(lb, min=NEG_INF)
    return out.permute(1, 2, 0).contiguous()


def composed_forward_plain(log_b, diag_col, lengths):
    """The composed_forward kernel's function in eager PyTorch: log-alpha
    (T, LS, B), rows at t >= length repeating the last valid row."""
    T, LS, B = log_b.shape
    dev = log_b.device
    lens = lengths.to(dev)
    start = torch.where(torch.arange(LS, device=dev) == 0, 0.0, NEG_INF)[:, None]
    la = torch.empty_like(log_b)
    carry = torch.clamp(start + log_b[0], min=NEG_INF)  # frame 0 always initializes
    la[0] = carry
    for t in range(1, T):
        upd = _lse_terms([_shift_down(carry, d) + diag_col[d] for d in range(diag_col.shape[0])])
        new = torch.clamp(upd + log_b[t], min=NEG_INF)
        carry = torch.where(lens > t, new, carry)
        la[t] = carry
    return la


def composed_backward_stats_plain(log_b, log_alpha, diag_row, lengths, safe_z, vmask):
    """The composed_backward_stats kernel's function in eager PyTorch:
    (gamma (T, LS, B), xi (band+1, LS, B), den_trans (LS, B), den_mix
    (LS, B)); xi[d][i] = sum_t xi_t(i -> i+d) over t < length-1, gamma
    masked by t < length and vmask, log-beta initialized at the final row
    LS-1."""
    T, LS, B = log_b.shape
    nd = diag_row.shape[0]
    dev = log_b.device
    f32 = dict(dtype=torch.float32, device=dev)
    lens = lengths.to(dev)[None, :]
    z = safe_z.to(dev, torch.float32)[None, :]
    vm = vmask.to(dev, torch.float32)[None, :] > 0.0
    init = torch.where(torch.arange(LS, device=dev) == LS - 1, 0.0, NEG_INF)[:, None].expand(LS, B)
    beta = init
    xi = [torch.zeros((LS, B), **f32) for _ in range(nd)]
    den_trans = torch.zeros((LS, B), **f32)
    den_mix = torch.zeros((LS, B), **f32)
    gamma = torch.empty((T, LS, B), **f32)
    for t in range(T - 1, -1, -1):
        la_t = log_alpha[t]
        lbn = log_b[t + 1] if t + 1 < T else torch.full((LS, B), NEG_INF, **f32)
        inner = torch.clamp(lbn + beta, min=NEG_INF)
        stepping = lens - 1 > t
        m_xi = stepping & vm
        ups = [_shift_up(inner, d) for d in range(nd)]
        for d in range(nd):
            term = la_t + diag_row[d] + ups[d] - z
            xi[d] = xi[d] + torch.where(m_xi, torch.exp(torch.clamp(term, max=0.0)), 0.0)
        upd = _lse_terms([ups[d] + diag_row[d] for d in range(nd)])
        beta = torch.where(stepping, upd, init)
        m_g = (lens > t) & vm
        g = torch.where(m_g, torch.exp(torch.clamp(la_t + beta - z, max=0.0)), 0.0)
        gamma[t] = g
        den_mix = den_mix + g
        den_trans = den_trans + torch.where(m_xi, g, 0.0)
    return gamma, torch.stack(xi), den_trans, den_mix


def _moment_lift(x, full: bool):
    """[x; x^2; 1] (diagonal) or [x; vec(x x^T); 1] (full, block d holds
    x * x[d]) along the last axis."""
    ones = torch.ones_like(x[..., :1])
    if not full:
        return torch.cat([x, x * x, ones], dim=-1)
    D = x.shape[-1]
    return torch.cat([x] + [x * x[..., d : d + 1] for d in range(D)] + [ones], dim=-1)


def _bank_moments_plain(ids, banks, feats, gamma_btj, lengths, full: bool):
    """Per stream (NB, M_p, Cm) from gamma viewed as (B, T, LS)."""
    D, NB = _check_streams(banks, feats, full)
    B, LS = ids.shape
    T = feats.shape[1]
    dev = feats.device
    x_all = feats.to(torch.float32)
    on = (torch.arange(T, device=dev)[None, :] < lengths.to(dev)[:, None])  # (B, T)
    flat_ids = ids.reshape(-1)
    out = []
    for bk in banks:
        M = bk.shape[1]
        Cm = moment_cols(D, full)
        mom_pos = torch.empty((B, LS, M, Cm), dtype=torch.float32, device=dev)
        for b0, b1 in _utt_chunks(B, T * LS * M * (D if full else 1)):
            x = x_all[b0:b1]
            q = _stream_q(x, bk.to(torch.float32)[ids[b0:b1].long()], D, full)  # (b, T, LS, M)
            lb = _lse_mix(q)[..., None]
            post = torch.where(lb > NEG_INF / 2, torch.exp(torch.clamp(q - lb, max=0.0)), 0.0)
            g = torch.where(on[b0:b1, :, None], gamma_btj[b0:b1].to(torch.float32), 0.0)
            gm = g[..., None] * post
            mom_pos[b0:b1] = torch.einsum("btjm,btc->bjmc", gm, _moment_lift(x, full))
        out.append(segment_sum(mom_pos.reshape(B * LS, M, Cm), flat_ids, NB))
    return tuple(out)


def bank_moments_lattice_plain(ids, bank, feats, gamma_tsb, lengths, full: bool = False):
    """The bank_moments kernel's function with gamma in the lattice layout
    (T, LS, B): per stream (NB, M_p, Cm) bank-row moments (a tuple for a
    tuple of banks, else one tensor)."""
    out = _bank_moments_plain(ids, _as_tuple(bank), feats, gamma_tsb.permute(2, 0, 1), lengths, full)
    return out if isinstance(bank, (tuple, list)) else out[0]


def bank_moments_plain(ids, bank, feats, gamma_bst, lengths, full: bool = False):
    """The same function with gamma in the (B, LS, T) layout."""
    out = _bank_moments_plain(ids, _as_tuple(bank), feats, gamma_bst.permute(0, 2, 1), lengths, full)
    return out if isinstance(bank, (tuple, list)) else out[0]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/composed.cu)
# ---------------------------------------------------------------------------


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the composed launchers' C signatures."""
    from .build import load_library

    lib = load_library()
    c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    p_ptr, p_int = ctypes.POINTER(c_ptr), ctypes.POINTER(c_int)
    bank_head = [c_ptr, p_ptr, p_int, p_int, c_int, c_int, c_ptr]  # ids banks mixes strides P NB feats
    lib.srhmm_bank_emission.restype = c_int
    lib.srhmm_bank_emission.argtypes = bank_head + [c_ptr] + [c_int] * 7 + [c_ptr]
    lib.srhmm_composed_forward.restype = c_int
    lib.srhmm_composed_forward.argtypes = [c_ptr] * 4 + [c_int] * 9 + [c_ptr]
    lib.srhmm_composed_backward_stats.restype = c_int
    lib.srhmm_composed_backward_stats.argtypes = [c_ptr] * 10 + [c_int] * 9 + [c_ptr]
    lib.srhmm_bank_moments.restype = c_int
    lib.srhmm_bank_moments.argtypes = (
        bank_head + [c_ptr, c_ll, c_ll, c_ll] + [c_ptr] * 4 + [p_ptr] + [c_int] * 4 + [p_ptr] + [c_int] * 6
        + [c_ptr]
    )
    lib.srhmm_bank_wide_occupancy.restype = c_int
    lib.srhmm_bank_wide_occupancy.argtypes = [c_int, c_int, c_int, p_int]
    return lib


class _BankLaunch:
    """Checked arguments of a bank kernel (emission or moments)."""

    def __init__(self, name, ids, bank, feats, full, lengths=None):
        banks = _as_tuple(bank)
        dev = feats.device
        require_float32(name, dev, [ids, *banks, feats] + ([lengths] if lengths is not None else []),
                 [*banks, feats])
        if feats.dim() != 3 or ids.dim() != 2 or ids.shape[0] != feats.shape[0]:
            raise ValueError(f"{name}: ids (B, LS) and features (B, T, D) disagree on B")
        self.D, self.NB = _check_streams(banks, feats, full)
        self.dmax = dmax_for([self.D], name)
        self.B, self.T, _ = feats.shape
        self.LS = ids.shape[1]
        if self.B > _MAX_GRID_Y:
            raise ValueError(f"{name}: at most {_MAX_GRID_Y} utterances a launch, got {self.B}")
        self.name, self.dev, self.full = name, dev, full
        self.banks = [bk.contiguous() for bk in banks]
        self.ids = ids.to(torch.int32).contiguous()
        self.feats = feats.contiguous()
        self.mixes = [bk.shape[1] for bk in banks]
        self.strides = [bk.shape[2] for bk in banks]

    def head(self):
        P = len(self.banks)
        ints = ctypes.c_int * P
        return [
            self.ids.data_ptr(), (ctypes.c_void_p * P)(*[bk.data_ptr() for bk in self.banks]),
            ints(*self.mixes), ints(*self.strides), P, self.NB, self.feats.data_ptr(),
        ]

    def smem_bytes(self, which: int) -> int:
        """Dynamic shared memory of one block: 0 = emission (its ring of
        emission_ring buffers, or the z-GEMM block), 1 = moments."""
        if which == 0:
            if wide_full(self.D, self.full):
                return wide_smem_bytes(self.D, 0)
            return emission_ring(self.mixes, self.strides) * 4 * sum(m * s for m, s in zip(self.mixes, self.strides))
        return _moments_bytes(self.mixes, self.strides, self.D, self.full, *self.moments_shape())

    def moments_shape(self) -> tuple[int, bool, bool]:
        return moments_shape(self.mixes, self.D, self.full, self.strides)

    def fit(self, which: int) -> None:
        if self.smem_bytes(which) > SMEM_LIMIT:
            raise ValueError(
                f"{self.name}: {self.smem_bytes(which)} bytes of shared memory per block, above "
                f"the {SMEM_LIMIT}-byte budget"
            )


def bank_emission(ids, bank, feats, full: bool = False):
    """Per-utterance bank emission: log_b (T, LS, B) float32 (see
    bank_emission_plain).  bank: one (NB, M, stride) record tensor or a
    tuple of them, one per stream; feats (B, T, D).

    CUDA tensors launch the hand-written kernel (csrc/composed.cu) and count
    one in ``bank_emission.launches``; CPU tensors run bank_emission_plain.
    The ids are not range-checked on the host (that would wait for the
    card): on the card an id outside [0, NB) gives NaN rows.  Full records
    hold the rows of L^T upper triangular, as pack_position_bank_full
    writes them: past D = 16 the kernel skips the products left of the
    diagonal (exact zeros there)."""
    if on_cpu("bank_emission", feats):
        return bank_emission_plain(ids, bank, feats, full)
    ln = _BankLaunch("bank_emission", ids, bank, feats, full)
    ln.fit(0)
    log_b = torch.empty((ln.T, ln.LS, ln.B), dtype=torch.float32, device=ln.dev)
    check_launch(ln.name, _kernel_library().srhmm_bank_emission(
        *ln.head(), log_b.data_ptr(), ln.B, ln.T, ln.D, ln.LS, int(full),
        emission_ring(ln.mixes, ln.strides), *device_args(ln.dev)))
    bank_emission.launches += 1
    return log_b


bank_emission.launches = 0


def _check_lattice(name, log_b, diag, lengths, extra=()):
    T, LS, B = log_b.shape
    nd = diag.shape[0]
    if diag.shape != (nd, LS, B) or lengths.shape != (B,):
        raise ValueError(f"{name}: diagonals (band+1, LS, B) and lengths (B,) must fit log_b (T, LS, B)")
    if not 1 <= nd <= MAX_BAND + 1:
        raise ValueError(f"{name}: 1 to {MAX_BAND + 1} diagonals, got {nd}")
    require_float32(name, log_b.device, [log_b, diag, lengths, *extra], [log_b, diag, *extra])
    return T, LS, B, nd


def composed_forward(log_b, diag_col, lengths):
    """Banded log-forward over per-utterance composed chains: log-alpha
    (T, LS, B) (see composed_forward_plain).

    CUDA tensors launch the hand-written kernel (a warp per utterance, log_b
    staged a tile of frames ahead; forward_block) and count one in
    ``composed_forward.launches``; CPU tensors run composed_forward_plain."""
    if on_cpu("composed_forward", log_b):
        return composed_forward_plain(log_b, diag_col, lengths)
    T, LS, B, nd = _check_lattice("composed_forward", log_b, diag_col, lengths)
    log_b, diag_col = log_b.contiguous(), diag_col.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    la = torch.empty_like(log_b)
    index, stream = device_args(log_b.device)
    blk = forward_block(LS, B, nd, sm_count(index))
    check_launch("composed_forward", _kernel_library().srhmm_composed_forward(
        log_b.data_ptr(), diag_col.data_ptr(), lens.data_ptr(), la.data_ptr(), T, LS, B, nd,
        blk["rows_per_lane"], blk["warps"], blk["utts"], blk["tile"], index, stream))
    composed_forward.launches += 1
    return la


composed_forward.launches = 0


def _lattice_shape(name: str, LS: int, B: int, nd: int, sms: int, tiles, smem_bytes) -> dict:
    """R rows a lane (the fewest of 1, 2, 4 that hold LS in one warp, else
    4), W warps an utterance, U utterances a block (at most _LATTICE_WARPS
    recursion warps a block, halved while fewer than 3/4 of the `sms` SMs
    would get a block), TT frames a staged tile (the largest of `tiles`
    whose block takes at most SMEM_LIMIT bytes, smem_bytes(R, W, U, TT,
    LS))."""
    if LS > _MAX_LATTICE_THREADS:
        raise ValueError(f"{name}: at most {_MAX_LATTICE_THREADS} composed rows, got {LS}")
    if not 1 <= nd <= MAX_BAND + 1:
        raise ValueError(f"{name}: 1 to {MAX_BAND + 1} diagonals, got {nd}")
    R = next((r for r in ROWS_PER_LANE if 32 * r >= LS), ROWS_PER_LANE[-1])
    W = -(-LS // (32 * R))
    U = max(1, _LATTICE_WARPS // W)
    while U > 1 and -(-B // U) < 3 * sms // 4:
        U //= 2
    TT = next((tt for tt in tiles if smem_bytes(R, W, U, tt, LS) <= SMEM_LIMIT), None)
    if TT is None:
        raise ValueError(f"{name}: no tile of LS={LS} rows fits {SMEM_LIMIT} bytes")
    return {"rows_per_lane": R, "warps": W, "utts": U, "tile": TT}


def forward_block(LS: int, B: int, nd: int, sms: int = 132) -> dict:
    """The launch shape of the forward kernel (csrc/composed.cu,
    _lattice_shape): W warps an utterance of each kind (recursion, store),
    U utterances a block (64 W U <= 512 threads), TT the largest of
    FORWARD_TILES that fits."""
    return _lattice_shape("composed_forward", LS, B, nd, sms, FORWARD_TILES,
                          lambda R, W, U, TT, LS: forward_smem_bytes(U, TT, LS))


def forward_smem_bytes(U: int, TT: int, LS: int) -> int:
    """csrc/composed.cu forward_floats: log_b and log-alpha in two slots
    each, (TT, LS, U) with a tile pitch of LS U rounded up to 4."""
    return 4 * 4 * TT * (-(-LS * U // 4) * 4)


def backward_block(LS: int, B: int, nd: int, sms: int = 132) -> dict:
    """The launch shape of the backward-stats kernel (csrc/composed.cu,
    _lattice_shape): W warps an utterance of each kind (recursion,
    statistics), U utterances a block (64 W U <= 512 threads), TT the
    largest of BACKWARD_TILES that fits."""
    return _lattice_shape("composed_backward_stats", LS, B, nd, sms, BACKWARD_TILES, backward_smem_bytes)


def backward_smem_bytes(R: int, W: int, U: int, TT: int, LS: int) -> int:
    """csrc/composed.cu backward_floats: log-alpha in three slots and log_b
    in two, (TT, LS, U) with a tile pitch of LS U rounded up to 4; the inner
    terms and log-beta in two slots each, (TT, U, 32 R W + 4)."""
    ap = -(-LS * U // 4) * 4
    return 4 * (5 * TT * ap + 4 * TT * U * (32 * R * W + 4))


def composed_backward_stats(log_b, log_alpha, diag_row, lengths, safe_z, vmask):
    """Banded log-backward + lattice statistics: (gamma (T, LS, B), xi
    (band+1, LS, B), den_trans (LS, B), den_mix (LS, B)) (see
    composed_backward_stats_plain).  The per-utterance sums are taken by one
    lane each, in time order: two runs are bitwise equal.

    CUDA tensors launch the hand-written kernel (a warp per utterance, the
    lattices staged a tile of frames ahead; backward_block) and count one in
    ``composed_backward_stats.launches``; CPU tensors run the twin."""
    if on_cpu("composed_backward_stats", log_b):
        return composed_backward_stats_plain(log_b, log_alpha, diag_row, lengths, safe_z, vmask)
    name = "composed_backward_stats"
    T, LS, B, nd = _check_lattice(name, log_b, diag_row, lengths, (log_alpha, safe_z, vmask))
    if log_alpha.shape != log_b.shape or safe_z.shape != (B,) or vmask.shape != (B,):
        raise ValueError(f"{name}: log_alpha (T, LS, B), safe_z and vmask (B,) must fit log_b")
    # kept alive in locals until the launch is queued
    log_b, log_alpha, diag_row = log_b.contiguous(), log_alpha.contiguous(), diag_row.contiguous()
    safe_z, vmask = safe_z.contiguous(), vmask.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=log_b.device)
    gamma = torch.empty((T, LS, B), **f32)
    xi = torch.empty((nd, LS, B), **f32)
    den_trans = torch.empty((LS, B), **f32)
    den_mix = torch.empty((LS, B), **f32)
    index, stream = device_args(log_b.device)
    blk = backward_block(LS, B, nd, sm_count(index))
    check_launch(name, _kernel_library().srhmm_composed_backward_stats(
        log_b.data_ptr(), log_alpha.data_ptr(), diag_row.data_ptr(), lens.data_ptr(),
        safe_z.data_ptr(), vmask.data_ptr(), gamma.data_ptr(), xi.data_ptr(),
        den_trans.data_ptr(), den_mix.data_ptr(), T, LS, B, nd,
        blk["rows_per_lane"], blk["warps"], blk["utts"], blk["tile"], index, stream))
    composed_backward_stats.launches += 1
    return gamma, xi, den_trans, den_mix


composed_backward_stats.launches = 0


def _bank_moments_cuda(name, ids, bank, feats, gamma, strides_tjb, lengths, full):
    """Both passes of the moments kernel; gamma element (t, j, b) at
    t * st + j * sj + b * sb."""
    ln = _BankLaunch(name, ids, bank, feats, full, lengths)
    require_float32(name, ln.dev, [gamma], [gamma])
    ln.fit(1)
    B, LS, NB = ln.B, ln.LS, ln.NB
    lens = lengths.to(torch.int32).contiguous()
    Cm = moment_cols(ln.D, full)
    f32 = dict(dtype=torch.float32, device=ln.dev)
    # the fixed summation order: a stable sort of the flattened ids, cut
    # on the card into chunks of at most PAIRS_PER_CHUNK pairs of one bank
    # row (pass 0: the chunk table, in `table`)
    sorted_ids, order = torch.sort(ln.ids.reshape(-1), stable=True)
    table = torch.empty(2 * (NB + 1), dtype=torch.int32, device=ln.dev)
    # at most ceil(pairs / chunk) full chunks plus one partial chunk a row
    n_chunks = -(-B * LS // PAIRS_PER_CHUNK) + min(NB, B * LS)
    partial = [torch.empty((n_chunks, M * Cm), **f32) for M in ln.mixes]
    mom = [torch.empty((NB, M, Cm), **f32) for M in ln.mixes]
    P = len(ln.banks)
    ptrs = ctypes.c_void_p * P
    st, sj, sb = strides_tjb
    check_launch(name, _kernel_library().srhmm_bank_moments(
        *ln.head(), gamma.data_ptr(), st, sj, sb, lens.data_ptr(), sorted_ids.data_ptr(), order.data_ptr(),
        table.data_ptr(), ptrs(*[t.data_ptr() for t in partial]), n_chunks, *map(int, ln.moments_shape()),
        ptrs(*[t.data_ptr() for t in mom]), B, ln.T, ln.D, LS, int(full), *device_args(ln.dev)))
    return tuple(mom) if isinstance(bank, (tuple, list)) else mom[0]


def bank_moments_lattice(ids, bank, feats, gamma_tsb, lengths, full: bool = False):
    """Gamma-weighted mixture moments summed into bank rows, gamma in the
    backward kernel's (T, LS, B) layout: per stream (NB, M_p, Cm) (see
    bank_moments_lattice_plain).  Frames t >= lengths[b] are skipped (their
    gamma is 0).

    CUDA tensors launch the hand-written kernel's two passes (one partial row
    per chunk of the (utterance, row) pairs of a bank row, taken in the
    stable order of the ids, tiles of 32 frames whose gamma are all 0.0
    skipped; then each bank row's partials summed in chunk order: no
    atomics, two runs bitwise equal) and count one in
    ``bank_moments_lattice.launches``; CPU tensors run the twin.  Full
    records as bank_emission takes them (L^T upper triangular)."""
    if on_cpu("bank_moments_lattice", feats):
        return bank_moments_lattice_plain(ids, bank, feats, gamma_tsb, lengths, full)
    T, LS, B = gamma_tsb.shape
    if (B, T) != tuple(feats.shape[:2]) or LS != ids.shape[1]:
        raise ValueError("bank_moments_lattice: gamma must be (T, LS, B)")
    gamma_tsb = gamma_tsb.contiguous()
    out = _bank_moments_cuda("bank_moments_lattice", ids, bank, feats, gamma_tsb, (LS * B, B, 1),
                             lengths, full)
    bank_moments_lattice.launches += 1
    return out


bank_moments_lattice.launches = 0


def bank_moments(ids, bank, feats, gamma_bst, lengths, full: bool = False):
    """bank_moments_lattice with gamma in the (B, LS, T) layout.

    CUDA tensors launch the same kernel with transposed gamma strides and
    count one in ``bank_moments.launches``; CPU tensors run
    bank_moments_plain."""
    if on_cpu("bank_moments", feats):
        return bank_moments_plain(ids, bank, feats, gamma_bst, lengths, full)
    B, LS, T = gamma_bst.shape
    if (B, T) != tuple(feats.shape[:2]) or LS != ids.shape[1]:
        raise ValueError("bank_moments: gamma must be (B, LS, T)")
    gamma_bst = gamma_bst.contiguous()
    out = _bank_moments_cuda("bank_moments", ids, bank, feats, gamma_bst, (1, T, LS * T), lengths, full)
    bank_moments.launches += 1
    return out


bank_moments.launches = 0


def wide_occupancy(D: int, device=None) -> dict:
    """Blocks an SM of the two z-GEMM bank kernels at full covariance and
    feature dim D past 16 on the card, at their launch shapes
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor): {"bank_emission": n,
    "bank_moments": n}."""
    if not wide_full(D, True):
        raise ValueError(f"wide_occupancy: the z-GEMM blocks take D = 17 to 64, got {D}")
    index, _ = device_args(torch.device("cuda") if device is None else torch.device(device))
    out = {}
    for which, name in ((0, "bank_emission"), (1, "bank_moments")):
        n = ctypes.c_int(0)
        check_launch("wide_occupancy", _kernel_library().srhmm_bank_wide_occupancy(which, D, index, ctypes.byref(n)))
        out[name] = n.value
    return out


def launch_counts() -> dict:
    """The launch counts of the composed wrappers, by name."""
    return {f.__name__: f.launches for f in _WRAPPERS}


def set_launch_counts(counts: dict) -> None:
    for f in _WRAPPERS:
        f.launches = counts[f.__name__]


_WRAPPERS = (bank_emission, composed_forward, composed_backward_stats, bank_moments_lattice, bank_moments)
