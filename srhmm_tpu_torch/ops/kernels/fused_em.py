"""Baum-Welch E-step kernels: emit-forward (K1) and backward-stats (K2).

Counterpart of ``srhmm_tpu/ops/pallas/fused_em_pallas.py``.  Three layers:

* ``pack_lane_constants`` — one stream's per-mixture GEMM constants,
  packed in float64 torch ops on the model's device and only then cast (it
  runs inside every EM iteration, so it never leaves the device).  The
  layouts are the JAX package's.
* ``emit_forward`` / ``backward_stats`` — on CUDA tensors they launch the
  hand-written kernels of ``csrc/fused_em.cu`` and count one in their
  ``.launches``; on CPU tensors they run ``emit_forward_plain`` /
  ``backward_stats_plain``, the same functions in eager PyTorch.  Nothing
  falls back from one to the other.
* ``fits`` — the static rule of which E-steps the kernels take (streams,
  states, band, feature dims up to the compiled bound of 64, diagonal or
  full covariance, a backward-stats block within shared memory): every
  refusal of the two wrappers', so ``train.em`` routes any other model to
  the plain E-step before a launch.  Full covariance past D = 16
  (``wide_full``) takes the z-GEMM blocks of csrc/wide_gemm.cuh: each
  wrapper launches two kernels, emit-forward the emission into log_b then
  the recursion, backward-stats the recursion into a gamma scratch then
  the moments over ranges of utterances (``moment_ranges``), one partial
  row a range.
* the shapes, in the JAX layouts: features (T, D_p, B) per stream;
  ``log_b`` and ``log_alpha`` (T, S, B); xi (nslots, S, B) per utterance
  with nslots = band+1 (slot d holds xi[j-d -> j] at j) for a banded
  left-right model or S (slot i holds xi[i -> j]) for dense transitions
  (``band=None``); ``den_trans`` / ``den_mix`` (S, B); moments (M_p*S,
  L_p+1) per stream, rows m*S + s, columns [y | y^2 or vec(y y^T) | 1]
  about the stream's shifted origin.

Every function takes P >= 1 streams as sequences: ``feats``, ``packed``
(the 4-tuples of ``pack_lane_constants``) and ``origins`` hold one entry
per stream, so the single-stream call is P = 1.

Deliberate difference from the TPU kernels: for dense transitions the TPU
K2 accumulated xi through a U/V factorization with v capped at exp(30),
which loses xi mass when a frame's forward range exceeds ~30 nats; here
dense xi is exact, per (source, destination) pair, like the banded case.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...models.gmm_hmm import FULL, GmmStream
from .common import (
    _TINY,
    DMAX_BOUNDS,
    LOG_GAUS_CLAMP,
    NEG_INF,
    SMEM_LIMIT,
    WIDE_FRAMES,
    WIDE_GROUP,
    WIDE_THREADS,
    dmax_for,
    mixture_records,
    wide_emission_bytes,
    wide_lift_rows,
)

MAX_STREAMS = 6
MAX_STATES = 256  # csrc/fused_em.cu kMaxStates
EMIT_THREADS = 672  # csrc/fused_em.cu kEmitThreads: an emit-forward block's recursion, emission and memory warps
EMIT_REC_WARPS = 8  # recursion warps an emit-forward block at most
EMIT_MEMORY_WARPS = 2  # an emit-forward block's warps staging the features and writing log-alpha out
EMIT_UTTS = (16, 8, 4, 2, 1)  # utterances an emit-forward block, the largest that fits first
EMIT_TILES = (32, 16, 8, 4, 2, 1)  # frames an emit-forward tile, the largest that fits first
EMIT_SLOTS = (2, 4, 8)  # transition slots the emit-forward recursion unrolls (0: the generic loop)
EMIT_BUSY = 0.75  # share of the SMs an emit-forward grid fills where B allows
BACKWARD_TILES = (16, 8, 4, 2, 1)  # frames a backward-stats tile stages, largest that fits first
BACKWARD_UTTS = 16  # utterances a backward-stats block at most
BACKWARD_THREADS = 512  # csrc/fused_em.cu kMaxBackwardThreads: recursion threads + statistics warps
XI_REGS = 8  # csrc/fused_em.cu kXiRegs: xi slots a backward-stats thread keeps in registers
# full-covariance bounds DMAX compiled in csrc/fused_em.cu (kernel_for): 40
# keeps D = 39's records and features smaller than the shared bound 64
FULL_DMAX_BOUNDS = (4, 8, 12, 16, 32, 40, 64)
WIDE_STAT_WARPS = 2  # warps of a wide backward-stats block writing gamma out
WIDE_MOMENT_BLOCKS = 4  # moments blocks an SM the ranges aim at (two waves of two resident blocks)
# share of the card's memory a stored per-mixture q may take (stored_q_refusal): the E-step's
# other (T, ., B) buffers (features, lattices, gamma) keep the rest
STORED_Q_SHARE = 0.25
_WIDE_QCAP = WIDE_FRAMES + WIDE_THREADS  # csrc/fused_em.cu kEmQcap: kept columns a moments block queues


def em_dmax(ds, full: bool, name: str) -> int:
    """The compiled bound DMAX of the E-step kernels for feature dims ds:
    common.dmax_for for diagonal covariance, the smallest of
    FULL_DMAX_BOUNDS >= max(ds) for full."""
    if not full or max(ds) > FULL_DMAX_BOUNDS[-1]:
        return dmax_for(ds, name)
    return next(b for b in FULL_DMAX_BOUNDS if b >= max(ds))


def wide_full(ds, full: bool) -> bool:
    """Whether the E-step kernels take the z-GEMM blocks: full covariance
    past D = 16 (the compiled bounds 32, 40 and 64)."""
    return full and max(ds) > 16


def moment_groups(S: int, M: int) -> int:
    """csrc/fused_em.cu em_groups: the z-GEMM moments' row groups of a
    stream of M mixtures, one mma n tile of WIDE_GROUP rows each:
    WIDE_GROUP // M whole states a group for M <= WIDE_GROUP, else
    WIDE_GROUP mixtures of one state."""
    if M <= WIDE_GROUP:
        return -(-S // (WIDE_GROUP // M))
    return S * -(-M // WIDE_GROUP)


def moment_ranges(B: int, groups: int, sms: int) -> int:
    """Ranges of utterances the z-GEMM moments split B into, one partial row
    each: about WIDE_MOMENT_BLOCKS blocks an SM over all groups, ranges of
    equal length but the last, none empty."""
    per = -(-B // max(1, min(B, -(-WIDE_MOMENT_BLOCKS * sms // groups))))
    return -(-B // per)


def stored_q_bytes(T: int, S: int, B: int, ms) -> int:
    """Bytes of the stored per-mixture q of one E-step: (T, M_p S, B)
    float32 per stream."""
    return 4 * T * S * B * sum(ms)


def stored_q_refusal(ds, ms, full: bool, S: int, T: int, B: int, device_bytes: int | None = None) -> str | None:
    """Why emit-forward does not store the per-mixture q for backward-stats
    at these shapes, or None where it does: full covariance past D = 16
    (wide_full) only, and, given the card's memory in bytes, at most
    STORED_Q_SHARE of it (stored_q_bytes)."""
    if not wide_full(ds, full):
        return "a stored q is for full covariance past D = 16 only"
    need = stored_q_bytes(T, S, B, ms)
    if device_bytes is not None and need > STORED_Q_SHARE * device_bytes:
        return f"a stored q of {need} bytes, above {STORED_Q_SHARE} of the card's {device_bytes} bytes"
    return None


def stored_q_buffers(feats, ms, S: int, full: bool):
    """The per-stream (T, M_p S, B) float32 buffers in which emit_forward
    stores the per-mixture q for backward_stats (their q_out / q), or None
    where the moments recompute it: CPU tensors, and where
    stored_q_refusal refuses at the card's total memory.  The total, not
    the free memory: a free-memory query takes milliseconds a call on the
    H100, more than the E-step's kernels (PERF.md section 6)."""
    ds = [f.shape[1] for f in feats]
    if not feats[0].is_cuda or not wide_full(ds, full):
        return None
    T, _, B = feats[0].shape
    dev = feats[0].device
    if stored_q_refusal(ds, ms, full, S, T, B, torch.cuda.get_device_properties(dev).total_memory) is not None:
        return None
    return tuple(torch.empty((T, M * S, B), dtype=torch.float32, device=dev) for M in ms)


def wide_smem_bytes(rb: int, which: int) -> int:
    """csrc/fused_em.cu wide_smem at the bound rb: the emission's
    wide_emission_floats (which = 0); the moments' (1) em_moments_floats,
    that plus the weights of its n tile (WIDE_GROUP, WIDE_FRAMES + 4) and
    the gamma of its states (WIDE_GROUP, WIDE_FRAMES), and em_moments_ints,
    the lift table (16 a m tile at rb), the queue of kept columns and the
    warps' vote counts (2, warps)."""
    if which == 0:
        return wide_emission_bytes(rb)
    floats = WIDE_GROUP * (WIDE_FRAMES + 4) + WIDE_GROUP * WIDE_FRAMES
    ints = 16 * -(-wide_lift_rows(rb) // 16) + _WIDE_QCAP + 2 * (WIDE_THREADS // 32)
    return wide_emission_bytes(rb) + 4 * floats + 4 * ints


def pack_lane_constants(stream: GmmStream, dtype=torch.float32, origin=None):
    """Packed per-mixture GEMM constants of one stream, on its device.

    Returns (a, bias_g, bias, logw).  logw is separate from bias so the
    full-covariance 1e20 density clamp lands between density and weight.

    Diagonal covariance: a (M*S, 2D) m-major rows with
    q[m*S+s] = a @ [y; y^2] + bias + logw; bias_g is a (1, 1) dummy.

    Full covariance: the Cholesky z form, K = L L^T:
    z = G y + bias_g, q = min(-1/2 sum_d z_d^2 + bias, log 1e20) + logw,
    with G (M*S*D, D) holding row d of L^T for (s, m) at row d*M*S + m*S + s
    and bias_g = -L^T mu'.  A mixture whose log|det| is not finite gets zero
    rows and bias NEG_INF; one whose inverse covariance is not positive
    definite (``cholesky_ex`` reports it, or the factor is not finite) gets
    zero rows and bias LOG_GAUS_CLAMP.

    origin: optional (D,) shift o with y = x - o; the moments K2 accumulates
    are then about o.  Everything is computed in float64 and cast at the
    end; no host sync."""
    f64 = torch.float64
    mu = stream.means.to(f64)  # (S, M, D)
    if origin is not None:
        mu = mu - torch.as_tensor(origin, device=mu.device).to(f64)
    k = stream.inv_cov.to(f64)
    w = stream.weights.to(f64)
    log_det = stream.log_abs_det().to(f64)
    S, M, D = mu.shape
    norm = -0.5 * (D * math.log(2.0 * math.pi) + log_det)  # (S, M)
    logw = torch.log(torch.clamp(w, min=1e-300)).T.reshape(M * S, 1)
    if stream.cov_type == FULL:
        chol, info = torch.linalg.cholesky_ex(k, check_errors=False)  # k = L L^T
        zmu = torch.einsum("smed,sme->smd", chol, mu)  # L^T mu' per (s, m)
        det_ok = torch.isfinite(norm)
        # cholesky_ex leaves a partial factor, not NaN, where k is not PD
        ok = (info == 0) & torch.isfinite(chol).all(-1).all(-1) & det_ok
        chol = torch.where(ok[..., None, None], chol, 0.0)
        zmu = torch.where(ok[..., None], zmu, 0.0)
        clamp_or_neg = torch.where(det_ok, LOG_GAUS_CLAMP, NEG_INF).to(f64)
        bias = torch.where(ok, norm, clamp_or_neg)
        a = chol.permute(3, 1, 0, 2).reshape(M * S * D, D)  # G[d*M*S + m*S + s, e] = L[s,m,e,d]
        bias_g = -zmu.permute(2, 1, 0).reshape(M * S * D, 1)
    else:
        a = torch.cat([mu * k, -0.5 * k], dim=-1)  # (S, M, 2D)
        a = a.permute(1, 0, 2).reshape(M * S, 2 * D)  # m-major
        bias = -0.5 * torch.sum(mu * mu * k, dim=-1) + norm
        bias_g = torch.zeros((1, 1), dtype=f64, device=mu.device)
    bias = bias.T.reshape(M * S, 1)
    return (
        a.to(dtype),
        bias_g.to(dtype),
        torch.clamp(bias, min=NEG_INF).to(dtype),
        torch.clamp(logw, min=NEG_INF).to(dtype),
    )


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _stream_shapes(feats, packed):
    """Per-stream feature dims D_p and mixture rows M_p * S, and the
    covariance type, inferred from a's width (2D: diagonal, D: full)."""
    ds, rows, fulls = [], [], []
    for f, (a, _, bias, _) in zip(feats, packed):
        D = f.shape[1]
        a_w = a.shape[1]
        if a_w not in (2 * D, D):
            raise ValueError(f"fused_em: constants of width {a_w} do not fit D={D}")
        ds.append(D)
        fulls.append(a_w == D)
        rows.append(bias.shape[0])
    if len(set(fulls)) != 1:
        raise ValueError("fused_em: homogeneous covariance across streams only")
    return tuple(ds), tuple(rows), fulls[0]


def _lt_log(trans: torch.Tensor) -> torch.Tensor:
    """(S, S) float32 log transitions, NEG_INF where the transition is 0."""
    lt = trans.to(torch.float32)
    return torch.where(lt > 0.0, torch.log(torch.clamp(lt, min=_TINY)), NEG_INF)


def _stream_q(x, a, bias_g, bias, logw, full: bool):
    """Per-mixture weighted log-likelihoods q (M*S, B) of centred features
    x (D, B)."""
    if full:
        D = x.shape[0]
        ms = a.shape[0] // D
        z = torch.matmul(a, x) + bias_g  # (M*S*D, B), d-major
        z2 = z * z
        quad = z2[0:ms]
        for d in range(1, D):
            quad = quad + z2[d * ms : (d + 1) * ms]
        q = torch.clamp(-0.5 * quad + bias, max=LOG_GAUS_CLAMP)
    else:
        q = torch.matmul(a, torch.cat([x, x * x], dim=0)) + bias
    return q + logw


def _log_b_from_q(q, S: int, M: int):
    """(M*S, B) m-major q -> per-state mixture logsumexp (S, B); the max is
    taken per state and seeded at NEG_INF."""
    m_s = q[0:S]
    for m in range(1, M):
        m_s = torch.maximum(m_s, q[m * S : (m + 1) * S])
    m_s = torch.clamp(m_s, min=NEG_INF)
    e = torch.exp(q[0:S] - m_s)
    for m in range(1, M):
        e = e + torch.exp(q[m * S : (m + 1) * S] - m_s)
    return torch.log(torch.clamp(e, min=_TINY)) + m_s


def _lse_terms(terms):
    """Elementwise logsumexp over a list of same-shape tensors, clamped."""
    m = terms[0]
    for t in terms[1:]:
        m = torch.maximum(m, t)
    m = torch.clamp(m, min=NEG_INF)
    e = torch.exp(terms[0] - m)
    for t in terms[1:]:
        e = e + torch.exp(t - m)
    return torch.clamp(torch.log(torch.clamp(e, min=_TINY)) + m, min=NEG_INF)


def _shift_down(x, d: int):
    """y[j] = x[j - d] along dim 0, NEG_INF-filled at the top."""
    if d == 0:
        return x
    return torch.cat([torch.full_like(x[:d], NEG_INF), x[:-d]], dim=0)


def _shift_up(x, d: int):
    """y[j] = x[j + d] along dim 0, NEG_INF-filled at the bottom."""
    if d == 0:
        return x
    return torch.cat([x[d:], torch.full_like(x[:d], NEG_INF)], dim=0)


def _band_columns(lt, band: int):
    """dcol[d][j] = lt[j-d, j] (NEG_INF for j < d), each (S, 1)."""
    S = lt.shape[0]
    j = torch.arange(S, device=lt.device)
    return [
        torch.where(j >= d, lt[torch.clamp(j - d, min=0), j], NEG_INF)[:, None]
        for d in range(band + 1)
    ]


def _band_rows(lt, band: int):
    """drow[d][i] = lt[i, i+d] (NEG_INF for i + d >= S), each (S, 1)."""
    S = lt.shape[0]
    i = torch.arange(S, device=lt.device)
    return [
        torch.where(i + d < S, lt[i, torch.clamp(i + d, max=S - 1)], NEG_INF)[:, None]
        for d in range(band + 1)
    ]


def _frame_q(feats, packed, origins, t: int, full: bool):
    """Per stream: (centred features x (D, B), q (M*S, B)) of frame t."""
    out = []
    for f, pk, o in zip(feats, packed, origins):
        x = f[t].to(torch.float32) - o.to(torch.float32)[:, None]
        out.append((x, _stream_q(x, *pk, full)))
    return out


def emit_forward_plain(feats, packed, origins, trans, lengths, band, q_out=None):
    """The emit-forward kernel's function in eager PyTorch: per-stream
    (T, D_p, B) features + packed constants -> (log_b, log_alpha), both
    (T, S, B) float32, log-alpha rows at t >= length repeating the last
    valid row.  band: the transition band width (trans_band) or None for
    dense transitions.  q_out: None, or per stream a (T, M_p S, B) float32
    tensor that gets every frame's per-mixture q (rows m S + s)."""
    _, _, full = _stream_shapes(feats, packed)
    T, _, B = feats[0].shape
    S = trans.shape[-1]
    dev = feats[0].device
    lt = _lt_log(trans.to(dev))
    lens = lengths.to(dev)
    dcols = _band_columns(lt, band) if band is not None else None
    start = torch.where(torch.arange(S, device=dev) == 0, 0.0, NEG_INF)[:, None]
    log_b = torch.empty((T, S, B), dtype=torch.float32, device=dev)
    la = torch.empty((T, S, B), dtype=torch.float32, device=dev)
    carry = None
    for t in range(T):
        lb = None
        for p, ((_, q), pk) in enumerate(zip(_frame_q(feats, packed, origins, t, full), packed)):
            lb_p = _log_b_from_q(q, S, pk[2].shape[0] // S)
            lb = lb_p if lb is None else lb + lb_p
            if q_out is not None:
                q_out[p][t] = q
        lb = torch.clamp(lb, min=NEG_INF)
        if t == 0:  # frame 0 always initializes the carry, even for zero-length rows
            carry = torch.clamp(start + lb, min=NEG_INF)
        else:
            if band is not None:
                upd = _lse_terms([_shift_down(carry, d) + dcols[d] for d in range(band + 1)])
            else:
                upd = _lse_terms(list(carry[:, None, :] + lt[:, :, None]))
            new = torch.clamp(upd + lb, min=NEG_INF)
            carry = torch.where(lens > t, new, carry)
        log_b[t] = lb
        la[t] = carry
    return log_b, la


def _lift1(x, full: bool):
    """Moment lift with the constant row: [x; x^2; 1] (diagonal) or
    [x; vec(x x^T); 1] (full, block d holds x * x[d])."""
    ones = torch.ones_like(x[:1])
    if not full:
        return torch.cat([x, x * x, ones], dim=0)
    D = x.shape[0]
    return torch.cat([x] + [x * x[d : d + 1] for d in range(D)] + [ones], dim=0)


def backward_stats_plain(feats, log_b, log_alpha, packed, origins, trans, lengths, safe_z, vmask, band):
    """The backward-stats kernel's function in eager PyTorch.

    feats, packed, origins as for emit_forward; log_b / log_alpha (T, S, B)
    from it; safe_z (B,) per-utterance final log-prob (0 where invalid);
    vmask (B,) 1.0 / 0.0 validity.  Returns (xi (nslots, S, B),
    den_trans (S, B), den_mix (S, B), (mom_p (M_p*S, L_p+1), ...))."""
    ds, _, full = _stream_shapes(feats, packed)
    T, _, B = feats[0].shape
    S = trans.shape[-1]
    dev = feats[0].device
    lt = _lt_log(trans.to(dev))
    lens = lengths.to(dev)
    z = safe_z.to(dev, torch.float32)[None, :]
    vm = vmask.to(dev, torch.float32)[None, :] > 0.0
    f32 = dict(dtype=torch.float32, device=dev)
    if band is not None:
        dcols, drows = _band_columns(lt, band), _band_rows(lt, band)
        xi = [torch.zeros((S, B), **f32) for _ in range(band + 1)]
    else:
        xi_dense = torch.zeros((S, S, B), **f32)
    den_trans = torch.zeros((S, B), **f32)
    den_mix = torch.zeros((S, B), **f32)
    moms = [torch.zeros((pk[2].shape[0], (D + D * D if full else 2 * D) + 1), **f32)
            for pk, D in zip(packed, ds)]
    beta_init = torch.where(torch.arange(S, device=dev) == S - 1, 0.0, NEG_INF)[:, None].expand(S, B)
    beta = beta_init  # log-beta at t+1 until this frame's update
    for t in range(T - 1, -1, -1):
        la_t = log_alpha[t]
        lbn = log_b[t + 1] if t + 1 < T else torch.full((S, B), NEG_INF, **f32)
        stepping = (lens - 1 > t)[None, :]  # t < length-1; else the init row
        m_xi = stepping & vm
        inner = torch.clamp(lbn + beta, min=NEG_INF)
        lnz = inner - z
        if band is not None:
            for d in range(band + 1):
                term = _shift_down(la_t, d) + dcols[d] + lnz
                xi[d] = xi[d] + torch.where(m_xi, torch.exp(torch.clamp(term, max=0.0)), 0.0)
            upd = _lse_terms([_shift_up(inner, d) + drows[d] for d in range(band + 1)])
        else:
            term = la_t[:, None, :] + lt[:, :, None] + lnz[None, :, :]  # (from, to, B)
            xi_dense = xi_dense + torch.where(m_xi[None], torch.exp(torch.clamp(term, max=0.0)), 0.0)
            upd = _lse_terms(list((lt[:, :, None] + inner[None, :, :]).permute(1, 0, 2)))
        beta = torch.where(stepping, upd, beta_init)

        m_g = (lens > t)[None, :] & vm
        gamma = torch.where(m_g, torch.exp(torch.clamp(la_t + beta - z, max=0.0)), 0.0)
        den_mix = den_mix + gamma
        den_trans = den_trans + torch.where(m_xi, gamma, 0.0)
        for p, ((x, q), pk) in enumerate(zip(_frame_q(feats, packed, origins, t, full), packed)):
            M = pk[2].shape[0] // S
            lb_p = _log_b_from_q(q, S, M)  # the stream's OWN mixture logsumexp
            gm = []
            for m in range(M):
                post = torch.exp(torch.clamp(q[m * S : (m + 1) * S] - lb_p, max=0.0))
                post = torch.where(lb_p > NEG_INF / 2, post, 0.0)
                gm.append(gamma * post)
            moms[p] = moms[p] + torch.matmul(torch.cat(gm, dim=0), _lift1(x, full).T)
    xi_out = torch.stack(xi) if band is not None else xi_dense
    return xi_out, den_trans, den_mix, tuple(moms)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/fused_em.cu)
# ---------------------------------------------------------------------------


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the launchers' C signatures declared."""
    from .build import load_library

    lib = load_library()
    c_int, c_ptr, p_int = ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    head = [ctypes.POINTER(c_ptr), p_int, p_int, p_int, p_int, c_int,  # feats, dims, mixes, offs, origin_offs, P
            c_ptr, c_int, c_int, c_ptr]  # consts, C, lt_off, lengths
    shape = [c_int] * 7  # T B S band full dmax U
    lib.srhmm_emit_forward.restype = c_int
    # log_b, la, the stored q; the shape; TT, rec_warps, em_warps, consts_global, nsl, device; stream
    lib.srhmm_emit_forward.argtypes = head + [c_ptr, c_ptr, ctypes.POINTER(c_ptr)] + shape + [c_int] * 6 + [c_ptr]
    lib.srhmm_backward_stats.restype = c_int
    # safe_z .. mom, gamma, ranges, the stored q; the shape; TT, stat_warps, acc_global, consts_global, device; stream
    lib.srhmm_backward_stats.argtypes = (head + [c_ptr] * 9 + [c_int, ctypes.POINTER(c_ptr)] + shape + [c_int] * 5
                                         + [c_ptr])
    lib.srhmm_em_occupancy.restype = c_int
    lib.srhmm_em_occupancy.argtypes = [c_int, c_int, c_int, c_int, c_int, p_int]
    return lib


def constant_floats(ds, ms, full: bool, S: int, dmax: int) -> int:
    """Floats of a launch's constant block (_Launch._constants): per stream
    its S M records (csrc/emission.cuh strides at the bound dmax), per
    stream its origin, the (S, S) log transitions, each part padded to 4."""
    r4 = lambda x: -(-x // 4) * 4  # noqa: E731
    stride = lambda D: D * dmax + dmax + 4 if full else 2 * dmax + 4  # noqa: E731
    return sum(r4(S * M * stride(D)) for D, M in zip(ds, ms)) + sum(r4(D) for D in ds) + r4(S * S)


def _launch_refusal(ds, full: bool, S: int, band) -> str | None:
    """The refusals _Launch makes for both kernels: 1 to MAX_STREAMS
    streams, a band inside the model, at most MAX_STATES states, dims
    within the compiled bound of 64 (diagonal or full covariance)."""
    if not 1 <= len(ds) <= MAX_STREAMS:
        return f"1 to {MAX_STREAMS} streams, one pack and origin each"
    if band is not None and not 0 <= band < S:
        return f"band {band} outside [0, {S})"
    if S > MAX_STATES:
        return f"at most {MAX_STATES} states, got {S}"
    if max(ds) > DMAX_BOUNDS[-1]:
        return f"feature dim {max(ds)} exceeds {DMAX_BOUNDS[-1]}"
    return None


def refusal(ds, ms, full: bool, S: int, band) -> str | None:
    """Why the E-step kernels do not take streams of feature dims ds and
    mixtures ms (full or diagonal covariance) over S states with this band
    (None = dense), or None where both do: _Launch's refusals, then a
    backward-stats block of one utterance and one frame past shared memory
    (backward_block's last try).  Emit-forward takes every shape _Launch
    passes (emit_block keeps the constants in device memory when they do
    not fit).  The wrappers raise with this reason, and ``fits`` is its
    negation."""
    why = _launch_refusal(ds, full, S, band)
    if why is not None:
        return why
    nslots = band + 1 if band is not None else S
    dmax = em_dmax(ds, full, "fused E-step")
    least = _backward_least_smem(constant_floats(ds, ms, full, S, dmax), S, ds, ms, nslots, full)
    if least > SMEM_LIMIT:
        return f"{least} bytes of shared memory per block, above the {SMEM_LIMIT}-byte budget"
    return None


def fits(ds, ms, full: bool, S: int, band) -> bool:
    """The static routing rule of the fused E-step: True where emit_forward
    and backward_stats both launch their kernels for float32 tensors of
    these shapes (see ``refusal``)."""
    return refusal(ds, ms, full, S, band) is None


class _Launch:
    """Checked, packed arguments of one kernel launch on CUDA tensors."""

    def __init__(self, name, feats, packed, origins, trans, lengths, band, extra=()):
        dev = feats[0].device
        P = len(feats)
        if not 1 <= P <= MAX_STREAMS or len(packed) != P or len(origins) != P:
            raise ValueError(f"{name}: 1 to {MAX_STREAMS} streams, one pack and origin each")
        tensors = [*feats, *(t for pk in packed for t in pk), *origins, trans, *extra]
        if any(t.device != dev for t in [*tensors, lengths]):
            raise ValueError(f"{name}: every tensor must be on the features' CUDA device")
        if any(t.dtype != torch.float32 for t in tensors):
            raise ValueError(f"{name}: the CUDA kernel takes float32 tensors only")
        ds, mss, full = _stream_shapes(feats, packed)
        T, _, B = feats[0].shape
        S = trans.shape[-1]
        if trans.shape != (S, S) or any(ms % S for ms in mss):
            raise ValueError(f"{name}: constants do not fit {S} states")
        if any(f.shape[0] != T or f.shape[2] != B for f in feats) or lengths.shape != (B,):
            raise ValueError(f"{name}: streams disagree on (T, B)")
        why = _launch_refusal(ds, full, S, band)
        if why is not None:
            raise ValueError(f"{name}: {why}")
        self.ms = tuple(ms // S for ms in mss)
        self.dmax = em_dmax(ds, full, name)
        self.wide = wide_full(ds, full)
        self.name, self.dev, self.ds, self.full = name, dev, ds, full
        self.T, self.B, self.S, self.band = T, B, S, band
        self.nslots = band + 1 if band is not None else S
        self.feats = [f.contiguous() for f in feats]
        self.lengths = lengths.to(torch.int32).contiguous()
        self.consts, self.offs, self.origin_offs, self.lt_off = self._constants(packed, origins, trans)

    def _constants(self, packed, origins, trans):
        """One float32 block: per stream its mixture records
        (csrc/emission.cuh), then per stream its origin, then the (S, S)
        log transitions; every part starts on a 4-float boundary."""
        S, parts, off = self.S, [], 0
        offs, origin_offs = [], []

        def put(x):
            nonlocal off
            x = x.reshape(-1)
            pad = (-x.numel()) % 4
            parts.append(torch.cat([x, x.new_zeros(pad)]) if pad else x)
            start, off = off, off + x.numel() + pad
            return start

        for (a, bg, bi, lw), D, M in zip(packed, self.ds, self.ms):
            if self.full:  # (M*S*D, D) d-major rows -> (M*D, S, D)
                a3 = a.reshape(D, M, S, D).permute(1, 0, 2, 3).reshape(M * D, S, D)
                bg3 = bg.reshape(D, M, S).permute(1, 0, 2).reshape(M * D, S, 1)
            else:
                a3, bg3 = a.reshape(M, S, 2 * D), None
            rec = mixture_records(a3, bg3, bi.reshape(M, S, 1), lw.reshape(M, S, 1),
                                  D, M, 1, S, self.full, self.dmax)
            offs.append(put(rec))
        for o in origins:
            origin_offs.append(put(o.to(torch.float32)))
        lt_off = put(_lt_log(trans))
        return torch.cat(parts).contiguous(), offs, origin_offs, lt_off

    def moment_floats(self) -> int:
        return moment_floats(self.ds, self.ms, self.full)

    def block(self, which: int) -> dict:
        """The launch shape: emit_block's for emit-forward (which=0),
        backward_shape's (U, TT, statistics warps, acc_global,
        consts_global) for backward-stats."""
        if which == 1:
            return backward_shape(self.consts.numel(), self.S, self.ds, self.ms, self.nslots, self.full, self.name)
        return emit_block(self.S, self.B, self.consts.numel(), self.ds, _sm_count(self.dev), self.name, self.wide)

    def ranges(self) -> int:
        """The z-GEMM moments' ranges of utterances (moment_ranges)."""
        groups = sum(moment_groups(self.S, M) for M in self.ms)
        return moment_ranges(self.B, groups, _sm_count(self.dev))

    def head(self):
        P = len(self.feats)
        ints = ctypes.c_int * P
        return [
            (ctypes.c_void_p * P)(*[f.data_ptr() for f in self.feats]),
            ints(*self.ds), ints(*self.ms), ints(*self.offs), ints(*self.origin_offs), P,
            self.consts.data_ptr(), self.consts.numel(), self.lt_off, self.lengths.data_ptr(),
        ]

    def shape(self, U: int):
        return [self.T, self.B, self.S, -1 if self.band is None else self.band, int(self.full), self.dmax, U]

    def where(self):
        dev = self.dev
        return [dev.index if dev.index is not None else torch.cuda.current_device(),
                torch.cuda.current_stream(dev).cuda_stream]

    def stored_q(self, q):
        """The host array of the stored q's device pointers for the
        launchers (None for none), after its checks: full covariance past
        D = 16 (stored_q_refusal), per stream a contiguous (T, M_p S, B)
        float32 tensor on the features' device."""
        if q is None:
            return None
        why = stored_q_refusal(self.ds, self.ms, self.full, self.S, self.T, self.B)
        if why is not None:
            raise ValueError(f"{self.name}: {why}")
        if len(q) != len(self.feats) or any(
                t.shape != (self.T, M * self.S, self.B) or t.dtype != torch.float32 or t.device != self.dev
                or not t.is_contiguous() for t, M in zip(q, self.ms)):
            raise ValueError(f"{self.name}: the stored q must be one contiguous (T, M_p*S, B) float32 tensor "
                             "a stream, on the features' device")
        return (ctypes.c_void_p * len(q))(*[t.data_ptr() for t in q])

    def check(self, err: int):
        if err != 0:
            msg = _kernel_library().srhmm_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err} ({msg})")


def moment_floats(ds, ms, full: bool) -> int:
    """Moment floats of one state over the streams: sum_p M_p (L_p + 1)."""
    return sum(M * ((D + D * D if full else 2 * D) + 1) for D, M in zip(ds, ms))


def backward_smem_bytes(C: int, S: int, ds, ms, nslots: int, full: bool, U: int, TT: int, stat_warps: int,
                        acc_global: bool = False, consts_global: bool = False, wide: bool = False) -> int:
    """csrc/fused_em.cu backward_floats + backward_ints: the dynamic shared
    memory of a backward-stats block of U utterances at TT frames a tile
    with stat_warps statistics warps, for C floats of constants (the
    records, origins and log transitions); acc_global: the moment
    accumulators in the block's row of the partials instead of shared
    memory; consts_global: the constants read from device memory; wide
    (full covariance past D = 16): the recursion's part alone, no features
    staged (the statistics warps write gamma out)."""
    nt, cols = S * U, TT * U
    recursion = ((0 if consts_global else C) + 3 * TT * U * (2 * S + (0 if wide else sum(ds))) + 2 * TT * nt + 2 * nt
                 + max(nslots - XI_REGS, 0) * nt)
    if wide:
        return 4 * recursion
    ks = -(-cols // 8) * 8 + (4 if cols > 8 else 0)
    floats = recursion + (S * max(ms) + max(ds)) * ks + (0 if acc_global else S * moment_floats(ds, ms, full))
    return 4 * floats + 4 * (cols + stat_warps)


def emit_slots(S: int, band) -> int:
    """The transition slots the emit-forward recursion unrolls: the
    smallest of EMIT_SLOTS >= band + 1, or 0 (the generic loop over every
    slot) for a wider band or dense transitions (band None)."""
    if band is None:
        return 0
    return next((n for n in EMIT_SLOTS if n >= band + 1), 0)


def emit_smem_bytes(C: int, S: int, sum_d: int, U: int, TT: int, consts_global: bool = False,
                    wide: bool = False) -> int:
    """csrc/fused_em.cu emit_floats: the constants (C floats, unless read
    from device memory), two slots each of the features (TT, sum_p D_p, U;
    none when wide: full covariance past D = 16 reads log_b), log_b and
    log-alpha (TT, S, U)."""
    return 4 * ((0 if consts_global else C) + 2 * TT * U * ((0 if wide else sum_d) + 2 * S))


def emit_block(S: int, B: int, C: int, ds, sms: int, name: str = "emit_forward", wide: bool = False) -> dict:
    """The emit-forward launch shape on a card of `sms` SMs, for C floats of
    constants and feature dims ds.  Utterances a block U: the largest of
    EMIT_UTTS whose recursion fits EMIT_REC_WARPS warps (32 // S utterances
    a warp for S <= 32, else ceil(S / 32) warps an utterance) and whose grid
    of ceil(B / U) blocks fills EMIT_BUSY of the SMs (1 where B is too small
    for that); the tile the largest of EMIT_TILES that fits SMEM_LIMIT with
    the constants in shared memory, halving U until one does, else the
    constants stay in device memory at that U; EMIT_MEMORY_WARPS memory
    warps and the rest of EMIT_THREADS emission warps.  wide (full
    covariance past D = 16): the recursion's block after the z-GEMM
    emission, no features staged and the log transitions read from device
    memory, so only log_b and log-alpha tiles take shared memory."""
    if S > MAX_STATES:
        raise ValueError(f"{name}: at most {MAX_STATES} states, got {S}")
    W = -(-S // 32)  # warps an utterance's states span
    G = 32 // S if S <= 32 else 0  # utterances a recursion warp holds
    cap = EMIT_REC_WARPS * G if S <= 32 else max(1, EMIT_REC_WARPS // W)
    utts = [U for U in EMIT_UTTS if U <= cap]
    busy = next((U for U in utts if -(-B // U) >= EMIT_BUSY * sms), 1)
    sum_d = sum(ds)
    shape = None if wide else next(((U, TT, False) for U in utts if U <= busy for TT in EMIT_TILES
                                    if emit_smem_bytes(C, S, sum_d, U, TT) <= SMEM_LIMIT), None)
    if shape is None:
        TT = next(tt for tt in EMIT_TILES if emit_smem_bytes(C, S, sum_d, busy, tt, True, wide) <= SMEM_LIMIT)
        shape = (busy, TT, True)
    U, TT, consts_global = shape
    rec = -(-U // G) if S <= 32 else U * W
    return {"utts": U, "tile": TT, "rec_warps": rec, "em_warps": EMIT_THREADS // 32 - rec - EMIT_MEMORY_WARPS,
            "memory_warps": EMIT_MEMORY_WARPS, "warps_per_utt": W, "consts_global": consts_global,
            "threads": EMIT_THREADS, "smem_bytes": emit_smem_bytes(C, S, sum_d, U, TT, consts_global, wide)}


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def backward_block(C: int, S: int, ds, ms, nslots: int, full: bool,
                   name: str = "backward_stats", consts_global: bool = False,
                   wide: bool = False) -> tuple[int, int, int, bool]:
    """(utterances per block U, frames a tile TT, statistics warps,
    acc_global) of the backward-stats kernel: U = min(16, 128 // S) (at
    most four warps of recursion threads), statistics warps filling the
    block to 512 threads, TT the largest of BACKWARD_TILES whose block fits
    SMEM_LIMIT, with the moment accumulators in shared memory or, where
    only that way it fits, in the block's row of the partials; U halves
    until a tile fits.  consts_global: the constants in device memory.
    wide: the recursion alone and WIDE_STAT_WARPS warps writing gamma out."""
    if S > MAX_STATES:
        raise ValueError(f"{name}: at most {MAX_STATES} states, got {S}")
    U = max(1, min(BACKWARD_UTTS, 128 // S))
    while True:
        warps = WIDE_STAT_WARPS if wide else _backward_stat_warps(S, U)
        for TT in BACKWARD_TILES:
            for acc_global in (False,) if wide else (False, True):
                if backward_smem_bytes(C, S, ds, ms, nslots, full, U, TT, warps, acc_global,
                                       consts_global, wide) <= SMEM_LIMIT:
                    return U, TT, warps, acc_global
        if U == 1:
            raise ValueError(
                f"{name}: {_backward_least_smem(C, S, ds, ms, nslots, full)} bytes of shared "
                f"memory per block, above the {SMEM_LIMIT}-byte budget"
            )
        U //= 2


def backward_shape(C: int, S: int, ds, ms, nslots: int, full: bool,
                   name: str = "backward_stats") -> tuple[int, int, int, bool, bool]:
    """backward_block's shape with the constants in shared memory, else
    with them read from device memory: (U, TT, statistics warps,
    acc_global, consts_global).  Full covariance past D = 16 (wide_full):
    the wide recursion's block, the log transitions read from device
    memory."""
    if wide_full(ds, full):
        return (*backward_block(C, S, ds, ms, nslots, full, name, consts_global=True, wide=True), True)
    try:
        return (*backward_block(C, S, ds, ms, nslots, full, name), False)
    except ValueError:
        return (*backward_block(C, S, ds, ms, nslots, full, name, consts_global=True), True)


def _backward_stat_warps(S: int, U: int) -> int:
    """Statistics warps filling a backward-stats block of U utterances to
    BACKWARD_THREADS (at least 2)."""
    return max(2, (BACKWARD_THREADS - -(-S * U // 32) * 32) // 32)


def _backward_least_smem(C: int, S: int, ds, ms, nslots: int, full: bool) -> int:
    """The shared memory of backward_shape's last try: one utterance, one
    frame a tile, the accumulators in the partials, the constants in device
    memory."""
    return backward_smem_bytes(C, S, ds, ms, nslots, full, 1, 1, _backward_stat_warps(S, 1), True, True)


def _on_cpu(name, feats) -> bool:
    kind = feats[0].device.type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"{name}: no implementation for device {feats[0].device}")
    return False


def emit_forward(feats, packed, origins, trans, lengths, band, q_out=None):
    """Per-stream (T, D_p, B) features + packed constants
    (pack_lane_constants, about ``origins``) -> (log_b, log_alpha), both
    (T, S, B) float32 (see emit_forward_plain).  q_out: None, or per
    stream a (T, M_p S, B) float32 tensor for the per-mixture q, which
    backward_stats then reads instead of recomputing it (full covariance
    past D = 16: stored_q_refusal, stored_q_buffers; else ValueError).

    CUDA tensors launch the hand-written kernel (csrc/fused_em.cu) and count
    one in ``emit_forward.launches``; CPU tensors run emit_forward_plain."""
    if _on_cpu("emit_forward", feats):
        return emit_forward_plain(feats, packed, origins, trans, lengths, band, q_out)
    ln = _Launch("emit_forward", feats, packed, origins, trans, lengths, band)
    qbuf = ln.stored_q(q_out)
    shape = ln.block(0)
    f32 = dict(dtype=torch.float32, device=ln.dev)
    log_b = torch.empty((ln.T, ln.S, ln.B), **f32)
    la = torch.empty((ln.T, ln.S, ln.B), **f32)
    lib = _kernel_library()
    ln.check(lib.srhmm_emit_forward(
        *ln.head(), log_b.data_ptr(), la.data_ptr(), qbuf, *ln.shape(shape["utts"]), shape["tile"],
        shape["rec_warps"], shape["em_warps"], int(shape["consts_global"]), emit_slots(ln.S, ln.band), *ln.where()))
    emit_forward.launches += 1
    return log_b, la


emit_forward.launches = 0


def backward_stats(feats, log_b, log_alpha, packed, origins, trans, lengths, safe_z, vmask, band, q=None):
    """The E-step statistics from emit_forward's lattices: (xi (nslots, S,
    B), den_trans (S, B), den_mix (S, B), (mom_p (M_p*S, L_p+1), ...))
    (see backward_stats_plain).  q: None, or the per-mixture q emit_forward
    stored (its q_out), which the moments read instead of recomputing it
    (bitwise the same statistics).

    CUDA tensors launch the hand-written kernel (csrc/fused_em.cu) and count
    one in ``backward_stats.launches``; the per-block moment partials (per
    range of utterances at full covariance past D = 16, where the recursion
    writes gamma to a scratch the z-GEMM moments read) are summed over
    blocks here, in a fixed order.  CPU tensors run backward_stats_plain."""
    if _on_cpu("backward_stats", feats):
        return backward_stats_plain(
            feats, log_b, log_alpha, packed, origins, trans, lengths, safe_z, vmask, band
        )
    ln = _Launch("backward_stats", feats, packed, origins, trans, lengths, band,
                 extra=(log_b, log_alpha, safe_z, vmask))
    qbuf = ln.stored_q(q)
    T, S, B = ln.T, ln.S, ln.B
    if log_b.shape != (T, S, B) or log_alpha.shape != (T, S, B):
        raise ValueError("backward_stats: log_b / log_alpha must be (T, S, B)")
    if safe_z.shape != (B,) or vmask.shape != (B,):
        raise ValueError("backward_stats: safe_z / vmask must be (B,)")
    # kept alive in locals until the launch is queued: a temporary copy freed
    # before then could be handed to the next allocation while still unread
    safe_z, vmask = safe_z.contiguous(), vmask.contiguous()
    log_b, log_alpha = log_b.contiguous(), log_alpha.contiguous()
    U, TT, stat_warps, acc_global, consts_global = ln.block(1)
    mom_thread = ln.moment_floats()
    f32 = dict(dtype=torch.float32, device=ln.dev)
    xi = torch.empty((ln.nslots, S, B), **f32)
    den_trans = torch.empty((S, B), **f32)
    den_mix = torch.empty((S, B), **f32)
    ranges = ln.ranges() if ln.wide else 0
    gamma = torch.empty((T, S, B), **f32) if ln.wide else None
    partial = torch.empty((ranges if ln.wide else -(-B // U), S * mom_thread), **f32)
    lib = _kernel_library()
    ln.check(lib.srhmm_backward_stats(
        *ln.head(), safe_z.data_ptr(), vmask.data_ptr(),
        log_b.data_ptr(), log_alpha.data_ptr(), xi.data_ptr(),
        den_trans.data_ptr(), den_mix.data_ptr(), partial.data_ptr(),
        None if gamma is None else gamma.data_ptr(), ranges, qbuf, *ln.shape(U),
        TT, stat_warps, int(acc_global), int(consts_global), *ln.where(),
    ))
    backward_stats.launches += 1
    mom = partial.sum(0)
    moms, off = [], 0
    for D, M in zip(ln.ds, ln.ms):
        L1 = (D + D * D if ln.full else 2 * D) + 1
        moms.append(mom[off : off + M * S * L1].reshape(M * S, L1))
        off += M * S * L1
    return xi, den_trans, den_mix, tuple(moms)


backward_stats.launches = 0


def occupancy(which: int, feats, packed, origins, trans, lengths, band) -> dict:
    """Resident blocks and warps per SM of one launch (which: 0 =
    emit-forward, 1 = backward-stats), from the CUDA occupancy calculator
    for the block shape the wrappers choose, with that shape.  Full
    covariance past D = 16 adds the z-GEMM kernel's blocks an SM
    (``emission_blocks_per_sm`` / ``moments_blocks_per_sm``) and, for the
    moments, their grid (ranges x row groups)."""
    ln = _Launch("occupancy", feats, packed, origins, trans, lengths, band)
    if which == 0:
        shape = ln.block(0)
        U, threads, smem = shape["utts"], shape["threads"], shape["smem_bytes"]
        variant = {0: 0, 2: 1, 4: 2, 8: 3}[emit_slots(ln.S, ln.band)]  # csrc/fused_em.cu emit_variant
        out = {**shape, "slots": emit_slots(ln.S, ln.band)}
    else:
        U, TT, stat_warps, acc_global, consts_global = ln.block(1)
        threads = -(-ln.S * U // 32) * 32 + 32 * stat_warps
        variant = 4 if ln.nslots <= 2 else 5  # csrc/fused_em.cu backward_variant
        out = {"tile_frames": TT, "stat_warps": stat_warps, "acc_in_shared_memory": not acc_global,
               "consts_in_shared_memory": not consts_global}
        smem = backward_smem_bytes(ln.consts.numel(), ln.S, ln.ds, ln.ms, ln.nslots, ln.full, U, TT, stat_warps,
                                   acc_global, consts_global, ln.wide)
    lib = _kernel_library()
    blocks = ctypes.c_int(0)
    ln.check(lib.srhmm_em_occupancy(variant, ln.dmax, int(ln.full), threads, smem, ctypes.byref(blocks)))
    if ln.wide:  # the z-GEMM kernel beside the recursion (csrc/fused_em.cu variants 6 and 7)
        wide = ctypes.c_int(0)
        ln.check(lib.srhmm_em_occupancy(6 + which, ln.dmax, 1, 0, 0, ctypes.byref(wide)))
        kind = "moments" if which else "emission"
        out = {**out, f"{kind}_blocks_per_sm": wide.value, f"{kind}_smem_bytes": wide_smem_bytes(ln.dmax, which)}
        if which == 1:
            out["moment_grid"] = (ln.ranges(), sum(moment_groups(ln.S, M) for M in ln.ms))
    return {**out, "utts_per_block": U, "threads": threads, "smem_bytes": smem, "blocks_per_sm": blocks.value,
            "grid": -(-ln.B // U), "warps_per_block": -(-threads // 32)}
