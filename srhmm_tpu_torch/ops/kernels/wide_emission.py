"""The emission pass of the vocabulary scorer (#1) and the word-loop
decoder (#6-#8) at full covariance past D = 16: ``csrc/wide_log_b.cu``.

Part of the ports of ``srhmm_tpu/ops/pallas/scoring_pallas.py:301`` and
``decode_pallas.py:352 / :718 / :1050`` (their full-covariance emission):
at full covariance with a feature dim past 16 the scorer and the decoder
compute log b of every column (frame, utterance) they step and every row
(word, state) first, into a device buffer their recursions read.

* ``is_wide`` — the rule: full covariance, a feature dim past 16.
* ``pack_streams`` — every stream's records in csrc/wide_gemm.cuh's staged
  layout (``common.wide_records``) and the register bound.
* ``plan_parts`` — the launches of one call: (utterances, frames) parts whose
  log b stays within ``common.WIDE_LOG_B_BYTES``, decided from the shapes.
* ``columns`` — the (frame, utterance) columns of one part that a recursion
  steps, in the order the pass writes them.
* ``wide_log_b`` — fills a part's buffer.  CUDA tensors launch the kernel
  and count one in ``wide_log_b.launches``; CPU tensors run
  ``wide_log_b_plain``, the same function in eager PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import common
from .common import _TINY, LOG_GAUS_CLAMP, NEG_INF, check_launch, device_args, wide_records
from .composed import register_bound

ROW_GROUP_MIXES = 256  # mixtures (summed over the streams) of a block's row group, at most where rows allow


def is_wide(dims, full: bool) -> bool:
    """Whether a full-covariance vocabulary of these feature dims takes the
    emission pass: a register bound past 16 (D of 17 to 64)."""
    return bool(full) and register_bound(max(dims)) > 16


def pack_streams(a_s, bias_gs, biass, logws, ds, ms, N: int):
    """(records, float offset of each stream's, register bound): the
    streams' records back to back, each N * M_p staged records at the
    register bound of the largest D."""
    rb = register_bound(max(ds))
    recs, offs, off = [], [], 0
    for a, bg, bi, lw, D, M in zip(a_s, bias_gs, biass, logws, ds, ms):
        rec = wide_records(a, bg, bi, lw, D, M, N, rb)
        recs.append(rec)
        offs.append(off)
        off += rec.numel()
    return torch.cat(recs).contiguous(), offs, rb


def rows_per_group(N: int, ms) -> int:
    """Rows of a block's row group: the rows split evenly into the fewest
    groups of at most ROW_GROUP_MIXES mixtures (one row at least)."""
    groups = max(1, -(-N * sum(ms) // ROW_GROUP_MIXES))
    return -(-N // groups)


def plan_parts(B: int, T: int, N: int, unit: int) -> list[tuple[int, int, int, int]]:
    """The launches of one call as (b_lo, b_hi, t_lo, t_hi) parts, in order:
    utterances in runs of whole `unit`s (the scorer's utterance block U, the
    decoder's 1), each part's log b, 4 N unit bytes a frame and unit, at
    most common.WIDE_LOG_B_BYTES over its T frames; where one unit alone
    passes that, each unit's frames in chunks that fit, in time order (the
    recursion carries its state from one to the next)."""
    cap, per = common.WIDE_LOG_B_BYTES, 4 * N * unit
    if per * T <= cap:
        step = max(1, cap // (per * T)) * unit
        return [(lo, min(B, lo + step), 0, T) for lo in range(0, B, step)]
    tc = max(1, cap // per)
    return [(lo, min(B, lo + unit), t, min(T, t + tc)) for lo in range(0, B, unit) for t in range(0, T, tc)]


def columns(lengths, b_lo: int, b_hi: int, t_lo: int, t_hi: int, T: int, t_major: bool) -> torch.Tensor:
    """(n, 2) int32 (frame, utterance) columns of a part that a recursion
    steps: the frames t_lo <= t < t_hi below min(max(length, 1), T) of the
    utterances b_lo <= b < b_hi; frame-major (utterances fastest, the
    scorer's order) or utterance-major (frames fastest, the decoder's)."""
    tend = lengths[b_lo:b_hi].to(torch.int64).clamp(min=1, max=T)
    t = torch.arange(t_lo, t_hi, device=lengths.device)
    mask = t[None, :] < tend[:, None]  # (utterances, frames)
    if t_major:
        tt, bb = mask.T.nonzero(as_tuple=True)
    else:
        bb, tt = mask.nonzero(as_tuple=True)
    return torch.stack([tt + t_lo, bb + b_lo], 1).to(torch.int32).contiguous()


def _layout_index(cols, N: int, b0: int, t0: int, uo: int, s_ub: int, s_t: int, s_n: int) -> torch.Tensor:
    """(n, N) flat indices of the columns' rows in a buffer of the pass's
    layout (csrc/wide_log_b.cu)."""
    t, b = cols[:, 0].long(), cols[:, 1].long() - b0
    base = (b // uo) * s_ub + (t - t0) * s_t + b % uo
    return base[:, None] + torch.arange(N, device=cols.device)[None, :] * s_n


def gather_columns(buf, cols, N: int, b0: int, t0: int, uo: int, s_ub: int, s_t: int, s_n: int) -> torch.Tensor:
    """(n, N) log b of the columns read back out of a buffer of that layout."""
    return buf.reshape(-1)[_layout_index(cols, N, b0, t0, uo, s_ub, s_t, s_n)]


def wide_log_b_plain(feats, recs, offs, ds, ms, rb: int, N: int, cols, out, b0: int, t0: int, uo: int,
                     s_ub: int, s_t: int, s_n: int):
    """The pass's function in eager PyTorch on the same inputs: per column
    and row, per stream z = L^T x + c from the staged records, q =
    min(-sum z^2 / 2 + bias, log 1e20) + log w, the mixture logsumexp (max
    at least NEG_INF, the 1e-38 guard), summed over the streams; written
    into out (contiguous) at the layout's places.  Columns go in chunks that
    keep the (chunk, N, M, rb) z small."""
    idx = _layout_index(cols, N, b0, t0, uo, s_ub, s_t, s_n)
    flat = out.view(-1)
    size = (rb + 1) * (rb + 4)
    chunk = max(1, (1 << 25) // (N * max(ms) * rb))
    for c0 in range(0, cols.shape[0], chunk):
        t, b = cols[c0:c0 + chunk, 0].long(), cols[c0:c0 + chunk, 1].long()
        lb = None
        for f, off, D, M in zip(feats, offs, ds, ms):
            r = recs[off:off + N * M * size].reshape(N, M, rb + 1, rb + 4)
            x = F.pad(f[t, :, b].to(torch.float32), (0, rb - D))  # (n, rb)
            z = torch.einsum("nmde,ce->cnmd", r[:, :, :rb, :rb], x) + r[None, :, :, rb, :rb]
            q = torch.clamp(-0.5 * (z * z).sum(-1) + r[:, :, rb, rb], max=LOG_GAUS_CLAMP) + r[:, :, rb, rb + 1]
            m = torch.clamp(q.max(-1).values, min=NEG_INF)
            v = torch.log(torch.clamp(torch.exp(q - m[..., None]).sum(-1), min=_TINY)) + m
            lb = v if lb is None else lb + v
        flat[idx[c0:c0 + chunk].reshape(-1)] = lb.reshape(-1)
    return out


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the launcher's C signature declared."""
    from .build import load_library

    lib = load_library()
    c_int, c_ptr, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    p_int = ctypes.POINTER(c_int)
    lib.srhmm_wide_log_b.restype = c_int
    lib.srhmm_wide_log_b.argtypes = [
        ctypes.POINTER(c_ptr), ctypes.POINTER(c_ll), p_int, p_int, ctypes.POINTER(c_ll),  # feats, strides, dims,
        c_int, c_int, c_ptr, c_ptr, c_int,  # mixes, offs, n_streams, rb, recs, cols, n_cols
        c_int, c_int, c_ptr,  # N, rows_per_group, out
        c_int, c_int, c_int, c_ll, c_ll, c_ll,  # b0, t0, uo, s_ub, s_t, s_n
        c_int, c_ptr,  # device, stream
    ]
    return lib


def wide_log_b(feats, recs, offs, ds, ms, rb: int, N: int, cols, out, b0: int, t0: int, uo: int,
               s_ub: int, s_t: int, s_n: int):
    """log b of the columns cols ((n, 2) int32 (frame, utterance)) at every
    row of N, from per-stream (T, D_p, B) features (any strides) and the
    staged records recs (pack_streams: stream offsets offs, register bound
    rb), written into out (contiguous float32) at (b' // uo) s_ub + (t - t0)
    s_t + b' % uo + row s_n, b' = b - b0.  CUDA tensors launch
    csrc/wide_log_b.cu and count one in ``wide_log_b.launches``; CPU
    tensors run wide_log_b_plain."""
    if common.on_cpu("wide_log_b", recs):
        return wide_log_b_plain(feats, recs, offs, ds, ms, rb, N, cols, out, b0, t0, uo, s_ub, s_t, s_n)
    P = len(feats)
    if not out.is_contiguous() or out.dtype != torch.float32 or cols.dtype != torch.int32:
        raise ValueError("wide_log_b: a contiguous float32 buffer and int32 columns")
    if cols.shape[0] == 0:
        return out
    common.require_float32("wide_log_b", recs.device, [*feats, recs, cols, out], [*feats, recs, out])
    ints = ctypes.c_int * P
    check_launch("wide_log_b", _kernel_library().srhmm_wide_log_b(
        (ctypes.c_void_p * P)(*[f.data_ptr() for f in feats]),
        (ctypes.c_longlong * (3 * P))(*[s for f in feats for s in f.stride()]),
        ints(*ds), ints(*ms), (ctypes.c_longlong * P)(*offs), P, rb, recs.data_ptr(), cols.data_ptr(),
        cols.shape[0], N, rows_per_group(N, ms), out.data_ptr(), b0, t0, uo, s_ub, s_t, s_n,
        *device_args(recs.device),
    ))
    wide_log_b.launches += 1
    return out


wide_log_b.launches = 0
