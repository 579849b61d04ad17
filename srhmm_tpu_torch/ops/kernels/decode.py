"""Word-loop Viterbi decode kernels: 1-best, 2-best and K-best.

Counterpart of ``srhmm_tpu/ops/pallas/decode_pallas.py``.  One frame-
synchronous Viterbi over a stacked vocabulary's word loop decodes every
utterance of a padded batch in one launch: the per-frame emissions from
the packed constants (``scoring.pack_vocab_constants``), the banded
within-word (max, +) step, the cross-word merge (a unigram decomposition,
or a genuine (W, W) bigram), and the backpointers as the only large
output.

* ``word_loop_decode_plain`` — the three TPU kernels' function in eager
  PyTorch, one Python step per frame vectorized over (K, N, B):
  n_best=1 follows ``word_loop_decode_pallas`` (source-row pointers),
  n_best=2 ``word_loop_decode_k2_pallas`` and n_best>=3
  ``word_loop_decode_kn_pallas`` (flat src*K + k pointers), tie-breaks
  included.  For K = 2 the last two compute the same top-2; they break a
  tie between equal tokens differently.
* ``word_loop_decode`` / ``word_loop_decode_k2`` / ``word_loop_decode_kn``
  — the JAX signatures without the TPU tiling arguments.  CUDA tensors
  launch the hand-written kernel ``csrc/word_loop_decode.cu`` (one kernel
  templated on K; K = 2 follows the 2-best contract whichever wrapper
  calls it) and count one in the wrapper's ``.launches``; CPU tensors run
  the twin.  Nothing falls back from one to the other.

Shapes, as in the JAX package: features (T, D_p, B) per stream (a tuple for
several streams, any strides); a / bias / bias_g / logw per stream from
``pack_vocab_constants``; diag (band+1, N, 1); arc_col (N, 1) per-
destination arc at entry rows (NEG_INF elsewhere) or the (W, W) bigram
matrix; entry_col and exit_col (N, 1) (exit_col: 0.0 at each word's exit
row, NEG_INF elsewhere; default the last state of every word).  Outputs:
final (N, B) and bp (T, N, B) source rows for n_best=1; final (K, N, B)
and bp (T, K, N, B) for n_best=K.  bp[0] is the identity, and so is every
row at t >= length, where the carry is kept; frame 0 is taken even for a
zero-length row.  The kernel writes its lattice as (B, T, N, K), every
frame of an utterance contiguous, and returns views in the JAX layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .common import NEG_INF, SMEM_LIMIT, dmax_for, mixture_records
from .scoring import _as_tuple, _plain_stream_log_b, _stream_shapes

MAX_STREAMS = 6
K_MAX = 4  # csrc/word_loop_decode.cu kMaxK
_MAX_THREADS = 512  # csrc/word_loop_decode.cu kMaxThreads
_FRAMES_MAX = 16  # csrc/word_loop_decode.cu kFramesMax: emission chunk
_RED_WORDS = 128  # csrc/word_loop_decode.cu kRedWords


def _r4(x: int) -> int:
    return -(-x // 4) * 4


def smem_bytes(N: int, W: int, K: int, P: int, dmax: int, bigram: bool, frames: int) -> int:
    """csrc/word_loop_decode.cu smem_floats, in bytes: the double-buffered
    (K, N) carry, a chunk of per-frame log b, the chunk's features (x per
    stream), the reduction scratch, and for a bigram the per-word exit
    tokens and cross-word candidates."""
    words = _r4(2 * K * N) + _r4(frames * N) + frames * P * dmax + _RED_WORDS
    if bigram:
        words += 3 * K * W
    return 4 * words


def frames_per_chunk(N: int, W: int, K: int, P: int, dmax: int, bigram: bool) -> int:
    """Frames whose emissions the kernel computes together (each mixture
    record is read once per chunk): the most that fit shared memory, up to
    16; 0 if not even one does."""
    for f in range(_FRAMES_MAX, 0, -1):
        if smem_bytes(N, W, K, P, dmax, bigram, f) <= SMEM_LIMIT:
            return f
    return 0


def merge_groups(W: int, threads: int) -> int:
    """Threads a bigram destination takes in the kernel's merge (its
    sources split between them): the largest power of two up to 32 with
    groups * W <= threads, else 1."""
    g = 1
    while g < 32 and 2 * g * W <= threads:
        g *= 2
    return g


def fits(N: int, W: int, K: int, dims, bigram: bool) -> bool:
    """Whether the kernel takes this problem: K within its compiled
    maximum, feature dims within its bounds, and one frame's working set
    in a block's shared memory."""
    if not 1 <= K <= K_MAX or len(dims) > MAX_STREAMS:
        return False
    try:
        dmax = dmax_for(dims, "word_loop_decode")
    except ValueError:
        return False
    return frames_per_chunk(N, W, K, len(dims), dmax, bigram) > 0


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------


def _streams(feats_tdb, a, bias, bias_g, logw):
    featss, a_s, bias_s = _as_tuple(feats_tdb), _as_tuple(a), _as_tuple(bias)
    P = len(featss)
    bias_gs = bias_g if isinstance(bias_g, tuple) else (bias_g,) * P
    logws = logw if isinstance(logw, tuple) else (logw,) * P
    if not (len(a_s) == len(bias_s) == len(bias_gs) == len(logws) == P):
        raise ValueError("word_loop_decode: one set of constants per stream")
    ds, ms, full = _stream_shapes(featss, a_s)
    return featss, a_s, bias_s, bias_gs, logws, ds, ms, full


def _default_exit_col(N: int, s_word: int, device) -> torch.Tensor:
    rid = torch.arange(N, device=device) % s_word
    return torch.where(rid == s_word - 1, 0.0, NEG_INF).to(torch.float32)[:, None]


def _exit_rows(exit_col: torch.Tensor, s_word: int) -> torch.Tensor:
    """(W,) int32 global row of each word's exit (its first exit row)."""
    N = exit_col.shape[0]
    W = N // s_word
    mask = (exit_col[:, 0] > -1.0).reshape(W, s_word).to(torch.int32)
    return (mask.argmax(1) + torch.arange(W, device=exit_col.device) * s_word).to(torch.int32)


def _insert(vals, ids, v, i):
    """K-slot insertion of candidate (v, i) into descending slots; strict
    > keeps the first-seen candidate on ties (_topk_insert)."""
    for k in range(len(vals)):
        better = v > vals[k]
        vals[k], v = torch.where(better, v, vals[k]), torch.where(better, vals[k], v)
        ids[k], i = torch.where(better, i, ids[k]), torch.where(better, ids[k], i)


def _lowest(mask, idx, fill, dim=0, keepdim=False):
    """The lowest idx where mask holds (fill where it nowhere does)."""
    return torch.where(mask, idx, fill).amin(dim, keepdim=keepdim)


class _Frame:
    """Per-call constants of the twin's frame step."""

    def __init__(self, N, B, s_word, band, K, diag, arc_col, exit_col, dev):
        self.N, self.B, self.S, self.W, self.band, self.K = N, B, s_word, N // s_word, band, K
        self.neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
        self.row = torch.arange(N, device=dev)[:, None]
        self.rin = self.row % s_word
        self.is_entry = self.rin == 0
        self.diag, self.arc, self.exit_col = diag, arc_col, exit_col
        self.is_exit = exit_col > -1.0
        self.bigram = tuple(arc_col.shape) == (self.W, self.W) and s_word != 1
        self.exit_row = _exit_rows(exit_col, s_word).long()

    def shifted(self, c, d):
        return c if d == 0 else torch.where(self.rin >= d, torch.roll(c, d, 0), self.neg)

    def spread(self, v):  # (W, B) per word -> (N, B) per row
        return v.repeat_interleave(self.S, 0)

    def exit_per_word(self, c):  # (N, B) -> (W, B) max over each word's rows of c + exit_col
        return (c + self.exit_col).reshape(self.W, self.S, -1).amax(1)

    def step1(self, c, log_b):
        """#6 (word_loop_decode_pallas): source-row pointers."""
        N, neg, row = self.N, self.neg, self.row
        best = c + self.diag[0]
        bp = row.expand(N, self.B)
        for d in range(1, self.band + 1):
            cand = self.shifted(c, d) + self.diag[d]
            take = cand > best
            best = torch.where(take, cand, best)
            bp = torch.where(take, row - d, bp)
        if self.bigram:
            cand = self.exit_per_word(c)[:, None, :] + self.arc[:, :, None]  # (W_src, W_dst, B)
            cr = cand.amax(0)
            rows3 = self.exit_row[:, None, None].expand_as(cand)
            am_row = _lowest(cand == cr[None], rows3, N)
            cross = torch.where(self.is_entry, self.spread(cr), neg)
            bp_x = self.spread(am_row)
        else:
            exit_m = torch.where(self.is_exit, c, neg)
            m = exit_m.amax(0, keepdim=True)
            am = _lowest(exit_m == m, row, N, keepdim=True)
            cross = m + self.arc
            bp_x = am.expand(N, self.B)
        take = cross > best
        best = torch.where(take, cross, best)
        bp = torch.where(take, bp_x, bp)
        return [torch.maximum(best + log_b, neg)], [bp]

    def cross_k2(self, c):
        """#7's two cross-word candidates (value (N, B), pointer)."""
        N, neg, row = self.N, self.neg, self.row
        if self.bigram:
            e0w, e1w = self.exit_per_word(c[0]), self.exit_per_word(c[1])
            arc3 = self.arc[:, :, None]
            cand1 = e0w[:, None, :] + arc3
            cr1 = cand1.amax(0)
            rows3 = self.exit_row[:, None, None].expand_as(cand1)
            amr = _lowest(cand1 == cr1[None], rows3, N)
            is_best = rows3 == amr[None]
            excl = torch.where(is_best, neg, cand1)
            s1x = excl.amax(0)
            asr = _lowest(excl == s1x[None], rows3, N)
            c2b = torch.where(is_best, e1w[:, None, :] + arc3, neg).amax(0)
            use_ru = s1x >= c2b
            x2v = torch.where(use_ru, s1x, c2b)
            x2bp = torch.where(use_ru, asr * 2, amr * 2 + 1)
            return [
                (torch.where(self.is_entry, self.spread(cr1), neg), self.spread(amr * 2)),
                (torch.where(self.is_entry, self.spread(x2v), neg), self.spread(x2bp)),
            ]
        e0 = torch.where(self.is_exit, c[0], neg)
        e1 = torch.where(self.is_exit, c[1], neg)
        rm0, rm1 = e0.amax(0, keepdim=True), e1.amax(0, keepdim=True)
        am0 = _lowest(e0 == rm0, row, N, keepdim=True)
        am1 = _lowest(e1 == rm1, row, N, keepdim=True)
        x0 = torch.where(row == am0, neg, e0)
        x1 = torch.where(row == am1, neg, e1)
        s0, s1 = x0.amax(0, keepdim=True), x1.amax(0, keepdim=True)
        as0 = _lowest(x0 == s0, row, N, keepdim=True)
        as1 = _lowest(x1 == s1, row, N, keepdim=True)
        take0 = rm0 >= rm1
        x1v = torch.where(take0, rm0, rm1)
        x1bp = torch.where(take0, am0 * 2, am1 * 2 + 1)
        a_v = torch.where(take0, rm1, rm0)
        a_bp = torch.where(take0, am1 * 2 + 1, am0 * 2)
        b_v = torch.where(take0, s0, s1)
        b_bp = torch.where(take0, as0 * 2, as1 * 2 + 1)
        use_a = a_v >= b_v
        x2v, x2bp = torch.where(use_a, a_v, b_v), torch.where(use_a, a_bp, b_bp)
        live = self.arc > neg
        return [
            (torch.where(live, x1v + self.arc, neg), x1bp.expand(N, self.B)),
            (torch.where(live, x2v + self.arc, neg), x2bp.expand(N, self.B)),
        ]

    def cross_kn(self, c):
        """#8's K cross-word candidates: take counters, per row (unigram)
        or per (source, destination) pair (bigram)."""
        N, K, neg, row = self.N, self.K, self.neg, self.row
        out = []
        if self.bigram:
            e_w = [self.exit_per_word(c[kk]) for kk in range(K)]
            arc3 = self.arc[:, :, None]
            tc3 = torch.zeros((self.W, self.W, self.B), dtype=torch.long, device=row.device)
            rows3 = self.exit_row[:, None, None].expand_as(tc3)
            for _ in range(K):
                cand = torch.full_like(tc3, NEG_INF, dtype=torch.float32)
                for kk in range(K - 1, -1, -1):
                    cand = torch.where(tc3 == kk, e_w[kk][:, None, :] + arc3, cand)
                m = cand.amax(0)
                amr = _lowest(cand == m[None], rows3, N)
                is_ch = rows3 == amr[None]
                tcs = _lowest(is_ch, tc3, K)
                out.append((torch.where(self.is_entry, self.spread(m), neg), self.spread(amr * K + tcs)))
                tc3 = torch.where(is_ch, tc3 + 1, tc3)
            return out
        planes = [torch.where(self.is_exit, c[kk], neg) for kk in range(K)]
        tc = torch.zeros((N, self.B), dtype=torch.long, device=row.device)
        live = self.arc > neg
        for _ in range(K):
            cand = torch.full((N, self.B), NEG_INF, dtype=torch.float32, device=row.device)
            for kk in range(K - 1, -1, -1):
                cand = torch.where(tc == kk, planes[kk], cand)
            m = cand.amax(0, keepdim=True)
            am = _lowest(cand == m, row, N, keepdim=True)
            tc_sel = _lowest(row == am, tc, N, keepdim=True)
            out.append((torch.where(live, m + self.arc, neg), (am * K + tc_sel).expand(N, self.B)))
            tc = torch.where(row == am, tc + 1, tc)
        return out

    def stepk(self, c, log_b):
        """#7 (K = 2) and #8 (K >= 3): flat src*K + k pointers."""
        N, K, neg, row = self.N, self.K, self.neg, self.row
        zero = torch.zeros((N, self.B), dtype=torch.long, device=row.device)
        vals = [neg.expand(N, self.B)] * K
        ids = [zero] * K
        for d in range(self.band + 1):
            for kk in range(K):
                v = self.shifted(c[kk], d) + self.diag[d]
                pid = torch.full_like(zero, d * K + kk)
                if K == 2 and d == 0 and kk == 0:  # #7 seeds its best slot with the first candidate
                    vals, ids = [v, neg.expand(N, self.B)], [pid, pid]
                else:
                    _insert(vals, ids, v, pid)
        n_within = (self.band + 1) * K
        cross = self.cross_k2(c) if K == 2 else self.cross_kn(c)
        for t, (v, _) in enumerate(cross):
            _insert(vals, ids, v, torch.full_like(zero, n_within + t))

        def bp_of(pid):
            bp = zero
            for d in range(self.band + 1):
                for kk in range(K):
                    bp = torch.where(pid == d * K + kk, (row - d) * K + kk, bp)
            for t, (_, bp_x) in enumerate(cross):
                bp = torch.where(pid == n_within + t, bp_x, bp)
            return bp

        return [torch.maximum(v + log_b, neg) for v in vals], [bp_of(i) for i in ids]


def word_loop_decode_plain(
    feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word: int, band: int,
    n_best: int = 1, exit_col=None, bias_g=None, logw=None,
):
    """The word-loop kernels' function in eager PyTorch (module
    docstring): n_best=1 returns (final (N, B), bp (T, N, B) source rows);
    n_best=K >= 2 returns (final (K, N, B), bp (T, K, N, B) flat
    src*K + k)."""
    featss, a_s, bias_s, bias_gs, logws, ds, _, full = _streams(feats_tdb, a, bias, bias_g, logw)
    T, _, B = featss[0].shape
    N = a_s[0].shape[1]
    if N % s_word:
        raise ValueError("word_loop_decode: rows are not a whole number of words")
    K = n_best
    dev = featss[0].device
    if exit_col is None:
        exit_col = _default_exit_col(N, s_word, dev)
    fr = _Frame(N, B, s_word, band, K, diag, arc_col, exit_col.to(torch.float32), dev)
    lens = lengths.to(dev)
    ident = [(fr.row * K + k).expand(N, B).to(torch.int32) for k in range(K)]
    bps = torch.empty((T, K, N, B), dtype=torch.int32, device=dev)
    carry = None
    for t in range(T):
        log_b = None
        for p in range(len(featss)):
            lb = _plain_stream_log_b(featss[p][t].to(torch.float32), a_s[p], bias_gs[p], bias_s[p],
                                     logws[p], ds[p], full)
            log_b = lb if log_b is None else log_b + lb
        if t == 0:  # frame 0 is always taken
            carry = [torch.maximum(entry_col + log_b, fr.neg)] + [fr.neg.expand(N, B)] * (K - 1)
            for k in range(K):
                bps[0, k] = ident[k]
            continue
        new, bp = fr.step1(carry[0], log_b) if K == 1 else fr.stepk(carry, log_b)
        keep = (lens > t)[None, :]
        carry = [torch.where(keep, n, c) for n, c in zip(new, carry)]
        for k in range(K):
            bps[t, k] = torch.where(keep, bp[k], ident[k])
    if K == 1:
        return carry[0], bps[:, 0]
    return torch.stack(carry), bps


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/word_loop_decode.cu)
# ---------------------------------------------------------------------------


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """The built kernel library with the launcher's C signature declared."""
    from .build import load_library

    lib = load_library()
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    p_int = ctypes.POINTER(c_int)
    lib.srhmm_word_loop_decode.restype = c_int
    lib.srhmm_word_loop_decode.argtypes = [
        ctypes.POINTER(c_ptr), ctypes.POINTER(ctypes.c_longlong),  # feats, strides (t, d, b) per stream
        p_int, p_int, p_int, c_int, c_int,  # dims, mixes, offs, n_streams, dmax
        c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr, c_ptr,  # consts, diag, arc, entry, exit, exit_row,
                                                                 # arc_range, lengths
        c_ptr, c_ptr,  # final, bp
        c_int, c_int, c_int, c_int, c_int, c_int,  # T, B, N, S, band, bigram
        c_int, c_int, c_int, c_int, c_int, c_int, c_ptr,  # K, full, frames, threads, groups, device, stream
    ]
    return lib


def decode_records(rec, N: int, M: int, dmax: int, full: bool) -> torch.Tensor:
    """One stream's csrc/emission.cuh records (mixture_records, (1, N * M *
    stride)) in the order the kernel reads them, flat: full covariance as
    they are, row-major (row, mixture); diagonal row-minor, so that the
    rows of a warp read neighbouring words: the float4 groups of the x and
    x² halves as (M, dmax / 4, 2, N, 4), then bias and log w as (M, 2, N),
    padded to a multiple of 4 floats."""
    if full:
        return rec.reshape(-1)
    r = rec.reshape(N, M, 2 * dmax + 4)
    halves = r[..., : 2 * dmax].reshape(N, M, 2, dmax // 4, 4).permute(1, 3, 2, 0, 4)
    scalars = r[..., 2 * dmax : 2 * dmax + 2].permute(1, 2, 0)
    pad = torch.zeros((-2 * M * N) % 4, dtype=rec.dtype, device=rec.device)
    return torch.cat([halves.reshape(-1), scalars.reshape(-1), pad])


def _on_cpu(name: str, feats_tdb) -> bool:
    dev = _as_tuple(feats_tdb)[0].device
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no implementation for device {dev}")
    return False


def _launch(name, feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word, band, K,
            exit_col, bias_g, logw):
    """Check the operands, pack the mixture records and launch the kernel
    on the current stream.  Returns (final, bp) as views in the JAX
    layout of the n_best=K contract."""
    featss, a_s, bias_s, bias_gs, logws, ds, ms, full = _streams(feats_tdb, a, bias, bias_g, logw)
    P = len(featss)
    if P > MAX_STREAMS:
        raise ValueError(f"{name}: at most {MAX_STREAMS} streams, got {P}")
    if not 1 <= K <= K_MAX:
        raise ValueError(f"{name}: n_best {K} outside the kernel's [1, {K_MAX}]")
    dev = featss[0].device
    T, _, B = featss[0].shape
    N = a_s[0].shape[1]
    if N % s_word:
        raise ValueError(f"{name}: rows are not a whole number of words")
    W = N // s_word
    if exit_col is None:
        exit_col = _default_exit_col(N, s_word, dev)
    consts_in = [*a_s, *bias_s, *(x for x in (*bias_gs, *logws) if x is not None)]
    tensors = [*featss, *consts_in, diag, arc_col, entry_col, exit_col]
    if any(t.device != dev for t in [*tensors, lengths]):
        raise ValueError(f"{name}: every tensor must be on the features' CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes float32 tensors only")
    if any(f.shape[0] != T or f.shape[2] != B for f in featss) or tuple(lengths.shape) != (B,):
        raise ValueError(f"{name}: streams disagree on (T, B)")
    bigram = tuple(arc_col.shape) == (W, W) and s_word != 1
    if not bigram and tuple(arc_col.shape) != (N, 1):
        raise ValueError(f"{name}: arc_col must be (N, 1) or (W, W), got {tuple(arc_col.shape)}")
    if tuple(diag.shape) != (band + 1, N, 1) or tuple(entry_col.shape) != (N, 1) \
            or tuple(exit_col.shape) != (N, 1):
        raise ValueError(f"{name}: diag / entry_col / exit_col do not fit N={N}, band={band}")
    if full and any(bg is None or lw is None for bg, lw in zip(bias_gs, logws)):
        raise ValueError(f"{name}: full covariance needs bias_g and logw")
    dmax = dmax_for(ds, name)
    frames = frames_per_chunk(N, W, K, P, dmax, bigram)
    if frames == 0:
        raise ValueError(
            f"{name}: one frame needs {smem_bytes(N, W, K, P, dmax, bigram, 1)} bytes of shared "
            f"memory, above the {SMEM_LIMIT}-byte budget of a block"
        )
    recs, offs, off = [], [], 0
    for a_p, bg, bi, lw, D, M in zip(a_s, bias_gs, bias_s, logws, ds, ms):
        rec = decode_records(mixture_records(a_p, bg, bi, lw if full else None, D, M, 1, N, full, dmax),
                             N, M, dmax, full)
        recs.append(rec)
        offs.append(off)
        off += rec.numel()
    # every operand stays referenced here until the launch is queued
    consts = torch.cat(recs).contiguous()
    diag_c, arc_c = diag.contiguous(), arc_col.contiguous()
    entry_c, exit_c = entry_col.contiguous(), exit_col.contiguous()
    exit_row = _exit_rows(exit_c, s_word).contiguous()
    # the bigram arcs' min and max, the merge's bound on what can enter a top
    # K (a unigram reads nothing there)
    arc_range = torch.stack([arc_c.amin(), arc_c.amax()]) if bigram else arc_c
    lens = lengths.to(torch.int32).contiguous()
    final = torch.empty((B, K, N), dtype=torch.float32, device=dev)
    bp = torch.empty((B, T, N, K), dtype=torch.int32, device=dev)
    strides = [s for f in featss for s in f.stride()]
    threads = min(_MAX_THREADS, -(-N // 32) * 32)  # one thread per row, up to 16 warps
    ints = ctypes.c_int * P
    lib = _kernel_library()
    err = lib.srhmm_word_loop_decode(
        (ctypes.c_void_p * P)(*[f.data_ptr() for f in featss]),
        (ctypes.c_longlong * (3 * P))(*strides),
        ints(*ds), ints(*ms), ints(*offs), P, dmax,
        consts.data_ptr(), diag_c.data_ptr(), arc_c.data_ptr(), entry_c.data_ptr(),
        exit_c.data_ptr(), exit_row.data_ptr(), arc_range.data_ptr(), lens.data_ptr(),
        final.data_ptr(), bp.data_ptr(),
        T, B, N, s_word, band, int(bigram), K, int(full), frames, threads, merge_groups(W, threads) if bigram else 1,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        msg = lib.srhmm_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    if K == 1:
        return final[:, 0, :].T, bp[..., 0].permute(1, 2, 0)
    return final.permute(1, 2, 0), bp.permute(1, 3, 2, 0)


def word_loop_decode(
    feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word: int, band: int,
    exit_col=None, bias_g=None, logw=None,
):
    """1-best word-loop Viterbi (word_loop_decode_pallas): (final (N, B),
    bp (T, N, B) int32 source rows).  CUDA tensors launch the kernel and
    count one in ``word_loop_decode.launches``; CPU tensors run
    word_loop_decode_plain."""
    args = (feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word, band)
    if _on_cpu("word_loop_decode", feats_tdb):
        return word_loop_decode_plain(*args, 1, exit_col, bias_g, logw)
    out = _launch("word_loop_decode", *args, 1, exit_col, bias_g, logw)
    word_loop_decode.launches += 1
    return out


word_loop_decode.launches = 0


def word_loop_decode_k2(
    feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word: int, band: int,
    exit_col=None, bias_g=None, logw=None,
):
    """2-best (word_loop_decode_k2_pallas): (final (2, N, B), bp
    (T, 2, N, B) int32 flat src*2 + k).  CUDA tensors launch the kernel
    and count one in ``word_loop_decode_k2.launches``."""
    args = (feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word, band)
    if _on_cpu("word_loop_decode_k2", feats_tdb):
        return word_loop_decode_plain(*args, 2, exit_col, bias_g, logw)
    out = _launch("word_loop_decode_k2", *args, 2, exit_col, bias_g, logw)
    word_loop_decode_k2.launches += 1
    return out


word_loop_decode_k2.launches = 0


def word_loop_decode_kn(
    feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word: int, band: int,
    n_best: int, exit_col=None, bias_g=None, logw=None,
):
    """K-best, K >= 2 (word_loop_decode_kn_pallas): (final (K, N, B), bp
    (T, K, N, B) int32 flat src*K + k).  CUDA tensors launch the kernel
    and count one in ``word_loop_decode_kn.launches``; at K = 2 it computes
    word_loop_decode_k2's result."""
    if n_best < 2:
        raise ValueError("word_loop_decode_kn: n_best >= 2 (word_loop_decode for 1-best)")
    args = (feats_tdb, a, bias, diag, arc_col, entry_col, lengths, s_word, band)
    if _on_cpu("word_loop_decode_kn", feats_tdb):
        return word_loop_decode_plain(*args, n_best, exit_col, bias_g, logw)
    out = _launch("word_loop_decode_kn", *args, n_best, exit_col, bias_g, logw)
    word_loop_decode_kn.launches += 1
    return out


word_loop_decode_kn.launches = 0
