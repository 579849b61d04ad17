"""Continuous recognition: composed-HMM token passing, N-best decode
(counterpart of ``srhmm_tpu/decode/continuous.py``; same names, same
contracts).

Word models are composed into a decoding graph and a frame-synchronous
Viterbi runs over the composed state space:

* ``compose_word_loop`` / ``compose_sequence`` build a dense
  (S_tot, S_tot) graph (``ComposedGraph``); ``token_passing`` runs the
  K-best Viterbi over it, one Python loop step per frame;
* ``compose_word_loop_blocks`` factors the word loop into (W, S, S)
  within-word blocks and a (W, W) exit->entry arc matrix (``BlockGraph``);
  ``token_passing_blocks`` is the per-utterance engine of
  ``decode_continuous``;
* ``decode_continuous_batch`` decodes a whole padded batch through the
  hand-written word-loop kernel (``ops/kernels/decode.py``, CUDA on a card,
  its plain twin on the CPU) and one batched backtrace on the device.

Backpointers are flat ``state * K + k`` indices, as in the JAX package.
``jax.lax.top_k`` is stable (the lower index wins a tie) and the K-best
engines meet many equal ``-inf`` candidates, so every top-k here is the
stable ``_top_k`` (a stable descending sort, then the first K), never
``torch.topk``.

Routing differs from the JAX package in one way: whether a batch rides
the kernel is decided before any launch by ``_fused_decode_eligible``
(covariance types, stream count, K against the kernel's compiled maximum,
the kernel's shared memory at this N and K).  An eligible CUDA batch
reaches the kernel or raises; nothing is retried on another engine after
an error.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..models.gmm_hmm import DIAG, FULL, GmmHmm, GmmStream
from ..ops.emission import log_state_emission
from ..ops.kernels import decode as kdecode
from ..ops.kernels.common import NEG_INF
from ..ops.kernels.scoring import pack_vocab_constants


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _top_k(x: torch.Tensor, k: int):
    """Top k along the last axis, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _log_trans_np(trans) -> np.ndarray:
    trans = _host(trans)
    with np.errstate(divide="ignore"):
        return np.where(trans > 0, np.log(np.maximum(trans, 1e-300)), -np.inf)


def _lm_arcs(W: int, lm_logprobs, lm_initial):
    """(arc_lm (W, W), initial (W,)) from a unigram / bigram LM."""
    if lm_logprobs is None:
        lm_logprobs = np.full(W, -np.log(W))
    lm_logprobs = np.asarray(lm_logprobs, dtype=np.float64)
    if lm_logprobs.ndim == 1:
        arc_lm = np.broadcast_to(lm_logprobs, (W, W))
        initial = lm_logprobs if lm_initial is None else np.asarray(lm_initial)
    elif lm_logprobs.shape == (W, W):
        arc_lm = lm_logprobs
        initial = np.full(W, -np.log(W)) if lm_initial is None else np.asarray(lm_initial)
    else:
        raise ValueError(f"lm_logprobs must be (W,) or (W, W) for W={W}, got {lm_logprobs.shape}")
    return arc_lm, initial


def _words_of(vocab: GmmHmm) -> tuple:
    return tuple(vocab.word) if isinstance(vocab.word, tuple) else ()


@dataclass
class ComposedGraph:
    """A decoding graph over the composed state space of a stacked vocab.

    log_trans: (S_tot, S_tot) float64; state_to_word: (S_tot,) int32;
    entry_states / exit_states: int32 composed-state ids; log_entry:
    (S_tot,) float64 initial scores (-inf off the entry states)."""

    log_trans: torch.Tensor
    state_to_word: torch.Tensor
    entry_states: torch.Tensor
    exit_states: torch.Tensor
    log_entry: torch.Tensor
    words: tuple = ()


def compose_word_loop(
    vocab: GmmHmm,
    lm_logprobs=None,
    exit_logprob: float = np.log(0.1),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial=None,
) -> ComposedGraph:
    """Word-loop graph: every word's left-right HMM, with an arc from each
    word's final state to every word's entry state.  lm_logprobs: None
    (uniform), (W,) unigram or (W, W) bigram log P(next | prev); lm_scale
    multiplies every LM score; word_insertion_penalty is added on every
    exit->entry arc; lm_initial: optional (W,) first-word log-probs
    (default: the unigram, or uniform for a bigram)."""
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    S_tot = W * S
    arc_lm, initial = _lm_arcs(W, lm_logprobs, lm_initial)
    lt = np.full((S_tot, S_tot), -np.inf)
    log_word_trans = _log_trans_np(vocab.trans)
    for w in range(W):
        lt[w * S : (w + 1) * S, w * S : (w + 1) * S] = log_word_trans[w]
    entry = np.arange(W) * S
    exit_ = np.arange(W) * S + (S - 1)
    for w in range(W):
        lt[exit_[w], entry] = np.maximum(
            lt[exit_[w], entry], exit_logprob + lm_scale * arc_lm[w] + word_insertion_penalty
        )
    log_entry = np.full(S_tot, -np.inf)
    log_entry[entry] = lm_scale * initial
    dev = vocab.trans.device
    return ComposedGraph(
        log_trans=torch.as_tensor(lt, device=dev),
        state_to_word=torch.as_tensor(np.repeat(np.arange(W, dtype=np.int32), S), device=dev),
        entry_states=torch.as_tensor(entry.astype(np.int32), device=dev),
        exit_states=torch.as_tensor(exit_.astype(np.int32), device=dev),
        log_entry=torch.as_tensor(log_entry, device=dev),
        words=_words_of(vocab),
    )


def compose_sequence(vocab: GmmHmm, transcript: list[int]) -> ComposedGraph:
    """Left-to-right concatenation of the models in ``transcript`` (ids
    into the stacked vocab): unit k's final state feeds unit k+1's entry
    with the final state's self-loop mass.  The forced-alignment graph."""
    S = vocab.trans.shape[-1]
    L = len(transcript)
    S_tot = L * S
    logt = _log_trans_np(vocab.trans)
    lt = np.full((S_tot, S_tot), -np.inf)
    for k, w in enumerate(transcript):
        lt[k * S : (k + 1) * S, k * S : (k + 1) * S] = logt[w]
        if k + 1 < L:
            lt[k * S + S - 1, (k + 1) * S] = logt[w][S - 1, S - 1]
    log_entry = np.full(S_tot, -np.inf)
    log_entry[0] = 0.0
    dev = vocab.trans.device
    return ComposedGraph(
        log_trans=torch.as_tensor(lt, device=dev),
        state_to_word=torch.as_tensor(np.repeat(np.asarray(transcript, dtype=np.int32), S), device=dev),
        entry_states=torch.as_tensor((np.arange(L) * S).astype(np.int32), device=dev),
        exit_states=torch.as_tensor((np.arange(L) * S + S - 1).astype(np.int32), device=dev),
        log_entry=torch.as_tensor(log_entry, device=dev),
        words=_words_of(vocab),
    )


def composed_emissions(vocab: GmmHmm, frames) -> torch.Tensor:
    """(T, W*S) emission log-likelihoods of every (word, state): frames
    (T, D), or a tuple of per-stream (T, D_p) tensors whose per-stream
    emissions sum in log space."""
    per_word = log_state_emission(frames, vocab.streams)  # (T, W, S)
    T, W, S = per_word.shape
    return per_word.reshape(T, W * S)


def emissions_for_graph(vocab: GmmHmm, graph: ComposedGraph, frames) -> torch.Tensor:
    """(T, S_tot) emissions for any composed graph: computed once per
    word, then gathered by state_to_word (sequence graphs repeat units)."""
    per_word = log_state_emission(frames, vocab.streams)  # (T, W, S)
    S = per_word.shape[-1]
    n_states = graph.state_to_word.shape[0]
    s2w = graph.state_to_word.to(per_word.device).long()
    within = torch.arange(n_states, device=per_word.device) % S
    return per_word[:, s2w, within]


def token_passing(
    graph: ComposedGraph,
    log_b: torch.Tensor,
    length=None,
    n_best: int = 1,
    beam: float | None = None,
):
    """Frame-synchronous K-best Viterbi over the dense composed graph.

    log_b: (T, S_tot).  Returns (scores (S_tot, K) at the last valid frame,
    backpointers (T-1, S_tot, K) int32 flat from_state*K + k).  beam:
    tokens more than ``beam`` below the frame's best are set to -inf.
    Frames t >= length keep the carry and get identity pointers."""
    T, S_tot = log_b.shape
    K = n_best
    dev = log_b.device
    init = graph.log_entry.to(dev)[:, None] + log_b[0][:, None]
    carry = torch.cat([init, torch.full((S_tot, K - 1), -math.inf, dtype=init.dtype, device=dev)], 1)
    id_bp = (torch.arange(S_tot, device=dev)[:, None] * K + torch.arange(K, device=dev)[None, :]).int()
    lt = graph.log_trans.to(dev)
    bps = []
    for t in range(1, T):
        cand = (carry[:, :, None] + lt[:, None, :]).reshape(S_tot * K, S_tot)
        top, idx = _top_k(cand.T, K)  # (S_to, K)
        new = top + log_b[t][:, None]
        if beam is not None:
            new = torch.where(new >= new.max() - beam, new, -math.inf)
        bp = idx.int()
        if length is not None:
            keep = torch.as_tensor(t < length, device=dev)
            new = torch.where(keep, new, carry)
            bp = torch.where(keep, bp, id_bp)
        carry = new
        bps.append(bp)
    bps = torch.stack(bps) if bps else torch.empty((0, S_tot, K), dtype=torch.int32, device=dev)
    return carry, bps


@dataclass
class BlockGraph:
    """Block-structured word loop: (W, S, S) within-word log-transitions,
    a (W, W) exit->entry arc matrix (LM and penalty included), (W,) initial
    scores at the entry states, and optional (W,) per-word exit states
    (heterogeneous vocabularies stacked by pad_stack_models; None = S-1)."""

    log_trans: torch.Tensor
    arc: torch.Tensor
    log_entry: torch.Tensor
    words: tuple = ()
    exit_states: torch.Tensor | None = None


def compose_word_loop_blocks(
    vocab: GmmHmm,
    lm_logprobs=None,
    exit_logprob: float = np.log(0.1),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial=None,
    final_states=None,
) -> BlockGraph:
    """Block-structured equivalent of compose_word_loop (same LM
    arguments); final_states: optional (W,) real final state per word."""
    W = vocab.trans.shape[0]
    arc_lm, initial = _lm_arcs(W, lm_logprobs, lm_initial)
    dev = vocab.trans.device
    arc = exit_logprob + lm_scale * arc_lm + word_insertion_penalty
    return BlockGraph(
        log_trans=torch.as_tensor(_log_trans_np(vocab.trans), device=dev),
        arc=torch.as_tensor(arc, device=dev),
        log_entry=torch.as_tensor(lm_scale * initial, device=dev),
        words=_words_of(vocab),
        exit_states=(
            None if final_states is None
            else torch.as_tensor(_host(final_states).astype(np.int32), device=dev)
        ),
    )


def token_passing_blocks(
    graph: BlockGraph,
    log_b: torch.Tensor,
    length=None,
    n_best: int = 1,
    beam: float | None = None,
):
    """Frame-synchronous K-best Viterbi over the block-structured word loop.

    log_b: (T, W*S).  Returns (scores (W*S, K) at the last valid frame,
    backpointers (T-1, W*S, K) int32 flat (w*S+s)*K + k): the contract of
    token_passing, at O(W S^2 K + W^2 K) per frame."""
    T = log_b.shape[0]
    W, S, _ = graph.log_trans.shape
    K = n_best
    dev, dtype = log_b.device, log_b.dtype
    lb = log_b.reshape(T, W, S)
    carry = torch.full((W, S, K), -math.inf, dtype=dtype, device=dev)
    carry[:, 0, 0] = (graph.log_entry.to(dev) + lb[0, :, 0]).to(dtype)
    flat_ids = (
        (torch.arange(W * S, device=dev)[:, None] * K + torch.arange(K, device=dev)[None, :])
        .int().reshape(W, S, K)
    )
    lt = graph.log_trans.to(device=dev, dtype=dtype)
    arc = graph.arc.to(device=dev, dtype=dtype)
    if graph.exit_states is None:
        exit_off = torch.full((W,), S - 1, dtype=torch.long, device=dev)
    else:
        exit_off = graph.exit_states.to(dev).long()
    wids = torch.arange(W, device=dev)
    bps = []
    for t in range(1, T):
        # within-word: candidates into (w, j) from (w, i, k)
        cand_in = (carry[:, :, :, None] + lt[:, :, None, :]).reshape(W, S * K, S)
        top_in, idx_in = _top_k(cand_in.transpose(1, 2), K)  # (W, j, K)
        bp_in = ((wids[:, None, None] * S + idx_in // K) * K + idx_in % K).int()
        # cross-word: every word's exit tokens into every entry state
        exit_tok = carry[wids, exit_off, :]  # (W, K)
        cross = (exit_tok[:, None, :] + arc[:, :, None]).transpose(0, 1).reshape(W, W * K)
        top_x, idx_x = _top_k(cross, K)
        w_src = idx_x // K
        bp_x = ((w_src * S + exit_off[w_src]) * K + idx_x % K).int()
        # merge at entry state 0: within-word K first, then cross-word K
        merged = torch.cat([top_in[:, 0, :], top_x], 1)
        merged_bp = torch.cat([bp_in[:, 0, :], bp_x], 1)
        m_top, m_idx = _top_k(merged, K)
        new = top_in.clone()
        new[:, 0, :] = m_top
        new = new + lb[t][:, :, None]
        bp = bp_in.clone()
        bp[:, 0, :] = torch.gather(merged_bp, 1, m_idx)
        if beam is not None:
            new = torch.where(new >= new.max() - beam, new, -math.inf)
        if length is not None:
            keep = torch.as_tensor(t < length, device=dev)
            new = torch.where(keep, new, carry)
            bp = torch.where(keep, bp, flat_ids)
        carry = new
        bps.append(bp)
    bps = torch.stack(bps) if bps else torch.empty((0, W, S, K), dtype=torch.int32, device=dev)
    return carry.reshape(W * S, K), bps.reshape(T - 1, W * S, K)


def backtrace_path_device(backpointers: torch.Tensor, state, k) -> torch.Tensor:
    """Follow flat (state*K + k) pointers from the final (state, k) token
    through the (T-1, S_tot, K) lattice on its device: the (T,) state
    path, without a host transfer of the lattice."""
    K = backpointers.shape[-1]
    dev = backpointers.device
    s = torch.as_tensor(state, device=dev).long()
    kk = torch.as_tensor(k, device=dev).long()
    rest = [None] * backpointers.shape[0]
    for t in range(backpointers.shape[0] - 1, -1, -1):
        rest[t] = s
        flat = backpointers[t, s, kk].long()
        s, kk = flat // K, flat % K
    return torch.stack([s] + rest).int()


def backtrace_words(graph: ComposedGraph, final_scores, backpointers, length: int, rank: int = 0):
    """The rank-th best word sequence of a token-passing run: (score,
    word_ids, word_spans) with (start, end) frame spans, ending in any
    word's exit state."""
    final_scores = _host(final_scores)
    backpointers = _host(backpointers)
    exit_states = _host(graph.exit_states)
    s2w = _host(graph.state_to_word)
    K = final_scores.shape[1]
    ends = [(final_scores[s, k], s, k) for s in exit_states for k in range(K)]
    ends.sort(key=lambda x: -x[0])
    score, state, k = ends[min(rank, len(ends) - 1)]

    path = [state]
    for t in range(length - 2, -1, -1):
        flat = backpointers[t, state, k]
        state, k = int(flat) // K, int(flat) % K
        path.append(state)
    path.reverse()

    entry_set = set(int(s) for s in _host(graph.entry_states))
    exit_set = set(int(s) for s in exit_states)
    words, spans = [], []
    start = 0
    for t in range(1, length):
        # a word boundary is exactly an exit->entry arc
        if path[t] in entry_set and path[t - 1] in exit_set and path[t] != path[t - 1]:
            words.append(int(s2w[path[start]]))
            spans.append((start, t))
            start = t
    words.append(int(s2w[path[start]]))
    spans.append((start, length))
    return float(score), words, spans


def _words_from_path(path, S: int, exit_off=None):
    """Word boundaries of a composed-state path: an exit -> entry(0)
    crossing.  exit_off: the exit state within each word, a scalar
    (default S - 1) or a (W,) per-word array."""
    if exit_off is None:
        exit_off = S - 1
    p = _host(path)
    crossed = np.zeros(len(p), dtype=bool)
    exit_off = np.asarray(exit_off)
    if len(p) > 1:
        prev_exit = exit_off[p[:-1] // S] if exit_off.ndim else exit_off
        crossed[1:] = (p[1:] % S == 0) & (p[:-1] % S == prev_exit) & (p[1:] != p[:-1])
    starts = np.flatnonzero(np.concatenate([[True], crossed[1:]]))
    ends = np.append(starts[1:], len(p))
    words = (p[starts] // S).astype(int).tolist()
    return words, list(zip(starts.tolist(), ends.tolist()))


def decode_continuous(
    vocab: GmmHmm,
    frames,
    lm_logprobs=None,
    n_best: int = 1,
    exit_logprob: float = float(np.log(0.1)),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial=None,
    engine: str = "blocks",
    final_states=None,
):
    """End-to-end continuous decode of one utterance: compose the word
    loop, token-pass, return up to n_best (score, word_ids, spans)
    hypotheses with distinct word sequences, best first.  engine: "blocks"
    (default; token_passing_blocks and a device backtrace) or "dense"
    (token_passing over the dense graph)."""
    kwargs = dict(
        lm_logprobs=lm_logprobs, exit_logprob=exit_logprob, lm_scale=lm_scale,
        word_insertion_penalty=word_insertion_penalty, lm_initial=lm_initial,
    )
    log_b = composed_emissions(vocab, frames)
    T = log_b.shape[0]
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]

    if engine == "dense":
        if final_states is not None:
            raise ValueError("decode_continuous: heterogeneous final_states require the blocks engine")
        graph = compose_word_loop(vocab, **kwargs)
        final, bps = token_passing(graph, log_b, n_best=n_best)
        final, bps = _host(final), _host(bps)
        out, seen = [], set()
        for r in range(n_best * len(graph.exit_states)):
            score, words, spans = backtrace_words(graph, final, bps, T, rank=r)
            key = tuple(words)
            if key not in seen and np.isfinite(score):
                seen.add(key)
                out.append((score, words, spans))
            if len(out) >= n_best:
                break
        return out

    graph = compose_word_loop_blocks(vocab, final_states=final_states, **kwargs)
    final, bps = token_passing_blocks(graph, log_b, n_best=n_best)
    fin = _host(final)  # (W*S, K); bps stays on the device for the backtrace
    K = fin.shape[1]
    ex_off = np.full(W, S - 1) if final_states is None else _host(final_states)
    exit_states = np.arange(W) * S + ex_off
    ends = [(fin[s, k], s, k) for s in exit_states for k in range(K)]
    ends.sort(key=lambda x: -x[0])
    out, seen = [], set()
    for score, s, k in ends:
        if not np.isfinite(score):
            continue
        path = _host(backtrace_path_device(bps, int(s), int(k)))
        words, spans = _words_from_path(path[:T], S, exit_off=ex_off)
        key = tuple(words)
        if key not in seen:
            seen.add(key)
            out.append((float(score), words, spans))
        if len(out) >= n_best:
            break
    return out


# ---------------------------------------------------------------------------
# the batched path: every utterance of a padded batch in one kernel launch
# ---------------------------------------------------------------------------


def backtrace_batch_device(bps: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
    """Batched backtrace through the kernel's (T, W*S, B) source-row
    pointers from each utterance's final state: one gather per frame on
    the lattice's device.  bps[0] is the identity frame and rows at
    t >= length are identities, so padded frames keep the state.
    Returns the (T, B) int32 state paths."""
    T, _, B = bps.shape
    dev = bps.device
    cols = torch.arange(B, device=dev)
    s = states.to(dev).long()
    out = [None] * T
    for t in range(T - 1, 0, -1):
        out[t] = s
        s = bps[t][s, cols].long()
    out[0] = s
    return torch.stack(out).int()


def _pad_vocab_states(vocab: GmmHmm, s_pad: int) -> GmmHmm:
    """Every word of a stacked vocabulary padded to s_pad states: filler
    states are unreachable (self-loop 1.0, no arcs from real states) with
    benign unit-weight mixture-0 emissions (the pad_stack_models recipe);
    the bigram path pads to s_word % 8 == 0 as the JAX package does, so
    both report the same padded state space."""
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    assert s_pad >= S
    dev = vocab.trans.device
    dtype = _host(vocab.trans).dtype
    trans = np.zeros((W, s_pad, s_pad), dtype)
    trans[:, :S, :S] = _host(vocab.trans)
    for s in range(S, s_pad):
        trans[:, s, s] = 1.0
    new_streams = []
    for st in vocab.streams:
        M, D = st.num_mixtures, st.dim
        w = np.zeros((W, s_pad, M), dtype)
        w[:, :S] = _host(st.weights)
        w[:, S:, 0] = 1.0
        mu = np.zeros((W, s_pad, M, D), dtype)
        mu[:, :S] = _host(st.means)
        det = np.ones((W, s_pad, M), dtype)
        det[:, :S] = _host(st.det)
        ld = np.zeros((W, s_pad, M), dtype)
        ld[:, :S] = _host(st.log_abs_det())
        if st.cov_type == FULL:
            ic = np.tile(np.eye(D, dtype=dtype), (W, s_pad, M, 1, 1))
        else:
            ic = np.ones((W, s_pad, M, D), dtype)
        ic[:, :S] = _host(st.inv_cov)
        new_streams.append(
            GmmStream(weights=w, means=mu, inv_cov=ic, det=det, cov_type=st.cov_type, log_det=ld).to(dev)
        )
    return GmmHmm(trans=torch.as_tensor(trans, device=dev), streams=new_streams, word=vocab.word)


def _as_batches(batch) -> tuple:
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


def _is_unigram(graph: BlockGraph) -> bool:
    arc = _host(graph.arc).astype(np.float64)
    return bool(np.allclose(arc, arc[0:1]))


def _bigram_s_eff(S: int) -> int:
    return -(-S // 8) * 8


def _fused_decode_eligible(vocab: GmmHmm, batch, graph: BlockGraph, n_best: int) -> bool:
    """Whether a batch rides the word-loop kernel, from facts known before
    any launch: homogeneous diagonal or full covariance, at most
    kdecode.MAX_STREAMS streams and one feature batch per stream, K within
    the kernel's compiled maximum, feature dims within its bound, and the
    shared memory of a block at this N (padded to s_word % 8 == 0 for a
    bigram) and K.  Replaces the JAX package's VMEM gates and its
    ``except ValueError`` retries."""
    batches = _as_batches(batch)
    P = len(vocab.streams)
    if len(batches) != P:
        raise ValueError(f"decode_continuous_batch: {P} streams need {P} feature batches")
    cov_types = {st.cov_type for st in vocab.streams}
    if len(cov_types) != 1 or cov_types - {DIAG, FULL}:
        return False
    if P > kdecode.MAX_STREAMS or not 1 <= n_best <= kdecode.K_MAX:
        return False
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    bigram = not _is_unigram(graph)
    s_eff = _bigram_s_eff(S) if bigram and S % 8 else S
    return kdecode.fits(W * s_eff, W, n_best, [st.dim for st in vocab.streams], bigram)


def _fused_operands(vocab: GmmHmm, graph: BlockGraph, batches):
    """(feats, a, bias, bias_g, logw, diag, band, arc_col, entry_col,
    exit_col, lengths, s_eff) for the word-loop kernel: the JAX wrappers'
    operands without their TPU padding.  Tuples collapse to bare tensors
    for a single stream."""
    arc = _host(graph.arc).astype(np.float64)
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    unigram = _is_unigram(graph)
    s_eff = S
    if not unigram and S % 8 != 0:
        s_eff = _bigram_s_eff(S)
        vocab = _pad_vocab_states(vocab, s_eff)
    N = W * s_eff
    dev = batches[0].features.device
    P = len(batches)
    full = vocab.streams[0].cov_type == FULL
    packs = [pack_vocab_constants(vocab, torch.float32, stream=p, device=dev) for p in range(P)]
    band = packs[0][5]
    diag = packs[0][4]
    a = tuple(pk[0] for pk in packs)
    bias = tuple(pk[2] for pk in packs)
    bias_g = tuple(pk[1] for pk in packs) if full else (None,) * P
    logw = tuple(pk[3] for pk in packs) if full else (None,) * P
    feats = tuple(b.features.to(torch.float32).permute(1, 2, 0) for b in batches)  # (T, D, B) views
    if P == 1:
        feats, a, bias, bias_g, logw = feats[0], a[0], bias[0], bias_g[0], logw[0]
    entry_rows = np.arange(W) * s_eff
    if unigram:
        arc_col = np.full((N, 1), NEG_INF)
        arc_col[entry_rows, 0] = arc[0]
    else:
        arc_col = np.maximum(arc, NEG_INF)  # (W, W) bigram matrix
    entry_col = np.full((N, 1), NEG_INF)
    entry_col[entry_rows, 0] = _host(graph.log_entry).astype(np.float64)
    exit_col = None
    if s_eff != S or graph.exit_states is not None:
        off = _host(graph.exit_states) if graph.exit_states is not None else np.full(W, S - 1)
        ec = np.full((N, 1), NEG_INF)
        ec[np.arange(W) * s_eff + off, 0] = 0.0
        exit_col = torch.as_tensor(ec, dtype=torch.float32, device=dev)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    return (feats, a, bias, bias_g, logw, diag, band, f32(arc_col), f32(entry_col), exit_col,
            batches[0].lengths.to(dev), s_eff)


def _run_fused(wrapper, vocab, graph, batch, **extra):
    (feats, a, bias, bias_g, logw, diag, band, arc_col, entry_col, exit_col, lengths,
     s_eff) = _fused_operands(vocab, graph, _as_batches(batch))
    final, bps = wrapper(feats, a, bias, diag, arc_col, entry_col, lengths, s_word=s_eff, band=band,
                         exit_col=exit_col, bias_g=bias_g, logw=logw, **extra)
    return final, bps, s_eff


def token_passing_fused(vocab: GmmHmm, graph: BlockGraph, batch):
    """Batched 1-best word-loop Viterbi through ``word_loop_decode``:
    emissions, the banded within-word recursion and the cross-word merge
    (unigram or genuine bigram arcs) for every utterance in one launch.
    batch: an UtteranceBatch, or a tuple of per-stream batches.  Bigram
    vocabularies whose state count is not a multiple of 8 are padded with
    unreachable filler states (as in the JAX package), so outputs are in
    the padded state space s_eff.  Returns (final (W*s_eff, B), bps
    (T, W*s_eff, B) int32 source rows, s_eff)."""
    return _run_fused(kdecode.word_loop_decode, vocab, graph, batch)


def token_passing_fused_k2(vocab: GmmHmm, graph: BlockGraph, batch):
    """n_best=2 through ``word_loop_decode_k2``: (final (2, W*s_eff, B),
    bps (T, 2, W*s_eff, B) int32 flat src*2 + k, s_eff)."""
    return _run_fused(kdecode.word_loop_decode_k2, vocab, graph, batch)


def token_passing_fused_kn(vocab: GmmHmm, graph: BlockGraph, batch, n_best: int):
    """Any n_best = K through ``word_loop_decode_kn``: (final (K, W*s_eff,
    B), bps (T, K, W*s_eff, B) int32 flat src*K + k, s_eff)."""
    return _run_fused(kdecode.word_loop_decode_kn, vocab, graph, batch, n_best=n_best)


def _per_utterance(vocab, batches, n_best, kwargs, final_states=None):
    """The per-utterance block engine over a batch: (score, words, spans)
    per utterance for n_best=1, else a list of up to n_best of them."""
    lengths = _host(batches[0].lengths)
    out = []
    for b in range(batches[0].features.shape[0]):
        L = int(lengths[b])
        if L <= 0:
            out.append((float("-inf"), [], []) if n_best == 1 else [])
            continue
        frames = tuple(bb.features[b, :L] for bb in batches)
        hyp = decode_continuous(
            vocab, frames if len(batches) > 1 else frames[0], n_best=n_best,
            final_states=final_states, **kwargs,
        )
        out.append(hyp[0] if n_best == 1 else hyp)
    return out


def _one_best(vocab, graph, batches, exit_off):
    """n_best=1 on the kernel: the best exit per utterance, one batched
    backtrace, word boundaries on the host."""
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    final, bps, s_eff = token_passing_fused(vocab, graph, batches if len(batches) > 1 else batches[0])
    fin = _host(final)  # (W*s_eff, B)
    exit_rows = np.arange(W) * s_eff + exit_off
    best_states = exit_rows[np.argmax(fin[exit_rows], axis=0)]
    paths = _host(backtrace_batch_device(bps, torch.as_tensor(best_states, device=bps.device)))
    lengths = _host(batches[0].lengths)
    out = []
    for b in range(fin.shape[1]):
        L = int(lengths[b])
        if L <= 0:
            out.append((float("-inf"), [], []))
            continue
        words, spans = _words_from_path(paths[:L, b], s_eff, exit_off=exit_off)
        out.append((float(fin[best_states[b], b]), words, spans))
    return out


def decode_continuous_batch(
    vocab: GmmHmm,
    batch,
    lm_logprobs=None,
    exit_logprob: float = float(np.log(0.1)),
    lm_scale: float = 1.0,
    word_insertion_penalty: float = 0.0,
    lm_initial=None,
    n_best: int = 1,
    final_states=None,
):
    """Batched continuous decode: every utterance of a padded batch in one
    launch of the word-loop kernel plus one batched device backtrace, when
    ``_fused_decode_eligible`` says so; otherwise the per-utterance block
    engine.  n_best=1 returns a list over utterances of (score, word_ids,
    word_spans); n_best>=2 a list over utterances of up to n_best such
    tuples, best first (distinct word sequences).

    Multi-stream vocabularies take ``batch`` as a tuple of per-stream
    UtteranceBatch objects (shared lengths).  As in the JAX package, the
    multi-stream paths do not take ``final_states``: n_best=1 reads every
    word's exit at state S-1."""
    kwargs = dict(
        lm_logprobs=lm_logprobs, exit_logprob=exit_logprob, lm_scale=lm_scale,
        word_insertion_penalty=word_insertion_penalty, lm_initial=lm_initial,
    )
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    if isinstance(batch, (tuple, list)) and len(vocab.streams) > 1:
        batches = tuple(batch)
        if n_best >= 2:
            return _decode_batch_kn(vocab, batches, n_best, kwargs)
        if n_best == 1:
            graph = compose_word_loop_blocks(vocab, **kwargs)
            if _fused_decode_eligible(vocab, batches, graph, 1):
                return _one_best(vocab, graph, batches, S - 1)
        return _per_utterance(vocab, batches, n_best, kwargs)
    if n_best >= 2:
        return _decode_batch_kn(vocab, _as_batches(batch), n_best, kwargs, final_states)
    if n_best != 1:
        raise ValueError("decode_continuous_batch: n_best must be >= 1")
    batches = _as_batches(batch)
    graph = compose_word_loop_blocks(vocab, final_states=final_states, **kwargs)
    if not _fused_decode_eligible(vocab, batches, graph, 1):
        return _per_utterance(vocab, batches, 1, kwargs, final_states)
    ex_off = np.full(W, S - 1) if final_states is None else _host(final_states)
    return _one_best(vocab, graph, batches, ex_off)


def _backtrace_ids(bps: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Follow R token ids per utterance through the (T, K, N, B) flat
    src*K + k pointers.  ids: (R, B) flat n*K + k.  Returns (T, B, R)."""
    T, K, N, B = bps.shape
    # (B, T, N*K) with the flat id innermost: the kernel's own layout (a
    # free view), a copy for a contiguous (T, K, N, B) lattice
    flat = bps.permute(3, 0, 2, 1).reshape(B, T, N * K)
    s = ids.T.to(bps.device).long().contiguous()  # (B, R)
    out = [None] * T
    for t in range(T - 1, 0, -1):
        out[t] = s
        s = torch.gather(flat[:, t, :], 1, s).long()
    out[0] = s
    return torch.stack(out).int()


def _decode_batch_kn(vocab, batches, n_best, kwargs, final_states=None):
    """n_best=K on the kernel: rank every exit token, backtrace all K*W of
    them in one batched pass, dedupe word sequences on the host (the
    per-utterance engine's rule)."""
    K = n_best
    graph = compose_word_loop_blocks(vocab, final_states=final_states, **kwargs)
    W, S = vocab.trans.shape[0], vocab.trans.shape[-1]
    if not _fused_decode_eligible(vocab, batches, graph, K):
        return _per_utterance(vocab, batches, K, kwargs, final_states)
    one = batches if len(batches) > 1 else batches[0]
    if K == 2:
        final, bps, s_eff = token_passing_fused_k2(vocab, graph, one)
    else:
        final, bps, s_eff = token_passing_fused_kn(vocab, graph, one, n_best=K)
    N = W * s_eff
    B = final.shape[-1]
    scores_flat = final.permute(1, 0, 2).reshape(K * N, B)  # id = n*K + k
    ex = np.full(W, S - 1) if final_states is None else np.array(_host(final_states))
    row = torch.arange(K * N, device=final.device)
    ex_t = torch.as_tensor(ex, device=final.device).long()
    is_exit = ((row // K) % s_eff) == ex_t[(row // K) // s_eff]
    masked = torch.where(is_exit[:, None], scores_flat, -math.inf)
    R = K * W
    ranked = torch.argsort(-masked, dim=0, stable=True)[:R]  # (R, B)
    paths = _host(_backtrace_ids(bps, ranked))  # (T, B, R)
    sc = _host(scores_flat)
    ranked_np = _host(ranked)
    lengths = _host(batches[0].lengths)
    out = []
    for b in range(B):
        L = int(lengths[b])
        hyps, seen = [], set()
        if L > 0:
            for r in range(R):
                cid = int(ranked_np[r, b])
                score = float(sc[cid, b])
                if not np.isfinite(score):
                    break
                words, spans = _words_from_path(paths[:L, b, r] // K, s_eff, exit_off=ex)
                key = tuple(words)
                if key not in seen:
                    seen.add(key)
                    hyps.append((score, words, spans))
                if len(hyps) >= K:
                    break
        out.append(hyps)
    return out
