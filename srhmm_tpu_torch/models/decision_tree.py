"""Phonetic decision-tree state clustering (counterpart of
``srhmm_tpu/models/decision_tree.py``; plain numpy, a copy kept in the port
so it never imports the JAX package).

The reference ties nothing — every HMM state owns a private GMM
(struct state, hmm-full-fs/hmm_continuous_full_fs.c:62-66).  Tied-state
systems (models/tying.py) need a (unit, state) -> senone map; this module
CONSTRUCTS that map from data with the classic top-down likelihood-gain
tree clustering of Young/Odell/Woodland (HTK's tree-based state tying),
host-side in NumPy — a modeling step that runs once between a monophone
pass and tied-triphone EM, not a kernel.

Method: one tree per (center phone, state position).  All context variants
of that state start pooled at the root; nodes are split greedily by yes/no
questions about the left/right context phone ("is the left context in
{set}?"), choosing the question with the largest gain in the single-Gaussian
log-likelihood approximation

    L(c) = -1/2 * occ_c * ( D*log(2*pi) + sum_d log var_c[d] + D )

computed from pooled occupancy/first/second moments, until the best gain
falls below `min_gain` or a child's occupancy below `min_occ`.  Leaves are
senones.  Unseen triphones synthesize by answering the questions down the
tree (`ClusterResult.senone_for`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

Triphone = tuple[str, str, str]  # (left, center, right); "sil"/"" for none


@dataclass
class Question:
    name: str
    side: str  # "left" | "right"
    phones: frozenset


@dataclass
class _Node:
    question: Question | None = None  # None => leaf
    yes: "_Node | None" = None
    no: "_Node | None" = None
    senone: int = -1
    occ: float = 0.0


@dataclass
class ClusterResult:
    state_map: np.ndarray  # (P, S) int32 senone ids
    num_senones: int
    trees: dict[tuple[str, int], _Node]  # (center, state) -> root
    units: Sequence[Triphone] = field(default_factory=tuple)

    def senone_for(self, tri: Triphone, state: int) -> int:
        """Senone id for any (possibly unseen) triphone state.  Falls back to
        any tree of the same state position if the center phone is unseen."""
        root = self.trees.get((tri[1], state))
        if root is None:
            cands = [r for (c, s), r in self.trees.items() if s == state]
            if not cands:
                raise KeyError(f"no tree for state {state}")
            root = max(cands, key=lambda r: r.occ)
        node = root
        while node.question is not None:
            ctx = tri[0] if node.question.side == "left" else tri[2]
            node = node.yes if ctx in node.question.phones else node.no
        return node.senone


def default_questions(phones: Sequence[str]) -> list[Question]:
    """Singleton questions for every phone on both sides — always available
    even without a phonetic class inventory (equivalent to unconstrained
    splitting on individual context identities)."""
    qs = []
    for p in sorted(set(phones)):
        for side in ("left", "right"):
            qs.append(Question(f"{side[0].upper()}_{p}", side, frozenset([p])))
    return qs


def questions_from_classes(
    classes: Mapping[str, Sequence[str]]
) -> list[Question]:
    """Questions from a named phone-class inventory, applied to both sides."""
    qs = []
    for name, ph in classes.items():
        for side in ("left", "right"):
            qs.append(Question(f"{side[0].upper()}_{name}", side, frozenset(ph)))
    return qs


def _loglik(occ, x, xx, var_floor):
    """Single diag-Gaussian log-likelihood of pooled stats; occ scalar or
    (...,), x/xx (..., D)."""
    occ = np.asarray(occ, np.float64)
    safe = np.maximum(occ, 1e-10)
    mean = x / safe[..., None]
    var = np.maximum(xx / safe[..., None] - mean * mean, var_floor)
    D = x.shape[-1]
    return -0.5 * occ * (D * np.log(2 * np.pi) + np.log(var).sum(-1) + D)


def cluster_states(
    units: Sequence[Triphone],
    occ: np.ndarray,  # (P, S) state occupancies
    x: np.ndarray,  # (P, S, D) sum of gamma * x
    xx: np.ndarray,  # (P, S, D) sum of gamma * x^2 (diag)
    questions: Sequence[Question] | None = None,
    *,
    min_occ: float = 100.0,
    min_gain: float = 350.0,
    max_senones: int | None = None,
    var_floor: float = 1.0e-5,
) -> ClusterResult:
    """Build the (unit, state) -> senone map by tree clustering.

    units[p] is the triphone label of unit p; statistics are per (unit,
    state) single-Gaussian moments (from a monophone-alignment E-step —
    see `state_stats_from_suffstats`).  Returns contiguous senone ids.
    """
    units = [tuple(u) for u in units]
    P, S = occ.shape
    assert len(units) == P, (len(units), P)
    occ = np.asarray(occ, np.float64)
    x = np.asarray(x, np.float64)
    xx = np.asarray(xx, np.float64)
    if questions is None:
        ctx = [u[0] for u in units] + [u[2] for u in units]
        questions = default_questions(ctx)

    state_map = np.full((P, S), -1, np.int32)
    trees: dict[tuple[str, int], _Node] = {}
    next_id = 0

    # candidate splits evaluated lazily: (negative gain, tie, node, members,
    # question, yes_mask) in a best-first queue so max_senones keeps the
    # globally best splits
    import heapq

    heap: list = []
    counter = 0

    def best_split(members: np.ndarray, s: int):
        """members: int unit indices.  Returns (gain, question, yes_mask)."""
        mo, mx, mxx = occ[members, s], x[members, s], xx[members, s]
        parent = _loglik(mo.sum(), mx.sum(0), mxx.sum(0), var_floor)
        best = (0.0, None, None)
        for q in questions:
            side = 0 if q.side == "left" else 2
            yes = np.fromiter(
                (units[int(m)][side] in q.phones for m in members),
                bool,
                len(members),
            )
            oy, on = mo[yes].sum(), mo[~yes].sum()
            if oy < min_occ or on < min_occ:
                continue
            ly = _loglik(oy, mx[yes].sum(0), mxx[yes].sum(0), var_floor)
            ln = _loglik(on, mx[~yes].sum(0), mxx[~yes].sum(0), var_floor)
            gain = float(ly + ln - parent)
            if gain > best[0]:
                best = (gain, q, yes)
        return best

    def push(node: _Node, members: np.ndarray, s: int):
        nonlocal counter
        gain, q, yes = best_split(members, s)
        if q is not None and gain >= min_gain:
            heapq.heappush(heap, (-gain, counter, node, members, s, q, yes))
            counter += 1

    # roots: one per (center, state) with any occupancy
    roots: list[tuple[_Node, np.ndarray, int]] = []
    centers = sorted({u[1] for u in units})
    for c in centers:
        members_c = np.asarray([i for i, u in enumerate(units) if u[1] == c])
        for s in range(S):
            node = _Node(occ=float(occ[members_c, s].sum()))
            trees[(c, s)] = node
            roots.append((node, members_c, s))
            push(node, members_c, s)

    leaves: dict[int, tuple[_Node, np.ndarray, int]] = {
        id(n): (n, m, s) for n, m, s in roots
    }
    while heap:
        if max_senones is not None and len(leaves) >= max_senones:
            break
        _ng, _c, node, members, s, q, yes = heapq.heappop(heap)
        node.question = q
        node.yes = _Node(occ=float(occ[members[yes], s].sum()))
        node.no = _Node(occ=float(occ[members[~yes], s].sum()))
        del leaves[id(node)]
        leaves[id(node.yes)] = (node.yes, members[yes], s)
        leaves[id(node.no)] = (node.no, members[~yes], s)
        push(node.yes, members[yes], s)
        push(node.no, members[~yes], s)

    # no stale heap entries: a node is pushed at most once (when it becomes
    # a leaf) and split at most once
    for node, members, s in leaves.values():
        node.senone = next_id
        state_map[members, s] = next_id
        next_id += 1

    assert (state_map >= 0).all()
    return ClusterResult(
        state_map=state_map, num_senones=next_id, trees=trees, units=tuple(units)
    )


def _host(a) -> np.ndarray:
    """A float64 numpy copy of a torch tensor (any device) or array."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def state_stats_from_suffstats(stats) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(occ, x, xx) per (unit, state) from embedded-EM SuffStats with a
    leading P axis (train/embedded.py), pooling mixtures to one Gaussian.
    Full-covariance xx keeps only the diagonal — the clustering criterion is
    diagonal by construction (HTK does the same)."""
    den = _host(stats.den_mix)  # (P, S)
    st = stats.streams[0]
    x_m = _host(st.x)  # (P, S, M, D)
    xx = _host(st.xx)
    if xx.ndim == x_m.ndim + 1:  # full: (P, S, M, D, D)
        xx = np.diagonal(xx, axis1=-2, axis2=-1)
    return den, x_m.sum(-2), xx.sum(-2)  # pool mixtures
