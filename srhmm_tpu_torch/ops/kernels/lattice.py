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
last-row mode and the Viterbi kernel of ops/kernels/forward.py; the three
kernels share a launch shape (``_lane_block``: an utterance's states on
adjacent lanes, four recursion warps and a memory warp a block, two for the
Viterbi) up to LANE_STATES = 64 states.  Past them, up to MAX_STATES =
4096 (the wrappers refuse more), all three run the group mode
(``group_block``: a group of utterances a cluster of blocks, each block
owning a slice of the states for the whole group, the previous row shared
through distributed shared memory, the transitions packed or streamed in
tiles that serve the whole group; the Viterbi its max-plus kind, its shape
from ``viterbi_block``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .common import NEG_INF, SMEM_LIMIT, aligned16, check_launch, device_args, on_cpu, require_float32, sm_count

LANE_STATES = 64  # csrc/lattice.cu kMaxStates: the lane path
MAX_STATES = 4096  # csrc/lattice.cu kMaxBlockStates: the group mode
# csrc/lattice.cu's group mode (the three kernels past LANE_STATES)
GROUP_CLUSTERS = (1, 2, 4, 8, 16)  # blocks a cluster (16: the non-portable size)
# clusters of each size an H100 (132 SMs) runs at once at one block an SM: its
# GPCs hold 7 of 16, 15 of 8, 30 of 4 (cudaOccupancyMaxActiveClusters through
# srhmm_lattice_group_clusters, NVIDIA H100 80GB HBM3), the same for the
# forward's instances and the Viterbi's at their shapes
GROUP_CLUSTERS_AT_ONCE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
GROUP_SFU_EXPS_PER_S = 16 * 1.755e9  # an SM's exponentials a second (MUFU.EX2, 16 a clock)
# an SM's Viterbi steps a second: an add, a compare and two selects a (source,
# key, utterance), at 128 lanes' instructions a clock
GROUP_MAXPLUS_PER_S = 128 / 4 * 1.755e9
GROUP_L2_BYTES_PER_S = 5.5e12  # the card's L2 reads a second (an estimate): the dense tiles' source
GROUP_RING = 8  # kGroupRing: frames of log b an owner keeps in flight
GROUP_STAGES = 2  # kGroupStages: transition tiles in flight (the streamed route)
GROUP_SHARES = (32, 16, 8)  # sources a thread takes from a tile, largest first (kGroupChunk multiples)
GROUP_THREADS = 512  # the threads a cluster block's register tiles aim at
GROUP_STREAM_THREADS = 640  # kGroupStreamThreads: a cluster block's threads at most
GROUP_MAX_THREADS = 1024  # kGroupMaxThreads: a one-block group's threads at most
GROUP_MAX_OWNED = 16  # kGroupMaxOwned: (utterance, key) pairs a thread owns at most
SINGLE_BLOCK_STATES = 128  # up to here one block takes every key of a group
FORWARD_REC_WARPS = 4  # csrc/lattice.cu kFwdRecWarps: a block's recursion warps
VITERBI_MEMORY_WARPS = 2  # csrc/lattice.cu kVitThreads (the forward and backward have one)
FORWARD_TILES = (32, 16, 8, 4, 2, 1)  # frames a tile, largest first


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
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.srhmm_lattice_forward.restype = c_int
    # log_b lt per_row lengths out, layout T S B G U TT vec device, stream
    lib.srhmm_lattice_forward.argtypes = [c_ptr, c_ptr, c_int, c_ptr, c_ptr] + [c_int] * 9 + [c_ptr]
    lib.srhmm_lattice_backward.restype = c_int
    # log_b lt lengths out, T S B G U TT vec device, stream
    lib.srhmm_lattice_backward.argtypes = [c_ptr] * 4 + [c_int] * 8 + [c_ptr]
    lib.srhmm_viterbi.restype = c_int
    # log_b lt lengths scores bptr, T S B G U TT vec C NT KS SP lt_cap device, stream
    lib.srhmm_viterbi.argtypes = [c_ptr] * 5 + [c_int] * 13 + [c_ptr]
    lib.srhmm_lattice_group.restype = c_int
    # kind, log_b lt, per_row, lengths out, layout T S B G C NT KS SP lt_cap device, stream
    lib.srhmm_lattice_group.argtypes = [c_int, c_ptr, c_ptr, c_int, c_ptr, c_ptr] + [c_int] * 11 + [c_ptr]
    lib.srhmm_lattice_group_clusters.restype = c_int
    # kind S B G C NT KS SP lt_cap device, clusters
    lib.srhmm_lattice_group_clusters.argtypes = [c_int] * 10 + [c_ptr]
    return lib


class LatticeLaunch:
    """Checked operands of one csrc/lattice.cu launch.  layout "tsb": log b
    (T, S, B); "bts": (B, T, S).  log_trans (S, S), or with per_row_ok also
    (B, S, S) per utterance."""

    def __init__(self, name: str, log_b, log_trans, lengths, layout: str, per_row_ok: bool = False):
        dev = log_b.device
        require_float32(name, dev, [log_b, log_trans, lengths], [log_b, log_trans])
        if log_b.dim() != 3:
            raise ValueError(f"{name}: log b must have three axes, got {tuple(log_b.shape)}")
        T, S, B = log_b.shape if layout == "tsb" else (log_b.shape[1], log_b.shape[2], log_b.shape[0])
        self.per_row = int(per_row_ok and log_trans.dim() == 3)
        want = (B, S, S) if self.per_row else (S, S)
        if tuple(log_trans.shape) != want or tuple(lengths.shape) != (B,):
            raise ValueError(f"{name}: log transitions {want} and lengths ({B},) must fit log b")
        if not 1 <= S <= MAX_STATES or T < 1 or B < 1:
            raise ValueError(f"{name}: 1 to {MAX_STATES} states and T, B >= 1, got T={T} S={S} B={B}")
        self.name, self.dev, self.T, self.S, self.B = name, dev, T, S, B
        # kept alive in locals of the wrapper until the launch is queued
        self.log_b = log_b.contiguous()
        self.log_trans = log_trans.contiguous()
        self.lengths = lengths.to(torch.int32).contiguous()

    def empty(self, shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=self.dev)


def forward_smem_bytes(S: int, U: int, TT: int, layout: str, per_row: bool) -> int:
    """csrc/lattice.cu forward_floats: log b in two slots, (TT, S, U) for
    "tsb" or U runs of TT S floats at a pitch rounded up to 4, + 4, for
    "bts"; the lattice out in two (TT, S, U) slots ("tsb"); the transitions
    past 32 states, one matrix or the block's U."""
    tile = TT * S * U if layout == "tsb" else U * (-(-TT * S // 4) * 4 + 4)
    out = 2 * TT * S * U if layout == "tsb" else 0
    trans = (U if per_row else 1) * S * S if S > 32 else 0
    return 4 * (2 * tile + out + trans)


def viterbi_smem_bytes(S: int, U: int, TT: int) -> int:
    """csrc/lattice.cu viterbi_floats: log b in two slots of U runs of TT S
    floats at a pitch rounded up to 4, + 4, the backpointers in two slots
    of the same shape; the transitions past 32 states."""
    return 4 * (4 * U * (-(-TT * S // 4) * 4 + 4) + (S * S if S > 32 else 0))


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def group_regions(S: int, G: int, C: int, NT: int, KS: int, SP: int) -> dict:
    """csrc/lattice.cu group_layout: a group-mode block's keys Db (ceil(S /
    C) rounded up to 4), sources a tile KT = SP KS, owned pairs a
    thread PO, and its regions in floats: two rows of G utterances at the
    larger of the pitches (S rounded up to KT for the streamed route, S | 1
    for the packed), the log b ring (GROUP_RING frames of PO NT floats), the
    owners' carries (PO NT), the KS partial (max, sum) pairs of every
    (utterance, key), the ints (lo and cnt of Db keys, the width, the G
    lengths), and the streamed route's GROUP_STAGES tiles of KT x Db (the
    least room for the transitions)."""
    Db = _r4(-(-S // C))
    KT = SP * KS
    rp = max(-(-S // KT) * KT, S | 1)
    PO = -(-G * Db // NT)
    return {"keys": Db, "tile_sources": KT, "owned": PO, "rows": _r4(2 * G * rp), "ring": GROUP_RING * PO * NT,
            "carry": PO * NT, "partials": 2 * KS * G * Db, "ints": _r4(2 * Db + 1 + G),
            "tiles": GROUP_STAGES * KT * Db}


def group_shape(S: int, G: int, C: int) -> dict | None:
    """The group-mode block of G utterances and C blocks a cluster, or None
    where it does not exist or does not fit.  A cluster block (C > 1, where
    dense transitions stream): KS the smallest power of two giving the
    register tiles (UT utterances x 4 keys, (G / UT) (Db / 4) of them) at
    least GROUP_THREADS threads, NT those threads rounded up to a warp (at
    most GROUP_STREAM_THREADS).  A one-block group (C = 1, the packed route
    at these S): NT = the G Db pairs over the fewest owned a thread that
    keep NT within GROUP_MAX_THREADS, rounded up to a warp, and KS the
    largest power of two whose register tiles fit NT.  Every block of the
    cluster owns a key, at most GROUP_MAX_OWNED pairs a thread, SP the
    largest of GROUP_SHARES whose tiles fit in a cluster block (fewer
    barriers a frame) and the smallest in one block (the packed route runs
    there: less shared memory leaves more L1), and lt_cap the floats of
    transitions: the dense slice S Db (rounded up to 4) where it fits beside
    the other regions, else what SMEM_LIMIT leaves (a multiple of 4), at
    least the streamed route's tiles."""
    Db = _r4(-(-S // C))
    if (C - 1) * Db >= S:
        return None
    UT = 2 if G % 2 == 0 else 1  # csrc/lattice.cu group_utt_tile
    units = (G // UT) * (Db // 4)
    if C == 1:
        owned = -(-G * Db // GROUP_MAX_THREADS)
        NT = -(-(-(-G * Db // owned)) // 32) * 32
        if units > NT:
            return None
        KS = 1
        while units * KS * 2 <= NT and KS < 64:
            KS *= 2
    else:
        KS = 1
        while units * KS < GROUP_THREADS:
            KS *= 2
        NT = -(-units * KS // 32) * 32
        if NT > GROUP_STREAM_THREADS:
            return None
    for SP in GROUP_SHARES if C > 1 else GROUP_SHARES[-1:]:
        reg = group_regions(S, G, C, NT, KS, SP)
        rest = (SMEM_LIMIT // 4 - reg["rows"] - reg["ring"] - reg["carry"] - reg["partials"] - reg["ints"]) // 4 * 4
        lt_cap = max(reg["tiles"], min(_r4(S * Db), rest))
        if reg["owned"] <= GROUP_MAX_OWNED and lt_cap <= rest:
            break
    else:
        return None
    return {**reg, "utts": G, "cluster": C, "threads": NT, "utt_tile": UT, "splits": KS, "share": SP, "lt_cap": lt_cap,
            "smem_bytes": 4 * (reg["rows"] + reg["ring"] + reg["carry"] + reg["partials"] + reg["ints"] + lt_cap)}


def group_block(S: int, B: int, per_row: bool = False, sms: int = 132, viterbi: bool = False) -> dict:
    """The group-mode launch shape of csrc/lattice.cu's forward, backward
    and (viterbi) Viterbi past LANE_STATES states: G utterances a cluster of
    C blocks, each block owning Db keys of all G.  Up to SINGLE_BLOCK_STATES
    states one block takes every key (C = 1: the whole matrix packs beside
    the rows); past them C is one of GROUP_CLUSTERS.  For each C, G = ceil(B
    / n) fills the card in one wave of one block an SM, n the clusters of C
    the card runs at once (GROUP_CLUSTERS_AT_ONCE, at most sms // C); G = 1
    for per-row transitions (nothing is shared); G is lowered while the
    block does not fit.  The shape kept has the least frame time over its waves, a frame
    taking the longer of a block's G Db S (source, key, utterance) steps
    (exponentials at GROUP_SFU_EXPS_PER_S; the Viterbi's max-plus steps at
    GROUP_MAXPLUS_PER_S) and the L2 reads of the groups that run at once
    (each streams the S x S matrix a frame, at GROUP_L2_BYTES_PER_S: past
    SINGLE_BLOCK_STATES the rule takes the transitions as dense), then the
    fewest groups."""
    if not LANE_STATES < S <= MAX_STATES:
        raise ValueError(f"lattice group kernel: {LANE_STATES + 1} to {MAX_STATES} states, got {S}")
    rate = GROUP_MAXPLUS_PER_S if viterbi else GROUP_SFU_EXPS_PER_S
    best = None
    for C in (1,) if S <= SINGLE_BLOCK_STATES else GROUP_CLUSTERS:
        at_once = max(min(GROUP_CLUSTERS_AT_ONCE[C], sms // C), 1)
        G = 1 if per_row else max(1, -(-B // at_once))
        sh = group_shape(S, G, C)
        while sh is None and G > 1:
            G -= 1
            sh = group_shape(S, G, C)
        if sh is None:
            continue
        groups = -(-B // G)
        frame = max(G * sh["keys"] * S / rate, min(groups, at_once) * 4 * S * S / GROUP_L2_BYTES_PER_S)
        cost = (-(-groups // at_once) * frame, groups)
        if best is None or cost < best[0]:
            best = (cost, {**sh, "mode": "group", "groups": groups, "blocks": groups * C})
    if best is None:
        raise ValueError(f"lattice group kernel: no group of S={S} fits {SMEM_LIMIT} bytes")
    return best[1]


def _lane_block(kernel: str, S: int, B: int, smem, sms: int, memory_warps: int = 1) -> dict:
    """The launch shape of a csrc/lattice.cu kernel: R states a lane (2 past
    32 states), G = 32 // S utterances a warp (1 past 32 states), U = 4 G a
    block of four recursion warps and `memory_warps`, NS compiled transition
    slots (4, 8, 16, 32 or 64 >= S); TT the largest of FORWARD_TILES whose
    blocks all fit on the card at once by shared memory (smem(U, TT) bytes a
    block) and threads (else the largest that fits a block), and the
    blocks."""
    if not 1 <= S <= LANE_STATES:
        raise ValueError(f"{kernel} kernel: 1 to {LANE_STATES} states a lane, got {S}")
    R = 2 if S > 32 else 1
    G = 1 if R == 2 else 32 // S
    U = G * FORWARD_REC_WARPS
    blocks = -(-B // U)
    threads = 32 * (FORWARD_REC_WARPS + memory_warps)
    fits = [tt for tt in FORWARD_TILES if smem(U, tt) <= SMEM_LIMIT]

    def resident(tt):  # blocks an SM holds: 2048 threads, 228 KB with 1 KB reserved a block
        return min(2048 // threads, 233472 // (smem(U, tt) + 1024))

    TT = next((tt for tt in fits if resident(tt) * sms >= blocks), fits[0])
    return {"states_per_lane": R, "utts_per_warp": G, "utts": U, "slots": next(n for n in (4, 8, 16, 32, 64) if n >= S),
            "tile": TT, "blocks": blocks, "smem_bytes": smem(U, TT)}


def forward_block(S: int, B: int, layout: str, per_row: bool = False, sms: int = 132) -> dict:
    """The launch shape of csrc/lattice.cu's forward kernel (_lane_block;
    past LANE_STATES states the group mode, group_block, which keeps one
    utterance a group for per-row transitions)."""
    if S > LANE_STATES:
        return group_block(S, B, per_row, sms)
    return _lane_block("forward", S, B, lambda U, tt: forward_smem_bytes(S, U, tt, layout, per_row), sms)


def backward_block(S: int, B: int, sms: int = 132) -> dict:
    """The launch shape of csrc/lattice.cu's backward kernel (_lane_block):
    its shared memory is the forward lattice's (log b and the lattice in two
    (TT, S, U) slots each, the transitions past 32 states); past
    LANE_STATES states the group mode, group_block."""
    if S > LANE_STATES:
        return group_block(S, B, False, sms)
    return _lane_block("backward", S, B, lambda U, tt: forward_smem_bytes(S, U, tt, "tsb", False), sms)


def viterbi_block(S: int, B: int, sms: int = 132) -> dict:
    """The launch shape of csrc/lattice.cu's Viterbi kernel (_lane_block,
    viterbi_smem_bytes, VITERBI_MEMORY_WARPS; past LANE_STATES states the
    group mode's max-plus kind, group_block(viterbi=True))."""
    if S > LANE_STATES:
        return group_block(S, B, False, sms, viterbi=True)
    return _lane_block("Viterbi", S, B, lambda U, tt: viterbi_smem_bytes(S, U, tt), sms, VITERBI_MEMORY_WARPS)


def shape_args(blk: dict, vec: bool) -> list[int]:
    """The lane launchers' shape arguments G, U, TT, vec."""
    return [blk["utts_per_warp"], blk["utts"], blk["tile"], int(vec)]


def group_args(blk: dict) -> list[int]:
    """srhmm_lattice_group's shape arguments G, C, NT, KS, SP, lt_cap."""
    return [blk["utts"], blk["cluster"], blk["threads"], blk["splits"], blk["share"], blk["lt_cap"]]


def viterbi_args(blk: dict, vec: bool) -> list[int]:
    """srhmm_viterbi's shape arguments G, U, TT, vec, C, NT, KS, SP, lt_cap:
    the lane path's first four (shape_args), the group mode's G and the
    last five past LANE_STATES."""
    if blk.get("mode") == "group":
        G, *rest = group_args(blk)
        return [G, 0, 0, 0, *rest]
    return [*shape_args(blk, vec), 0, 0, 0, 0, 0]


def forward_copies_16(S: int, T: int, B: int, blk: dict, layout: str) -> bool:
    """Whether a csrc/lattice.cu kernel moves log b (and the lattice or the
    backpointers) 16 bytes at a time: rows of U utterances along B ("tsb")
    where U and B are multiples of 4, runs of TT S floats an utterance
    ("bts") where T S and TT S are."""
    if layout == "tsb":
        return blk["utts"] % 4 == 0 and B % 4 == 0
    return T * S % 4 == 0 and blk["tile"] * S % 4 == 0


def group_launch(ln: "LatticeLaunch", kind: int, layout: str, log_trans, blk: dict, out, index: int, stream: int):
    """Launch csrc/lattice.cu's group mode (kind 0 the forward, 1 the
    backward) on checked operands past LANE_STATES states."""
    check_launch(ln.name, kernel_library().srhmm_lattice_group(
        kind, ln.log_b.data_ptr(), log_trans.data_ptr(), ln.per_row, ln.lengths.data_ptr(), out.data_ptr(),
        int(layout == "bts"), ln.T, ln.S, ln.B, *group_args(blk), index, stream))
    return out


def forward_launch(ln: "LatticeLaunch", layout: str):
    """Launch csrc/lattice.cu's forward kernel on checked operands: the (T,
    S, B) lattice for layout "tsb", the final carries (B, S) for "bts"."""
    index, stream = device_args(ln.dev)
    blk = forward_block(ln.S, ln.B, layout, bool(ln.per_row), sm_count(index))
    out = ln.empty((ln.T, ln.S, ln.B) if layout == "tsb" else (ln.B, ln.S))
    if ln.S > LANE_STATES:
        return group_launch(ln, 0, layout, ln.log_trans, blk, out, index, stream)
    vec = forward_copies_16(ln.S, ln.T, ln.B, blk, layout)
    log_b = aligned16(ln.log_b) if vec else ln.log_b
    check_launch(ln.name, kernel_library().srhmm_lattice_forward(
        log_b.data_ptr(), ln.log_trans.data_ptr(), ln.per_row, ln.lengths.data_ptr(), out.data_ptr(),
        int(layout == "bts"), ln.T, ln.S, ln.B, *shape_args(blk, vec), index, stream))
    return out


def _forward_cuda(name, log_b_tsb, log_trans, lengths):
    return forward_launch(LatticeLaunch(name, log_b_tsb, log_trans, lengths, "tsb"), "tsb")


def _backward_cuda(name, log_b_tsb, log_trans, lengths):
    ln = LatticeLaunch(name, log_b_tsb, log_trans, lengths, "tsb")
    index, stream = device_args(ln.dev)
    blk = backward_block(ln.S, ln.B, sm_count(index))
    out = ln.empty((ln.T, ln.S, ln.B))
    if ln.S > LANE_STATES:
        # the group mode reads a source's row as a column of the transpose
        return group_launch(ln, 1, "tsb", ln.log_trans.t().contiguous(), blk, out, index, stream)
    vec = forward_copies_16(ln.S, ln.T, ln.B, blk, "tsb")
    log_b = aligned16(ln.log_b) if vec else ln.log_b
    check_launch(name, kernel_library().srhmm_lattice_backward(
        log_b.data_ptr(), ln.log_trans.data_ptr(), ln.lengths.data_ptr(), out.data_ptr(), ln.T, ln.S, ln.B,
        *shape_args(blk, vec), index, stream))
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
