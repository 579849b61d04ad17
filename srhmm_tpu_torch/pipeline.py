"""End-to-end continuous-recognition pipeline: the framework as ONE system
(counterpart of ``srhmm_tpu/pipeline.py``).  One call chains

  synthetic multi-speaker audio
    -> MFCC frontend                  (ops/kernels/mfcc.py, csrc/mfcc.cu on CUDA)
    -> LBG flat-start monophones      (init/lbg.py)
    -> monophone embedded EM          (train/embedded.py, composed kernels on CUDA)
    -> decision-tree state clustering (models/decision_tree.py)
    -> tied-state (senone) EM         (train/tied.py)
    -> materialize lexicon words      (models.concat_models over triphones)
    -> bigram n-best decode           (decode/continuous.py, word-loop kernel on CUDA)
    -> WER                            (eval/metrics.py)

crossing every seam between the modules (frontend -> trainer dtype, tree
-> tied hand-off, tied -> decode materialization, decoder -> WER).  CLI:
``python -m srhmm_tpu_torch.cli.pipeline``.

Synthetic speech: each phone is a fixed triple of formant-like sinusoids;
words are phone strings from a small lexicon; utterances concatenate
words with per-phone duration and pitch jitter ("speakers"), optionally at
a target SNR.  The synthesis is numpy, the same numbers as the JAX
package's for the same configuration.

Everything runs on ``device`` (default cuda), which is never swapped for
another: on CUDA the frontend, the EM E-steps and the decoder run the
hand-written kernels; on the CPU their plain twins.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from .features.frontend import FrontendConfig

# ---------------------------------------------------------------------------
# synthetic speech


@dataclass(frozen=True)
class PipelineConfig:
    phones: tuple = ("aa", "iy", "uw", "eh", "ow", "ae", "er", "ah", "ey", "ao")
    n_words: int = 10
    # int: fixed length (homogeneous word HMMs); (min, max) tuple: variable
    # lengths, decoded as heterogeneous word HMMs (pad_stack_models) with
    # per-word final states
    phones_per_word: int | tuple = 3
    states_per_phone: int = 3
    n_mix: int = 2
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    phone_dur: tuple = (0.09, 0.16)  # seconds, uniform per phone instance
    min_words: int = 2
    max_words: int = 5
    snr_db: float | None = None  # additive white noise; None = clean
    seed: int = 0


def phone_formants(idx: int, n_phones: int) -> tuple:
    """Deterministic distinct formant triple per phone (Hz)."""
    f1 = 260.0 + 620.0 * idx / max(n_phones - 1, 1)
    f2 = 2350.0 - 1400.0 * idx / max(n_phones - 1, 1)
    # third formant alternates high/low so neighbors in f1/f2 still differ
    f3 = 2700.0 + (380.0 if idx % 2 else 40.0) + 35.0 * idx
    return (f1, f2, f3)


def _ppw_range(cfg: PipelineConfig) -> tuple:
    ppw = cfg.phones_per_word
    return (ppw, ppw) if isinstance(ppw, int) else tuple(ppw)


def make_lexicon(cfg: PipelineConfig) -> list:
    """[(word_name, phone_id tuple)]: distinct phone strings (fixed or
    variable length per cfg.phones_per_word), deterministic in cfg.seed;
    every phone is used."""
    rng = np.random.default_rng(cfg.seed + 1000)
    n_ph = len(cfg.phones)
    lo, hi = _ppw_range(cfg)
    seen = set()
    lex = []
    k = 0
    while len(lex) < cfg.n_words:
        n_p = int(rng.integers(lo, hi + 1))
        base = len(lex) * lo
        covered = tuple((base + i) % n_ph for i in range(n_p))
        if base < n_ph and covered not in seen:
            ph = covered  # coverage: early words walk the inventory
        else:
            ph = tuple(rng.integers(0, n_ph, n_p).tolist())
        if ph in seen or len(set(ph)) < min(2, n_p):
            k += 1
            if k > 10_000:
                raise ValueError("lexicon generation failed; enlarge phones")
            continue
        seen.add(ph)
        lex.append((f"word{len(lex):02d}", ph))
    return lex


def synth_phone(
    rng: np.random.Generator, phone_id: int, n_phones: int, dur_s: float,
    sr: int, pitch_jitter: float,
) -> np.ndarray:
    """One phone instance: three formant sinusoids with random phase, a
    per-instance frequency jitter (the "speaker"), and a raised-cosine
    amplitude envelope."""
    n = max(int(dur_s * sr), 1)
    t = np.arange(n) / sr
    x = np.zeros(n)
    for amp, f in zip((1.0, 0.7, 0.35), phone_formants(phone_id, n_phones)):
        fj = f * (1.0 + pitch_jitter * rng.uniform(-1.0, 1.0))
        x += amp * np.sin(2 * np.pi * fj * t + rng.uniform(0, 2 * np.pi))
    # raised-cosine attack/release over 12% of the phone
    edge = max(int(0.12 * n), 1)
    env = np.ones(n)
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
    env[:edge] *= ramp
    env[-edge:] *= ramp[::-1]
    return (x * env).astype(np.float64)


def synth_utterance(
    rng: np.random.Generator, word_ids: Sequence[int], lexicon, cfg: PipelineConfig,
) -> np.ndarray:
    """Float32 waveform of a word-id sequence (phones abut; no silence).
    SNR noise is added here, so training and test share the condition."""
    lo, hi = cfg.phone_dur
    jit = 0.03
    parts = [
        synth_phone(
            rng, ph, len(cfg.phones), rng.uniform(lo, hi),
            cfg.frontend.sample_rate, jit,
        )
        for w in word_ids
        for ph in lexicon[w][1]
    ]
    x = np.concatenate(parts)
    if cfg.snr_db is not None:
        p_sig = float(np.mean(x * x))
        p_noise = p_sig / (10.0 ** (cfg.snr_db / 10.0))
        x = x + rng.normal(scale=np.sqrt(p_noise), size=x.shape)
    return x.astype(np.float32)


def synthesize_dataset(cfg: PipelineConfig, n_train: int, n_test: int) -> tuple:
    """(train_waves, train_refs, test_waves, test_refs); refs are word-id
    lists.  The first n_words training utterances each lead with a distinct
    word, so every lexicon entry is seen."""
    lexicon = make_lexicon(cfg)
    rng = np.random.default_rng(cfg.seed)
    W = len(lexicon)

    def one(force_first: int | None):
        n_w = int(rng.integers(cfg.min_words, cfg.max_words + 1))
        ids = rng.integers(0, W, n_w).tolist()
        if force_first is not None:
            ids[0] = force_first
        return ids, synth_utterance(rng, ids, lexicon, cfg)

    train_refs, train_waves, test_refs, test_waves = [], [], [], []
    for i in range(n_train):
        ids, x = one(i % W if i < W else None)
        train_refs.append(ids)
        train_waves.append(x)
    for _ in range(n_test):
        ids, x = one(None)
        test_refs.append(ids)
        test_waves.append(x)
    return train_waves, train_refs, test_waves, test_refs


# ---------------------------------------------------------------------------
# features


def mfcc_features(waves: Sequence[np.ndarray], cfg: FrontendConfig, device="cuda") -> list:
    """MFCC per waveform, every waveform of the call in one pass: the
    hand-written kernel (csrc/mfcc.cu) when device is CUDA, its plain twin
    on the CPU.  Returns float32 (F, n_mfcc) numpy arrays, the frontend ->
    trainer dtype seam."""
    from .ops.kernels.mfcc import mfcc_fused, pack_waves, split_frames

    samples, offsets = pack_waves(waves, torch.device(device))
    out = mfcc_fused(samples, offsets, cfg).cpu().numpy()
    return [f.copy() for f in split_frames(out, offsets, cfg)]


def global_cmvn(train_feats: Sequence[np.ndarray], test_feats: Sequence[np.ndarray]) -> tuple:
    """run_pipeline's global CMVN: the mean and standard deviation of every
    training frame, taken on the host in numpy float32 as the JAX package
    takes them (so both normalize into the same space), applied to the
    training and the test features.  Returns (train, test) float32 lists."""
    allf = np.concatenate(train_feats, axis=0)
    g_mean = allf.mean(0)
    g_std = np.maximum(allf.std(0), 1e-6)

    def norm(fs):
        return [((f - g_mean) / g_std).astype(np.float32) for f in fs]

    return norm(train_feats), norm(test_feats)


# ---------------------------------------------------------------------------
# units: monophones -> triphones -> senones

BOUNDARY = "#"


def word_triphones(phones: Sequence[str], word_ph: Sequence[int]) -> list:
    """Word-internal triphones with `#` word-boundary contexts."""
    names = [phones[p] for p in word_ph]
    out = []
    for i, c in enumerate(names):
        left = names[i - 1] if i > 0 else BOUNDARY
        right = names[i + 1] if i + 1 < len(names) else BOUNDARY
        out.append((left, c, right))
    return out


def build_inventory(cfg: PipelineConfig, lexicon) -> tuple:
    """(units: list[Triphone], word_unit_ids: list[list[int]]): the distinct
    triphone inventory over the lexicon and each word's unit-id sequence."""
    units: list = []
    index: dict = {}
    word_unit_ids = []
    for _, ph in lexicon:
        ids = []
        for tri in word_triphones(cfg.phones, ph):
            if tri not in index:
                index[tri] = len(units)
                units.append(tri)
            ids.append(index[tri])
        word_unit_ids.append(ids)
    return units, word_unit_ids


def flat_start_monophones(
    cfg: PipelineConfig, feats: Sequence[np.ndarray], phone_seqs: Sequence[Sequence[int]]
):
    """LBG flat start: uniform segmentation of every utterance over its
    transcript positions gives each phone instance a frame segment; each
    phone's segments feed the reference LBG initializer
    (init/lbg.create_initial_model) with S states and M mixtures.  Returns
    a stacked monophone GmmHmm (diagonal covariance, float64, CPU)."""
    from .init.lbg import create_initial_model
    from .models import stack_models

    n_ph = len(cfg.phones)
    segments: list = [[] for _ in range(n_ph)]
    for f, seq in zip(feats, phone_seqs):
        L = len(seq)
        bounds = np.linspace(0, len(f), L + 1).astype(int)
        for k, ph in enumerate(seq):
            seg = f[bounds[k] : bounds[k + 1]]
            if len(seg) >= cfg.states_per_phone:
                segments[ph].append(np.asarray(seg, np.float64))
    models = []
    for p in range(n_ph):
        if not segments[p]:
            raise ValueError(f"phone {cfg.phones[p]} unseen in training data")
        models.append(
            create_initial_model(
                [segments[p]], cfg.states_per_phone, [cfg.n_mix],
                word=cfg.phones[p], cov_type="diag",
            )
        )
    return stack_models(models)


def clone_monophones_to_units(mono, units, phones):
    """Triphone seeding: every unit starts as a copy of its centre
    monophone (the cloning step before tree-based tying), gathered on the
    monophones' device."""
    from .models import GmmHmm, GmmStream

    center = torch.as_tensor([phones.index(c) for (_l, c, _r) in units], device=mono.trans.device)
    streams = [
        GmmStream(
            weights=st.weights[center], means=st.means[center], inv_cov=st.inv_cov[center],
            det=st.det[center], cov_type=st.cov_type, log_det=st.log_det[center],
        )
        for st in mono.streams
    ]
    return GmmHmm(trans=mono.trans[center], streams=streams, word=tuple("-".join(u) for u in units))


def _bucketed_embedded_stats(models, utts, transcripts, pad_multiple: int = 32, fused: bool | None = None,
                             mesh=None):
    """Summed embedded E-step SuffStats over shape buckets (the
    train_embedded packing, float32 features on the models' device): the
    per-(unit, state) occupancy and moment source of tree clustering.

    fused=None takes the composed kernels (batch_stats_fused) when every
    bucket is eligible (_embedded_fused_eligible: CUDA float32 among
    others), decided once here; True forces them (their plain twins on CPU
    tensors); False runs the plain batch_stats.  mesh: a Mesh with a
    "data" axis: each rank sums its rows of every bucket (padded to a
    multiple of the axis) and one all_reduce gives every rank the same
    sums."""
    from .parallel.mesh import DATA_AXIS, all_reduce_stats
    from .train.embedded import _add_stats, _embedded_fused_eligible, batch_stats, batch_stats_fused, mesh_buckets

    utts = [np.asarray(u, np.float32) for u in utts]
    packed, group = mesh_buckets("_bucketed_embedded_stats", utts, transcripts, models.trans.float(), pad_multiple,
                                 mesh, DATA_AXIS)
    if fused is None:
        fused = all(_embedded_fused_eligible(models, trs, f) for trs, f, _ in packed)
    stats = batch_stats_fused if fused else batch_stats
    agg = None
    for trs, feats, lengths in packed:
        st = stats(models, trs, feats, lengths)
        agg = st if agg is None else _add_stats(agg, st)
    return all_reduce_stats(agg, group)


def tree_cluster(models, utts, transcripts, units, pad_multiple: int = 32, mesh=None, **cluster_kw):
    """Tie the (unit, state) pairs of `models` by tree clustering
    (models/decision_tree.py cluster_states, `cluster_kw` its thresholds) on
    the statistics of one embedded E-step.  Under a mesh the statistics are
    data-parallel and all-reduced, so every rank's tree reads the same sums
    and builds the same state map (the senone count sizes every later
    collective)."""
    from .models.decision_tree import cluster_states, state_stats_from_suffstats

    stats = _bucketed_embedded_stats(models, utts, transcripts, pad_multiple=pad_multiple, mesh=mesh)
    occ, x, xx = state_stats_from_suffstats(stats)
    return cluster_states(units, occ, x, xx, **cluster_kw)


def estimate_bigram(refs: Sequence[Sequence[int]], W: int, alpha: float = 0.5) -> tuple:
    """Add-alpha bigram LM from training word sequences: ((W, W) log
    P(next|prev), (W,) initial log-probs)."""
    counts = np.full((W, W), alpha)
    init = np.full(W, alpha)
    for seq in refs:
        if seq:
            init[seq[0]] += 1.0
        for a, b in zip(seq[:-1], seq[1:]):
            counts[a, b] += 1.0
    lm = np.log(counts / counts.sum(1, keepdims=True))
    lm_init = np.log(init / init.sum())
    return lm, lm_init


# ---------------------------------------------------------------------------
# the chain


@dataclass
class PipelineResult:
    wer: object  # eval.metrics.WerCounts aggregated over the test set
    hyps: list  # decoded word-id lists
    refs: list  # true word-id lists
    n_senones: int
    n_units: int
    mono_iterations: int
    tied_iterations: int
    mono_log_prob: float
    tied_log_prob: float
    stage_seconds: dict
    words: tuple = ()


def run_pipeline(
    cfg: PipelineConfig = PipelineConfig(),
    n_train: int = 48,
    n_test: int = 16,
    max_iterations: int = 8,
    tied_iterations: int = 8,
    n_best: int = 2,
    lm_scale: float = 1.0,
    max_senones: int | None = None,
    min_occ: float = 40.0,
    min_gain: float = 200.0,
    mesh=None,
    pad_multiple: int = 32,
    cmvn: bool = True,
    var_floor: float = 1.0e-3,
    verbose: bool = False,
    device="cuda",
) -> PipelineResult:
    """Run the whole framework once, as one system (see the module
    docstring), on ``device``.  Returns the aggregate WER over the held-out
    test set (near 0 on clean synthetic speech).

    cmvn and var_floor are the numerics levers (on by default): global
    mean/variance normalization of the MFCC space, computed on the host in
    float32 as the JAX package does, and a relative variance floor.

    mesh: a Mesh with a "data" axis (parallel/mesh.py), ``device`` its
    device: both EM stages and the clustering statistics run
    data-parallel (train_embedded / train_tied / tree_cluster with mesh=),
    so every rank clusters the same all-reduced sums.  Every rank runs the
    rest of the chain on the whole data (synthesis and MFCC are
    deterministic; every rank decodes the held-out set), so every rank
    returns the same result."""
    from .decode.continuous import decode_continuous_batch
    from .eval.metrics import WerCounts, edit_alignment
    from .io.dataset import pack_utterances
    from .models import concat_models, pad_stack_models, stack_models
    from .models.tying import tie_from_models
    from .train.embedded import train_embedded
    from .train.tied import train_tied

    if mesh is not None:
        from .parallel.mesh import DATA_AXIS, require_axis

        require_axis("run_pipeline", mesh, DATA_AXIS)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_pipeline: device cuda, but torch sees no CUDA device")
    times: dict = {}
    t0 = time.time()

    def tick(name):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.time()
        times[name] = round(t1 - t0, 3)
        if verbose:
            print(f"[pipeline] {name}: {times[name]:.2f}s", flush=True)
        t0 = t1

    lexicon = make_lexicon(cfg)
    W = len(lexicon)
    train_waves, train_refs, test_waves, test_refs = synthesize_dataset(cfg, n_train, n_test)
    tick("synthesize")

    train_feats = mfcc_features(train_waves, cfg.frontend, device)
    test_feats = mfcc_features(test_waves, cfg.frontend, device)
    if cmvn:  # the models live in CMVN space end to end
        train_feats, test_feats = global_cmvn(train_feats, test_feats)
    tick("mfcc")

    # monophone transcripts: concatenated word phone strings
    phone_seqs = [[p for w in ids for p in lexicon[w][1]] for ids in train_refs]
    mono0 = flat_start_monophones(cfg, train_feats, phone_seqs).astype(torch.float32).to(device)
    tick("lbg_init")

    mono_res = train_embedded(
        mono0, train_feats, phone_seqs,
        max_iterations=max_iterations, mesh=mesh, pad_multiple=pad_multiple, var_floor=var_floor,
    )
    tick("monophone_em")

    # triphone cloning + one E-step for clustering statistics
    units, word_unit_ids = build_inventory(cfg, lexicon)
    tri0 = clone_monophones_to_units(mono_res.model, units, cfg.phones)
    unit_seqs = [[u for w in ids for u in word_unit_ids[w]] for ids in train_refs]
    cluster = tree_cluster(
        tri0, train_feats, unit_seqs, units, pad_multiple=pad_multiple, mesh=mesh,
        min_occ=min_occ, min_gain=min_gain, max_senones=max_senones,
    )
    tick("tree_cluster")

    tied0 = tie_from_models(tri0, cluster.state_map).astype(torch.float32)
    tied_res = train_tied(
        tied0, train_feats, unit_seqs,
        max_iterations=tied_iterations, mesh=mesh, pad_multiple=pad_multiple, var_floor=var_floor,
    )
    tick("tied_em")

    # the tied system as lexicon word models; variable-length lexicons
    # stack heterogeneous word HMMs and decode with per-word final states
    unit_models = tied_res.model.materialize()
    word_models = [concat_models(unit_models, word_unit_ids[w], word=lexicon[w][0]) for w in range(W)]
    if len({len(word_unit_ids[w]) for w in range(W)}) == 1:
        vocab = stack_models(word_models).astype(torch.float32)
        finals = None
    else:
        vocab, finals = pad_stack_models(word_models)
        vocab = vocab.astype(torch.float32).to(device)
    lm, lm_init = estimate_bigram(train_refs, W)
    tick("materialize")

    batch = pack_utterances(test_feats, pad_multiple=32, device=device)
    hyps_raw = decode_continuous_batch(
        vocab, batch, lm_logprobs=lm, lm_initial=lm_init,
        lm_scale=lm_scale, n_best=n_best, final_states=finals,
    )
    hyps = [list((h[0] if n_best >= 2 else h)[1]) for h in hyps_raw]
    tick("decode")

    wer = WerCounts()
    for ref, hyp in zip(test_refs, hyps):
        wer = wer + edit_alignment(ref, hyp)
    tick("wer")

    return PipelineResult(
        wer=wer,
        hyps=hyps,
        refs=test_refs,
        n_senones=tied_res.model.num_senones,
        n_units=len(units),
        mono_iterations=mono_res.iterations,
        tied_iterations=tied_res.iterations,
        mono_log_prob=float(mono_res.mean_log_prob),
        tied_log_prob=float(tied_res.mean_log_prob),
        stage_seconds=times,
        words=tuple(name for name, _ in lexicon),
    )
