"""The MFCC frontend: srhmm_tpu_torch/features/frontend.py and the twin of
the MFCC kernel (ops/kernels/mfcc.py) against srhmm_tpu on the same numpy
waveforms (CPU).

Tolerances: the constants exactly equal (both build them in numpy
float64); the float64 frontend to 1e-9 absolute, rtol 1e-10 (the same
products, other summation orders); the kernel's float32 twin against the
Pallas kernel in interpret mode at rtol = atol = 2e-3, the bound of
tests/test_pallas_kernels.py::test_fused_mfcc_matches_frontend.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.features.frontend as jf
import srhmm_tpu_torch.features.frontend as tf
from srhmm_tpu.features.pallas_mfcc import mfcc_pallas
from srhmm_tpu_torch.ops.kernels import mfcc as km

CONFIGS = {
    "default": tf.FrontendConfig(),
    "mels40": tf.FrontendConfig(n_mels=40, n_mfcc=20),
    "hann": tf.FrontendConfig(window="hann"),
    "w512_s128": tf.FrontendConfig(frame_length=512, frame_shift=128),
    "rect_fmax": tf.FrontendConfig(window="rect", fmax=6000.0, sample_rate=12_000),
    "energy": tf.FrontendConfig(include_energy=True),
    # W not a multiple of 4 (the kernel's remainder loop), another sample rate
    "w551_22k": tf.FrontendConfig(sample_rate=22_050, frame_length=551, frame_shift=220),
}


def _jcfg(cfg: tf.FrontendConfig) -> jf.FrontendConfig:
    return jf.FrontendConfig(**dataclasses.asdict(cfg))


def _wave(seed, n, dtype=np.float64):
    return np.random.default_rng(seed).normal(size=n).astype(dtype)


def _close64(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_constants_are_exactly_the_jax_packages(name):
    cfg = CONFIGS[name]
    for a, b in zip(tf.dft_matrices(cfg), jf.dft_matrices(_jcfg(cfg))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf.mel_filterbank(cfg), jf.mel_filterbank(_jcfg(cfg)))
    np.testing.assert_array_equal(tf.dct_matrix(cfg), jf.dct_matrix(_jcfg(cfg)))
    for T in (1, 2, 7):
        np.testing.assert_array_equal(tf.delta_matrix(T), jf.delta_matrix(T))


@pytest.mark.parametrize("name", ["default", "hann", "w512_s128", "energy", "w551_22k"])
@pytest.mark.parametrize("n", [4000, 300])
def test_mfcc_and_log_mel_float64(name, n):
    """n=300 is shorter than one frame: one frame, its tail repeating the
    last sample (JAX's gather clamps)."""
    cfg = CONFIGS[name]
    x = _wave(n, n)
    _close64(tf.mfcc(torch.as_tensor(x), cfg), jf.mfcc(jnp.asarray(x), _jcfg(cfg)))
    _close64(tf.log_mel(torch.as_tensor(x), cfg), jf.log_mel(jnp.asarray(x), _jcfg(cfg)))


def test_frame_signal_clamps_and_batched_frontend():
    cfg = CONFIGS["default"]
    x = _wave(1, 300)
    fr = tf.frame_signal(torch.as_tensor(x), cfg).numpy()
    assert fr.shape == (1, 400)
    np.testing.assert_array_equal(fr[0, :300], x)
    np.testing.assert_array_equal(fr[0, 300:], np.full(100, x[-1]))
    np.testing.assert_array_equal(fr, np.asarray(jf.frame_signal(jnp.asarray(x), _jcfg(cfg))))
    with pytest.raises(ValueError):
        tf.frame_signal(torch.zeros(0), cfg)
    xb = np.stack([_wave(s, 2000) for s in range(3)])  # (3, 2000): batched leading axis
    _close64(tf.mfcc(torch.as_tensor(xb), cfg), jf.mfcc(jnp.asarray(xb), _jcfg(cfg)))


def test_add_deltas_and_cmvn_float64():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(3, 20, 4)) * 3.0 + 1.0
    lens = np.asarray([20, 11, 1], np.int32)
    _close64(tf.add_deltas(torch.as_tensor(feats)), jf.add_deltas(jnp.asarray(feats)))
    _close64(tf.add_deltas(torch.as_tensor(feats), 3), jf.add_deltas(jnp.asarray(feats), 3))
    for var_norm in (True, False):
        _close64(tf.cmvn(torch.as_tensor(feats), var_norm=var_norm),
                 jf.cmvn(jnp.asarray(feats), var_norm=var_norm))
        _close64(tf.cmvn(torch.as_tensor(feats), torch.as_tensor(lens), var_norm=var_norm),
                 jf.cmvn(jnp.asarray(feats), jnp.asarray(lens), var_norm=var_norm))
    # padded frames pass through untouched
    out = tf.cmvn(torch.as_tensor(feats), torch.as_tensor(lens)).numpy()
    np.testing.assert_array_equal(out[1, 11:], feats[1, 11:])


def _pallas(x, cfg):
    return np.asarray(mfcc_pallas(jnp.asarray(x, jnp.float32), _jcfg(cfg), interpret=True))


@pytest.mark.parametrize("name", ["default", "mels40", "hann", "w512_s128", "w551_22k"])
def test_twin_matches_pallas_kernel(name):
    """Several waveforms of different lengths in one call, each against its
    own mfcc_pallas call; 5000 samples give 29 frames (no block multiple),
    300 one clamped frame."""
    cfg = CONFIGS[name]
    waves = [_wave(10 + i, n, np.float32) for i, n in enumerate((5000, 300, 3337))]
    samples, offsets = km.pack_waves(waves, "cpu")
    got = km.split_frames(km.mfcc_plain(samples, offsets, cfg).numpy(), offsets, cfg)
    for x, g in zip(waves, got):
        want = _pallas(x, cfg)
        assert g.shape == want.shape == (tf.frame_count(len(x), cfg), cfg.n_mfcc)
        np.testing.assert_allclose(g, want, rtol=2e-3, atol=2e-3)


def test_include_energy_is_the_frontends_not_the_pallas_kernels():
    """mfcc_pallas ignores include_energy (column 0 stays the DCT's c0);
    frontend.mfcc writes the log frame energy there.  The port's twin (and
    kernel) follow frontend.mfcc."""
    cfg = CONFIGS["energy"]
    x = _wave(7, 4000, np.float32)
    ref = np.asarray(jf.mfcc(jnp.asarray(x), _jcfg(cfg)))
    pallas = _pallas(x, cfg)
    assert np.abs(pallas[:, 0] - ref[:, 0]).max() > 1.0  # the JAX pair disagrees in column 0
    np.testing.assert_allclose(pallas[:, 1:], ref[:, 1:], rtol=2e-3, atol=2e-3)
    samples, offsets = km.pack_waves([x], "cpu")
    got = km.mfcc_plain(samples, offsets, cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_wrapper_on_cpu_runs_the_twin_and_checks_bounds():
    cfg = CONFIGS["default"]
    waves = [_wave(3, 1000, np.float32), _wave(4, 401, np.float32)]
    samples, offsets = km.pack_waves(waves, "cpu")
    assert samples.dtype == torch.float32 and offsets.tolist() == [0, 1000, 1401]
    before = km.mfcc_fused.launches
    out = km.mfcc_fused(samples, offsets, cfg)
    assert km.mfcc_fused.launches == before  # no kernel on a CPU tensor
    assert torch.equal(out, km.mfcc_plain(samples, offsets, cfg))
    assert km.frame_offsets(offsets, cfg).tolist() == [0, 4, 5]
    for bad in (dict(frame_length=2048), dict(n_mels=200), dict(n_mfcc=30), dict(window="blackman"),
                dict(frame_shift=0)):
        with pytest.raises(ValueError):
            km.mfcc_fused(samples, offsets, dataclasses.replace(cfg, **bad))
    with pytest.raises(ValueError):  # an empty waveform
        km.mfcc_fused(samples, np.asarray([0, 1000, 1000, 1401]), cfg)
    big = tf.FrontendConfig(frame_length=1024, n_mels=128)
    threads, smem, frames = km.launch_shape(big)
    weights = 4 * len(km.mel_ranges(big)[1])
    assert (threads, frames) == (256, 4) and smem == 4 * 4 * (4 * 512 + 128 + 1) + weights <= km.BLOCK_SMEM
    # W=400: two buffers of the FFT's 200 points, 26 mels and the energy a
    # frame, and the filters' nonzero weights
    assert km.launch_shape(cfg) == (256, 4 * 16 * (4 * 200 + 26 + 1) + 4 * len(km.mel_ranges(cfg)[1]), 16)
    # the largest frame, an odd W: one frame a block would still fit
    assert km.launch_shape(tf.FrontendConfig(frame_length=1023, n_mels=128))[1] <= km.SMEM_LIMIT


def _is_prime(n):
    return n > 1 and all(n % d for d in range(2, int(n**0.5) + 1))


def test_fft_plan_factors_every_frame_length():
    """Every W the kernel takes, 1-1024: the radices multiply to N (W/2 with
    the split step for an even W, W for an odd one), in the kernel's order
    (8s, then at most one 4 or 2, then 5s, 3s, then the other primes
    ascending), within the kernel's MAX_STAGES."""
    seen = set()
    for W in range(1, km.MAX_FRAME_LENGTH + 1):
        N, split, radices = km.fft_plan(W)
        assert (N, split) == ((W // 2, True) if W % 2 == 0 else (W, False))
        assert int(np.prod(radices)) == N and len(radices) <= km.MAX_STAGES
        assert all(r in km.BUTTERFLIES or _is_prime(r) for r in radices)
        rank = [{8: 0, 4: 1, 2: 1, 5: 2, 3: 3}.get(r, 4) for r in radices]
        assert rank == sorted(rank) and rank.count(1) <= 1
        generic = [r for r in radices if r not in km.BUTTERFLIES]
        assert generic == sorted(generic)
        seen |= {r if r in km.BUTTERFLIES else "generic" for r in radices}
    assert seen == {8, 4, 2, 5, 3, "generic"}
    assert km.fft_plan(400)[2] == (8, 5, 5) and km.fft_plan(551)[2] == (19, 29) and km.fft_plan(397)[2] == (397,)


def _run_plan(x, W):
    """The kernel's FFT in numpy float64, stage by stage in its order, with
    the factors read from fft_layout's table at the offsets the kernel
    reads: Stockham stages, then the real split step."""
    N, split, stages, table, split_off = km.fft_layout(W)
    z = x[0::2] + 1j * x[1::2] if split else x.astype(complex)
    for R, p, off in stages:
        m = N // R
        i = np.arange(m)
        k = i % p
        j = (i - k) * R + k
        u = np.stack([z[i + r * m] for r in range(R)])
        y = np.empty(N, complex)
        if R in km.BUTTERFLIES:
            roots = table[off : off + R]
            u[1:] = u[1:] * table[off + R : off + R + (R - 1) * p].reshape(R - 1, p)[:, k]
            for q in range(R):
                y[j + q * p] = sum(u[r] * roots[(r * q) % R] for r in range(R))
        else:
            roots = table[off : off + p * R]
            for q in range(R):
                y[j + q * p] = sum(u[a] * roots[(a * (k + q * p)) % (p * R)] for a in range(R))
        z = y
    if not split:
        return z[: W // 2 + 1]
    kk = np.arange(N + 1)
    a, b = z[kk % N], np.conj(z[(N - kk) % N])
    return (a + b) / 2 + table[split_off : split_off + N + 1] * (a - b) / 2j


@pytest.mark.parametrize("W", [1, 2, 397, 400, 480, 512, 551, 1024])
def test_fft_plan_run_in_numpy_is_rfft(W):
    x = _wave(W, W)
    np.testing.assert_allclose(_run_plan(x, W), np.fft.rfft(x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["default", "mels40", "w512_s128", "rect_fmax", "w551_22k"])
def test_mel_ranges_reproduce_the_dense_filterbank_product(name):
    """The kernel's per-filter nonzero ranges hold every nonzero weight of
    the float32 filterbank, and its sums over them (ascending bins) equal
    the sums over every bin exactly, for non-negative powers."""
    cfg = CONFIGS[name]
    fb = tf.mel_filterbank(cfg).astype(np.float32)
    ranges, weights = km.mel_ranges(cfg)
    dense = np.zeros_like(fb)
    at = 0
    for m, (lo, hi) in enumerate(ranges):
        dense[lo:hi, m] = weights[at : at + hi - lo]
        at += hi - lo
        assert hi == lo or (fb[lo, m] != 0 and fb[hi - 1, m] != 0)
    np.testing.assert_array_equal(dense, fb)
    power = np.abs(_wave(5, fb.shape[0])).astype(np.float32) ** 2
    for m, (lo, hi) in enumerate(ranges):
        full = ranged = np.float32(0.0)
        for k in range(fb.shape[0]):
            full = np.float32(full + power[k] * fb[k, m])
        for k in range(lo, hi):
            ranged = np.float32(ranged + power[k] * fb[k, m])
        assert full == ranged


def test_kernel_constants_are_the_float64_layout_rounded_once():
    cfg = CONFIGS["w551_22k"]
    table, ranges, off = km._constants(cfg, torch.device("cpu"))
    _, _, stages, cplx, _ = km.fft_layout(cfg.frame_length)
    t = table.numpy()
    np.testing.assert_array_equal(t[: 2 * len(cplx) : 2], cplx.real.astype(np.float32))
    np.testing.assert_array_equal(t[1 : 2 * len(cplx) : 2], cplx.imag.astype(np.float32))
    assert off["stages"] == tuple((R, p, 2 * o) for R, p, o in stages)
    np.testing.assert_array_equal(t[off["window"] : off["window"] + cfg.frame_length],
                                  tf._window(cfg).astype(np.float32))
    np.testing.assert_array_equal(t[off["dct"] :], tf.dct_matrix(cfg).astype(np.float32).reshape(-1))
    fb = tf.mel_filterbank(cfg).astype(np.float32)
    for m, (lo, hi, at) in enumerate(ranges.numpy()):
        np.testing.assert_array_equal(t[at : at + hi - lo], fb[lo:hi, m])
