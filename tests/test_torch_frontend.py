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
    threads, smem = km.launch_shape(tf.FrontendConfig(frame_length=1024, n_mels=128))
    assert threads == 192 and smem <= km.SMEM_LIMIT
    assert km.launch_shape(cfg) == (224, 4 * 32 * (400 + 201 + 26 + 1))
