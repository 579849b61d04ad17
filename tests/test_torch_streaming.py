"""The input pipeline (srhmm_tpu_torch/io/pipeline.py) and streaming EM
(srhmm_tpu_torch/train/streaming.py) against srhmm_tpu's, on the same numpy
inputs (CPU).

PrefetchLoader: the overlap and error tests of tests/test_streaming.py:36-70
with their bounds, and a consumer that leaves early stopping the producer.
shard_batch: bitwise the JAX package's shards.  train_streaming: the JAX
package's train_streaming on the same shards and the port's train_fast on
the whole batch, within tests/test_streaming.py:72-95's bounds (history
rtol 1e-5, means rtol and atol 1e-4); em_step_streaming in float64 against
em_step on the whole batch, rtol 1e-10.  The CUDA side of the loader (side
stream, event, record_stream) runs in tests/test_torch_cuda.py.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.train.streaming as js
import srhmm_tpu_torch.train.streaming as ts
from srhmm_tpu.io.dataset import pack_utterances as j_pack
from srhmm_tpu.io.pipeline import PrefetchLoader as JPrefetchLoader
from srhmm_tpu_torch.io.dataset import UtteranceBatch
from srhmm_tpu_torch.io.dataset import pack_utterances as t_pack
from srhmm_tpu_torch.io.pipeline import PrefetchLoader, device_put_loader
from srhmm_tpu_torch.models import init_left_right_trans
from srhmm_tpu_torch.train.em import em_step, train_fast
from torch_port_utils import both_models, rand_stream


def test_prefetch_overlaps_load_with_compute():
    """With depth=2 the wall time approaches load + n * compute instead of
    n * (load + compute): the producer loads shard k+1 while the consumer
    computes on shard k."""
    load_s, compute_s, n = 0.05, 0.08, 6

    def slow_load(i):
        time.sleep(load_s)
        return i

    t0 = time.perf_counter()
    out = []
    for item in PrefetchLoader(range(n), slow_load, depth=2):
        time.sleep(compute_s)
        out.append(item)
    wall = time.perf_counter() - t0
    assert out == list(range(n))
    serial = n * (load_s + compute_s)
    overlapped = load_s + n * compute_s
    # at least 60% of the theoretical overlap win
    assert wall < overlapped + 0.6 * (serial - overlapped), (wall, serial, overlapped)


@pytest.mark.parametrize("loader", [JPrefetchLoader, PrefetchLoader])
def test_prefetch_propagates_producer_errors(loader):
    def boom(i):
        if i == 2:
            raise RuntimeError("shard 2 failed")
        return i

    got = []
    with pytest.raises(RuntimeError, match="shard 2"):
        for x in loader(range(4), boom, depth=2):
            got.append(x)
    assert got == [0, 1]
    with pytest.raises(ValueError, match="depth"):
        loader(range(4), boom, depth=0)


def test_a_consumer_that_leaves_early_stops_the_producer():
    loaded = []
    it = iter(PrefetchLoader(range(100), lambda i: loaded.append(i) or i, depth=2, ready=lambda i: -i))
    assert [next(it), next(it)] == [0, -1]
    it.close()
    assert not [t for t in threading.enumerate() if t.name == "prefetch-loader"]
    assert len(loaded) <= 6


def _model_pair(rng_seed=0, S=4, M=2, D=5):
    rng = np.random.default_rng(rng_seed)
    trans = np.asarray(init_left_right_trans(S))
    stream = rand_stream(rng, S, M, D, "diag", scale=3.0)
    return both_models(trans, [stream])


def _utterances(seed=0, n=13, D=5):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(24 + 2 * (i % 5), D)) for i in range(n)]


def _host_pair(utts, dtype_j, dtype_t, pad=8):
    bj = j_pack(utts, pad_multiple=pad, dtype=dtype_j)
    hj = bj.replace(features=np.asarray(bj.features), lengths=np.asarray(bj.lengths))
    return hj, t_pack(utts, pad_multiple=pad, dtype=dtype_t)


@pytest.mark.parametrize("n_shards", [1, 3, 4, 13, 20])
def test_shard_batch_is_the_jax_packages(n_shards):
    hj, bt = _host_pair(_utterances(1, n=13, D=3), jnp.float32, torch.float32, pad=4)
    sj, st = js.shard_batch(hj, n_shards), ts.shard_batch(bt, n_shards)
    assert len(st) == len(sj)
    for a, b in zip(sj, st):
        assert b.features.dtype == torch.float32 and b.lengths.dtype == torch.int32
        np.testing.assert_array_equal(b.features.numpy(), np.asarray(a.features))
        np.testing.assert_array_equal(b.lengths.numpy(), np.asarray(a.lengths))
    assert sum(int((s.lengths > 0).sum()) for s in st) == 13
    # one stream's shards, or a tuple of shards a stream
    pairs = ts.shard_batch((bt, bt), n_shards)
    assert len(pairs) == len(st)
    for p, s in zip(pairs, st):
        assert all(torch.equal(x.features, s.features) and torch.equal(x.lengths, s.lengths) for x in p)


def test_train_streaming_matches_jax_and_train_fast():
    jm, tm = _model_pair()
    jm, tm = jm.astype(jnp.float32), tm.astype(torch.float32)
    utts = _utterances()
    hj, bt = _host_pair(utts, jnp.float32, torch.float32)
    rj = js.train_streaming(jm, js.shard_batch(hj, 4), threshold=1e-4, max_iterations=6)
    rt = ts.train_streaming(tm, ts.shard_batch(bt, 4), threshold=1e-4, max_iterations=6)
    rf = train_fast(tm, bt, threshold=1e-4, max_iterations=6)
    assert rt.iterations == rj.iterations == rf.iterations
    assert rt.exemplar_count == rj.exemplar_count == 13
    for ref in (rj.log_prob_history, rf.log_prob_history):
        np.testing.assert_allclose(rt.log_prob_history, ref, rtol=1e-5)
    for ref in (np.asarray(rj.model.streams[0].means), rf.model.streams[0].means.numpy()):
        np.testing.assert_allclose(rt.model.streams[0].means.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_em_step_streaming_sums_the_shards_in_float64():
    _, tm = _model_pair(2)
    utts = _utterances(3, n=9)
    bt = t_pack(utts, pad_multiple=8, dtype=torch.float64)
    want, lp, nv = em_step(tm, bt, fused=False)
    got, lp_s, nv_s = ts.em_step_streaming(tm, device_put_loader(ts.shard_batch(bt, 4), device="cpu"))
    np.testing.assert_allclose(float(lp_s), float(lp), rtol=1e-10)
    assert float(nv_s) == float(nv) == 9
    for name in ("weights", "means", "inv_cov", "log_det"):
        np.testing.assert_allclose(getattr(got.streams[0], name).numpy(), getattr(want.streams[0], name).numpy(),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got.trans.numpy(), want.trans.numpy(), rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="empty"):
        ts.em_step_streaming(tm, [])


def test_device_put_loader_copies_plainly_on_the_cpu():
    b = UtteranceBatch(torch.arange(12.0).reshape(1, 4, 3), torch.tensor([4], dtype=torch.int32))
    out = list(device_put_loader([b, (b, b)], device="cpu"))
    assert torch.equal(out[0].features, b.features) and isinstance(out[1], tuple)
    assert torch.equal(out[1][1].lengths, b.lengths)
