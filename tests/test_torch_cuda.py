"""The CUDA scoring kernel against its plain PyTorch version, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Bound: max |kernel - plain| / max(|plain|, 1) <= 1e-5 over finite scores,
equal finite masks (the bound of the JAX package's compiled-vs-interpret
gate); both run fp32, in another summation order.
"""

import numpy as np
import pytest
import torch

import srhmm_tpu_torch.models as tm
from srhmm_tpu_torch.io.dataset import pack_utterances
from srhmm_tpu_torch.ops.kernels import scoring
from torch_port_utils import rand_word

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _vocab(cov, W, S, mixes_dims, delta=1):
    words = [tm.gmm_hmm_from_numpy(*rand_word(i, S, list(mixes_dims), cov, delta)) for i in range(W)]
    return tm.stack_models(words).astype(torch.float32)


def _batch(device, dims, lens, seed=8):
    rng = np.random.default_rng(seed)
    out = tuple(
        pack_utterances([rng.normal(size=(n, D)) * 2 for n in lens], pad_multiple=1,
                        dtype=torch.float32, device=device)
        for D in dims
    )
    return out[0] if len(out) == 1 else out


def _kernel_and_plain(vocab, batch, device, mode, semiring, final_states=None):
    cpu = tuple(b.to("cpu") for b in batch) if isinstance(batch, tuple) else batch.to("cpu")
    launches = scoring.vocab_scores.launches
    got = scoring.score_batch_fused(vocab.to(device), batch, mode, semiring, final_states)
    torch.cuda.synchronize()
    assert scoring.vocab_scores.launches == launches + 1
    want = scoring.score_batch_fused(vocab.to("cpu"), cpu, mode, semiring, final_states)
    return got.cpu().numpy(), want.numpy()


def _assert_close(got, want):
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    rel = np.max(np.abs(got[fin] - want[fin]) / np.maximum(np.abs(want[fin]), 1.0))
    assert rel <= 1e-5, rel
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("semiring", ["sum", "max"])
@pytest.mark.parametrize("cov,mixes_dims,delta", [
    ("diag", ((3, 9), (2, 3)), 1),
    ("full", ((3, 9), (2, 3)), 1),
    ("diag", ((4, 13),), 2),
    ("full", ((1, 9),), 1),
    ("diag", ((2, 40),), 1),
])
def test_kernel_matches_plain(cuda_device, cov, mixes_dims, delta, semiring):
    vocab = _vocab(cov, 7, 6, mixes_dims, delta)
    lens = [0, 1, 33, 130, 129, 77, 5, 300]
    batch = _batch(cuda_device, [D for _, D in mixes_dims], lens)
    for mode in ("total", "final"):
        _assert_close(*_kernel_and_plain(vocab, batch, cuda_device, mode, semiring))


def test_kernel_heterogeneous_final_states(cuda_device):
    words = [tm.gmm_hmm_from_numpy(*rand_word(i, S, [(M, 6)], "diag"))
             for i, (S, M) in enumerate([(4, 2), (6, 1), (6, 3), (4, 2)])]
    vocab, fs = tm.pad_stack_models(words)
    vocab = vocab.astype(torch.float32)
    batch = _batch(cuda_device, [6], [40, 0, 17, 129, 3])
    for mode in ("total", "final"):
        _assert_close(*_kernel_and_plain(vocab, batch, cuda_device, mode, "sum", fs))


def test_kernel_rejects_what_it_does_not_take(cuda_device):
    vocab = _vocab("diag", 2, 4, ((2, 5),)).to(cuda_device)
    b64 = _batch(cuda_device, [5], [10, 12])
    args, kw = scoring.pack_batch(vocab, b64)
    with pytest.raises(ValueError, match="float32"):
        scoring.vocab_scores(args[0].double(), *args[1:], **kw)
    wide = _vocab("diag", 2, 4, ((1, 65),)).to(cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        scoring.score_batch_fused(wide, _batch(cuda_device, [65], [10]))
