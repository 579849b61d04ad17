"""srhmm_tpu_torch.models against srhmm_tpu.models: weight exchange,
stacking, padding and the float32 cast of overflowing determinants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srhmm_tpu.models as jm
import srhmm_tpu_torch.models as tm
from srhmm_tpu_torch.models import gmm_hmm_from_numpy, gmm_hmm_to_numpy
from torch_port_utils import assert_same_leaves, both_models, rand_word


def test_numpy_round_trip():
    trans, streams = rand_word(0, 4, [(2, 3), (3, 2)], "full")
    model = gmm_hmm_from_numpy(trans, streams, "w")
    t2, s2, word = gmm_hmm_to_numpy(model)
    back = gmm_hmm_from_numpy(t2, s2, word)
    assert word == "w" and back.word == "w"
    np.testing.assert_array_equal(t2, trans)
    for a, b in zip(streams, s2):
        assert a["cov_type"] == b["cov_type"]
        for key in ("weights", "means", "inv_cov", "det"):
            np.testing.assert_array_equal(b[key], a[key])
        np.testing.assert_array_equal(b["log_det"], np.log(np.abs(a["det"])))
    for x, y in zip(gmm_hmm_to_numpy(back)[1], s2):
        for key in ("weights", "means", "inv_cov", "det", "log_det"):
            np.testing.assert_array_equal(x[key], y[key])


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_stack_models_matches_jax(cov):
    pairs = [both_models(*rand_word(i, 5, [(2, 4)], cov), f"w{i}") for i in range(3)]
    sj = jm.stack_models([p[0] for p in pairs])
    st = tm.stack_models([p[1] for p in pairs])
    assert st.word == sj.word == ("w0", "w1", "w2")
    assert_same_leaves(sj, st)
    np.testing.assert_array_equal(st.log_trans().numpy(), np.asarray(sj.log_trans()))
    with pytest.raises(ValueError, match="homogeneous"):
        tm.stack_models([pairs[0][1], both_models(*rand_word(9, 4, [(2, 4)], cov))[1]])


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_pad_stack_models_matches_jax(cov):
    shapes = [(4, 2), (6, 1), (3, 3), (5, 2)]
    pairs = [both_models(*rand_word(i, S, [(M, 3)], cov), f"w{i}") for i, (S, M) in enumerate(shapes)]
    sj, fj = jm.pad_stack_models([p[0] for p in pairs])
    st, ft = tm.pad_stack_models([p[1] for p in pairs])
    assert ft.dtype == torch.int32
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert_same_leaves(sj, st)
    with pytest.raises(ValueError, match="feature dims differ"):
        tm.pad_stack_models([pairs[0][1], both_models(*rand_word(9, 4, [(2, 5)], cov))[1]])


def test_astype_float32_keeps_huge_determinants_finite():
    trans, streams = rand_word(1, 3, [(1, 9)], "full")
    streams[0]["det"] = np.full((3, 1), 1e40)  # inf in float32
    jmod, tmod = both_models(trans, streams)
    t32 = tmod.astype(torch.float32)
    j32 = jmod.astype(jnp.float32)
    ld = t32.streams[0].log_det
    assert ld.dtype == torch.float32 and torch.isfinite(ld).all()
    np.testing.assert_allclose(ld.numpy(), np.asarray(j32.streams[0].log_abs_det()), rtol=1e-7)
    np.testing.assert_allclose(ld.numpy(), np.log(1e40), rtol=1e-7)
    assert t32.trans.dtype == torch.float32 and t32.streams[0].means.dtype == torch.float32
    # astype moves nothing: the cast stays on the model's device
    assert t32.trans.device == tmod.trans.device


@pytest.mark.parametrize("S,delta", [(1, 1), (5, 1), (6, 2)])
def test_init_left_right_trans_matches_jax(S, delta):
    got = tm.init_left_right_trans(S, delta)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.init_left_right_trans(S, delta)))
