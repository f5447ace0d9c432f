"""Paper models and flattening of the PyTorch port against the JAX
package, on the JAX ``init`` params carried over. Single ops in fp32:
atol = rtol = 1e-5 (the two frameworks sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.models import modules as jmod
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.models import modules as tmod
from repro_torch.models import paper_models as tpm

TOL = dict(atol=1e-5, rtol=1e-5)

MODELS = {
    "mclr": lambda p: p.mclr(24, 7),
    "mlp": lambda p: p.mlp(24, 16, 7),
    "lstm": lambda p: p.lstm_classifier(30, 6, 8, 3),
}


def _inputs(name, rng, B=9):
    if name == "lstm":
        x = rng.integers(0, 30, (B, 5)).astype(np.float32)
        y = rng.integers(0, 3, B).astype(np.int32)
    else:
        x = rng.normal(size=(B, 24)).astype(np.float32)
        y = rng.integers(0, 7, B).astype(np.int32)
    return x, y


def _pair(name, seed=0):
    jm, tm = MODELS[name](jpm), MODELS[name](tpm)
    jp = jm.init(jax.random.PRNGKey(seed))
    if name == "mclr":          # zero init: perturb so the test has teeth
        jp = jax.tree_util.tree_map(
            lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(9),
                                                  p.shape), jp)
    return jm, tm, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                jp))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_loss_accuracy_match(name):
    jm, tm, jp, tp = _pair(name)
    x, y = _inputs(name, np.random.default_rng(1))
    np.testing.assert_allclose(
        tm.apply(tp, torch.as_tensor(x)).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(x))), **TOL)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    tb = {"x": torch.as_tensor(x), "y": torch.as_tensor(y).long()}
    np.testing.assert_allclose(float(tm.loss(tp, tb)),
                               float(jm.loss(jp, jb)), **TOL)
    assert float(tm.accuracy(tp, tb)) == float(jm.accuracy(jp, jb))
    assert int(tm.correct_count(tp, tb)) == int(jm.correct_count(jp, jb))


def test_lstm_token_cast_truncates_like_int32():
    jm, tm, jp, tp = _pair("lstm")
    x = np.random.default_rng(2).integers(0, 30, (4, 5)).astype(np.float32)
    x = x + 0.7                          # float tokens: the cast truncates
    np.testing.assert_allclose(
        tm.apply(tp, torch.as_tensor(x)).numpy(),
        np.asarray(jm.apply(jp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flatten_follows_jax_leaf_order(name):
    _, _, jp, tp = _pair(name)
    want = np.asarray(jmod.flatten_updates(jp))
    got = tmod.flatten_updates(tp).numpy()
    assert np.array_equal(got, want)
    assert tmod.param_count(tp) == jmod.param_count(jp)
    back = tmod.unflatten_like(torch.tensor(want), tp)
    for k in tp:
        assert torch.equal(back[k], tp[k])
    stacked = {k: torch.stack([v, 2 * v]) for k, v in tp.items()}
    flat2 = tmod.flatten_stacked(stacked).numpy()
    assert np.array_equal(flat2[0], want)
    assert np.array_equal(flat2[1], 2 * want)


def test_mlp_leaf_order_is_sorted():
    tp = tpm.mlp(4, 3, 2).init(torch.Generator().manual_seed(0), "cpu")
    assert tmod.leaf_keys(tp) == ["b1", "b2", "w1", "w2"]


def test_femnist_mlp512_width_matches_paper_table2():
    tp = tpm.mlp(784, 512, 26).init(torch.Generator().manual_seed(0),
                                     "cpu")
    assert tmod.param_count(tp) == 415_258
