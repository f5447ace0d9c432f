"""The port's local solver and evaluation against ``repro.fed.client``:
same params, same data, and the minibatch indices replayed from the
reference's ``split``/``randint`` chain. After many SGD steps the two
frameworks' float sums drift apart in the last bits: rtol 1e-4 (atol 1e-6
for near-zero entries)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from _torch_parity import replay_batch_indices, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.fed import client as jclient
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.fed import client as tclient
from repro_torch.models import paper_models as tpm

SOLVER_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)


def _data(seed=0, K=5, max_n=23, dim=12, classes=4, lstm=False):
    rng = np.random.default_rng(seed)
    if lstm:
        X = rng.integers(0, 20, (K, max_n, 4)).astype(np.float32)
    else:
        X = rng.normal(size=(K, max_n, dim)).astype(np.float32)
    Y = rng.integers(0, classes, (K, max_n)).astype(np.int32)
    n = rng.integers(1, max_n + 1, K).astype(np.int32)
    n[0] = max_n
    n[-1] = 0                      # an empty client: n_valid clamps to 1
    return X, Y, n


CASES = {
    "mlp": (lambda p: p.mlp(12, 8, 4), 0.0, {}),
    "mclr-prox": (lambda p: p.mclr(12, 4), 0.05, {}),
    "mlp-prox": (lambda p: p.mlp(12, 8, 4), 0.01, {}),
    "lstm": (lambda p: p.lstm_classifier(20, 4, 6, 4), 0.0, {"lstm": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_solver_matches_reference(case):
    make, mu, dkw = CASES[case]
    jm, tm = make(jpm), make(tpm)
    jp = jm.init(jax.random.PRNGKey(3))
    X, Y, n = _data(**dkw)
    E, B, lr = 2, 4, 0.1
    keys = jax.random.split(jax.random.PRNGKey(5), X.shape[0])
    jsolve = jclient.make_batch_solver(jm, epochs=E, batch_size=B, lr=lr,
                                       mu=mu, max_samples=X.shape[1])
    jd, jf = jsolve(jp, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(n), keys)
    tsolve = tclient.make_batch_solver(tm, epochs=E, batch_size=B, lr=lr,
                                       mu=mu, max_samples=X.shape[1])
    idx = replay_batch_indices(keys, n, tsolve.max_steps, B)
    td, tf = tsolve(params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                             jp)),
                    torch.as_tensor(X), torch.as_tensor(Y),
                    torch.as_tensor(n).long(), idx)
    for k in td:
        np.testing.assert_allclose(tnp(td[k]), np.asarray(jd[k]),
                                   **SOLVER_TOL)
        np.testing.assert_allclose(tnp(tf[k]), np.asarray(jf[k]),
                                   **SOLVER_TOL)


def test_drawn_indices_stay_in_the_valid_prefix():
    n = torch.tensor([1, 7, 0, 30])
    g = torch.Generator().manual_seed(0)
    idx = tclient.draw_batch_indices(n, 50, 8, g)
    assert idx.shape == (4, 50, 8) and idx.dtype == torch.int64
    hi = torch.clamp(n, min=1)[:, None, None]
    assert bool((idx >= 0).all()) and bool((idx < hi).all())
    assert set(idx[3].unique().tolist()) == set(range(30))
    again = tclient.draw_batch_indices(n, 50, 8,
                                       torch.Generator().manual_seed(0))
    assert torch.equal(idx, again)


def test_solver_draws_from_its_generator_without_indices():
    tm = tpm.mclr(12, 4)
    X, Y, n = _data()
    solve = tclient.make_batch_solver(tm, epochs=1, batch_size=4, lr=0.1,
                                      max_samples=X.shape[1])
    args = (tm.init(device="cpu"), torch.as_tensor(X), torch.as_tensor(Y),
            torch.as_tensor(n).long())
    a, _ = solve(*args, generator=torch.Generator().manual_seed(1))
    b, _ = solve(*args, generator=torch.Generator().manual_seed(1))
    c, _ = solve(*args, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    with pytest.raises(ValueError, match="batch indices"):
        solve(*args, torch.zeros((5, 1, 4), dtype=torch.int64))


def test_eval_and_loss_match_reference():
    jm, tm = jpm.mlp(12, 8, 4), tpm.mlp(12, 8, 4)
    m = 3
    jgp = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(0), m))
    tgp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jgp))
    X, Y, n = _data(K=7)
    mem = np.array([0, 2, -1, 1, 1, 0, -1], np.int32)
    jc, jt = jclient.grouped_eval_correct(jm)(jgp, jnp.asarray(mem),
                                              X, Y, n)
    tc, tt = tclient.grouped_eval_correct(tm)(
        tgp, torch.as_tensor(mem), torch.as_tensor(X),
        torch.as_tensor(Y), torch.as_tensor(n))
    assert (int(tc), int(tt)) == (int(jc), int(jt))

    p0 = {k: v[0] for k, v in jgp.items()}
    tp0 = {k: v[0] for k, v in tgp.items()}
    jcorr = jclient.make_eval_fn(jm)(p0, X, Y, n)
    tcorr = tclient.make_eval_fn(tm)(tp0, torch.as_tensor(X),
                                     torch.as_tensor(Y).long(),
                                     torch.as_tensor(n))
    assert np.array_equal(tnp(tcorr), np.asarray(jcorr))
    jl = jax.vmap(jclient.client_mean_loss(jm),
                  in_axes=(None, 0, 0, 0))(p0, X, Y, n)
    tl = vmap(tclient.client_mean_loss(tm), in_dims=(None, 0, 0, 0))(
        tp0, torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(n))
    np.testing.assert_allclose(tnp(tl), np.asarray(jl), **TOL)
