"""The port's fused round (Alg. 2) against
``repro.fed.rounds.make_round_executor``, with the minibatch indices
replayed from the reference's keys. Tolerance after many SGD steps:
rtol 1e-4 (atol 1e-6 for near-zero entries)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import replay_batch_indices, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.fed import client as jclient
from repro.fed import rounds as jrounds
from repro.models import paper_models as jpm
from repro_torch.convert import params_from_numpy
from repro_torch.fed import rounds as trounds
from repro_torch.models import paper_models as tpm

TOL = dict(rtol=1e-4, atol=1e-6)
E, B, LR = 2, 5, 0.05


def _setup(m, K=6, seed=0, max_n=17, dim=10):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(K, max_n, dim)).astype(np.float32)
    Y = rng.integers(0, 4, (K, max_n)).astype(np.int32)
    n = rng.integers(3, max_n + 1, K).astype(np.int32)
    # group m-1 stays empty when m > 2: the occupied mask keeps it at w0
    mem = (np.arange(K) % max(m - 1, 1)).astype(np.int32)
    jm, tm = jpm.mlp(dim, 8, 4), tpm.mlp(dim, 8, 4)
    jgp = jax.vmap(jm.init)(jax.random.split(jax.random.PRNGKey(seed), m))
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), K)
    return jm, tm, jgp, X, Y, n, mem, keys


def _run_both(m, eta_g, quarantine, quarantine_mult=10.0, setup=None):
    jm, tm, jgp, X, Y, n, mem, keys = setup or _setup(m)
    kw = dict(epochs=E, batch_size=B, lr=LR, mu=0.0, n_groups=m,
              max_samples=X.shape[1], eta_g=eta_g, quarantine=quarantine,
              quarantine_mult=quarantine_mult)
    jout = jax.jit(jrounds.make_round_executor(jm, **kw))(
        jgp, jnp.asarray(mem), jnp.asarray(X), jnp.asarray(Y),
        jnp.asarray(n), keys)
    tex = trounds.make_round_executor(tm, **kw)
    tout = tex(params_from_numpy(jax.tree_util.tree_map(np.asarray, jgp)),
               torch.as_tensor(mem), torch.as_tensor(X), torch.as_tensor(Y),
               torch.as_tensor(n).long(),
               replay_batch_indices(keys, n, tex.max_steps, B))
    return jout, tout


def _assert_outputs_match(jout, tout):
    for field in ("group_params", "global_params", "agg_delta"):
        j, t = getattr(jout, field), getattr(tout, field)
        for k in t:
            np.testing.assert_allclose(tnp(t[k]), np.asarray(j[k]), **TOL)
    np.testing.assert_allclose(tnp(tout.group_delta_flat),
                               np.asarray(jout.group_delta_flat), **TOL)
    for field in ("discrepancy", "mean_loss"):
        np.testing.assert_allclose(float(getattr(tout, field)),
                                   float(getattr(jout, field)), **TOL)
    assert int(tout.n_quarantined) == int(jout.n_quarantined)
    assert np.array_equal(tnp(tout.membership), np.asarray(jout.membership))


@pytest.mark.parametrize("m,eta_g,quarantine", [
    (1, 0.0, False), (1, 0.0, True), (3, 0.0, False), (3, 0.05, True),
    (5, 0.05, False), (5, 0.0, True),
])
def test_round_matches_reference(m, eta_g, quarantine):
    _assert_outputs_match(*_run_both(m, eta_g, quarantine))


def test_quarantine_screens_nonfinite_and_outlier_updates():
    jm, tm, jgp, X, Y, n, mem, keys = _setup(3)
    X = X.copy()
    X[1, 0, 0] = np.nan               # poisoned payload: non-finite delta
    X[4] *= 1e4                       # norm outlier
    jout, tout = _run_both(3, 0.05, True,
                           setup=(jm, tm, jgp, X, Y, n, mem, keys))
    assert int(jout.n_quarantined) == 2
    _assert_outputs_match(jout, tout)


def test_even_cohort_median_averages_the_two_middle_norms():
    """jnp.nanmedian averages the two middle values of an even count;
    torch.nanmedian would return the lower one. The outlier threshold
    here sits between mult x lower-middle and mult x mean-of-middles, so
    only the averaging median keeps every client."""
    jm, tm, jgp, X, Y, n, mem, keys = _setup(1, K=4, seed=2)
    gp0 = jax.tree_util.tree_map(lambda g: g[0], jgp)
    deltas, _ = jclient.make_batch_solver(
        jm, epochs=E, batch_size=B, lr=LR, mu=0.0,
        max_samples=X.shape[1])(gp0, X, Y, n, keys)
    norms = np.sort(np.sqrt(sum(
        np.sum(np.square(np.asarray(d).reshape(4, -1)), axis=1)
        for d in jax.tree_util.tree_leaves(deltas))))
    lower, avg = norms[1], (norms[1] + norms[2]) / 2
    assert norms[2] > lower * 1.001, "middle norms must differ"
    mult = norms[3] / ((lower + avg) / 2)   # top norm between the two
    assert norms[3] > mult * lower and norms[3] < mult * avg
    jout, tout = _run_both(1, 0.0, True, quarantine_mult=float(mult),
                           setup=(jm, tm, jgp, X, Y, n, mem, keys))
    assert int(jout.n_quarantined) == 0
    _assert_outputs_match(jout, tout)
    vals = torch.tensor([norms[0], norms[1], float("nan"), norms[2],
                         norms[3]])
    np.testing.assert_allclose(float(torch.nanquantile(vals, 0.5)),
                               float(jnp.nanmedian(jnp.asarray(vals))),
                               rtol=1e-6)
