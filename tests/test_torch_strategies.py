"""The port's dynamic-assignment strategies (``fed.ifca``, ``fed.fesem``,
``fed.strategies``) against the JAX package's, and the port's fused
assignment round against its own serial oracles.

Trainer parity: the JAX trainer's initial params and m group inits are
carried over and every draw is replayed from its key chain
(``ReplayDraws``); membership must be equal every round, loss and
discrepancy within rtol 1e-3 (float sums over many SGD steps), accuracy
within 0.01 (an argmax may flip at a near-tie), ``comm_params`` equal, and
FeSEM / FedClust's ``local_flat`` within rtol 1e-4, atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed import client as jclient
from repro.fed import rounds as jrounds
from repro.fed import strategies as jstrategies
from repro.fed.engine import FedConfig as JFedConfig
from repro.models import paper_models as jpm
from repro.models.modules import flatten_updates as j_flatten
from repro_torch.convert import params_from_numpy
from repro_torch.data.generators import mnist_like
from repro_torch.fed import client as tclient
from repro_torch.fed import rounds as trounds
from repro_torch.fed import server as tserver
from repro_torch.fed import strategies as tstrategies
from repro_torch.fed.engine import FedConfig
from repro_torch.fed.fesem import fesem_state_update, make_fesem_assign
from repro_torch.fed.ifca import make_ifca_assign
from repro_torch.models import paper_models as tpm
from repro_torch.models.modules import flatten_stacked, flatten_updates

ROUNDS = 3
DYNAMIC = ["ifca", "fesem", "fedclust", "lcfl"]
TOL = dict(rtol=1e-4, atol=1e-6)
E, B, LR = 2, 5, 0.05


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# Trainer parity, port against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fed_data():
    kw = dict(seed=0, n_clients=30, classes_per_client=2, total_train=1000,
              dim=32)
    return j_mnist_like(**kw), mnist_like(**kw)


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("name", DYNAMIC)
def test_trainer_matches_reference(name, m, fed_data):
    jdata, tdata = fed_data
    jcfg = JFedConfig(n_rounds=ROUNDS, clients_per_round=8, local_epochs=2,
                      batch_size=10, lr=0.05, n_groups=m, seed=0)
    jtr = jstrategies.make_trainer(name, jpm.mlp(32, 16, 10), jdata, jcfg)
    ttr = tstrategies.make_trainer(
        name, tpm.mlp(32, 16, 10), tdata,
        FedConfig(**dataclasses.asdict(jcfg)), device="cpu",
        init_params=params_from_numpy(_np_tree(jtr.params)),
        init_group_params=params_from_numpy(_np_tree(jtr.group_params)),
        draws=ReplayDraws(jcfg.seed))
    assert type(ttr).framework == name
    for t in range(ROUNDS):
        jm, tm = jtr.round(t), ttr.round(t)
        assert np.array_equal(ttr.membership, jtr.membership), t
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01
        assert ttr.comm_params == jtr.comm_params
        if name in ("fesem", "fedclust"):
            np.testing.assert_allclose(tnp(ttr.local_flat),
                                       np.asarray(jtr.local_flat), **TOL)
    assert ttr.counters["rounds.completed"] == ROUNDS
    # migrations are counted from the same membership writes
    assert ttr.counters["rounds.migrations"] == int(
        jtr.obs.registry.get("rounds.migrations"))


def test_fesem_local_flat_stays_on_the_trainer_device(fed_data):
    _, tdata = fed_data
    cfg = FedConfig(n_rounds=1, clients_per_round=8, local_epochs=1,
                    batch_size=10, n_groups=3, seed=0)
    tr = tstrategies.make_trainer("fesem", tpm.mlp(32, 16, 10), tdata, cfg,
                                  device="cpu")
    before = tr.local_flat.clone()
    idx = tr._select()
    tr.round(0, idx)
    assert tr.local_flat.device == tr.device
    assert tr.local_flat.shape == (tdata.n_clients, tr.model_size)
    untouched = np.setdiff1d(np.arange(tdata.n_clients), idx)
    assert torch.equal(tr.local_flat[untouched], before[untouched])
    assert not torch.equal(tr.local_flat[idx], before[idx])


def test_default_group_inits_are_seeded_per_strategy(fed_data):
    """Without ``init_group_params`` the m centres come from a CPU
    generator seeded seed + offset: distinct groups, repeatable per seed,
    and FedClust shares FeSEM's offset."""
    _, tdata = fed_data
    cfg = FedConfig(n_groups=3, seed=4)
    made = {name: tstrategies.make_trainer(name, tpm.mlp(32, 16, 10), tdata,
                                           cfg, device="cpu").group_params
            for name in DYNAMIC}
    again = tstrategies.make_trainer("ifca", tpm.mlp(32, 16, 10), tdata,
                                     cfg, device="cpu").group_params
    w = {name: gp["w1"] for name, gp in made.items()}
    assert torch.equal(again["w1"], w["ifca"])
    assert torch.equal(w["fesem"], w["fedclust"])
    assert not torch.equal(w["ifca"], w["fesem"])
    assert not torch.equal(w["ifca"], w["lcfl"])
    assert not torch.equal(w["ifca"][0], w["ifca"][1])


# ---------------------------------------------------------------------------
# Fused assignment round against the port's serial oracles
# ---------------------------------------------------------------------------
def _setup(m=3, K=12, max_n=20, dim=6, n_classes=4, seed=0, spread=0.3):
    """Group models far apart, and each client's labels drawn from one
    group's predictions, so the assignment spreads clients over groups
    (the reference's ``tests/test_dynamic_assignment.py`` setup, drawn
    with numpy)."""
    rng = np.random.default_rng(seed)
    model = tpm.mclr(dim, n_classes)
    base = model.init(None, "cpu")
    gp_list = [{k: v + spread * torch.as_tensor(
        rng.standard_normal(tuple(v.shape)), dtype=torch.float32)
        for k, v in base.items()} for _ in range(m)]
    X = torch.as_tensor(rng.standard_normal((K, max_n, dim)),
                        dtype=torch.float32)
    Y = torch.stack([torch.argmax(model.apply(gp_list[i % m], X[i]), -1)
                     for i in range(K)])
    n = torch.full((K,), max_n, dtype=torch.int64)
    idx = torch.as_tensor(rng.integers(0, max_n, (K, E * (max_n // B), B)))
    return model, gp_list, X, Y, n, idx


def _executor(model, m, max_n, **kw):
    return trounds.make_round_executor(
        model, epochs=E, batch_size=B, lr=LR, mu=0.0, n_groups=m,
        max_samples=max_n, **kw)


def _solver(model, max_n):
    return tclient.make_batch_solver(model, epochs=E, batch_size=B, lr=LR,
                                     max_samples=max_n)


def _local_flat_near(gp_list, K, jitter=1e-3):
    m = len(gp_list)
    centers = torch.stack([flatten_updates(p) for p in gp_list])
    return torch.stack([centers[i % m] + jitter for i in range(K)])


def _assert_groups_close(stacked, ref_list, atol=1e-5):
    for j, ref in enumerate(ref_list):
        got = tserver.tree_index(stacked, j)
        for k in ref:
            np.testing.assert_allclose(tnp(got[k]), tnp(ref[k]), atol=atol,
                                       rtol=atol)


def _assert_fused_matches(out, ref_groups, ref_mem, ref_disc):
    assert np.array_equal(tnp(out.membership), ref_mem)
    _assert_groups_close(out.group_params, ref_groups)
    assert float(out.discrepancy) == pytest.approx(ref_disc, abs=1e-4)


@pytest.mark.parametrize("m", [1, 3, 5])
def test_fused_ifca_matches_serial_oracle(m):
    model, gp_list, X, Y, n, idx = _setup(m=m)
    out = _executor(model, m, X.shape[1], assign_fn=make_ifca_assign(model))(
        trounds.stack_trees(gp_list), None, X, Y, n, idx)
    ref_groups, ref_mem, ref_disc = trounds.serial_ifca_round(
        _solver(model, X.shape[1]), tclient.make_loss_eval_fn(model),
        gp_list, X, Y, n, idx)
    assert len(np.unique(ref_mem)) == m
    _assert_fused_matches(out, ref_groups, ref_mem, ref_disc)
    assert out.assign_state is None


@pytest.mark.parametrize("m", [1, 3, 5])
@pytest.mark.parametrize("name", ["fesem", "fedclust"])
def test_fused_local_flat_round_matches_serial_oracle(name, m):
    model, gp_list, X, Y, n, idx = _setup(m=m)
    K = X.shape[0]
    lf = _local_flat_near(gp_list, K)
    if name == "fesem":
        assign = make_fesem_assign()
    else:
        d_head = tstrategies.fedclust_head_dim(lf.shape[1], 0.5)
        assign = tstrategies.make_fedclust_assign(d_head)
    state = {"local_flat": lf.clone(), "idx": torch.arange(K)}
    out = _executor(model, m, X.shape[1], assign_fn=assign,
                    state_update_fn=fesem_state_update)(
        trounds.stack_trees(gp_list), state, X, Y, n, idx)
    solver = _solver(model, X.shape[1])
    if name == "fesem":
        ref_groups, ref_mem, ref_local, ref_disc = \
            trounds.serial_fesem_round(solver, gp_list, lf, X, Y, n, idx)
    else:
        ref_groups, ref_mem, ref_local, ref_disc = \
            tstrategies.serial_fedclust_round(solver, gp_list, lf, X, Y, n,
                                              idx, d_head=d_head)
    assert len(np.unique(ref_mem)) == m
    _assert_fused_matches(out, ref_groups, ref_mem, ref_disc)
    np.testing.assert_allclose(tnp(out.assign_state["local_flat"]),
                               tnp(ref_local), atol=1e-5)


@pytest.mark.parametrize("m", [1, 3, 5])
def test_fused_lcfl_matches_serial_oracle(m):
    model, gp_list, X, Y, n, idx = _setup(m=m)
    K = X.shape[0]
    cur = np.random.default_rng(m).integers(-1, m, K)   # cold and warm
    out = _executor(model, m, X.shape[1],
                    assign_fn=tstrategies.make_lcfl_assign(model, 0.1))(
        trounds.stack_trees(gp_list), torch.as_tensor(cur), X, Y, n, idx)
    ref_groups, ref_mem, ref_disc = tstrategies.serial_lcfl_round(
        _solver(model, X.shape[1]), tclient.make_loss_eval_fn(model),
        gp_list, cur, X, Y, n, idx, margin=0.1)
    _assert_fused_matches(out, ref_groups, ref_mem, ref_disc)


def test_lcfl_huge_margin_keeps_every_current_group():
    model, gp_list, X, Y, n, idx = _setup()
    cur = (np.arange(X.shape[0]) + 1) % 3      # off the loss-optimal group
    out = _executor(model, 3, X.shape[1],
                    assign_fn=tstrategies.make_lcfl_assign(model, 1e6))(
        trounds.stack_trees(gp_list), torch.as_tensor(cur), X, Y, n, idx)
    assert np.array_equal(tnp(out.membership), cur)


@pytest.mark.parametrize("m,eta_g", [(1, 0.0), (3, 0.05)])
def test_fused_round_matches_serial_reference_round(m, eta_g):
    model, gp_list, X, Y, n, idx = _setup(m=m)
    mem = np.arange(X.shape[0]) % m
    out = _executor(model, m, X.shape[1], eta_g=eta_g)(
        trounds.stack_trees(gp_list), torch.as_tensor(mem), X, Y, n, idx)
    new_list, global_params, group_delta, disc = \
        trounds.serial_reference_round(_solver(model, X.shape[1]), gp_list,
                                       mem, X, Y, n, idx, eta_g=eta_g)
    _assert_fused_matches(out, new_list, mem, disc)
    np.testing.assert_allclose(tnp(out.group_delta_flat), tnp(group_delta),
                               atol=1e-5)
    for k in global_params:
        np.testing.assert_allclose(tnp(out.global_params[k]),
                                   tnp(global_params[k]), atol=1e-5)


def test_quarantined_client_hands_its_group_start_to_local_flat():
    """A screened FeSEM client's ``finals`` is its group's round-start
    parameters, and that is the row ``local_flat`` receives."""
    model, gp_list, X, Y, n, idx = _setup()
    X = X.clone()
    X[2, 0, 0] = float("nan")                   # a poisoned payload
    K = X.shape[0]
    state = {"local_flat": _local_flat_near(gp_list, K), "idx": torch.arange(K)}
    out = _executor(model, 3, X.shape[1], assign_fn=make_fesem_assign(),
                    state_update_fn=fesem_state_update, quarantine=True)(
        trounds.stack_trees(gp_list), state, X, Y, n, idx)
    assert int(out.n_quarantined) == 1
    g = int(out.membership[2])
    assert torch.equal(out.assign_state["local_flat"][2],
                       flatten_updates(gp_list[g]))
    assert torch.isfinite(out.assign_state["local_flat"]).all()


# ---------------------------------------------------------------------------
# Assignment stages and oracles, bit for bit
# ---------------------------------------------------------------------------
def _jax_setup(m, K=15):
    """The same inputs in both packages: the port's _setup, handed to JAX."""
    model, gp_list, X, Y, n, idx = _setup(m=m, K=K)
    jgp = jrounds.stack_trees([{k: jnp.asarray(tnp(v)) for k, v in p.items()}
                               for p in gp_list])
    return (model, gp_list, X, Y, n, jpm.mclr(6, 4), jgp, jnp.asarray(tnp(X)),
            jnp.asarray(tnp(Y)), jnp.asarray(tnp(n), jnp.int32))


@pytest.mark.parametrize("m", [1, 3, 5])
def test_fedclust_assign_bit_identical(m):
    model, gp_list, X, Y, n, jm, jgp, jX, jY, jn = _jax_setup(m)
    lf = _local_flat_near(gp_list, 15, jitter=5e-3)
    d_head = tstrategies.fedclust_head_dim(lf.shape[1], 0.25)
    got = tnp(tstrategies.make_fedclust_assign(d_head)(
        trounds.stack_trees(gp_list), X, Y, n,
        {"local_flat": lf, "idx": torch.arange(15)}))
    centers = tnp(torch.stack([flatten_updates(p) for p in gp_list]))
    oracle = tstrategies.serial_fedclust_assign(centers, tnp(lf), d_head)
    assert np.array_equal(got, oracle)
    assert np.array_equal(
        oracle, jstrategies.serial_fedclust_assign(centers, tnp(lf), d_head))
    jgot = jstrategies.make_fedclust_assign(d_head)(
        jgp, jX, jY, jn, {"local_flat": jnp.asarray(tnp(lf)),
                          "idx": jnp.arange(15, dtype=jnp.int32)})
    assert np.array_equal(got, np.asarray(jgot))


@pytest.mark.parametrize("m", [1, 3, 5])
def test_lcfl_assign_bit_identical(m):
    model, gp_list, X, Y, n, jm, jgp, jX, jY, jn = _jax_setup(m)
    cur = np.random.default_rng(1).integers(-1, m, 15)
    got = tnp(tstrategies.make_lcfl_assign(model, 0.1)(
        trounds.stack_trees(gp_list), X, Y, n, torch.as_tensor(cur)))
    losses = np.stack([tnp(tclient.make_loss_eval_fn(model)(p, X, Y, n))
                       for p in gp_list])
    oracle = tstrategies.serial_lcfl_assign(losses, cur, 0.1)
    assert np.array_equal(got, oracle)
    assert np.array_equal(oracle,
                          jstrategies.serial_lcfl_assign(losses, cur, 0.1))
    jgot = jstrategies.make_lcfl_assign(jm, 0.1)(jgp, jX, jY, jn,
                                                 jnp.asarray(cur, jnp.int32))
    assert np.array_equal(got, np.asarray(jgot))


@pytest.mark.parametrize("m", [1, 3, 5])
def test_ifca_and_fesem_assign_match_reference(m):
    model, gp_list, X, Y, n, jm, jgp, jX, jY, jn = _jax_setup(m)
    from repro.fed.fesem import make_fesem_assign as j_fesem_assign
    from repro.fed.ifca import make_ifca_assign as j_ifca_assign
    got = tnp(make_ifca_assign(model)(trounds.stack_trees(gp_list), X, Y, n,
                                      None))
    assert np.array_equal(got, np.asarray(j_ifca_assign(jm)(jgp, jX, jY, jn,
                                                            None)))
    lf = _local_flat_near(gp_list, 15, jitter=5e-3)
    st = {"local_flat": lf, "idx": torch.arange(15)}
    got = tnp(make_fesem_assign()(trounds.stack_trees(gp_list), X, Y, n, st))
    jst = {"local_flat": jnp.asarray(tnp(lf)),
           "idx": jnp.arange(15, dtype=jnp.int32)}
    assert np.array_equal(got, np.asarray(j_fesem_assign()(jgp, jX, jY, jn,
                                                           jst)))


def test_loss_eval_fn_matches_reference():
    model, gp_list, X, Y, n, jm, jgp, jX, jY, jn = _jax_setup(3)
    got = tclient.make_loss_eval_fn(model)(gp_list[1], X, Y, n)
    want = jclient.make_loss_eval_fn(jm)(
        jax.tree_util.tree_map(lambda g: g[1], jgp), jX, jY, jn)
    np.testing.assert_allclose(tnp(got), np.asarray(want), rtol=1e-6)


def test_fedclust_head_is_the_same_slice_in_both_packages():
    """The trailing d_head coordinates depend on the flatten order: both
    packages flatten in JAX's sorted leaf order (b1, b2, w1, w2)."""
    params = jpm.mlp(32, 16, 10).init(jax.random.PRNGKey(3))
    jflat = np.asarray(j_flatten(params))
    tflat = tnp(flatten_updates(params_from_numpy(_np_tree(params))))
    d_head = tstrategies.fedclust_head_dim(len(jflat), 0.25)
    assert np.array_equal(tflat[-d_head:], jflat[-d_head:])
    w2 = np.asarray(params["w2"]).reshape(-1)         # the last leaf
    assert np.array_equal(tflat[-len(w2):], w2)


def test_fedclust_head_dim_bounds():
    for d_w, frac in [(100, 0.25), (100, 0.0), (100, 2.0), (1, 0.5),
                      (415258, 0.25)]:
        got = tstrategies.fedclust_head_dim(d_w, frac)
        assert got == jstrategies.fedclust_head_dim(d_w, frac)
    assert tstrategies.fedclust_head_dim(100, 0.25) == 25
    assert tstrategies.fedclust_head_dim(100, 0.0) == 1      # floor
    assert tstrategies.fedclust_head_dim(100, 2.0) == 100    # cap


def test_lcfl_margin_zero_matches_ifca():
    """margin 0 keeps the incumbent only on an exact loss tie, so the
    decision is IFCA's argmin wherever that argmin is unique."""
    model, gp_list, X, Y, n, idx = _setup()
    K = X.shape[0]
    gp = trounds.stack_trees(gp_list)
    cur = torch.as_tensor((np.arange(K) + 1) % 3)
    lcfl = tstrategies.make_lcfl_assign(model, 0.0)(gp, X, Y, n, cur)
    ifca = make_ifca_assign(model)(gp, X, Y, n, None)
    assert torch.equal(lcfl, ifca)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
def test_registry_lists_the_reference_strategies():
    assert tstrategies.available_strategies() == \
        jstrategies.available_strategies() == \
        ["fedclust", "fesem", "ifca", "lcfl", "static"]
    for name in tstrategies.available_strategies():
        assert tstrategies.get_strategy(name).state_kind == \
            jstrategies.get_strategy(name).state_kind
    assert tstrategies.get_strategy("static").trainer.__name__ == \
        "FedGroupTrainer"
    assert tstrategies.get_strategy("static").make_assign is None


def test_registry_errors():
    with pytest.raises(KeyError, match="available"):
        tstrategies.get_strategy("nope")
    spec = tstrategies.get_strategy("ifca")
    with pytest.raises(ValueError, match="already registered"):
        tstrategies.register(spec)
    with pytest.raises(ValueError, match="state_kind"):
        tstrategies.register(spec._replace(name="x", state_kind="bogus"))
    assert "x" not in tstrategies.available_strategies()


def test_registry_make_assign_builds_each_stage():
    model, gp_list, X, Y, n, idx = _setup()
    gp = trounds.stack_trees(gp_list)
    K = X.shape[0]
    d_w = int(flatten_stacked(gp).shape[1])
    states = {"none": None, "membership": torch.full((K,), -1),
              "local_flat": {"local_flat": _local_flat_near(gp_list, K),
                             "idx": torch.arange(K)}}
    for name in DYNAMIC:
        spec = tstrategies.get_strategy(name)
        got = spec.make_assign(model, d_w, FedConfig())(
            gp, X, Y, n, states[spec.state_kind])
        assert got.shape == (K,) and int(got.min()) >= 0 and \
            int(got.max()) < 3
