"""The port's async runtime against the JAX package's, on the CPU at
``tests/test_async.py``'s fixtures (``mnist_like(n_clients=40, dim=16)``,
``mclr(16, 10)``, K = 8, E = 2).

  * ``staleness_weight`` exactly; the two folds at fixed numpy inputs: a
    bitwise passthrough at w = 1 (-0.0 and NaN lanes included), rtol 1e-6
    at w = 0.5 and per-group weights, the pinned fold writing only the
    alive cohort's rows;
  * the dispatch executor (static membership and FeSEM's rows) with the
    reference's minibatch draws replayed;
  * FedGroup pinned at D = 2, α = 0.8, β = 0.5 over 6 rounds and FedAvg
    streamed at D = 2 over 5 rounds, the port replaying the JAX trainer's
    draws from its initial params: ``async_stats``, ``group_version`` and
    membership equal, loss and discrepancy within rtol 1e-3, accuracy
    within 0.01;
  * the port's own copies of ``fed/leases.py`` and ``obs/metrics.py``
    against the reference modules.

The port-against-port cases (D = 1 against the synchronous paths, leases,
kill-and-resume, a JAX archive resumed) are in
``tests/test_torch_async_resume.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ReplayDraws, replay_batch_indices, tnp
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.core.fedgroup import FedGroupTrainer as JFedGroup
from repro.data.generators import mnist_like as j_mnist_like
from repro.fed import fesem as jfesem
from repro.fed import leases as jleases
from repro.fed import population as jpop
from repro.fed import rounds as jrounds
from repro.fed import store as jstore
from repro.fed.engine import FedAvgTrainer as JFedAvg
from repro.fed.engine import FedConfig as JFedConfig
from repro.models import paper_models as jpm
from repro.obs import metrics as jmetrics
from repro_torch.convert import params_from_numpy
from repro_torch.core.fedgroup import FedGroupTrainer
from repro_torch.data.generators import mnist_like
from repro_torch.fed import fesem as tfesem
from repro_torch.fed import leases as tleases
from repro_torch.fed import population as tpop
from repro_torch.fed import rounds as trounds
from repro_torch.fed import store as tstore
from repro_torch.fed.engine import FedAvgTrainer, FedConfig
from repro_torch.models import paper_models as tpm
from repro_torch.obs import metrics as tmetrics

N_CLIENTS = 40
STREAM_KW = dict(initial_active=30, arrival_rate=2.0, prefetch=2)
FOLD_RTOL = 1e-6
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def small_data():
    kw = dict(seed=0, n_clients=N_CLIENTS, classes_per_client=2,
              total_train=2000, dim=16)
    return j_mnist_like(**kw), mnist_like(**kw)


def _jcfg(**kw):
    base = dict(n_rounds=4, clients_per_round=8, local_epochs=2,
                batch_size=5, lr=0.05, n_groups=3, pretrain_scale=4, seed=0)
    base.update(kw)
    return JFedConfig(**base)


def _tcfg(jcfg):
    return FedConfig(**dataclasses.asdict(jcfg))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(x) -> bytes:
    return np.ascontiguousarray(tnp(x)).tobytes()


def _assert_rounds_agree(t_rounds, j_rounds):
    assert [r.round for r in t_rounds] == [r.round for r in j_rounds]
    for tm, jm in zip(t_rounds, j_rounds):
        np.testing.assert_allclose(tm.mean_loss, jm.mean_loss, rtol=1e-3)
        np.testing.assert_allclose(tm.discrepancy, jm.discrepancy,
                                   rtol=1e-3)
        assert abs(tm.weighted_acc - jm.weighted_acc) <= 0.01


# ---------------------------------------------------------------------------
# staleness weights and the folds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.8, 0.5), (0.25, 2.0),
                                        (0.9, 0.3)])
def test_staleness_weight_equals_reference(alpha, beta):
    s = np.array([0, 1, 2, 7, 1000], np.int64)
    want = jrounds.staleness_weight(s, alpha=alpha, beta=beta)
    got = trounds.staleness_weight(s, alpha=alpha, beta=beta)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def test_negative_staleness_raises():
    with pytest.raises(ValueError, match="negative staleness"):
        trounds.staleness_weight(np.array([0, -1]))


def _fold_inputs():
    rng = np.random.default_rng(5)
    cur = rng.standard_normal((3, 4, 2)).astype(np.float32)
    cur[0, 0, 0] = -0.0
    cur[1, 2, 1] = np.nan
    cur[2, 3, 0] = np.inf
    res = rng.standard_normal((3, 4, 2)).astype(np.float32)
    res_g = rng.standard_normal((4, 2)).astype(np.float32)
    return cur, res, res_g


@pytest.mark.parametrize("weights", [
    [1.0, 1.0, 1.0], [0.5, 0.5, 0.5], [1.0, 0.25, 0.5]],
    ids=["passthrough", "half", "per-group"])
def test_param_fold_equals_reference(weights):
    cur, res, res_g = _fold_inputs()
    w = np.asarray(weights, np.float32)
    jg, jglob = jrounds.make_param_fold()(
        {"w": jnp.asarray(cur)}, {"w": jnp.asarray(res)},
        {"w": jnp.asarray(res_g)}, jnp.asarray(w))
    tg, tglob = trounds.make_param_fold()(
        {"w": torch.as_tensor(cur)}, {"w": torch.as_tensor(res)},
        {"w": torch.as_tensor(res_g)}, w)
    for g in range(3):
        if w[g] == 1.0:
            # the select passes res through bit for bit, whatever cur holds
            assert _bits(tg["w"][g]) == _bits(jg["w"][g]) == _bits(res[g])
        else:
            np.testing.assert_allclose(tnp(tg["w"][g]), np.asarray(jg["w"][g]),
                                       rtol=FOLD_RTOL)
    if (w == 1.0).all():
        assert _bits(tglob["w"]) == _bits(jglob["w"]) == _bits(res_g)
    else:
        np.testing.assert_allclose(tnp(tglob["w"]), np.asarray(jglob["w"]),
                                   rtol=FOLD_RTOL)


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0], [0.5, 0.8, 1.0]],
                         ids=["passthrough", "mixed"])
def test_staleness_fold_equals_reference(weights):
    """The pinned fold writes only the alive cohort's membership and aux
    rows (the port's result holds just those rows), mixes the groups and
    takes the result's global model, or the groups' mean."""
    cur, res, res_g = _fold_inputs()
    glob = np.zeros((4, 2), np.float32)
    w = np.asarray(weights, np.float32)
    idx = np.array([0, 2, 5, 3], np.int64)
    alive = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    mem_cur = np.array([0, 1, 2, 0, 1, 2, -1], np.int64)   # 6 + trash
    mem_res = np.array([2, 2, 0, 2, 2, 1, -1], np.int64)
    aux_cur = np.arange(14, dtype=np.float32).reshape(7, 2)
    aux_res = -np.arange(14, dtype=np.float32).reshape(7, 2)
    delta = np.arange(6, dtype=np.float32).reshape(3, 2)
    jcur = dict(group_params={"w": jnp.asarray(cur)},
                global_params={"w": jnp.asarray(glob)},
                group_delta=jnp.zeros((3, 2)),
                membership=jnp.asarray(mem_cur, jnp.int32),
                aux=jnp.asarray(aux_cur))
    jres = dict(group_params={"w": jnp.asarray(res)},
                global_params={"w": jnp.asarray(res_g)},
                group_delta=jnp.asarray(delta),
                membership=jnp.asarray(mem_res, jnp.int32),
                aux=jnp.asarray(aux_res))
    jout = jrounds.make_staleness_fold()(
        jcur, jres, jnp.asarray(idx, jnp.int32), jnp.asarray(alive),
        jnp.asarray(w))
    rows = np.where(alive > 0, idx, 6)
    tcur = dict(group_params={"w": torch.as_tensor(cur)},
                global_params={"w": torch.as_tensor(glob)},
                group_delta=torch.zeros((3, 2)),
                membership=torch.as_tensor(mem_cur),
                aux=torch.as_tensor(aux_cur))
    tres = dict(group_params={"w": torch.as_tensor(res)},
                global_params={"w": torch.as_tensor(res_g)},
                group_delta=torch.as_tensor(delta),
                membership=torch.as_tensor(mem_res[rows]),
                aux=torch.as_tensor(aux_res[rows]))
    tout = trounds.make_staleness_fold()(
        tcur, tres, torch.as_tensor(idx), torch.as_tensor(alive), w)
    assert tout is tcur                          # in place
    mem = tnp(tout["membership"])
    np.testing.assert_array_equal(mem[:-1],
                                  np.asarray(jout["membership"])[:-1])
    assert (mem[0], mem[3], mem[5]) == (2, 2, 1)  # the alive cohort's rows
    assert mem[2] == 2                           # dead lane: not written
    assert mem[1] == 1 and mem[4] == 1           # not in the cohort
    np.testing.assert_array_equal(tnp(tout["aux"])[:-1],
                                  np.asarray(jout["aux"])[:-1])
    np.testing.assert_array_equal(tnp(tout["group_delta"]), delta)
    for g in range(3):
        if w[g] == 1.0:
            assert _bits(tout["group_params"]["w"][g]) == _bits(res[g])
        else:
            np.testing.assert_allclose(
                tnp(tout["group_params"]["w"][g]),
                np.asarray(jout["group_params"]["w"][g]), rtol=FOLD_RTOL)
    if (w == 1.0).all():
        assert _bits(tout["global_params"]["w"]) == _bits(res_g)
    else:
        np.testing.assert_allclose(tnp(tout["global_params"]["w"]),
                                   np.asarray(jout["global_params"]["w"]),
                                   rtol=FOLD_RTOL)


# ---------------------------------------------------------------------------
# the dispatch executor, draws replayed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["static", "fesem"])
def test_dispatch_executor_equals_reference(kind, small_data):
    jdata, tdata = small_data
    m, K, N = 3, 8, N_CLIENTS
    jmodel, tmodel = jpm.mclr(16, 10), tpm.mclr(16, 10)
    keys = jax.random.split(jax.random.PRNGKey(3), m + 1)
    groups = _np_tree(jax.tree_util.tree_map(
        lambda *ls: jnp.stack(ls), *[jmodel.init(k) for k in keys[:m]]))
    rng = np.random.default_rng(1)
    mem = np.append(rng.integers(0, m, N), -1).astype(np.int64)
    idx = rng.choice(N, K, replace=False).astype(np.int64)
    alive = np.ones(K, np.float32)
    ckeys = jax.random.split(keys[m], K)
    kw = dict(epochs=2, batch_size=5, lr=0.05, mu=0.0, n_groups=m,
              max_samples=jdata.x_train.shape[1])
    aux = None
    if kind == "fesem":
        d_w = sum(int(np.prod(v.shape[1:])) for v in groups.values())
        aux = np.append(rng.standard_normal((N, d_w)).astype(np.float32),
                        np.zeros((1, d_w), np.float32), axis=0)
        jkw = dict(assign_fn=jfesem.make_fesem_assign(),
                   state_update_fn=jfesem.fesem_state_update,
                   make_state=lambda a, i, mm: {"local_flat": a, "idx": i},
                   state_to_aux=lambda s: s["local_flat"])
        tkw = dict(assign_fn=tfesem.make_fesem_assign(),
                   state_update_fn=tfesem.fesem_state_update,
                   make_state=lambda a, i, mm: {"local_flat": a, "idx": i},
                   state_to_aux=lambda s: s["local_flat"])
    else:
        jkw = tkw = {}
    jfn = jrounds.make_async_dispatch_executor(jmodel, **kw, **jkw)
    tfn = trounds.make_async_dispatch_executor(tmodel, **kw, **tkw)
    jcarry = dict(group_params=jax.tree_util.tree_map(jnp.asarray, groups),
                  global_params=jax.tree_util.tree_map(
                      lambda g: jnp.mean(jnp.asarray(g), 0), groups),
                  group_delta=jnp.zeros((m, 1)),
                  membership=jnp.asarray(mem, jnp.int32),
                  aux=None if aux is None else jnp.asarray(aux))
    jstack = tuple(jnp.asarray(a) for a in (jdata.x_train, jdata.y_train,
                                            jdata.n_train))
    jres, (jl, jd, jq, jmem) = jfn(jcarry, jstack, jnp.asarray(idx, jnp.int32),
                                   ckeys, jnp.asarray(alive))
    tgroups = params_from_numpy(groups)
    tcarry = dict(group_params=tgroups,
                  global_params={k: g.mean(0) for k, g in tgroups.items()},
                  group_delta=torch.zeros((m, 1)),
                  membership=torch.as_tensor(mem),
                  aux=None if aux is None else torch.as_tensor(aux))
    before = {k: v.clone() for k, v in tcarry.items()
              if isinstance(v, torch.Tensor)}
    tstack = (torch.as_tensor(tdata.x_train),
              torch.as_tensor(tdata.y_train).long(),
              torch.as_tensor(tdata.n_train).long())
    bidx = replay_batch_indices(ckeys, tdata.n_train[idx], tfn.max_steps, 5)
    tres, tmets = tfn(tcarry, tstack, torch.as_tensor(idx), bidx,
                      torch.as_tensor(alive))
    for k, v in before.items():                  # the snapshot is only read
        assert torch.equal(tcarry[k], v), k
    for key in ("group_params", "global_params"):
        for k in tres[key]:
            np.testing.assert_allclose(tnp(tres[key][k]),
                                       np.asarray(jres[key][k]), **TOL)
    np.testing.assert_allclose(tnp(tres["group_delta"]),
                               np.asarray(jres["group_delta"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tnp(tres["membership"]), np.asarray(jmem))
    mets = tnp(tmets)
    np.testing.assert_allclose(mets[:2], [float(jl), float(jd)], rtol=1e-4)
    assert mets[2] == int(jq)
    np.testing.assert_array_equal(mets[3:], np.asarray(jmem))
    if kind == "fesem":
        np.testing.assert_allclose(tnp(tres["aux"]),
                                   np.asarray(jres["aux"])[idx], **TOL)
    else:
        assert tres["aux"] is None


# ---------------------------------------------------------------------------
# whole runs at D = 2 against the JAX trainers
# ---------------------------------------------------------------------------
def test_fedgroup_pinned_depth2_matches_reference(small_data):
    jdata, tdata = small_data
    jcfg = _jcfg(async_depth=2, async_alpha=0.8, async_beta=0.5)
    jtr = JFedGroup(jpm.mclr(16, 10), jdata, jcfg)
    ttr = FedGroupTrainer(tpm.mclr(16, 10), tdata, _tcfg(jcfg), device="cpu",
                          init_params=params_from_numpy(_np_tree(jtr.params)),
                          draws=ReplayDraws(jcfg.seed))
    jh, th = jtr.run(6), ttr.run(6)
    _assert_rounds_agree(th.rounds, jh.rounds)
    assert th.async_stats == dict(jh.async_stats)
    assert th.async_stats["max_in_flight"] == 2
    assert any(int(k) >= 1 for k in th.async_stats["staleness_hist"])
    np.testing.assert_array_equal(ttr.group_version, jtr.group_version)
    np.testing.assert_array_equal(ttr.membership, jtr.membership)
    assert ttr.comm_params == jtr.comm_params
    for k in ttr.group_params:
        np.testing.assert_allclose(tnp(ttr.group_params[k]),
                                   np.asarray(jtr.group_params[k]),
                                   rtol=1e-3, atol=1e-5)


def test_fedavg_streamed_depth2_matches_reference(small_data):
    jdata, tdata = small_data
    jcfg = _jcfg(async_depth=2, async_alpha=0.9, async_beta=0.5)
    jp = jpop.Population(jstore.ArrayClientStore(jdata),
                         jpop.PopulationConfig(**STREAM_KW))
    tp = tpop.Population(tstore.ArrayClientStore(tdata),
                         tpop.PopulationConfig(**STREAM_KW))
    jtr = JFedAvg(jpm.mclr(16, 10), None, jcfg, population=jp)
    ttr = FedAvgTrainer(tpm.mclr(16, 10), None, _tcfg(jcfg), device="cpu",
                        population=tp,
                        init_params=params_from_numpy(_np_tree(jtr.params)),
                        draws=ReplayDraws(jcfg.seed))
    try:
        jh, th = jtr.run(5), ttr.run(5)
        _assert_rounds_agree(th.rounds, jh.rounds)
        assert th.async_stats == dict(jh.async_stats)
        assert th.async_stats["max_in_flight"] == 2
        np.testing.assert_array_equal(ttr.group_version, jtr.group_version)
        assert dict(tp.stats) == dict(jp.stats)
        np.testing.assert_array_equal(tp.scheduler.active_ids(),
                                      jp.scheduler.active_ids())
        assert ttr.comm_params == jtr.comm_params
        for k in ttr.params:
            np.testing.assert_allclose(tnp(ttr.params[k]),
                                       np.asarray(jtr.params[k]),
                                       rtol=1e-3, atol=1e-5)
    finally:
        jtr.close()
        ttr.close()


# ---------------------------------------------------------------------------
# the port's copies of the reference modules that import no JAX
# ---------------------------------------------------------------------------
def test_leases_equal_reference():
    for a, c in [(0, 1.0), (1, 1.0), (3, 0.3), (10, 1.0)]:
        assert tleases.backoff_delay(a, 0.05, c) == \
            jleases.backoff_delay(a, 0.05, c)
    tp, jp = tleases.RetryPolicy(2.0, 2, 0.1, 0.15), \
        jleases.RetryPolicy(2.0, 2, 0.1, 0.15)
    assert tuple(tp) == tuple(jp) and tp.deadline(5.0) == jp.deadline(5.0)
    assert tleases.RetryPolicy()._fields == jleases.RetryPolicy()._fields
    assert [f.name for f in dataclasses.fields(tleases.Lease)] == \
        [f.name for f in dataclasses.fields(jleases.Lease)]
    seen = {}
    for mod, policy in ((tleases, tp), (jleases, jp)):
        buf, log = mod.RequeueBuffer(), []
        lease = mod.Lease(staged=("a",), attempts=0)
        for now in (0.0, 0.05):
            log.append(buf.push(lease, policy, now))
            lease = mod.Lease(staged=("b",), attempts=lease.attempts + 1)
        log += [len(buf), buf.earliest(), buf.pop_ready(0.09),
                buf.pop_ready(0.1), buf.pop_ready(0.19), bool(buf)]
        with pytest.raises(RuntimeError) as ei:
            buf.push(mod.Lease(staged=(), attempts=2), policy, 1.0)
        log.append(str(ei.value))
        seen[mod.__name__] = log
    t_log, j_log = seen.values()
    assert t_log == j_log
    assert "async_lease_timeout=2.0s" in t_log[-1]
    assert "async_max_retries=2" in t_log[-1]


def test_metrics_registry_equals_reference():
    assert tmetrics.ASYNC_SCHEMA == jmetrics.ASYNC_SCHEMA
    assert tmetrics.ROUND_SCHEMA == jmetrics.ROUND_SCHEMA
    from repro.obs.telemetry import _ASYNC_VIEW
    assert tmetrics.ASYNC_VIEW == _ASYNC_VIEW
    assert [tuple(s) for s in tpop.pop_metric_specs()] == \
        [tuple(s) for s in jpop.pop_metric_specs()]
    snaps = []
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.declare([mod.MetricSpec("pop.killed_clients", mod.COUNTER)])
        reg.inc("pop.killed_clients", 3)
        reg.inc("async.dispatches")
        reg.set("async.max_in_flight", 2)
        reg.observe("async.staleness_hist", 1)
        view = reg.view({"hist": "async.staleness_hist",
                         "killed": "pop.killed_clients"})
        view["hist"]["0"] = view["hist"].get("0", 0) + 4
        snap = reg.snapshot()
        reg.reset(["async.staleness_hist"])
        assert view["hist"] == {}
        reg.restore(dict(snap, **{"new.metric": 5, "new.hist": {"2": 1}}))
        with pytest.raises(ValueError, match="redeclared"):
            reg.declare([mod.MetricSpec("async.folds", mod.GAUGE)])
        with pytest.raises(TypeError):
            reg.inc("async.staleness_hist")
        with pytest.raises(KeyError):
            reg.get("nope")
        snaps.append((snap, reg.snapshot(), reg.names("async."),
                      view.snapshot(), dict(view) == {"hist": {"0": 4,
                                                               "1": 1},
                                                      "killed": 3}))
    assert snaps[0] == snaps[1]
    assert snaps[0][-1]
